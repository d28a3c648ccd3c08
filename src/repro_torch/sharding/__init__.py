"""Sharding of the port (counterpart of ``repro/sharding``).

``specs`` maps every LM parameter, optimizer slot, input and cache leaf to
a spec (FSDP over ``data``, tensor parallelism over ``model``, the batch
over ("pod", "data"), KV caches with their slots over ``model``) and a
spec to DTensor placements; it also holds the rollout engine's fleet
placements. ``ctx`` is the activation-sharding context the LM's step
builders install and the model's ``constrain`` reads.
"""
from repro_torch.sharding.ctx import (REDISTRIBUTES, ShardCtx, constrain,
                                      current, use_sharding)
from repro_torch.sharding.specs import (arrival_specs, batch_specs,
                                        cache_specs, engine_state_specs,
                                        local_block, mesh_axes, mesh_sizes,
                                        opt_state_specs, param_specs,
                                        placements, replicated)

__all__ = ["mesh_axes", "mesh_sizes", "param_specs", "opt_state_specs",
           "batch_specs", "cache_specs", "replicated", "placements",
           "ShardCtx", "current", "use_sharding", "constrain",
           "REDISTRIBUTES", "engine_state_specs", "arrival_specs",
           "local_block"]
