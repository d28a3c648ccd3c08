"""Sharding specs of the port (counterpart of ``repro/sharding``): the
rollout engine's fleet placements only. The LM's parameter, optimizer,
batch and cache specs and ``sharding/ctx.py`` are not ported."""
from repro_torch.sharding.specs import (arrival_specs, engine_state_specs,
                                        local_block)

__all__ = ["engine_state_specs", "arrival_specs", "local_block"]
