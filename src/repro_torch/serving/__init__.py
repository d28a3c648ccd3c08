"""Serving side of the port: the event-driven simulator of the paper's
Fig. 2 loop (``simulator``, with its ``edge`` executors and the central
``controller``), the batched rollout engine (``engine``), the bucketed
decision fast path (``fastpath``), the fleet-sharded rollouts over a
``torch.distributed`` mesh (``fleet``) and the continuous-batching LM edge
server (``batching``). Exports what the reference's package does."""
from repro_torch.serving.controller import CentralController, SchedulerChoice
from repro_torch.serving.edge import SimEdge
from repro_torch.serving.engine import (ASSIGN_FNS, EngineConfig,
                                        greedy_assign, init_batch, init_state,
                                        local_assign, make_policy_assign,
                                        make_rollout, partials_to_summary,
                                        resolve_assign_fn, step_round,
                                        summarize, summarize_partials)
from repro_torch.serving.fastpath import (DEFAULT_BUCKETS, DecisionFastPath,
                                          SLOSpec, evaluate_slo, pad_instance)
from repro_torch.serving.fleet import (FleetPartition, apply_partition,
                                       fleet_summary, make_fleet_rollout,
                                       zipf_partition)
from repro_torch.serving.simulator import MultiEdgeSim, SimConfig
from repro_torch.serving.topology import nearest_alive_edge

__all__ = ["CentralController", "SchedulerChoice", "MultiEdgeSim", "SimConfig",
           "SimEdge", "nearest_alive_edge",
           "EngineConfig", "init_state", "init_batch", "step_round",
           "make_rollout", "summarize", "summarize_partials",
           "partials_to_summary", "local_assign", "greedy_assign",
           "make_policy_assign", "ASSIGN_FNS", "resolve_assign_fn",
           "FleetPartition", "zipf_partition", "apply_partition",
           "make_fleet_rollout", "fleet_summary",
           "DecisionFastPath", "SLOSpec", "DEFAULT_BUCKETS", "evaluate_slo",
           "pad_instance"]
