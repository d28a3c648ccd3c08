"""Serving side of the port: the event-driven simulator of the paper's
Fig. 2 loop (``simulator``, with its ``edge`` executors and the central
``controller``), the batched rollout engine (``engine``), the bucketed
decision fast path (``fastpath``) and the continuous-batching LM edge
server (``batching``). Exports what the reference's package does, less the
fleet, which is not ported yet."""
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
from repro_torch.serving.simulator import MultiEdgeSim, SimConfig
from repro_torch.serving.topology import nearest_alive_edge

__all__ = ["CentralController", "SchedulerChoice", "MultiEdgeSim", "SimConfig",
           "SimEdge", "nearest_alive_edge",
           "EngineConfig", "init_state", "init_batch", "step_round",
           "make_rollout", "summarize", "summarize_partials",
           "partials_to_summary", "local_assign", "greedy_assign",
           "make_policy_assign", "ASSIGN_FNS", "resolve_assign_fn",
           "DecisionFastPath", "SLOSpec", "DEFAULT_BUCKETS", "evaluate_slo",
           "pad_instance"]
