"""Workload & scenario subsystem of the port (numpy copies of
``repro.workloads``): arrival processes, trace record/replay, the named
scenario registry and the padded per-round materializer that feeds the
rollout engine. The device-resident materializer is not ported yet."""
from repro_torch.workloads.base import (Arrival, Merged, ServiceMix, SizeSpec,
                                        Workload, edge_weights, merge,
                                        workload_rng)
from repro_torch.workloads.batch import (DEADLINE_INF,
                                         materialize_round_batch,
                                         materialize_rounds)
from repro_torch.workloads.processes import (DiurnalArrivals,
                                             FlashCrowdArrivals,
                                             InhomogeneousPoisson,
                                             MMPPArrivals, PoissonArrivals)
from repro_torch.workloads.trace import (SCHEMA, SCHEMA_V1, SCHEMA_V2,
                                         SCHEMA_V3, FaultEvent, TraceWorkload,
                                         read_trace, record_trace,
                                         write_trace)
from repro_torch.workloads.scenarios import (ScenarioSpec,
                                             instance_config_for_scenario,
                                             list_scenarios,
                                             register_scenario, scenario,
                                             scenario_cloud_spec,
                                             scenario_fault_spec,
                                             scenario_spec)

__all__ = [
    "Arrival", "Merged", "ServiceMix", "SizeSpec", "Workload", "edge_weights",
    "merge", "workload_rng", "DEADLINE_INF", "materialize_rounds",
    "materialize_round_batch",
    "PoissonArrivals", "InhomogeneousPoisson", "DiurnalArrivals",
    "FlashCrowdArrivals", "MMPPArrivals",
    "SCHEMA", "SCHEMA_V1", "SCHEMA_V2", "SCHEMA_V3", "FaultEvent",
    "TraceWorkload", "read_trace", "record_trace", "write_trace",
    "ScenarioSpec", "register_scenario", "scenario", "scenario_spec",
    "scenario_fault_spec", "scenario_cloud_spec", "list_scenarios",
    "instance_config_for_scenario",
]
