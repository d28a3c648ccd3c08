"""Named scenario registry — one vocabulary for sim, training, benchmarks.

A numpy copy of ``repro/workloads/scenarios.py`` with all of its
registered scenarios (held bit for bit by ``tests/test_torch_workloads.py``).

A *scenario* bundles a workload factory (how requests arrive over time)
with static-instance overrides (how ``core/instances.py`` should condition
its request/backlog sampling so training and Table-III-style generalization
see the same laws). Consumers:

    wl  = scenario("flash_crowd_10x")                   # -> Workload
    sim.drive(wl, until=3.0)                            # serving
    cfg = instance_config_for_scenario("heavy_tail_pareto", base_cfg)
    inst = generate_instance(rng, cfg)                  # training / eval
    PYTHONPATH=src python benchmarks/scenario_sweep.py  # full matrix

Factories accept keyword overrides forwarded to the underlying process
dataclass, e.g. ``scenario("mmpp_bursty", rates=(2.0, 200.0))``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.resilience.faults import FaultSpec
from repro_torch.serving.cache import CacheSpec
from repro_torch.serving.topology import CloudSpec
from repro_torch.workloads.base import ServiceMix, SizeSpec, Workload
from repro_torch.workloads.processes import (DiurnalArrivals,
                                             FlashCrowdArrivals,
                                             MMPPArrivals, PoissonArrivals)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    name: str
    factory: Callable[..., Workload]
    description: str = ""
    # InstanceConfig field overrides (size_dist/size_params/source_skew/...)
    # applied by instance_config_for_scenario for static-instance consumers.
    instance_overrides: Optional[dict] = None
    # Chaos scenarios: the fault process injected alongside the arrivals
    # (materialized per seed by repro.resilience.faults). None = fault-free.
    fault_spec: Optional[FaultSpec] = None
    # Edge–cloud scenarios: the cloud tier + per-edge service-cache laws
    # both engines must be configured with (None = flat single-tier).
    cloud_spec: Optional[CloudSpec] = None
    cache_spec: Optional[CacheSpec] = None


_REGISTRY: dict[str, ScenarioSpec] = {}


def register_scenario(name: str, factory: Callable[..., Workload], *,
                      description: str = "",
                      instance_overrides: Optional[dict] = None,
                      fault_spec: Optional[FaultSpec] = None,
                      cloud_spec: Optional[CloudSpec] = None,
                      cache_spec: Optional[CacheSpec] = None,
                      overwrite: bool = False) -> ScenarioSpec:
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {name!r} already registered")
    spec = ScenarioSpec(name=name, factory=factory, description=description,
                        instance_overrides=instance_overrides,
                        fault_spec=fault_spec, cloud_spec=cloud_spec,
                        cache_spec=cache_spec)
    _REGISTRY[name] = spec
    return spec


def scenario(name: str, **overrides) -> Workload:
    """Instantiate a registered scenario's workload, with optional keyword
    overrides forwarded to its factory."""
    try:
        spec = _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown scenario {name!r}; known: {known}") from None
    return spec.factory(**overrides)


def scenario_spec(name: str) -> ScenarioSpec:
    return _REGISTRY[name]


def scenario_fault_spec(name: str) -> Optional[FaultSpec]:
    """The fault process a scenario injects (None for fault-free ones).
    Consumers materialize it per seed via ``resilience.faults`` — e.g.
    ``temporal_train`` fault-injects chaos-scenario episodes automatically,
    and ``benchmarks/scenario_sweep.py`` drives both engines with it."""
    return _REGISTRY[name].fault_spec


def scenario_cloud_spec(name: str):
    """The (CloudSpec, CacheSpec) pair a ``cloud-*`` scenario runs under —
    (None, None) for flat single-tier scenarios. Consumers thread these
    into ``EngineConfig(cloud=, cache=)`` and ``SimConfig(cloud=, cache=)``
    so both engines simulate the identical tiered cluster."""
    spec = _REGISTRY[name]
    return spec.cloud_spec, spec.cache_spec


def list_scenarios() -> dict[str, str]:
    """name -> one-line description, in registration order."""
    return {name: spec.description for name, spec in _REGISTRY.items()}


def instance_config_for_scenario(name: str, base):
    """Condition an :class:`repro.core.InstanceConfig` on a scenario: returns
    ``base`` with the scenario's size-distribution / source-skew overrides
    applied (unchanged if the scenario has none, e.g. purely temporal ones)."""
    spec = _REGISTRY[name]
    if not spec.instance_overrides:
        return base
    return dataclasses.replace(base, **spec.instance_overrides)


# -- built-in scenarios ------------------------------------------------------

register_scenario(
    "uniform_iid",
    lambda **kw: PoissonArrivals(**{"rate": 20.0, **kw}),
    description="Paper §V.A analogue: steady Poisson arrivals, U(0,1) sizes, "
                "uniform edge popularity.",
)

register_scenario(
    "hotspot_skew",
    lambda **kw: PoissonArrivals(**{"rate": 20.0, "edge_skew": 2.0, **kw}),
    description="Zipf(2) edge popularity: most traffic lands on one hot "
                "edge, stressing transfer-aware balancing.",
    instance_overrides={"source_skew": 2.0},
)

register_scenario(
    "heavy_tail_pareto",
    lambda **kw: PoissonArrivals(
        **{"rate": 20.0, "sizes": SizeSpec("pareto", (1.5, 0.05)), **kw}),
    description="Pareto(1.5) data sizes: elephant requests dominate the "
                "makespan.",
    instance_overrides={"size_dist": "pareto", "size_params": (1.5, 0.05)},
)

register_scenario(
    "lognormal_sizes",
    lambda **kw: PoissonArrivals(
        **{"rate": 20.0, "sizes": SizeSpec("lognormal", (-1.5, 0.8)), **kw}),
    description="Lognormal data sizes (multiplicative noise), the common "
                "fit for measured request footprints.",
    instance_overrides={"size_dist": "lognormal", "size_params": (-1.5, 0.8)},
)

register_scenario(
    "diurnal",
    lambda **kw: DiurnalArrivals(**{"base_rate": 20.0, "amplitude": 0.8,
                                    "period": 4.0, **kw}),
    description="Sinusoidal day/night cycle: load swings 10x between trough "
                "and peak.",
)

register_scenario(
    "flash_crowd_10x",
    lambda **kw: FlashCrowdArrivals(**{"base_rate": 10.0, "multiplier": 10.0,
                                       "spike_start": 1.0,
                                       "spike_duration": 0.5, **kw}),
    description="Steady base traffic plus a 10x flash crowd concentrated on "
                "one edge for a short window.",
    instance_overrides={"source_skew": 4.0},
)

register_scenario(
    "mmpp_bursty",
    lambda **kw: MMPPArrivals(**{"rates": (5.0, 80.0),
                                 "mean_sojourn": (2.0, 0.25), **kw}),
    description="2-state Markov-modulated Poisson: calm/burst regime "
                "switching (classic bursty edge traffic).",
)

# -- edge–cloud scenarios (tiered topology + service caches, schema v3) ------
# Arrivals carry service ids, deadlines, and priorities (ServiceMix); the
# registry also pins the cloud tier + cache laws so every consumer (engine,
# oracle, sweep, training) simulates the identical tiered cluster.

register_scenario(
    "cloud-cache-churn",
    lambda **kw: ServiceMix(
        PoissonArrivals(rate=kw.pop("rate", 40.0)),
        **{"num_services": 12, "skew": 0.5, "deadline": (1.0, 3.0), **kw}),
    description="Miss-heavy tier stress: 12 services churning through "
                "2-slot edge caches under overload, every request carrying "
                "a 1-3s deadline. Edges pay 1s cache-aside warm-ups; the "
                "always-hit cloud pays a 0.4s WAN round-trip instead. "
                "Deadline-aware, cache-aware dispatch is the whole game.",
    cloud_spec=CloudSpec(wan_rtt=0.4, wan_dist=1.5, lanes=12,
                         phi_a=0.2, phi_b=0.02),
    cache_spec=CacheSpec(slots=2, miss_penalty=1.0, num_services=12),
)

register_scenario(
    "cloud-burst-offload",
    lambda **kw: ServiceMix(
        MMPPArrivals(rates=kw.pop("rates", (8.0, 90.0)),
                     mean_sojourn=kw.pop("mean_sojourn", (2.0, 0.3))),
        **{"num_services": 6, "skew": 1.2, "deadline": (1.5, 4.0),
           "priorities": (3.0, 1.0), **kw}),
    description="Bursty MMPP traffic against a 16-lane cloud: calm phases "
                "fit on the edges (popular services stay cached), bursts "
                "must spill to the WAN. Tests elastic offload timing under "
                "deadlines and mixed priorities.",
    cloud_spec=CloudSpec(wan_rtt=0.3, wan_dist=1.2, lanes=16,
                         phi_a=0.25, phi_b=0.03),
    cache_spec=CacheSpec(slots=3, miss_penalty=0.6, num_services=6),
)

# -- chaos scenarios (resilience subsystem) ----------------------------------
# Same arrival vocabulary, plus a registered fault process: the engines
# apply the materialized trajectory identically (equivalence-tested), and
# temporal_train injects it into every training episode.

register_scenario(
    "chaos-rolling-failure",
    lambda **kw: PoissonArrivals(**{"rate": 180.0, **kw}),
    description="Overload + a rolling outage: each edge in turn goes down "
                "for two rounds mid-episode, orphaning its queue onto the "
                "survivors while arrivals outrun the degraded capacity. "
                "The admission-control proving ground.",
    fault_spec=FaultSpec(rolling=(2, 2)),
)

register_scenario(
    "chaos-flash-failure",
    lambda **kw: FlashCrowdArrivals(**{"base_rate": 10.0, "multiplier": 10.0,
                                       "spike_start": 1.0,
                                       "spike_duration": 0.5, **kw}),
    description="Flash crowd on edge 0 while that same edge fails during "
                "the spike window: failover and the crowd collide.",
    instance_overrides={"source_skew": 4.0},
    fault_spec=FaultSpec(scripted_failures=((0, 4, 8),)),
)

register_scenario(
    "chaos-straggler-storm",
    lambda **kw: PoissonArrivals(**{"rate": 25.0, **kw}),
    description="Markov straggler churn (5x slowdowns) plus lognormal "
                "per-request runtime jitter: perception must route around "
                "slow edges it was never told about.",
    fault_spec=FaultSpec(straggle_prob=0.2, straggle_recover_prob=0.5,
                         straggle_factor=5.0, jitter_sigma=0.15),
)
