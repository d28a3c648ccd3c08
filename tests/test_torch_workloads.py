"""The port's numpy copies of the workload, cluster and fault modules held
bit for bit against the JAX package's originals: ``serving/rounds.py`` and
``topology.py``, ``workloads/base.py``, ``processes.py``, ``scenarios.py``
(every registered scenario), ``trace.py`` (byte for byte against the
committed v1/v2 traces, read and write), the host paths of
``workloads/batch.py`` and ``resilience/faults.py``, and the numpy half of
``serving/cache.py``. Also: importing the port's engine loads neither jax
nor the reference."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.resilience import faults as jfaults
from repro.serving import cache as jcache
from repro.serving import rounds as jrounds
from repro.serving import topology as jtopo
from repro.workloads import base as jbase
from repro.workloads import batch as jbatch
from repro.workloads import scenarios as jscen
from repro.workloads import trace as jtrace
from repro_torch.resilience import faults as tfaults
from repro_torch.serving import cache as tcache
from repro_torch.serving import rounds as trounds
from repro_torch.serving import topology as ttopo
from repro_torch.workloads import base as tbase
from repro_torch.workloads import batch as tbatch
from repro_torch.workloads import processes as tproc
from repro_torch.workloads import scenarios as tscen
from repro_torch.workloads import trace as ttrace

DATA = Path(__file__).resolve().parent / "data"
SRC = Path(__file__).resolve().parents[1] / "src"
DT = 0.25
SCENARIOS = list(jscen.list_scenarios())


def _same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _arrivals(mod_scen, name, seed, num_edges=5, until=3.0):
    rng = np.random.default_rng((seed, 1_000_000_007))
    return [dataclasses.astuple(a) for a in
            mod_scen.scenario(name).arrivals(rng, num_edges, until)]


@pytest.mark.parametrize("q,seed", [(5, 0), (5, 7), (12, 3), (100, 1)])
def test_sample_cluster_and_cloud_row_are_bit_identical(q, seed):
    want = jrounds.sample_cluster(q, 4, 0.2, 1.0, seed)
    got = trounds.sample_cluster(q, 4, 0.2, 1.0, seed)
    _same_arrays(dataclasses.asdict(got), dataclasses.asdict(want))
    spec = jscen.scenario_cloud_spec("cloud-cache-churn")[0]
    _same_arrays(
        dataclasses.asdict(trounds.extend_cluster_with_cloud(got, spec)),
        dataclasses.asdict(jrounds.extend_cluster_with_cloud(want, spec)))
    size = np.linspace(0.0, 1.0, 7)
    for fn, args in ((trounds.transfer_delay, (1.0, size, 0.3)),
                     (trounds.exec_time, (0.5, 0.05, size))):
        np.testing.assert_array_equal(fn(*args),
                                      getattr(jrounds, fn.__name__)(*args))
    np.testing.assert_array_equal(
        trounds.service_runtime(0.5, 0.05, size, 2.0, 0.01, 0.3),
        jrounds.service_runtime(0.5, 0.05, size, 2.0, 0.01, 0.3))
    assert (trounds.MIN_RUNTIME, trounds.MIN_JITTER) == (
        jrounds.MIN_RUNTIME, jrounds.MIN_JITTER)


def test_nearest_alive_edge_matches():
    cl = jrounds.sample_cluster(6, 4, 0.2, 1.0, 2)
    for alive in ([True] * 6, [False, True, False, True, False, True],
                  [False] * 5 + [True]):
        for src in range(6):
            assert ttopo.nearest_alive_edge(cl.w, src, alive) == \
                jtopo.nearest_alive_edge(cl.w, src, alive)
    with pytest.raises(RuntimeError, match="no alive"):
        ttopo.nearest_alive_edge(cl.w, 0, [False] * 6)
    assert ttopo.CloudSpec() == ttopo.CloudSpec(**dataclasses.asdict(
        jtopo.CloudSpec()))


def test_registry_lists_the_same_scenarios():
    assert tscen.list_scenarios() == jscen.list_scenarios()
    assert len(SCENARIOS) == 12
    for name in SCENARIOS:
        j, t = jscen.scenario_spec(name), tscen.scenario_spec(name)
        assert t.description == j.description
        assert t.instance_overrides == j.instance_overrides
        for key in ("fault_spec", "cloud_spec", "cache_spec"):
            a, b = getattr(t, key), getattr(j, key)
            assert (a is None) == (b is None), key
            if a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b), key


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_arrivals_are_bit_identical(name):
    for seed in (0, 1, 5):
        want = _arrivals(jscen, name, seed)
        assert want, f"{name} drew no arrivals"
        assert _arrivals(tscen, name, seed) == want


def test_processes_and_mixes_with_overrides():
    """Each arrival process with non-default parameters, a 3-state MMPP
    (its uniform state jump), merges and a ServiceMix with priorities."""
    from repro.workloads import processes as jproc
    cases = [
        ("InhomogeneousPoisson", dict(rate_fn=lambda t: 10.0 * t,
                                      rate_max=30.0, edge_skew=1.0)),
        ("DiurnalArrivals", dict(base_rate=15.0, amplitude=0.5, period=2.0,
                                 phase=0.3, hot_edge=2)),
        ("FlashCrowdArrivals", dict(base_rate=8.0, multiplier=5.0,
                                    spike_edge=3)),
        ("MMPPArrivals", dict(rates=(5.0, 40.0, 0.0),
                              mean_sojourn=(0.5, 0.2, 0.3))),
        ("PoissonArrivals", dict(rate=12.0, sizes=None, edge_skew=0.5)),
    ]
    for cls, kw in cases:
        jkw, tkw = dict(kw), dict(kw)
        if "sizes" in kw:
            jkw["sizes"] = jbase.SizeSpec("lognormal", (-1.0, 0.5), cap=0.9)
            tkw["sizes"] = tbase.SizeSpec("lognormal", (-1.0, 0.5), cap=0.9)
        jw, tw = getattr(jproc, cls)(**jkw), getattr(tproc, cls)(**tkw)
        jw = jbase.ServiceMix(jbase.merge(jw, jproc.PoissonArrivals(rate=3.0)),
                              num_services=5, priorities=(1.0, 2.0),
                              deadline=(0.5, 1.0), deadline_frac=0.5)
        tw = tbase.ServiceMix(tbase.merge(tw, tproc.PoissonArrivals(rate=3.0)),
                              num_services=5, priorities=(1.0, 2.0),
                              deadline=(0.5, 1.0), deadline_frac=0.5)
        for seed in (0, 3):
            want = list(jw.arrivals(np.random.default_rng(seed), 6, 2.5))
            got = list(tw.arrivals(np.random.default_rng(seed), 6, 2.5))
            assert [dataclasses.astuple(a) for a in got] == \
                [dataclasses.astuple(a) for a in want], cls


def test_base_helpers_are_bit_identical():
    for skew, hot in ((0.0, 0), (1.5, 2), (64.0, 4)):
        np.testing.assert_array_equal(tbase.edge_weights(5, skew, hot),
                                      jbase.edge_weights(5, skew, hot))
    for dist, params in (("uniform", ()), ("fixed", (0.3,)),
                         ("pareto", ()), ("lognormal", (-1.0, 0.4))):
        np.testing.assert_array_equal(
            tbase.SizeSpec(dist, params).sample(np.random.default_rng(1), 9),
            jbase.SizeSpec(dist, params).sample(np.random.default_rng(1), 9))
        assert (tbase.SizeSpec(dist, params).sample_one(
            np.random.default_rng(2)) == jbase.SizeSpec(dist, params)
                .sample_one(np.random.default_rng(2)))
    assert tbase.workload_rng(3).random() == jbase.workload_rng(3).random()
    p = tbase.edge_weights(7, 1.0)
    assert [tbase.pick_edge(np.random.default_rng(s), p) for s in range(9)] \
        == [jbase.pick_edge(np.random.default_rng(s), p) for s in range(9)]


@pytest.mark.parametrize("name", ["uniform_iid", "mmpp_bursty",
                                  "cloud-cache-churn", "flash_crowd_10x"])
def test_materialize_rounds_and_batch_are_bit_identical(name):
    wl_t, wl_j = tscen.scenario(name), jscen.scenario(name)
    for seed in (0, 2):
        _same_arrays(tbatch.materialize_rounds(wl_t, 5, 12, DT, seed=seed),
                     jbatch.materialize_rounds(wl_j, 5, 12, DT, seed=seed))
    kw = dict(base_seed=3, max_per_round=6, overflow="clip")
    clipped = tbatch.materialize_round_batch(wl_t, 5, 8, DT, 4, **kw)
    _same_arrays(clipped, jbatch.materialize_round_batch(wl_j, 5, 8, DT, 4,
                                                         **kw))
    _same_arrays(tbatch.materialize_round_batch(wl_t, 5, 8, DT, 3),
                 jbatch.materialize_round_batch(wl_j, 5, 8, DT, 3))
    if clipped["dropped"].any():
        with pytest.raises(ValueError, match="max_per_round"):
            tbatch.materialize_round_batch(wl_t, 5, 8, DT, 4, base_seed=3,
                                           max_per_round=6)
    with pytest.raises(ValueError, match="overflow"):
        tbatch.materialize_rounds(wl_t, 5, 8, DT, overflow="drop")
    assert tbatch.DEADLINE_INF == jbatch.DEADLINE_INF


def test_materialize_rejects_out_of_horizon_arrivals():
    events = (tbase.Arrival(t=0.1, edge=0, size=0.5),
              tbase.Arrival(t=0.2, edge=9, size=0.5))
    with pytest.raises(ValueError, match="edge 9"):
        tbatch.materialize_rounds(ttrace.TraceWorkload(events=events), 5, 4,
                                  DT)


FAULT_SPECS = [
    jscen.scenario_fault_spec("chaos-rolling-failure"),
    jscen.scenario_fault_spec("chaos-flash-failure"),
    jscen.scenario_fault_spec("chaos-straggler-storm"),
    jfaults.FaultSpec(fail_prob=0.3, recover_prob=0.4, min_alive=2,
                      scripted_stragglers=((1, 2, 5, 3.0),)),
]


@pytest.mark.parametrize("spec", FAULT_SPECS, ids=range(len(FAULT_SPECS)))
def test_fault_host_paths_are_bit_identical(spec):
    tspec = tfaults.FaultSpec(**dataclasses.asdict(spec))
    assert tspec.has_faults == spec.has_faults
    for seed in (0, 4):
        _same_arrays(tfaults.materialize_faults(tspec, 5, 12, seed=seed),
                     jfaults.materialize_faults(spec, 5, 12, seed=seed))
        np.testing.assert_array_equal(
            tfaults.jitter_table(tspec, 50, seed=seed),
            jfaults.jitter_table(spec, 50, seed=seed))
    assert tfaults.fault_rng(2).random() == jfaults.fault_rng(2).random()
    arr = jbatch.materialize_round_batch(jscen.scenario("uniform_iid"), 5, 12,
                                         DT, 3, base_seed=1)
    _same_arrays(tfaults.attach_fault_batch(arr, tspec, 5, seeds=[4, 5, 6]),
                 jfaults.attach_fault_batch(arr, spec, 5, seeds=[4, 5, 6]))
    one = {k: v[0] for k, v in arr.items()}
    ev = jfaults.materialize_faults(spec, 5, 12, seed=1)
    table = jfaults.jitter_table(spec, 80, seed=1)
    _same_arrays(tfaults.attach_faults(one, ev, table),
                 jfaults.attach_faults(one, ev, table))
    with pytest.raises(ValueError, match="fault seeds"):
        tfaults.attach_fault_batch(arr, tspec, 5, seeds=[1])
    with pytest.raises(ValueError, match="fault events cover"):
        tfaults.attach_faults(one, {k: v[:3] for k, v in ev.items()})


def test_trace_v1_reads_and_writes_byte_for_byte(tmp_path):
    path = DATA / "trace_v1.jsonl"
    got, want = ttrace.read_trace(str(path)), jtrace.read_trace(str(path))
    assert got.schema == want.schema == ttrace.SCHEMA_V1
    assert [dataclasses.astuple(a) for a in got.events] == \
        [dataclasses.astuple(a) for a in want.events]
    assert got.meta == want.meta and got.num_edges == want.num_edges
    out = tmp_path / "v1.jsonl"
    ttrace.record_trace(str(out), tscen.scenario("uniform_iid"), num_edges=4,
                        until=2.0, seed=42)
    assert out.read_bytes() == path.read_bytes()
    again = tmp_path / "again.jsonl"
    ttrace.write_trace(str(again), got.events, num_edges=4, meta=got.meta)
    assert again.read_bytes() == path.read_bytes()


def test_trace_v2_reads_and_writes_byte_for_byte(tmp_path):
    path = DATA / "trace_v2.jsonl"
    got, want = ttrace.read_trace(str(path)), jtrace.read_trace(str(path))
    assert got.schema == want.schema == ttrace.SCHEMA_V2
    assert got.fault_events and [dataclasses.astuple(e) for e in
                                 got.fault_events] == \
        [dataclasses.astuple(e) for e in want.fault_events]
    assert [dataclasses.astuple(a) for a in got.events] == \
        [dataclasses.astuple(a) for a in want.events]
    out = tmp_path / "v2.jsonl"
    ttrace.write_trace(str(out), got.events, num_edges=got.num_edges,
                       meta=got.meta, fault_events=got.fault_events)
    assert out.read_bytes() == path.read_bytes()


def test_trace_v3_round_trip_matches_reference_bytes(tmp_path):
    """A deadline/priority stream writes the same v3 bytes from both
    packages, and the readers agree; malformed files raise alike."""
    kw = dict(num_services=5, skew=0.7, deadline=(1.0, 2.5),
              priorities=(2.0, 1.0))
    jw = jbase.ServiceMix(jscen.scenario("uniform_iid"), **kw)
    tw = tbase.ServiceMix(tscen.scenario("uniform_iid"), **kw)
    a, b = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jtrace.record_trace(str(a), jw, num_edges=4, until=2.0, seed=3)
    ttrace.record_trace(str(b), tw, num_edges=4, until=2.0, seed=3)
    assert a.read_bytes() == b.read_bytes()
    assert ttrace.read_trace(str(b)).schema == ttrace.SCHEMA_V3
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"schema": "corais.trace.v1", "num_edges": 3}\n'
                   '{"t": 0.1, "edge": 0, "size": 0.5, "deadline": 1.0}\n')
    with pytest.raises(ValueError, match="corais.trace.v3"):
        ttrace.read_trace(str(bad))
    with pytest.raises(ValueError, match="fault kind"):
        ttrace.FaultEvent(t=0.5, kind="explode", edge=0)


def test_cache_numpy_half_is_bit_identical():
    for spec in (jcache.CacheSpec(), jcache.CacheSpec(slots=3, warm=False),
                 jcache.CacheSpec(slots=2, num_services=12)):
        tspec = tcache.CacheSpec(**dataclasses.asdict(spec))
        np.testing.assert_array_equal(tcache.initial_cache(6, 5, tspec),
                                      jcache.initial_cache(6, 5, spec))
        th, jh = tcache.HostCache(6, 5, tspec), jcache.HostCache(6, 5, spec)
        rng = np.random.default_rng(0)
        for node, svc in zip(rng.integers(0, 6, 60), rng.integers(0, 8, 60)):
            assert th.access(node, svc) == jh.access(node, svc)
            assert th.hit_fraction(node, [1, 2, 3]) == \
                jh.hit_fraction(node, [1, 2, 3])
        np.testing.assert_array_equal(th.cache, jh.cache)
        assert (th.hits, th.misses) == (jh.hits, jh.misses)
    assert tcache.CACHE_EMPTY == jcache.CACHE_EMPTY


def test_port_engine_imports_neither_jax_nor_the_reference():
    code = ("import sys; import repro_torch.serving.engine, "
            "repro_torch.core.evaluate, repro_torch.workloads, "
            "repro_torch.resilience.faults; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
