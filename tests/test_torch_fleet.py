"""The port's fleet-sharded rollouts (``repro_torch.serving.fleet``), meshes
(``launch/mesh.py``) and fleet specs (``sharding/specs.py``) against the
JAX reference, on the CPU.

The partition numpy is held to the reference's bit for bit. The fleet
rollout runs at W = 1 in this process and at W = 2 as two ranks: this file
re-runs itself as one subprocess per rank (``python
tests/test_torch_fleet.py --rank r --world 2 --store ... --out ...``),
joined over gloo through a ``FileStore`` under the test's ``tmp_path`` (no
TCP rendezvous port), each subprocess given 120 s and the group 60 s, so a
hang fails in seconds. Both are held, on ``zipf_partition(16, 2,
skew=0.9, seed=1)``'s placement order (``tests/fleet_child.py``'s), to the
reference's single-device ``make_rollout(batch=True)`` plus
``summarize_partials`` with ``greedy`` and ``local``, and to the port's
single-device engine with ``"policy"`` on the plain head, greedy and
sampled (best-of-n from a seeded generator, which the fleet hands each
rank as a block of the global batch's draws): counts, histograms and the
displaced and cross-shard accounting exactly, floats to 1e-5. The reference's own sharded fleet tests cannot run on this jax (C3),
so its single-device engine is the bar. Checks that need a world larger
than the ranks at hand (mesh bounds, an indivisible batch) run on
PyTorch's fake process group of 3, which raises before any collective.
"""
import argparse
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core.inference import DecisionSpec  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from repro_torch.serving import fleet as tfleet  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402
from repro_torch.workloads import batch as tbatch  # noqa: E402
from repro_torch.workloads import scenarios as tscen  # noqa: E402

Q, ROUNDS, DT, B, SHARDS = 5, 8, 0.25, 16, 2
SKEW, PART_SEED = 0.9, 1
BACKENDS = ("greedy", "local", "policy", "policy-sample")
SAMPLE_SPEC = DecisionSpec(mode="sample", num_samples=8, num_candidates=3)
SAMPLE_SEED = 11
SMALL = dict(d_model=32, ff_hidden=64, edge_layers=1, request_layers=1)
RANK_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
COUNT_KEYS = ("completed", "submitted", "shed_requests", "dropped_requests",
              "stranded_requests", "retried_requests", "displaced_instances",
              "transferred", "cross_shard_transferred",
              "intra_fleet_transferred", "cross_shard_completed",
              "per_edge_completed", "deadline_total", "deadline_missed",
              "cache_hits", "cache_misses", "cloud_completed")
FLOAT_KEYS = ("mean_response", "max_response", "makespan",
              "transferred_frac", "cross_shard_frac", "p50_response",
              "p95_response")


# -- the rollout batch, the same in every process -----------------------------


def _batch():
    """(cfg, states, arrivals, partition) in placement order: the numpy
    arrivals (the reference's bit for bit), init_batch states on the
    CPU."""
    arr = tbatch.materialize_round_batch(tscen.scenario("uniform_iid"), Q,
                                         ROUNDS, DT, B, base_seed=0)
    cfg = te.EngineConfig(num_edges=Q, num_rounds=ROUNDS, round_interval=DT,
                          max_per_round=arr["mask"].shape[-1])
    part = tfleet.zipf_partition(B, SHARDS, skew=SKEW, seed=PART_SEED)
    states = te.init_batch(cfg, range(B), device="cpu")
    return (cfg, tfleet.apply_partition(part, states),
            tfleet.apply_partition(part, arr), part)


def _assign(name):
    if not name.startswith("policy"):
        return te.resolve_assign_fn(name)
    policy = tpol.CoRaiSPolicy(tpol.PolicyConfig(**SMALL),
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    if name == "policy-sample":
        return te.resolve_assign_fn("policy", policy=policy, spec=SAMPLE_SPEC)
    return te.resolve_assign_fn(name, policy=policy)


def _generator(name):
    """A fresh seeded generator for the sampled backend, None otherwise."""
    if name != "policy-sample":
        return None
    return torch.Generator().manual_seed(SAMPLE_SEED)


def _host(partials):
    return {k: v.numpy().copy() for k, v in partials.items()}


def _fleet_partials(mesh):
    """{backend: reduced partials} of the fleet rollout on ``mesh``."""
    cfg, states, arr, part = _batch()
    return {name: _host(tfleet.make_fleet_rollout(cfg, _assign(name), mesh)(
        states, arr, _generator(name), displaced=part.placed_displaced))
        for name in BACKENDS}


# -- the ranks ----------------------------------------------------------------


def _rank_main(rank, world, out):
    """One rank of the W = 2 run: the fleet rollout on the whole world, the
    bounds of a world of two, and a one-shard subset mesh."""
    result = {"partials": _fleet_partials(tmesh.make_fleet_mesh(
        device="cpu"))}
    for bad in (0, world + 1):
        try:
            tmesh.make_fleet_mesh(bad, device="cpu")
        except ValueError as e:
            result[f"fleet_{bad}"] = str(e)
    # the subset mesh of the first rank: rank 0 rolls the whole batch
    # alone, rank 1 is not on it
    sub = tmesh.make_fleet_mesh(1, device="cpu")
    cfg, states, arr, part = _batch()
    if rank == 0:
        result["subset"] = _host(tfleet.make_fleet_rollout(
            cfg, te.greedy_assign, sub)(states, arr,
                                        displaced=part.placed_displaced))
    else:
        try:
            tfleet.make_fleet_rollout(cfg, te.greedy_assign, sub)
        except ValueError as e:
            result["subset"] = str(e)
    torch.save(result, Path(out) / f"rank{rank}.pt")


def _spawn_ranks(tmp_path, world=2):
    """Start this file as ``world`` ranks; returns a join function giving
    each rank's saved result."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    store = tmp_path / "store"
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), "--world",
                 str(world), "--store", str(store), "--out", str(tmp_path)],
                env=env, stdout=log, stderr=subprocess.STDOUT))

    def join():
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            pytest.fail(f"a rank did not finish within {RANK_TIMEOUT_S} s")
        for r, p in enumerate(procs):
            assert p.returncode == 0, \
                f"rank {r} failed:\n{logs[r].read_text()[-4000:]}"
        return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
                for r in range(world)]

    return join


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """Destroy any process group a test started."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    """{backend: summary} of the reference's single-device engine on the
    placement order (greedy, local), and of the port's single-device engine
    (policy and policy-sample, on the plain head)."""
    import jax

    from repro.serving import engine as je
    cfg, states, arr, part = _batch()
    jcfg = je.EngineConfig(num_edges=Q, num_rounds=ROUNDS, round_interval=DT,
                           max_per_round=cfg.max_per_round)
    jstates = {k: v.numpy() for k, v in states.items()}
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(0), B))
    out = {}
    for name in ("greedy", "local"):
        final, _ = je.make_rollout(jcfg, je.ASSIGN_FNS[name], batch=True)(
            jstates, arr, keys)
        out[name] = je.partials_to_summary(je.summarize_partials(
            final, displaced=part.placed_displaced))
    for name in ("policy", "policy-sample"):
        final, _ = te.make_rollout(cfg, _assign(name), batch=True)(
            states, arr, _generator(name))
        out[name] = te.partials_to_summary(te.summarize_partials(
            final, displaced=part.placed_displaced))
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    join = _spawn_ranks(tmp_path_factory.mktemp("fleet_w2"))
    return join()


@pytest.fixture(scope="module")
def one_rank():
    try:
        return _fleet_partials(tmesh.make_fleet_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()


def _assert_summary(got, want, where):
    for k in COUNT_KEYS:
        assert got[k] == want[k], (where, k, got[k], want[k])
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=f"{where} {k}")


# -- partition, specs, meshes -------------------------------------------------


@pytest.mark.parametrize("b,s,skew,seed", [(16, 2, 0.9, 1), (64, 8, 1.2, 0),
                                           (12, 3, 0.0, 5), (40, 4, 2.0, 7),
                                           (7, 1, 1.0, 3)])
def test_zipf_partition_matches_reference(b, s, skew, seed):
    from repro.serving import fleet as jfleet
    got = tfleet.zipf_partition(b, s, skew=skew, seed=seed)
    want = jfleet.zipf_partition(b, s, skew=skew, seed=seed)
    for k in ("home", "shard", "order", "displaced", "placed_displaced"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    loads = np.random.default_rng(seed).integers(0, 50, b)
    for kw in ({}, {"loads": loads}):
        assert got.imbalance_report(**kw) == want.imbalance_report(**kw)
    assert np.bincount(got.shard, minlength=s).tolist() == [b // s] * s


def test_zipf_partition_rejects_indivisible_batch():
    with pytest.raises(ValueError, match="equal blocks"):
        tfleet.zipf_partition(10, 4)


def test_apply_partition_reorders_numpy_and_tensors():
    part = tfleet.zipf_partition(8, 2, skew=1.0, seed=2)
    tree = {"a": np.arange(8), "b": torch.arange(16).reshape(8, 2)}
    out = tfleet.apply_partition(part, tree)
    assert isinstance(out["a"], np.ndarray)
    np.testing.assert_array_equal(out["a"], np.arange(8)[part.order])
    assert isinstance(out["b"], torch.Tensor) and out["b"].device.type == "cpu"
    np.testing.assert_array_equal(out["b"].numpy(),
                                  np.arange(16).reshape(8, 2)[part.order])


def test_specs_shard_the_instance_axis_and_reject_scalars():
    from torch.distributed.tensor import Shard
    cfg, states, arr, _ = _batch()
    for specs in (tspecs.engine_state_specs(states),
                  tspecs.arrival_specs(arr)):
        assert all(p == (Shard(0),) for p in specs.values())
    block = tspecs.local_block(arr, tspecs.arrival_specs(arr), 1, 2)
    for k, v in arr.items():
        np.testing.assert_array_equal(block[k], v[B // 2:])
    for fn in (tspecs.engine_state_specs, tspecs.arrival_specs):
        with pytest.raises(ValueError, match="leading instance axis"):
            fn({"t": torch.zeros(())})
        with pytest.raises(ValueError, match="leading instance axis"):
            fn({"t": np.float32(0.0)})


def _fake_world(n):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def test_mesh_bounds_on_a_world_of_three():
    _fake_world(3)
    assert tmesh.make_fleet_mesh(device="cpu").shape == (3,)
    assert tmesh.make_fleet_mesh(2, device="cpu").shape == (2,)
    for bad in (0, 4):
        with pytest.raises(ValueError, match=r"3 device\(s\) available"):
            tmesh.make_fleet_mesh(bad, device="cpu")


def test_world_of_one_starts_on_a_file_store():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_fleet_mesh()
    assert not dist.is_initialized()
    mesh = tmesh.make_fleet_mesh(device="cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert mesh.shape == (1,) and mesh.mesh_dim_names == ("fleet",)
    assert tmesh.mesh_axis(mesh, "fleet")[1:] == (0, 1)
    with pytest.raises(ValueError, match="no axis"):
        tmesh.mesh_axis(mesh, "data")
    with pytest.raises(RuntimeError, match="NCCL"):
        tmesh._check_backend(torch.device("cuda"))


def test_fleet_rollout_rejects_indivisible_batch():
    """B = 16 over a 3-rank axis fails before any device work."""
    cfg, states, arr, _ = _batch()
    _fake_world(3)
    run = tfleet.make_fleet_rollout(cfg, te.greedy_assign,
                                    tmesh.make_fleet_mesh(device="cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        run(states, arr)


# -- the fleet rollout --------------------------------------------------------


@pytest.mark.parametrize("name", BACKENDS)
def test_fleet_rollout_one_rank_matches_single_device(name, one_rank,
                                                      reference):
    got = tfleet.fleet_summary(one_rank[name])
    _assert_summary(got, reference[name], f"W=1 {name}")
    assert got["completed"] > 0 and got["displaced_instances"] > 0


@pytest.mark.parametrize("name", BACKENDS)
def test_fleet_rollout_two_ranks_match_single_device(name, two_ranks,
                                                     reference):
    got = tfleet.fleet_summary(two_ranks[0]["partials"][name])
    _assert_summary(got, reference[name], f"W=2 {name}")
    assert got["completed"] > 0
    # the skewed partition displaced someone, so the cross-shard split is
    # exercised and not vacuously zero
    assert got["displaced_instances"] > 0
    assert got["cross_shard_transferred"] > 0 or name == "local"


def test_sampled_backend_is_not_the_greedy_one(reference):
    """The sampled backend's best-of-n took decisions greedy would not, so
    its fleet cases test where each rank's draws come from."""
    assert reference["policy-sample"]["mean_response"] != \
        reference["policy"]["mean_response"]


def test_fleet_ranks_return_the_same_partials(two_ranks):
    r0, r1 = (r["partials"] for r in two_ranks)
    for name in BACKENDS:
        assert set(r0[name]) == set(r1[name])
        for k, v in r0[name].items():
            assert v.dtype == r1[name][k].dtype
            assert np.array_equal(v, r1[name][k]), (name, k)


def test_fleet_world_of_two_bounds_and_subset_mesh(two_ranks, reference):
    r0, r1 = two_ranks
    for bad in (0, 3):
        assert "fleet mesh" in r0[f"fleet_{bad}"]
    _assert_summary(tfleet.fleet_summary(r0["subset"]), reference["greedy"],
                    "one-shard subset mesh")
    assert "not on this" in r1["subset"]


def test_fleet_summary_is_partials_to_summary(one_rank):
    for slo in (None, 2.0):
        assert tfleet.fleet_summary(one_rank["greedy"], slo=slo) == \
            te.partials_to_summary(one_rank["greedy"], slo=slo)


def test_partials_reduce_in_three_packed_collectives(monkeypatch):
    """One all-reduce per (dtype, operation), MAX for the max keys."""
    cfg, states, arr, part = _batch()
    final, _ = te.make_rollout(cfg, te.greedy_assign, batch=True)(states,
                                                                  arr)
    partials = te.summarize_partials(final, displaced=part.placed_displaced)
    calls = []

    def all_reduce(t, op=dist.ReduceOp.SUM, group=None):
        calls.append((t.dtype, op, t.numel()))

    monkeypatch.setattr(tfleet.dist, "all_reduce", all_reduce)
    out = tfleet.all_reduce_partials(partials, None)
    assert len(calls) == 3
    assert {(d, o) for d, o, _ in calls} == {
        (torch.int32, dist.ReduceOp.SUM), (torch.float32, dist.ReduceOp.SUM),
        (torch.float32, dist.ReduceOp.MAX)}
    assert sum(n for *_, n in calls) == sum(v.numel()
                                            for v in partials.values())
    for k, v in partials.items():
        assert torch.equal(out[k], v), k


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(a.store, a.world), rank=a.rank,
        world_size=a.world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        _rank_main(a.rank, a.world, a.out)
    finally:
        dist.destroy_process_group()
