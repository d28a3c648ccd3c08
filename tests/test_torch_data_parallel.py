"""The port's data-parallel temporal REINFORCE (``make_temporal_epoch_step``
and ``temporal_train`` with ``mesh=``), its sharding-free draws and the
int8-compressed all-reduce (``optim/grad_utils.py``), on the CPU.

W = 2 runs as two ranks: this file re-runs itself as one subprocess per
rank (``python tests/test_torch_data_parallel.py --rank r --world 2 --store
... --job ...``), joined over gloo through a ``FileStore`` under
``tmp_path`` (no TCP rendezvous port), each subprocess given 120 s and the
group 60 s. What a rank needs (configs, parameters, injected draws) comes
in a pickled job file, and each rank saves its results for this process to
compare.

* Sharded equals unsharded: the W = 2 epoch step (K = 2 updates, B = 8)
  equals the unsharded one on the same seeds, parameters and Adam state to
  1e-5, metrics to 1e-4, for ``norm="layer"``, a warmed BatchNorm
  (count > 0) and two faulted chaos scenarios, one with the admit head;
  Adam's ``eps=1e-3``, for the reason ``tests/train_child.py`` gives (a
  near-zero gradient's reassociation noise would otherwise move a
  parameter by a sign-like 2 * lr). ``temporal_train(mesh=)`` equals the
  meshless epoch loop, history to 1e-4, and resumes from rank 0's
  checkpoint bit for bit. The two ranks' parameters are the same bits.
* Sharded equals the reference: with the reference's draws injected (the
  ``_reference_loss`` pattern of ``tests/test_torch_temporal.py``), the
  W = 2 loss and gradients averaged over the ranks, and the global aux,
  equal the reference's meshless loss, aux and gradients at that file's
  tolerances, and the W = 2 update equals the reference's clip and Adam
  step on its gradients.
* The draws: the Gumbel-max dispatch and the admit draw follow the
  policy's probabilities (a TV bound at a fixed seed), and neither depends
  on how the batch is split.
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

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.core import decode as tdec  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh  # noqa: E402
from repro_torch.nn import param_tree  # noqa: E402
from repro_torch.optim import (AdamConfig, adam_init,  # noqa: E402
                               compressed_psum, dequantize_int8,
                               quantize_int8)
from repro_torch.serving import engine as te  # noqa: E402

B, K = 8, 2
SMALL = dict(d_model=32, ff_hidden=64, edge_layers=1, request_layers=1)
ENGINE = dict(num_edges=3, num_rounds=4, max_per_round=8)
RANK_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
TOL = 1e-4          # tests/test_torch_temporal.py's loss, aux and gradients
STEP_CASES = {
    "layer": ("uniform_iid", dict(norm="layer"), {}, False),
    "batch-warm": ("uniform_iid", dict(norm="batch"), {}, True),
    "chaos-straggler-storm": ("chaos-straggler-storm", dict(norm="layer"),
                              {}, False),
    "chaos-rolling-failure": ("chaos-rolling-failure",
                              dict(norm="layer", admit_head=True,
                                   admit_hidden=8),
                              dict(admission=True, slo=3.0, slo_penalty=2.0),
                              False),
}
REFERENCE_CASES = ("uniform_iid", "chaos-rolling-failure")
PSUM_SHAPE = (8, 64)


def _cfg(scenario, policy_kw, cfg_kw, **kw):
    return ttrain.TemporalRLConfig(
        policy=tpol.PolicyConfig(**SMALL, **policy_kw),
        engine=te.EngineConfig(**ENGINE), scenario=scenario, batch_size=B,
        lr=2e-5, num_batches=2 * K, seed=0, device_episodes=True,
        epoch_len=K, **cfg_kw, **kw)


def _adam(cfg):
    return AdamConfig(lr=cfg.lr, eps=1e-3)


def _policy(cfg, warm=False):
    policy = tpol.CoRaiSPolicy(cfg.policy,
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    if warm:
        for buf in policy.buffers():
            if buf.ndim == 0:
                buf.fill_(1.0)   # count > 0: the running statistics rule
    return policy


def _epoch_inputs(cfg):
    sim0 = te.init_batch(cfg.engine, np.concatenate(
        [ttrain._cluster_seeds(cfg, b) for b in range(K)]), device="cpu")
    sim0 = {k: v.reshape(K, B, *v.shape[1:]) for k, v in sim0.items()}
    return sim0, np.stack([ttrain._episode_seeds(cfg, b) for b in range(K)])


def _params(policy):
    return {k: p.detach().clone() for k, p in param_tree(policy).items()}


def _run_step(name, mesh=None):
    """(params, opt_state, metrics) after one K-update epoch step."""
    scenario, pkw, ckw, warm = STEP_CASES[name]
    cfg = _cfg(scenario, pkw, ckw)
    policy = _policy(cfg, warm)
    step, adam_cfg = ttrain.make_temporal_epoch_step(cfg, _adam(cfg),
                                                     mesh=mesh)
    opt, mets = step(policy, adam_init(param_tree(policy), adam_cfg),
                     *_epoch_inputs(cfg))
    return _params(policy), opt, mets


def _train_cfg():
    return _cfg("uniform_iid", dict(norm="layer"), {})


def _psum_input(rank):
    return (np.random.default_rng(100 + rank).standard_normal(PSUM_SHAPE)
            * 3.0).astype(np.float32)


# -- the ranks ----------------------------------------------------------------


def _rank_steps(rank, world, job):
    mesh = make_fleet_mesh(device="cpu")
    out = {"steps": {name: _run_step(name, mesh) for name in STEP_CASES}}
    cfg = _train_cfg()
    policy, opt, hist = ttrain.temporal_train(cfg, mesh=mesh,
                                              adam_cfg=_adam(cfg),
                                              device="cpu")
    out["train"] = (_params(policy), opt, hist)
    ck = job["checkpoints"]
    for _ in range(2):   # the second run resumes from the first's save
        policy, opt, hist = ttrain.temporal_train(
            cfg, num_batches=2, mesh=mesh, adam_cfg=_adam(cfg),
            checkpointer=Checkpointer(ck, every=2), device="cpu")
    out["resumed"] = (_params(policy), opt, hist)
    out["psum"] = compressed_psum(torch.from_numpy(_psum_input(rank)))
    return out


def _rank_reference(rank, world, job):
    """The W = 2 loss and gradients averaged over the ranks, the global aux
    and one update, each rank on its block with the reference's draws."""
    mesh = make_fleet_mesh(device="cpu")
    group = mesh.get_group("fleet")
    out = {}
    for name, case in job["cases"].items():
        cfg = case["cfg"]
        b = cfg.batch_size // world
        rows = slice(rank * b, (rank + 1) * b)
        policy = tpol.CoRaiSPolicy(cfg.policy, device="cpu")
        policy.load_state_dict(case["state_dict"])
        sim = te.init_batch(cfg.engine, case["seeds"][rows], device="cpu")
        arr = {k: v[rows] for k, v in case["arrivals"].items()}
        draws = dict(actions=torch.as_tensor(case["actions"][:, rows]),
                     admits=(None if case["admits"] is None
                             else torch.as_tensor(case["admits"][:, rows])))
        loss, aux, grads = ttrain.temporal_loss_and_grads(
            policy, sim, arr, cfg, group=group, **draws)
        loss, grads = ttrain._group_mean(loss, grads, group)
        adam_cfg = _adam(cfg)
        opt, mets = ttrain._temporal_update(
            policy, adam_init(param_tree(policy), adam_cfg), sim, arr, cfg,
            adam_cfg, group=group, **draws)
        out[name] = {"loss": loss, "aux": aux, "grads": grads,
                     "params": _params(policy), "metrics": mets}
    return out


RANK_JOBS = {"steps": _rank_steps, "reference": _rank_reference}


def _spawn_ranks(tmp_path, kind, job, world=2):
    """Start this file as ``world`` ranks on ``job``; returns a join
    function giving each rank's saved result."""
    job_file = tmp_path / "job.pt"
    torch.save(dict(job, kind=kind), job_file)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), "--world",
                 str(world), "--store", str(tmp_path / "store"), "--job",
                 str(job_file)],
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
        return [torch.load(tmp_path / f"rank{r}.out.pt", weights_only=False)
                for r in range(world)]

    return join


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """Destroy any process group a test started."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(unsharded results in this process, the two ranks' results)."""
    tmp = tmp_path_factory.mktemp("dp_steps")
    join = _spawn_ranks(tmp, "steps", {"checkpoints": str(tmp / "ck")})
    cfg = _train_cfg()
    policy, opt, hist = ttrain.temporal_train(cfg, adam_cfg=_adam(cfg),
                                              device="cpu")
    local = {"steps": {name: _run_step(name) for name in STEP_CASES},
             "train": (_params(policy), opt, hist)}
    return local, join()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's meshless loss, aux, gradients and update with its
    own draws recorded (per case), and the two ranks' results on those
    draws."""
    from repro.optim import adam_init as j_adam_init
    from repro.optim import adam_update as j_adam_update
    from repro.optim import clip_by_global_norm as j_clip
    from repro.optim.adam import AdamConfig as JAdamConfig
    from repro.serving import engine as je
    from test_torch_temporal import _reference_loss, _setup

    want, cases = {}, {}
    for name in REFERENCE_CASES:
        # LayerNorm: an untrained BatchNorm pools its fallback statistics
        # over the rank's block, which is not the reference's batch
        jcfg, tcfg, params, state, policy, arrivals, seeds = _setup(
            name, policy_kw=dict(norm="layer"))
        loss, aux, flat, _, acts, adms = _reference_loss(
            jcfg, params, state, je.init_batch(jcfg.engine, seeds), arrivals)
        p0 = {k: p.detach().numpy().copy()
              for k, p in param_tree(policy).items()}
        jadam = JAdamConfig(lr=tcfg.lr, eps=1e-3)
        clipped, gnorm = j_clip(flat, tcfg.grad_clip)
        new, _ = j_adam_update(p0, clipped, j_adam_init(p0, jadam), jadam)
        want[name] = {"loss": loss, "aux": aux, "grads": flat,
                      "grad_norm": float(gnorm), "lr": tcfg.lr,
                      "params": {k: np.asarray(v) for k, v in new.items()}}
        cases[name] = {"cfg": tcfg, "state_dict": policy.state_dict(),
                       "seeds": seeds, "arrivals": arrivals,
                       "actions": acts, "admits": adms}
    got = _spawn_ranks(tmp_path_factory.mktemp("dp_reference"), "reference",
                       {"cases": cases})()
    return want, got


# -- sharded equals unsharded -------------------------------------------------


def _assert_trees(got: dict, want: dict, tol, where):
    assert set(got) == set(want), where
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            torch.testing.assert_close(got[k], w, rtol=tol, atol=tol,
                                       msg=lambda m: f"{where} {k}: {m}")


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_epoch_step_equals_unsharded(name, steps):
    (p1, o1, m1), ranks = steps[0]["steps"][name], steps[1]
    p2, o2, m2 = ranks[0]["steps"][name]
    _assert_trees(p2, p1, 1e-5, f"{name} params")
    assert int(o2["step"]) == int(o1["step"]) == K
    for moment in ("m", "v"):
        _assert_trees(o2[moment], o1[moment], 1e-5, f"{name} adam {moment}")
    assert set(m2) == set(m1)
    for k, v in m1.items():
        torch.testing.assert_close(m2[k], v, rtol=TOL, atol=1e-5,
                                   msg=lambda m: f"{name} metric {k}: {m}")
    assert (m1["completed"] > 0).all()


def test_ranks_hold_the_same_parameter_bits(steps):
    r0, r1 = steps[1]
    for name in STEP_CASES:
        for k, v in r0["steps"][name][0].items():
            assert torch.equal(v, r1["steps"][name][0][k]), (name, k)
    for run in ("train", "resumed"):
        for k, v in r0[run][0].items():
            assert torch.equal(v, r1[run][0][k]), (run, k)
        assert r0[run][2] and [
            {k: v for k, v in row.items() if k != "sec"}
            for row in r0[run][2]] == [
            {k: v for k, v in row.items() if k != "sec"}
            for row in r1[run][2]]


def test_temporal_train_on_a_mesh_equals_the_meshless_loop(steps):
    (p1, _, h1), (p2, _, h2) = steps[0]["train"], steps[1][0]["train"]
    _assert_trees(p2, p1, 1e-5, "temporal_train params")
    assert [r["batch"] for r in h2] == [r["batch"] for r in h1] == [0, 1, 2,
                                                                    3]
    for a, b in zip(h1, h2):
        assert set(a) == set(b)
        for k in a:
            if k not in ("batch", "sec"):
                assert b[k] == pytest.approx(a[k], rel=TOL, abs=1e-5), k


def test_temporal_train_on_a_mesh_resumes_from_rank0_checkpoint(steps):
    """Rank 0 alone writes; both ranks restore its step-2 save and replay
    batches 2 and 3 exactly as the uninterrupted sharded run did."""
    for rank in steps[1]:
        (pf, of, hf), (pr, o_r, hr) = rank["train"], rank["resumed"]
        assert [r["batch"] for r in hr] == [2, 3]
        assert int(o_r["step"]) == int(of["step"]) == 4
        for k, v in pf.items():
            assert torch.equal(pr[k], v), k
        for a, b in zip(hf[2:], hr):
            assert {k: v for k, v in a.items() if k != "sec"} == \
                {k: v for k, v in b.items() if k != "sec"}


def test_sharded_step_on_one_rank_is_bit_identical():
    """At W = 1 the block is the whole batch: the same draws and the same
    arithmetic, so the same bits as the unsharded step."""
    mesh = make_fleet_mesh(device="cpu")
    p1, o1, m1 = _run_step("chaos-rolling-failure")
    p2, o2, m2 = _run_step("chaos-rolling-failure", mesh)
    for a, b in ((p1, p2), (o1["m"], o2["m"]), (o1["v"], o2["v"]),
                 (m1, m2)):
        for k, v in a.items():
            assert torch.equal(b[k], v), k


# -- sharded equals the reference ---------------------------------------------


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_sharded_loss_and_gradients_equal_the_reference(name, reference):
    want, ranks = reference[0][name], [r[name] for r in reference[1]]
    for got in ranks:
        assert float(got["loss"]) == pytest.approx(want["loss"], rel=TOL,
                                                   abs=TOL)
        assert set(got["aux"]) == set(want["aux"])
        for k, v in want["aux"].items():
            assert float(got["aux"][k]) == pytest.approx(v, rel=TOL,
                                                         abs=TOL), k
        gmax = max(float(np.abs(g).max()) for g in want["grads"].values())
        assert np.isfinite(gmax) and gmax > 0
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k].numpy(), g, rtol=0,
                                       atol=TOL * gmax, err_msg=k)
    assert float(ranks[0]["loss"]) == float(ranks[1]["loss"])


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_sharded_update_equals_the_reference(name, reference):
    """The update from the averaged gradients: clip and Adam as the
    reference's. A first Adam step moves a parameter by lr * g / (|g| +
    eps), whose slope in g is at most lr / eps, so the gradients' TOL *
    gmax bound carries over as (lr / eps) * TOL * gmax (twice, for the
    clip's scale)."""
    want, got = reference[0][name], reference[1][0][name]
    gmax = max(float(np.abs(g).max()) for g in want["grads"].values())
    bound = 2 * (want["lr"] / 1e-3) * TOL * gmax
    assert float(got["metrics"]["grad_norm"]) == pytest.approx(
        want["grad_norm"], rel=TOL)
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), w, rtol=0,
                                   atol=bound, err_msg=k)


# -- the draws ----------------------------------------------------------------


def _log_probs():
    """(A, Q) eq-17 log-probs with masked edges at -1e9, as the head
    gives them."""
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0, 0.5],
                           [3.0, 0.0, 0.0, 0.0, 0.0],
                           [0.0, 0.0, 0.0, 0.0, 0.0],
                           [-1e9, 0.0, 1.0, -1e9, 0.2],
                           [-1e9, -1e9, -1e9, -1e9, 0.0]])
    return torch.log_softmax(logits, -1)


def test_gumbel_max_dispatch_draws_the_policy_probabilities():
    n = 40_000
    lp = _log_probs()
    acts = tdec.gumbel_argmax(torch.Generator().manual_seed(0),
                              lp.expand(n, *lp.shape))
    freq = torch.nn.functional.one_hot(acts, lp.shape[-1]).float().mean(0)
    probs = torch.exp(lp)
    tv = 0.5 * (freq - probs).abs().sum(-1)
    # E[TV] ~ 0.5 * sum_q sqrt(2 p (1 - p) / (pi n)) <= 0.005 here
    assert float(tv.max()) < 0.015, tv
    assert float(freq[probs < 1e-30].sum()) == 0.0   # masked edges never


def _admit(source, logits):
    """The episode's admit draw: uniform noise below sigmoid(logits)."""
    return tdec.uniform(source, logits.shape, logits.device) < \
        torch.sigmoid(logits)


def test_admit_draw_follows_the_admit_probability():
    n = 40_000
    logits = torch.tensor([-3.0, -0.5, 0.0, 0.7, 2.0, 6.0])
    admit = _admit(torch.Generator().manual_seed(1), logits.expand(n, -1))
    err = (admit.float().mean(0) - torch.sigmoid(logits)).abs()
    assert float(err.max()) < 0.01, err   # 4 standard errors at p = 1/2


@pytest.mark.parametrize("world", [2, 4])
def test_draws_do_not_depend_on_the_split(world):
    gen = torch.Generator()
    lp = torch.log_softmax(torch.randn(B, 8, 5, generator=gen.manual_seed(3)),
                           -1)
    logits = torch.randn(B, 8, generator=gen)
    full_a = tdec.gumbel_argmax(gen.manual_seed(9), lp)
    full_u = _admit(gen, logits)
    full_s = tdec.sample_assignments(gen, lp, 3)
    b = B // world
    for r in range(world):
        rows = slice(r * b, (r + 1) * b)
        block = tdec.BlockDraws(gen.manual_seed(9), r * b, B)
        assert torch.equal(tdec.gumbel_argmax(block, lp[rows]), full_a[rows])
        assert torch.equal(_admit(block, logits[rows]), full_u[rows])
        assert torch.equal(tdec.sample_assignments(block, lp[rows], 3),
                           full_s[:, rows])


def test_episode_blocks_equal_the_whole_batch():
    """A sharded rank's episode is its rows of the unsharded episode:
    engine state, log-probs and entropies (admission and faults on)."""
    scenario, pkw, ckw, _ = STEP_CASES["chaos-rolling-failure"]
    cfg, fspec = ttrain.resolve_temporal_config(_cfg(scenario, pkw, ckw))
    policy = _policy(cfg)
    arrivals = te._to_device(ttrain._host_episode(
        cfg, fspec, ttrain.scenarios_lib.scenario(scenario), 0), "cpu")
    sim = te.init_batch(cfg.engine, ttrain._cluster_seeds(cfg, 0),
                        device="cpu")
    with torch.no_grad():
        full = ttrain._episode(policy, sim, arrivals, cfg,
                               torch.Generator().manual_seed(5), None, None)
        for rows in (slice(0, 4), slice(4, 8), slice(2, 4)):
            part = ttrain._episode(
                policy, {k: v[rows] for k, v in sim.items()},
                {k: v[rows] for k, v in arrivals.items()}, cfg,
                tdec.BlockDraws(torch.Generator().manual_seed(5), rows.start,
                                B), None, None)
            for k, v in full[0].items():
                assert torch.equal(part[0][k], v[rows]), k
            for got, want in zip(part[1:], full[1:]):
                torch.testing.assert_close(got, want[:, rows], rtol=0,
                                           atol=1e-5)
    assert bool((full[0]["slot_edge"] >= 0).any())


# -- the int8-compressed all-reduce -------------------------------------------


@pytest.mark.parametrize("case", ["normal", "zeros", "ties"])
def test_quantize_int8_bit_for_bit(case):
    import jax.numpy as jnp
    from repro.optim.grad_utils import dequantize_int8 as j_dequantize
    from repro.optim.grad_utils import quantize_int8 as j_quantize
    x = {"normal": np.random.default_rng(0).standard_normal(257) * 3.0,
         "zeros": np.zeros(5),
         "ties": np.array([127.0, 63.5, -63.5, 0.5, -0.5, 1.5, 2.5, -2.5]),
         }[case].astype(np.float32)
    q, scale = quantize_int8(torch.from_numpy(x))
    jq, jscale = j_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = dequantize_int8(q, scale, dtype)
        want = np.asarray(j_dequantize(jq, jscale, jdtype))
        assert got.dtype == dtype
        assert got.float().numpy().tobytes() == \
            want.astype(np.float32).tobytes()


def test_compressed_psum_two_ranks_matches_the_reference_math(steps):
    """The reference's arithmetic in numpy on the two shards: the shared
    MAX scale, re-quantization, the int32 sum."""
    xs = [_psum_input(r) for r in range(2)]
    scale = max(np.maximum(np.abs(x).max() / np.float32(127.0),
                           np.float32(1e-12)) for x in xs)
    total = sum(np.clip(np.round(x / scale), -127, 127).astype(np.int8)
                .astype(np.int32) for x in xs)
    want = (total.astype(np.float32) * scale).astype(np.float32)
    for rank in steps[1]:
        assert rank["psum"].numpy().tobytes() == want.tobytes()
    assert np.abs(want - sum(xs)).max() <= 2 * scale / 2 + 1e-6


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--job", required=True)
    a = ap.parse_args()
    torch.set_num_threads(1)
    job = torch.load(a.job, weights_only=False)
    dist.init_process_group(
        "gloo", store=dist.FileStore(a.store, a.world), rank=a.rank,
        world_size=a.world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        result = RANK_JOBS[job["kind"]](a.rank, a.world, job)
        torch.save(result, Path(a.job).parent / f"rank{a.rank}.out.pt")
    finally:
        dist.destroy_process_group()
