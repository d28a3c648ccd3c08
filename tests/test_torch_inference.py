"""The port's decision path against the JAX reference: greedy decisions,
the objective, sampled decode (held by distribution, since torch and jax
draw different random numbers), the serving fast path, the numpy copies of
the instance sampler, and the port's isolation from jax."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import InstanceConfig as JInstanceConfig
from repro.core import generate_batch as j_generate_batch
from repro.core import generate_instance as j_generate_instance
from repro.core import inference as jinf
from repro.core import objective as jobj
from repro.core import policy as jpol
from repro.serving import fastpath as jfast
from repro.workloads import base as jbase
from repro_torch.checkpoint import load_reference_params
from repro_torch.core import decode as tdec
from repro_torch.core import inference as tinf
from repro_torch.core import instances as tinst
from repro_torch.core import objective as tobj
from repro_torch.core import policy as tpol
from repro_torch.kernels import policy_score
from repro_torch.serving import fastpath as tfast
from repro_torch.workloads import base as tbase

torch.set_num_threads(1)

SMALL = dict(d_model=32, ff_hidden=64, edge_layers=2, request_layers=1)
GAP = 1e-5
SRC = Path(__file__).resolve().parents[1] / "src"


def _flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def pair():
    jcfg = jpol.PolicyConfig(**SMALL)
    params, state = _init(jax.random.PRNGKey(0), jcfg)
    policy = tpol.CoRaiSPolicy(tpol.PolicyConfig(**SMALL), device="cpu")
    load_reference_params(policy, _flat(params), _flat(state))
    return jcfg, params, state, policy


def _batch(seed=0, b=3, q=5, z=12, q_pad=7, z_pad=16):
    return j_generate_batch(np.random.default_rng(seed), JInstanceConfig(
        num_edges=q, num_requests=z, max_edges=q_pad, max_requests=z_pad), b)


def _t(inst):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in inst.items()}


def _j(inst):
    return jax.tree.map(jnp.asarray, inst)


# jit'd reference entry points: one compile per shape, far cheaper than
# op-by-op dispatch of the eager reference
_init = jax.jit(jpol.corais_init, static_argnums=1)
_encode = jax.jit(jpol.corais_encode, static_argnames=("cfg", "training"))
_score = jax.jit(jpol.corais_score, static_argnames=("cfg", "backend"))
_per_edge_times = jax.jit(jobj.per_edge_times)
_makespans = jax.jit(jax.vmap(jobj.makespan, in_axes=(None, 0)))


def _assert_gapped(log_probs, req_mask, k=1):
    """Every real request's top-(k+1) log-probs differ by more than GAP."""
    top = -np.sort(-np.asarray(log_probs), axis=-1)[..., :k + 1]
    gaps = (top[..., :-1] - top[..., 1:]).min(-1)
    assert gaps[np.asarray(req_mask)].min() > GAP


@pytest.mark.parametrize("fused,normalize", [(True, True), (True, False),
                                             (False, True)])
def test_greedy_decisions_equal_reference_pallas(pair, fused, normalize):
    jcfg, params, state, policy = pair
    batch = _batch()
    spec = jinf.DecisionSpec(fused_decode=fused, normalize=normalize,
                             backend="pallas")
    want = np.asarray(jinf.make_decision_fn(params, state, jcfg, spec)(
        _j(batch), jax.random.PRNGKey(0)))
    c, h, _ = _encode(params, state, _j(batch), cfg=jcfg)
    _assert_gapped(_score(params, c, h, batch["edge_mask"], cfg=jcfg),
                   batch["req_mask"])
    tspec = tinf.DecisionSpec(fused_decode=fused, normalize=normalize)
    got = tinf.policy_decide(policy, _t(batch), tspec)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for backend in ("torch", "ref"):
        other = tinf.policy_decide(policy, _t(batch),
                                   tspec.replace(backend=backend))
        np.testing.assert_array_equal(other.numpy(), want)


def test_admission_decision_matches_reference():
    jcfg = jpol.PolicyConfig(**SMALL, admit_head=True)
    params, state = _init(jax.random.PRNGKey(1), jcfg)
    policy = tpol.CoRaiSPolicy(tpol.PolicyConfig(**SMALL, admit_head=True),
                               device="cpu")
    load_reference_params(policy, _flat(params), _flat(state))
    batch = _batch(seed=1)
    _, admit = jinf.make_decision_fn(
        params, state, jcfg, jinf.DecisionSpec(admission=True))(
            _j(batch), jax.random.PRNGKey(0))
    _, tadmit = tinf.policy_decide(policy, _t(batch),
                                   tinf.DecisionSpec(admission=True))
    np.testing.assert_array_equal(tadmit.numpy(), np.asarray(admit))


def test_objective_matches_reference_on_random_assignments():
    """makespan and per_edge_times to 1e-5, batched instances and S
    assignments of one instance."""
    batch = _batch(seed=2)
    rng = np.random.default_rng(3)
    assign = rng.integers(0, 5, size=(3, 16)).astype(np.int32)
    want = _per_edge_times(_j(batch), jnp.asarray(assign))
    got = tobj.per_edge_times(_t(batch), torch.from_numpy(assign))
    for key in ("mu", "eta", "kappa", "T"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tobj.makespan(_t(batch), torch.from_numpy(assign)).numpy(),
        np.asarray(jax.jit(jobj.makespan)(_j(batch), jnp.asarray(assign))),
        atol=1e-5, rtol=0)
    inst = {k: v[0] for k, v in batch.items()}
    samples = rng.integers(0, 5, size=(9, 16)).astype(np.int32)
    want = _makespans(_j(inst), jnp.asarray(samples))
    np.testing.assert_allclose(
        tobj.makespan(_t(inst), torch.from_numpy(samples)).numpy(),
        np.asarray(want), atol=1e-5, rtol=0)


def test_sample_frequencies_follow_reference_policy(pair):
    """K = Q candidates from the port's fused decode, sampled with an
    explicit generator: each request's edge frequencies are within TV 0.05
    of softmax of the reference's log-probs."""
    jcfg, params, state, policy = pair
    inst = {k: v[0] for k, v in _batch(seed=4, b=1, q=5, z=8,
                                       q_pad=5, z_pad=8).items()}
    c, h, _ = _encode(params, state, _j(inst), cfg=jcfg)
    probs = np.exp(np.asarray(
        _score(params, c, h, inst["edge_mask"], cfg=jcfg)))
    with torch.inference_mode():
        tc, th = tpol.corais_encode(policy, _t(inst))
        ti, tv = tpol.corais_score_decode(policy, tc, th,
                                          torch.from_numpy(inst["edge_mask"]),
                                          k=5, normalize=True)
    n = 4000
    gen = torch.Generator().manual_seed(0)
    samples = tdec.sample_candidates(gen, ti, tv, n).numpy()  # (S, Z)
    freq = np.stack([np.bincount(samples[:, z], minlength=5) / n
                     for z in range(8)])
    tv_dist = 0.5 * np.abs(freq - probs).sum(-1)
    assert tv_dist.max() < 0.05, tv_dist


def test_best_of_n_is_an_argmin_of_reference_makespan(pair):
    _, _, _, policy = pair
    inst = {k: v[0] for k, v in _batch(seed=5, b=1).items()}
    tinst_ = _t(inst)
    with torch.inference_mode():
        tc, th = tpol.corais_encode(policy, tinst_)
        ti, tv = tpol.corais_score_decode(policy, tc, th, tinst_["edge_mask"],
                                          k=7, normalize=True)
    samples = tdec.sample_candidates(torch.Generator().manual_seed(7),
                                     ti, tv, 32)
    cands = np.concatenate([ti[None, :, 0].numpy(), samples.numpy()])
    ref_costs = np.asarray(_makespans(_j(inst),
                                      jnp.asarray(cands.astype(np.int32))))
    best, cost = tdec.topk_sampling_decode(torch.Generator().manual_seed(7),
                                           tinst_, ti, tv, 32)
    best = best.numpy()
    assert any((best == c).all() for c in cands)
    ref_best = float(_makespans(_j(inst), jnp.asarray(best[None]))[0])
    assert ref_best <= ref_costs.min() + 1e-5
    np.testing.assert_allclose(float(cost), ref_best, atol=1e-5, rtol=0)
    # sample mode end to end: same draws through policy_decide
    spec = tinf.DecisionSpec(mode="sample", num_samples=32, fused_decode=True,
                             num_candidates=7)
    got = tinf.policy_decide(policy, tinst_, spec,
                             generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(got.numpy(), best)
    with pytest.raises(ValueError, match="Generator"):
        tinf.policy_decide(policy, tinst_, spec)


def test_fastpath_matches_reference_fastpath(pair):
    """Greedy fused serving at two buckets: the port's fast path on the CPU
    returns the reference fast path's assignments."""
    jcfg, params, state, policy = pair
    buckets = ((8, 32), (16, 64))
    ref_fp = jfast.DecisionFastPath(params, state, jcfg, buckets=buckets)
    fp = tfast.DecisionFastPath(policy, buckets=buckets, device="cpu")
    rng = np.random.default_rng(6)
    for q, z in ((6, 20), (12, 50), (5, 32)):
        inst = j_generate_instance(rng, JInstanceConfig(num_edges=q,
                                                        num_requests=z))
        with torch.inference_mode():
            tc, th = tpol.corais_encode(policy, _t(inst))
            lp = tpol.corais_score(policy, tc, th,
                                   torch.from_numpy(inst["edge_mask"]),
                                   backend="torch")
        _assert_gapped(lp.numpy(), inst["req_mask"])
        want = ref_fp.decide(inst)
        got = fp.decide(inst)
        assert got.shape == (z,) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert set(fp._stages) == set(buckets)
    assert len(fp.latencies_ms) == 3


def test_fastpath_stream_warmup_sampling_and_slo(pair):
    _, _, _, policy = pair
    buckets = ((8, 32),)
    fp = tfast.DecisionFastPath(policy, buckets=buckets, device="cpu")
    assert fp.spec.fused_decode and not fp.spec.normalize
    assert set(fp.warmup()) == {(8, 32)}
    rng = np.random.default_rng(7)
    insts = [tinst.generate_instance(rng, tinst.InstanceConfig(
        num_edges=6, num_requests=20)) for _ in range(4)]
    sync = [fp.decide(i) for i in insts]
    streamed = list(fp.stream(insts))
    for a, b in zip(sync, streamed):
        np.testing.assert_array_equal(a, b)
    fs = tfast.DecisionFastPath(policy, mode="sample", num_samples=8,
                                buckets=buckets, device="cpu")
    assert fs.spec.normalize
    out = fs.decide(insts[0])
    assert out.shape == (20,) and out.min() >= 0 and out.max() < 6
    report = tfast.evaluate_slo(fp, insts, tfast.SLOSpec(1e9, 1e9, 1e9))
    assert report["pass"] and report["samples"] == 4
    assert report["device"] == "cpu"
    with pytest.raises(ValueError, match="exceeds every fast-path bucket"):
        fp.bucket_for(9, 10)


def test_fastpath_without_device_needs_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("the default device is CUDA here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfast.DecisionFastPath(pair[3])


def test_cpu_decisions_launch_no_kernel(pair):
    _, _, _, policy = pair
    policy_score.reset_launch_counts()
    for fused in (True, False):
        tinf.policy_decide(policy, _t(_batch()),
                           tinf.DecisionSpec(fused_decode=fused))
    assert sum(policy_score.LAUNCHES.values()) == 0


@pytest.mark.parametrize("cfg", [
    dict(num_edges=6, num_requests=30, max_edges=8, max_requests=40),
    dict(num_edges=5, num_requests=20, size_dist="pareto"),
    dict(num_edges=7, num_requests=25, source_skew=1.2, hot_edge=2,
         size_dist="lognormal"),
], ids=["uniform", "pareto", "skewed"])
def test_instance_copy_is_bit_identical(cfg):
    want = j_generate_batch(np.random.default_rng(11), JInstanceConfig(**cfg), 2)
    got = tinst.generate_batch(np.random.default_rng(11),
                               tinst.InstanceConfig(**cfg), 2)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_workload_base_copy_is_bit_identical():
    for dist, params in (("uniform", ()), ("fixed", (0.3,)),
                         ("pareto", (1.2, 0.1)), ("lognormal", ())):
        want = jbase.SizeSpec(dist, params).sample(np.random.default_rng(1), 50)
        got = tbase.SizeSpec(dist, params).sample(np.random.default_rng(1), 50)
        np.testing.assert_array_equal(got, want)
    for skew, hot in ((0.0, 0), (1.5, 3)):
        np.testing.assert_array_equal(tbase.edge_weights(6, skew, hot),
                                      jbase.edge_weights(6, skew, hot))


def test_port_never_imports_jax_or_the_reference():
    """Importing every repro_torch module leaves jax and repro.* out of
    sys.modules (the card machine has no jax)."""
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
                         timeout=120)
    assert out.returncode == 0, out.stderr
