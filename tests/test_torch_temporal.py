"""The port's temporal REINFORCE (``repro_torch.core.train``'s temporal half)
against the JAX reference, on the CPU, at the reference tests' small size
(d = 32, Q = 3 edges, R = 4 rounds, A = 8 slots a round, B = 4).

``temporal_rl_loss`` is held against the reference's on uniform_iid,
chaos-rolling-failure (admission, SLO penalty), cloud-burst-offload
(deadline penalty, tier features) and cloud-cache-churn, with the same
parameters (weight bridge), clusters and arrivals (the numpy samplers, bit
for bit) and the same draws. The draws are replaced inside this file only:
the reference's loss runs under ``jax.disable_jit()``, where ``lax.scan``
calls its body once per round in Python, with ``jax.random.categorical``
and ``jax.random.bernoulli`` patched to draw from the reference's own
probabilities with a numpy generator and record the draws; the port then
gets them as ``actions=`` and ``admits=``. The reference's drained end
state is caught from its last ``vmap``-ed call. Nothing in ``src/repro/``
changes. Loss and aux agree to 1e-4, every gradient to 1e-4 of the model's
largest gradient entry, the end state's counts exactly and its floats to
1e-4.

One deliberate difference (ROADMAP C6): where an instance has no arrivals
in a round, the reference's masked max of its requests is -inf; the
forward never reads it (every key of the context attention is masked), but
its gradient is -inf * 0 = NaN in the context attention's weights and the
request encoder, and the reference's clip then drops the whole update. The
port's masked max of an empty set is 0. The parity runs patch the same
guard into the reference (``_masked_max``), and
``test_empty_request_set_*`` shows both sides of the difference.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import policy as jpol
from repro.core.instances import InstanceConfig as JInstanceConfig
from repro.core.instances import generate_batch as j_generate_batch
from repro.resilience import faults as jfaults
from repro.serving import engine as je
from repro.workloads import batch as jbatch
from repro.workloads import scenarios as jscen
from repro_torch.checkpoint import Checkpointer, load_reference_params
from repro_torch.core import policy as tpol
from repro_torch.core import train as ttrain
from repro_torch.nn import param_tree
from repro_torch.optim import adam_init
from repro_torch.serving import engine as te
from repro_torch.workloads import scenarios as tscen
from repro_torch.workloads.processes import InhomogeneousPoisson

jtrain = importlib.import_module("repro.core.train")
torch.set_num_threads(1)

Q, R, A, B = 3, 4, 8, 4
TOL = 1e-4
SMALL = dict(d_model=32, ff_hidden=64, edge_layers=1, request_layers=1)
SCENARIOS = {
    "uniform_iid": ({}, {}),
    "chaos-rolling-failure": (dict(admit_head=True, admit_hidden=8),
                              dict(admission=True, slo=3.0,
                                   slo_penalty=2.0)),
    "cloud-burst-offload": (dict(tier_features=True),
                            dict(deadline_penalty=8.0)),
    "cloud-cache-churn": ({}, {}),
}


def _flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.array(leaf)
    return out


def _cfgs(name, policy_kw=None, cfg_kw=None, **kw):
    """(reference, port) TemporalRLConfig at the small size, resolved."""
    pkw, ckw = SCENARIOS.get(name, ({}, {}))
    pkw = dict(pkw, **(policy_kw or {}))
    ckw = dict(ckw, **(cfg_kw or {}), **kw)
    engine = dict(num_edges=Q, num_rounds=R, max_per_round=A)
    jcfg = jtrain.TemporalRLConfig(
        policy=jpol.PolicyConfig(**SMALL, **pkw, score_backend="xla"),
        engine=je.EngineConfig(**engine), scenario=name, batch_size=B, **ckw)
    tcfg = ttrain.TemporalRLConfig(
        policy=tpol.PolicyConfig(**SMALL, **pkw),
        engine=te.EngineConfig(**engine), scenario=name, batch_size=B, **ckw)
    return (jtrain.resolve_temporal_config(jcfg)[0],
            ttrain.resolve_temporal_config(tcfg)[0])


def _guarded(masked_max):
    """The port's masked max (0 on an empty set) around the reference's."""
    def guarded(x, mask):
        return jnp.where(mask.any(-1, keepdims=True), masked_max(x, mask),
                         0.0)
    return guarded


def _reference_loss(jcfg, params, state, sim0, arrivals, seed=3,
                    guard=True):
    """The reference's loss, value and grad, under ``jax.disable_jit()``
    with its draws taken from its own probabilities by a numpy generator
    and recorded. Returns (loss, aux, grads, drained end state, actions,
    admits)."""
    rng = np.random.default_rng(seed)
    acts, adms, states = [], [], []
    saved = (jax.random.categorical, jax.random.bernoulli, jax.vmap,
             jpol._masked_max)

    def categorical(key, logits, axis=-1, shape=None):
        lp = np.asarray(logits, np.float64)
        p = np.exp(lp - lp.max(-1, keepdims=True))
        cdf = np.cumsum(p / p.sum(-1, keepdims=True), -1)
        u = rng.random(cdf.shape[:-1] + (1,))
        a = np.minimum((cdf < u).sum(-1), cdf.shape[-1] - 1).astype(np.int32)
        acts.append(a)
        return jnp.asarray(a)

    def bernoulli(key, p):
        a = rng.random(np.shape(p)) < np.asarray(p)
        adms.append(a)
        return jnp.asarray(a)

    def vmap(fn, *args, **kw):
        batched = saved[2](fn, *args, **kw)

        def call(*a, **k):
            out = batched(*a, **k)
            if isinstance(out, dict) and "slot_finish" in out:
                states.append(out)
            return out
        return call

    jax.random.categorical, jax.random.bernoulli, jax.vmap = (
        categorical, bernoulli, vmap)
    if guard:
        jpol._masked_max = _guarded(saved[3])
    try:
        with jax.disable_jit():
            (loss, aux), grads = jax.value_and_grad(
                jtrain.temporal_rl_loss, has_aux=True)(
                    params, state, jax.tree.map(jnp.asarray, sim0),
                    jax.tree.map(jnp.asarray, arrivals),
                    jax.random.PRNGKey(0), jcfg)
    finally:
        (jax.random.categorical, jax.random.bernoulli, jax.vmap,
         jpol._masked_max) = saved
    return (float(loss), {k: float(v) for k, v in aux.items()}, _flat(grads),
            {k: np.asarray(v) for k, v in states[-1].items()},
            np.stack(acts), np.stack(adms) if adms else None)


def _port_loss(policy, tcfg, sim0, arrivals, actions, admits):
    """The port's loss and grads with injected draws, and its drained end
    state (caught at the drain's ``advance``)."""
    caught = {}
    advance = te.advance

    def catching(state, t_new, cfg):
        out = advance(state, t_new, cfg)
        if isinstance(t_new, float) and t_new == te.DRAIN_HORIZON:
            caught["state"] = out
        return out

    te.advance = catching
    try:
        loss, aux, grads = ttrain.temporal_loss_and_grads(
            policy, sim0, arrivals, tcfg,
            actions=torch.as_tensor(actions),
            admits=None if admits is None else torch.as_tensor(admits))
    finally:
        te.advance = advance
    return (float(loss), {k: float(v) for k, v in aux.items()},
            {k: g.numpy() for k, g in grads.items()},
            {k: v.numpy() for k, v in caught["state"].items()})


def _setup(name, **kw):
    jcfg, tcfg = _cfgs(name, **kw)
    params, state = jpol.corais_init(jax.random.PRNGKey(0), jcfg.policy)
    policy = tpol.CoRaiSPolicy(tcfg.policy, device="cpu")
    load_reference_params(policy, _flat(params), _flat(state))
    _, fspec = ttrain.resolve_temporal_config(tcfg)
    arrivals = ttrain._host_episode(tcfg, fspec, tscen.scenario(name), 0)
    seeds = ttrain._cluster_seeds(tcfg, 0)
    return jcfg, tcfg, params, state, policy, arrivals, seeds


@pytest.fixture(scope="module", params=list(SCENARIOS))
def episode(request):
    name = request.param
    jcfg, tcfg, params, state, policy, arrivals, seeds = _setup(name)
    ref = _reference_loss(jcfg, params, state, je.init_batch(jcfg.engine,
                                                             seeds), arrivals)
    port = _port_loss(policy, tcfg, te.init_batch(tcfg.engine, seeds,
                                                  device="cpu"),
                      arrivals, ref[4], ref[5])
    return name, ref, port


def test_temporal_loss_and_aux_match_reference(episode):
    name, (loss, aux, *_), (t_loss, t_aux, *_) = episode
    assert set(t_aux) == set(aux), name
    assert t_loss == pytest.approx(loss, rel=TOL, abs=TOL)
    for k, v in aux.items():
        assert t_aux[k] == pytest.approx(v, rel=TOL, abs=TOL), (name, k)
    assert aux["completed"] > 0


def test_temporal_gradients_match_reference(episode):
    name, (_, _, grads, *_), (_, _, t_grads, _) = episode
    assert set(t_grads) == set(grads)
    gmax = max(float(np.abs(g).max()) for g in grads.values())
    assert np.isfinite(gmax) and gmax > 0
    for k, g in grads.items():
        np.testing.assert_allclose(t_grads[k], g, rtol=0, atol=TOL * gmax,
                                   err_msg=f"{name} {k}")


def test_temporal_end_state_matches_reference(episode):
    name, (_, _, _, final, *_), (_, _, _, t_final) = episode
    assert set(t_final) >= set(final)
    for k, w in final.items():
        g = t_final[k]
        assert g.shape == w.shape, (name, k)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {k}")
        elif w.size:
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL,
                                       err_msg=f"{name} {k}")
    assert (final["slot_edge"] >= 0).any()


def _empty_instance_batch():
    """A static instance batch whose first instance has no requests."""
    batch = j_generate_batch(np.random.default_rng(2), JInstanceConfig(
        num_edges=3, num_requests=6, max_edges=4, max_requests=8), 3)
    batch["req_mask"][0] = False
    return batch


def test_empty_request_set_context_gradient_is_nan_in_the_reference():
    """The reference's fault the port repairs: an instance with no request
    gives NaN in the context attention's query and key weights (and the
    request encoder), while its forward is finite."""
    cfg = jpol.PolicyConfig(**SMALL)
    params, state = jpol.corais_init(jax.random.PRNGKey(1), cfg)
    batch = jax.tree.map(jnp.asarray, _empty_instance_batch())

    def loss(p):
        c, h, _ = jpol.corais_encode(p, state, batch, cfg)
        return jnp.sum(c * c)

    value, grads = jax.value_and_grad(loss)(params)
    flat = _flat(grads)
    assert np.isfinite(float(value))
    assert not np.isfinite(flat["ctx_mha/wq"]).all()
    assert not np.isfinite(flat["ctx_mha/wk"]).all()


def test_empty_request_set_gradient_is_finite_in_the_port():
    """The port's forward is the reference's on such a batch, and its
    gradient is the reference's with the empty-set guard, finite."""
    cfg = jpol.PolicyConfig(**SMALL)
    params, state = jpol.corais_init(jax.random.PRNGKey(1), cfg)
    batch = _empty_instance_batch()
    jb = jax.tree.map(jnp.asarray, batch)
    policy = tpol.CoRaiSPolicy(tpol.PolicyConfig(**SMALL), device="cpu")
    load_reference_params(policy, _flat(params), _flat(state))

    def loss(p):
        c, h, _ = jpol.corais_encode(p, state, jb, cfg)
        return jnp.sum(c * c), c

    saved = jpol._masked_max
    want_c = np.asarray(loss(params)[1])
    jpol._masked_max = _guarded(saved)
    try:
        (value, _), grads = jax.value_and_grad(loss, has_aux=True)(params)
    finally:
        jpol._masked_max = saved
    c, _ = tpol.corais_encode(policy, {k: torch.from_numpy(np.array(v))
                                       for k, v in batch.items()})
    np.testing.assert_allclose(c.detach().numpy(), want_c, rtol=0,
                               atol=1e-6)
    tree = param_tree(policy)
    got = torch.autograd.grad((c * c).sum(), list(tree.values()),
                              allow_unused=True)
    want = _flat(grads)
    gmax = max(float(np.abs(g).max()) for g in want.values())
    for (k, p), g in zip(tree.items(), got):
        g = np.zeros(p.shape, np.float32) if g is None else g.numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, want[k], rtol=0, atol=TOL * gmax,
                                   err_msg=k)


def _episode_logps(policy, tcfg, sim0, arrivals, actions):
    with torch.no_grad():
        _, logps, _ = ttrain._episode(policy, sim0, arrivals, tcfg, None,
                                      actions, None)
    return logps


def test_loss_pools_untrained_batchnorm_statistics_over_the_batch():
    """The loss encodes the batched instance with ``training=False``: an
    untrained BatchNorm takes its fallback statistics over all B instances
    (the reference does not vmap here), so an instance's log-probs depend
    on the rest of the batch; with trained statistics they do not."""
    _, tcfg, _, _, policy, arrivals, seeds = _setup("uniform_iid")
    sim = te.init_batch(tcfg.engine, seeds, device="cpu")
    arr = te._to_device(arrivals, "cpu")
    actions = torch.zeros((R, B, A), dtype=torch.long)
    half = lambda tree: {k: v[:2] for k, v in tree.items()}  # noqa: E731
    full = _episode_logps(policy, tcfg, sim, arr, actions)[:, :2]
    part = _episode_logps(policy, tcfg, half(sim), half(arr),
                          actions[:, :2])
    assert (full - part).abs().max() > 1e-4
    for buf in policy.buffers():
        if buf.ndim == 0:
            buf.fill_(1.0)   # count > 0: the running statistics rule
    full = _episode_logps(policy, tcfg, sim, arr, actions)[:, :2]
    part = _episode_logps(policy, tcfg, half(sim), half(arr),
                          actions[:, :2])
    torch.testing.assert_close(full, part, rtol=0, atol=1e-5)


def test_freeze_dispatch_moves_only_the_admit_head():
    _, tcfg, _, _, policy, arrivals, seeds = _setup(
        "chaos-rolling-failure", cfg_kw=dict(freeze_dispatch=True, lr=1e-2))
    before = {k: p.detach().clone() for k, p in param_tree(policy).items()}
    step, adam_cfg = ttrain.make_temporal_train_step(tcfg)
    opt = adam_init(param_tree(policy), adam_cfg)
    opt, metrics = step(policy, opt, te.init_batch(tcfg.engine, seeds,
                                                   device="cpu"),
                        arrivals, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    for k, p in param_tree(policy).items():
        moved = not torch.equal(p.detach(), before[k])
        assert moved == k.startswith("admit/"), k
    for kw in (dict(admission=False), dict()):
        _, cfg = _cfgs("uniform_iid", cfg_kw=dict(freeze_dispatch=True, **kw),
                       policy_kw=dict(admit_head=bool(kw)))
        pol = tpol.CoRaiSPolicy(cfg.policy, device="cpu")
        step, adam_cfg = ttrain.make_temporal_train_step(cfg)
        with pytest.raises(ValueError, match="freeze_dispatch"):
            step(pol, adam_init(param_tree(pol), adam_cfg),
                 te.init_batch(cfg.engine, seeds, device="cpu"), arrivals,
                 generator=torch.Generator())


def _spec_fields(spec):
    return None if spec is None else dataclasses.asdict(spec)


@pytest.mark.parametrize("name", jscen.list_scenarios())
def test_resolve_temporal_config_matches_reference(name):
    jcfg, tcfg = (jtrain.TemporalRLConfig(scenario=name),
                  ttrain.TemporalRLConfig(scenario=name))
    (jc, jf), (tc, tf) = (jtrain.resolve_temporal_config(jcfg),
                          ttrain.resolve_temporal_config(tcfg))
    assert _spec_fields(tf) == _spec_fields(jf)
    assert _spec_fields(tc.engine.cloud) == _spec_fields(jc.engine.cloud)
    assert _spec_fields(tc.engine.cache) == _spec_fields(jc.engine.cache)
    assert ttrain.resolve_temporal_config(tc) == (tc, tf)   # idempotent
    # the config's own spec wins; one with no faults resolves to None
    mine = ttrain.TemporalRLConfig(
        scenario=name, fault_spec=ttrain.faults_lib.FaultSpec(rolling=(1, 1)))
    assert ttrain.resolve_temporal_config(mine)[1] == mine.fault_spec
    none = ttrain.TemporalRLConfig(scenario=name,
                                   fault_spec=ttrain.faults_lib.FaultSpec())
    assert ttrain.resolve_temporal_config(none)[1] is None


@pytest.mark.parametrize("name", ["uniform_iid", "chaos-straggler-storm",
                                  "cloud-cache-churn"])
def test_clusters_and_host_episodes_equal_the_reference(name):
    jcfg, tcfg = _cfgs(name)
    for b in (0, 5):
        seeds = ttrain._cluster_seeds(tcfg, b)
        np.testing.assert_array_equal(seeds, jtrain._cluster_seeds(jcfg, b))
        _, fspec = ttrain.resolve_temporal_config(tcfg)
        got = ttrain._host_episode(tcfg, fspec, tscen.scenario(name), b)
        want = jbatch.materialize_round_batch(
            jscen.scenario(name), Q, R, jcfg.engine.round_interval, B,
            base_seed=int(np.random.default_rng(
                (0, jtrain._ARRIVAL_SALT, b)).integers(0, 2**31 - 1)),
            max_per_round=A, overflow="clip")
        jspec = jscen.scenario_fault_spec(name)
        if jspec is not None:
            want = jfaults.attach_fault_batch(
                want, jspec, Q, seeds=np.random.default_rng(
                    (0, jtrain._FAULT_SEED_SALT, b)).integers(
                        0, 2**31 - 1, size=B))
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _reference_metric_keys(name, **kw):
    """The keys of the reference's update metrics, by tracing its update
    (no compile)."""
    jcfg, _ = _cfgs(name, **kw)
    params, state = jpol.corais_init(jax.random.PRNGKey(0), jcfg.policy)
    adam_cfg = jtrain.AdamConfig(lr=jcfg.lr)
    opt = jtrain.adam_init(params, adam_cfg)
    sim0 = je.init_batch(jcfg.engine, range(B))
    arrivals = jbatch.materialize_round_batch(
        jscen.scenario(name), Q, R, jcfg.engine.round_interval, B,
        max_per_round=A, overflow="clip")
    jspec = jtrain.resolve_temporal_config(jcfg)[1]
    if jspec is not None:
        arrivals = jfaults.attach_fault_batch(arrivals, jspec, Q,
                                              seeds=range(B))
    out = jax.eval_shape(
        lambda *a: jtrain._temporal_update(*a, jcfg, adam_cfg),
        params, state, opt, sim0, arrivals, jax.random.PRNGKey(0))
    return set(out[2])


@pytest.mark.parametrize("epoch", [False, True])
@pytest.mark.parametrize("name", ["uniform_iid", "chaos-rolling-failure",
                                  "cloud-burst-offload"])
def test_history_rows_have_the_reference_keys(name, epoch):
    want = _reference_metric_keys(name) | {"batch", "sec"}
    _, tcfg = _cfgs(name, num_batches=2,
                    **(dict(device_episodes=True, epoch_len=2) if epoch
                       else {}))
    _, _, hist = ttrain.temporal_train(tcfg, device="cpu")
    assert [row["batch"] for row in hist] == [0, 1]
    for row in hist:
        assert set(row) == want
        assert all(np.isfinite(v) for v in row.values())


def test_temporal_step_runs_and_is_finite():
    """Twin of the reference's smoke test: two host-loop updates on a
    miniature uniform_iid episode are finite and complete requests."""
    _, tcfg = _cfgs("uniform_iid", lr=3e-4, num_batches=2)
    policy, opt, hist = ttrain.temporal_train(tcfg, device="cpu")
    assert len(hist) == 2 and int(opt["step"]) == 2
    for row in hist:
        for k in ("loss", "grad_norm", "cost_mean", "entropy"):
            assert np.isfinite(row[k]), (k, row)
        assert row["completed"] > 0


def test_temporal_epoch_path_runs_and_is_finite():
    """The epoch path (device episodes, K updates per call): per-batch
    rows, finite metrics, work completing; metrics come back (K,) and on
    the state's device from the epoch step itself."""
    _, tcfg = _cfgs("uniform_iid", lr=3e-4, num_batches=4,
                    device_episodes=True, epoch_len=2)
    _, _, hist = ttrain.temporal_train(tcfg, device="cpu")
    assert [row["batch"] for row in hist] == [0, 1, 2, 3]
    for row in hist:
        for k in ("loss", "grad_norm", "cost_mean", "entropy"):
            assert np.isfinite(row[k]), (k, row)
    assert any(row["completed"] > 0 for row in hist)
    step, adam_cfg = ttrain.make_temporal_epoch_step(tcfg)
    policy = tpol.CoRaiSPolicy(tcfg.policy, device="cpu")
    sim0 = te.init_batch(tcfg.engine, range(3 * B), device="cpu")
    sim0 = {k: v.reshape(3, B, *v.shape[1:]) for k, v in sim0.items()}
    seeds = np.stack([ttrain._episode_seeds(tcfg, b) for b in range(3)])
    opt, mets = step(policy, adam_init(param_tree(policy), adam_cfg), sim0,
                     seeds)
    assert int(opt["step"]) == 3
    assert all(v.shape == (3,) and v.device.type == "cpu"
               for v in mets.values())


@pytest.mark.parametrize("name", ["chaos-straggler-storm",
                                  "chaos-rolling-failure"])
def test_temporal_epoch_path_on_faulted_scenarios(name):
    _, tcfg = _cfgs(name, device_episodes=True, epoch_len=2, num_batches=2)
    _, _, hist = ttrain.temporal_train(tcfg, device="cpu")
    assert len(hist) == 2 and all(np.isfinite(r["loss"]) for r in hist)
    slo = name == "chaos-rolling-failure"   # SCENARIOS gives it an SLO
    assert all(("slo_violation_frac" in r) == slo and "shed" in r
               for r in hist)


def test_unsupported_options_raise(monkeypatch):
    _, tcfg = _cfgs("uniform_iid", device_episodes=True)
    # a batch that does not divide over the mesh (B = 4 over a fake world of
    # three ranks) fails before any collective, naming both sizes
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist = torch.distributed
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=3)
    try:
        mesh = DeviceMesh("cpu", torch.arange(3), mesh_dim_names=("fleet",))
        msg = "batch_size 4 does not divide over the 3-device mesh"
        with pytest.raises(ValueError, match=msg):
            ttrain.temporal_train(tcfg, mesh=mesh, device="cpu")
        with pytest.raises(ValueError, match=msg):
            ttrain.make_temporal_epoch_step(tcfg, mesh=mesh)
    finally:
        dist.destroy_process_group()
    # a workload with no device law fails when the epoch step is built
    monkeypatch.setattr(ttrain.scenarios_lib, "scenario", lambda name: (
        InhomogeneousPoisson(rate_fn=lambda t: 5.0, rate_max=5.0)))
    with pytest.raises(ValueError, match="no device sampler"):
        ttrain.make_temporal_epoch_step(tcfg)


def _trees_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("epoch", [False, True])
def test_temporal_checkpoint_resume_bit_identical(tmp_path, epoch):
    """Stopping a temporal run at a checkpoint and resuming replays exactly
    what the uninterrupted run produced, on both paths (the epoch path's
    chunks clamp to checkpoint boundaries)."""
    kw = dict(device_episodes=True, epoch_len=3) if epoch else {}
    _, tcfg = _cfgs("uniform_iid", lr=3e-4, num_batches=4, **kw)

    p_full, o_full, h_full = ttrain.temporal_train(tcfg, device="cpu")
    ck = Checkpointer(str(tmp_path / "ck"), every=2)
    ttrain.temporal_train(tcfg, num_batches=2, checkpointer=ck,
                          device="cpu")
    ck2 = Checkpointer(str(tmp_path / "ck"), every=2)
    p_res, o_res, h_res = ttrain.temporal_train(tcfg, num_batches=2,
                                                checkpointer=ck2,
                                                device="cpu")
    assert [r["batch"] for r in h_res] == [2, 3]
    assert _trees_equal(dict(p_full.state_dict()), dict(p_res.state_dict()))
    assert torch.equal(o_full["step"], o_res["step"])
    assert _trees_equal(o_full["m"], o_res["m"])
    assert _trees_equal(o_full["v"], o_res["v"])
    for a, b in zip([r for r in h_full if r["batch"] >= 2], h_res):
        assert a["loss"] == b["loss"] and a["cost_mean"] == b["cost_mean"]


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """A temporal run's checkpoint is in the reference's format."""
    from repro.checkpoint import restore_pytree
    jcfg, tcfg = _cfgs("uniform_iid", num_batches=2)
    ck = Checkpointer(str(tmp_path / "ck"), every=2)
    policy, _, _ = ttrain.temporal_train(tcfg, checkpointer=ck, device="cpu")
    params, state = jpol.corais_init(jax.random.PRNGKey(0), jcfg.policy)
    restored, _ = restore_pytree({"params": params, "state": state},
                                 str(tmp_path / "ck" / "step_0000000002"))
    for k, v in _flat(restored["params"]).items():
        np.testing.assert_array_equal(
            v, param_tree(policy)[k].detach().numpy(), err_msg=k)
    assert JCheckpointer(str(tmp_path / "ck"),
                         async_save=False).latest_step() == 2
