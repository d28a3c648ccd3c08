"""The port's static REINFORCE training against the JAX reference.

* ``rl_loss``: loss, metrics, every gradient and the new BatchNorm state
  against the reference's ``jax.value_and_grad(rl_loss)`` through the
  Pallas custom VJP (interpret mode), on the same parameters (weight
  bridge) and the very samples the reference draws (its own split +
  categorical repeated on its own log-probs, then injected). Loss and
  metrics to rtol 1e-4; gradients to rtol 1e-4 plus 1e-5 of the model's
  largest gradient entry (a bias just ahead of a BatchNorm has a true
  gradient of 0 and carries only rounding noise). One Adam step is held on
  identical gradients, because Adam's first step is about +-lr wherever |g|
  is tiny, so a noisy near-zero gradient may flip it.
* The port's own draws, by their distribution (total variation).
* The numpy copies (objective mirror, heuristics, exact solvers, LP
  export, ablation configs), bit for bit.
* Twins of the reference's training smoke tests, bit-identical resume,
  the checkpointer, and a port-trained checkpoint restored by the
  reference's ``restore_pytree``.
"""
import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree
from repro.core import InstanceConfig as JInstanceConfig
from repro.core import ablations as jabl
from repro.core import decode as jdec
from repro.core import evaluate as jeval
from repro.core import heuristics as jheur
from repro.core import ilp as jilp
from repro.core import objective as jobj
from repro.core import policy as jpol
from repro.core.instances import generate_batch as j_generate_batch
from repro.core.instances import generate_instance as j_generate_instance
from repro.optim import AdamConfig as JAdamConfig
from repro.optim import adam_init as j_adam_init
from repro.optim import adam_update as j_adam_update
from repro_torch.checkpoint import (Checkpointer, load_reference_params,
                                    load_train_state, train_tree)
from repro_torch.core import ablations as tabl
from repro_torch.core import decode as tdec
from repro_torch.core import evaluate as teval
from repro_torch.core import heuristics as theur
from repro_torch.core import ilp as tilp
from repro_torch.core import instances as tinst
from repro_torch.core import objective as tobj
from repro_torch.core import policy as tpol
from repro_torch.core import train as ttrain
from repro_torch.nn import param_tree, state_tree
from repro_torch.optim import AdamConfig, adam_init, adam_update

# ``repro.core`` re-exports the function ``train`` under the module's name
jtrain = importlib.import_module("repro.core.train")
torch.set_num_threads(1)

RTOL = 1e-4
SMALL = dict(d_model=32, ff_hidden=64, edge_layers=2, request_layers=1)
INSTANCE = dict(num_edges=4, num_requests=10, max_edges=5, max_requests=12)


def _flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = np.array(leaf)
    return out


def _cfgs(**policy_kw):
    """(reference RLConfig on the Pallas head, port RLConfig on the CUDA
    head, which runs its plain versions on CPU tensors)."""
    common = dict(batch_size=6, num_samples=8, lr=3e-4, seed=0)
    jcfg = jtrain.RLConfig(
        policy=jpol.PolicyConfig(**SMALL, **policy_kw, score_backend="pallas"),
        instance=JInstanceConfig(**INSTANCE), **common)
    tcfg = ttrain.RLConfig(
        policy=tpol.PolicyConfig(**SMALL, **policy_kw, score_backend="cuda"),
        instance=tinst.InstanceConfig(**INSTANCE), **common)
    return jcfg, tcfg


_j_value_and_grad = jax.jit(
    jax.value_and_grad(jtrain.rl_loss, has_aux=True), static_argnums=4)


@functools.partial(jax.jit, static_argnums=4)
def _reference_samples(params, state, batch, key, cfg):
    """The reference's draws, repeated: ``repro/core/train.py:59-73``."""
    c, h, _ = jpol.corais_encode(params, state, batch, cfg.policy,
                                 training=True)
    lp = jax.lax.stop_gradient(jpol.corais_score(params, c, h,
                                                 batch["edge_mask"],
                                                 cfg.policy))
    keys = jax.random.split(key, cfg.num_samples)
    return jax.vmap(lambda k: jax.random.categorical(k, lp, axis=-1)
                    )(keys).astype(jnp.int32)


def _pair(policy_kw=None, seed=0):
    jcfg, tcfg = _cfgs(**(policy_kw or {}))
    params, state = jpol.corais_init(jax.random.PRNGKey(seed), jcfg.policy)
    policy = tpol.CoRaiSPolicy(tcfg.policy, device="cpu")
    load_reference_params(policy, _flat(params), _flat(state))
    return jcfg, tcfg, params, state, policy


def _batch(seed=0, b=6):
    return j_generate_batch(np.random.default_rng(seed),
                            JInstanceConfig(**INSTANCE), b)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _grad_close(got: dict, want: dict):
    gmax = max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=RTOL,
                                   atol=1e-5 * gmax, err_msg=k)


# -- rl_loss against the reference ---------------------------------------------


def test_rl_loss_grads_and_state_match_reference():
    jcfg, tcfg, params, state, policy = _pair()
    batch = _batch(1)
    jb = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(5)
    (loss, aux), grads = _j_value_and_grad(params, state, jb, key, jcfg)
    samples = torch.from_numpy(np.array(
        _reference_samples(params, state, jb, key, jcfg)))

    t_loss, t_aux, t_grads = ttrain.loss_and_grads(policy, _t(batch), tcfg,
                                                   samples=samples)
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=RTOL)
    for k in ("cost_mean", "cost_best", "entropy"):
        np.testing.assert_allclose(float(t_aux[k]), float(aux[k]), rtol=RTOL,
                                   err_msg=k)
    _grad_close(t_grads, _flat(grads))
    # the encoder ran once in training mode: the buffers hold the
    # reference's new state, count 1
    for k, w in _flat(aux["state"]).items():
        np.testing.assert_allclose(state_tree(policy)[k].numpy(), w,
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    assert float(state_tree(policy)["edge_layers/0/norm1/count"]) == 1.0

    # two Adam steps on identical gradients (the reference's)
    jp, jopt = params, j_adam_init(params, JAdamConfig(lr=tcfg.lr))
    tp = param_tree(policy)
    topt = adam_init(tp, AdamConfig(lr=tcfg.lr))
    g_t = {k: torch.from_numpy(v) for k, v in _flat(grads).items()}
    for _ in range(2):
        jp, jopt = j_adam_update(jp, grads, jopt, JAdamConfig(lr=tcfg.lr))
        topt = adam_update(tp, g_t, topt, AdamConfig(lr=tcfg.lr))
    for k, w in _flat(jp).items():
        np.testing.assert_allclose(tp[k].detach().numpy(), w, rtol=1e-6,
                                   atol=1e-9, err_msg=k)


def test_admission_head_gets_zero_gradients_as_under_jax_grad():
    """The loss does not reach the admission head: its gradients are zeros
    (not missing), and the rest still match the reference."""
    jcfg, tcfg, params, state, policy = _pair({"admit_head": True}, seed=1)
    batch = _batch(2)
    jb = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(6)
    (loss, _), grads = _j_value_and_grad(params, state, jb, key, jcfg)
    samples = torch.from_numpy(np.array(
        _reference_samples(params, state, jb, key, jcfg)))
    t_loss, _, t_grads = ttrain.loss_and_grads(policy, _t(batch), tcfg,
                                               samples=samples)
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=RTOL)
    _grad_close(t_grads, _flat(grads))
    assert all(float(t_grads[k].abs().max()) == 0.0 for k in t_grads
               if k.startswith("admit/"))


def test_rl_loss_gradient_matches_finite_differences():
    """A directional finite difference of the port's own loss (central, in
    f32, along the normalized gradient), with the BatchNorm buffers
    snapshotted and restored around every evaluation, agrees with autograd
    to 2 %; the buffers end where they started."""
    _, tcfg, _, _, policy = _pair(seed=2)
    batch = _t(_batch(3))
    samples = torch.randint(0, 4, (8, 6, 12),
                            generator=torch.Generator().manual_seed(0))
    saved = {k: v.clone() for k, v in state_tree(policy).items()}

    def restore():
        for k, v in state_tree(policy).items():
            v.copy_(saved[k])

    _, _, grads = ttrain.loss_and_grads(policy, batch, tcfg, samples=samples)
    restore()
    norm = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
    params = param_tree(policy)
    eps = 1e-2

    def loss_at(sign):
        with torch.no_grad():
            for k, p in params.items():
                p.add_(sign * eps * grads[k] / norm)
        loss, _ = ttrain.rl_loss(policy, batch, tcfg, samples=samples)
        restore()
        with torch.no_grad():
            for k, p in params.items():
                p.sub_(sign * eps * grads[k] / norm)
        return float(loss)

    fd = (loss_at(1.0) - loss_at(-1.0)) / (2 * eps)
    np.testing.assert_allclose(fd, float(norm), rtol=2e-2)
    for k, v in state_tree(policy).items():
        assert torch.equal(v, saved[k]), k


# -- the port's own sampling -----------------------------------------------------


def test_port_draws_follow_the_policy_distribution():
    """Draws of ``sample_assignments`` (what ``rl_loss`` samples from when
    no samples are injected) against softmax(log_probs), per request: total
    variation below 0.02 at 20,000 draws, masked edges never drawn."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 5, 4, generator=gen) * 2
    mask = torch.tensor([[True, True, False, True], [True] * 4])
    log_probs = torch.log_softmax(torch.where(mask[:, None], logits, -1e9), -1)
    n = 20_000
    draws = tdec.sample_assignments(torch.Generator().manual_seed(1),
                                    log_probs, n)
    assert draws.shape == (n, 2, 5)
    freq = torch.nn.functional.one_hot(draws, 4).float().mean(0)
    tv = 0.5 * (freq - log_probs.exp()).abs().sum(-1)
    assert float(tv.max()) < 0.02, tv
    assert int((draws[:, 0] == 2).sum()) == 0


def test_rl_loss_draws_are_seeded_by_the_generator():
    _, tcfg, _, _, policy = _pair(seed=3)
    batch = _t(_batch(4))
    losses = []
    for seed in (7, 7, 8):
        loss, _ = ttrain.rl_loss(policy, batch, tcfg,
                                 generator=torch.Generator().manual_seed(seed))
        losses.append(float(loss))
    assert losses[0] == losses[1] != losses[2]


# -- numpy copies, bit for bit ------------------------------------------------------


def test_numpy_copies_match_reference_bit_for_bit(tmp_path):
    rng_j, rng_t = np.random.default_rng(9), np.random.default_rng(9)
    for q, z in ((3, 5), (4, 7)):
        ji = j_generate_instance(rng_j, JInstanceConfig(
            num_edges=q, num_requests=z, max_edges=q + 1, max_requests=z + 2))
        ti = tinst.generate_instance(rng_t, tinst.InstanceConfig(
            num_edges=q, num_requests=z, max_edges=q + 1, max_requests=z + 2))
        assign = np.random.default_rng(q).integers(0, q, size=z + 2)
        for name, want in jobj.per_edge_times_np(ji, assign).items():
            np.testing.assert_array_equal(
                tobj.per_edge_times_np(ti, assign)[name], want)
        assert tobj.makespan_np(ti, assign) == jobj.makespan_np(ji, assign)
        for fn in ("solve_local", "solve_greedy"):
            np.testing.assert_array_equal(getattr(theur, fn)(ti),
                                          getattr(jheur, fn)(ji))
        np.testing.assert_array_equal(theur.solve_random(ti, 50, seed=3),
                                      jheur.solve_random(ji, 50, seed=3))
        np.testing.assert_array_equal(tilp.solve_enumerate(ti),
                                      jilp.solve_enumerate(ji))
        np.testing.assert_array_equal(tilp.solve_branch_and_bound(ti),
                                      jilp.solve_branch_and_bound(ji))
        tilp.write_lp(ti, str(tmp_path / "port.lp"))
        jilp.write_lp(ji, str(tmp_path / "ref.lp"))
        assert ((tmp_path / "port.lp").read_bytes()
                == (tmp_path / "ref.lp").read_bytes())
    for variant in tabl.VARIANTS:
        got = tabl.variant_config(tpol.PolicyConfig(), variant)
        want = jabl.variant_config(jpol.PolicyConfig(), variant)
        assert (got.edge_align, got.req_align) == (want.edge_align,
                                                   want.req_align)
    with pytest.raises(ValueError, match="unknown variant"):
        tabl.variant_config(tpol.PolicyConfig(), "fc4")


def test_decode_helpers_match_reference():
    """assignment_log_prob, and makespan over S assignments of one instance
    (the reference's makespan_batch_samples), on the same arrays."""
    batch = _batch(5, b=1)
    inst = {k: v[0] for k, v in batch.items()}
    lp = jax.nn.log_softmax(jnp.asarray(np.random.default_rng(0).normal(
        size=(12, 5)).astype(np.float32)), -1)
    assigns = np.random.default_rng(1).integers(0, 4, size=(7, 12)).astype(
        np.int32)
    ji = jax.tree.map(jnp.asarray, inst)
    ti = _t(inst)
    tlp = torch.from_numpy(np.asarray(lp))
    want = jax.vmap(lambda a: jdec.assignment_log_prob(lp, a,
                                                       ji["req_mask"]))(assigns)
    got = tdec.assignment_log_prob(tlp, torch.from_numpy(assigns),
                                   ti["req_mask"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(
        tobj.makespan(ti, torch.from_numpy(assigns)).numpy(),
        np.asarray(jobj.makespan_batch_samples(ji, jnp.asarray(assigns))),
        rtol=1e-6)


# -- training loop -----------------------------------------------------------------


def _small_cfg(**kw):
    base = dict(
        policy=tpol.PolicyConfig(**SMALL),
        instance=tinst.InstanceConfig(num_edges=3, num_requests=12,
                                      backlog_high=5),
        batch_size=16, num_samples=16, lr=3e-4, num_batches=5, seed=0)
    base.update(kw)
    return ttrain.RLConfig(**base)


def test_step_runs_and_is_finite():
    cfg = _small_cfg()
    policy = tpol.CoRaiSPolicy(cfg.policy, device="cpu")
    opt = adam_init(param_tree(policy), AdamConfig(lr=cfg.lr))
    step, _ = ttrain.make_train_step(cfg)
    batch = ttrain.to_device(tinst.generate_batch(
        np.random.default_rng(0), cfg.instance, cfg.batch_size), "cpu")
    before = {k: p.detach().clone() for k, p in param_tree(policy).items()}
    opt, metrics = step(policy, opt, batch,
                        generator=torch.Generator().manual_seed(1))
    for k, v in metrics.items():
        assert np.isfinite(float(v)), (k, v)
    assert float(metrics["cost_best"]) <= float(metrics["cost_mean"]) + 1e-6
    assert int(opt["step"]) == 1
    assert any(not torch.equal(p, before[k])
               for k, p in param_tree(policy).items())


def test_entropy_decreases_with_entropy_penalty_off():
    """With C2 high the policy stays stochastic; sanity on the knob."""
    _, _, hist_h = ttrain.train(_small_cfg(c2=50.0, num_batches=8),
                                device="cpu")
    _, _, hist_l = ttrain.train(_small_cfg(c2=0.0, num_batches=8),
                                device="cpu")
    assert hist_h[-1]["entropy"] >= hist_l[-1]["entropy"] - 1e-3


def test_train_resumes_bit_identically_through_the_checkpointer(tmp_path):
    """Batches 2-3 resumed from the port's checkpoint (policy, norm buffers
    and Adam state written after batch 1) equal, bit for bit, batches 2-3
    continued in memory from the run that wrote it."""
    cfg = _small_cfg(batch_size=8, num_samples=8)
    ckpt = Checkpointer(str(tmp_path / "ckpt"), every=1, keep=2)
    live, opt, _ = ttrain.train(cfg, num_batches=2, device="cpu",
                                checkpointer=ckpt)
    assert ckpt.latest_step() == 1
    assert sorted(os.listdir(ckpt.root)) == ["LATEST", "step_0000000001"]
    _, opt_live, hist_live = ttrain.train(cfg, num_batches=2, policy=live,
                                          opt_state=opt, start_batch=2)

    resumed = tpol.CoRaiSPolicy(cfg.policy,
                                generator=torch.Generator().manual_seed(99),
                                device="cpu")
    opt = load_train_state(resumed, ckpt.restore_latest()["tree"])
    _, opt_res, hist_res = ttrain.train(cfg, num_batches=2, policy=resumed,
                                        opt_state=opt, start_batch=2)
    assert ([h["loss"] for h in hist_res] == [h["loss"] for h in hist_live])
    sd_live, sd_res = live.state_dict(), resumed.state_dict()
    for k in sd_live:
        assert torch.equal(sd_live[k], sd_res[k]), k
    assert int(opt_res["step"]) == int(opt_live["step"]) == 4
    for k in opt_live["m"]:
        assert torch.equal(opt_live["m"][k], opt_res["m"][k]), k
        assert torch.equal(opt_live["v"][k], opt_res["v"][k]), k


def test_port_trained_checkpoint_loads_into_reference(tmp_path):
    """The weight bridge back: two port training steps, saved by the port's
    checkpointer, restored by the reference's ``restore_pytree`` into
    ``corais_init``'s tree; the reference's forward then gives the port's
    log-probs to 1e-5."""
    cfg = _small_cfg(num_batches=2)
    policy, opt, _ = ttrain.train(cfg, device="cpu")
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(2, train_tree(policy, opt))
    ckpt.wait()  # the save runs on a background thread
    jcfg = jpol.PolicyConfig(**SMALL)
    params0, state0 = jpol.corais_init(jax.random.PRNGKey(0), jcfg)
    tree, _ = restore_pytree({"params": params0, "state": state0},
                             os.path.join(ckpt.root, "step_0000000002"))
    assert float(tree["state"]["edge_layers"][0]["norm1"]["count"]) == 2.0
    batch = _batch(6)
    want, _ = jpol.corais_apply(tree["params"], tree["state"],
                                jax.tree.map(jnp.asarray, batch), jcfg)
    with torch.no_grad():
        got = tpol.corais_apply(policy, _t(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    (opt_tree, _) = restore_pytree(
        {"opt_state": j_adam_init(params0, JAdamConfig())},
        os.path.join(ckpt.root, "step_0000000002"))
    assert int(opt_tree["opt_state"]["step"]) == 2


def test_greedy_eval_and_method_suite_run_on_the_port():
    """greedy_eval is the mean greedy makespan; the Table II method suite
    runs the port's decision path beside the numpy baselines, whose costs
    equal the reference's suite on the same instances."""
    cfg = _small_cfg()
    policy = tpol.CoRaiSPolicy(cfg.policy, device="cpu")
    batch = ttrain.to_device(tinst.generate_batch(
        np.random.default_rng(1), cfg.instance, 4), "cpu")
    with torch.no_grad():
        lp = tpol.corais_apply(policy, batch)
    want = tobj.makespan(batch, tdec.greedy_decode(lp)).mean()
    assert float(ttrain.greedy_eval(policy, batch)) == float(want)

    rng = np.random.default_rng(2)
    insts = [tinst.generate_instance(rng, cfg.instance) for _ in range(3)]
    methods = teval.standard_method_suite(policy, ref_budget_s=0.01,
                                          random_ns=(1, 10), sample_ns=(8,))
    res = teval.evaluate_methods(insts, methods, reference="Local")
    assert set(res) == {"ILS(0.01s)", "Local", "Random(1)", "Random(10)",
                        "CoRaiS(greedy)", "CoRaiS(8)"}
    assert res["Local"].mean_gap == 1.0
    for r in res.values():
        assert np.isfinite(r.mean_cost) and r.mean_time_s >= 0
    jres = jeval.evaluate_methods(
        insts, {"Local": jheur.solve_local,
                "Random(10)": lambda i: jheur.solve_random(i, 10, seed=0)},
        reference="Local")
    for name in ("Local", "Random(10)"):
        assert res[name].mean_cost == jres[name].mean_cost
        assert res[name].mean_gap == jres[name].mean_gap


def test_train_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device is CUDA here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(_small_cfg(), num_batches=1)
