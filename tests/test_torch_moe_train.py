"""MoE (mixtral) training against the JAX reference, on the CPU.

The reduced mixtral LM (2 layers, d = 64, 4 experts top-2, a 16-token
window, f32) runs ``train_loss`` on the reference's own weights, bridged
through ``checkpoint/convert.py``, on tokens drawn with numpy from a
seed: the total (``loss + 0.01 * aux``), the loss, ``aux_loss`` (the
layers' mean load-balance loss) and the gradient of every leaf against
``jax.value_and_grad`` of the reference's ``train_loss``, at one dispatch
group under remat "full" and at two with dropped entries (capacity
factor 0.5). Tolerances: 1e-5 for the losses, every gradient within 1e-4
of its largest |entry| (ROADMAP "How parity is held"). The train step
passes the reference's ``_dp_groups``: 1 on one device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.models import init_params as j_init_params
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.checkpoint import load_reference_lm_params
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.nn import named_leaves

torch.set_num_threads(1)

ARCH = "mixtral-8x7b"
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4                       # of each gradient's largest |entry|


def _reference(**kw):
    cfg = dataclasses.replace(configs.get_reduced_config(ARCH), **kw)
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(ARCH), **kw)
    jparams = jax.jit(j_init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams)[0]}
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(9))
    load_reference_lm_params(params, flat)
    return cfg, jcfg, jparams, params


@pytest.mark.parametrize("groups,cf,remat", [(1, 4.0, "full"),
                                             (2, 0.5, "none")])
def test_mixtral_train_loss_aux_and_gradients_match_reference(groups, cf,
                                                              remat):
    cfg, jcfg, jparams, params = _reference(capacity_factor=cf, remat=remat)
    rng = np.random.default_rng(groups * 10 + int(cf))
    b, s = 2, 24
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    batch["labels"][:, :3] = -100
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jlm.train_loss(p, bt, jcfg, groups), has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    jflat = {k: np.asarray(v) for k, v in _flatten_with_paths(jgrads)[0]}
    leaves = named_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    total, metrics = lm.train_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
        groups)
    grads = dict(zip(leaves, torch.autograd.grad(
        total, list(leaves.values()), allow_unused=True)))
    assert float(metrics["aux_loss"].detach()) > 0.5  # E sum f_e P_e / k ~ 1
    for got, want in ((total, jtotal), (metrics["loss"], jmetrics["loss"]),
                      (metrics["aux_loss"], jmetrics["aux_loss"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   **LOSS_TOL)
    np.testing.assert_allclose(
        float(total.detach()), float(metrics["loss"].detach())
        + 0.01 * float(metrics["aux_loss"].detach()), **LOSS_TOL)
    for key, g in grads.items():
        parts = key.split("/")
        want = (jflat["/".join(["layers"] + parts[2:])][int(parts[1])]
                if parts[0] == "layers" else jflat[key])
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert np.abs(got - want).max() <= GRAD_TOL * scale, key
    # the router learns from the load-balance term too
    assert float(grads["layers/0/moe/router"].abs().max()) > 0


@pytest.mark.parametrize("batch,seq,kind,want", [
    (8, 128, "train", 1), (1, 1, "decode", 1), (4, 16, "train", 1)])
def test_dp_groups_is_the_reference_rule_on_one_device(batch, seq, kind,
                                                       want):
    """The reference's ``_dp_groups`` on a data axis of one: 1 group."""
    cfg = configs.get_reduced_config(ARCH)
    shape = ShapeConfig(name="cell", seq_len=seq, global_batch=batch,
                        kind=kind)
    assert steps._dp_groups(None, cfg, shape) == want
    assert steps._dp_groups(None, cfg, None) == 1


def test_train_step_updates_mixtral_with_its_aux_metric():
    """``build_train_step`` on reduced mixtral: the step's metrics carry
    ``aux_loss`` and its total, and two steps change every expert."""
    cfg = configs.get_reduced_config(ARCH)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(3))
    before = params["layers"][1]["moe"]["wo"].clone()
    _, opt_init, _ = steps.make_optimizer(cfg, steps.TrainKnobs())
    opt_state = opt_init(named_leaves(params))
    step = steps.build_train_step(cfg)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    for _ in range(2):
        params, opt_state, metrics = step(params, opt_state, batch)
    assert np.isfinite(float(metrics["aux_loss"]))
    np.testing.assert_allclose(
        float(metrics["loss_total"]),
        float(metrics["loss"]) + 0.01 * float(metrics["aux_loss"]),
        rtol=1e-6)
    moved = (params["layers"][1]["moe"]["wo"] - before).abs().amax((1, 2))
    assert bool((moved > 0).all())
