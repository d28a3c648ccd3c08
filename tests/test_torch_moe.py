"""The port's MoE layer (``models/moe.py``) and the mixtral family against
the JAX reference, on the CPU.

``moe_apply`` runs on weights and tokens drawn with numpy from a seed
(router std 1/sqrt(d), so the router logits are O(1) and their margins
wide), the same arrays in both packages: the capacity dispatch with and
without dropped tokens, two dispatch groups, the dense decode path, an
exact tie in the router logits, and bf16. Every input's k-th to (k+1)-th
router margin is checked to exceed ``MARGIN`` first, so f32 noise cannot
flip a route (a check of the data, not a reseed). Tolerances: f32 outputs
within 1e-5 of their largest |entry|, the load-balance loss within 1e-6,
bf16 outputs atol = rtol = 2e-2 (``tests/test_torch_attention.py``'s
bf16 bar). The chosen experts and the dropped entries are exact.

The mixtral LM (reduced: 2 layers, d = 64, 4 experts top-2, a 16-token
window) runs on the reference's own weights, bridged: ``prefill`` and
``decode_step`` on both decode paths and a prompt past the window (logits
atol 1e-4, K/V 1e-5, slot positions exactly, as ``test_torch_lm.py``),
and the weight bridge both ways bit for bit in f32 and bf16.
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
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.checkpoint import load_reference_lm_params
from repro_torch.checkpoint.convert import host_array, stack_layers
from repro_torch.models import lm, moe
from repro_torch.nn import named_leaves

torch.set_num_threads(1)

ARCH = "mixtral-8x7b"
TOL = 1e-5          # f32 outputs, of their largest |entry|
AUX_TOL = 1e-6
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
MARGIN = 1e-5       # the data's k-th to (k+1)-th router logit margin
KV_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=0)   # tests/test_torch_lm.py


def _cfgs(**kw):
    return (dataclasses.replace(configs.get_reduced_config(ARCH), **kw),
            dataclasses.replace(jconfigs.get_reduced_config(ARCH), **kw))


def _weights(cfg, seed=0):
    """f32 numpy weights: router std 1/sqrt(d), the experts' 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return {"router": w((d, e), d), "wg": w((e, d, f), d),
            "wu": w((e, d, f), d), "wo": w((e, f, d), f)}


def _tokens(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _margins(x, router, k):
    """Each token's k-th minus (k+1)-th largest router logit, in f32."""
    logits = np.sort(x.reshape(-1, x.shape[-1]) @ router, axis=-1)[:, ::-1]
    return logits[:, k - 1] - logits[:, k]


def _both(cfg, jcfg, weights, x, dp_groups=1, dtype="float32"):
    """(port (y, aux), reference (y, aux)) on the same arrays; in bf16 the
    tokens and expert weights are rounded once from f32 in both packages
    and the router stays f32, as ``moe_init`` makes it."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = jnp.dtype(dtype)
    p = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else tdt)
         for k, v in weights.items()}
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt)
          for k, v in weights.items()}
    y, aux = moe.moe_apply(p, torch.from_numpy(x).to(tdt), cfg, dp_groups)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x, jdt), jcfg, dp_groups)
    return (y, aux), (np.asarray(jy.astype(jnp.float32)), float(jaux))


def _check_f32(got, want):
    (y, aux), (jy, jaux) = got, want
    scale = np.abs(jy).max()
    assert np.abs(y.numpy() - jy).max() <= TOL * scale
    assert abs(float(aux) - jaux) <= AUX_TOL


# (capacity factor, dp_groups, dense decode): no drops; drops; two groups
# with drops; a group count that does not divide B*S (one group); dense
CASES = [(4.0, 1, False), (0.5, 1, False), (0.5, 2, False), (0.5, 5, False),
         (1.25, 1, True)]


@pytest.mark.parametrize("cf,groups,dense", CASES)
def test_moe_apply_matches_reference(cf, groups, dense):
    cfg, jcfg = _cfgs(capacity_factor=cf, moe_dense_decode=dense)
    weights = _weights(cfg)
    x = _tokens(2, 12, cfg.d_model)
    assert _margins(x, weights["router"], cfg.experts_per_token).min() > \
        MARGIN
    _check_f32(*_both(cfg, jcfg, weights, x, groups))


@pytest.mark.parametrize("groups", [1, 2])
def test_dropped_entries_equal_reference(groups):
    """At capacity factor 0.25 about half the entries are past their
    expert's 8 slots and dropped: the port's chosen experts equal
    ``jax.lax.top_k``'s, its kept
    set equals the rank of each entry among the earlier entries (row-major
    over (N, k), per group) below the reference's capacity, and a token
    with every entry dropped comes out exactly 0 in both packages."""
    cfg, jcfg = _cfgs(capacity_factor=0.25)
    weights = _weights(cfg, seed=3)
    x = _tokens(4, 16, cfg.d_model, seed=4)
    k, e = cfg.experts_per_token, cfg.num_experts
    assert _margins(x, weights["router"], k).min() > MARGIN
    n = x.shape[0] * x.shape[1] // groups
    cap = jmoe._capacity(n, jcfg)
    assert moe._capacity(n, cfg) == cap == 8

    xg = torch.from_numpy(x).reshape(groups, n, -1)
    _, idx, _ = moe.route(xg, torch.from_numpy(weights["router"]), k)
    jlogits = jnp.asarray(x).reshape(groups, n, -1) @ weights["router"]
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(jax.lax.top_k(jlogits, k)[1]))
    _, keep = moe.slots(idx, e, cap)
    want = np.zeros((groups, n * k), bool)
    for g in range(groups):
        seen = np.zeros(e, int)
        for j, ex in enumerate(idx[g].reshape(-1).tolist()):
            want[g, j] = seen[ex] < cap
            seen[ex] += 1
    np.testing.assert_array_equal(keep.numpy(), want)
    assert not want.all()  # some entries are dropped

    got, ref = _both(cfg, jcfg, weights, x, groups)
    _check_f32(got, ref)
    gone = ~want.reshape(groups * n, k).any(-1)
    assert gone.any()
    assert not got[0].reshape(groups * n, -1)[torch.from_numpy(gone)].any()
    assert not ref[0].reshape(groups * n, -1)[gone].any()


@pytest.mark.parametrize("dense", [False, True])
def test_router_tie_takes_the_lower_expert(dense):
    """Experts 1 and 2 have equal router columns, so their logits tie
    exactly on every token: the lower expert comes first (and wins where
    the tie is for the last choice), as in ``jax.lax.top_k``."""
    cfg, jcfg = _cfgs(moe_dense_decode=dense)
    weights = _weights(cfg, seed=5)
    weights["router"][:, 2] = weights["router"][:, 1]
    x = _tokens(2, 12, cfg.d_model, seed=6)
    k = cfg.experts_per_token
    _, idx, _ = moe.route(torch.from_numpy(x), torch.from_numpy(
        weights["router"]), k)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x) @ weights["router"], k)[1])
    np.testing.assert_array_equal(idx.numpy(), want)
    flat = idx.reshape(-1, k).numpy()
    both = (flat == 1).any(-1) & (flat == 2).any(-1)
    last = (flat[:, -1] == 1) & ~both  # the tie decided the last choice
    assert both.any() and last.any()
    assert (flat[both] == [1, 2]).all()
    _check_f32(*_both(cfg, jcfg, weights, x))


def _bf16_rounded(weights):
    return {k: v if k == "router" else
            torch.from_numpy(v).bfloat16().float().numpy()
            for k, v in weights.items()}


@pytest.mark.parametrize("cf,groups", [(4.0, 1), (0.5, 2)])
def test_moe_apply_bf16_matches_reference(cf, groups):
    cfg, jcfg = _cfgs(capacity_factor=cf, dtype="bfloat16")
    weights = _weights(cfg, seed=7)
    x = _tokens(2, 12, cfg.d_model, seed=8)
    x16 = torch.from_numpy(x).bfloat16().float().numpy()
    assert _margins(x16, weights["router"], cfg.experts_per_token).min() > \
        MARGIN
    (y, aux), (jy, jaux) = _both(cfg, jcfg, weights, x, groups, "bfloat16")
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), jy, **BF16_TOL)
    assert abs(float(aux) - jaux) <= AUX_TOL


def test_dense_moe_bf16_matches_reference_in_f32():
    """The reference's bf16 dense path does not run on XLA's CPU (its
    bf16 x bf16 -> f32 product is unsupported there), so the port's bf16
    dense path is held to the reference's f32 dense path on the same
    bf16-rounded tokens and weights: they differ by the bf16 roundings of
    h and of the output."""
    cfg, _ = _cfgs(moe_dense_decode=True, dtype="bfloat16")
    _, jcfg = _cfgs(moe_dense_decode=True)
    weights = _weights(cfg, seed=7)
    x16 = torch.from_numpy(_tokens(2, 12, cfg.d_model, seed=8)).bfloat16()
    assert _margins(x16.float().numpy(), weights["router"],
                    cfg.experts_per_token).min() > MARGIN
    p = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                   else torch.bfloat16)
         for k, v in weights.items()}
    y, aux = moe.moe_apply(p, x16, cfg)
    jy, jaux = jmoe.moe_apply(
        {k: jnp.asarray(v) for k, v in _bf16_rounded(weights).items()},
        jnp.asarray(x16.float().numpy()), jcfg)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy), **BF16_TOL)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


# -- the mixtral LM -----------------------------------------------------------


def _reference(dtype=None, **kw):
    if dtype is not None:
        kw["dtype"] = dtype
    cfg, jcfg = _cfgs(**kw)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams)[0]}
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(9))
    load_reference_lm_params(params, flat)
    return cfg, jcfg, jparams, params, flat


def _assert_cache(cache, jcache):
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]), **KV_TOL)
    for key in ("slot_pos", "pos"):
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(jcache[key]))


def _int_tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("prompt,max_seq", [(13, 32), (40, 48)])
def test_mixtral_prefill_and_decode_match_reference(dense, prompt, max_seq):
    """Prefill then three decode steps; a 40-token prompt is past the
    16-token window, so the cache is the rolling one. Decode runs the
    capacity dispatch on the B tokens, or the dense path."""
    cfg, jcfg, jparams, params, _ = _reference(moe_dense_decode=dense)
    tokens = _int_tokens(2, prompt, seed=2)
    jcache, jlogits = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcfg, 1, max_seq=max_seq)
    cache, logits = lm.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               cfg, max_seq=max_seq)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _assert_cache(cache, jcache)
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, c, {"token": t}, jcfg))
    for step, tok in enumerate(_int_tokens(3, 2, seed=3)):
        jcache, jlogits = jstep(jparams, jcache, jnp.asarray(tok))
        cache, logits = lm.decode_step(params, cache,
                                       {"token": torch.from_numpy(tok)}, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL, err_msg=f"step {step}")
        _assert_cache(cache, jcache)


def test_mixtral_prefill_dp_groups_matches_reference():
    """``prefill`` with two dispatch groups, each with its own capacity."""
    cfg, jcfg, jparams, params, _ = _reference(capacity_factor=0.5)
    tokens = _int_tokens(2, 24, seed=5)
    jcache, jlogits = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcfg, 2, max_seq=32)
    cache, logits = lm.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               cfg, max_seq=32, dp_groups=2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _assert_cache(cache, jcache)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixtral_weight_bridge_both_ways(dtype):
    """The reference's MoE leaves, ``layers/moe/{wg,wu,wo}`` (L, E, d, f)
    and (L, E, f, d) and ``layers/moe/router`` (L, d, E), land bit for bit
    in the port's per-layer leaves, and ``stack_layers`` gives them back
    bit for bit in the reference's layout."""
    cfg, _, _, params, flat = _reference(dtype)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    shapes = {"layers/moe/wg": (2, e, d, f), "layers/moe/wu": (2, e, d, f),
              "layers/moe/wo": (2, e, f, d), "layers/moe/router": (2, d, e)}
    for key, shape in shapes.items():
        assert flat[key].shape == shape, key
    assert not any(k.startswith("layers/mlp") for k in flat)
    back = stack_layers(named_leaves(params))
    assert set(back) == set(flat)
    for key, want in flat.items():
        got = host_array(back[key])
        assert got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), key
    assert params["layers"][1]["moe"]["router"].dtype == torch.float32
    assert params["layers"][1]["moe"]["wg"].dtype == (
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def test_moe_training_is_refused_before_allocating():
    """MoE training runs now: ``train_loss`` at the reduced mixtral adds
    0.01 times the layers' mean load-balance loss, reports it as
    ``aux_loss``, and its gradient reaches the router and every expert.
    (Its parity is ``tests/test_torch_moe_train.py``'s.)"""
    cfg, _, _, params, _ = _reference()
    leaves = named_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.int32),
             "labels": torch.zeros(1, 4, dtype=torch.int32)}
    total, metrics = lm.train_loss(params, batch, cfg)
    aux = float(metrics["aux_loss"].detach())
    assert aux > 0
    torch.testing.assert_close(float(total.detach()),
                               float(metrics["loss"].detach()) + 0.01 * aux)
    router, wo = torch.autograd.grad(
        total, [leaves["layers/0/moe/router"], leaves["layers/1/moe/wo"]])
    assert float(router.abs().max()) > 0 and bool(torch.isfinite(wo).all())
