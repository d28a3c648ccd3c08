"""The port's bf16 selective scan (``ssm_scan_dtype="bfloat16"``, the
reference's ``ssm-bf16`` variant) against the JAX reference, on the CPU.

With the bf16 scan the reference rounds exp(dt*A) and dt*B*u to bf16 and
runs its chunked associative scan in bf16 (``repro/models/ssm.py:74-87``),
rounding the state in a tree order; the port rounds the same inputs and
carries the state in bf16 at B6's rounding points (the plain versions'
``bf16_state``, ``kernels/ref.py::_bf16_chunks``). No twin matches a tree
of bf16 roundings bit for bit, so the bars are of the largest |entry|, set
by measurement:

* the scan (``ref.mamba_scan_torch``, ``ops.mamba_scan``,
  ``models.ssm.ssm_scan``) and the gated tail against the reference's
  ``ssm_scan(scan_dtype=bfloat16)``, and ``ssm_apply`` at S = 7 and 64,
  within 2e-2 of the largest |y| and |h_last|. The reference's own tree
  of roundings departs from an f32 state fed the same bf16 inputs by up to
  1.21e-2 of the largest |h_last| (six seeds of each scan case here); the
  port lies within 1.04e-2 of that state and within 1.39e-2 of the
  reference. A bar of 1e-2 would fail on the reference's noise;
* ``ssm_apply`` at S = 256 and 512 within 3e-2: there the reference
  departs from the f32 state fed its bf16 inputs by up to 1.35e-2 of the
  largest |h| (at S = 512), and the port lies within 2.1e-2 of it;
* the gradients of ``ssm_apply`` within 1.5e-2 of each gradient's largest
  |entry| against ``jax.vjp`` of the reference's bf16 ``ssm_apply``
  (measured: at most 6e-3; the reference carries bf16 cotangents through
  its scan, the port f32 ones);
* a reduced falcon-mamba prefill's logits at 1e-4, as
  ``tests/test_torch_lm_ssm.py`` holds the f32 one (the reduced model's
  states are of order 1e-7, so the rounding moves the logits little).

A bf16 scan is told from an f32 one by its rounding, not by y at these
bars, so every case also checks that h_last holds bf16 values only and
that the bf16 result differs from the f32 one. B6 and B6b with the bf16
state run on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
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
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.checkpoint import load_reference_lm_params
from repro_torch.kernels import build, ops, ref
from repro_torch.models import lm, ssm

torch.set_num_threads(1)

BAR = 2e-2        # of the largest |entry|, the scan and short blocks
LONG_BAR = 3e-2   # ssm_apply at S >= 256 (the module's docstring)
GRAD_BAR = 1.5e-2  # of each gradient's largest |entry|
LOGIT_TOL = dict(atol=1e-4, rtol=0)


def _scan_inputs(b, s, d, n, seed=0):
    """As ``tests/test_kernels.py`` makes them: u, B, C normal, dt =
    softplus(normal) * 0.1, A = -exp(0.2 * normal)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, s, d)).astype(np.float32)
    dt = (np.logaddexp(rng.normal(size=(b, s, d)), 0.0) * 0.1).astype(
        np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    a = (-np.exp(0.2 * rng.normal(size=(d, n)))).astype(np.float32)
    return u, dt, bm, cm, a


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _within(got, want, bar, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= bar, f"{what}: {err} of the largest |entry|, bar {bar}"
    return err


def _bf16_values(t):
    return bool(torch.equal(t.to(torch.bfloat16).float(), t))


def _rounding_happens(h, h_f32, y, y_f32):
    """h holds bf16 values (the f32 state does not), and the bf16 result
    differs from the f32 one by ten times the f32 bars (1e-5)."""
    assert _bf16_values(h) and not _bf16_values(h_f32)
    assert float((y - y_f32).abs().max()) > 1e-4 * float(y_f32.abs().max())


# (B, S, d, N) and the reference's chunk (a divisor of S)
SCAN_CASES = [((2, 512, 64, 16), 256), ((1, 300, 32, 8), 100)]


@pytest.mark.parametrize("shape,chunk", SCAN_CASES)
def test_plain_scan_matches_reference_bf16_scan(shape, chunk):
    args = _scan_inputs(*shape)
    y, h = ref.mamba_scan_torch(*_t(args), bf16_state=True)
    jy, jh = jssm.ssm_scan(*map(jnp.asarray, args), chunk=chunk,
                           scan_dtype=jnp.bfloat16)
    _within(y, jy, BAR, "y")
    _within(h, jh, BAR, "h_last")
    _rounding_happens(h, ref.mamba_scan_torch(*_t(args))[1], y,
                      ref.mamba_scan_torch(*_t(args))[0])


@pytest.mark.parametrize("shape,chunk", SCAN_CASES)
def test_ssm_scan_and_ops_take_the_bf16_state(shape, chunk):
    """``models.ssm.ssm_scan(scan_dtype="bfloat16")`` is ``ops.mamba_scan``
    with the flag, which on a CPU tensor is the plain version bit for bit
    and launches nothing."""
    args = _t(_scan_inputs(*shape, seed=1))
    build.reset_launch_counts()
    y, h = ssm.ssm_scan(*args, scan_dtype="bfloat16")
    wy, wh = ref.mamba_scan_torch(*args, bf16_state=True)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    oy, oh = ops.mamba_scan(*args, bf16_state=True)
    assert torch.equal(oy, wy) and torch.equal(oh, wh)
    assert build.LAUNCHES["mamba_scan"] == 0
    jy, jh = jssm.ssm_scan(*(jnp.asarray(a.numpy()) for a in args),
                           chunk=chunk, scan_dtype=jnp.bfloat16)
    _within(y, jy, BAR, "y")
    _within(h, jh, BAR, "h_last")


def test_scan_dtype_other_than_the_two_raises():
    args = _t(_scan_inputs(1, 8, 4, 2))
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        ssm.ssm_scan(*args, scan_dtype="float16")


def test_chunk_states_and_h0_hold_bf16_values():
    """The states entering each chunk (what B6 stores for B6b) are the
    bf16 state's, and an f32 ``h0`` is rounded first."""
    args = _t(_scan_inputs(2, 300, 16, 4, seed=2))
    y, h, states = ref.mamba_scan_torch(*args, chunk=128, bf16_state=True)
    assert states.shape == (2, 3, 16, 4) and _bf16_values(states)
    assert torch.equal(states[:, 0], torch.zeros(2, 16, 4))
    wy, wh = ref.mamba_scan_torch(*args, bf16_state=True)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    h0 = torch.randn(2, 16, 4, generator=torch.Generator().manual_seed(3))
    y0, _ = ref.mamba_scan_torch(*args, h0=h0, bf16_state=True)
    y1, _ = ref.mamba_scan_torch(*args, h0=ref.bf16_round(h0),
                                 bf16_state=True)
    assert torch.equal(y0, y1)


def _gated_inputs(b, s, d, n, seed=0):
    """The model's dt: dt_raw 0.5 * normal plus dt_bias, the inverse
    softplus of a dt log-uniform in [1e-3, 0.1]; z normal."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, s, d)).astype(np.float32)
    dt_raw = (0.5 * rng.normal(size=(b, s, d))).astype(np.float32)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), size=d))
    bias = (dt0 + np.log(-np.expm1(-dt0))).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    a = (-np.exp(0.2 * rng.normal(size=(d, n)))).astype(np.float32)
    dskip = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    z = rng.normal(size=(b, s, d)).astype(np.float32)
    return u, dt_raw, bias, bm, cm, a, dskip, z


def test_gated_plain_matches_the_reference_bf16_tail():
    """``mamba_scan_gated_torch`` with the flag against the tail of the
    reference's ``ssm_apply`` with the bf16 scan: softplus, the scan, the
    D skip and the gate in f32."""
    u, dt_raw, bias, bm, cm, a, dskip, z = _gated_inputs(2, 256, 32, 8)
    dt = jax.nn.softplus(jnp.asarray(dt_raw) + jnp.asarray(bias))
    jy, jh = jssm.ssm_scan(jnp.asarray(u), dt, jnp.asarray(bm),
                           jnp.asarray(cm), jnp.asarray(a), chunk=128,
                           scan_dtype=jnp.bfloat16)
    jy = (jy + jnp.asarray(dskip) * jnp.asarray(u)) * jax.nn.silu(
        jnp.asarray(z))
    args = _t((u, dt_raw, bias, bm, cm, a, dskip, z))
    out, h = ref.mamba_scan_gated_torch(*args, bf16_state=True)
    _within(out, jy, BAR, "out")
    _within(h, jh, BAR, "h_last")
    out32, h32 = ref.mamba_scan_gated_torch(*args)
    _rounding_happens(h, h32, out, out32)


def _block(seed=0):
    """Reduced falcon-mamba's SSM block with the reference's initial
    weights, the conv and the projections scaled up 10x as
    ``tests/test_torch_ssm.py`` takes them (h, y and the gate of order 1),
    in both packages with the bf16 scan."""
    cfg = dataclasses.replace(configs.get_reduced_config("falcon-mamba-7b"),
                              ssm_scan_dtype="bfloat16")
    jcfg = dataclasses.replace(
        jconfigs.get_reduced_config("falcon-mamba-7b"),
        ssm_scan_dtype="bfloat16")
    jp = jssm.ssm_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    jp = {k: v * 10.0 if k in ("conv_w", "in_proj", "x_proj", "out_proj")
          else v for k, v in jp.items()}
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, jcfg, p, jp


@pytest.mark.parametrize("s,bar", [(7, BAR), (64, BAR), (256, LONG_BAR),
                                   (512, LONG_BAR)])
def test_ssm_apply_matches_reference_bf16_block(s, bar):
    """The full-sequence block and the state it hands to decode; the bar
    at S >= 256 is the module docstring's."""
    cfg, jcfg, p, jp = _block()
    x = np.random.default_rng(s).normal(size=(2, s, cfg.d_model)).astype(
        np.float32)
    out, state = ssm.ssm_apply(p, torch.from_numpy(x), cfg)
    jout, jstate = jssm.ssm_apply(jp, jnp.asarray(x), jcfg)
    _within(out, jout, bar, "out")
    _within(state["h"], jstate["h"], bar, "h")
    np.testing.assert_allclose(state["conv"].numpy(),
                               np.asarray(jstate["conv"]), atol=1e-5,
                               rtol=1e-5)
    out32, state32 = ssm.ssm_apply(
        p, torch.from_numpy(x), dataclasses.replace(cfg,
                                                    ssm_scan_dtype="float32"))
    _rounding_happens(state["h"], state32["h"], out, out32)


def test_ssm_apply_gradients_match_reference_vjp():
    """Every leaf's and the input's gradient through ``ops.mamba_scan_gated``
    (its CPU backward, B6b's plain version with the flag) against
    ``jax.vjp`` of the reference's bf16 ``ssm_apply``, at S = 256."""
    cfg, jcfg, p, jp = _block()
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 256, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda jp, x: jssm.ssm_apply(jp, x, jcfg)[0], jp,
                     jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    tp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = ssm.ssm_apply(tp, tx, cfg)
    out.backward(torch.from_numpy(g))
    _within(tx.grad, jgx, GRAD_BAR, "dx")
    for k, t in tp.items():
        _within(t.grad, jgp[k], GRAD_BAR, f"d{k}")
    # the f32 scan's gradients differ: the flag reaches the backward
    tp32 = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out32, _ = ssm.ssm_apply(tp32, torch.from_numpy(x), dataclasses.replace(
        cfg, ssm_scan_dtype="float32"))
    out32.backward(torch.from_numpy(g))
    assert not torch.allclose(tp32["A_log"].grad, tp["A_log"].grad,
                              atol=1e-5, rtol=1e-5)


def test_gated_backward_on_cpu_is_the_plain_bf16_backward():
    """``MambaScanGated``'s backward with the flag is B6b's plain version
    with it, bit for bit."""
    args = _t(_gated_inputs(1, 150, 12, 4, seed=4))
    leaves = [t.clone().requires_grad_(True) for t in args]
    out, h = ops.mamba_scan_gated(*leaves, bf16_state=True)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    got = torch.autograd.grad(out, leaves, dout)
    want = ref.mamba_scan_gated_bwd_torch(*args, dout, bf16_state=True)
    for gt, w in zip(got, want):
        assert torch.equal(gt, w)
    wout, wh = ref.mamba_scan_gated_torch(*args, bf16_state=True)
    assert torch.equal(out.detach(), wout) and torch.equal(h.detach(), wh)


def _reference(seed=0):
    cfg = dataclasses.replace(configs.get_reduced_config("falcon-mamba-7b"),
                              ssm_scan_dtype="bfloat16")
    jcfg = dataclasses.replace(
        jconfigs.get_reduced_config("falcon-mamba-7b"),
        ssm_scan_dtype="bfloat16")
    jparams = j_init_params(jax.random.PRNGKey(seed), jcfg)
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams)[0]}
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(9))
    load_reference_lm_params(params, flat)
    return cfg, jcfg, jparams, params


@pytest.mark.parametrize("prompt", [13, 40])
def test_reduced_falcon_mamba_prefill_matches_reference(prompt):
    """A reduced falcon-mamba prefill with the bf16 scan: last-token logits
    at the f32 model's bar, the SSM states within BAR of the largest |h|
    and holding bf16 values."""
    cfg, jcfg, jparams, params = _reference()
    tokens = np.random.default_rng(prompt).integers(
        0, 256, (2, prompt)).astype(np.int32)
    jcache, jlogits = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcfg, 1, max_seq=64)
    cache, logits = lm.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               cfg, max_seq=64)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    h = cache["layers"]["h"]
    _within(h, jcache["layers"]["h"], BAR, "h")
    cache32, _ = lm.prefill(params, {"tokens": torch.from_numpy(tokens)},
                            dataclasses.replace(cfg,
                                                ssm_scan_dtype="float32"),
                            max_seq=64)
    assert _bf16_values(h) and not _bf16_values(cache32["layers"]["h"])
