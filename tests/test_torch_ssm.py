"""The port's mamba-1 SSM block (B6's plain version, the causal depthwise
conv, ``models/ssm.py``) against the JAX reference, on the CPU.

The same numpy inputs (from a seed) go through the port and through the
reference: B6's plain version (``kernels/ref.py::mamba_scan_torch``, what
``kernels/ops.py`` runs for CPU tensors) against the reference's Pallas
kernel in interpret mode (``repro.kernels.ops.mamba_scan``, S a multiple of
``chunk`` and d of ``bd``) and its oracle ``mamba_scan_ref`` (any S, an
initial state); the conv and the block (``ssm_apply``, ``ssm_decode_step``)
at reduced falcon-mamba in f32 with the reference's own initial weights.
Tolerance 1e-5 (atol and rtol): the same f32 math in another order. The
CUDA kernel runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.kernels import build, ops, ref
from repro_torch.models import common, ssm

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _scan_inputs(b, s, d, n, seed=0):
    """Inputs made as ``tests/test_kernels.py`` makes them: u, B, C normal,
    dt = softplus(normal) * 0.1, A = -exp(0.2 * normal)."""
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


@pytest.mark.parametrize("shape", [(2, 128, 64, 8), (1, 64, 128, 16)])
@pytest.mark.parametrize("chunk,bd", [(32, 32), (64, 64)])
def test_mamba_scan_plain_matches_pallas_and_oracle(shape, chunk, bd):
    """The reference sweep's shapes (``tests/test_kernels.py:66``)."""
    args = _scan_inputs(*shape)
    y, h = ref.mamba_scan_torch(*_t(args))
    jy, jh = jops.mamba_scan(*map(jnp.asarray, args), chunk=chunk, bd=bd)
    ry, rh = jref.mamba_scan_ref(*map(jnp.asarray, args))
    for got, want in ((y, jy), (h, jh), (y, ry), (h, rh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,with_h0", [((1, 37, 20, 4), False),
                                           ((1, 37, 20, 4), True),
                                           ((2, 37, 64, 16), True),
                                           ((3, 1, 5, 16), True)])
def test_mamba_scan_plain_matches_oracle_ragged_and_h0(shape, with_h0):
    """A ragged S (the Pallas kernel needs S % chunk == 0) and an initial
    state, against ``mamba_scan_ref`` only."""
    b, s, d, n = shape
    args = _scan_inputs(*shape, seed=3)
    h0 = (np.random.default_rng(4).normal(size=(b, d, n)).astype(np.float32)
          if with_h0 else None)
    y, h = ref.mamba_scan_torch(*_t(args), h0=None if h0 is None
                                else torch.from_numpy(h0))
    ry, rh = jref.mamba_scan_ref(*map(jnp.asarray, args),
                                 h0=None if h0 is None else jnp.asarray(h0))
    assert y.shape == (b, s, d) and h.shape == (b, d, n)
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **TOL)


def test_ops_mamba_scan_runs_the_plain_version_on_cpu():
    """A CPU tensor takes the plain version bit for bit and launches
    nothing."""
    args = _t(_scan_inputs(2, 50, 24, 4, seed=5))
    build.reset_launch_counts()
    y, h = ops.mamba_scan(*args)
    wy, wh = ref.mamba_scan_torch(*args)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    assert build.LAUNCHES["mamba_scan"] == 0


@pytest.mark.parametrize("s", [1, 2, 3, 7, 33])
def test_causal_depthwise_conv_matches_reference(s):
    rng = np.random.default_rng(s)
    u = rng.normal(size=(2, s, 12)).astype(np.float32)
    w = rng.normal(size=(12, 4)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    got = common.causal_depthwise_conv(*_t((u, w, b)))
    want = jcommon.causal_depthwise_conv(*map(jnp.asarray, (u, w, b)))
    assert got.shape == (2, s, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [2, 9])
def test_conv_step_matches_reference_and_the_full_conv(s):
    """Steps from a zero state over S inputs (S = 2 < K - 1 included)
    reproduce the full-sequence conv, and each step and its new state equal
    the reference's."""
    rng = np.random.default_rng(10 + s)
    u = rng.normal(size=(3, s, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    ut, wt, bt = _t((u, w, b))
    state = torch.zeros(3, 3, 8)
    jstate = jnp.zeros((3, 3, 8), jnp.float32)
    full = common.causal_depthwise_conv(ut, wt, bt)
    for t in range(s):
        y, state = common.conv_step(ut[:, t], state, wt, bt)
        jy, jstate = jcommon.conv_step(jnp.asarray(u[:, t]), jstate,
                                       jnp.asarray(w), jnp.asarray(b))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                                   **TOL)
        np.testing.assert_allclose(y.numpy(), full[:, t].numpy(), **TOL)


def _block(seed=0):
    """Reduced falcon-mamba (d_model 64, d_inner 128, N 4, dt_rank 4) with
    the reference's initial weights for one SSM block, bridged. The conv
    and the in, x and out projections are scaled up 10x from their init
    (std 0.02), whose state would stay near 1e-7, so that h, y and the gate
    are of order 1."""
    cfg = configs.get_reduced_config("falcon-mamba-7b")
    jcfg = jconfigs.get_reduced_config("falcon-mamba-7b")
    jp = jssm.ssm_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    jp = {k: v * 10.0 if k in ("conv_w", "in_proj", "x_proj", "out_proj")
          else v for k, v in jp.items()}
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, jcfg, p, jp


@pytest.mark.parametrize("s", [2, 7, 256, 512])
def test_ssm_apply_matches_reference(s):
    """The full-sequence block and the state it hands to decode; S = 2 is
    shorter than the conv (the conv state's padding branch), 512 spans two
    of the reference's 256-step chunks."""
    cfg, jcfg, p, jp = _block()
    x = np.random.default_rng(s).normal(size=(2, s, cfg.d_model)).astype(
        np.float32)
    out, state = ssm.ssm_apply(p, torch.from_numpy(x), cfg)
    jout, jstate = jssm.ssm_apply(jp, jnp.asarray(x), jcfg)
    assert out.shape == (2, s, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for key in ("h", "conv"):
        assert state[key].dtype == torch.float32
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(jstate[key]), **TOL)
    assert float(state["h"].abs().max()) > 0.01  # a state that is not ~0
    # the conv state owns its K-1 rows, not a view of the (B, S, d) input
    assert state["conv"].untyped_storage().nbytes() == 4 * state[
        "conv"].numel()


def test_ssm_decode_step_matches_reference():
    """Four one-token steps from a prefill's state; the port updates the
    state in place."""
    cfg, jcfg, p, jp = _block(seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 11, cfg.d_model)).astype(np.float32)
    _, state = ssm.ssm_apply(p, torch.from_numpy(x), cfg)
    _, jstate = jssm.ssm_apply(jp, jnp.asarray(x), jcfg)
    state = {k: v.clone() for k, v in state.items()}
    h_buf = state["h"]
    for step in range(4):
        xt = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
        y = ssm.ssm_decode_step(p, torch.from_numpy(xt), state, cfg)
        jy, jstate = jssm.ssm_decode_step(jp, jnp.asarray(xt), jstate, jcfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL,
                                   err_msg=f"step {step}")
        for key in ("h", "conv"):
            np.testing.assert_allclose(state[key].numpy(),
                                       np.asarray(jstate[key]), **TOL)
    assert state["h"] is h_buf


def test_ssm_scan_takes_any_length():
    """The reference's ``ssm_scan`` asserts S % min(chunk, S) == 0; the
    port's takes S = 300 and equals the oracle."""
    args = _scan_inputs(1, 300, 16, 4, seed=6)
    y, h = ssm.ssm_scan(*_t(args))
    ry, rh = jref.mamba_scan_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **TOL)
    with pytest.raises(AssertionError):
        jssm.ssm_scan(*map(jnp.asarray, args), chunk=256)


@pytest.mark.parametrize("arch,dtype", [("falcon-mamba-7b", torch.float32),
                                        ("hymba-1.5b", torch.bfloat16)])
def test_ssm_init_matches_reference_leaves(arch, dtype):
    """The reference's leaves, shapes and dtypes (projections in the model
    dtype; conv, dt and A in f32); ``A_log``, ``D`` and ``conv_b`` exactly;
    ``dt_bias`` the inverse softplus of a dt in [1e-3, 1e-1]."""
    cfg = configs.get_reduced_config(arch)
    jcfg = jconfigs.get_reduced_config(arch)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jssm.ssm_init(jax.random.PRNGKey(0), jcfg, jdtype)
    p = ssm.ssm_init(torch.Generator().manual_seed(0), cfg, dtype)
    assert list(p) == list(jp)
    for key, want in jp.items():
        assert tuple(p[key].shape) == want.shape, key
        assert str(p[key].dtype).split(".")[-1] == want.dtype.name, key
    for key in ("A_log", "D", "conv_b"):
        np.testing.assert_array_equal(p[key].numpy(), np.asarray(jp[key]))
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    log_dt = torch.log(dt)  # log-uniform: the mean of log dt near the middle
    assert abs(float(log_dt.mean()) - float(np.log(1e-2))) < 0.5
    again = ssm.ssm_init(torch.Generator().manual_seed(0), cfg, dtype)
    assert all(torch.equal(again[k], p[k]) for k in p)


def test_reduced_precision_scan_is_not_ported():
    """The reduced-precision scan was refused; it runs now: the bf16 scan
    (``ssm_scan_dtype="bfloat16"``) carries the block's state in bf16
    against the reference's at the bars of
    ``tests/test_torch_ssm_bf16.py``, and a dtype other than the two
    raises ValueError naming them."""
    cfg, jcfg, p, jp = _block()
    cfg = dataclasses.replace(cfg, ssm_scan_dtype="bfloat16")
    jcfg = dataclasses.replace(jcfg, ssm_scan_dtype="bfloat16")
    x = np.random.default_rng(7).normal(size=(2, 33, cfg.d_model)).astype(
        np.float32)
    out, state = ssm.ssm_apply(p, torch.from_numpy(x), cfg)
    jout, jstate = jssm.ssm_apply(jp, jnp.asarray(x), jcfg)
    for got, want in ((out, jout), (state["h"], jstate["h"])):
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= 2e-2 * float(
            np.abs(want).max())
    assert torch.equal(state["h"].to(torch.bfloat16).float(), state["h"])
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        ssm.ssm_apply(p, torch.zeros(1, 4, cfg.d_model),
                      dataclasses.replace(cfg, ssm_scan_dtype="float16"))


def test_ssm_state_shapes_match_reference():
    for arch in ("falcon-mamba-7b", "hymba-1.5b"):
        for cfg_fn in (configs.get_config, configs.get_reduced_config):
            cfg = cfg_fn(arch)
            assert ssm.ssm_state_shapes(cfg, 3) == jssm.ssm_state_shapes(
                cfg, 3)
