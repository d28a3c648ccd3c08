"""B6's chunk-parallel design (``kernels/csrc/mamba_scan.cu``) written out in
torch, on the CPU, against the JAX reference; and B6's gated entry's plain
version against the reference's ``ssm_apply`` tail.

The CUDA kernel runs only on a card. Here its decomposition is spelled out
step by step as the kernel takes it: blocks of 32 channels, chunks of
P * SEG steps walked in order, P segments of SEG steps per chunk, each
segment's (decay, value) pair composed in registers (the decay as one
exponential of the summed dt), a Hillis-Steele combine over the segments
in a fixed order, the exclusive prefix applied to the state carried in
from the previous chunk, the segments walked again for y, exponentials as
exp2 of dt * (A * log2 e). It is held against ``mamba_scan_ref`` and the
Pallas kernel in interpret mode at the reference's own bar, atol = rtol =
5e-4 (``tests/test_kernels.py``; the same bar holds the kernel against
its plain version on the card): the design reorders f32 products and sums
(segment products, the combine), so it matches to rounding, not to the
bit. The decomposition takes the plan the source states; the plans that
``tools/b6_ablation.py`` compiles and times beside it are held here too,
as is that tool's patching of the source.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import mamba_scan as msm

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "b6_ablation", Path(__file__).resolve().parents[1] / "tools"
    / "b6_ablation.py")
abl = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(abl)

TOL = dict(atol=5e-4, rtol=5e-4)
LOG2E = 1.4426950408889634
SOURCE = abl.SOURCE.read_text()
P0, SEG0, _ = abl.source_plan(SOURCE)
TILE = 32  # kTC, channels per block: one 128-byte row of f32


def design_scan(u, dt, B_mat, C_mat, A, segments, seg_len, tile=TILE,
                bf16=False):
    """The kernel's decomposition of the scan from a zero state; u, dt
    (B, S, d), B_mat, C_mat (B, S, N), A (d, N), f32. Returns (y, h_last).
    ``bf16``: the bf16 state's rounding points (the source's header note):
    exp(dt * A) and dt * u * B rounded where formed, a segment's decay the
    product of its rounded exponentials, the state entering a segment and
    after each step of its walk rounded."""
    rnd = ref.bf16_round if bf16 else (lambda x: x)
    b, s, d = u.shape
    n = A.shape[-1]
    p, seg = segments, seg_len
    chunk = p * seg
    a2 = A * LOG2E
    y = torch.zeros(b, s, d)
    h_last = torch.zeros(b, d, n)
    for c0 in range(0, d, tile):  # one block per channel tile
        cs = slice(c0, min(c0 + tile, d))
        dc = cs.stop - c0
        carry = torch.zeros(b, dc, n)
        for t0 in range(0, s, chunk):  # chunks in order
            rows = min(chunk, s - t0)

            def tile_of(x, width):  # rows past S are zeros: identity steps
                out = torch.zeros(b, chunk, width)
                out[:, :rows] = x[:, t0:t0 + rows]
                return out.reshape(b, p, seg, width)

            uu, dd = tile_of(u[..., cs], dc), tile_of(dt[..., cs], dc)
            bb, cc = tile_of(B_mat, n), tile_of(C_mat, n)
            duv = dd * uu
            sdv = torch.zeros(b, p, dc)
            for i in range(seg):
                sdv = sdv + dd[:, :, i]
            # each segment's (decay, value) pair, per state
            ea = rnd(torch.exp2(dd[..., None] * a2[cs]))   # (b, p, seg, dc, n)
            eb = rnd(duv[..., None] * bb[:, :, :, None, :])
            ac = (ea.prod(2) if bf16
                  else torch.exp2(sdv[..., None] * a2[cs]))  # (b, p, dc, n)
            bc = torch.zeros(b, p, dc, n)
            for i in range(seg):
                bc = ea[:, :, i] * bc + eb[:, :, i]
            # Hillis-Steele inclusive combine over the segments
            off = 1
            while off < p:
                new_ac, new_bc = ac.clone(), bc.clone()
                new_bc[:, off:] = ac[:, off:] * bc[:, :-off] + bc[:, off:]
                new_ac[:, off:] = ac[:, off:] * ac[:, :-off]
                ac, bc = new_ac, new_bc
                off *= 2
            # the state entering each segment: the exclusive prefix on the
            # carry
            h = torch.empty(b, p, dc, n)
            h[:, 0] = carry
            h[:, 1:] = rnd(ac[:, :-1] * carry[:, None] + bc[:, :-1])
            yv = torch.zeros(b, p, seg, dc)
            for i in range(seg):
                h = rnd(ea[:, :, i] * h + eb[:, :, i])
                yv[:, :, i] = (h * cc[:, :, i, None, :]).sum(-1)
            carry = h[:, p - 1]
            y[:, t0:t0 + rows, cs] = yv.reshape(b, chunk, dc)[:, :rows]
        h_last[:, cs] = carry
    return y, h_last


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


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("shape,pallas", [
    ((1, 3, 40, 16), None),          # S shorter than one segment
    ((2, 256, 64, 16), (64, 64)),    # S a multiple of the chunk, B > 1
    ((1, 200, 70, 4), None),         # ragged S and d, N = 4
    ((2, 37, 33, 1), None),          # N = 1
    ((1, 130, 32, 32), None),        # N = 32, one step past two chunks
    ((3, 128, 64, 8), (32, 32)),     # the reference sweep's N, B = 3
])
def test_design_matches_reference_oracle_and_pallas(shape, pallas):
    """The source's plan's decomposition against the oracle (any S) and, where S and
    d fit its blocks, the Pallas kernel in interpret mode."""
    args = _scan_inputs(*shape, seed=shape[1])
    got = design_scan(*map(torch.from_numpy, args), P0, SEG0)
    _check(got, jref.mamba_scan_ref(*map(jnp.asarray, args)))
    if pallas is not None:
        chunk, bd = pallas
        _check(got, jops.mamba_scan(*map(jnp.asarray, args), chunk=chunk,
                                    bd=bd))


@pytest.mark.parametrize("shape", [(1, 3, 40, 16), (2, 256, 64, 16),
                                   (1, 200, 70, 4), (2, 37, 33, 1),
                                   (1, 130, 32, 32), (2, 300, 40, 16)])
def test_bf16_design_matches_the_plain_bf16_scan(shape):
    """The source's plan with the bf16 state's rounding points against the
    plain version with ``bf16_state`` (which rounds at the same points, at
    the plan ``ref.BF16_SEGMENTS, ref.BF16_SEG_LEN`` names): within 2e-3
    of the largest |entry| (measured: at most 5.2e-4, where exp2 of dt *
    (A log2 e) and exp(dt * A) an f32 ulp apart round to neighbouring
    bf16 decays), h_last equal, and both holding bf16 values."""
    assert (ref.BF16_SEGMENTS, ref.BF16_SEG_LEN) == (P0, SEG0)
    args = list(map(torch.from_numpy, _scan_inputs(*shape, seed=shape[1])))
    y, h = design_scan(*args, P0, SEG0, bf16=True)
    wy, wh = ref.mamba_scan_torch(*args, bf16_state=True)
    assert float((y - wy).abs().max()) <= 2e-3 * float(wy.abs().max())
    assert torch.equal(h, wh)
    assert torch.equal(h.to(torch.bfloat16).float(), h)


@pytest.mark.parametrize("plan", abl.SWEEP)
def test_every_plan_matches_the_oracle(plan):
    """Every plan of the ablation tool's sweep (segments, steps per
    segment; the unroll does not change the function) at a ragged S over
    three chunks."""
    segments, seg_len, _ = plan
    assert seg_len % 4 == 0 and 32 % segments == 0  # the kernel's rules
    args = _scan_inputs(2, 300, 40, 16, seed=7)
    got = design_scan(*map(torch.from_numpy, args), segments, seg_len)
    _check(got, jref.mamba_scan_ref(*map(jnp.asarray, args)))


def test_sweep_copies_state_their_plans():
    """The source's plan is one of the sweep's, and the tool makes one
    copy of the source for each other plan, stating that plan."""
    plan = abl.source_plan(SOURCE)
    assert plan in abl.SWEEP
    copies = abl.variants(SOURCE)
    plans = {name: abl.source_plan(text) for name, text in copies.items()
             if name.startswith("plan_")}
    assert sorted(plans.values()) == sorted(p for p in abl.SWEEP
                                            if p != plan)
    assert copies["full"] == SOURCE


@pytest.mark.parametrize("cut", sorted(abl.CUTS))
def test_ablation_cuts_apply_to_the_source(cut):
    """Each cut of ``tools/b6_ablation.py`` finds its text exactly once in
    the source, so an edit of those lines fails here and not on the
    card."""
    text = abl.patched(SOURCE, cut, abl.CUTS[cut])
    assert text != SOURCE
    assert abl.source_plan(text) == abl.source_plan(SOURCE)


def _kernel_softplus(x):
    """The gated entry's softplus arithmetic (``softplus()`` in the
    source), in f32: max(x, 0) + 2 atanh(e / (2 + e)), e = exp(-|x|), as
    an odd series; x above 20 stays x."""
    e = torch.exp2(-x.abs() * LOG2E)
    r = e / (2 + e)
    r2 = r * r
    q = torch.full_like(x, 1 / 15)
    for k in (13, 11, 9, 7, 5, 3, 1):
        q = q * r2 + 1 / k
    return torch.where(x > 20, x, torch.clamp(x, min=0) + 2 * r * q)


def test_kernel_softplus_is_within_2e6_of_softplus():
    """The header note's claim: within 2e-6 relative of F.softplus (f64)
    over [-30, 30], the threshold included."""
    x = torch.linspace(-30, 30, 120_001, dtype=torch.float32)
    want = F.softplus(x.double())
    rel = ((_kernel_softplus(x).double() - want).abs() / want).max()
    assert float(rel) < 2e-6


def _gated_inputs(b, s, d, n, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, s, d)).astype(np.float32)
    dt_raw = (0.5 * rng.normal(size=(b, s, d))).astype(np.float32)
    dt_raw[..., ::7] = 25.0  # above softplus's threshold
    dt0 = np.exp(rng.uniform(size=d) * (math.log(0.1) - math.log(1e-3))
                 + math.log(1e-3))
    bias = (dt0 + np.log(-np.expm1(-dt0))).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    a = (-np.exp(0.2 * rng.normal(size=(d, n)))).astype(np.float32)
    dskip = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    z = rng.normal(size=(b, s, d)).astype(np.float32)
    return u, dt_raw, bias, bm, cm, a, dskip, z


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_plain_matches_the_reference_tail(dtype):
    """``mamba_scan_gated_torch`` against the tail of the reference's
    ``ssm_apply`` (``repro/models/ssm.py:114-120``) on the same inputs:
    softplus, its chunked scan, the D skip, the gate and the cast to z's
    dtype. f32 to 1e-5 (the same f32 math in another order, as
    ``tests/test_torch_ssm.py``); bf16 to one bf16 ulp (2^-7 of the
    value), since two f32 values 1e-6 apart may round to neighbouring
    bf16 values."""
    u, dt_raw, bias, bm, cm, a, dskip, z = _gated_inputs(2, 64, 24, 8)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jz = jnp.asarray(z).astype(jdtype)
    dt = jax.nn.softplus(jnp.asarray(dt_raw) + jnp.asarray(bias))
    jy, jh = jssm.ssm_scan(jnp.asarray(u), dt, jnp.asarray(bm),
                           jnp.asarray(cm), jnp.asarray(a), chunk=32)
    jy = jy + jnp.asarray(dskip) * jnp.asarray(u)
    jy = (jy * jax.nn.silu(jz.astype(jnp.float32))).astype(jdtype)
    tz = torch.from_numpy(z).to(dtype)
    out, h = ref.mamba_scan_gated_torch(
        *map(torch.from_numpy, (u, dt_raw, bias, bm, cm, a, dskip)), tz)
    assert out.dtype == dtype and h.dtype == torch.float32
    want = np.asarray(jy.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(out.float().numpy(), want, atol=0,
                                   rtol=2.0 ** -7)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)


def test_ops_gated_runs_the_plain_version_on_cpu():
    """A CPU tensor takes the plain version bit for bit, z a strided view,
    and launches nothing."""
    u, dt_raw, bias, bm, cm, a, dskip, z = _gated_inputs(2, 30, 16, 4, seed=3)
    args = list(map(torch.from_numpy, (u, dt_raw, bias, bm, cm, a, dskip)))
    uz = torch.cat([torch.from_numpy(u), torch.from_numpy(z)], -1).to(
        torch.bfloat16)
    zv = uz[..., 16:]
    build.reset_launch_counts()
    out, h = ops.mamba_scan_gated(*args, zv)
    want, wh = ref.mamba_scan_gated_torch(*args, zv)
    assert torch.equal(out, want) and torch.equal(h, wh)
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    assert build.LAUNCHES["mamba_scan"] == 0


@pytest.mark.parametrize("fault,error,match", [
    ("dtype", TypeError, "float32"),
    ("z_dtype", TypeError, "bfloat16 or torch.float32"),
    ("z_stride", ValueError, "unit last stride"),
    ("shape", ValueError, "shape"),
    ("n_over_32", ValueError, "N <= 32"),
    ("cpu", ValueError, "CUDA tensors"),
])
def test_gated_wrapper_refuses_what_the_kernel_does_not_take(fault, error,
                                                              match):
    """The layout checks come before the device check, so they hold for
    CPU tensors too; well-formed CPU tensors are refused for their
    device."""
    b, s, d, n = 1, 16, 40, 4
    u, dt_raw, bias, bm, cm, a, dskip, _ = map(
        torch.from_numpy, _gated_inputs(b, s, d, n))
    z = torch.zeros(b, s, 2 * d, dtype=torch.bfloat16)[..., d:]
    if fault == "dtype":
        u = u.double()
    elif fault == "z_dtype":
        z = z.half()
    elif fault == "z_stride":
        z = torch.zeros(b, d, s, dtype=torch.bfloat16).transpose(1, 2)
    elif fault == "shape":
        bm = bm[:, :8]
    elif fault == "n_over_32":
        bm = cm = torch.zeros(b, s, 33)
        a = torch.zeros(d, 33)
    with pytest.raises(error, match=match):
        msm.mamba_scan_gated_cuda(u, dt_raw, bias, bm, cm, a, dskip, z)
