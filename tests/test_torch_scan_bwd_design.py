"""B6b's chunk-parallel design (``kernels/csrc/mamba_scan_bwd.cu``) written
out in torch, on the CPU, against B6b's plain version and the JAX
reference's gradient.

The CUDA kernel runs only on a card. Here its decomposition is spelled out
as the kernel takes it, at the plan the source states (channels a block,
steps a segment, blocks a cluster): chunks of 128 steps walked in reverse
from B6's saved chunk states; the softplus and the SiLU once per (t, c);
per state, exp(dt * A) once per (t, c, n) as exp2 of dt * (A * log2 e);
each segment's (decay, value) pairs for h (forward from 0) and for the
adjoint g (backward from 0), the decay one exponential of the summed dt;
Hillis-Steele scans over the segments, h lowest first and g highest first;
the exclusive scans applied to the chunk's saved state and to the adjoint
carried from the later chunk (dh_last at the end); the segment walked
forward for h and back for g with every per-step term; the sums over
states in a thread's registers in state order; dA over a segment's steps
and then over the segments by the butterfly's pairwise tree; the sums over
channels in the kernel's order (the warp's reduce-scatter, the warps in
order, the cluster's blocks in rank order) into one partial per cluster,
which the wrapper adds with torch.sum.

It is held against ``ref.mamba_scan_gated_bwd_torch`` and ``jax.vjp`` of
the reference's chunked scan plus its ``ssm_apply`` tail
(``repro/models/ssm.py:59-120``, as ``tests/test_torch_scan_backward.py``
takes it) at 1e-4 of each gradient's largest |entry|: the design reorders
f32 sums (segments, scans, folds) and uses the kernels' short forms of the
exponential, softplus and sigmoid, so it matches to rounding, not to the
bit; dz in bf16 within one bf16 ulp (2^-8), where two f32 values may round
apart. The plans that ``tools/b6b_ablation.py`` compiles and times are
held here too, as is that tool's patching of the source.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import ref
from repro_torch.kernels import mamba_scan as msm

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "b6b_ablation", Path(__file__).resolve().parents[1] / "tools"
    / "b6b_ablation.py")
abl = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(abl)

SOURCE = abl.SOURCE.read_text()
PLAN = abl.source_plan(SOURCE)
CHUNK = msm.STATE_CHUNK
LOG2E = 1.4426950408889634
TOL = 1e-4
BF16_ULP = 2.0 ** -8
NAMES = ("du", "ddt_raw", "ddt_bias", "dB", "dC", "dA", "dD", "dz")


def _softplus(x):
    """The kernels' softplus (``softplus()`` in both sources)."""
    e = torch.exp2(-x.abs() * LOG2E)
    r = e / (2 + e)
    r2 = r * r
    q = torch.full_like(x, 1 / 15)
    for k in (13, 11, 9, 7, 5, 3, 1):
        q = q * r2 + 1 / k
    return torch.where(x > 20, x, torch.clamp(x, min=0) + 2 * r * q)


def _sigmoid(x):
    return 1 / (1 + torch.exp2(-x * LOG2E))


def _tree(parts):
    """A butterfly's sum as its lane 0 forms it: the halves' sums added."""
    if len(parts) == 1:
        return parts[0]
    half = len(parts) // 2
    return _tree(parts[:half]) + _tree(parts[half:])


def _warp_fold(parts):
    """The warp's reduce-scatter over its channel lanes: each lane adds
    its partner across the top channel bit, then the next bit."""
    if len(parts) == 1:
        return parts[0]
    half = len(parts) // 2
    return _warp_fold([parts[a] + parts[a + half] for a in range(half)])


def design_bwd(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z, dout, states,
               dh_last, plan, bf16=False):
    """The kernel's decomposition of B6b at ``plan`` (channels a block,
    steps a segment, blocks a cluster, states at once: the sums over
    states run in state order however many a thread walks at once, so the
    last does not change the arithmetic). Inputs as the op takes them,
    ``states`` B6's chunk states (B, ceil(S / 128), d, N). Returns (du,
    d dt_raw, d dt_bias, dB, dC, dA, dD, dz), dz in z's dtype. ``bf16``:
    the states recomputed at the bf16 state's rounding points (the
    source's header note): exp(dt * A) and dt * u * B rounded where
    formed, a segment's decay the product of its rounded exponentials, the
    state entering a segment and after each step of its walk rounded."""
    rnd = ref.bf16_round if bf16 else (lambda x: x)
    channels, seg_len, cluster, _ = plan
    segs = CHUNK // seg_len
    wch = 32 // segs  # channels a warp
    b, s, d = u.shape
    n = A.shape[-1]
    nchunks = -(-s // CHUNK)
    per = channels * cluster  # channels of one partial
    ncl = -(-d // per)
    dp, sp = ncl * per, nchunks * CHUNK
    # tiles padded as the kernel loads them: zeros past S and d
    def pad(x, width):
        out = torch.zeros(b, sp, width)
        out[:, :s, :x.shape[-1]] = x.float()
        return out

    uu, xr, zz, do = (pad(t, dp) for t in (u, dt_raw, z, dout))
    bb, cc = pad(B_mat, n), pad(C_mat, n)
    live = torch.zeros(b, sp, dp, dtype=torch.bool)
    live[:, :s, :d] = True
    bias = torch.zeros(dp)
    bias[:d] = dt_bias
    dsk = torch.zeros(dp)
    dsk[:d] = D
    a = torch.zeros(dp, n)
    a[:d] = A
    a2 = a * LOG2E
    x = xr + bias
    # once per (t, c): dt (0 on identity steps), softplus's derivative,
    # dy = dout * silu(z), dt * u
    dt = torch.where(live, _softplus(x), torch.zeros(()))
    # softplus's derivative from its exponential e = exp(-|x|)
    e = torch.exp2(-x.abs() * LOG2E)
    sgx = torch.where(x > 20, torch.ones(()),
                      torch.where(x >= 0, torch.ones(()), e) / (1 + e))
    dy = torch.where(live, do * (zz * _sigmoid(zz)), torch.zeros(()))
    duv = dt * uu
    h0s = torch.zeros(b, nchunks, dp, n)
    h0s[:, :, :d] = states
    gin = torch.zeros(b, dp, n)
    if dh_last is not None:
        gin[:, :d] = dh_last

    def seg_view(t):  # (b, sp, ...) -> chunks x (b, segs, seg_len, ...)
        return t.reshape(b, nchunks, segs, seg_len, *t.shape[2:])

    dtv, duvv, dyv, bv, cv = map(seg_view, (dt, duv, dy, bb, cc))
    s1, s2, s3 = (torch.zeros(b, nchunks, segs, seg_len, dp)
                  for _ in range(3))
    dA_acc = torch.zeros(b, dp, n)
    dBp = torch.zeros(b, ncl, sp, n)
    dCp = torch.zeros(b, ncl, sp, n)
    for k in range(nchunks - 1, -1, -1):  # chunks in reverse
        dvk, duk, dyk, bk, ck = (t[:, k] for t in (dtv, duvv, dyv, bv, cv))
        sdv = torch.zeros(b, segs, dp)
        for i in range(seg_len):
            sdv = sdv + dvk[:, :, i]
        for m in range(n):  # the state loop
            am = a2[:, m]
            ea = rnd(torch.exp2(dvk * am))  # (b, segs, seg_len, dp)
            eb = rnd(duk * bk[..., m, None])
            cdy = ck[..., m, None] * dyk
            ac = ea.prod(2) if bf16 else torch.exp2(sdv * am)
            hb = torch.zeros(b, segs, dp)
            for i in range(seg_len):
                hb = ea[:, :, i] * hb + eb[:, :, i]
            gb = torch.zeros(b, segs, dp)
            for i in range(seg_len - 1, -1, -1):
                gb = ea[:, :, i] * (cdy[:, :, i] + gb)
            ah, ag = ac, ac
            off = 1
            while off < segs:  # Hillis-Steele, both ways
                nah, nhb, nag, ngb = ah.clone(), hb.clone(), ag.clone(), gb.clone()
                nhb[:, off:] = ah[:, off:] * hb[:, :-off] + hb[:, off:]
                nah[:, off:] = ah[:, off:] * ah[:, :-off]
                ngb[:, :-off] = ag[:, :-off] * gb[:, off:] + gb[:, :-off]
                nag[:, :-off] = ag[:, :-off] * ag[:, off:]
                ah, hb, ag, gb = nah, nhb, nag, ngb
                off *= 2
            h0, g_in = h0s[:, k, :, m][:, None], gin[..., m]
            hin = torch.empty(b, segs, dp)
            hin[:, 0] = h0[:, 0]
            hin[:, 1:] = rnd(ah[:, :-1] * h0 + hb[:, :-1])
            xg = torch.empty(b, segs, dp)
            xg[:, -1] = g_in
            xg[:, :-1] = ag[:, 1:] * g_in[:, None] + gb[:, 1:]
            gin[..., m] = ag[:, 0] * g_in + gb[:, 0]  # the adjoint leaving
            hv = []
            h = hin
            for i in range(seg_len):
                h = rnd(ea[:, :, i] * h + eb[:, :, i])
                hv.append(h)
                s3[:, k, :, i] = s3[:, k, :, i] + h * ck[:, :, i, m, None]
            dA = torch.zeros(b, segs, dp)
            pb = torch.empty(b, segs, seg_len, dp)
            pc = torch.empty(b, segs, seg_len, dp)
            xs = xg
            for i in range(seg_len - 1, -1, -1):
                g = cdy[:, :, i] + xs
                q = g * (ea[:, :, i] * (hv[i - 1] if i else hin))
                s1[:, k, :, i] = s1[:, k, :, i] + g * bk[:, :, i, m, None]
                s2[:, k, :, i] = s2[:, k, :, i] + q * a[:, m]
                dA = dA + q * dvk[:, :, i]
                pb[:, :, i] = g * duk[:, :, i]
                pc[:, :, i] = dyk[:, :, i] * hv[i]
                xs = ea[:, :, i] * g
            dA_acc[..., m] = dA_acc[..., m] + _tree(list(dA.unbind(1)))
            # over channels: the warp's lanes, its block's warps in order,
            # the cluster's blocks in rank order
            for acc, val in ((dBp, pb), (dCp, pc)):
                v = val.reshape(b, segs * seg_len, ncl, cluster,
                                channels // wch, wch)
                v = _warp_fold(list(v.unbind(-1)))
                wsum = torch.zeros(b, segs * seg_len, ncl, cluster)
                for w in range(channels // wch):
                    wsum = wsum + v[..., w]
                csum = torch.zeros(b, segs * seg_len, ncl)
                for r in range(cluster):
                    csum = csum + wsum[..., r]
                acc[:, :, k * CHUNK:(k + 1) * CHUNK, m] = csum.transpose(1, 2)
    # the end of each chunk: du, d dt_raw, dz; dD and d dt_bias summed over
    # a thread's steps, chunks in reverse, then over its segments
    s1, s2, s3 = (t.reshape(b, sp, dp) for t in (s1, s2, s3))
    du = dt * s1 + dsk * dy
    dx = (uu * s1 + s2) * sgx
    sg = _sigmoid(zz)
    dz = do * (dsk * uu + s3) * (sg * (1 + zz * (1 - sg)))
    dx = torch.where(live, dx, torch.zeros(()))

    def thread_sum(v):
        v = v.reshape(b, nchunks, segs, seg_len, dp)
        acc = torch.zeros(b, segs, dp)
        for k in range(nchunks - 1, -1, -1):
            for i in range(seg_len):
                acc = acc + v[:, k, :, i]
        return _tree(list(acc.unbind(1)))

    dD, dbias = thread_sum(dy * uu), thread_sum(dx)
    return (du[:, :s, :d], dx[:, :s, :d], dbias[:, :d].sum(0),
            dBp[:, :, :s].sum(1), dCp[:, :, :s].sum(1), dA_acc[:, :d].sum(0),
            dD[:, :d].sum(0), dz[:, :s, :d].to(z.dtype))


def _inputs(b, s, d, n, *, seed):
    """u normal; dt_raw 0.5 * normal with every 5th channel at 30 (above
    softplus's threshold with any dt_bias here); dt_bias the inverse
    softplus of a dt in [1e-3, 0.1]; B, C normal; A = -exp(0.2 * normal);
    D near 1; z, dout, dh_last normal; numpy f32."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    dt_raw = 0.5 * normal(b, s, d)
    dt_raw[..., ::5] = 30.0
    dt0 = np.exp(rng.uniform(math.log(1e-3), math.log(0.1), size=d))
    bias = (dt0 + np.log(-np.expm1(-dt0))).astype(np.float32)
    a = (-np.exp(0.2 * normal(d, n))).astype(np.float32)
    args = [normal(b, s, d), dt_raw, bias, normal(b, s, n), normal(b, s, n),
            a, (1 + 0.1 * normal(d)).astype(np.float32), normal(b, s, d)]
    return args, normal(b, s, d), normal(b, d, n)


def _jax_vjp(args, dout, dh_last, chunk, zdtype):
    """The reference's chunked scan and its ssm_apply tail, differentiated
    with ``jax.vjp`` at the cotangents (dout, dh_last)."""
    jdt = jnp.bfloat16 if zdtype == torch.bfloat16 else jnp.float32

    def tail(u, dt_raw, dt_bias, bm, cm, a, dskip, z):
        dt = jax.nn.softplus(dt_raw + dt_bias)
        y, h_last = jssm.ssm_scan(u, dt, bm, cm, a, chunk=chunk)
        y = (y + dskip * u) * jax.nn.silu(z.astype(jnp.float32))
        return y.astype(z.dtype), h_last

    jargs = [jnp.asarray(x) for x in args]
    jargs[-1] = jargs[-1].astype(jdt)
    _, vjp = jax.vjp(tail, *jargs)
    dh = (jnp.zeros(args[3].shape[:1] + args[5].shape, jnp.float32)
          if dh_last is None else jnp.asarray(dh_last))
    grads = vjp((jnp.asarray(dout).astype(jdt), dh))
    return [torch.from_numpy(np.array(g.astype(jnp.float32))) for g in grads]


def _run(shape, zdtype, seeded, plan, seed, bf16=False):
    args, dout, dh = _inputs(*shape, seed=seed)
    t = [torch.from_numpy(x) for x in args]
    t[-1] = t[-1].to(zdtype)
    tdout = torch.from_numpy(dout).to(zdtype)
    tdh = torch.from_numpy(dh) if seeded else None
    _, _, states = ref.mamba_scan_gated_torch(*t, chunk=CHUNK,
                                              bf16_state=bf16)
    got = design_bwd(*t, tdout, states, tdh, plan, bf16=bf16)
    want = ref.mamba_scan_gated_bwd_torch(*t, tdout, tdh, bf16_state=bf16)
    return got, want, (args, dout, dh if seeded else None)


def _close(got, want, zdtype, names=NAMES, tol=TOL):
    for name, g, w in zip(names, got, want):
        bar = (max(tol, BF16_ULP) if name == "dz" and zdtype == torch.bfloat16
               else tol)
        g, w = g.float(), w.float()
        assert g.shape == w.shape, name
        err = float((g - w).abs().max())
        assert err <= bar * float(w.abs().max()) + 1e-30, (name, err)


# (B, S, d, N), z dtype, dh_last seeded, the reference's chunk (a divisor
# of S): ragged S over three chunks and inside one, N = 1, 4, 16 and 32, d
# off the block's channels and over two clusters
CASES = [
    ((2, 300, 40, 16), torch.float32, True, 100),
    ((2, 300, 40, 16), torch.bfloat16, False, 100),
    ((1, 37, 20, 4), torch.float32, False, 37),
    ((2, 37, 9, 1), torch.bfloat16, True, 37),
    ((1, 300, 24, 32), torch.float32, True, 150),
    ((1, 130, 136, 4), torch.bfloat16, True, 65),
]


@pytest.mark.parametrize("shape,zdtype,seeded,chunk", CASES)
def test_design_matches_plain_version_and_reference(shape, zdtype, seeded,
                                                    chunk):
    """The source's plan's decomposition against B6b's plain version and
    the JAX reference's gradient, every gradient within 1e-4 of its largest
    |entry| (dz in bf16 within one bf16 ulp)."""
    got, want, (args, dout, dh) = _run(shape, zdtype, seeded, PLAN,
                                       seed=sum(shape))
    _close(got, want, zdtype)
    jgot = _jax_vjp(args, dout, dh, chunk, zdtype)
    # the reference's gradients in its argument order: u, dt_raw, dt_bias,
    # B, C, A, D, z
    _close(got, jgot, zdtype)


#: the bf16 state's bar, of each gradient's largest |entry|: B6b's 8-step
#: segments round the recomputed states at other points than the plain
#: version's (B6's 16-step segments); measured at most 2.7e-3 (dA)
BF16_TOL = 5e-3


@pytest.mark.parametrize("shape,zdtype,seeded", [
    ((2, 300, 40, 16), torch.float32, True),
    ((2, 300, 40, 16), torch.bfloat16, False),
    ((1, 37, 20, 4), torch.float32, False),
    ((1, 130, 136, 4), torch.bfloat16, True)])
def test_bf16_design_matches_the_plain_bf16_backward(shape, zdtype, seeded):
    """The source's plan with the bf16 state's rounding points, from B6's
    bf16 chunk states, against B6b's plain version with ``bf16_state``,
    at BF16_TOL; and the f32 state's gradients differ from them."""
    got, want, (args, dout, dh) = _run(shape, zdtype, seeded, PLAN,
                                       seed=sum(shape), bf16=True)
    _close(got, want, zdtype, tol=BF16_TOL)
    t = [torch.from_numpy(x) for x in args]
    t[-1] = t[-1].to(zdtype)
    f32 = ref.mamba_scan_gated_bwd_torch(
        *t, torch.from_numpy(dout).to(zdtype),
        None if dh is None else torch.from_numpy(dh))
    assert not torch.allclose(f32[5], want[5], atol=0, rtol=1e-4)  # dA


@pytest.mark.parametrize("plan", abl.SWEEP)
def test_every_plan_matches_the_plain_version(plan):
    """Every plan of the ablation tool's sweep at a ragged S over three
    chunks, d over two clusters of the plan."""
    channels, seg_len, cluster, states = plan
    assert CHUNK // seg_len == 16 and channels % 4 == 0  # the rules
    assert cluster <= 8 and states in (1, 2)
    got, want, _ = _run((2, 300, channels * cluster + 12, 8), torch.float32,
                        True, plan, seed=7)
    _close(got, want, torch.float32)


def test_source_plan_folds_four_times_fewer_partials():
    """One partial of dB and dC covers a cluster's channels: at least 4x
    fewer than one per 32 channels, the same at every N."""
    channels, seg_len, cluster, _ = PLAN
    assert channels * cluster >= 4 * 32 and CHUNK % seg_len == 0
    assert "constexpr int kPartial = kChannels * kCluster;" in SOURCE
    assert "using Narrow = Plan<16, kPartial / 16, 1>;" in SOURCE
    assert "  return kPartial;\n" in SOURCE


def test_sweep_copies_state_their_plans():
    """The source's plan is one of the sweep's, and the tool makes one
    copy of the source for each other plan, stating that plan."""
    assert PLAN in abl.SWEEP
    copies = abl.variants(SOURCE)
    plans = {name: abl.source_plan(text) for name, text in copies.items()
             if name.startswith("plan_")}
    assert sorted(plans.values()) == sorted(p for p in abl.SWEEP
                                            if p != PLAN)
    assert copies["full"] == SOURCE


@pytest.mark.parametrize("cut", sorted(abl.CUTS))
def test_ablation_cuts_apply_to_the_source(cut):
    """Each cut of ``tools/b6b_ablation.py`` finds its text exactly once in
    the source, so an edit of those lines fails here and not on the
    card."""
    text = abl.patched(SOURCE, cut, abl.CUTS[cut])
    assert text != SOURCE
    assert abl.source_plan(text) == PLAN


def test_phase_probes_apply_to_the_source():
    """The ablation tool's ``probes`` copy finds each probe's text exactly
    once in the source, one probe a phase boundary and one a group of
    states, with a reader of their buffer."""
    text = abl.variants(SOURCE)["probes"]
    assert text.count("= clock64();") == len(abl.PHASES) + 1
    assert "b6b_probes_read" in text
    assert abl.source_plan(text) == PLAN


def test_one_exponential_per_item_and_no_state_lanes():
    """The state loop evaluates exp(dt * A) once per (t, c, n): one ex2 of
    dt * a2 in the source, beside the segment's decay; no per-state lane
    layout and a cp.async ring."""
    assert SOURCE.count("ex2(dv[i + j] * a2[v])") == 1
    assert SOURCE.count("ex2(sdv * a2[v])") == 1
    assert "tid / NP" not in SOURCE and "tid % NP" not in SOURCE
    assert "cp.async.cg.shared.global" in SOURCE and "cp_wait<1>()" in SOURCE
