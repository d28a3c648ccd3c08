"""The arithmetic of B4b, the training attention's backward, on the CPU.

B4b (``csrc/flash_attention_bwd.cu``) runs only on a card
(``tests/test_torch_cuda_attention_bwd.py``, ``chip_smoke.py``). These
tests write out in torch the two passes its design rests on, at the tile
plan the source states (``kBQ`` query rows and ``kBK`` keys a tile, read
from the source), and hold them, on inputs made with numpy from a seed,
against ``jax.vjp`` of the reference's ``repro.models.attention.
flash_attention`` and against the port's plain version
(``ref.flash_attention_bwd_torch``, the pair-scan):

* the dq pass: per (q tile, head) it writes ``delta = rowsum(dO * O)``,
  walks the live K/V tiles (B4's range), masks only the tiles that cut
  the diagonal, the window or the end of Sq or Sk, and sums ``ds k``;
* the dk/dv pass: per (key tile, KV head) it walks the G query heads and,
  for each, the q tiles holding an allowed pair, then those of rows with no
  allowed column (whose p is 1 at every key), in that fixed order, reading
  delta;
* in the bf16 plan P and dS enter their products as two bf16 terms, hi +
  lo.

f32 results are held within 1e-5 of each gradient's largest |entry| (f32
sums in another order); the hi + lo split on bf16-valued inputs within
1e-4 of the f32 design's: each term keeps P or dS to ~2^-16 of itself.
The op ``repro_torch::flash_attention_bwd`` is checked for its fake
implementation and its FLOP formula, and ``FlashAttention`` on the CPU for
the reference's VJP. These run no kernel code.
"""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.models import attention as jattn
from repro_torch.kernels import counts, ops, ref
from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_op)

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "kernels" / "csrc" / "flash_attention_bwd.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


BQ, BK = _constant("kBQ"), _constant("kBK")
# the wgmma plan: consumer warpgroups of WG_ROWS rows, BLOCK rows a block
WG_ROWS, CONSUMERS = _constant("kWgRows"), _constant("kConsumers")
BLOCK = WG_ROWS * CONSUMERS
# launch_bf16's choice: hd -> the wgmma plan or the mma.sync plan
WG_HDS = {int(n) for n in re.findall(r"B4B_WG\((\d+)\)", SOURCE)}
TC_HDS = {int(n) for n in re.findall(r"B4B_TC\((\d+)\)", SOURCE)}
PLANS = ("tiles64", "wgmma")  # f32 and mma.sync; bf16 at WG_HDS
NEG_INF = -1e30
F32_TOL = 1e-5    # of each gradient's largest |entry|
SPLIT_TOL = 1e-4  # the hi + lo split against the f32 design


# -- the design, written out -------------------------------------------------


def _allowed(rows, cols, sq, sk, causal, window):
    ok = (cols[None, :] < sk) & (rows[:, None] < sq)
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None])
    if window is not None:
        ok = ok & (cols[None, :] > rows[:, None] - window)
    return ok


def _cuts(q0, k0, sq, sk, causal, window):
    """The kernel's ``cuts``: the tile pair holds a refused pair."""
    return (k0 + BK > sk or q0 + BQ > sq or (causal and k0 + BK - 1 > q0)
            or (window is not None and k0 <= q0 + BQ - 1 - window))


def kv_tiles(q0, sq, sk, causal, window, rows=BQ):
    """The dq pass's live K/V tiles of the ``rows``-row q tile at q0 (B4's
    range)."""
    last = min(q0 + rows - 1, sq - 1)
    hi = (min(last, sk - 1) if causal else sk - 1) // BK
    lo = (q0 - window + 1) // BK if window and q0 - window + 1 > 0 else 0
    return list(range(lo, hi + 1))


def q_tiles(k0, sq, sk, causal, window, keys=BK):
    """The dk/dv pass's q tiles of the ``keys``-key tile at k0 (the
    kernel's ``q_tiles<keys>``): those holding an allowed pair, then those
    of rows with no allowed column."""
    nq = -(-sq // BQ)
    cmax = min(k0 + keys - 1, sk - 1)
    qlo = k0 // BQ if causal else 0
    qhi = nq - 1
    if window is not None:
        qhi = min(qhi, (cmax + window - 1) // BQ)
    n1 = max(0, qhi - qlo + 1)
    e_lo = nq
    if window is not None and sk + window - 1 < sq:
        e_lo = (sk + window - 1) // BQ
    r2 = max(e_lo, qhi + 1 if n1 else 0)
    return list(range(qlo, qlo + n1)) + list(range(r2, nq))


def _span(start, n, end):
    """start .. min(start + n, end) - 1, empty past end."""
    return torch.arange(start, max(start, min(start + n, end)))


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _times(a, b, split):
    """a @ b, with a carried as hi + lo bf16 terms in the split plan."""
    if not split:
        return a @ b
    hi, lo = _split(a)
    return hi @ b + lo @ b


def _scores(x, y, scale, softcap):
    s = (x @ y.T) * scale
    if softcap > 0:
        th = torch.tanh(s / softcap)
        return softcap * th, th
    return s, None


def _grads(p, dp, delta, th, ok):
    ds = p * (dp - delta)
    if th is not None:
        ds = ds * (1.0 - th * th)
    return ds if ok is None else torch.where(ok, ds, 0.0)


def _dq_tile(q, k, v, dout, lse, dl, bi, hh, g, q0, j, acc, scale, causal,
             window, softcap, split):
    """dq += ds k over the 64 x 64 pair (q0, key tile j), masked where
    the pair cuts an edge; acc and dl hold the rows q0 .. q0 + 63 below
    Sq."""
    sq, sk = q.shape[1], k.shape[1]
    rows = _span(q0, BQ, sq)
    cols = _span(j * BK, BK, sk)
    if not len(rows) or not len(cols):
        return acc
    qi, doi = q[bi, rows, hh], dout[bi, rows, hh]
    kj, vj = k[bi, cols, hh // g], v[bi, cols, hh // g]
    s, th = _scores(qi, kj, scale, softcap)
    ok = (_allowed(rows, cols, sq, sk, causal, window)
          if _cuts(q0, j * BK, sq, sk, causal, window) else None)
    if ok is not None:
        s = torch.where(ok, s, NEG_INF)
    p = torch.exp(s - lse[bi, hh, rows][:, None])
    ds = _grads(p, doi @ vj.T, dl[:, None], th, ok)
    return acc + _times(ds, kj, split)


def _dkdv_tile(q, k, v, dout, lse, delta, bi, kh, hh, q0, k0, dka, dva,
               scale, causal, window, softcap, split):
    """dv += p^T dout and dk += ds^T q over the 64 x 64 pair (q tile q0,
    keys k0 .. k0 + 63); dka and dva hold the keys below Sk."""
    sq, sk = q.shape[1], k.shape[1]
    rows = _span(q0, BQ, sq)
    cols = _span(k0, BK, sk)
    if not len(rows) or not len(cols):
        return dka, dva
    qi, doi = q[bi, rows, hh], dout[bi, rows, hh]
    kj, vj = k[bi, cols, kh], v[bi, cols, kh]
    st, th = _scores(kj, qi, scale, softcap)
    ok = (_allowed(rows, cols, sq, sk, causal, window).T
          if _cuts(q0, k0, sq, sk, causal, window) else None)
    if ok is not None:
        st = torch.where(ok, st, NEG_INF)
    p = torch.exp(st - lse[bi, hh, rows][None, :])  # P^T: keys x queries
    ds = _grads(p, vj @ doi.T, delta[bi, hh, rows][None, :], th, ok)
    return dka + _times(ds, qi, split), dva + _times(p, doi, split)


def design_bwd(q, k, v, out, lse, dout, *, causal=True, window=None,
               softcap=0.0, split=False, visits=None, plan="tiles64"):
    """B4b's two passes on f32 tensors (the kernel's layouts) -> (dq, dk,
    dv) f32, at one of the source's tile plans: ``tiles64`` (the f32 and
    the mma.sync plans: 64-row q tiles, 64-key tiles) or ``wgmma`` (blocks
    of BLOCK rows, each consumer warpgroup WG_ROWS of them: the dq pass's
    groups both walk the block's key tiles, the dk/dv pass's the q tiles
    ``q_tiles`` lists for the block's BLOCK keys; a pair whose rows and
    keys are all refused adds nothing). ``visits``, a dict, collects the
    tile pairs each pass walks, in order."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    block = BLOCK if plan == "wgmma" else BQ
    share = WG_ROWS if plan == "wgmma" else BQ
    dq = torch.zeros(q.shape)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    delta = (out * dout).sum(-1).transpose(1, 2).contiguous()
    if visits is not None:
        visits.update(dq=[], dkdv=[])
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
              split=split)
    for bi in range(b):  # the dq pass: (q block, head, batch row)
        for hh in range(h):
            for qb in range(-(-sq // block)):
                tiles = kv_tiles(qb * block, sq, sk, causal, window, block)
                if visits is not None and bi == hh == 0:
                    visits["dq"] += [(qb, j) for j in tiles]
                for q0 in range(qb * block, qb * block + block, share):
                    rows = _span(q0, share, sq)
                    acc = torch.zeros(len(rows), hd)
                    for j in tiles:
                        acc = _dq_tile(q, k, v, dout, lse, delta[bi, hh, rows],
                                       bi, hh, g, q0, j, acc, **kw)
                    dq[bi, rows, hh] = acc * scale
    for bi in range(b):  # the dk/dv pass: (key block, KV head, batch row)
        for kh in range(kv):
            for kb in range(-(-sk // block)):
                k0 = kb * block
                tiles = q_tiles(k0, sq, sk, causal, window, block)
                if visits is not None and bi == kh == 0:
                    visits["dkdv"] += [(kb, hh, qt) for hh in range(g)
                                       for qt in tiles]
                for kw0 in range(k0, k0 + block, share):
                    cols = _span(kw0, share, sk)
                    dka = torch.zeros(len(cols), hd)
                    dva = torch.zeros(len(cols), hd)
                    for hh in range(kh * g, kh * g + g):
                        for qt in tiles:
                            dka, dva = _dkdv_tile(
                                q, k, v, dout, lse, delta, bi, kh, hh,
                                qt * BQ, kw0, dka, dva, **kw)
                    dk[bi, cols, kh] = dka * scale
                    dv[bi, cols, kh] = dva
    return dq, dk, dv


# -- inputs and the reference ------------------------------------------------


def _inputs(b, sq, sk, h, kv, hd, seed, bf16_valued=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, n, m, hd)).astype(np.float32)
            for n, m in ((sq, h), (sk, kv), (sk, kv), (sq, h))]
    if bf16_valued:
        arrs = [torch.tensor(a).bfloat16().float().numpy() for a in arrs]
    return arrs


def _forward(q, k, v, causal, window, softcap):
    """The plain forward's out and lse, the residuals B4 writes."""
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    out = ref.flash_attention_torch(tq, tk, tv, causal=causal, window=window,
                                    softcap=softcap)
    lse = ref.flash_attention_lse_torch(tq, tk, causal=causal, window=window,
                                        softcap=softcap)
    return out, lse


def _reference_vjp(q, k, v, dout, chunk, causal, window, softcap):
    def fn(q, k, v):
        return jattn.flash_attention(q, k, v, chunk=chunk, causal=causal,
                                     window=window, logit_softcap=softcap)
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _assert_close(got, want, tol, what):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = np.asarray(a, np.float64), np.asarray(w, np.float64)
        assert a.shape == w.shape, (what, name)
        bar = tol * max(np.abs(w).max(), 1e-30)
        err = np.abs(a - w).max()
        assert err <= bar, f"{what} {name}: {err} > {bar}"


# (B, Sq, Sk, H, KV, hd, causal, window, softcap, chunk): causal; windowed
# with the window shorter than S; non-causal; Sq != Sk both ways; ragged
# lengths; G = 1, 4, 5; hd 64 and 128 (the wgmma plan's in bf16) and 32,
# 80 (the mma.sync plan's); the cap on; one row with no allowed column (Sq
# = Sk + window: row Sk + window - 1 sees no key; the reference's chunk
# holds all of Sq); whisper's cross attention's ragged keys cut short
CASES = {
    "causal_g4_hd64": (2, 130, 130, 4, 1, 64, True, None, 0.0, 64),
    "window_g5_hd64": (1, 200, 200, 5, 1, 64, True, 70, 0.0, 32),
    "noncausal_g1_hd128": (2, 75, 75, 2, 2, 128, False, None, 0.0, 32),
    "cross_sq_lt_sk": (1, 40, 150, 4, 1, 64, False, None, 0.0, 512),
    "causal_sq_gt_sk": (1, 150, 70, 2, 2, 64, True, None, 0.0, 512),
    "ragged_window_cap_hd128": (1, 97, 97, 4, 1, 128, True, 33, 30.0, 16),
    "causal_cap_g5": (1, 129, 129, 5, 1, 64, True, None, 5.0, 64),
    "empty_row": (1, 64, 50, 2, 1, 64, True, 14, 0.0, 512),
    "empty_rows_noncausal": (1, 140, 50, 4, 1, 64, False, 20, 0.0, 512),
    "causal_g2_hd32": (1, 150, 150, 4, 2, 32, True, None, 0.0, 64),
    "window_cap_hd80": (1, 140, 140, 5, 1, 80, True, 50, 20.0, 32),
    "cross_ragged_keys_hd128": (1, 70, 150, 2, 2, 128, False, None, 0.0,
                                512),
}


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_design_matches_reference_and_pair_scan(name, plan):
    b, sq, sk, h, kv, hd, causal, window, cap, chunk = CASES[name]
    q, k, v, dout = _inputs(b, sq, sk, h, kv, hd, seed=len(name))
    out, lse = _forward(q, k, v, causal, window, cap)
    got = design_bwd(*(torch.tensor(x) for x in (q, k, v)), out, lse,
                     torch.tensor(dout), causal=causal, window=window,
                     softcap=cap, plan=plan)
    want = _reference_vjp(q, k, v, dout, chunk, causal, window, cap)
    _assert_close([g.numpy() for g in got], want, F32_TOL,
                  f"{name} ({plan}) vs jax.vjp")
    plain = ref.flash_attention_bwd_torch(
        *(torch.tensor(x) for x in (q, k, v)), out, lse, torch.tensor(dout),
        chunk=chunk, causal=causal, window=window, softcap=cap)
    _assert_close([g.numpy() for g in got], [p.numpy() for p in plain],
                  F32_TOL, f"{name} ({plan}) vs the pair-scan")


@pytest.mark.parametrize("plan", PLANS)
def test_an_empty_row_adds_its_dout_to_every_key(plan):
    """The row with no allowed column has lse -1e30 and p = 1 at every
    key: it adds exactly its dout to dv (the difference with its dout
    zeroed) and nothing to dq or dk, in the design at each plan as in the
    pair-scan whose one block holds all of Sq."""
    b, sq, sk, h, kv, hd, causal, window, cap, chunk = CASES["empty_row"]
    q, k, v, dout = (torch.tensor(x) for x in
                     _inputs(b, sq, sk, h, kv, hd, seed=3))
    out, lse = _forward(q.numpy(), k.numpy(), v.numpy(), causal, window, cap)
    row = sk + window - 1
    assert row == sq - 1 and float(lse[0, 0, row]) == np.float32(NEG_INF)
    quiet = dout.clone()
    quiet[:, row] = 0
    for fn in (lambda d: design_bwd(q, k, v, out, lse, d, causal=causal,
                                    window=window, plan=plan),
               lambda d: ref.flash_attention_bwd_torch(
                   q, k, v, out, lse, d, chunk=chunk, causal=causal,
                   window=window)):
        (dq1, dk1, dv1), (dq0, dk0, dv0) = fn(dout), fn(quiet)
        assert float(dq1[:, row].abs().max()) == 0.0
        torch.testing.assert_close(dk1, dk0, rtol=0, atol=1e-6)
        added = dout[:, row].reshape(b, kv, h // kv, hd).sum(2)
        torch.testing.assert_close(dv1 - dv0, added[:, None].expand_as(dv1),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["causal_g4_hd64", "ragged_window_cap_hd128",
                                  "cross_sq_lt_sk", "empty_rows_noncausal",
                                  "causal_g2_hd32"])
def test_split_plan_on_bf16_values_stays_near_f32(name):
    """P and dS carried as hi + lo bf16 terms, on bf16-valued inputs, at the
    bf16 plan launch_bf16 takes for the case's hd, within SPLIT_TOL of the
    f32 design."""
    b, sq, sk, h, kv, hd, causal, window, cap, _ = CASES[name]
    q, k, v, dout = (torch.tensor(x) for x in _inputs(
        b, sq, sk, h, kv, hd, seed=7, bf16_valued=True))
    out, lse = _forward(q.numpy(), k.numpy(), v.numpy(), causal, window, cap)
    out = out.bfloat16().float()  # B4 writes out in bf16
    kw = dict(causal=causal, window=window, softcap=cap)
    f32 = design_bwd(q, k, v, out, lse, dout, **kw)
    split = design_bwd(q, k, v, out, lse, dout, split=True,
                       plan="wgmma" if hd in WG_HDS else "tiles64", **kw)
    _assert_close([g.numpy() for g in split], [g.numpy() for g in f32],
                  SPLIT_TOL, f"{name} split")


def _live_pairs(sq, sk, causal, window, rows=BQ, keys=BK):
    """(q block, key block) pairs, of ``rows`` and ``keys``, holding an
    allowed pair, by brute force."""
    ok = _allowed(torch.arange(sq), torch.arange(sk), sq, sk, causal, window)
    return {(qt, kt) for qt in range(-(-sq // rows))
            for kt in range(-(-sk // keys))
            if ok[qt * rows:qt * rows + rows, kt * keys:kt * keys + keys].any()}


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_passes_walk_live_tiles_in_a_fixed_order(name, plan):
    """The dq pass's blocks visit exactly their live key tiles, in order;
    the dk/dv pass's blocks the live q tiles and those of rows with no
    allowed column, each G query head in turn and its q tiles ascending.
    A block of the wgmma plan holds BLOCK rows or keys."""
    b, sq, sk, h, kv, hd, causal, window, cap, _ = CASES[name]
    q, k, v, dout = (torch.tensor(x) for x in _inputs(1, sq, sk, h, kv, 16,
                                                      seed=1))
    out, lse = _forward(q.numpy(), k.numpy(), v.numpy(), causal, window, 0.0)
    visits = {}
    design_bwd(q, k, v, out, lse, dout, causal=causal, window=window,
               visits=visits, plan=plan)
    block = BLOCK if plan == "wgmma" else BQ
    assert visits["dq"] == sorted(_live_pairs(sq, sk, causal, window,
                                              rows=block))
    live = _live_pairs(sq, sk, causal, window, keys=block)
    rows_empty = [r for r in range(sq) if not _allowed(
        torch.tensor([r]), torch.arange(sk), sq, sk, causal, window).any()]
    empty_tiles = {r // BQ for r in rows_empty}
    g = h // kv
    for kt in range(-(-sk // block)):
        seq = [(hh, qt) for t, hh, qt in visits["dkdv"] if t == kt]
        want_q = sorted({qt for qt, t in live if t == kt} | empty_tiles)
        assert seq == [(hh, qt) for hh in range(g) for qt in want_q]


def test_launch_takes_the_wgmma_plan_at_hd_64_and_128():
    """launch_bf16 sends hd = 64 and 128 (every card path's) to the wgmma
    plan and the other multiples of 16 the wrapper takes to the mma.sync
    plan, each once; the wgmma plan's pieces are Hopper's own."""
    from repro_torch.kernels.flash_attention import (BF16_HEAD_DIM_MULTIPLE,
                                                     MAX_HEAD_DIM)
    assert WG_HDS == {64, 128}
    hds = set(range(BF16_HEAD_DIM_MULTIPLE, MAX_HEAD_DIM + 1,
                    BF16_HEAD_DIM_MULTIPLE))
    assert TC_HDS == hds - WG_HDS
    assert BLOCK == 128 and WG_ROWS == BQ == BK
    header = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
              "kernels" / "csrc" / "wgmma_bf16.cuh").read_text()
    for text in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier",
                 "setmaxnreg"):
        assert text in header, text
    assert "atomicAdd" not in SOURCE and "red.global" not in SOURCE


def test_lse_times_log2e_is_rounded_apart_from_the_exponent():
    """Every plan takes lse log2 e through ``lse_log2e`` (``__fmul_rn``),
    never as a product nvcc may fuse into the fma of x - lse log2 e: a row
    with no allowed column (lse -1e30) then meets the refused pairs'
    -1e30 log2 e exactly, p = 1."""
    assert "__fmul_rn(lse, kLog2e)" in SOURCE
    assert SOURCE.count("lse_log2e(") == 5  # its definition and four loads
    assert re.search(r"\]\s*\*\s*kLog2e", SOURCE) is None


# -- the op ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementation_gives_the_kernel_layouts(dtype):
    with FakeTensorMode():
        q = torch.empty(2, 70, 8, 64, dtype=dtype)
        k = torch.empty(2, 90, 2, 64, dtype=dtype)
        lse = torch.empty(2, 8, 70)
        dq, dk, dv = flash_attention_bwd_op(q, k, k, q, lse, q, True, 33,
                                            0.0, 512)
    for got, want in ((dq, q), (dk, k), (dv, k)):
        assert got.shape == want.shape and got.dtype == dtype
        assert got.stride() == want.stride() and got.is_contiguous()


@pytest.mark.parametrize("causal,window,sk", [(True, None, 96),
                                              (True, 40, 96),
                                              (False, None, 150)])
def test_flop_formula_is_the_counts_function(causal, window, sk):
    b, sq, h, kv, hd = 2, 96, 4, 2, 32
    q, k, v, dout = (torch.tensor(x) for x in _inputs(b, sq, sk, h, kv, hd,
                                                      seed=5))
    out, lse = _forward(q.numpy(), k.numpy(), v.numpy(), causal, window, 0.0)
    with FlopCounterMode(display=False) as counter:
        flash_attention_bwd_op(q, k, v, out, lse, dout, causal, window, 0.0,
                               32)
    want = counts.flash_attention_bwd_counts(b, sq, sk, h, kv, hd,
                                             causal=causal, window=window)
    assert counter.get_total_flops() == want[0]
    # five products of the kept pairs; each input read and output written
    # once
    assert want[0] == 10 * h * hd * counts.attention_pairs(b, sq, sk, causal,
                                                           window)
    assert want[1] == 2 * (4 * b * sq * h * hd + 4 * b * sk * kv * hd) + \
        4 * b * h * sq


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window,cap", [(True, None, 0.0),
                                               (True, 5, 2.0),
                                               (False, None, 0.0)])
def test_opcheck(dtype, causal, window, cap):
    """``torch.library.opcheck``: the schema, the fake implementation
    against the CPU kernel, the dispatch under ``make_fx`` and AOT
    autograd."""
    q, k, v, dout = (torch.tensor(x).to(dtype) for x in _inputs(
        2, 9, 7, 4, 2, 16, seed=13))
    out = ref.flash_attention_torch(q, k, v, causal=causal, window=window,
                                    softcap=cap)
    lse = ref.flash_attention_lse_torch(q, k, causal=causal, window=window,
                                        softcap=cap)
    torch.library.opcheck(flash_attention_bwd_op, (q, k, v, out, lse, dout,
                                                   causal, window, cap, 4))


def test_op_on_the_cpu_is_the_pair_scan():
    b, sq, sk, h, kv, hd = 1, 70, 70, 4, 2, 32
    q, k, v, dout = (torch.tensor(x) for x in _inputs(b, sq, sk, h, kv, hd,
                                                      seed=9))
    out, lse = _forward(q.numpy(), k.numpy(), v.numpy(), True, 30, 0.0)
    got = flash_attention_bwd_op(q, k, v, out, lse, dout, True, 30, 0.0, 16)
    want = ref.flash_attention_bwd_torch(q, k, v, out, lse, dout, chunk=16,
                                         causal=True, window=30)
    for a, w in zip(got, want):
        assert torch.equal(a, w) and a.is_contiguous()


def test_the_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_cuda(q, q, q, q, torch.zeros(1, 2, 8), q)


@pytest.mark.parametrize("window,cap", [(None, 0.0), (24, 0.0), (None, 7.0)])
def test_flash_attention_on_the_cpu_gives_the_reference_vjp(window, cap):
    b, sq, sk, h, kv, hd = 2, 50, 50, 4, 2, 64
    q, k, v, dout = _inputs(b, sq, sk, h, kv, hd, seed=11)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    ops.flash_attention(*leaves, causal=True, window=window, chunk=16,
                        softcap=cap).backward(torch.tensor(dout))
    want = _reference_vjp(q, k, v, dout, 16, True, window, cap)
    _assert_close([x.grad.numpy() for x in leaves], want, F32_TOL,
                  "FlashAttention")


def _timing_tool():
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "tools" / "b4b_timing.py"
    spec = importlib.util.spec_from_file_location("b4b_timing", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_the_timing_tools_variants_apply_to_the_source():
    """``tools/b4b_timing.py --variants`` copies the source with one text
    change each: every text is found exactly once."""
    tool = _timing_tool()
    assert tool.VARIANTS
    for name, (old, new) in tool.VARIANTS.items():
        assert SOURCE.count(old) == 1 and old != new, name


def test_the_timing_tools_probes_apply_to_the_source():
    """``tools/b4b_timing.py --probes`` copies the source with a clock64()
    store at each of the 8 points of a tile in both passes: every text it
    changes is found exactly once, in the order the passes run it."""
    tool = _timing_tool()
    pairs = tool._probes()
    assert len(pairs) == 1 + 2 * 6
    text = SOURCE
    for old, new in pairs:
        assert text.count(old) == 1 and old != new, old
        text = text.replace(old, new)
    for p in range(2):
        for k in range(len(tool.PHASES)):
            assert text.count(f"* 8 + {k}] = clock64();") == 2
    assert text.count("= clock64();") == 2 * len(tool.PHASES)
