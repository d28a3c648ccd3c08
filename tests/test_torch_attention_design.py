"""The arithmetic of the attention kernels' designs, on the CPU.

B4 and B5 run only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). These tests write out in torch the arithmetic their
designs rest on and hold it, on inputs made with numpy from a seed, against
the port's plain versions (``kernels/ref.py``) and the JAX reference's
oracles (``repro/kernels/ref.py``):

(a) B5's split-W flash-decode: each split of whole 64-slot tiles walks the
    tiles that hold a valid slot with an online softmax over its valid
    slots only, and writes (m, l, acc); the splits are combined in split
    order; a lane with no valid slot returns the mean of all W V rows;
(b) the wrapper's split plan (``decode_attention.split_plan``), which the
    CPU reaches: whole tiles, no empty split, a full grid where W allows;
(c) B4's bf16 tensor-core path: 64-row q tiles over the live 64-column K/V
    tiles, masks only on the tiles that cut the diagonal, the window or the
    end of S, an online softmax, and P carried into P.V as two bf16 terms
    P_hi + P_lo.

All f32. (a) is held to 1e-6: the same f32 softmax, summed in another order
(tile by tile, split by split) than one softmax over W.

(a) and (c) run no kernel code: they document the arithmetic the kernels
are built on, and cannot fail when a kernel changes. The kernels
themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). (b) runs the wrapper's
own planning functions.
"""
import math

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (MAX_TILES_PER_SPLIT,
                                                  MIN_BLOCKS_PER_SM, TILE,
                                                  check_plan, split_plan,
                                                  split_ranges)

torch.set_num_threads(1)

NEG_INF = -1e30
DECODE_TOL = dict(atol=1e-6, rtol=1e-6)
# (c): P_hi + P_lo holds each weight to 2^-16 of itself (P_hi keeps 8
# significant bits, P_lo the next 8), so an output, a convex combination of
# V rows, moves by at most ~2^-16 of the largest |v| -- about 1.5e-5 of
# it, and the largest |v| is within a few times the largest |o| (row 0's
# output is a V row). 1e-4 of the largest |o| holds that with room.
SPLIT_P_TOL = 1e-4


# -- (a) B5: split-W partial softmax and the ordered combine ----------------


def split_decode(q, kc, vc, slot_pos, pos, per, window=None):
    """B5's arithmetic, written out: q (B, H, hd), caches (B, W, KV, hd),
    splits of ``per`` tiles -> (B, H, hd) f32."""
    b, w, kv, hd = kc.shape
    g = q.shape[1] // kv
    scale = 1.0 / math.sqrt(hd)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window is not None:
        valid &= slot_pos > pos[:, None] - window
    out = torch.empty(b, kv, g, hd)
    for i in range(b):
        for j in range(kv):
            qg = q[i].reshape(kv, g, hd)[j]
            parts = []
            for s0, s1 in split_ranges(w, per):
                m = torch.full((g,), NEG_INF)
                l = torch.zeros(g)
                acc = torch.zeros(g, hd)
                for t0 in range(s0, s1, TILE):
                    t1 = min(t0 + TILE, s1)
                    ok = valid[i, t0:t1]
                    if not ok.any():  # the tile is not read
                        continue
                    sc = (qg @ kc[i, t0:t1, j].T) * scale
                    sc = torch.where(ok, sc, -math.inf)  # skipped: weight 0
                    m_new = torch.maximum(m, sc.max(-1).values)
                    p = torch.exp(sc - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ vc[i, t0:t1, j]
                    m = m_new
                parts.append((m, l, acc))
            live = [pt for pt in parts if bool((pt[1] > 0).all())]
            if not live:  # every score -1e30: a uniform softmax over W
                out[i, j] = vc[i, :, j].sum(0) / w
                continue
            mx = torch.stack([pt[0] for pt in live]).max(0).values
            l_sum = torch.zeros(g)
            o = torch.zeros(g, hd)
            for m, l, acc in live:  # split order
                wgt = torch.exp(m - mx)
                l_sum = l_sum + wgt * l
                o = o + wgt[:, None] * acc
            out[i, j] = o / l_sum[:, None]
    return out.reshape(b, kv * g, hd)


def _decode_case(w, g, hd, kv=2, seed=0):
    """Four lanes: no valid slot (no roll), a cache rolled past W
    (positions p0 .. p0+W-1 at slots p % W), a partly filled one, and a full
    one whose query position is mid-way."""
    rng = np.random.default_rng(seed)
    b = 4
    q = rng.normal(size=(b, kv * g, hd)).astype(np.float32)
    kc = rng.normal(size=(b, w, kv, hd)).astype(np.float32)
    vc = rng.normal(size=(b, w, kv, hd)).astype(np.float32)
    slot_pos = np.full((b, w), -1, np.int32)
    tail = np.arange(3 * w + 17, 4 * w + 17)
    slot_pos[1, tail % w] = tail
    fill = w // 3
    slot_pos[2, :fill] = np.arange(fill)
    slot_pos[3] = np.arange(w)
    pos = np.array([0, tail[-1], fill - 1, w // 2], np.int32)
    return q, kc, vc, slot_pos, pos


@pytest.mark.parametrize("w,per,n_splits", [
    (1000, 16, 1), (1000, 8, 2), (886, 2, 7), (1000, 1, 16)])
@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("g,hd", [(4, 16), (5, 64)])
def test_split_w_decode_matches_plain_version_and_reference(
        w, per, n_splits, window, g, hd):
    assert w % TILE and len(split_ranges(w, per)) == n_splits
    q, kc, vc, slot_pos, pos = _decode_case(w, g, hd, seed=n_splits)
    t = [torch.from_numpy(a) for a in (q, kc, vc, slot_pos, pos)]
    got = split_decode(*t, per, window=window)
    want = ref.decode_attention_torch(*t, window=window)
    torch.testing.assert_close(got, want, **DECODE_TOL)
    oracle = np.asarray(jref.decode_attention_ref(q, kc, vc, slot_pos, pos,
                                                  window=window))
    np.testing.assert_allclose(got.numpy(), oracle, **DECODE_TOL)
    # the empty lane is the mean of V over all W slots
    np.testing.assert_allclose(
        got[0].numpy(), np.repeat(vc[0].mean(0), g, axis=0), **DECODE_TOL)


# -- (b) the split plan ------------------------------------------------------


@pytest.mark.parametrize("w,b,kv,sm", [
    (4096, 4, 8, 132),    # the 4-lane qwen3-4b edge
    (2048, 4, 5, 132),    # the 4-lane hymba-1.5b edge
    (4096, 1, 8, 132),    # one lane: many splits
    (4096, 2, 8, 132),
    (1, 1, 1, 132),       # W = 1
    (96, 3, 8, 132),      # W too short to fill the card
    (70, 33, 8, 132),     # enough pairs for one split each
    (100_000, 2, 8, 132),  # splits capped at MAX_TILES_PER_SPLIT tiles
    (1000, 4, 5, 114),    # another SM count
    (640, 1, 1, 132),
])
def test_split_plan_covers_w_in_whole_tiles_and_fills_the_card(w, b, kv, sm):
    splits, per = split_plan(w, b, kv, sm)
    ranges = split_ranges(w, per)
    assert len(ranges) == splits and 1 <= per <= MAX_TILES_PER_SPLIT
    assert ranges[0][0] == 0 and ranges[-1][1] == w
    for (s0, s1), (n0, _) in zip(ranges, ranges[1:] + [(w, None)]):
        assert s0 < s1 == n0  # no split empty, no gap, no overlap
        assert s0 % TILE == 0 and (s1 % TILE == 0 or s1 == w)
        assert s1 - s0 <= per * TILE
    tiles = -(-w // TILE)
    assert splits * b * kv >= min(MIN_BLOCKS_PER_SM * sm, tiles * b * kv)
    check_plan(w, splits, per)  # what the wrapper passes to the kernel


@pytest.mark.parametrize("w,splits,per,ok", [
    (4096, 22, 3, True),    # the last split owns one tile
    (4096, 1, 64, True),    # one split of the most tiles
    (1, 1, 1, True),
    (4096, 21, 3, False),   # one tile short of W
    (4096, 23, 3, False),   # the last split empty
    (100, 1, 0, False),     # no tiles a split
    (8192, 1, 128, False),  # more tiles than the kernel keeps flags for
    (64, 0, 1, False),      # no split
])
def test_check_plan_takes_only_what_the_kernel_takes(w, splits, per, ok):
    if ok:
        check_plan(w, splits, per)
    else:
        with pytest.raises(ValueError, match="split plan"):
            check_plan(w, splits, per)


# -- (c) B4: P carried as P_hi + P_lo ---------------------------------------


def tiled_flash(q, k, v, causal, window, p_terms):
    """B4's bf16 arithmetic in f32 on bf16-valued q, k, v: per 64-row q
    tile, the live 64-column tiles [lo, hi] in order; S = Q K^T, then the
    scale; -1e30 masks only on edge tiles (elsewhere the full mask is
    asserted to pass); an online softmax with l from P in f32; O += each of
    ``p_terms(P)`` times V."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty(b, s, h, hd)
    pad = (0, 0, 0, (-s) % 64)  # K/V rows past S zero-filled
    kp = torch.nn.functional.pad(k.permute(0, 2, 1, 3), pad)
    vp = torch.nn.functional.pad(v.permute(0, 2, 1, 3), pad)
    for bi in range(b):
        for hh in range(h):
            for q0 in range(0, s, 64):
                n = min(64, s - q0)
                qt = q[bi, q0:q0 + n, hh]
                rows = torch.arange(q0, q0 + n)[:, None]
                last = min(q0 + 63, s - 1)
                hi = last // 64 if causal else (s - 1) // 64
                lo = (q0 - window + 1) // 64 if window and q0 - window + 1 > 0 \
                    else 0
                m = torch.full((n,), NEG_INF)
                l = torch.zeros(n)
                acc = torch.zeros(n, hd)
                for j in range(lo, hi + 1):
                    k0 = j * 64
                    cols = torch.arange(k0, k0 + 64)[None, :]
                    kt = kp[bi, hh // g, k0:k0 + 64]
                    vt = vp[bi, hh // g, k0:k0 + 64]
                    sc = (qt @ kt.T) * scale
                    ok = cols < s
                    if causal:
                        ok = ok & (cols <= rows)
                    if window:
                        ok = ok & (cols > rows - window)
                    edge = (k0 + 64 > s or (causal and k0 + 63 > q0)
                            or bool(window and k0 <= q0 + 63 - window))
                    if edge:
                        sc = torch.where(ok, sc, NEG_INF)
                    else:
                        assert bool(ok.all())
                    m_new = torch.maximum(m, sc.max(-1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None]
                    for term in p_terms(p):
                        acc = acc + term @ vt
                    m = m_new
                out[bi, q0:q0 + n, hh] = acc / l.clamp_min(1e-30)[:, None]
    return out


def split_p(p):
    hi = p.bfloat16().float()
    return hi, (p - hi).bfloat16().float()


def _bf16_valued(shape, rng):
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.bfloat16().float()


def _flash_case(b, s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return [_bf16_valued((b, s, n, hd), rng) for n in (h, kv, kv)]


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", [
    (1, 1, 4, 2, 16, True, None),
    (1, 37, 4, 1, 32, True, None),     # ragged last q and K tile
    (1, 63, 5, 1, 64, True, 2048),     # hymba heads, window past S
    (1, 65, 5, 1, 64, True, 2048),
    (2, 130, 4, 2, 16, False, None),   # non-causal
    (1, 200, 4, 2, 16, True, 70),      # window lo tile off a tile edge
    (1, 200, 4, 1, 32, False, 50),     # non-causal window
    (1, 150, 2, 1, 128, True, None),   # qwen3's head width
])
def test_split_p_flash_matches_plain_version_and_reference(
        b, s, h, kv, hd, causal, window):
    q, k, v = _flash_case(b, s, h, kv, hd, seed=s)
    got = tiled_flash(q, k, v, causal, window, split_p)
    want = ref.flash_attention_torch(q, k, v, causal=causal, window=window)
    bar = SPLIT_P_TOL * float(want.abs().max())
    torch.testing.assert_close(got, want, atol=bar, rtol=0)
    oracle = np.asarray(jref.flash_attention_ref(
        q.numpy(), k.numpy(), v.numpy(), causal=causal, window=window))
    np.testing.assert_allclose(got.numpy(), oracle, atol=bar, rtol=0)


def test_one_bf16_rounding_of_p_is_far_coarser_than_the_split():
    """Why two terms: P rounded once to bf16 (SDPA's P.V) moves the outputs
    by more than ten times what P_hi + P_lo does."""
    q, k, v = _flash_case(1, 256, 4, 2, 64, seed=3)
    want = ref.flash_attention_torch(q, k, v, causal=True)
    err_split = float((tiled_flash(q, k, v, True, None, split_p)
                       - want).abs().max())
    err_once = float((tiled_flash(q, k, v, True, None,
                                  lambda p: (p.bfloat16().float(),))
                      - want).abs().max())
    assert err_once > 10 * err_split
