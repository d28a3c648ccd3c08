"""B1's, B3's and B2's designs (``kernels/csrc/policy_score.cu``) written
out in torch, on the CPU, against the JAX reference.

The CUDA kernels run only on a card. Here their decompositions are spelled
out step by step as the kernels take them, and held against
``repro.kernels.policy_score`` (Pallas in interpret mode, as
``tests/test_kernels.py`` runs it), against ``jax.vjp`` of the reference
head (``repro.kernels.ref.policy_score_ref``), and against the port's plain
versions (``repro_torch.kernels.ref``):

* B3, the fused score + top-K decode: px = c @ Wpx over the flattened B*Q
  edge rows and pxy[b] = Wpy @ px[b]^T in BK-deep chunks (the tile
  routine's order); u = h @ pxy as the 8 warps' partial sums over their
  slices of each 256-deep chunk of d, added in warp order; the edges padded
  to 32, 64 or 128 (padding valued -inf, indexed past Q); selection by one
  arg-max at K = 1 and by the kernel's bitonic network over (value desc,
  index asc) keys at K > 1.
* B1, the materialized head: above kFlatQ edges, B3's launches up to the
  selection (the same px, pxy and u), then each row's log-softmax over its
  keys, so its values at B3's normalized top-K indices are B3's values
  exactly; at kFlatQ edges or fewer (the training shape's Q = 5), its
  small-Q plan: px and pxy^T = px @ Wpy^T over the B*Q edge rows (B2's
  tiles), and u per row over its own instance's edges in four lanes'
  quarters of d (``pair_u``), then the same log-softmax.
* B2, the head's backward, folded as the reference folds its decode: px
  and pxy^T = px @ Wpy^T over the B*Q edge rows; u = h . pxy^T[b, q] and
  dh = gu @ pxy^T[b] per row over tiles of 16 flattened request rows
  across instance boundaries (``pair_u``); ghx = gu^T h per instance (z
  in order);
  dpx = ghx @ Wpy; the weight gradients dWpy = ghx^T px and dWpx = c^T dpx
  over the B*Q edge rows in the wrapper's row split, partials added in
  order; dc = dpx @ Wpx^T. No (Z, d) x (d, d) product is left.

The kernels use no tensor cores (f32 FMAs only), so no hi/lo split is
written out here. Tolerances: indices exactly, on rows whose top-K+1
scores are more than GAP apart (another summation order moves scores by
rounding, ~1e-6, so nearer rows may swap) and on every row of the
exact-arithmetic tie inputs; values within ATOL = 2e-5 (f32 sums over d,
scaled by C = 10 through tanh; the bar chip_smoke.py holds the kernel to);
gradients within BWD_TOL of each output's largest entry (chip_smoke.py's:
dc and dh sum over d and Q in another order, the weight gradients over
the B*Q rows in partials).
"""
import importlib.util
import math
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.policy_score import policy_score_decode_fwd as j_decode
from repro.kernels.policy_score import policy_score_fwd as j_policy_score
from repro_torch.kernels import build, ref
from repro_torch.kernels import policy_score as kps

torch.set_num_threads(1)

ATOL = 2e-5
GAP = 1e-5
BWD_TOL = {"dc": 2e-5, "dh": 2e-5, "dw_px": 1e-4, "dw_py": 1e-4}
CLIP = 10.0
SOURCE = (build.CSRC / "policy_score.cu").read_text()
_spec = importlib.util.spec_from_file_location(
    "b1_plans", Path(__file__).resolve().parents[1] / "tools" / "b1_plans.py")
b1_plans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(b1_plans)


def _const(pattern):
    return int(re.search(pattern, SOURCE).group(1))


# the plan the source states
ROW_KC = _const(r"constexpr int kRowKC = (\d+);")
WARPS = _const(r"constexpr int kThreads = (\d+);") // 32
BWD_ROWS = _const(r"constexpr int kBwdRows = (\d+);")
FLAT_ROWS = _const(r"constexpr int kFlatRows = (\d+);")
FLAT_Q = _const(r"constexpr int kFlatQ = (\d+);")


def _tile(name):
    """(BK, KSPLIT) of the Tile the source names ``name``."""
    m = re.search(rf"using {name} = Tile<\d+, \d+, (\d+), \d+, \d+, \w+, "
                  rf"\w+(?:, (\d+))?", SOURCE)
    return int(m.group(1)), int(m.group(2) or 1)


EDGE, EDGE_T, PX, PXY, WT, CT = (_tile(n) for n in (
    "EdgeTile", "EdgeTileT", "PxTile", "PxyTile", "WTile", "CTile"))


def tile_product(a, b, plan):
    """a (M, K) @ b (K, N) as the tile routine sums it, plan = (BK,
    KSPLIT): group g sums its KSPLIT-th of every BK-deep chunk of the
    reduction, chunks in order, and the groups' sums are added in order."""
    bk, ksplit = plan
    kg = bk // ksplit
    total = None
    for g in range(ksplit):
        acc = torch.zeros(a.shape[0], b.shape[1])
        for k0 in range(0, a.shape[1], bk):
            ks = slice(k0 + g * kg, k0 + (g + 1) * kg)
            acc = acc + a[:, ks] @ b[ks]
        total = acc if total is None else total + acc
    return total


def padded_edges(q):
    """QP, the edge count decode_rows<QP> is instantiated for."""
    return 32 if q <= 32 else 64 if q <= 64 else 128


def bitonic_desc(v, idx):
    """The kernel's warp_sort on the last axis (a power of two): the bitonic
    network, every compare-exchange keeping the earlier of two (value desc,
    index asc) keys at the lower position of a descending run."""
    n = v.shape[-1]
    e = torch.arange(n)
    size = 2
    while size <= n:
        stride = size // 2
        while stride:
            p = e ^ stride
            vp, ip = v[..., p], idx[..., p]
            mine_first = (v > vp) | ((v == vp) & (idx < ip))
            keep_first = (e < p) == ((e & size) == 0)
            keep = keep_first == mine_first
            v, idx = torch.where(keep, v, vp), torch.where(keep, idx, ip)
            stride //= 2
        size *= 2
    return v, idx


def design_rows_u(c, h, wx, wy):
    """u * scale, (B, Z, QP), as B3's (and B1's above FLAT_Q) three
    launches compute it: px = c @ Wpx over the flattened B*Q edge rows and
    pxy[b] = Wpy @ px[b]^T in BK-deep chunks (the tile routine's order);
    u = h @ pxy as the 8 warps' partial sums over their slices of each
    256-deep chunk of d, added in warp order (``rows_u``); padding edges
    read zeros."""
    b, q, d = c.shape
    z = h.shape[1]
    px = tile_product(c.reshape(-1, d), wx, EDGE).reshape(b, q, d)
    qp = padded_edges(q)
    pxy = torch.zeros(b, d, qp)
    for i in range(b):
        pxy[i, :, :q] = tile_product(wy, px[i].T, EDGE_T)
    kw = ROW_KC // WARPS
    parts = []
    for w in range(WARPS):  # each warp's slice of every chunk of d
        part = torch.zeros(b, z, qp)
        for k0 in range(0, d, ROW_KC):
            ks = slice(k0 + w * kw, min(k0 + (w + 1) * kw, d))
            part = part + h[..., ks] @ pxy[:, ks]
        parts.append(part)
    u = parts[0]
    for part in parts[1:]:  # in warp order
        u = u + part
    return u * (1.0 / math.sqrt(d))


def design_keys(u, maskf, normalize):
    """``row_keys`` over the last axis of u (B, Z, P), P >= Q edges
    (padding valued -inf): (v, the row's log-sum-exp or None)."""
    b, z, p = u.shape
    q = maskf.shape[-1]
    keep = torch.zeros(b, p, dtype=torch.bool)
    keep[:, :q] = maskf > 0.5
    keep = keep[:, None, :].expand(b, z, p)
    if normalize:
        v = torch.where(keep, CLIP * torch.tanh(u), torch.tensor(-1e9))
    else:
        v = torch.where(keep, u, torch.tensor(-math.inf))
    v = torch.where((torch.arange(p) < q).expand(b, z, p), v,
                    torch.tensor(-math.inf))
    if not normalize:
        return v, None
    mx = v.max(-1, keepdim=True).values
    return v, torch.log(torch.exp(v - mx).sum(-1, keepdim=True)) + mx


def design_decode(c, h, wx, wy, maskf, k, normalize):
    """B3 as the kernel computes it; c (B, Q, d), h (B, Z, d), maskf (B, Q)
    f32. Returns (top_idx int32, top_val), (B, Z, K)."""
    v, lse = design_keys(design_rows_u(c, h, wx, wy), maskf, normalize)
    qp = v.shape[-1]
    idx = torch.arange(qp).expand(v.shape)
    if k == 1:  # one arg-max, the first index attaining it
        top = v.max(-1, keepdim=True).values
        sel_i = torch.where(v == top, idx, qp).min(-1, keepdim=True).values
        sel_v = top
    else:
        sv, si = bitonic_desc(v, idx)
        sel_v, sel_i = sv[..., :k], si[..., :k]
    sel_v = sel_v - lse if normalize else CLIP * torch.tanh(sel_v)
    return sel_i.to(torch.int32), sel_v


def pair_u(hr, pt):
    """hr . pt[:, q] as ``pair_u`` sums it: four lanes, each a quarter of d
    (lane s takes k = 4 s + 16 j .. + 3 when d % 4 == 0, else k = s + 4 j),
    added as (lane 0 + 1) + (lane 2 + 3). hr (n, d), pt (n, Q, d) -> (n,
    Q)."""
    k = torch.arange(hr.shape[-1])
    lane = (k // 4) % 4 if hr.shape[-1] % 4 == 0 else k % 4
    part = [torch.einsum("nd,nqd->nq", hr[:, lane == s], pt[:, :, lane == s])
            for s in range(4)]
    return (part[0] + part[1]) + (part[2] + part[3])


def design_score(c, h, wx, wy, maskf):
    """B1 as the kernel computes it: (B, Z, Q) log-probs. Above FLAT_Q
    edges B3's u and keys; else the small-Q plan (B2's edge-side tiles and
    flattened rows, u per row over its own instance's Q edges). Then each
    row's keys minus its log-sum-exp."""
    b, q, d = c.shape
    z = h.shape[1]
    if q > FLAT_Q:
        u = design_rows_u(c, h, wx, wy)
    else:
        px = tile_product(c.reshape(-1, d), wx, PX)
        pxyT = tile_product(px, wy.T, PXY).reshape(b, q, d)
        inst = torch.arange(b * z) // z  # each row's own instance; rows
        u = pair_u(h.reshape(-1, d), pxyT[inst])  # are independent
        u = u.reshape(b, z, q) * (1.0 / math.sqrt(d))
    v, lse = design_keys(u, maskf, True)
    return (v - lse)[..., :q]


def design_bwd(g, out, c, h, wx, wy, maskf):
    """B2 as the kernels compute it (the fold); returns (dc, dh, dw_px,
    dw_py)."""
    b, q, d = c.shape
    z = h.shape[1]
    scale = 1.0 / math.sqrt(d)
    cf = c.reshape(-1, d)
    px = tile_product(cf, wx, PX)            # (B*Q, d)
    pxyT = tile_product(px, wy.T, PXY)       # px @ Wpy^T
    pxyT_b = pxyT.reshape(b, q, d)
    hf, gf, of = h.reshape(-1, d), g.reshape(-1, q), out.reshape(-1, q)
    gu = torch.zeros(b * z, q)
    dh = torch.zeros(b * z, d)
    for r0 in range(0, b * z, BWD_ROWS):  # bwd_rows's tiles
        rows = torch.arange(r0, min(r0 + BWD_ROWS, b * z))
        inst = rows // z                  # each row's own instance
        pt = pxyT_b[inst]                 # (n, Q, d): its Q edges only
        u = pair_u(hf[rows], pt)
        th = torch.tanh(u * scale)
        gi = gf[rows] - torch.exp(of[rows]) * gf[rows].sum(-1, keepdim=True)
        v = torch.where(maskf[inst] > 0.5,
                        gi * (CLIP * scale) * (1.0 - th * th),
                        torch.tensor(0.0))
        gu[rows] = v
        dh[rows] = torch.einsum("nq,nqd->nd", v, pt)
    gub = gu.reshape(b, z, q)
    ghx = torch.zeros(b, q, d)
    for zz in range(z):  # bwd_ghx: z in order
        ghx = ghx + gub[:, zz, :, None] * h[:, zz, None, :]
    ghx = ghx.reshape(-1, d)
    dpx = tile_product(ghx, wy, PX)
    split = kps._row_split(b * q)
    per = -(-b * q // split)

    def weight_grad(a, m):  # partials over the edge rows, added in order
        total = torch.zeros(d, d)
        for k0 in range(0, b * q, per):
            total = total + tile_product(a[k0:k0 + per].T, m[k0:k0 + per],
                                         WT)
        return total

    dc = tile_product(dpx, wx.T, CT)
    return (dc.reshape(b, q, d), dh.reshape(b, z, d), weight_grad(cf, dpx),
            weight_grad(ghx, px))


def _inputs(b, q, z, d, seed, exact=False):
    """Embeddings, init-scale weights and a random valid-edge set per
    instance (between 1 and Q edges). ``exact``: small multiples of 2^-6
    (embeddings) and 2^-7 (weights), so every product and sum above is
    exact in f32 and all implementations score alike; edge 1 duplicates
    edge 0 and edge 3 edge 2 (where they exist), so rows hold exact ties."""
    rng = np.random.default_rng(seed)
    if exact:
        c = rng.integers(-3, 4, size=(b, q, d)) / 64.0
        h = rng.integers(-3, 4, size=(b, z, d)) / 64.0
        wx = rng.integers(-2, 3, size=(d, d)) / 128.0
        wy = rng.integers(-2, 3, size=(d, d)) / 128.0
        for src, dst in ((0, 1), (2, 3)):
            if dst < q:
                c[:, dst] = c[:, src]
    else:
        bound = 1.0 / np.sqrt(d)
        c = rng.normal(size=(b, q, d))
        h = rng.normal(size=(b, z, d))
        wx = rng.uniform(-bound, bound, size=(d, d))
        wy = rng.uniform(-bound, bound, size=(d, d))
    mask = np.zeros((b, q), bool)
    for i in range(b):
        mask[i, rng.permutation(q)[:rng.integers(1, q + 1)]] = True
    if exact:
        mask[:, :min(q, 4)] = True  # the duplicated edges compete
    return [x.astype(np.float32) for x in (c, h, wx, wy)] + [mask]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _gapped(sorted_vals, n_valid, k):
    """Rows whose first min(k, valid) sorted scores are each more than GAP
    above the next valid one; sorted_vals (B, Z, Q) descending."""
    gaps = sorted_vals[..., :-1] - sorted_vals[..., 1:]
    use = np.arange(gaps.shape[-1])[None, None, :] < np.minimum(
        k, n_valid - 1)[:, None, None]
    return np.where(use, gaps, np.inf).min(-1, initial=np.inf) > GAP


# (B, Q, Z, d): Q in {1, 5, 100, 128} (QP 32, 32, 128, 128), Z = 37 a
# multiple of no tile (16-row B2 tiles, 8/16/32-row B3 blocks), B*Z = 111
# and B*Q not multiples of 16 or 8 either, d in {32, 512} (one and two
# 256-deep chunks)
CASES = [(1, 1, 37, 32), (3, 5, 37, 32), (1, 100, 37, 32),
         (3, 128, 37, 32), (3, 5, 37, 512), (1, 128, 37, 512)]


@pytest.mark.parametrize("b,q,z,d", CASES)
@pytest.mark.parametrize("normalize", [True, False])
def test_decode_design_matches_reference(b, q, z, d, normalize):
    """The design's top-K (K in 1, 3, Q) against Pallas interpret (the
    reference kernel, ranked slots below the valid-edge count; the slots
    past it are undefined upstream) and the port's plain version (every
    slot)."""
    c, h, wx, wy, mask = _inputs(b, q, z, d, seed=q + d)
    ri, rv = (np.asarray(x) for x in j_decode(
        c, h, wx, wy, mask, k=q, normalize=normalize, interpret=True))
    n_valid = mask.sum(-1)
    tc, th, twx, twy, tm = _t(c, h, wx, wy, mask)
    maskf = tm.to(torch.float32)
    for k in sorted({1, min(3, q), q}):
        ti, tv = design_decode(tc, th, twx, twy, maskf, k, normalize)
        pi, pv = ref.policy_score_decode_torch(tc, th, twx, twy, tm, CLIP, k,
                                               normalize)
        rows = _gapped(rv, n_valid, k)
        assert rows.mean() > 0.5
        np.testing.assert_array_equal(ti.numpy()[rows], pi.numpy()[rows])
        np.testing.assert_allclose(tv.numpy(), pv.numpy(), atol=ATOL, rtol=0)
        for i in range(b):
            n = min(k, int(n_valid[i]))
            np.testing.assert_array_equal(ti.numpy()[i, rows[i], :n],
                                          ri[i, rows[i], :n])
            np.testing.assert_allclose(tv.numpy()[i, :, :n], rv[i, :, :n],
                                       atol=ATOL, rtol=0)


@pytest.mark.parametrize("q", [5, 100])
@pytest.mark.parametrize("normalize", [True, False])
def test_decode_design_breaks_exact_ties_by_lowest_index(q, normalize):
    """Exact arithmetic, duplicated edge columns: every row's indices equal
    the reference oracle's and the plain version's, ties to the lower edge."""
    b, z, d = 2, 37, 32
    c, h, wx, wy, mask = _inputs(b, q, z, d, seed=7, exact=True)
    n_valid = mask.sum(-1)
    oi, _ = (np.asarray(x) for x in jax.vmap(
        lambda ci, hi, mi: jref.policy_score_decode_ref(
            ci, hi, wx, wy, mi, CLIP, q, normalize))(c, h, mask))
    tc, th, twx, twy, tm = _t(c, h, wx, wy, mask)
    maskf = tm.to(torch.float32)
    ties = 0
    for k in sorted({1, 3, q}):
        ti, _ = design_decode(tc, th, twx, twy, maskf, k, normalize)
        pi, _ = ref.policy_score_decode_torch(tc, th, twx, twy, tm, CLIP, k,
                                              normalize)
        np.testing.assert_array_equal(ti.numpy(), pi.numpy())
        for i in range(b):
            n = min(k, int(n_valid[i]))
            np.testing.assert_array_equal(ti.numpy()[i, :, :n], oi[i, :, :n])
        if k == q:  # the duplicated pairs appear in rank order
            pos = np.argsort(ti.numpy(), -1)
            ties += int((pos[..., 0] < pos[..., 1]).sum())
    assert ties == b * z


def test_bitonic_network_sorts_like_a_stable_sort():
    """The kernel's sort network over 32, 64 and 128 keys equals a stable
    descending sort, with many exact ties and -inf padding."""
    rng = np.random.default_rng(3)
    for n in (32, 64, 128):
        v = torch.from_numpy(rng.integers(-4, 5, size=(50, n)).astype(
            np.float32))
        v[:, n - 5:] = -math.inf
        idx = torch.arange(n).expand(50, n)
        sv, si = bitonic_desc(v, idx)
        want_v, want_i = ref.stable_topk(v, n)
        assert torch.equal(si, want_i) and torch.equal(sv, want_v)


def _score_references(c, h, wx, wy, mask):
    """B1's reference values: Pallas interpret, the reference head per
    instance and the port's plain version."""
    return [np.asarray(j_policy_score(c, h, wx, wy, mask, interpret=True)),
            np.asarray(jax.vmap(lambda ci, hi, mi: jref.policy_score_ref(
                ci, hi, wx, wy, mi))(c, h, mask)),
            ref.policy_score_torch(*_t(c, h, wx, wy, mask)).numpy()]


# CASES, Q = 9 (QP 32 just above the small-Q plan) and Q = 50 (QP 64)
SCORE_CASES = CASES + [(2, 9, 37, 32), (2, 50, 37, 32)]


@pytest.mark.parametrize("b,q,z,d", SCORE_CASES)
def test_score_design_matches_reference(b, q, z, d):
    """B1's design (both plans) against Pallas interpret, the reference
    head and the port's plain version, within ATOL."""
    c, h, wx, wy, mask = _inputs(b, q, z, d, seed=3 * q + d)
    tc, th, twx, twy, tm = _t(c, h, wx, wy, mask)
    got = design_score(tc, th, twx, twy, tm.to(torch.float32)).numpy()
    for want in _score_references(c, h, wx, wy, mask):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,q,z,d", [(128, 5, 50, 256), (16, 1, 1, 256)])
def test_score_design_small_q_plan(b, q, z, d):
    """The small-Q plan at the training shape (B=128, Q=5, Z=50, d=256;
    400 blocks of 16 flattened rows, two instances a block) and at Q = 1,
    Z = 1 (16 instances a block), against Pallas interpret, the reference
    head and the plain version."""
    assert q <= FLAT_Q
    c, h, wx, wy, mask = _inputs(b, q, z, d, seed=13)
    tc, th, twx, twy, tm = _t(c, h, wx, wy, mask)
    got = design_score(tc, th, twx, twy, tm.to(torch.float32)).numpy()
    for want in _score_references(c, h, wx, wy, mask):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,q,z,d", [x for x in SCORE_CASES if x[1] > FLAT_Q])
def test_score_design_equals_decode_design_values(b, q, z, d):
    """Above FLAT_Q edges B1 and B3 share u and the keys: B1's values at
    B3's normalized top-K indices (K = 1, 3, Q) are B3's values, exactly,
    and B1's row arg-max is B3's K = 1 index."""
    c, h, wx, wy, mask = _t(*_inputs(b, q, z, d, seed=q + 2 * d))
    maskf = mask.to(torch.float32)
    scores = design_score(c, h, wx, wy, maskf)
    for k in (1, 3, q):
        ti, tv = design_decode(c, h, wx, wy, maskf, k, True)
        assert torch.equal(scores.gather(-1, ti.long()), tv), k
        if k == 1:
            assert torch.equal(scores.argmax(-1), ti[..., 0].long())


@pytest.mark.parametrize("name", sorted(b1_plans.PLANS))
def test_b1_plans_edits_apply_to_the_source(name):
    """Each copy ``tools/b1_plans.py`` times finds its texts exactly once
    in the source (``source`` has none), so an edit of those lines fails
    here and not on the card."""
    text = b1_plans.patched(SOURCE, name, b1_plans.PLANS[name])
    assert (text == SOURCE) == (name == "source")


@pytest.mark.parametrize("b,q,z,d", CASES)
def test_backward_design_matches_reference_vjp(b, q, z, d):
    """The folded design's four gradients against jax.vjp of the Pallas
    custom VJP (interpret) and of the reference head, and against the
    port's plain version, on one cotangent."""
    c, h, wx, wy, mask = _inputs(b, q, z, d, seed=q * d + 1)
    g = np.random.default_rng(2).normal(size=(b, z, q)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: j_policy_score(*a, mask, interpret=True),
                       c, h, wx, wy)
    want_pallas = [np.asarray(x) for x in vjp(g)]
    _, vjp_ref = jax.vjp(lambda cc, hh, x, y: jax.vmap(
        lambda ci, hi, mi: jref.policy_score_ref(ci, hi, x, y, mi))(
            cc, hh, mask), c, h, wx, wy)
    want_ref = [np.asarray(x) for x in vjp_ref(g)]
    tc, th, twx, twy, tm, tg, tout = _t(c, h, wx, wy, mask, g, out)
    maskf = tm.to(torch.float32)
    got = design_bwd(tg, tout, tc, th, twx, twy, maskf)
    plain = ref.policy_score_bwd_torch(tg, tout, tc, th, twx, twy, maskf)
    for key, x, wp, wr, pl in zip(BWD_TOL, got, want_pallas, want_ref, plain):
        # dc's layout is (B, Q, d) in all three; the weights are summed
        for want in (wp, wr, pl.numpy()):
            assert x.shape == want.shape, key
            np.testing.assert_allclose(
                x.numpy(), want, rtol=0,
                atol=BWD_TOL[key] * max(np.abs(want).max(), 1e-30),
                err_msg=key)


def test_backward_design_at_the_training_shape():
    """B=128, Q=5, Z=50, d=256 (RLConfig's), partial masks: the design, its
    5 partials of 128 edge rows, against jax.vjp of the reference head."""
    b, q, z, d = 128, 5, 50, 256
    assert kps._row_split(b * q) == 5
    c, h, wx, wy, mask = _inputs(b, q, z, d, seed=11)
    g = np.random.default_rng(12).normal(size=(b, z, q)).astype(np.float32)
    out, vjp = jax.vjp(lambda cc, hh, x, y: jax.vmap(
        lambda ci, hi, mi: jref.policy_score_ref(ci, hi, x, y, mi))(
            cc, hh, mask), c, h, wx, wy)
    want = [np.asarray(x) for x in vjp(g)]
    tc, th, twx, twy, tm, tg, tout = _t(c, h, wx, wy, mask, g, out)
    got = design_bwd(tg, tout, tc, th, twx, twy, tm.to(torch.float32))
    for key, x, w in zip(BWD_TOL, got, want):
        np.testing.assert_allclose(
            x.numpy(), w, rtol=0,
            atol=BWD_TOL[key] * max(np.abs(w).max(), 1e-30), err_msg=key)


@pytest.mark.parametrize("n", [1, 5, 127, 128, 129, 640, 4096, 6400, 10**5])
def test_row_split_keeps_every_partial_nonempty(n):
    """B2's row split: at most 32 partials, one for up to 128 rows, at
    least 64 rows each (half the target) when there are more, and no empty
    partial."""
    split = kps._row_split(n)
    per = -(-n // split)
    assert 1 <= split <= 32 and (split - 1) * per < n
    assert split == 1 if n <= 128 else per >= 64


def test_design_constants_match_the_source():
    """The constants the design reads from the source, and the wrapper's
    mirror of the weight-gradient tile."""
    assert (ROW_KC, WARPS, BWD_ROWS) == (256, 8, 16)
    assert EDGE == EDGE_T and PX == PXY and all(
        bk % (4 * ks) == 0 for bk, ks in (EDGE, PX, WT, CT))
    assert ROW_KC % (WARPS * 8) == 0  # each warp's slice in 8-deep pieces
    # B1's small-Q plan: lane q holds edge q; the u tile keeps the staged
    # pxy^T rows 16-byte aligned; the plan and its tiles as design_score
    # takes them
    assert (FLAT_ROWS, FLAT_Q) == (16, 8) and FLAT_Q <= 32
    assert FLAT_ROWS * FLAT_Q % 4 == 0
    assert "if (Q <= kFlatQ) {" in SOURCE
    for call in ("launch_gemm<PxTile>(c, d, 0, wpx, d, 0, px, d, 0, B * Q,",
                 "launch_gemm<PxyTile>(px, d, 0, wpy, d, 0, pxy, d, 0, B * Q,",
                 "launch_gemm<EdgeTile>(c, d, 0, wpx, d, 0, px, d, 0, B * Q,",
                 "launch_gemm<EdgeTileT>(wpy, d, 0, px, d, (size_t)Q * d, pxy, "
                 "Q,"):
        assert SOURCE.count(call) == 1, call
    assert "constexpr int kWT = WTile::BM;" in SOURCE
    assert _const(r"using WTile = Tile<(\d+),") == kps.WEIGHT_TILE
    assert kps.MAX_EDGES == 128 == padded_edges(kps.MAX_EDGES)
