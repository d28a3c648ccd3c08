"""Plain PyTorch versions of the port's kernels (the allclose ground truth,
counterpart of the oracles in ``repro/kernels/ref.py``): the policy head
(B1-B3), the LM attention (B4, B5) and the mamba-1 selective scan (B6).

``*_ref`` take one instance (no batch axis); ``*_torch`` take any leading
batch shape and are what :mod:`repro_torch.kernels.ops` runs for tensors on
the CPU. On a CUDA tensor ``ops`` launches the hand-written kernels of
:mod:`repro_torch.kernels.policy_score` instead, and ``chip_smoke.py``
holds those kernels against the ``*_torch`` functions here. The B2
kernel's plain version, :func:`policy_score_bwd_torch`, is the head's
explicit backward; :func:`flash_attention_lse_torch` is that of B4's
optional log-sum-exp output, and :func:`flash_attention_bwd_torch`, the
reference's pair-scan backward, that of B4b. The attention twins
(:func:`flash_attention_torch`, :func:`decode_attention_torch`) use f32
math, the -1e30 mask, GQA by reshape, and return the input dtype, as the
reference's oracles do.
:func:`mamba_scan_torch` is B6's plain version: a sequential loop over S
in f32; :func:`mamba_scan_gated_torch` is that of B6's gated entry, the SSM
block's softplus, scan, D skip, SiLU gate and cast as plain ops, and
:func:`mamba_scan_gated_bwd_torch` that of its backward B6b.

Two options of the reference's model code are options here too. The
attention twins take ``softcap`` (the reference's ``logit_softcap``): a
cap above 0 replaces each scaled score s by ``cap * tanh(s / cap)`` before
the mask. The scan twins take ``bf16_state`` (the reference's
``ssm_scan_dtype="bfloat16"``, ``repro/models/ssm.py:74-87``): exp(dt*A)
and dt*B*u are formed in f32 and rounded to bf16 and the state is carried
in bf16, rounded where B6 rounds it (:func:`_bf16_chunks`); y is formed in
f32 from that state.

Decode contract (shared with the CUDA kernel, ``policy_score.cu``):

* top-k ties go to the lowest edge index (stable sort; ``torch.topk``
  promises no order among equal values);
* ``normalize=True`` selects on the eq-16 scores ``C*tanh(u)`` with masked
  edges at -1e9 and returns eq-17 log-probabilities;
* ``normalize=False`` selects in u-space with masked edges at -inf and
  applies ``C*tanh`` to the K winners only, as the reference's fused
  kernel does (``repro/kernels/policy_score.py:197-212``). ``tanh`` is
  monotone, so the ranking equals the reference oracle's except where
  ``tanh`` rounds two different u to the same f32 value. Slots beyond the
  number of valid edges hold masked edges in index order, valued ``-C``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last axis, in
    descending order, ties toward the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def policy_score_ref(c_emb, h_emb, w_px, w_py, edge_mask, tanh_clip=10.0):
    """Fused CoRaiS policy head (paper eqs 16-17) on one instance.

    c_emb: (Q, d) context-decoder edge embeddings; h_emb: (Z, d) request
    embeddings; edge_mask: (Q,) bool. Returns log a_qz as (Z, Q)."""
    d = c_emb.shape[-1]
    px = c_emb.float() @ w_px.float()
    py = h_emb.float() @ w_py.float()
    u = (py @ px.T) / math.sqrt(d)  # (Z, Q)
    imp = tanh_clip * torch.tanh(u)
    imp = torch.where(edge_mask[None, :], imp, -1e9)
    return torch.log_softmax(imp, dim=-1)


def policy_score_torch(c_emb, h_emb, w_px, w_py, edge_mask, tanh_clip=10.0):
    """Batched policy head over any leading batch shape: the plain version
    of the B1 kernel. c_emb: (..., Q, d); h_emb: (..., Z, d); edge_mask:
    (..., Q) or (Q,) bool. Returns (..., Z, Q) log a_qz."""
    d = c_emb.shape[-1]
    px = c_emb @ w_px
    py = h_emb @ w_py
    u = (py @ px.transpose(-1, -2)) / math.sqrt(d)
    imp = tanh_clip * torch.tanh(u)  # eq (16)
    imp = torch.where(edge_mask[..., None, :], imp, -1e9)
    return torch.log_softmax(imp, dim=-1)  # eq (17): softmax over edges


def policy_score_bwd_torch(g, out, c, h, w_px, w_py, maskf, tanh_clip=10.0):
    """The plain version of the B2 kernel: the backward of the eq 16-17 head,
    the formulas of the reference's ``_bwd_kernel``
    (``repro/kernels/policy_score.py:65-91``) written out, not autograd.

    g, out: (..., Z, Q) cotangent and saved log-probs; c: (..., Q, d);
    h: (..., Z, d); maskf: (..., Q) float, > 0.5 = real edge. Returns
    ``(dc, dh, dw_px, dw_py)`` with the weight gradients summed over the
    leading batch; the mask gets no gradient."""
    d = c.shape[-1]
    scale = 1.0 / math.sqrt(d)
    # d log_softmax: g - softmax * sum_q g (softmax = exp(saved log-probs))
    gi = g - torch.exp(out) * g.sum(-1, keepdim=True)
    px = c @ w_px
    py = h @ w_py
    th = torch.tanh((py @ px.transpose(-1, -2)) * scale)
    # masked edges saw a constant -1e9: no gradient flows through them
    keep = (maskf > 0.5)[..., None, :]
    gu = torch.where(keep, gi * (tanh_clip * scale) * (1.0 - th * th), 0.0)
    dpy = gu @ px                    # (..., Z, d)
    dpx = gu.transpose(-1, -2) @ py  # (..., Q, d)
    dc = dpx @ w_px.T
    dh = dpy @ w_py.T
    dw_px = c.reshape(-1, d).T @ dpx.reshape(-1, d)
    dw_py = h.reshape(-1, d).T @ dpy.reshape(-1, d)
    return dc, dh, dw_px, dw_py


def _decode(u, edge_mask, tanh_clip, k, normalize):
    keep = edge_mask[..., None, :]
    if normalize:
        imp = torch.where(keep, tanh_clip * torch.tanh(u), -1e9)
        top_val, top_idx = stable_topk(imp, k)
        top_val = top_val - torch.logsumexp(imp, dim=-1, keepdim=True)
    else:
        top_val, top_idx = stable_topk(torch.where(keep, u, -math.inf), k)
        top_val = tanh_clip * torch.tanh(top_val)
    return top_idx.to(torch.int32), top_val


def policy_score_decode_ref(c_emb, h_emb, w_px, w_py, edge_mask,
                            tanh_clip=10.0, k=1, normalize=True):
    """Per-instance decode oracle: materialize the (Z, Q) scores and sort.

    c_emb: (Q, d); h_emb: (Z, d); returns (top_idx int32, top_val f32),
    both (Z, K), under the decode contract in the module docstring."""
    d = c_emb.shape[-1]
    px = c_emb.float() @ w_px.float()
    py = h_emb.float() @ w_py.float()
    u = (py @ px.T) / math.sqrt(d)
    return _decode(u, edge_mask, tanh_clip, k, normalize)


def policy_score_decode_torch(c_emb, h_emb, w_px, w_py, edge_mask,
                              tanh_clip=10.0, k=1, normalize=True):
    """Batched score + top-k decode over any leading batch shape: the plain
    version of the B3 kernel. Same (top_idx, top_val) contract, (..., Z, K)."""
    d = c_emb.shape[-1]
    px = c_emb @ w_px
    py = h_emb @ w_py
    u = (py @ px.transpose(-1, -2)) / math.sqrt(d)
    return _decode(u, edge_mask, tanh_clip, k, normalize)


NEG_INF = -1e30


def _softcap(sc, softcap: float):
    """``softcap * tanh(sc / softcap)`` for a cap above 0, else ``sc``: the
    reference's ``_softcap`` (``repro/models/attention.py:32-35``)."""
    return softcap * torch.tanh(sc / softcap) if softcap > 0 else sc


def _masked_scores(q, k, causal, window, softcap=0.0):
    """The scaled scores (B, KV, G, Sq, Sk) in f32, capped (``softcap``
    above 0) and masked at -1e30; the causal and window masks compare row
    and column from the top left, as the reference's model attention does
    at Sq != Sk."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd).float()
    sc = torch.einsum("bqkgd,bmkd->bkgqm", qg, k.float()) / math.sqrt(hd)
    sc = _softcap(sc, softcap)
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return torch.where(mask, sc, NEG_INF)


def flash_attention_torch(q, k, v, *, causal=True, window=None, softcap=0.0):
    """Plain version of B4, twin of ``ref.flash_attention_ref``
    (``repro/kernels/ref.py:10``) with keys of a length of their own, as
    the reference's model attention takes them, and its logit cap. q: (B,
    Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's dtype."""
    b, s, h, hd = q.shape
    p = torch.softmax(_masked_scores(q, k, causal, window, softcap), dim=-1)
    o = torch.einsum("bkgqm,bmkd->bqkgd", p, v.float())
    return o.reshape(b, s, h, hd).to(q.dtype)


def flash_attention_lse_torch(q, k, *, causal=True, window=None,
                              softcap=0.0):
    """Plain version of B4's log-sum-exp output: each row's logsumexp of
    the same capped, masked scores as :func:`flash_attention_torch`, (B, H,
    Sq) f32."""
    b, s, h, _ = q.shape
    lse = torch.logsumexp(_masked_scores(q, k, causal, window, softcap),
                          dim=-1)
    return lse.reshape(b, h, s)


def block_pairs(nq: int, nk: int, window_chunks, causal: bool):
    """The (i, j) block pairs the pair-scan visits, in the reference's
    order: row blocks i, and for each the column blocks from the window's
    first (or 0) to i (causal) or the last."""
    pairs = []
    for i in range(nq):
        lo = 0 if window_chunks is None else max(0, i - window_chunks)
        hi = i if causal else nk - 1
        pairs.extend((i, j) for j in range(lo, hi + 1))
    return pairs


def block_mask(i, j, cq, ck, causal, window, kv_len, device):
    """(cq, ck) bool: the allowed (row, column) pairs of block (i, j)."""
    rows = i * cq + torch.arange(cq, device=device)[:, None]
    cols = j * ck + torch.arange(ck, device=device)[None, :]
    mask = (cols < kv_len).expand(cq, ck)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    return mask


def _needs_mask(causal, window, kv_len, nk, ck) -> bool:
    return causal or window is not None or kv_len != nk * ck


def flash_attention_bwd_torch(q, k, v, out, lse, dout, *, chunk: int = 512,
                              causal: bool = True, window=None,
                              softcap: float = 0.0):
    """Plain version of B4b: the reference's flash backward (``_flash_bwd``,
    ``repro/models/attention.py:166-233``) in plain PyTorch: from the
    forward's residuals q (B, Sq, H, hd), k, v (B, Sk, KV, hd), out (B, Sq,
    H, hd), lse (B, H, Sq) f32 and the cotangent dout, the gradients (dq,
    dk, dv) in the inputs' dtypes.

    As the reference (``flash_attention``, ``:236-257``): ``chunk`` capped
    at Sq, q zero-padded by Sq and k, v by Sk to the chunk grid, columns at
    or past Sk masked (``kv_len``), one pass over :func:`block_pairs`,
    scores in f32 capped (``softcap`` above 0: ``cap * tanh(s_raw / cap)``
    of the scaled score s_raw) and masked at -1e30, ``delta = rowsum(dO *
    O)``, ``p = exp(s - lse)``, ``ds = p * (dp - delta)``, times ``1 -
    tanh^2(s_raw / cap)`` under a cap, masked to 0, the scale on dq and
    dk, and dq, dk, dv summed in f32. A causal block pair past the keys'
    last block (Sq > Sk) is fully masked and skipped: the reference visits
    it on a clamped index and adds zeros. The blocks are held as (B, KV,
    rows, hd) with a block's G query heads folded into its rows, so each
    product is one batched matmul over (B, KV); padded rows carry lse 0
    and a zero cotangent, and add nothing."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    chunk = min(chunk, max(s, 1))
    pad = (-s) % chunk
    pad_k = (-sk) % chunk
    n = (s + pad) // chunk
    nk = (sk + pad_k) // chunk
    wc = None if window is None else -(-window // chunk)
    masked = _needs_mask(causal, window, sk, nk, chunk)
    scale = 1.0 / math.sqrt(hd)

    def rows(x):  # (B, Sq, H, hd) -> (B, KV, n, chunk * G, hd) f32
        x = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
        x = x.reshape(b, n * chunk, kv, g, hd).permute(0, 2, 1, 3, 4)
        return x.reshape(b, kv, n, chunk * g, hd)

    def cols(x):  # (B, Sk, KV, hd) -> (B, KV, nk, chunk, hd) f32
        x = F.pad(x.float(), (0, 0, 0, 0, 0, pad_k)).permute(0, 2, 1, 3)
        return x.reshape(b, kv, nk, chunk, hd)

    qg, og, dog = rows(q), rows(out), rows(dout)
    kg, vg = cols(k), cols(v)
    delta = (og * dog).sum(-1)  # (B, KV, n, chunk * G)
    lse_g = F.pad(lse.reshape(b, kv, g, s).permute(0, 1, 3, 2),
                  (0, 0, 0, pad)).reshape(b, kv, n, chunk * g)
    dq, dk, dv = (torch.zeros_like(x) for x in (qg, kg, vg))
    for i, j in block_pairs(n, nk, wc, causal):
        if j >= nk:
            continue
        qi, kj, vj, do_i = qg[:, :, i], kg[:, :, j], vg[:, :, j], dog[:, :, i]
        sc = (qi @ kj.transpose(-1, -2)) * scale  # (B, KV, chunk*G, chunk)
        if softcap > 0:
            th = torch.tanh(sc / softcap)
            sc = softcap * th
        if masked:
            mask = block_mask(i, j, chunk, chunk, causal, window, sk,
                              q.device).repeat_interleave(g, dim=0)
            sc = torch.where(mask, sc, NEG_INF)
        p = torch.exp(sc - lse_g[:, :, i, :, None])
        dv[:, :, j] += p.transpose(-1, -2) @ do_i
        dp = do_i @ vj.transpose(-1, -2)
        ds = p * (dp - delta[:, :, i, :, None])
        if softcap > 0:
            ds = ds * (1.0 - torch.square(th))
        if masked:
            ds = torch.where(mask, ds, 0.0)
        dq[:, :, i] += (ds @ kj) * scale
        dk[:, :, j] += (ds.transpose(-1, -2) @ qi) * scale
    dq = dq.reshape(b, kv, n * chunk, g, hd).permute(0, 2, 1, 3, 4)
    dq = dq.reshape(b, n * chunk, h, hd)[:, :s]

    def unpack(x):  # (B, KV, nk, chunk, hd) -> (B, Sk, KV, hd)
        return x.reshape(b, kv, nk * chunk, hd).permute(0, 2, 1, 3)[:, :sk]

    return (dq.to(q.dtype), unpack(dk).to(k.dtype), unpack(dv).to(v.dtype))


def _decode_scores(q, k_cache, slot_pos, pos, window, softcap=0.0):
    """(B, KV, G, W) f32 scores of one query row per lane against its
    cache, capped (``softcap`` above 0), invalid slots at -1e30."""
    b, w, kv, hd = k_cache.shape
    h = q.shape[1]
    qg = q.reshape(b, kv, h // kv, hd).float()
    sc = torch.einsum("bkgd,bmkd->bkgm", qg, k_cache.float()) / math.sqrt(hd)
    sc = _softcap(sc, softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window is not None:
        valid &= slot_pos > (pos[:, None] - window)
    return torch.where(valid[:, None, None, :], sc, NEG_INF)


def decode_attention_torch(q, k_cache, v_cache, slot_pos, pos, *,
                           window=None, softcap=0.0):
    """Plain version of B5, twin of ``ref.decode_attention_ref``
    (``repro/kernels/ref.py:30``) with the reference's logit cap. q: (B, H,
    hd); k/v_cache: (B, W, KV, hd); slot_pos: (B, W) absolute position per
    slot (-1 = empty); pos: (B,) -> (B, H, hd) in q's dtype."""
    p = torch.softmax(_decode_scores(q, k_cache, slot_pos, pos, window,
                                     softcap), dim=-1)
    o = torch.einsum("bkgm,bmkd->bkgd", p, v_cache.float())
    return o.reshape(q.shape).to(q.dtype)


def decode_attention_lse_torch(q, k_cache, slot_pos, pos, *, window=None,
                               softcap=0.0):
    """Plain version of B5's log-sum-exp output: each (lane, head)'s
    ``torch.logsumexp`` of the same capped, masked scores as
    :func:`decode_attention_torch`, (B, H) f32; a lane with no valid slot
    gives the log-sum-exp of W scores of -1e30."""
    sc = _decode_scores(q, k_cache, slot_pos, pos, window, softcap)
    return torch.logsumexp(sc, dim=-1).reshape(q.shape[:2])


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16 value (ties to even), kept f32."""
    return x.to(torch.bfloat16).float()


#: B6's plan (``csrc/mamba_scan.cu``'s kSegments, kSegLen): a chunk of
#: BF16_SEGMENTS segments of BF16_SEG_LEN steps, where the bf16 state is
#: rounded
BF16_SEGMENTS, BF16_SEG_LEN = 8, 16


def _bf16_chunks(u, dt, B_mat, A, h):
    """The selective scan with the bf16 state, at B6's rounding points, from
    ``h`` (B, d, N), bf16 values in f32. Yields, for each chunk of
    BF16_SEGMENTS * BF16_SEG_LEN steps in order, (t0, rows, a, hs, h):
    the chunk's first step, its steps, exp(dt*A) rounded to bf16 and the
    state after each step, both (B, rows, d, N), and the state it hands on
    (B, d, N), all f32 holding bf16 values.

    Within a chunk, as B6 computes it: a = bf16(exp(dt*A)) and b =
    bf16(dt*B*u) per step; each segment of BF16_SEG_LEN steps composes its
    (decay, value) pair in f32 (the decay the product of its a, as the
    reference multiplies its bf16 decays); an inclusive Hillis-Steele
    combine over the segments in f32; the state entering a segment is the
    exclusive prefix applied to the chunk's entering state, rounded to
    bf16; then each step's ``a*h + b`` is rounded to bf16. One rounding of
    the state per step of a sequential walk would drift by several % where
    the decays round to 1 (dt near 1e-3): bf16 drops the small b's added
    to a large h; this walk restarts from the composition every segment.
    Rows past S in the last chunk are identity steps: the state handed on
    is the last segment's, which there starts from the composition, as
    B6's h_last does."""
    b, s, d = u.shape
    n = A.shape[-1]
    p, seg = BF16_SEGMENTS, BF16_SEG_LEN
    chunk = p * seg
    for t0 in range(0, s, chunk):
        rows = min(chunk, s - t0)

        def tile(x):
            out = x.new_zeros((b, chunk) + tuple(x.shape[2:]))
            out[:, :rows] = x[:, t0:t0 + rows]
            return out

        dd, uu, bb = tile(dt), tile(u), tile(B_mat)
        ea = bf16_round(torch.exp(dd[..., None] * A)).reshape(b, p, seg, d,
                                                                n)
        eb = bf16_round(dd[..., None] * bb[:, :, None, :]
                        * uu[..., None]).reshape(b, p, seg, d, n)
        ac = ea[:, :, 0]
        bc = eb[:, :, 0]
        for i in range(1, seg):
            ac = ac * ea[:, :, i]
            bc = ea[:, :, i] * bc + eb[:, :, i]
        off = 1
        while off < p:  # the inclusive combine, lowest segment first
            bc = torch.cat([bc[:, :off],
                            ac[:, off:] * bc[:, :-off] + bc[:, off:]], 1)
            ac = torch.cat([ac[:, :off], ac[:, off:] * ac[:, :-off]], 1)
            off *= 2
        x = torch.cat([h[:, None], bf16_round(ac[:, :-1] * h[:, None]
                                              + bc[:, :-1])], 1)
        hs = torch.empty((b, p, seg, d, n), dtype=torch.float32,
                         device=u.device)
        for i in range(seg):
            x = bf16_round(ea[:, :, i] * x + eb[:, :, i])
            hs[:, :, i] = x
        h = x[:, p - 1]
        yield (t0, rows, ea.reshape(b, chunk, d, n)[:, :rows],
               hs.reshape(b, chunk, d, n)[:, :rows], h)


def _bf16_scan(u, dt, B_mat, C_mat, A, h0, chunk):
    """:func:`mamba_scan_torch` with ``bf16_state``: (y, h_last) or, with
    ``chunk``, also the state entering each ``chunk`` steps."""
    b, s, d = u.shape
    n = A.shape[-1]
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=u.device)
         if h0 is None else bf16_round(h0.float()))
    ys = torch.empty((b, s, d), dtype=torch.float32, device=u.device)
    if chunk is not None:
        states = torch.empty((b, -(-s // chunk), d, n), dtype=torch.float32,
                             device=u.device)
    for t0, rows, _, hs, h_end in _bf16_chunks(u, dt, B_mat, A, h):
        if chunk is not None:
            for t in range(t0, t0 + rows):
                if t % chunk == 0:
                    states[:, t // chunk] = h if t == t0 else hs[:, t - t0 - 1]
        ys[:, t0:t0 + rows] = (hs * C_mat[:, t0:t0 + rows, None, :]).sum(-1)
        h = h_end
    return (ys, h) if chunk is None else (ys, h, states)


def mamba_scan_torch(u, dt, B_mat, C_mat, A, h0=None, chunk=None,
                     bf16_state=False):
    """Plain version of B6, twin of ``ref.mamba_scan_ref``
    (``repro/kernels/ref.py:46``): a sequential loop over S in f32, from
    ``h0`` (B, d, N) or zeros. u, dt: (B, S, d); B_mat, C_mat: (B, S, N);
    A: (d, N). Returns (y (B, S, d) f32, h_last (B, d, N) f32), and with
    ``chunk`` also the state entering each ``chunk`` steps, (B, ceil(S /
    chunk), d, N) f32, what B6's gated entry stores for B6b.

    The reference discretises all S steps up front, a (B, S, d, N) tensor;
    here each step's ``exp(dt * A)`` and ``dt * B * u`` are formed inside
    the loop, with the same elementwise roundings. With ``bf16_state``
    both are rounded to bf16 and the state (``h0`` too) is carried in
    bf16, rounded where B6 rounds it (:func:`_bf16_chunks`); h_last and
    the chunk states hold those bf16 values in f32."""
    b, s, d = u.shape
    n = A.shape[-1]
    u, dt, B_mat, C_mat, A = (t.float() for t in (u, dt, B_mat, C_mat, A))
    if bf16_state:
        return _bf16_scan(u, dt, B_mat, C_mat, A, h0, chunk)
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = torch.empty((b, s, d), dtype=torch.float32, device=u.device)
    if chunk is not None:
        states = torch.empty((b, -(-s // chunk), d, n), dtype=torch.float32,
                             device=u.device)
    for t in range(s):
        if chunk is not None and t % chunk == 0:
            states[:, t // chunk] = h
        dt_t = dt[:, t, :, None]
        dbu = dt_t * B_mat[:, t, None, :] * u[:, t, :, None]
        h = torch.exp(dt_t * A) * h + dbu
        ys[:, t] = (h * C_mat[:, t, None, :]).sum(-1)
    return (ys, h) if chunk is None else (ys, h, states)


def mamba_scan_gated_torch(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z,
                           chunk=None, bf16_state=False):
    """Plain version of B6's gated entry: the tail of the reference's
    ``ssm_apply`` (``repro/models/ssm.py:114-120``) as its own ops, in its
    order: dt = softplus(dt_raw + dt_bias), :func:`mamba_scan_torch`,
    y + D*u, times silu(z) in f32, cast to z's dtype. Returns (out (B, S, d)
    in z's dtype, h_last (B, d, N) f32), and with ``chunk`` also the states
    entering each chunk (:func:`mamba_scan_torch`, whose ``bf16_state`` it
    passes on: the skip and the gate stay f32)."""
    dt = F.softplus(dt_raw + dt_bias)
    # the scan's call names only the options set, as callers that wrap it
    # expect it
    kw = {} if chunk is None else {"chunk": chunk}
    if bf16_state:
        kw["bf16_state"] = True
    y, h_last, *states = mamba_scan_torch(u, dt, B_mat, C_mat, A, **kw)
    y = y + D * u
    y = y * F.silu(z.float())
    return (y.to(z.dtype), h_last, *states)


def mamba_scan_gated_bwd_torch(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z,
                               dout, dh_last=None, bf16_state=False):
    """Plain version of B6b, the backward of B6's gated entry
    (:func:`mamba_scan_gated_torch`), written out as a reverse loop over S
    in f32, not autograd. dout (B, S, d) is the gradient of ``out`` (in z's
    dtype), ``dh_last`` (B, d, N) that of ``h_last`` or None (zero).

    The forward's states h_t (B, S, d, N) are recomputed from zero; then the
    adjoint ``g_t = C_t * dy_t + exp(dt_{t+1} A) * g_{t+1}`` (seeded with
    ``dh_last``) runs backwards, where dy = dout * silu(z) is the gradient of
    y + D*u. With a_t = exp(dt_t A) and h_{-1} = 0, step t gives
    du_t = dt_t sum_n g_t B_t + D dy_t,
    ddt_t = sum_n g_t A a_t h_{t-1} + u_t sum_n g_t B_t,
    dB_t = sum_c g_t dt_t u_t, dC_t = sum_c dy_t h_t and
    dA += g_t dt_t a_t h_{t-1}; dt_raw's gradient is ddt times softplus's
    derivative, F.softplus's rule: 1 where dt_raw + dt_bias is above 20,
    else its sigmoid. Returns (du, d dt_raw, d dt_bias, dB, dC, dA, dD, dz),
    f32 but dz in z's dtype.

    With ``bf16_state`` the states are recomputed as the bf16 forward forms
    them (:func:`_bf16_chunks`), and a_t is exp(dt_t A) rounded to bf16
    wherever the formulas above read it; the arithmetic stays f32."""
    b, s, d = u.shape
    n = A.shape[-1]
    u, dt_raw, B_mat, C_mat, A = (t.float() for t in (u, dt_raw, B_mat,
                                                      C_mat, A))
    x = dt_raw + dt_bias
    dt = F.softplus(x)
    hs = torch.empty((b, s, d, n), dtype=torch.float32, device=u.device)
    h = torch.zeros((b, d, n), dtype=torch.float32, device=u.device)
    if bf16_state:
        decay = torch.empty_like(hs)
        for t0, rows, a, h_steps, _ in _bf16_chunks(u, dt, B_mat, A, h):
            decay[:, t0:t0 + rows] = a
            hs[:, t0:t0 + rows] = h_steps
    for t in range(0 if bf16_state else s):
        dt_t = dt[:, t, :, None]
        h = torch.exp(dt_t * A) * h + dt_t * B_mat[:, t, None, :] * u[:, t, :,
                                                                      None]
        hs[:, t] = h
    y = (hs * C_mat[:, :, None, :]).sum(-1) + D * u
    zf, do = z.float(), dout.float()
    sig = torch.sigmoid(zf)
    dy = do * (zf * sig)
    dz = (do * y * sig * (1 + zf * (1 - sig))).to(z.dtype)
    g = (torch.zeros((b, d, n), dtype=torch.float32, device=u.device)
         if dh_last is None else dh_last.float())
    du = torch.empty_like(u)
    ddt = torch.empty_like(u)
    dB = torch.empty((b, s, n), dtype=torch.float32, device=u.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros((d, n), dtype=torch.float32, device=u.device)
    zero = torch.zeros_like(h)
    for t in range(s - 1, -1, -1):
        dt_t = dt[:, t, :, None]
        g = g + C_mat[:, t, None, :] * dy[:, t, :, None]
        a = decay[:, t] if bf16_state else torch.exp(dt_t * A)
        q = g * a * (hs[:, t - 1] if t else zero)
        gb = (g * B_mat[:, t, None, :]).sum(-1)
        du[:, t] = dt[:, t] * gb
        ddt[:, t] = (q * A).sum(-1) + u[:, t] * gb
        dA += (q * dt_t).sum(0)
        dB[:, t] = (g * (dt[:, t] * u[:, t])[..., None]).sum(1)
        dC[:, t] = (hs[:, t] * dy[:, t, :, None]).sum(1)
        g = a * g
    du = du + D * dy
    dx = torch.where(x > 20, ddt, ddt * torch.sigmoid(x))
    return (du, dx, dx.sum((0, 1)), dB, dC, dA, (dy * u).sum((0, 1)), dz)
