"""Attention of the LM layers (counterpart of ``repro/models/attention.py``).

The reference computes prefill attention with a pure-jnp pair-scan flash
formulation and decode attention with a masked softmax; its Pallas kernels
B4 and B5 compute the same two functions for the TPU. Here both go through
:mod:`repro_torch.kernels.ops`: on a CUDA tensor the hand-written kernels
B4 (``flash_attention``) and B5 (``decode_attention``) run, on a CPU tensor
their plain versions. Layouts are the reference's: q (B, S, H, hd) and
k, v (B, Sk, KV, hd) for prefill, Sk the queries' S or (whisper's cross
attention) a length of its own; q (B, H, hd) and a (B, W, KV, hd) cache for
decode. The one-token cross attention of whisper's decode step over its
encoder frames is B5's shape too (:func:`cross_decode_attention`).

Training differentiates the full-sequence attention with the reference's
flash backward (``_flash_bwd``): :func:`flash_bwd` is that pair-scan over
the (i, j) blocks of ``chunk`` rows, in plain PyTorch, fed by B4's
log-sum-exp through :class:`repro_torch.kernels.ops.FlashAttention`.

Not ported yet: logit soft-capping (no config sets it, and neither Pallas
kernel has it) and ``sharded_decode_attention`` (ROADMAP A4).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import NEG_INF


def _no_softcap(logit_softcap: float) -> None:
    if logit_softcap:
        raise NotImplementedError(
            "logit soft-capping is not ported: no config sets it and neither "
            "attention kernel (B4, B5) implements it")


def naive_attention(q, k, v, *, causal=True, window=None, logit_softcap=0.0):
    """Reference O(S^2)-memory attention in plain PyTorch, f32 math (B4's
    plain version, on any device). q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd)
    -> (B, Sq, H, hd) in q's dtype."""
    _no_softcap(logit_softcap)
    return ref.flash_attention_torch(q, k, v, causal=causal, window=window)


def _block_pairs(nq: int, nk: int, window_chunks, causal: bool):
    """The (i, j) block pairs the pair-scan visits, in the reference's
    order: row blocks i, and for each the column blocks from the window's
    first (or 0) to i (causal) or the last."""
    pairs = []
    for i in range(nq):
        lo = 0 if window_chunks is None else max(0, i - window_chunks)
        hi = i if causal else nk - 1
        pairs.extend((i, j) for j in range(lo, hi + 1))
    return pairs


def _block_mask(i, j, cq, ck, causal, window, kv_len, device):
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


def flash_bwd(q, k, v, out, lse, dout, *, chunk: int, causal: bool = True,
              window=None):
    """The reference's flash backward (``_flash_bwd``,
    ``repro/models/attention.py:166-233``) in plain PyTorch: from the
    forward's residuals q (B, Sq, H, hd), k, v (B, Sk, KV, hd), out (B, Sq,
    H, hd), lse (B, H, Sq) f32 and the cotangent dout, the gradients (dq,
    dk, dv) in the inputs' dtypes.

    As the reference (``flash_attention``, ``:236-257``): ``chunk`` capped
    at Sq, q zero-padded by Sq and k, v by Sk to the chunk grid, columns at
    or past Sk masked (``kv_len``), one pass over :func:`_block_pairs`,
    scores in f32 masked at -1e30, ``delta = rowsum(dO * O)``, ``p = exp(s
    - lse)``, ``ds = p * (dp - delta)`` masked to 0, the scale on dq and
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
    for i, j in _block_pairs(n, nk, wc, causal):
        if j >= nk:
            continue
        qi, kj, vj, do_i = qg[:, :, i], kg[:, :, j], vg[:, :, j], dog[:, :, i]
        sc = (qi @ kj.transpose(-1, -2)) * scale  # (B, KV, chunk*G, chunk)
        if masked:
            mask = _block_mask(i, j, chunk, chunk, causal, window, sk,
                               q.device).repeat_interleave(g, dim=0)
            sc = torch.where(mask, sc, NEG_INF)
        p = torch.exp(sc - lse_g[:, :, i, :, None])
        dv[:, :, j] += p.transpose(-1, -2) @ do_i
        dp = do_i @ vj.transpose(-1, -2)
        ds = p * (dp - delta[:, :, i, :, None])
        if masked:
            ds = torch.where(mask, ds, 0.0)
        dq[:, :, i] += (ds @ kj) * scale
        dk[:, :, j] += (ds.transpose(-1, -2) @ qi) * scale
    dq = dq.reshape(b, kv, n * chunk, g, hd).permute(0, 2, 1, 3, 4)
    dq = dq.reshape(b, n * chunk, h, hd)[:, :s]

    def unpack(x):  # (B, KV, nk, chunk, hd) -> (B, Sk, KV, hd)
        return x.reshape(b, kv, nk * chunk, hd).permute(0, 2, 1, 3)[:, :sk]

    return (dq.to(q.dtype), unpack(dk).to(k.dtype), unpack(dv).to(v.dtype))


def flash_attention(q, k, v, *, chunk: int = 512, causal: bool = True,
                    window=None, logit_softcap: float = 0.0):
    """Full-sequence (prefill and training) attention through B4. q:
    (B, Sq, H, hd); k, v: (B, Sk, KV, hd), H a multiple of KV, any Sq and
    Sk (the masks aligned at the top left). Its gradient is
    :func:`flash_bwd` over ``chunk``-row blocks."""
    _no_softcap(logit_softcap)
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               chunk=chunk)


def cross_decode_attention(q, k, v):
    """One query row per sequence against all of its Sk keys, no mask:
    whisper's decode-step cross attention over the encoder frames. q: (B,
    1, H, hd); k, v: (B, Sk, KV, hd) -> (B, 1, H, hd).

    The reference runs ``naive_attention`` here
    (``repro/models/layers.py:117-118``), which is B4's plain version. On a
    CUDA tensor it goes through B5 instead, the kernel of one query row
    against many slots: a slot map of the frames (``slot_pos`` = 0..Sk-1,
    made on the card) and the query at position Sk - 1 make every frame
    valid, which is the unmasked attention. On a CPU tensor it is the
    plain ``naive_attention``."""
    if ops._device_type(q) == "cpu":
        return naive_attention(q, k, v, causal=False)
    b, sk = k.shape[0], k.shape[1]
    slot_pos = torch.arange(sk, dtype=torch.int32,
                            device=q.device).expand(b, sk).contiguous()
    pos = torch.full((b,), sk - 1, dtype=torch.int32, device=q.device)
    return ops.decode_attention(q[:, 0], k, v, slot_pos, pos,
                                window=None)[:, None]


def decode_attention(q, k_cache, v_cache, cache_positions, pos, *,
                     logit_softcap: float = 0.0, window=None):
    """Single-token attention against a (possibly rolling) KV cache, through
    B5. q: (B, H, hd); k_cache, v_cache: (B, W, KV, hd); cache_positions:
    (B, W) int32, the absolute position in each slot (-1 = empty); pos:
    (B,) int32, the query token's absolute position."""
    _no_softcap(logit_softcap)
    return ops.decode_attention(q, k_cache, v_cache, cache_positions, pos,
                                window=window)
