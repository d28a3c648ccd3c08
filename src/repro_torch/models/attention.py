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
flash backward (``_flash_bwd``) through
:class:`repro_torch.kernels.ops.FlashAttention`, fed by B4's log-sum-exp:
on a CUDA tensor the hand-written kernel B4b (``flash_attention_bwd``), on
a CPU tensor its plain version :func:`flash_bwd`, that pair-scan over the
(i, j) blocks of ``chunk`` rows in plain PyTorch.

On a mesh, :func:`sharded_decode_attention` is the reference's flash-decode
over a cache whose slot axis is split over the tensor-parallel axis: B5
with its log-sum-exp on each rank's block of slots, the blocks combined in
f32 with the reference's three collectives. :func:`write_slot` writes a
decode step's new row into a cache split that way.

Logit soft-capping (``logit_softcap``, the reference's ``_softcap``,
``repro/models/attention.py:32-35``): a cap above 0 replaces each scaled
score s by ``cap * tanh(s / cap)`` before the mask, in every path here:
inside B4, B5 and B4b on the card, in their plain versions on the CPU
(:func:`flash_bwd` among them), whose ``ds`` carries the factor ``1 -
tanh^2(s / cap)``. The layers pass ``cfg.attn_logit_softcap`` to self attention;
cross attention stays uncapped, as the reference's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.kernels import ops, ref
from repro_torch.sharding.ctx import current


def naive_attention(q, k, v, *, causal=True, window=None, logit_softcap=0.0):
    """Reference O(S^2)-memory attention in plain PyTorch, f32 math (B4's
    plain version, on any device). q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd)
    -> (B, Sq, H, hd) in q's dtype; ``logit_softcap`` above 0 caps the
    scaled scores."""
    return ref.flash_attention_torch(q, k, v, causal=causal, window=window,
                                     softcap=logit_softcap)


#: The reference's flash backward in plain PyTorch (B4b's plain version,
#: :func:`repro_torch.kernels.ref.flash_attention_bwd_torch`), with the
#: block helpers of its pair-scan, under the names the reference gives them.
flash_bwd = ref.flash_attention_bwd_torch
_block_pairs = ref.block_pairs
_block_mask = ref.block_mask


def flash_attention(q, k, v, *, chunk: int = 512, causal: bool = True,
                    window=None, logit_softcap: float = 0.0):
    """Full-sequence (prefill and training) attention through B4. q:
    (B, Sq, H, hd); k, v: (B, Sk, KV, hd), H a multiple of KV, any Sq and
    Sk (the masks aligned at the top left); ``logit_softcap`` above 0
    caps the scaled scores. Its gradient is B4b on the card and
    :func:`flash_bwd` over ``chunk``-row blocks on the CPU."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               chunk=chunk, softcap=logit_softcap)


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
    (B,) int32, the query token's absolute position. ``logit_softcap``
    above 0 caps the scaled scores."""
    return ops.decode_attention(q, k_cache, v_cache, cache_positions, pos,
                                window=window, softcap=logit_softcap)


def combine_partials(o, lse, group):
    """The ranks' partial attentions over disjoint blocks of slots, o (B,
    H, hd) with their log-sum-exps lse (B, H) f32, combined over ``group``
    in f32: the max of the lse, then the sums of the rescaled numerator and
    of the denominator (three all-reduces, in that order). A block with no
    valid slot carries lse -1e30 and weighs 0 beside one with a valid slot;
    when no block has one, all weigh alike and the result is the mean of
    every value row, as the reference's."""
    m = lse.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse - m)
    num = o.float() * w[..., None]
    dist.all_reduce(num, group=group)
    dist.all_reduce(w, group=group)
    return (num / torch.clamp(w, min=1e-30)[..., None]).to(o.dtype)


def _on_slot_blocks(site, local, ctx, q, k_cache, v_cache, cache_positions,
                    pos):
    """``local`` on each rank's block: its lanes of q and pos, its lanes
    and its block of slots (over ``ctx.tp_axis``) of the caches and the
    slot positions; the output split over the lanes only."""
    dp = ctx.dp or ()
    roles = tuple("batch" if n in dp else "slots" if n == ctx.tp_axis
                  else None for n in ctx.mesh.mesh_dim_names)
    row, blocks = {"batch": 0}, {"batch": 0, "slots": 1}
    return ops.run_on_blocks(
        site, local, ctx.mesh, roles,
        [(q, row), (k_cache, blocks), (v_cache, blocks),
         (cache_positions, blocks), (pos, row)], row)


def sharded_decode_attention(q, k_cache, v_cache, cache_positions, pos, *,
                             window=None, logit_softcap: float = 0.0,
                             ctx=None):
    """Flash-decode over a sequence-sharded KV cache (the reference's
    ``sharded_decode_attention``, ``repro/models/attention.py:260-310``).

    The cache's slot axis W is split over ``ctx.tp_axis`` and the batch
    over ``ctx.dp``; each rank runs B5 with its log-sum-exp on its block
    of slots (its plain version on the CPU), the scores capped there
    where ``logit_softcap`` is above 0, and :func:`combine_partials` joins
    the blocks. Where the axis does not divide W, this is
    :func:`decode_attention` (the reference's fallback). Inputs and output
    are DTensors; q (B, H, hd), the caches (B, W, KV, hd), cache_positions
    (B, W), pos (B,) -> (B, H, hd), split over the batch only."""
    if ctx is None:
        ctx = current()
    mesh, tp = ctx.mesh, ctx.tp_axis
    if tp is None or k_cache.shape[1] % mesh.size(
            mesh.mesh_dim_names.index(tp)) != 0:
        return decode_attention(q, k_cache, v_cache, cache_positions, pos,
                                logit_softcap=logit_softcap, window=window)
    group = mesh.get_group(tp)

    def local(q, kc, vc, sp, p):
        o, lse = ops.decode_attention(q, kc, vc, sp, p, window=window,
                                      with_lse=True, softcap=logit_softcap)
        return combine_partials(o, lse, group)

    return _on_slot_blocks("flash_decode", local, ctx, q, k_cache, v_cache,
                           cache_positions, pos)


def sharded_decode_attention_torch(q, k_cache, v_cache, cache_positions,
                                   pos, *, window=None, logit_softcap=0.0,
                                   ctx=None):
    """Plain version of :func:`sharded_decode_attention`: the reference's
    ``local`` body (``repro/models/attention.py:286-302``) in PyTorch on
    each rank's block, f32 scores capped (``logit_softcap`` above 0) and
    masked at -1e30, the max of the local maxima, then the sums of the
    exponentials and of their products with V, over ``ctx.tp_axis``."""
    if ctx is None:
        ctx = current()
    group = ctx.mesh.get_group(ctx.tp_axis)

    def local(q, kc, vc, sp, p):
        sc = ref._decode_scores(q, kc, sp, p, window,
                                logit_softcap)             # (b, KV, G, w)
        m = sc.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(sc - m[..., None])
        denom = e.sum(-1)
        dist.all_reduce(denom, group=group)
        num = torch.einsum("bkgm,bmkd->bkgd", e, vc.float())
        dist.all_reduce(num, group=group)
        out = num / torch.clamp(denom, min=1e-30)[..., None]
        return out.reshape(q.shape).to(q.dtype)

    return _on_slot_blocks("flash_decode_plain", local, ctx, q, k_cache,
                           v_cache, cache_positions, pos)


def write_slot(cache, slot, row) -> None:
    """``cache[b, slot[b]] = row[b]`` for every lane b, in place: cache
    (B, W, ...), slot (B,) int64, row (B, ...). A DTensor cache may split
    its batch and its slot axis W: each rank writes the rows whose slot
    falls in its block (a masked write: no host read)."""
    b = cache.shape[0]
    if not isinstance(cache, DTensor):
        cache[torch.arange(b, device=cache.device), slot] = row
        return
    mesh = cache.device_mesh
    pl = tuple(cache.placements)
    if any(p not in (Shard(0), Shard(1), Replicate()) for p in pl):
        raise ValueError(f"a cache on {pl} cannot take a slot write")
    lane_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)
    row_l = ops.to_placements(row, mesh, lane_pl, "cache_write").to_local()
    slot_l = ops.to_placements(slot, mesh, lane_pl,
                               "cache_write").to_local()
    local = cache.to_local()
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    n = local.shape[1]
    rel = slot_l - offset[1]
    inside = (rel >= 0) & (rel < n)
    idx = torch.clamp(rel, 0, n - 1)
    lanes = torch.arange(local.shape[0], device=local.device)
    keep = local[lanes, idx]
    mask = inside.reshape(-1, *(1,) * (keep.ndim - 1))
    local[lanes, idx] = torch.where(mask, row_l.to(local.dtype), keep)
