"""B5: hand-written CUDA decode attention (``csrc/decode_attention.cu``).

Replaces the Pallas ``_kernel`` of ``repro/kernels/decode_attention.py:25``:
one query token per sequence over a (possibly rolling) KV cache, the G
query heads of a KV head sharing each cache read, slot validity from
``slot_pos`` and ``pos`` evaluated in the kernel. It splits W over many
blocks (split-W flash-decode) and combines their partial softmaxes in the
same launch; :func:`split_plan` chooses the splits. With ``with_lse`` it
also writes each row's log-sum-exp (the flash-decode over a
sequence-sharded cache combines ranks with it). A ``softcap`` above 0 caps
the scaled scores as B4 does (the reference's ``logit_softcap``). The
source's header note
says what bounds it on the H100 and what its design does about that.

:func:`decode_attention_cuda` takes CUDA tensors only; its plain version is
:func:`repro_torch.kernels.ref.decode_attention_torch`. Both are the
kernels of two ``torch.library`` ops, ``repro_torch::decode_attention`` and
``repro_torch::decode_attention_lse`` (with the log-sum-exp), dispatched
by the tensors' device, with fake implementations and
:func:`repro_torch.kernels.counts.decode_attention_counts`'s FLOP formula
(a filled cache: the slots' validity is data); as for B4
(:mod:`~repro_torch.kernels.flash_attention`).
:func:`repro_torch.kernels.ops.decode_attention` calls them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref
from repro_torch.kernels.build import (LAUNCHES, check_tensor, load,
                                       raise_on)
from repro_torch.kernels.counts import decode_attention_counts
from repro_torch.kernels.flash_attention import (DTYPES, MAX_HEAD_DIM,
                                                 check_vector_loads,
                                                 softcap_arg, window_arg)

#: G * hd: the query heads of one KV head times the head width.
MAX_GROUP_WIDTH = 2048
#: Cache slots per tile; a split owns whole tiles (the kernel's kBW).
TILE = 64
#: Tiles one split may own: the kernel keeps a validity flag per slot of
#: its split in shared memory (kMaxTilesPerSplit).
MAX_TILES_PER_SPLIT = 64
#: Blocks per SM the split plan aims at, and the floor it keeps where W
#: allows. On an H100, splits of 2 to 4 tiles beat longer ones, and
#: one-tile splits cost more in set-up than they hide (the split sweep of
#: ``chip_smoke.py``; PERF.md section 6).
BLOCKS_PER_SM = 4
MIN_BLOCKS_PER_SM = 2

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"corais_decode_attention":
               [_P] * 9 + [_I] * 6 + [_F, _F] + [_I] * 3 + [_P]}
_COUNTERS: dict[tuple[torch.device, int], torch.Tensor] = {}


def split_plan(w: int, b: int, kv: int, sm_count: int) -> tuple[int, int]:
    """(splits, tiles per split) of B5's grid (splits, KV, B) over a cache
    of ``w`` slots: every split owns whole 64-slot tiles, at most
    MAX_TILES_PER_SPLIT; none is empty (the last owns at least one tile);
    the grid aims at BLOCKS_PER_SM * ``sm_count`` blocks and has at least
    MIN_BLOCKS_PER_SM * ``sm_count`` wherever W has that many tiles per
    (lane, KV head); a split owns two tiles or more where that floor
    allows."""
    tiles = -(-w // TILE)
    pairs = b * kv
    want = -(-BLOCKS_PER_SM * sm_count // pairs)  # splits per pair
    per = max(1, min(tiles // want, MAX_TILES_PER_SPLIT))
    if per == 1 and -(-tiles // 2) * pairs >= MIN_BLOCKS_PER_SM * sm_count:
        per = 2
    return -(-tiles // per), per


def check_plan(w: int, splits: int, per: int) -> None:
    """Raises ValueError unless ``splits`` splits of ``per`` tiles cover a
    cache of ``w`` slots in whole 64-slot tiles with no split empty and at
    most MAX_TILES_PER_SPLIT tiles a split (what the kernel takes)."""
    if not (splits >= 1 and 1 <= per <= MAX_TILES_PER_SPLIT
            and (splits - 1) * per * TILE < w <= splits * per * TILE):
        raise ValueError(f"split plan ({splits}, {per}) does not cover W={w} "
                         f"in splits of 1 to {MAX_TILES_PER_SPLIT} "
                         f"{TILE}-slot tiles with none empty")


def split_ranges(w: int, per: int) -> list[tuple[int, int]]:
    """The slot range [start, end) of each split of ``per`` tiles, in split
    order, as the kernel computes them."""
    return [(s, min(s + per * TILE, w)) for s in range(0, w, per * TILE)]


def _counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The (lane, KV head) counters for the in-launch combine: int32,
    zeroed once; every launch leaves them 0. One buffer per (card, stream):
    the launches that share it run one after another on their stream, and
    launches on two streams never share one."""
    buf = _COUNTERS.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[(dev, stream)] = buf
    return buf


def decode_attention_cuda(q, k_cache, v_cache, slot_pos, pos, *, window=None,
                          plan=None, with_lse=False, softcap: float = 0.0):
    """B5: q (B, H, hd); k_cache, v_cache (B, W, KV, hd), all f32 or all
    bf16, 16-byte aligned; slot_pos (B, W) int32 (-1 = empty); pos (B,)
    int32; contiguous, on one card; H a multiple of KV, hd <= 128 and a
    multiple of 8 (bf16) or 4 (f32), (H / KV) * hd <= 2048. ``plan``,
    (splits, tiles per split), replaces :func:`split_plan`'s choice (see
    :func:`check_plan`). ``softcap`` above 0 caps the scaled scores at
    ``softcap * tanh(s / softcap)`` before the mask (0: none). Returns (B,
    H, hd) in q's dtype, and with ``with_lse`` also each (lane, head)'s
    log-sum-exp of its capped, masked scores, (B, H) f32 (-1e30 for a lane
    with no valid slot)."""
    win = window_arg(window)
    cap = softcap_arg(softcap)
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError("q must be (B, H, hd) and the caches (B, W, KV, hd)")
    b, h, hd = q.shape
    w, kv = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if not (b >= 1 and w >= 1 and kv >= 1 and h % kv == 0
            and 1 <= hd <= MAX_HEAD_DIM and h // kv * hd <= MAX_GROUP_WIDTH):
        raise ValueError(f"unsupported shape B={b} W={w} H={h} KV={kv} "
                         f"hd={hd}: the kernel takes H % KV == 0, "
                         f"1 <= hd <= {MAX_HEAD_DIM} and "
                         f"(H / KV) * hd <= {MAX_GROUP_WIDTH}")
    dev = q.device
    check_tensor("q", q, (b, h, hd), q.dtype, dev)
    check_tensor("k_cache", k_cache, (b, w, kv, hd), q.dtype, dev)
    check_tensor("v_cache", v_cache, (b, w, kv, hd), q.dtype, dev)
    check_tensor("slot_pos", slot_pos, (b, w), torch.int32, dev)
    check_tensor("pos", pos, (b,), torch.int32, dev)
    check_vector_loads(hd, q.dtype, k_cache=k_cache, v_cache=v_cache)
    lib = load("decode_attention.cu", _SIGNATURES)
    if plan is None:
        plan = split_plan(w, b, kv, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    splits, per = plan
    check_plan(w, splits, per)
    g = h // kv
    out = torch.empty_like(q)
    lse = (torch.empty((b, h), dtype=torch.float32, device=dev)
           if with_lse else None)
    part = torch.empty(b * kv * splits * (g * hd + 2 * g),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counters = _counters(dev, stream, b * kv)
        err = lib.corais_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_pos.data_ptr(), pos.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(),
            None if lse is None else lse.data_ptr(), b, w, h, kv, hd, win,
            1.0 / math.sqrt(hd), cap, splits, per,
            int(q.dtype == torch.bfloat16), stream)
    raise_on(err, lib, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return (out, lse) if with_lse else out


# -- the torch.library ops ---------------------------------------------------


# The ops' CPU kernels: the plain versions, their outputs laid out as the
# kernel lays its own (contiguous).

def _plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           slot_pos: torch.Tensor, pos: torch.Tensor,
           window: Optional[int], softcap: float = 0.0) -> torch.Tensor:
    return ref.decode_attention_torch(q, k_cache, v_cache, slot_pos, pos,
                                      window=window,
                                      softcap=softcap).contiguous()


def _plain_lse(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               slot_pos: torch.Tensor, pos: torch.Tensor,
               window: Optional[int], softcap: float = 0.0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    return (_plain(q, k_cache, v_cache, slot_pos, pos, window, softcap),
            ref.decode_attention_lse_torch(q, k_cache, slot_pos, pos,
                                           window=window,
                                           softcap=softcap).contiguous())


decode_attention_op = torch.library.custom_op(
    "repro_torch::decode_attention", _plain, mutates_args=(),
    device_types="cpu")
decode_attention_lse_op = torch.library.custom_op(
    "repro_torch::decode_attention_lse", _plain_lse, mutates_args=(),
    device_types="cpu")


@decode_attention_op.register_kernel("cuda")
def _cuda(q, k_cache, v_cache, slot_pos, pos, window, softcap=0.0):
    return decode_attention_cuda(q, k_cache, v_cache, slot_pos, pos,
                                 window=window, softcap=softcap)


@decode_attention_lse_op.register_kernel("cuda")
def _cuda_lse(q, k_cache, v_cache, slot_pos, pos, window, softcap=0.0):
    return decode_attention_cuda(q, k_cache, v_cache, slot_pos, pos,
                                 window=window, with_lse=True,
                                 softcap=softcap)


@decode_attention_op.register_fake
def _fake(q, k_cache, v_cache, slot_pos, pos, window, softcap=0.0):
    return q.new_empty(q.shape)


@decode_attention_lse_op.register_fake
def _fake_lse(q, k_cache, v_cache, slot_pos, pos, window, softcap=0.0):
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def _flops(q_shape, k_shape, v_shape, slot_shape, pos_shape, window=None,
           *_, **__) -> int:
    """The two products of every slot of a filled cache; a cap's tanh per
    score is not counted (one per 4 * hd product operations)."""
    b, h, hd = q_shape
    return decode_attention_counts(b, k_shape[1], h, k_shape[2], hd,
                                   window=window)[0]


register_flop_formula([torch.ops.repro_torch.decode_attention,
                       torch.ops.repro_torch.decode_attention_lse])(_flops)
