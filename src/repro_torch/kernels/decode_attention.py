"""B5: hand-written CUDA decode attention (``csrc/decode_attention.cu``).

Replaces the Pallas ``_kernel`` of ``repro/kernels/decode_attention.py:25``:
one query token per sequence over a (possibly rolling) KV cache, the G
query heads of a KV head sharing each cache read, slot validity from
``slot_pos`` and ``pos`` evaluated in the kernel. The source's header note
says what bounds it on the H100 and what its design does about that.

:func:`decode_attention_cuda` takes CUDA tensors only; its plain version is
:func:`repro_torch.kernels.ref.decode_attention_torch`, and
:func:`repro_torch.kernels.ops.decode_attention` chooses between the two by
the tensors' device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import (LAUNCHES, check_tensor, load,
                                       raise_on)
from repro_torch.kernels.flash_attention import (DTYPES, MAX_HEAD_DIM,
                                                 check_vector_loads,
                                                 window_arg)

#: G * hd: the query heads of one KV head times the head width.
MAX_GROUP_WIDTH = 2048

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"corais_decode_attention": [_P] * 6 + [_I] * 6 + [_F, _I, _P]}


def decode_attention_cuda(q, k_cache, v_cache, slot_pos, pos, *, window=None):
    """B5: q (B, H, hd); k_cache, v_cache (B, W, KV, hd), all f32 or all
    bf16, 16-byte aligned; slot_pos (B, W) int32 (-1 = empty); pos (B,)
    int32; contiguous, on one card; H a multiple of KV, hd <= 128 and a
    multiple of 8 (bf16) or 4 (f32), (H / KV) * hd <= 2048. Returns
    (B, H, hd) in q's dtype."""
    win = window_arg(window)
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
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.corais_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_pos.data_ptr(), pos.data_ptr(), out.data_ptr(), b, w, h, kv,
            hd, win, 1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
            stream)
    raise_on(err, lib, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
