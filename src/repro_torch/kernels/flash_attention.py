"""B4: hand-written CUDA flash-attention forward (``csrc/flash_attention.cu``).

Replaces the Pallas ``_kernel`` of ``repro/kernels/flash_attention.py:26``
(causal / sliding-window GQA flash attention, online softmax in f32, dead
tiles skipped, KV head ``h // G``). Unlike the Pallas kernel it takes any
sequence length, and keys of a length of their own (Sk, as the
reference's model attention takes them: whisper's cross attention), the
masks aligned at the top left. bf16 runs on the tensor cores (hd a multiple of 16), f32
on the CUDA cores (hd a multiple of 4). The source's header note says what
bounds it on the H100 and what its design does about that. With
``with_lse`` it also writes each row's log-sum-exp (B, H, Sq) f32, the
residual of the training attention's backward; without it (serving) the
kernel stores nothing more, and the output is the same bits either way.
A ``softcap`` above 0 caps every scaled score at ``softcap * tanh(s /
softcap)`` before the mask (the reference's ``logit_softcap``); 0 is no
cap, and the kernel is then the uncapped one.

:func:`flash_attention_cuda` takes CUDA tensors only; its plain version is
:func:`repro_torch.kernels.ref.flash_attention_torch`. Both are the kernels
of two ``torch.library`` ops, ``repro_torch::flash_attention`` and
``repro_torch::flash_attention_lse`` (with the log-sum-exp): the
dispatcher runs the CUDA one on CUDA tensors and the plain one on CPU
tensors, and a fake implementation gives the outputs' shapes, dtypes and
strides, so that the op traces under fake tensors without a launch.
Each op's FLOP formula is :func:`repro_torch.kernels.counts.flash_attention_counts`'s.
:func:`repro_torch.kernels.ops.flash_attention` calls them.
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
from repro_torch.kernels.counts import flash_attention_counts

MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)
#: bf16 head widths are whole k16 steps of the tensor-core product.
BF16_HEAD_DIM_MULTIPLE = 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"corais_flash_attention":
               [_P] * 5 + [_I] * 8 + [_F, _F, _I, _P]}


def check_vector_loads(hd: int, dtype, **tensors) -> None:
    """The kernels load K and V in 16-byte chunks: hd must be a multiple of
    8 (bf16) or 4 (f32) and each tensor's data 16-byte aligned."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if hd % vec:
        raise ValueError(f"hd={hd} must be a multiple of {vec} for {dtype}")
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def softcap_arg(softcap) -> float:
    """The C interface's cap: a finite value of at least 0 (0 = none)."""
    cap = float(softcap)
    if not (math.isfinite(cap) and cap >= 0.0):
        raise ValueError(f"softcap must be finite and >= 0, got {softcap}")
    return cap


def window_arg(window) -> int:
    """The C interface's window: a positive width, or -1 for none."""
    if window is None:
        return -1
    if int(window) < 1:
        raise ValueError(f"window must be positive or None, got {window}")
    return int(window)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None,
                         with_lse: bool = False, softcap: float = 0.0):
    """B4: q (B, Sq, H, hd); k, v (B, Sk, KV, hd), H a multiple of KV,
    hd <= 128 and a multiple of 16 (bf16) or 4 (f32), all f32 or all bf16,
    contiguous, k and v (and q in bf16) 16-byte aligned, on one card. The
    causal and window masks compare the query row with the key column from
    the top left (``col <= row``), as the reference's model attention
    does. ``softcap`` above 0 caps the scaled scores (0: none). Returns (B,
    Sq, H, hd) in q's dtype, and with ``with_lse`` also the rows'
    log-sum-exp (B, H, Sq) f32, of the capped, masked scores."""
    win = window_arg(window)
    cap = softcap_arg(softcap)
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("q must be (B, Sq, H, hd) and k, v (B, Sk, KV, hd)")
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if not (b >= 1 and s >= 1 and sk >= 1 and kv >= 1 and h % kv == 0
            and 1 <= hd <= MAX_HEAD_DIM):
        raise ValueError(f"unsupported shape B={b} Sq={s} Sk={sk} H={h} "
                         f"KV={kv} hd={hd}: the kernel takes H % KV == 0 "
                         f"and 1 <= hd <= {MAX_HEAD_DIM}")
    check_tensor("q", q, (b, s, h, hd), q.dtype, q.device)
    check_tensor("k", k, (b, sk, kv, hd), q.dtype, q.device)
    check_tensor("v", v, (b, sk, kv, hd), q.dtype, q.device)
    if q.dtype == torch.bfloat16:
        if hd % BF16_HEAD_DIM_MULTIPLE:
            raise ValueError(f"hd={hd} must be a multiple of "
                             f"{BF16_HEAD_DIM_MULTIPLE} for torch.bfloat16 "
                             f"(tensor-core k16 steps)")
        check_vector_loads(hd, q.dtype, q=q, k=k, v=v)
    else:
        check_vector_loads(hd, q.dtype, k=k, v=v)
    lib = load("flash_attention.cu", _SIGNATURES)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.corais_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, s, sk, h, kv, hd,
            int(bool(causal)), win, 1.0 / math.sqrt(hd), cap,
            int(q.dtype == torch.bfloat16), stream)
    raise_on(err, lib, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out


# -- the torch.library ops ---------------------------------------------------


# The ops' CPU kernels: the plain versions, their outputs laid out as the
# kernel lays its own (contiguous).

def _plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int], softcap: float = 0.0) -> torch.Tensor:
    return ref.flash_attention_torch(q, k, v, causal=causal, window=window,
                                     softcap=softcap).contiguous()


def _plain_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: Optional[int], softcap: float = 0.0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    return (_plain(q, k, v, causal, window, softcap),
            ref.flash_attention_lse_torch(q, k, causal=causal, window=window,
                                          softcap=softcap).contiguous())


flash_attention_op = torch.library.custom_op(
    "repro_torch::flash_attention", _plain, mutates_args=(),
    device_types="cpu")
flash_attention_lse_op = torch.library.custom_op(
    "repro_torch::flash_attention_lse", _plain_lse, mutates_args=(),
    device_types="cpu")


@flash_attention_op.register_kernel("cuda")
def _cuda(q, k, v, causal, window, softcap=0.0):
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap)


@flash_attention_lse_op.register_kernel("cuda")
def _cuda_lse(q, k, v, causal, window, softcap=0.0):
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                with_lse=True, softcap=softcap)


@flash_attention_op.register_fake
def _fake(q, k, v, causal, window, softcap=0.0):
    return q.new_empty(q.shape)


@flash_attention_lse_op.register_fake
def _fake_lse(q, k, v, causal, window, softcap=0.0):
    b, s, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, s), dtype=torch.float32)


def _flops(q_shape, k_shape, v_shape, causal=True, window=None, *_,
           **__) -> int:
    """The two products of the kept pairs; a cap's tanh per score is not
    counted (one per 4 * hd product operations)."""
    b, s, h, hd = q_shape
    return flash_attention_counts(b, s, k_shape[1], h, k_shape[2], hd,
                                  causal=causal, window=window)[0]


register_flop_formula([torch.ops.repro_torch.flash_attention,
                       torch.ops.repro_torch.flash_attention_lse])(_flops)
