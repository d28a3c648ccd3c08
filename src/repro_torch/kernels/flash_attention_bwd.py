"""B4b: hand-written CUDA backward of the training attention
(``csrc/flash_attention_bwd.cu``).

The gradients (dq, dk, dv) of B4's forward from its residuals: q (B, Sq, H,
hd), k, v (B, Sk, KV, hd), the output (B, Sq, H, hd), the rows'
log-sum-exp (B, H, Sq) f32 as B4 writes it with ``with_lse``, and the
cotangent of the output. It replaces no Pallas kernel: the reference's
backward, ``_flash_bwd`` (``repro/models/attention.py:166-233``), is a
pure-jnp pair-scan, whose plain twin is
:func:`repro_torch.kernels.ref.flash_attention_bwd_torch`. Two launches,
a dq pass that also writes each row's ``delta = rowsum(dO * O)`` and a
dk/dv pass that reads it, with no float atomics: two calls give the same
bits. bf16 runs on the tensor cores (hd a multiple of 16), f32 on the CUDA
cores. The masks, the cap and the convention for a row with no allowed
column are B4's and the plain version's; the source's header note says what
bounds the kernel on the H100 and what its design does about that.

:func:`flash_attention_bwd_cuda` takes CUDA tensors only. It and the plain
version are the kernels of the ``torch.library`` op
``repro_torch::flash_attention_bwd``: the dispatcher runs the CUDA one on
CUDA tensors and the plain one on CPU tensors, and a fake implementation
gives the gradients' shapes, dtypes and strides, so that the op traces
under fake tensors without a launch. Its FLOP formula is
:func:`repro_torch.kernels.counts.flash_attention_bwd_counts`'s.
:class:`repro_torch.kernels.ops.FlashAttention` calls it in its backward.
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
from repro_torch.kernels.counts import flash_attention_bwd_counts
from repro_torch.kernels.flash_attention import (BF16_HEAD_DIM_MULTIPLE,
                                                 DTYPES, MAX_HEAD_DIM,
                                                 check_vector_loads,
                                                 softcap_arg, window_arg)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"corais_flash_attention_bwd":
               [_P] * 10 + [_I] * 8 + [_F, _F, _I, _P]}


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True,
                             window=None, softcap: float = 0.0):
    """B4b: q, out, dout (B, Sq, H, hd); k, v (B, Sk, KV, hd), H a multiple
    of KV, hd <= 128 and a multiple of 16 (bf16) or 4 (f32), all f32 or all
    bf16, contiguous and 16-byte aligned; lse (B, H, Sq) f32, contiguous;
    all on one card. The masks and the cap are those the forward ran with.
    Returns (dq, dk, dv) in the inputs' dtype."""
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
    for name, t in (("q", q), ("out", out), ("dout", dout)):
        check_tensor(name, t, (b, s, h, hd), q.dtype, q.device)
    check_tensor("k", k, (b, sk, kv, hd), q.dtype, q.device)
    check_tensor("v", v, (b, sk, kv, hd), q.dtype, q.device)
    check_tensor("lse", lse, (b, h, s), torch.float32, q.device)
    if q.dtype == torch.bfloat16 and hd % BF16_HEAD_DIM_MULTIPLE:
        raise ValueError(f"hd={hd} must be a multiple of "
                         f"{BF16_HEAD_DIM_MULTIPLE} for torch.bfloat16 "
                         f"(tensor-core k16 steps)")
    check_vector_loads(hd, q.dtype, q=q, k=k, v=v, out=out, dout=dout)
    lib = load("flash_attention_bwd.cu", _SIGNATURES)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.corais_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), b, s, sk, h, kv, hd,
            int(bool(causal)), win, 1.0 / math.sqrt(hd), cap,
            int(q.dtype == torch.bfloat16), stream)
    raise_on(err, lib, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


# -- the torch.library op ----------------------------------------------------

_T = torch.Tensor


def _plain(q: _T, k: _T, v: _T, out: _T, lse: _T, dout: _T, causal: bool,
           window: Optional[int], softcap: float = 0.0, chunk: int = 512
           ) -> tuple[_T, _T, _T]:
    """The op's CPU kernel: the reference's pair-scan over ``chunk``-row
    blocks (the kernel's result does not depend on ``chunk``), its outputs
    laid out as the kernel lays its own (contiguous)."""
    return tuple(t.contiguous() for t in ref.flash_attention_bwd_torch(
        q, k, v, out, lse, dout, chunk=chunk, causal=causal, window=window,
        softcap=softcap))


flash_attention_bwd_op = torch.library.custom_op(
    "repro_torch::flash_attention_bwd", _plain, mutates_args=(),
    device_types="cpu")


@flash_attention_bwd_op.register_kernel("cuda")
def _cuda(q, k, v, out, lse, dout, causal, window, softcap=0.0, chunk=512):
    return flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal,
                                    window=window, softcap=softcap)


@flash_attention_bwd_op.register_fake
def _fake(q, k, v, out, lse, dout, causal, window, softcap=0.0, chunk=512):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
           causal=True, window=None, *_, **__) -> int:
    """The five products of the kept pairs; a cap's tanh per score is not
    counted."""
    b, s, h, hd = q_shape
    return flash_attention_bwd_counts(b, s, k_shape[1], h, k_shape[2], hd,
                                      causal=causal, window=window)[0]
