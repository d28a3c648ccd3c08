"""B6: hand-written CUDA mamba-1 selective scan (``csrc/mamba_scan.cu``).

Replaces the Pallas ``_kernel`` of ``repro/kernels/mamba_scan.py:21``
(``h = exp(dt*A)*h + (dt*u)*B_t``, ``y_t = sum_n h*C_t``, the state carried
over the whole sequence). Unlike the Pallas kernel, which needs
``S % chunk == 0`` and ``d % bd == 0``, it takes any S and d. The source's
header note says what bounds it on the H100 and what its design does about
that.

:func:`mamba_scan_cuda` takes CUDA tensors only; its plain version is
:func:`repro_torch.kernels.ref.mamba_scan_torch`, and
:func:`repro_torch.kernels.ops.mamba_scan` chooses between the two by the
tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (LAUNCHES, check_tensor, load,
                                       raise_on)

#: The largest state width N the kernel takes (one thread per state).
MAX_STATE = 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"corais_mamba_scan": [_P] * 7 + [_I] * 4 + [_P]}


def mamba_scan_cuda(u, dt, B_mat, C_mat, A):
    """B6: u, dt (B, S, d); B_mat, C_mat (B, S, N); A (d, N); all f32,
    contiguous, on one card; B <= 65535, 1 <= N <= 32. Returns
    (y (B, S, d), h_last (B, d, N)), f32, from a zero state."""
    if u.ndim != 3 or B_mat.ndim != 3 or A.ndim != 2:
        raise ValueError("u, dt must be (B, S, d), B_mat, C_mat (B, S, N) "
                         "and A (d, N)")
    b, s, d = u.shape
    n = A.shape[-1]
    if not (1 <= b <= 65535 and s >= 1 and d >= 1 and 1 <= n <= MAX_STATE):
        raise ValueError(f"unsupported shape B={b} S={s} d={d} N={n}: the "
                         f"kernel takes B <= 65535, S, d >= 1 and "
                         f"1 <= N <= {MAX_STATE}")
    dev = u.device
    check_tensor("u", u, (b, s, d), torch.float32, dev)
    check_tensor("dt", dt, (b, s, d), torch.float32, dev)
    check_tensor("B_mat", B_mat, (b, s, n), torch.float32, dev)
    check_tensor("C_mat", C_mat, (b, s, n), torch.float32, dev)
    check_tensor("A", A, (d, n), torch.float32, dev)
    lib = load("mamba_scan.cu", _SIGNATURES)
    y = torch.empty_like(u)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.corais_mamba_scan(
            u.data_ptr(), dt.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
            A.data_ptr(), y.data_ptr(), h_last.data_ptr(), b, s, d, n, stream)
    raise_on(err, lib, "mamba_scan")
    LAUNCHES["mamba_scan"] += 1
    return y, h_last
