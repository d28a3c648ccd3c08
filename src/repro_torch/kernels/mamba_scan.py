"""B6: hand-written CUDA mamba-1 selective scan (``csrc/mamba_scan.cu``).

Replaces the Pallas ``_kernel`` of ``repro/kernels/mamba_scan.py:21``
(``h = exp(dt*A)*h + (dt*u)*B_t``, ``y_t = sum_n h*C_t``, the state carried
over the whole sequence). Unlike the Pallas kernel, which needs
``S % chunk == 0`` and ``d % bd == 0``, it takes any S and d. The scan is
chunk-parallel over time; the source's header note says what bounds it on
the H100 and what its design does about that.

Two entries share the kernel body: :func:`mamba_scan_cuda`, the bare scan
(plain version :func:`repro_torch.kernels.ref.mamba_scan_torch`), and
:func:`mamba_scan_gated_cuda`, the SSM block's tail with dt's softplus
before the scan and the D skip and SiLU gate after it (plain version
:func:`repro_torch.kernels.ref.mamba_scan_gated_torch`). Both count into
``LAUNCHES["mamba_scan"]``. For training the gated entry also returns the
state entering each of its chunks, from which :func:`mamba_scan_gated_bwd_cuda`
(B6b, ``csrc/mamba_scan_bwd.cu``; plain version
:func:`repro_torch.kernels.ref.mamba_scan_gated_bwd_torch`; counted into
``LAUNCHES["mamba_scan_bwd"]``) forms the gradients. Every entry takes
``bf16_state`` (the reference's ``ssm_scan_dtype="bfloat16"``): the state
is carried in bf16 (the source's header note; the plain versions take the
same flag), and B6b recomputes it so.

Each entry and its plain version are the kernels of a ``torch.library`` op
(``repro_torch::mamba_scan``, ``mamba_scan_gated``,
``mamba_scan_gated_states`` (with the chunk states) and
``mamba_scan_gated_bwd``), dispatched by the tensors' device, with fake
implementations and the FLOP formulas of
:mod:`repro_torch.kernels.counts`, as for B4
(:mod:`~repro_torch.kernels.flash_attention`).
:mod:`repro_torch.kernels.ops` calls them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref
from repro_torch.kernels.build import (LAUNCHES, check_device, check_layout,
                                       check_tensor, load, raise_on)
from repro_torch.kernels.counts import (mamba_scan_counts,
                                        mamba_scan_gated_bwd_counts,
                                        mamba_scan_gated_counts)

#: The largest state width N the kernel takes.
MAX_STATE = 32
#: The steps of one chunk of B6's walk, whose entering states B6's gated
#: entry stores for B6b (the kernels' ``corais_mamba_scan_chunk`` and
#: ``corais_mamba_scan_bwd_chunk``, checked at each launch that uses them).
STATE_CHUNK = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "corais_mamba_scan": [_P] * 7 + [_I] * 5 + [_P],
    "corais_mamba_scan_gated": ([_P] * 8 + [ctypes.c_longlong, _I] + [_P] * 3
                                + [_I] * 5 + [_P]),
    "corais_mamba_scan_chunk": [],
}
_BWD_SIGNATURES = {
    "corais_mamba_scan_gated_bwd": ([_P] * 8 + [ctypes.c_longlong, _I]
                                    + [_P] * 11 + [_I] * 6 + [_P]),
    "corais_mamba_scan_bwd_chunk": [],
    "corais_mamba_scan_bwd_block_channels": [],
}


def _shape(u, B_mat, A):
    if u.ndim != 3 or B_mat.ndim != 3 or A.ndim != 2:
        raise ValueError("u, dt must be (B, S, d), B_mat, C_mat (B, S, N) "
                         "and A (d, N)")
    b, s, d = u.shape
    n = A.shape[-1]
    if not (1 <= b <= 65535 and s >= 1 and d >= 1 and 1 <= n <= MAX_STATE):
        raise ValueError(f"unsupported shape B={b} S={s} d={d} N={n}: the "
                         f"kernel takes B <= 65535, S, d >= 1 and "
                         f"1 <= N <= {MAX_STATE}")
    return b, s, d, n


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def mamba_scan_cuda(u, dt, B_mat, C_mat, A, bf16_state=False):
    """B6: u, dt (B, S, d); B_mat, C_mat (B, S, N); A (d, N); all f32,
    contiguous, on one card; B <= 65535, 1 <= N <= 32. Returns
    (y (B, S, d), h_last (B, d, N)), f32, from a zero state; with
    ``bf16_state`` the state carried in bf16."""
    b, s, d, n = _shape(u, B_mat, A)
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
        err = lib.corais_mamba_scan(
            u.data_ptr(), dt.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
            A.data_ptr(), y.data_ptr(), h_last.data_ptr(), b, s, d, n,
            int(bool(bf16_state)), _stream(dev))
    raise_on(err, lib, "mamba_scan")
    LAUNCHES["mamba_scan"] += 1
    return y, h_last


def _check_gated(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z):
    """Layout checks of the gated entry, before any device check (so that
    they hold on any device)."""
    b, s, d, n = _shape(u, B_mat, A)
    for name, t, shape in (("u", u, (b, s, d)), ("dt_raw", dt_raw, (b, s, d)),
                           ("dt_bias", dt_bias, (d,)),
                           ("B_mat", B_mat, (b, s, n)),
                           ("C_mat", C_mat, (b, s, n)), ("A", A, (d, n)),
                           ("D", D, (d,))):
        check_layout(name, t, shape, torch.float32)
    if z.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"z must be torch.bfloat16 or torch.float32, got "
                        f"{z.dtype}")
    if tuple(z.shape) != (b, s, d):
        raise ValueError(f"z has shape {tuple(z.shape)}, expected "
                         f"{(b, s, d)}")
    row = z.stride(1)
    if z.stride(2) != 1 or row < d or (b > 1 and z.stride(0) != s * row):
        raise ValueError(f"z needs a unit last stride and evenly spaced rows "
                         f"of at least d={d} elements, got strides "
                         f"{z.stride()}")
    return b, s, d, n


def _gated_device(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z):
    dev = u.device
    for name, t in (("u", u), ("dt_raw", dt_raw), ("dt_bias", dt_bias),
                    ("B_mat", B_mat), ("C_mat", C_mat), ("A", A), ("D", D),
                    ("z", z)):
        check_device(name, t, dev)
    return dev


def _check_chunk(chunk: int, source: str) -> None:
    if chunk != STATE_CHUNK:
        raise RuntimeError(f"{source} walks chunks of {chunk} steps; the "
                           f"chunk states are laid out for {STATE_CHUNK}")


def mamba_scan_gated_cuda(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z,
                          bf16_state=False, *, with_states=False):
    """B6 with the SSM block's prologue and epilogue: dt = softplus(dt_raw +
    dt_bias) (F.softplus: x above 20 stays x), the scan from a zero state,
    then (y + D*u) * silu(z), stored once in z's dtype.

    u, dt_raw (B, S, d), B_mat, C_mat (B, S, N), A (d, N), dt_bias and D
    (d,): f32, contiguous. z (B, S, d): bf16 or f32, a unit last stride and
    evenly spaced rows (the strided half of in_proj's output is taken as it
    is, not copied). All on one card; B <= 65535, 1 <= N <= 32. Returns
    (out (B, S, d) in z's dtype, h_last (B, d, N) f32), and with
    ``with_states`` also the state entering each chunk of the kernel's walk,
    (B, ceil(S / chunk), d, N) f32, what :func:`mamba_scan_gated_bwd_cuda`
    starts from; out and h_last are the same bits either way. With
    ``bf16_state`` the state is carried in bf16, and h_last and the chunk
    states hold bf16 values."""
    b, s, d, n = _check_gated(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z)
    dev = _gated_device(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z)
    lib = load("mamba_scan.cu", _SIGNATURES)
    out = torch.empty((b, s, d), dtype=z.dtype, device=dev)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    states = None
    if with_states:
        _check_chunk(lib.corais_mamba_scan_chunk(), "mamba_scan.cu")
        states = torch.empty((b, -(-s // STATE_CHUNK), d, n),
                             dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.corais_mamba_scan_gated(
            u.data_ptr(), dt_raw.data_ptr(), dt_bias.data_ptr(),
            B_mat.data_ptr(), C_mat.data_ptr(), A.data_ptr(), D.data_ptr(),
            z.data_ptr(), z.stride(1), int(z.dtype == torch.bfloat16),
            out.data_ptr(), h_last.data_ptr(),
            None if states is None else states.data_ptr(), b, s, d, n,
            int(bool(bf16_state)), _stream(dev))
    raise_on(err, lib, "mamba_scan_gated")
    LAUNCHES["mamba_scan"] += 1
    return (out, h_last) if states is None else (out, h_last, states)


def mamba_scan_gated_bwd_cuda(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z,
                              states, dout, dh_last=None, bf16_state=False):
    """B6b: the gradients of :func:`mamba_scan_gated_cuda`'s (out, h_last)
    with respect to all eight inputs, from its inputs, the chunk states it
    saved (``with_states``), dout (B, S, d) in z's dtype and dh_last (B, d,
    N) f32 or None (zero). One launch; its partials (dB and dC one per
    cluster of blocks, ``corais_mamba_scan_bwd_block_channels`` channels
    each; dA, dD and d dt_bias one per batch row) are added here with
    ``torch.sum``, in a fixed order. ``bf16_state`` recomputes the states
    as the bf16 forward forms them (the gradients stay f32 arithmetic).
    Returns (du, d dt_raw, d dt_bias, dB, dC, dA, dD, dz), f32 but dz in
    z's dtype."""
    b, s, d, n = _check_gated(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z)
    dev = _gated_device(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z)
    lib = load("mamba_scan_bwd.cu", _BWD_SIGNATURES)
    _check_chunk(lib.corais_mamba_scan_bwd_chunk(), "mamba_scan_bwd.cu")
    check_tensor("states", states, (b, -(-s // STATE_CHUNK), d, n),
                 torch.float32, dev)
    check_tensor("dout", dout, (b, s, d), z.dtype, dev)
    if dh_last is not None:
        check_tensor("dh_last", dh_last, (b, d, n), torch.float32, dev)
    nblk = -(-d // lib.corais_mamba_scan_bwd_block_channels())
    f32 = dict(dtype=torch.float32, device=dev)
    du = torch.empty((b, s, d), **f32)
    ddt = torch.empty((b, s, d), **f32)
    dz = torch.empty((b, s, d), dtype=z.dtype, device=dev)
    dBp = torch.empty((b, nblk, s, n), **f32)
    dCp = torch.empty((b, nblk, s, n), **f32)
    dAp = torch.empty((b, d, n), **f32)
    dDp = torch.empty((b, d), **f32)
    dbp = torch.empty((b, d), **f32)
    with torch.cuda.device(dev):
        err = lib.corais_mamba_scan_gated_bwd(
            u.data_ptr(), dt_raw.data_ptr(), dt_bias.data_ptr(),
            B_mat.data_ptr(), C_mat.data_ptr(), A.data_ptr(), D.data_ptr(),
            z.data_ptr(), z.stride(1), int(z.dtype == torch.bfloat16),
            dout.data_ptr(), states.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(), du.data_ptr(),
            ddt.data_ptr(), dz.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
            dAp.data_ptr(), dDp.data_ptr(), dbp.data_ptr(), b, s, d, n, nblk,
            int(bool(bf16_state)), _stream(dev))
    raise_on(err, lib, "mamba_scan_gated_bwd")
    LAUNCHES["mamba_scan_bwd"] += 1
    return (du, ddt, dbp.sum(0), dBp.sum(1), dCp.sum(1), dAp.sum(0),
            dDp.sum(0), dz)


# -- the torch.library ops ---------------------------------------------------

# The ops' CPU kernels: the plain versions, their outputs laid out as the
# kernels lay their own (contiguous).

_T = torch.Tensor


def _contiguous(outs):
    return tuple(t.contiguous() for t in outs)


def _plain(u: _T, dt: _T, B_mat: _T, C_mat: _T, A: _T,
           bf16_state: bool = False) -> tuple[_T, _T]:
    return _contiguous(ref.mamba_scan_torch(u, dt, B_mat, C_mat, A,
                                            bf16_state=bf16_state))


def _plain_gated(u: _T, dt_raw: _T, dt_bias: _T, B_mat: _T, C_mat: _T,
                 A: _T, D: _T, z: _T, bf16_state: bool = False
                 ) -> tuple[_T, _T]:
    return _contiguous(ref.mamba_scan_gated_torch(
        u, dt_raw, dt_bias, B_mat, C_mat, A, D, z, bf16_state=bf16_state))


def _plain_gated_states(u: _T, dt_raw: _T, dt_bias: _T, B_mat: _T,
                        C_mat: _T, A: _T, D: _T, z: _T,
                        bf16_state: bool = False) -> tuple[_T, _T, _T]:
    return _contiguous(ref.mamba_scan_gated_torch(
        u, dt_raw, dt_bias, B_mat, C_mat, A, D, z, chunk=STATE_CHUNK,
        bf16_state=bf16_state))


def _plain_gated_bwd(u: _T, dt_raw: _T, dt_bias: _T, B_mat: _T, C_mat: _T,
                     A: _T, D: _T, z: _T, states: _T, dout: _T,
                     dh_last: Optional[_T], bf16_state: bool = False
                     ) -> tuple[_T, _T, _T, _T, _T, _T, _T, _T]:
    """The plain backward recomputes the states; ``states`` is unused."""
    return _contiguous(ref.mamba_scan_gated_bwd_torch(
        u, dt_raw, dt_bias, B_mat, C_mat, A, D, z, dout, dh_last,
        bf16_state=bf16_state))


def _op(name, fn):
    return torch.library.custom_op(f"repro_torch::{name}", fn,
                                   mutates_args=(), device_types="cpu")


mamba_scan_op = _op("mamba_scan", _plain)
mamba_scan_gated_op = _op("mamba_scan_gated", _plain_gated)
mamba_scan_gated_states_op = _op("mamba_scan_gated_states",
                                 _plain_gated_states)
mamba_scan_gated_bwd_op = _op("mamba_scan_gated_bwd", _plain_gated_bwd)
mamba_scan_op.register_kernel("cuda")(mamba_scan_cuda)
mamba_scan_gated_op.register_kernel("cuda")(mamba_scan_gated_cuda)
mamba_scan_gated_bwd_op.register_kernel("cuda")(mamba_scan_gated_bwd_cuda)


@mamba_scan_gated_states_op.register_kernel("cuda")
def _cuda_gated_states(*args, **kwargs):
    return mamba_scan_gated_cuda(*args, **kwargs, with_states=True)


def _f32(x, shape):
    return x.new_empty(shape, dtype=torch.float32)


@mamba_scan_op.register_fake
def _fake(u, dt, B_mat, C_mat, A, bf16_state=False):
    b, _, d = u.shape
    return _f32(u, u.shape), _f32(u, (b, d, A.shape[-1]))


@mamba_scan_gated_op.register_fake
def _fake_gated(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z, bf16_state=False):
    b, _, d = u.shape
    return z.new_empty(u.shape), _f32(u, (b, d, A.shape[-1]))


@mamba_scan_gated_states_op.register_fake
def _fake_gated_states(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z,
                       bf16_state=False):
    b, s, d = u.shape
    n = A.shape[-1]
    return (z.new_empty(u.shape), _f32(u, (b, d, n)),
            _f32(u, (b, (s + STATE_CHUNK - 1) // STATE_CHUNK, d, n)))


@mamba_scan_gated_bwd_op.register_fake
def _fake_gated_bwd(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z, states, dout,
                    dh_last, bf16_state=False):
    return (_f32(u, u.shape), _f32(u, u.shape), _f32(u, dt_bias.shape),
            _f32(u, B_mat.shape), _f32(u, C_mat.shape), _f32(u, A.shape),
            _f32(u, D.shape), z.new_empty(u.shape))


def _bsdn(u_shape, A_shape):
    b, s, d = u_shape
    return b, s, d, A_shape[-1]


@register_flop_formula(torch.ops.repro_torch.mamba_scan)
def _flops(u, dt, B_mat, C_mat, A, *_, **__) -> int:
    return mamba_scan_counts(*_bsdn(u, A))[0]


@register_flop_formula([torch.ops.repro_torch.mamba_scan_gated,
                        torch.ops.repro_torch.mamba_scan_gated_states])
def _flops_gated(u, dt_raw, dt_bias, B_mat, C_mat, A, *_, **__) -> int:
    return mamba_scan_gated_counts(*_bsdn(u, A))[0]


@register_flop_formula(torch.ops.repro_torch.mamba_scan_gated_bwd)
def _flops_gated_bwd(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z, states,
                     *_, **__) -> int:
    return mamba_scan_gated_bwd_counts(*_bsdn(u, A), states[1])[0]
