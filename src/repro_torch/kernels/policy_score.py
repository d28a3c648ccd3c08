"""Hand-written CUDA kernels for the CoRaiS policy head: build, bind, launch.

Three kernels, all in ``csrc/policy_score.cu`` (its header note says what
bounds them and how they are laid out):

* :func:`policy_score_cuda`, the materialized eq 16-17 head, replaces the
  Pallas ``_fwd_kernel`` (``repro/kernels/policy_score.py:51``);
* :func:`policy_score_bwd_cuda`, its backward, replaces the Pallas
  ``_bwd_kernel`` (``repro/kernels/policy_score.py:65``); the two meet in
  the ``torch.autograd.Function`` of :mod:`repro_torch.kernels.ops`;
* :func:`policy_score_decode_cuda`, the fused score + top-k decode,
  replaces the Pallas ``_decode_kernel`` (``repro/kernels/policy_score.py:180``).

:mod:`repro_torch.kernels.build` compiles the source at the first launch
and loads it with ``ctypes``. A wrapper checks its inputs, allocates
outputs and scratch with ``torch.empty``, launches on the current stream,
raises on a CUDA error, and adds one to its entry in :data:`LAUNCHES`.
It takes only CUDA tensors; the plain versions for the CPU live in
:mod:`repro_torch.kernels.ref`, and :mod:`repro_torch.kernels.ops` chooses
between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import (LAUNCHES, build, load, raise_on,
                                       reset_launch_counts)

#: Kernel limits: Q edges (B3 pads them to 32, 64 or 128 and sorts them in
#: one warp), d model width.
MAX_EDGES = 128
MAX_WIDTH = 512
#: Side of B2's weight-gradient tiles (``kWT`` in the source): one integer
#: counter per tile and weight.
WEIGHT_TILE = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "corais_policy_score": [_P] * 8 + [_I] * 4 + [_F, _F, _P],
    "corais_policy_score_decode": [_P] * 9 + [_I] * 6 + [_F, _F, _P],
    "corais_policy_score_bwd": [_P] * 18 + [_I] * 5 + [_F, _F, _P],
}


def _lib() -> ctypes.CDLL:
    return load("policy_score.cu", _SIGNATURES)


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(c, h, w_px, w_py, maskf):
    if c.ndim != 3 or h.ndim != 3:
        raise ValueError("c_emb and h_emb must be (B, Q, d) and (B, Z, d)")
    b, q, d = c.shape
    z = h.shape[1]
    if not (1 <= q <= MAX_EDGES and 1 <= d <= MAX_WIDTH and b >= 1 and z >= 1):
        raise ValueError(f"unsupported shape B={b} Q={q} Z={z} d={d}: the "
                         f"kernels take 1 <= Q <= {MAX_EDGES}, "
                         f"1 <= d <= {MAX_WIDTH}, B, Z >= 1")
    if c.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {c.device}")
    for name, t, shape in (("c_emb", c, (b, q, d)), ("h_emb", h, (b, z, d)),
                           ("w_px", w_px, (d, d)), ("w_py", w_py, (d, d)),
                           ("edge_mask", maskf, (b, q))):
        _check(name, t, shape, c.device)
    return b, q, z, d


def policy_score_cuda(c, h, w_px, w_py, maskf, *, tanh_clip: float = 10.0):
    """B1: log a_qz (eq 17) as (B, Z, Q) f32. c: (B, Q, d); h: (B, Z, d);
    w_px, w_py: (d, d); maskf: (B, Q) f32, > 0.5 = real edge. Above
    ``kFlatQ`` edges (8) its launches are B3's up to the selection, so its
    values equal B3's normalized values bit for bit; at fewer it takes its
    small-Q plan (the source's header note)."""
    b, q, z, d = _check_inputs(c, h, w_px, w_py, maskf)
    lib = _lib()
    out = torch.empty((b, z, q), dtype=torch.float32, device=c.device)
    px = torch.empty((b, q, d), dtype=torch.float32, device=c.device)
    # pxy (B, d, Q); the small-Q plan writes pxy^T (B, Q, d) there
    pxy = torch.empty((b, d, q), dtype=torch.float32, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = lib.corais_policy_score(
            c.data_ptr(), h.data_ptr(), w_px.data_ptr(), w_py.data_ptr(),
            maskf.data_ptr(), px.data_ptr(), pxy.data_ptr(), out.data_ptr(),
            b, q, z, d, 1.0 / math.sqrt(d), float(tanh_clip), stream)
    raise_on(err, lib, "policy_score")
    LAUNCHES["policy_score"] += 1
    return out


def policy_score_decode_cuda(c, h, w_px, w_py, maskf, *,
                             tanh_clip: float = 10.0, k: int = 1,
                             normalize: bool = True):
    """B3: per-request top-k edges as (top_idx int32, top_val f32), both
    (B, Z, K), without writing the (Z, Q) scores (decode contract in
    :mod:`repro_torch.kernels.ref`)."""
    b, q, z, d = _check_inputs(c, h, w_px, w_py, maskf)
    if not 1 <= k <= q:
        raise ValueError(f"k={k} outside 1..Q={q}")
    lib = _lib()
    top_idx = torch.empty((b, z, k), dtype=torch.int32, device=c.device)
    top_val = torch.empty((b, z, k), dtype=torch.float32, device=c.device)
    px = torch.empty((b, q, d), dtype=torch.float32, device=c.device)
    pxy = torch.empty((b, d, q), dtype=torch.float32, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = lib.corais_policy_score_decode(
            c.data_ptr(), h.data_ptr(), w_px.data_ptr(), w_py.data_ptr(),
            maskf.data_ptr(), px.data_ptr(), pxy.data_ptr(), top_idx.data_ptr(),
            top_val.data_ptr(), b, q, z, d, int(k), int(bool(normalize)),
            1.0 / math.sqrt(d), float(tanh_clip), stream)
    raise_on(err, lib, "policy_score_decode")
    LAUNCHES["policy_score_decode"] += 1
    return top_idx, top_val


def _row_split(n: int) -> int:
    """Partials of each B2 weight gradient over its ``n`` = B*Q edge rows:
    one per max(128, n / 32) rows, so at most 32 (5 at the training shape's
    640), each of ceil(n / split) rows but the last, and none empty; the
    two weights' partial tiles and the dc tiles fill the card together."""
    per = max(128, -(-n // 32))
    return -(-n // per)


def policy_score_bwd_cuda(g, out, c, h, w_px, w_py, maskf, *,
                          tanh_clip: float = 10.0):
    """B2: the backward of B1. g, out: (B, Z, Q) cotangent and saved
    log-probs; other inputs as :func:`policy_score_cuda`. Returns
    ``(dc (B, Q, d), dh (B, Z, d), dw_px (d, d), dw_py (d, d))``, the weight
    gradients summed over B in a fixed order (no float atomics: two calls
    give the same bits)."""
    b, q, z, d = _check_inputs(c, h, w_px, w_py, maskf)
    _check("g", g, (b, z, q), c.device)
    _check("out", out, (b, z, q), c.device)
    lib = _lib()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=c.device)

    dc, dh, dw_px, dw_py = empty(b, q, d), empty(b, z, d), empty(d, d), empty(d, d)
    split = _row_split(b * q)
    tiles = (-(-d // WEIGHT_TILE)) ** 2
    # px, pxy^T, gu, ghx, dpx, both weights' partials, the tile counters
    scratch = (empty(b, q, d), empty(b, q, d), empty(b, z, q), empty(b, q, d),
               empty(b, q, d), empty(2 * split, d, d),
               torch.empty(2 * tiles, dtype=torch.int32, device=c.device))
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = lib.corais_policy_score_bwd(
            g.data_ptr(), out.data_ptr(), c.data_ptr(), h.data_ptr(),
            w_px.data_ptr(), w_py.data_ptr(), maskf.data_ptr(),
            *(t.data_ptr() for t in scratch), dc.data_ptr(), dh.data_ptr(),
            dw_px.data_ptr(), dw_py.data_ptr(), b, q, z, d, split,
            1.0 / math.sqrt(d), float(tanh_clip), stream)
    raise_on(err, lib, "policy_score_bwd")
    LAUNCHES["policy_score_bwd"] += 1
    return dc, dh, dw_px, dw_py


__all__ = ["LAUNCHES", "build", "reset_launch_counts", "policy_score_cuda",
           "policy_score_decode_cuda", "policy_score_bwd_cuda"]
