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

The sources are compiled with ``nvcc`` into ``build/torch_kernels/`` at the
first launch (never at import: the CPU tests import this module on
machines without ``nvcc``) and loaded with ``ctypes``. A wrapper checks its
inputs, allocates outputs and scratch with ``torch.empty``, launches on the
current stream, raises on a CUDA error, and adds one to its entry in
:data:`LAUNCHES`. It takes only CUDA tensors; the plain versions for the
CPU live in :mod:`repro_torch.kernels.ref`, and :mod:`repro_torch.kernels.ops`
chooses between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("policy_score.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel limits: Q edges (four per lane of a warp), d model width.
MAX_EDGES = 128
MAX_WIDTH = 512

#: Launches per wrapper since the last :func:`reset_launch_counts`; a
#: wrapper adds one where it launches its kernel, and nowhere else.
LAUNCHES = {"policy_score": 0, "policy_score_bwd": 0, "policy_score_decode": 0}

_LIB: ctypes.CDLL | None = None  # loaded at the first launch


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are compiled from csrc/ at first use")


def _library(source: str) -> Path:
    return BUILD_DIR / f"lib{Path(source).stem}.so"


def build(force: bool = False) -> dict[str, str]:
    """Compile every stale source in ``csrc/`` (one ``nvcc`` per source, all
    started together) into ``build/torch_kernels/``. Returns
    {source: nvcc's report (registers, shared memory, spills)}; raises if a
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stale = [s for s in SOURCES if force or not _library(s).exists()
             or _library(s).stat().st_mtime < (CSRC / s).stat().st_mtime]
    procs = {}
    nvcc = _nvcc() if stale else None
    for src in stale:
        tmp = _library(src).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    reports = {}
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        os.replace(tmp, _library(src))  # atomic: a reader never sees half
        reports[src] = out
    return reports


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    build()
    lib = ctypes.CDLL(str(_library("policy_score.cu")))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.corais_policy_score.argtypes = [ptr] * 7 + [i32] * 4 + [f32, f32, ptr]
    lib.corais_policy_score.restype = i32
    lib.corais_policy_score_decode.argtypes = (
        [ptr] * 8 + [i32] * 6 + [f32, f32, ptr])
    lib.corais_policy_score_decode.restype = i32
    lib.corais_policy_score_bwd.argtypes = (
        [ptr] * 17 + [i32] * 6 + [f32, f32, ptr])
    lib.corais_policy_score_bwd.restype = i32
    lib.corais_cuda_error_string.argtypes = [i32]
    lib.corais_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


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


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        msg = lib.corais_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def policy_score_cuda(c, h, w_px, w_py, maskf, *, tanh_clip: float = 10.0):
    """B1: log a_qz (eq 17) as (B, Z, Q) f32. c: (B, Q, d); h: (B, Z, d);
    w_px, w_py: (d, d); maskf: (B, Q) f32, > 0.5 = real edge."""
    b, q, z, d = _check_inputs(c, h, w_px, w_py, maskf)
    lib = _lib()
    out = torch.empty((b, z, q), dtype=torch.float32, device=c.device)
    px_t = torch.empty((b, d, q), dtype=torch.float32, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = lib.corais_policy_score(
            c.data_ptr(), h.data_ptr(), w_px.data_ptr(), w_py.data_ptr(),
            maskf.data_ptr(), px_t.data_ptr(), out.data_ptr(), b, q, z, d,
            1.0 / math.sqrt(d), float(tanh_clip), stream)
    _raise_on(err, lib, "policy_score")
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
    pxy = torch.empty((b, d, q), dtype=torch.float32, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = lib.corais_policy_score_decode(
            c.data_ptr(), h.data_ptr(), w_px.data_ptr(), w_py.data_ptr(),
            maskf.data_ptr(), pxy.data_ptr(), top_idx.data_ptr(),
            top_val.data_ptr(), b, q, z, d, int(k), int(bool(normalize)),
            1.0 / math.sqrt(d), float(tanh_clip), stream)
    _raise_on(err, lib, "policy_score_decode")
    LAUNCHES["policy_score_decode"] += 1
    return top_idx, top_val


def _row_split(n: int) -> int:
    """Partial sums for a B2 weight gradient over ``n`` rows: at least 128
    rows each, at most 32 partials (enough blocks to fill the card at the
    training shape, B*Z = 6400 rows)."""
    per = max(128, -(-n // 32))
    return -(-n // per)


def policy_score_bwd_cuda(g, out, c, h, w_px, w_py, maskf, *,
                          tanh_clip: float = 10.0):
    """B2: the backward of B1. g, out: (B, Z, Q) cotangent and saved
    log-probs; other inputs as :func:`policy_score_cuda`. Returns
    ``(dc (B, Q, d), dh (B, Z, d), dw_px (d, d), dw_py (d, d))``, the weight
    gradients summed over B in a fixed order (no atomics: two calls give the
    same bits)."""
    b, q, z, d = _check_inputs(c, h, w_px, w_py, maskf)
    _check("g", g, (b, z, q), c.device)
    _check("out", out, (b, z, q), c.device)
    lib = _lib()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=c.device)

    dc, dh, dw_px, dw_py = empty(b, q, d), empty(b, z, d), empty(d, d), empty(d, d)
    split_x, split_y = _row_split(b * q), _row_split(b * z)
    scratch = (empty(b, d, q), empty(b, z, d), empty(b, z, q), empty(b, z, d),
               empty(b, q, d), empty(max(split_x, split_y), d, d))
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = lib.corais_policy_score_bwd(
            g.data_ptr(), out.data_ptr(), c.data_ptr(), h.data_ptr(),
            w_px.data_ptr(), w_py.data_ptr(), maskf.data_ptr(),
            *(t.data_ptr() for t in scratch), dc.data_ptr(), dh.data_ptr(),
            dw_px.data_ptr(), dw_py.data_ptr(), b, q, z, d, split_x, split_y,
            1.0 / math.sqrt(d), float(tanh_clip), stream)
    _raise_on(err, lib, "policy_score_bwd")
    LAUNCHES["policy_score_bwd"] += 1
    return dc, dh, dw_px, dw_py
