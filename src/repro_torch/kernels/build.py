"""Build and load the port's hand-written CUDA kernels.

Every source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into its
own shared library under the git-ignored ``build/torch_kernels/`` at the
first launch of one of its kernels (never at import: the CPU tests import
the wrappers on machines without ``nvcc``), and loaded with ``ctypes``.
Each library has a plain C interface whose entry points return the first
CUDA error of their launches; :func:`raise_on` turns that into an
exception, and :func:`check_tensor` checks a wrapper's tensors before a
launch. :func:`build` compiles all stale sources at once, one ``nvcc``
per source, started together.

:data:`LAUNCHES` counts kernel launches per wrapper: a wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("policy_score.cu", "flash_attention.cu", "flash_attention_bwd.cu",
           "decode_attention.cu", "mamba_scan.cu", "mamba_scan_bwd.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")  # a source's kernels optimized in parallel

#: Launches per wrapper since the last :func:`reset_launch_counts`.
LAUNCHES = {"policy_score": 0, "policy_score_bwd": 0, "policy_score_decode": 0,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "decode_attention": 0, "mamba_scan": 0, "mamba_scan_bwd": 0}

_LIBS: dict[str, ctypes.CDLL] = {}  # source -> library, loaded at first use


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
    # a source's library is stale when older than it or than any header
    headers = max((h.stat().st_mtime for h in CSRC.glob("*.cuh")),
                  default=0.0)
    stale = [s for s in SOURCES if force or not _library(s).exists()
             or _library(s).stat().st_mtime < max(
                 (CSRC / s).stat().st_mtime, headers)]
    procs = {}
    nvcc = _nvcc() if stale else None
    for src in stale:
        tmp = _library(src).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    reports, failed = {}, []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{out}")
            continue
        os.replace(tmp, _library(src))  # atomic: a reader never sees half
        reports[src] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(source: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``source`` (built first if stale), with each
    entry point's argument types set from ``signatures`` (name -> ctypes
    types; every entry point returns an int error code)."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    build()
    lib = ctypes.CDLL(str(_library(source)))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.corais_cuda_error_string.argtypes = [ctypes.c_int]
    lib.corais_cuda_error_string.restype = ctypes.c_char_p
    _LIBS[source] = lib
    return lib


def raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.corais_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def check_tensor(name: str, t, shape: tuple, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape`` and
    ``dtype`` on ``device``."""
    check_device(name, t, device)
    check_layout(name, t, shape, dtype)


def check_device(name: str, t, device) -> None:
    """Raise unless ``t`` is a CUDA tensor on ``device``."""
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {name} on "
                         f"{t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def check_layout(name: str, t, shape: tuple, dtype) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` and
    ``dtype``, on any device."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
