"""Meshes over ``torch.distributed`` (counterpart of ``make_host_mesh`` and
``make_fleet_mesh`` in ``repro/launch/mesh.py``).

:func:`make_host_mesh` returns a 2-D
:class:`torch.distributed.device_mesh.DeviceMesh` with the reference's
``("data", "model")`` axes, the LM steps' mesh; :func:`make_fleet_mesh` a
1-D one with the ``("fleet",)`` axis. A rank is a process with one
device, so the "devices" the reference counts are the ranks of the world
here: CUDA ranks talk over NCCL and CPU ranks over gloo.

When no process group exists, the first mesh starts one. Under a launcher
(``torchrun`` sets ``RANK`` and ``WORLD_SIZE``) it joins the launcher's
world; otherwise it starts a world of one on a ``FileStore`` in a temporary
directory, so no TCP port is opened for the rendezvous. A CUDA mesh needs
NCCL: without it, or on a group that runs another backend, it raises
rather than carry CUDA tensors over gloo.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device

__all__ = ["make_host_mesh", "make_fleet_mesh", "mesh_axis"]


def _backend_for(device: torch.device) -> str:
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError(
                "a CUDA mesh needs NCCL, and this PyTorch build has none")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device type {device.type!r}")


def _check_backend(device: torch.device) -> None:
    """The running world must carry this device's tensors: NCCL for CUDA,
    anything but NCCL alone for the CPU."""
    backend = str(dist.get_backend()).lower()
    if device.type == "cuda" and "nccl" not in backend:
        raise RuntimeError(
            f"a CUDA mesh needs an NCCL process group; the running group's "
            f"backend is {backend!r}")
    if device.type == "cpu" and backend == "nccl":
        raise RuntimeError(
            "a CPU mesh needs a gloo process group; the running group is "
            "NCCL only")


def _world(device: torch.device) -> int:
    """The world size, starting a process group on ``device``'s backend when
    none runs. Returns the number of ranks."""
    if not dist.is_initialized():
        backend = _backend_for(device)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend)
        else:
            tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
            atexit.register(shutil.rmtree, tmp, ignore_errors=True)
            store = dist.FileStore(os.path.join(tmp, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1)
    _check_backend(device)
    return dist.get_world_size()


def make_host_mesh(model_parallel: int = 1,
                   axis_names: tuple[str, str] = ("data", "model"), *,
                   device=None):
    """A (world / model_parallel, model_parallel) mesh over every rank of
    the world, ranks in row-major order. Raises ``ValueError`` when the
    world does not divide by ``model_parallel``."""
    device = resolve_device(device)
    n = _world(device)
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(
            f"cannot build a host mesh: {n} available device(s) not "
            f"divisible by model_parallel={model_parallel}")
    return DeviceMesh(device.type,
                      torch.arange(n).reshape(n // model_parallel,
                                              model_parallel),
                      mesh_dim_names=tuple(axis_names))


def make_fleet_mesh(num_shards: int | None = None, *, device=None):
    """1-D ``("fleet",)`` mesh for fleet-sharded rollouts
    (:mod:`repro_torch.serving.fleet`) and the data-parallel temporal
    trainer.

    Every rank lands on the fleet axis (``num_shards=None``), or the first
    ``num_shards`` ranks do (scaling curves); a rank outside such a subset
    builds the mesh too (its groups are made collectively) but takes no
    part in it."""
    device = resolve_device(device)
    n = _world(device)
    if num_shards is None:
        num_shards = n
    if not 1 <= num_shards <= n:
        raise ValueError(
            f"cannot build a fleet mesh with {num_shards} shard(s): "
            f"{n} device(s) available")
    return DeviceMesh(device.type, torch.arange(num_shards),
                      mesh_dim_names=("fleet",))


def mesh_axis(mesh: DeviceMesh, axis: str = "fleet"):
    """(process group, this rank's index on ``axis``, the axis size) of a
    mesh. Raises when this rank is not on the mesh."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {names}")
    if mesh.get_coordinate() is None:
        raise ValueError(
            f"rank {dist.get_rank()} is not on this {tuple(mesh.shape)} mesh")
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(names.index(axis)))
