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

:func:`make_production_mesh` is the dry run's: the reference's 256-chip
pod, or two of them, over a fake world of that many ranks in this one
process (PyTorch's fake process group: collectives return at once and move
nothing), for steps traced on fake tensors
(:mod:`repro_torch.launch.dryrun`). It cannot share a process with a real
world.
"""
from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device

__all__ = ["make_host_mesh", "make_fleet_mesh", "make_production_mesh",
           "make_fake_mesh", "mesh_axis"]

#: The fake world's backend name (``torch.testing``'s fake process group).
FAKE_BACKEND = "fake"


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


def _fake_world(n: int) -> None:
    """A fake world of ``n`` ranks, this process rank 0; an earlier fake
    world of another size is replaced. Raises when a real process group
    runs."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if str(dist.get_backend()) != FAKE_BACKEND:
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group runs in this "
                "process; the dry run's fake world needs a process of its "
                "own (python -m repro_torch.launch.dryrun)")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0,
                            world_size=n)


def make_fake_mesh(shape: tuple, axes: tuple, *, device=None):
    """A mesh of ``shape`` with ``axes`` over a fake world of as many ranks
    (the module's docstring). ``device`` names the ranks' device type
    (CUDA unless ``"cpu"``); nothing runs on it."""
    device = resolve_device(device)
    n = math.prod(shape)
    _fake_world(n)
    return DeviceMesh(device.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 ranks per pod, ("data", "model"); multi-pod = 2 pods =
    512 ranks, ("pod", "data", "model"), over a fake world
    (:func:`make_fake_mesh`)."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"),
                              device=device)
    return make_fake_mesh((16, 16), ("data", "model"), device=device)


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


def make_fleet_mesh(num_shards: int | None = None, *, dry_run: bool = False,
                    device=None):
    """1-D ``("fleet",)`` mesh for fleet-sharded rollouts
    (:mod:`repro_torch.serving.fleet`) and the data-parallel temporal
    trainer.

    Every rank lands on the fleet axis (``num_shards=None``), or the first
    ``num_shards`` ranks do (scaling curves); a rank outside such a subset
    builds the mesh too (its groups are made collectively) but takes no
    part in it. With ``dry_run=True`` the 256-rank
    :func:`make_production_mesh` pod is flattened onto one fleet axis
    (its fake world)."""
    if dry_run:
        prod = make_production_mesh(device=device)
        return DeviceMesh(prod.device_type, prod.mesh.reshape(-1),
                          mesh_dim_names=("fleet",))
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
