"""Checkpoints in the reference's own format, written by the port.

A tree of nested dicts of tensors is stored as ``arrays.npz`` plus a
``manifest.json`` whose ``leaves`` give each leaf's "/"-joined path, its
array name, dtype and shape (``repro/checkpoint/checkpointer.py:39-58``).
A bf16 leaf is stored as the reference stores it, its bits in numpy's
``|V2`` with the manifest dtype ``bfloat16``. A training checkpoint holds
``{"params", "state", "opt_state"}`` under the reference's paths, so a
policy trained by the port loads into the reference with its
``restore_pytree``, and back into the port with :func:`load_train_state`.
Writes go to ``<dir>.tmp`` and are renamed into place, so a reader never
sees half a checkpoint; :class:`Checkpointer` writes on a background
thread, as the reference's does.

In a world of several ranks (``torch.distributed``) rank 0 alone writes.
A tree holding DTensors is saved by every rank with its own blocks: each
DTensor leaf is gathered whole (a collective, leaf by leaf in path order)
and ``wait()`` holds every rank until the write has landed; a plain tree
may be saved by rank 0 alone. ``restore_latest(template, specs=, mesh=)``
is the
counterpart of the reference's ``restore_latest(template, shardings)``:
every rank reads the same full arrays and keeps its own block on any mesh
that fits, so a run resumes on another world size (elastic restart,
:mod:`repro_torch.launch.elastic`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.checkpoint.convert import (BF16_BITS, host_array,
                                            load_reference_params,
                                            read_reference_checkpoint,
                                            split_prefix, unstack_leaves)
from repro_torch.nn.module import named_leaves as flatten_tree
from repro_torch.nn.module import param_tree, state_tree
from repro_torch.sharding.specs import placements


def train_tree(policy, opt_state: Optional[dict] = None) -> dict:
    """The training state under the reference's paths."""
    tree = {"params": param_tree(policy), "state": state_tree(policy)}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    return tree


def save_pytree(tree, directory: str, extras: Optional[dict] = None) -> None:
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest, arrays = [], {}
    for i, (key, leaf) in enumerate(flatten_tree(tree).items()):
        name = f"arr_{i}"
        if isinstance(leaf, torch.Tensor):
            leaf = host_array(leaf)
        arrays[name] = np.asarray(leaf)
        dtype = arrays[name].dtype
        manifest.append({"key": key, "name": name,
                         "dtype": ("bfloat16" if dtype == BF16_BITS
                                   else str(dtype)),
                         "shape": list(arrays[name].shape)})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"leaves": manifest, "extras": extras or {}}, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)


def load_train_state(policy, flat: dict) -> Optional[dict]:
    """Load the ``params`` and ``state`` of a training checkpoint
    ({"/"-path: array}) into ``policy`` in place; return its optimizer
    state on the policy's device, or None when it has none."""
    load_reference_params(policy, split_prefix(flat, "params"),
                          split_prefix(flat, "state"))
    if "opt_state/step" not in flat:
        return None
    device = policy.device

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(device)

    return {"step": t(flat["opt_state/step"]),
            "m": {k: t(a) for k, a in split_prefix(flat, "opt_state/m").items()},
            "v": {k: t(a) for k, a in split_prefix(flat, "opt_state/v").items()}}


def _host_copy(tree):
    """The tree with every tensor copied to host numpy (a DTensor gathered
    whole first), so a save can go on while the caller updates its tensors
    in place."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return host_array(tree)
    return np.array(tree)


def _world() -> int:
    """The ranks of the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _rebuild(template, leaf, prefix: str = ""):
    """``template``'s structure (nested dicts and lists) with each leaf
    replaced by ``leaf(path)``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, leaf, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, list):
        return [_rebuild(v, leaf, f"{prefix}/{i}")
                for i, v in enumerate(template)]
    return leaf(prefix)


class Checkpointer:
    """Keep-K periodic checkpoints under ``root/step_XXXXXXXXXX`` with a
    ``LATEST`` pointer file. With ``async_save`` (the default, as in the
    reference) ``save`` copies the tree to host numpy and writes it on a
    background thread; a second ``save`` waits for the first, and
    ``wait()`` joins before the checkpoint is read or the process exits.

    In a world of several ranks rank 0 alone writes. A tree holding
    DTensors is saved by every rank (the gather of a sharded leaf is a
    collective), and ``wait()`` after it joins rank 0's write and then
    holds every rank until it has landed; a failed write raises on every
    rank, the error itself on rank 0."""

    def __init__(self, root: str, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.root = root
        self.every = max(every, 1)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._unsynced = False  # a save the other ranks have not waited on
        os.makedirs(root, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def save(self, step: int, tree, extras: Optional[dict] = None) -> None:
        self.wait()
        writer = not dist.is_initialized() or dist.get_rank() == 0
        # a tree holding DTensors is saved by every rank (its gathers are
        # collectives); wait() then holds them until rank 0's write lands
        collective = _world() > 1 and any(
            isinstance(x, DTensor) for x in flatten_tree(tree).values())
        if not (writer or collective):
            return
        host_tree = _host_copy(tree)
        self._unsynced = collective

        def work():
            save_pytree(host_tree, self._dir(step), extras)
            tmp = os.path.join(self.root, "LATEST.tmp")
            with open(tmp, "w") as f:
                f.write(str(step))
            os.replace(tmp, os.path.join(self.root, "LATEST"))
            self._gc()

        def background():
            try:
                work()
            except BaseException as e:  # raised again by wait()
                self._error = e

        if writer and self.async_save:
            self._thread = threading.Thread(target=background, daemon=True)
            self._thread.start()
        elif writer:
            background()
        if not self.async_save:
            self.wait()  # raises a failed write, in a world on every rank

    def wait(self) -> None:
        """Join the save in flight, if any; raise what it raised. After a
        save of DTensors in a world of several ranks, every rank must call
        it: it holds them until rank 0's write has landed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._unsynced:
            self._unsynced = False
            failed = self._sync_failure()
            if failed and self._error is None:
                raise RuntimeError(f"rank 0 failed to write the checkpoint "
                                   f"under {self.root}")
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _sync_failure(self) -> bool:
        """Whether rank 0's write failed, agreed by every rank (one
        all-reduce, on the card under NCCL)."""
        device = "cpu"
        if "nccl" in str(dist.get_backend()).lower():
            device = torch.device("cuda", torch.cuda.current_device())
        flag = torch.tensor([int(self._error is not None)], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.root, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip())

    def restore_latest(self, template=None, *, specs=None,
                       mesh=None) -> Optional[dict]:
        """{"step", "tree", "extras"} of the latest checkpoint, or None when
        there is none. Waits for this checkpointer's save in flight first.

        Without a template the tree is {"/"-path: ndarray}, the file's
        leaves. With one (a tree of the port's tensors, ``meta`` ones
        included, e.g. ``{"params", "opt_state"}`` from
        ``launch.steps.param_and_opt_shapes``), the tree has its structure:
        each leaf a CPU tensor in the file's dtype, a layer's row of the
        file's stacked leaf (``convert.unstack_leaves``; ``KeyError`` for a
        missing leaf, ``ValueError`` for a shape mismatch). With ``specs``
        (a matching tree of {path: spec} dicts, e.g. ``{"params":
        param_specs(...), "opt_state": opt_state_specs(...)}``) and
        ``mesh``, each leaf is a DTensor on its spec's placements on
        ``mesh``'s device: every rank reads the same full arrays and keeps
        its own block; nothing is sent."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        directory = self._dir(step)
        with open(os.path.join(directory, "manifest.json")) as f:
            extras = json.load(f).get("extras", {})
        tree = read_reference_checkpoint(directory)
        if template is None:
            return {"step": step, "tree": tree, "extras": extras}
        values = unstack_leaves(flatten_tree(template), tree)
        del tree
        if specs is None:
            return {"step": step, "tree": _rebuild(template, values.pop),
                    "extras": extras}
        flat_specs = flatten_tree(specs)
        device = torch.device(mesh.device_type)

        def placed(path):  # one leaf on the device at a time
            return distribute_tensor(
                values.pop(path).to(device), mesh,
                placements(flat_specs[path], mesh), src_data_rank=None)

        return {"step": step, "tree": _rebuild(template, placed),
                "extras": extras}

    def _gc(self) -> None:
        dirs = sorted(d for d in os.listdir(self.root) if d.startswith("step_"))
        for d in dirs[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
