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
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.convert import (BF16_BITS, host_array,
                                            load_reference_params,
                                            read_reference_checkpoint,
                                            split_prefix)
from repro_torch.nn.module import named_leaves as flatten_tree
from repro_torch.nn.module import param_tree, state_tree


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
    """The tree with every tensor copied to host numpy, so a save can go on
    while the caller updates its tensors in place."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return host_array(tree)
    return np.array(tree)


class Checkpointer:
    """Keep-K periodic checkpoints under ``root/step_XXXXXXXXXX`` with a
    ``LATEST`` pointer file. With ``async_save`` (the default, as in the
    reference) ``save`` copies the tree to host numpy and writes it on a
    background thread; a second ``save`` waits for the first, and
    ``wait()`` joins before the checkpoint is read or the process exits."""

    def __init__(self, root: str, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.root = root
        self.every = max(every, 1)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def save(self, step: int, tree, extras: Optional[dict] = None) -> None:
        self.wait()
        host_tree = _host_copy(tree)

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

        if self.async_save:
            self._thread = threading.Thread(target=background, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self) -> None:
        """Join the save in flight, if any; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.root, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip())

    def restore_latest(self) -> Optional[dict]:
        """{"step", "tree": {"/"-path: ndarray}, "extras"} of the latest
        checkpoint, or None when there is none. Waits for this
        checkpointer's save in flight first."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        directory = self._dir(step)
        with open(os.path.join(directory, "manifest.json")) as f:
            extras = json.load(f).get("extras", {})
        return {"step": step, "tree": read_reference_checkpoint(directory),
                "extras": extras}

    def _gc(self) -> None:
        dirs = sorted(d for d in os.listdir(self.root) if d.startswith("step_"))
        for d in dirs[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
