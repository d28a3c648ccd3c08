"""Weight bridge from the reference's checkpoints to the port's policy and
LM.

The reference writes a pytree as ``arrays.npz`` plus ``manifest.json``,
whose ``leaves`` list each leaf's "/"-joined pytree path, its array name,
dtype and shape (``repro/checkpoint/checkpointer.py:39-84``). Numpy alone
reads it. The port's state-dict keys are those paths with ``.`` for ``/``
and the same (in, out) layout, so leaves copy one for one. The LM's
reference params stack the layers on a leading L axis
(``repro/models/lm.py:67-68``); :func:`load_reference_lm_params` splits
them onto the port's per-layer leaves.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch import nn

from repro_torch.nn.module import param_tree, state_tree


def read_reference_checkpoint(directory: str) -> dict[str, np.ndarray]:
    """{"/"-path: ndarray} of every leaf of a reference checkpoint."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(directory, "arrays.npz")) as data:
        for leaf in manifest["leaves"]:
            arr = data[leaf["name"]]
            if list(arr.shape) != list(leaf["shape"]):
                raise ValueError(f"checkpoint leaf {leaf['key']!r} has shape "
                                 f"{arr.shape}, manifest says {leaf['shape']}")
            out[leaf["key"]] = arr
    return out


def split_prefix(flat: dict, prefix: str) -> dict:
    """The leaves under ``prefix/`` with the prefix removed, e.g. the
    ``params`` and ``state`` halves of a ``{"params", "state"}`` checkpoint."""
    head = prefix.rstrip("/") + "/"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


def _copy_leaves(kind: str, targets: dict[str, torch.Tensor], flat: dict):
    missing = sorted(set(targets) - set(flat))
    extra = sorted(set(flat) - set(targets))
    if missing or extra:
        raise KeyError(f"reference {kind} do not match the policy: missing "
                       f"{missing}, unexpected {extra}")
    for key, t in targets.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {kind} leaf {key!r}: "
                             f"reference {arr.shape}, policy {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.tensor(arr, dtype=t.dtype))


def load_reference_params(policy: nn.Module, params_flat: dict,
                          state_flat: dict) -> None:
    """Copy reference parameter and norm-state leaves ({"/"-path: array})
    into ``policy`` in place. Raises on a missing leaf, an extra leaf, or a
    shape mismatch."""
    _copy_leaves("params", param_tree(policy), params_flat)
    _copy_leaves("state", state_tree(policy), state_flat)


def reference_tensor(arr) -> torch.Tensor:
    """A CPU tensor of a reference leaf. bf16 numpy arrays (dtype name
    ``bfloat16``, from ``ml_dtypes``, which ``torch.tensor`` refuses) are
    reinterpreted bit for bit through int16, without importing
    ``ml_dtypes``."""
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def lm_param_groups(params: dict) -> dict[str, list[torch.Tensor]]:
    """{reference "/"-path: [port tensors]} of an LM's params: one tensor
    for a top-level leaf, one per layer (in order) for a ``layers/`` leaf."""
    groups: dict[str, list[torch.Tensor]] = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                walk(sub, f"{prefix}/{key}" if prefix else str(key))
        else:
            groups.setdefault(prefix, []).append(tree)

    for key, sub in params.items():
        if key == "layers":
            for layer in sub:
                walk(layer, "layers")
        else:
            walk(sub, key)
    return groups


def load_reference_lm_params(params: dict, flat: dict) -> None:
    """Copy a reference LM's leaves ({"/"-path: array}, layers stacked on a
    leading L axis, f32 or bf16) into the port's ``params`` in place.
    Raises on a missing leaf, an extra leaf, or a shape mismatch."""
    groups = lm_param_groups(params)
    missing = sorted(set(groups) - set(flat))
    extra = sorted(set(flat) - set(groups))
    if missing or extra:
        raise KeyError(f"reference params do not match the LM: missing "
                       f"{missing}, unexpected {extra}")
    n_layers = len(params["layers"])
    for key, tensors in groups.items():
        src = reference_tensor(flat[key])
        stacked = key.startswith("layers/")
        want = ((n_layers, *tensors[0].shape) if stacked
                else tuple(tensors[0].shape))
        if tuple(src.shape) != tuple(want):
            raise ValueError(f"shape mismatch for LM leaf {key!r}: "
                             f"reference {tuple(src.shape)}, port {want}")
        with torch.no_grad():
            for i, t in enumerate(tensors):
                t.copy_(src[i] if stacked else src)
