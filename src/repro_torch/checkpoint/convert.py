"""Weight bridge from the reference's checkpoints to the port's policy and
LM.

The reference writes a pytree as ``arrays.npz`` plus ``manifest.json``,
whose ``leaves`` list each leaf's "/"-joined pytree path, its array name,
dtype and shape (``repro/checkpoint/checkpointer.py:39-84``). Numpy alone
reads it. The port's state-dict keys are those paths with ``.`` for ``/``
and the same (in, out) layout, so leaves copy one for one. The LM's
reference params stack the layers on a leading L axis
(``repro/models/lm.py:67-68``); :func:`load_reference_lm_params` splits
them onto the port's per-layer leaves. An LM training checkpoint
(``{"params", "opt_state"}``, Adam's or Adafactor's state keyed as the
params) is written in that stacked layout by :func:`lm_train_tree` and
read back by :func:`load_lm_train_state`, so either package resumes the
other's ``train lm`` run.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch
from torch import nn

from repro_torch.nn.module import named_leaves, param_tree, state_tree


def read_reference_checkpoint(directory: str) -> dict[str, np.ndarray]:
    """{"/"-path: ndarray} of every leaf of a reference checkpoint. A bf16
    leaf comes back as numpy's 2-byte void (``|V2``), the bits that
    ``np.savez`` stored; :func:`reference_tensor` reads it as bf16."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(directory, "arrays.npz")) as data:
        for leaf in manifest["leaves"]:
            arr = data[leaf["name"]]
            if list(arr.shape) != list(leaf["shape"]):
                raise ValueError(f"checkpoint leaf {leaf['key']!r} has shape "
                                 f"{arr.shape}, manifest says {leaf['shape']}")
            if arr.dtype == BF16_BITS and leaf["dtype"] != "bfloat16":
                raise ValueError(f"checkpoint leaf {leaf['key']!r} holds "
                                 f"2-byte void data of dtype {leaf['dtype']}")
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


#: how ``np.savez`` stores a bf16 array (``ml_dtypes``' bfloat16 in memory)
BF16_BITS = np.dtype("V2")


def reference_tensor(arr) -> torch.Tensor:
    """A CPU tensor of a reference leaf. bf16 numpy arrays (dtype name
    ``bfloat16``, from ``ml_dtypes``, which ``torch.tensor`` refuses, or
    the ``|V2`` that a checkpoint file holds) are reinterpreted bit for
    bit through int16, without importing ``ml_dtypes``."""
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16" or arr.dtype == BF16_BITS:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t`` as the reference's checkpoints store it:
    bf16 as its bits in ``|V2``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS).copy()
    return t.numpy().copy()


# a layer's leaf in the port, ``<prefix>layers/<i>/<rest>`` or whisper's
# encoder ``<prefix>enc_layers/<i>/<rest>``
_LAYER_PATH = re.compile(r"^((?:.*/)?(?:enc_)?layers)/(\d+)/(.*)$")


def _layer_groups(flat: dict) -> dict[str, tuple[bool, list]]:
    """{reference path: (stacked, [values in layer order])} of {port
    "/"-path: value}: the leaves ``<prefix>layers/<i>/<rest>`` of all i
    form ``<prefix>layers/<rest>``, stacked on a leading L axis in the
    reference (``enc_layers`` likewise); any other leaf is its own."""
    groups = {}
    for key, value in flat.items():
        m = _LAYER_PATH.match(key)
        if m:
            by_layer = groups.setdefault(f"{m[1]}/{m[3]}", (True, {}))[1]
            by_layer[int(m[2])] = value
        else:
            groups[key] = (False, {0: value})
    return {k: (stacked, [by[i] for i in sorted(by)])
            for k, (stacked, by) in groups.items()}


def lm_param_groups(params: dict) -> dict[str, list[torch.Tensor]]:
    """{reference "/"-path: [port tensors]} of an LM's params: one tensor
    for a top-level leaf, one per layer (in order) for a ``layers/`` leaf."""
    groups = _layer_groups(named_leaves(params))
    return {k: tensors for k, (_, tensors) in groups.items()}


def stack_layers(flat: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """{port "/"-path: tensor} -> {reference path: tensor}, each layer leaf
    stacked in layer order (:func:`_layer_groups`)."""
    return {k: torch.stack(ts) if stacked else ts[0]
            for k, (stacked, ts) in _layer_groups(flat).items()}


def unstack_into(targets: dict[str, torch.Tensor], flat: dict) -> None:
    """Copy reference leaves ({reference path: array}, layers stacked, f32
    or bf16) into the port's tensors ({port path: tensor}) in place, row i
    of a stacked leaf into layer i's. Raises on a missing leaf, an extra
    leaf, or a shape mismatch."""
    groups = _layer_groups(targets)
    missing = sorted(set(groups) - set(flat))
    extra = sorted(set(flat) - set(groups))
    if missing or extra:
        raise KeyError(f"checkpoint leaves do not match the port's: missing "
                       f"{missing}, unexpected {extra}")
    for key, (stacked, tensors) in groups.items():
        src = reference_tensor(flat[key])
        want = ((len(tensors), *tensors[0].shape) if stacked
                else tuple(tensors[0].shape))
        if tuple(src.shape) != tuple(want):
            raise ValueError(f"shape mismatch for leaf {key!r}: checkpoint "
                             f"{tuple(src.shape)}, port {tuple(want)}")
        with torch.no_grad():
            for i, t in enumerate(tensors):
                t.copy_(src[i] if stacked else src)


def load_reference_lm_params(params: dict, flat: dict) -> None:
    """Copy a reference LM's leaves ({"/"-path: array}, layers stacked on a
    leading L axis, f32 or bf16) into the port's ``params`` in place.
    Raises on a missing leaf, an extra leaf, or a shape mismatch."""
    unstack_into(named_leaves(params), flat)


def lm_train_tree(params: dict, opt_state: dict) -> dict[str, torch.Tensor]:
    """An LM training state as the reference's ``train lm`` checkpoints it:
    {"params/...", "opt_state/..." path: tensor} with every layer leaf
    stacked (:func:`stack_layers`); ``Checkpointer.save`` writes it."""
    return stack_layers({**named_leaves(params, "params"),
                         **named_leaves(opt_state, "opt_state")})


def load_lm_train_state(params: dict, opt_state: dict, flat: dict) -> None:
    """Copy an LM training checkpoint ({"/"-path: array}, written by
    either package's ``train lm``) into ``params`` and ``opt_state`` in
    place; ``opt_state`` is a fresh state of the optimizer that wrote it."""
    unstack_into({**named_leaves(params, "params"),
                  **named_leaves(opt_state, "opt_state")}, flat)
