"""The activation-sharding context (counterpart of
``repro/sharding/ctx.py``).

Model code stays shard-agnostic: the step builders
(:mod:`repro_torch.launch.steps`) install a context, and the model calls
:func:`constrain` at a few boundaries (the embedding output, the residual
stream, the logits, the decode rows). Outside a context every call returns
its input, so the meshless paths never touch mesh machinery. Inside one,
the activations are DTensors, and :func:`constrain` redistributes its
input to the placements of the boundary's spec, the counterpart of the
reference's ``with_sharding_constraint``. A plain tensor inside a context
is an error: it means an activation left the mesh.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Optional

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.sharding.specs import placements

__all__ = ["ShardCtx", "current", "use_sharding", "constrain",
           "split_heads", "REDISTRIBUTES"]

_TLS = threading.local()

#: Redistributions the sharded LM path made, by site: ``constrain``'s
#: kinds and the kernel wrappers' own (``repro_torch.kernels.ops``). Each
#: counts one per call that moved data between placements.
REDISTRIBUTES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """A step's mesh and the roles of its axes (``specs.mesh_axes``):
    ``dp_axes`` the batch axes ("data",) or ("pod", "data"), ``tp_axis``
    the tensor-parallel axis (None under the "dp" layout), ``fsdp_axis``
    the weights' storage axes, ``seq_shard`` sequence parallelism on the
    residual stream, ``batch_divisible`` False when the global batch does
    not divide over the batch axes (it is then replicated)."""
    mesh: object
    dp_axes: tuple
    tp_axis: Optional[str] = "model"
    fsdp_axis: object = "data"
    seq_shard: bool = False
    batch_divisible: bool = True

    @property
    def dp(self):
        return self.dp_axes if self.batch_divisible else None


def current() -> Optional[ShardCtx]:
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: ShardCtx):
    prev = current()
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


def _spec_for(kind: str, ctx: ShardCtx, ndim: int) -> tuple:
    dp = ctx.dp
    seq = ctx.tp_axis if ctx.seq_shard else None
    if kind == "residual":        # (B, S, D)
        return (dp, seq, None)
    if kind == "tokens":          # (B, S)
        return (dp, None)
    if kind == "logits":          # (B, S, V) or (B, V)
        if ndim == 2:
            return (dp, ctx.tp_axis)
        return (dp, None, ctx.tp_axis)
    if kind == "decode_x":        # (B, D)
        return (dp, None)
    raise ValueError(kind)


def redistribute(x: DTensor, spec: tuple, site: str) -> DTensor:
    """``x`` on the placements of ``spec`` over the current context's
    mesh, counted under ``site`` in :data:`REDISTRIBUTES` when that moves
    anything."""
    mesh = current().mesh
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    REDISTRIBUTES[site] += 1
    return x.redistribute(mesh, want)


def constrain(x, kind: str):
    ctx = current()
    if ctx is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(
            f"constrain({kind!r}) inside a sharding context got a plain "
            f"{type(x).__name__}: the activation left the mesh")
    return redistribute(x, _spec_for(kind, ctx, x.ndim), kind)


def split_heads(x, n: int, hd: int):
    """``x`` (..., n * hd) as (..., n, hd). A DTensor whose last dimension
    a mesh axis splits into parts that are not whole heads (the axis size
    does not divide ``n``: qwen3-4b's 8 KV heads on a 16-wide ``model``
    axis) is brought whole on that axis first, counted under "heads"."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        mesh = x.device_mesh
        want = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                     and n % mesh.size(i) else p
                     for i, p in enumerate(x.placements))
        if want != tuple(x.placements):
            REDISTRIBUTES["heads"] += 1
            x = x.redistribute(mesh, want)
    return x.reshape(*x.shape[:-1], n, hd)
