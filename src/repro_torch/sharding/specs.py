"""Placements of the rollout engine's batched pytrees over a fleet mesh
(counterpart of ``engine_state_specs`` and ``arrival_specs`` in
``repro/sharding/specs.py``).

Every leaf of a batched engine state (:func:`repro_torch.serving.engine
.init_batch`) or arrival batch (``materialize_round_batch``) carries a
leading (B,) instance axis. Its placement is ``(Shard(0),)``: the instance
axis split into equal contiguous blocks over the mesh's one axis, the rest
whole. Instances are independent clusters, so per-instance state never
crosses ranks; only summary partials and gradients do.
"""
from __future__ import annotations

from torch.distributed.tensor import Shard

__all__ = ["engine_state_specs", "arrival_specs", "local_block"]


def _leading_axis_spec(x):
    if getattr(x, "ndim", 0) == 0:
        raise ValueError(
            "fleet sharding needs a leading instance axis on every leaf; "
            "got a scalar — batch the pytree first (engine.init_batch / "
            "workloads.materialize_round_batch)")
    return (Shard(0),)


def engine_state_specs(state: dict) -> dict:
    """``{name: (Shard(0),)}`` for a batched engine state."""
    return {k: _leading_axis_spec(v) for k, v in state.items()}


def arrival_specs(arrivals: dict) -> dict:
    """``{name: (Shard(0),)}`` for batched (B, R, A) arrivals, and for any
    other per-instance input of a fleet rollout ((B,) displacement
    flags)."""
    return {k: _leading_axis_spec(v) for k, v in arrivals.items()}


def local_block(tree: dict, specs: dict, index: int, count: int) -> dict:
    """Rank ``index``'s block of each leaf of ``tree`` (numpy arrays or
    tensors, a view where the type allows) under ``specs`` on an axis of
    ``count`` ranks. Every sharded dimension must divide by ``count``."""
    out = {}
    for k, x in tree.items():
        (placement,) = specs[k]
        dim = placement.dim
        n = x.shape[dim]
        if n % count:
            raise ValueError(f"leaf {k!r}: {n} rows along dim {dim} do not "
                             f"divide over {count} ranks")
        size = n // count
        idx = (slice(None),) * dim + (slice(index * size,
                                            (index + 1) * size),)
        out[k] = x[idx]
    return out
