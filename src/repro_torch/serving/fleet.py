"""Fleet-sharded rollouts: the batched engine over a device mesh
(counterpart of ``repro/serving/fleet.py``).

The engine (:mod:`repro_torch.serving.engine`) rolls a (B,) batch of
independent cluster instances on one device. This module spreads that
batch over the ranks of a 1-D ``("fleet",)`` mesh
(:func:`repro_torch.launch.mesh.make_fleet_mesh`): each rank takes its
contiguous block of the global batch (the ``(Shard(0),)`` placements of
:mod:`repro_torch.sharding.specs`), rolls it forward with the same
``make_rollout(batch=True)`` on its device, and the per-rank summary
partials (:func:`repro_torch.serving.engine.summarize_partials`: counts, a
fixed-bin response-time histogram, per-edge completions, the response
total and two maxima) are all-reduced over the mesh, MAX for
``engine.PARTIAL_MAX_KEYS`` and SUM for the rest. The partials travel
packed, one buffer per (dtype, operation), so the reduction is three
collectives whatever the number of keys. No slot table leaves its device.

Placement: :func:`zipf_partition` gives each instance a home shard from a
Zipf popularity law over shards, places it capacity-balanced (every rank
holds B/S instances), and marks the instances placed off their home as
displaced; the summary accounts their transfers as cross-shard traffic.
It is the reference's numpy, bit for bit.

Equivalence: instances never interact across ranks, and a sampling
backend's noise is drawn for the global batch on every rank (each keeping
its rows), so a fleet rollout reduces to the single-device engine's
summary on the same placement order and the same seeded generator: counts
and histograms exactly, float sums to rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.decode import BlockDraws
from repro_torch.launch.mesh import mesh_axis
from repro_torch.serving import engine
from repro_torch.sharding.specs import (arrival_specs, engine_state_specs,
                                        local_block)
from repro_torch.workloads.base import edge_weights

__all__ = ["FleetPartition", "zipf_partition", "apply_partition",
           "make_fleet_rollout", "fleet_summary"]


@dataclasses.dataclass(frozen=True)
class FleetPartition:
    """Instance-to-shard assignment for one fleet rollout.

    ``home`` is the Zipf-drawn region of each instance; ``shard`` the
    capacity-balanced placement actually used on the mesh; ``order`` the
    permutation that groups placements into the contiguous (B/S)-blocks
    the ranks take (apply it with :func:`apply_partition` before
    running)."""

    num_shards: int
    home: np.ndarray   # (B,) int — Zipf-popular home shard per instance
    shard: np.ndarray  # (B,) int — balanced placement shard per instance
    order: np.ndarray  # (B,) int — permutation grouping placement shards

    @property
    def displaced(self) -> np.ndarray:
        """(B,) bool, instance order: placed off its home shard."""
        return self.home != self.shard

    @property
    def placed_displaced(self) -> np.ndarray:
        """(B,) bool in *placement* order — pass this to the fleet rollout
        so cross-shard accounting travels with the reordered instances."""
        return self.displaced[self.order]

    def imbalance_report(self, loads=None) -> dict:
        """How skewed the requested (home) load was vs what each shard
        actually runs. ``loads`` weights instances (e.g. real arrival
        counts from an arrival batch's ``mask.sum``); defaults to 1 per
        instance. ``home_imbalance`` is max/mean of per-shard home load —
        1.0 is perfectly uniform."""
        b = len(self.home)
        loads = np.ones(b) if loads is None else np.asarray(loads, float)
        home_load = np.bincount(self.home, weights=loads,
                                minlength=self.num_shards)
        placed_load = np.bincount(self.shard, weights=loads,
                                  minlength=self.num_shards)
        mean = max(loads.sum() / self.num_shards, 1e-12)
        displaced = int(self.displaced.sum())
        return {
            "num_shards": self.num_shards,
            "capacity": b // self.num_shards,
            "home_load": [float(x) for x in home_load],
            "placed_load": [float(x) for x in placed_load],
            "home_imbalance": float(home_load.max() / mean),
            "placed_imbalance": float(placed_load.max() / mean),
            "displaced_instances": displaced,
            "displaced_frac": displaced / max(b, 1),
        }


def zipf_partition(num_instances: int, num_shards: int, *, skew: float = 0.0,
                   seed: int = 0) -> FleetPartition:
    """Draw each instance's home shard from a Zipf popularity law
    (rank-k shard has weight (k+1)^-skew; ``skew=0`` is uniform) and place
    instances with a capacity-balanced first-fit: home shard while it has
    room, else the least-loaded shard with remaining capacity. The gap
    between the two is exactly the load the fleet must move cross-shard."""
    if num_instances % num_shards != 0:
        raise ValueError(
            f"cannot partition {num_instances} instance(s) over "
            f"{num_shards} shard(s): the ranks need equal blocks "
            f"(instances % shards == 0)")
    probs = edge_weights(num_shards, skew)
    rng = np.random.default_rng(seed)
    home = rng.choice(num_shards, size=num_instances, p=probs)
    cap = num_instances // num_shards
    counts = np.zeros(num_shards, np.int64)
    shard = np.empty(num_instances, np.int64)
    for i, h in enumerate(home):
        if counts[h] < cap:
            shard[i] = h
        else:
            shard[i] = int(np.argmin(np.where(counts < cap, counts,
                                              num_instances + 1)))
        counts[shard[i]] += 1
    order = np.argsort(shard, kind="stable")
    return FleetPartition(num_shards=num_shards, home=home, shard=shard,
                          order=order)


def apply_partition(part: FleetPartition, tree: dict) -> dict:
    """Reorder a batched dict's leading instance axis into the partition's
    placement order (contiguous per-shard blocks). Numpy arrays stay numpy;
    tensors stay on their device."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, torch.Tensor):
            out[k] = x[torch.as_tensor(part.order, device=x.device)]
        else:
            out[k] = np.asarray(x)[part.order]
    return out


def all_reduce_partials(partials: dict, group) -> dict:
    """Reduce summary partials over ``group`` in place of one collective
    per key: the values are packed into one flat buffer per (dtype,
    operation), MAX for ``engine.PARTIAL_MAX_KEYS`` and SUM for the rest.
    Every rank gets the same dict back."""
    buckets: dict = {}
    for k, v in partials.items():
        op = (dist.ReduceOp.MAX if k in engine.PARTIAL_MAX_KEYS
              else dist.ReduceOp.SUM)
        buckets.setdefault((v.dtype, op), []).append(k)
    out = {}
    for (_, op), keys in buckets.items():
        flat = torch.cat([partials[k].reshape(-1) for k in keys])
        dist.all_reduce(flat, op=op, group=group)
        for k, part in zip(keys, torch.split(
                flat, [partials[k].numel() for k in keys])):
            out[k] = part.reshape(partials[k].shape)
    return {k: out[k] for k in partials}


def make_fleet_rollout(cfg: engine.EngineConfig, assign_fn, mesh, *,
                       axis: str = "fleet",
                       hist_bins: int = engine.HIST_BINS,
                       hist_max: float = engine.HIST_MAX,
                       slo: Optional[float] = None,
                       drain_to: Optional[float] = engine.DRAIN_HORIZON):
    """Build ``run(states, arrivals, generator=None, displaced=None) ->
    partials``: the fleet-sharded twin of ``make_rollout(batch=True)`` +
    ``summarize_partials``.

    Every rank of ``mesh`` calls ``run`` with the same global batch: the
    (B,)-leading ``init_batch`` states (on the mesh's device type) and
    ``materialize_round_batch`` arrivals, reordered with
    :func:`apply_partition` when a skewed partition places them. B must
    divide by the mesh's ``axis`` size. Each rank rolls its block and
    returns the reduced partials dict, the same on every rank; feed it to
    :func:`fleet_summary`. ``displaced`` is
    ``FleetPartition.placed_displaced`` and drives the cross-shard transfer
    split. ``generator`` reaches ``assign_fn`` on each rank as a
    :class:`~repro_torch.core.decode.BlockDraws` of the rank's rows: a
    sampling backend draws the global batch's noise and keeps its block,
    so an instance's draws are those of the single-device rollout given
    the same seeded generator, whatever the number of shards."""
    group, index, num_shards = mesh_axis(mesh, axis)
    inner = engine.make_rollout(cfg, assign_fn, batch=True, drain_to=drain_to)

    def run(states, arrivals, generator=None, displaced=None):
        b = int(np.shape(arrivals["size"])[0])
        if b % num_shards != 0:
            raise ValueError(
                f"batch of {b} instance(s) does not divide over the "
                f"{num_shards}-shard fleet axis {axis!r}; pad the batch or "
                f"shrink the mesh")
        device = states["t"].device
        if device.type != mesh.device_type:
            raise ValueError(f"states on {device} but the mesh is "
                             f"{mesh.device_type!r}")
        if displaced is None:
            displaced = np.zeros(b, bool)
        local_states = local_block(states, engine_state_specs(states), index,
                                   num_shards)
        inputs = dict(arrivals, displaced=displaced)
        local_arr = local_block(inputs, arrival_specs(inputs), index,
                                num_shards)
        local_disp = local_arr.pop("displaced")
        if generator is not None:
            generator = BlockDraws(generator, index * (b // num_shards), b)
        final, _ = inner(local_states, local_arr, generator)
        partials = engine.summarize_partials(
            final, hist_bins=hist_bins, hist_max=hist_max,
            displaced=local_disp, slo=slo)
        return all_reduce_partials(partials, group)

    return run


def fleet_summary(partials: dict, *, slo: Optional[float] = None,
                  hist_max: float = engine.HIST_MAX) -> dict:
    """Reduced fleet partials -> ``summarize``-style metrics dict
    (alias of :func:`repro_torch.serving.engine.partials_to_summary`)."""
    return engine.partials_to_summary(partials, slo=slo, hist_max=hist_max)
