"""Decode strategies (paper §IV-C): greedy and best-of-n sampling from a
per-request candidate set; counterpart of ``repro/core/decode.py``.
Random draws come from an explicit ``torch.Generator`` on the tensors'
device, or from a :class:`BlockDraws` when the tensors are one rank's
block of a batch sharded over ranks. Every categorical draw is the
Gumbel-max rule of :func:`gumbel_argmax`."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.objective import makespan, makespan_batch_samples


def greedy_decode(log_probs) -> torch.Tensor:
    """argmax_q a_qz per request (first index on ties).
    log_probs: (..., Z, Q) -> (..., Z) int32."""
    return torch.argmax(log_probs, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BlockDraws:
    """A source of draws for rows [first, first + n) of a global batch of
    ``total`` rows, where n is the block's own row count. The samplers
    below draw the noise of the global batch from ``generator`` and keep
    this block's rows, so a row's draws do not depend on how the batch is
    split over ranks. A plain ``torch.Generator`` is the block of the whole
    batch."""

    generator: Optional[torch.Generator]
    first: int
    total: int


def uniform(source, shape, device, *, axis: int = 0) -> torch.Tensor:
    """Uniform [0, 1) float32 noise of ``shape`` from ``source`` (a
    ``torch.Generator`` or a :class:`BlockDraws` whose rows lie along
    ``axis``)."""
    if not isinstance(source, BlockDraws):
        return torch.rand(shape, generator=source, device=device)
    full = list(shape)
    full[axis] = source.total
    u = torch.rand(full, generator=source.generator, device=device)
    return u.narrow(axis, source.first, shape[axis])


def gumbel_argmax(source, logits,
                  num_samples: Optional[int] = None) -> torch.Tensor:
    """Draws from the categorical law softmax(logits) over the last axis by
    the Gumbel-max rule: argmax(logits + g), g = -log(-log u). One draw per
    row (``logits.shape[:-1]``), or ``num_samples`` ((S, *shape[:-1])).
    Entries at -1e9 or -inf never win, as g stays below 17 in float32. A
    :class:`BlockDraws` source takes its rows along the first axis of
    ``logits``. int64; no gradient flows."""
    lead = () if num_samples is None else (num_samples,)
    u = uniform(source, lead + tuple(logits.shape), logits.device,
                axis=len(lead))
    return torch.argmax(logits.detach() - torch.log(-torch.log(u)), -1)


def sample_assignments(generator, log_probs,
                       num_samples: int) -> torch.Tensor:
    """Draw S complete assignments from the factorized policy: request z
    goes to edge q with probability exp(log_probs[..., z, q]), independently.
    log_probs: (..., Z, Q) -> (S, ..., Z) int64. No gradient flows."""
    return gumbel_argmax(generator, log_probs, num_samples)


def sampling_decode(generator, inst, log_probs,
                    num_samples: int):
    """Best-of-n sampling decode over the dense (Z, Q) head of one
    instance: sample n complete decisions, evaluate eq (19) for each, and
    return (best_assignment (Z,) int32, best_makespan). The greedy decision
    is always candidate 0 (costless, and it guards the tail of the
    sampling distribution); ties go to the first minimum."""
    samples = sample_assignments(generator, log_probs, num_samples)  # (S, Z)
    samples = torch.cat([greedy_decode(log_probs)[None].long(), samples])
    costs = makespan_batch_samples(inst, samples)
    best = torch.argmin(costs)
    return samples[best].to(torch.int32), costs[best]


def assignment_log_prob(log_probs, assign, req_mask) -> torch.Tensor:
    """log p(pi) = sum_z log a_{x_z, z} over real requests.
    log_probs: (..., Z, Q); assign: (..., Z), possibly with more leading
    axes than ``log_probs`` (S sampled assignments) -> assign's leading
    shape."""
    idx = assign.long()[..., None]
    lp = torch.gather(log_probs.expand(*idx.shape[:-1], log_probs.shape[-1]),
                      -1, idx)[..., 0]
    return (lp * req_mask.to(lp.dtype)).sum(-1)


def sample_candidates(generator, top_idx, top_lp,
                      num_samples: int) -> torch.Tensor:
    """Draw ``num_samples`` complete decisions from the factorized policy
    restricted to each request's candidates: slot k of request z with
    probability softmax(top_lp[z])[k]. top_idx, top_lp: (..., Z, K).
    Returns (S, ..., Z) int64 edge indices."""
    slots = gumbel_argmax(generator, top_lp, num_samples)  # (S, ..., Z)
    cands = top_idx.long().expand(num_samples, *top_idx.shape)
    return torch.gather(cands, -1, slots[..., None])[..., 0]


def topk_sampling_decode(generator, inst, top_idx, top_lp,
                         num_samples: int):
    """Best-of-n sampling from a (Z, K) candidate set: per-sample cost is
    O(Z*K). With K = Q it draws from exactly the eq-19 distribution. The
    greedy decision (``top_idx[..., 0]``) is always a candidate. Returns
    (best_assignment (..., Z), best_makespan (...)); ties in makespan go to
    the earliest candidate, greedy first."""
    samples = sample_candidates(generator, top_idx, top_lp, num_samples)
    samples = torch.cat([top_idx[None, ..., 0].long(), samples], dim=0)
    costs = makespan(inst, samples)  # (S + 1, ...)
    best = torch.argmin(costs, dim=0)  # (...)
    assign = torch.gather(
        samples, 0, best[None, ..., None].expand(1, *samples.shape[1:]))[0]
    return assign.to(torch.int32), torch.gather(costs, 0, best[None])[0]
