"""Decode strategies (paper §IV-C): greedy and best-of-n sampling from a
per-request candidate set; counterpart of ``repro/core/decode.py``.
Random draws come from an explicit ``torch.Generator`` on the tensors'
device."""
from __future__ import annotations

import torch

from repro_torch.core.objective import makespan, makespan_batch_samples


def greedy_decode(log_probs) -> torch.Tensor:
    """argmax_q a_qz per request (first index on ties).
    log_probs: (..., Z, Q) -> (..., Z) int32."""
    return torch.argmax(log_probs, dim=-1).to(torch.int32)


def sample_assignments(generator: torch.Generator, log_probs,
                       num_samples: int) -> torch.Tensor:
    """Draw S complete assignments from the factorized policy: request z
    goes to edge q with probability exp(log_probs[..., z, q]), independently.
    log_probs: (..., Z, Q) -> (S, ..., Z) int64. No gradient flows."""
    probs = torch.exp(log_probs.detach())
    q = probs.shape[-1]
    draws = torch.multinomial(probs.reshape(-1, q), num_samples,
                              replacement=True, generator=generator)
    return draws.T.reshape(num_samples, *log_probs.shape[:-1])


def sampling_decode(generator: torch.Generator, inst, log_probs,
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


def sample_candidates(generator: torch.Generator, top_idx, top_lp,
                      num_samples: int) -> torch.Tensor:
    """Draw ``num_samples`` complete decisions from the factorized policy
    restricted to each request's candidates: slot k of request z with
    probability softmax(top_lp[z])[k]. top_idx, top_lp: (..., Z, K).
    Returns (S, ..., Z) int64 edge indices."""
    probs = torch.softmax(top_lp, dim=-1)
    k = probs.shape[-1]
    slots = torch.multinomial(probs.reshape(-1, k), num_samples,
                              replacement=True, generator=generator)
    slots = slots.T.reshape(num_samples, *top_lp.shape[:-1])  # (S, ..., Z)
    cands = top_idx.long().expand(num_samples, *top_idx.shape)
    return torch.gather(cands, -1, slots[..., None])[..., 0]


def topk_sampling_decode(generator: torch.Generator, inst, top_idx, top_lp,
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
