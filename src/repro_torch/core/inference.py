"""Unified real-time decision path (paper §IV-C + Fig. 2 step iv) in
PyTorch; counterpart of ``repro/core/inference.py``.

A decision is one mask-invariant, fixed-shape forward (:func:`corais_encode`
+ the eq 16-17 head) followed by a decode (greedy argmax or best-of-n
sampling), configured by one frozen :class:`DecisionSpec`:

    materialized (``fused_decode=False``) — :func:`corais_score` emits the
        full (Z, Q) log-prob matrix; greedy argmaxes it, sampled dispatch
        takes its stable top-k.
    fused (``fused_decode=True``) — :func:`corais_score_decode` does the
        argmax/top-k inside the scoring kernel, so on the card the decision
        never writes (Z, Q) to device memory.

Entry points: :func:`policy_decide` (one decision) and
:func:`make_decision_fn` (a decision function bound to a policy and spec,
used by the serving fast path). Both run eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.decode import greedy_decode, topk_sampling_decode
from repro_torch.core.policy import (CoRaiSPolicy, corais_admit,
                                     corais_encode, corais_score,
                                     corais_score_decode)
from repro_torch.kernels.ref import stable_topk

DECODE_MODES = ("greedy", "sample")

__all__ = ["DECODE_MODES", "DecisionSpec", "policy_decide",
           "make_decision_fn"]


@dataclasses.dataclass(frozen=True)
class DecisionSpec:
    """Every knob of one scheduling decision, in one hashable value.

    mode            "greedy" (argmax) or "sample" (best-of-``num_samples``
                    eq-19 dispatch; needs a ``torch.Generator``).
    num_samples     complete decisions drawn in sample mode.
    backend         score/decode backend name (None = the policy config's
                    ``score_backend``; see core.policy.SCORE_BACKENDS).
    admission       also threshold the admission head; decisions become
                    ``(assign, admit)`` pairs (requires ``admit_head=True``).
    fused_decode    decode inside the scoring kernel; never materializes
                    the (Z, Q) log-prob matrix.
    num_candidates  per-request candidate-set size K for sampled dispatch
                    (None = all edges, the exact eq-19 distribution).
    normalize       greedy only: False skips the log-softmax normalizer
                    (identical argmax, cheapest serving path).
    """

    mode: str = "greedy"
    num_samples: int = 64
    backend: Optional[str] = None
    admission: bool = False
    fused_decode: bool = False
    num_candidates: Optional[int] = None
    normalize: bool = True

    def __post_init__(self):
        if self.mode not in DECODE_MODES:
            raise ValueError(f"unknown decode mode {self.mode!r}; "
                             f"supported: {', '.join(DECODE_MODES)}")

    def replace(self, **changes) -> "DecisionSpec":
        return dataclasses.replace(self, **changes)


@torch.inference_mode()
def policy_decide(policy: CoRaiSPolicy, inst, spec: Optional[DecisionSpec] = None,
                  *, generator: Optional[torch.Generator] = None):
    """One full scheduling decision on an instance dict of tensors: (..., Z)
    int32 execution edge per request. ``mode="sample"`` draws
    ``spec.num_samples`` complete decisions from ``generator`` over the
    per-request top-``num_candidates`` candidates and keeps the cheapest
    (eq 19), greedy included. With ``admission=True`` the decision is an
    ``(assign, admit)`` pair."""
    spec = spec or DecisionSpec()
    c_emb, h_emb = corais_encode(policy, inst, training=False)
    emask = inst["edge_mask"]
    if spec.mode == "greedy":
        if spec.fused_decode:
            ti, _ = corais_score_decode(policy, c_emb, h_emb, emask, k=1,
                                        normalize=spec.normalize,
                                        backend=spec.backend)
            assign = ti[..., 0]
        else:
            log_probs = corais_score(policy, c_emb, h_emb, emask,
                                     backend=spec.backend)
            assign = greedy_decode(log_probs)
    else:
        if generator is None:
            raise ValueError("sample mode needs a torch.Generator")
        k = spec.num_candidates or emask.shape[-1]
        if spec.fused_decode:
            ti, tv = corais_score_decode(policy, c_emb, h_emb, emask, k=k,
                                         normalize=True, backend=spec.backend)
        else:
            log_probs = corais_score(policy, c_emb, h_emb, emask,
                                     backend=spec.backend)
            tv, ti = stable_topk(log_probs, k)
        assign, _ = topk_sampling_decode(generator, inst, ti, tv,
                                         spec.num_samples)
    assign = assign.to(torch.int32)
    if not spec.admission:
        return assign
    admit = corais_admit(policy, c_emb, h_emb, emask) > 0
    return assign, admit & inst["req_mask"]


def make_decision_fn(policy: CoRaiSPolicy, spec: Optional[DecisionSpec] = None):
    """Decision function ``decide(inst, generator=None) -> (Z,) int32`` bound
    to ``policy`` and ``spec``: the serving fast path's per-bucket callable.
    Eager; a CUDA-graph capture per padded shape is later work."""
    spec = spec or DecisionSpec()

    def decide(inst, generator: Optional[torch.Generator] = None):
        return policy_decide(policy, inst, spec, generator=generator)

    return decide
