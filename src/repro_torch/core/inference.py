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

Entry points: :func:`policy_decide` (one decision, any leading batch
shape), :func:`make_decision_fn` (a decision function bound to a policy and
spec, used by the serving fast path) and :func:`make_assign_factory`, the
rollout engine's scheduler factory behind ``ASSIGN_FNS["policy"]``
(:func:`make_policy_assign`) and ``["policy-fused"]``
(:func:`make_policy_assign_fused`). All run eagerly.
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
           "make_policy_assign", "make_policy_assign_fused",
           "make_assign_factory", "make_decision_fn"]


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
                  *, generator: Optional[torch.Generator] = None,
                  per_instance: bool = False):
    """One full scheduling decision on an instance dict of tensors: (..., Z)
    int32 execution edge per request. ``mode="sample"`` draws
    ``spec.num_samples`` complete decisions from ``generator`` over the
    per-request top-``num_candidates`` candidates and keeps the cheapest
    (eq 19), greedy included. With ``admission=True`` the decision is an
    ``(assign, admit)`` pair. ``per_instance=True`` decides each instance
    of the leading axes on its own statistics (:func:`corais_encode`)."""
    spec = spec or DecisionSpec()
    c_emb, h_emb = corais_encode(policy, inst, training=False,
                                 per_instance=per_instance)
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


def make_assign_factory(defaults: DecisionSpec):
    """Build a rollout-engine scheduler factory around a default
    :class:`DecisionSpec`: the one registration point behind both policy
    entries of ``serving.engine.ASSIGN_FNS`` (``"policy"`` and
    ``"policy-fused"`` are this factory with different defaults).

    ``factory(policy, spec=None)`` returns ``fn(generator, inst)``, which
    decides a whole batch of round instances (leading axis B) with one
    :func:`policy_decide`, so the head's kernel launches once per round for
    all B instances, each decided on its own statistics as under the
    reference's ``vmap``. It gives the (B, A) int32 assignment, or ``(assign,
    admit)`` when ``spec.admission`` is set. ``generator`` is ignored by
    greedy decoding; sampled decoding draws from it (one device
    ``torch.Generator`` per rollout)."""

    def factory(policy: CoRaiSPolicy, spec: Optional[DecisionSpec] = None):
        resolved = defaults if spec is None else spec
        if not isinstance(resolved, DecisionSpec):
            raise TypeError(f"spec must be a DecisionSpec, got "
                            f"{type(resolved).__name__}")

        def fn(generator: Optional[torch.Generator], inst):
            return policy_decide(policy, inst, resolved, generator=generator,
                                 per_instance=True)

        return fn

    # engine.resolve_assign_fn builds entries tagged this way with a policy
    # rather than calling them every round
    factory._assign_factory = True
    factory._decision_defaults = defaults
    return factory


#: The CoRaiS policy as an engine scheduler factory (``ASSIGN_FNS["policy"]``):
#: the materialized head (B1) and its argmax.
make_policy_assign = make_assign_factory(DecisionSpec())

#: Same factory with the fused in-kernel decode on by default
#: (``ASSIGN_FNS["policy-fused"]``, B3).
make_policy_assign_fused = make_assign_factory(
    DecisionSpec(fused_decode=True))

make_policy_assign.__name__ = "make_policy_assign"
make_policy_assign_fused.__name__ = "make_policy_assign_fused"


def make_decision_fn(policy: CoRaiSPolicy, spec: Optional[DecisionSpec] = None):
    """Decision function ``decide(inst, generator=None) -> (Z,) int32`` bound
    to ``policy`` and ``spec``: the serving fast path's per-bucket callable.
    Eager; a CUDA-graph capture per padded shape is later work."""
    spec = spec or DecisionSpec()

    def decide(inst, generator: Optional[torch.Generator] = None):
        return policy_decide(policy, inst, spec, generator=generator)

    return decide
