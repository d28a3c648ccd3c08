"""Central controller (paper Fig. 2): snapshot -> schedule -> dispatch;
counterpart of ``repro/serving/controller.py``.

Scheduling backends: the trained CoRaiS policy (greedy or sampling decode,
optionally with the fused in-kernel decode — ``fused_decode=True`` — which
never materializes the per-round (Z, Q) log-prob matrix), the heuristics
(local / random / greedy insertion), or the ILS reference. The controller
is scheduler-agnostic: every backend consumes the same frozen instance
produced by core.state.snapshot_instance, so swapping the paper's learned
scheduler against baselines is a one-line config change. For the
latency-bound serving loop proper, see :mod:`repro_torch.serving.fastpath`.

Where the reference holds ``policy_params``, ``policy_state`` and
``policy_cfg``, the port holds one :class:`CoRaiSPolicy`, which lives on its
device: each round's padded snapshot is staged there as tensors and decided
by one :func:`make_decision_fn` built on the first round (B1 on the card,
or B3 with ``fused_decode=True``). Sampled decisions draw from one
``torch.Generator`` on that device, seeded with ``seed`` and advanced by
every call, in place of the reference's ``jax.random.split`` chain.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.heuristics import (solve_greedy, solve_ils, solve_local,
                                         solve_random)
from repro_torch.core.inference import DecisionSpec, make_decision_fn
from repro_torch.core.policy import CoRaiSPolicy
from repro_torch.core.state import QueuedRequest, snapshot_instance
from repro_torch.serving.topology import nearest_alive_edge

SchedulerChoice = ("corais", "corais-sample", "greedy", "local", "random", "ils")


@dataclasses.dataclass
class CentralController:
    scheduler: str = "greedy"
    policy: Optional[CoRaiSPolicy] = None
    sample_n: int = 128
    seed: int = 0
    # pad snapshots so the policy sees a constant shape
    q_pad: int = 0
    z_pad: int = 64
    # decode inside the scoring kernel (never materialize (Z, Q)); with
    # sampling, draw from the kernel's top-``num_candidates`` set
    # (None: all edges — exact eq-19 distribution)
    fused_decode: bool = False
    num_candidates: Optional[int] = None
    # full decode configuration in one value; overrides the per-field knobs
    # above when set (see repro_torch.core.inference.DecisionSpec)
    decision: Optional[DecisionSpec] = None

    def __post_init__(self):
        if self.scheduler.startswith("corais") and self.policy is None:
            raise ValueError(f"scheduler {self.scheduler!r} needs a policy")
        self._generator = (
            torch.Generator(device=self.policy.device).manual_seed(self.seed)
            if self.policy is not None else None)
        self._decide = None
        self.last_decision_time = 0.0

    def decision_spec(self) -> DecisionSpec:
        """The DecisionSpec this controller schedules with — ``decision``
        verbatim when given, else assembled from the per-field knobs
        (scheduler name picks the decode mode)."""
        if self.decision is not None:
            return self.decision
        mode = "sample" if self.scheduler == "corais-sample" else "greedy"
        return DecisionSpec(mode=mode, num_samples=self.sample_n,
                            fused_decode=self.fused_decode,
                            num_candidates=self.num_candidates)

    def _stage(self, inst) -> dict:
        """The padded numpy snapshot as tensors on the policy's device."""
        device = self.policy.device
        return {k: torch.as_tensor(np.asarray(v)).to(device)
                for k, v in inst.items()}

    def _policy_assign(self, inst) -> np.ndarray:
        if self._decide is None:
            # shared decision path (core.inference): built once, reused
            # every round
            self._decide = make_decision_fn(self.policy, self.decision_spec())
        assign = self._decide(self._stage(inst), generator=self._generator)
        return assign.cpu().numpy()

    def schedule(self, edges, pending: Sequence[QueuedRequest], w: np.ndarray,
                 ct: float) -> list[tuple[QueuedRequest, int]]:
        """Returns [(request, execution_edge)] for this round (CC step iv)."""
        if not pending:
            return []
        alive = [e for e in edges if e.alive]
        alive_ids = [e.edge_id for e in alive]
        id_map = {aid: i for i, aid in enumerate(alive_ids)}
        w_alive = w[np.ix_(alive_ids, alive_ids)]
        # remap request sources onto the alive-edge index space; a request
        # from a dead edge is re-homed at the *nearest* alive edge (its data
        # must be re-sent from there), not silently at alive index 0, which
        # would bias every transfer-distance cost
        alive_flags = np.zeros(w.shape[0], bool)
        for e in edges:
            alive_flags[e.edge_id] = e.alive
        remapped = []
        for r in pending:
            rr = dataclasses.replace(r)
            src = r.source_edge
            if src not in id_map:
                src = nearest_alive_edge(w, src, alive_flags)
            rr.source_edge = id_map[src]
            remapped.append(rr)
        zp = max(self.z_pad, len(remapped))
        qp = max(self.q_pad, len(alive))
        inst = snapshot_instance([e.state for e in alive], remapped, w_alive,
                                 ct, q_pad=qp, z_pad=zp, w_global=w)
        t0 = time.perf_counter()
        if self.scheduler in ("corais", "corais-sample"):
            assign = self._policy_assign(inst)
        elif self.scheduler == "greedy":
            assign = solve_greedy(inst)
        elif self.scheduler == "local":
            assign = solve_local(inst)
        elif self.scheduler == "random":
            assign = solve_random(inst, 100, seed=self.seed)
        elif self.scheduler == "ils":
            assign = solve_ils(inst, budget_s=1.0, seed=self.seed)
        else:
            raise ValueError(self.scheduler)
        self.last_decision_time = time.perf_counter() - t0
        out = []
        for i, r in enumerate(pending):
            exec_alive_idx = int(assign[i]) % max(len(alive), 1)
            out.append((r, alive_ids[exec_alive_idx]))
        return out
