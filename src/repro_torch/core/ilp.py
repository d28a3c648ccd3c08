"""Exact solvers and the ILP formulation (paper §III-D, eqs 4-11): a numpy
copy of ``repro/core/ilp.py``, equal to it bit for bit.

The min-max objective linearizes exactly (all max terms appear on the
minimized side):

    min T
    s.t.  T   >= m_q + eta_q(x)                  (eq 9)
          m_q >= mu_q(x)                         (eq 9 max arm 1)
          m_q >= Ct * v_q ;  m_q >= t_in_q       (eq 8)
          v_q >= f_z * w[src_z, q] * x_zq  ∀z    (eq 7)
          sum_q x_zq = 1 ∀z ;  x binary          (eqs 10, 11)

:func:`write_lp` exports this model in CPLEX LP format for external solvers
(no external solver is a dependency of this package).
:func:`solve_enumerate` and :func:`solve_branch_and_bound` are the in-repo
exact methods for small instances; B&B is validated against enumeration.
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.core.objective import makespan_np, per_edge_times_np


def _problem_arrays(inst):
    zs = np.nonzero(np.asarray(inst["req_mask"]))[0]
    qs = np.nonzero(np.asarray(inst["edge_mask"]))[0]
    phi = np.asarray(inst["phi"], np.float64)
    sizes = np.asarray(inst["req_size"], np.float64)
    src = np.asarray(inst["req_src"])
    w = np.asarray(inst["w"], np.float64)
    wl = np.asarray(inst["workload"], np.float64)
    reps = np.asarray(inst["replicas"], np.float64)
    ct = float(inst["ct"])
    return zs, qs, phi, sizes, src, w, wl, reps, ct


def solve_enumerate(inst, limit: int = 5_000_000) -> np.ndarray:
    """Exhaustive search over Q^Z assignments (tiny instances only)."""
    zs, qs, *_ = _problem_arrays(inst)
    if len(qs) ** len(zs) > limit:
        raise ValueError(f"search space {len(qs)}^{len(zs)} exceeds limit {limit}")
    assign = np.asarray(inst["req_src"], np.int32).copy()
    best, best_cost = None, np.inf
    for combo in itertools.product(qs, repeat=len(zs)):
        assign[zs] = combo
        cost = makespan_np(inst, assign)
        if cost < best_cost:
            best, best_cost = assign.copy(), cost
    return best


def solve_branch_and_bound(inst, node_limit: int = 2_000_000,
                           incumbent: np.ndarray | None = None) -> np.ndarray:
    """Depth-first B&B over request->edge assignments.

    Requests are branched in decreasing size order. The bound exploits that
    every term of T_q (eqs 5-9) is monotone nondecreasing in the assigned
    request set: the makespan of a partial assignment (unassigned requests
    ignored) is a valid lower bound on any completion. A per-request
    admissible increment (its best-case solo placement) tightens it.
    """
    zs, qs, phi, sizes, src, w, wl, reps, ct = _problem_arrays(inst)
    order = zs[np.argsort(-sizes[zs])]

    # best-case contribution of each unassigned request alone on its best edge
    solo = {}
    for z in order:
        best = np.inf
        for q in qs:
            comp = (phi[q, 0] * sizes[z] + phi[q, 1]) / reps[q]
            tx = ct * sizes[z] * w[src[z], q] if q != src[z] else 0.0
            # completing this request alone needs at least comp after tx/backlog
            lb = max(tx, wl[q, 2]) * 0 + comp  # comp always adds to mu or eta
            best = min(best, lb)
        solo[int(z)] = best

    from repro_torch.core.heuristics import solve_greedy

    if incumbent is None:
        incumbent = solve_greedy(inst)
    best_assign = incumbent.copy()
    best_cost = makespan_np(inst, incumbent)

    assign = np.asarray(inst["req_src"], np.int32).copy()
    nodes = 0

    def partial_cost(upto: int) -> float:
        """Makespan counting only the first ``upto`` requests in order."""
        mask_backup = np.asarray(inst["req_mask"]).copy()
        m = np.zeros_like(mask_backup)
        m[order[:upto]] = True
        tmp = dict(inst)
        tmp["req_mask"] = m
        return makespan_np(tmp, assign)

    def dfs(i: int):
        nonlocal best_cost, best_assign, nodes
        nodes += 1
        if nodes > node_limit:
            raise TimeoutError("B&B node limit reached")
        if i == len(order):
            cost = partial_cost(len(order))
            if cost < best_cost - 1e-12:
                best_cost = cost
                best_assign = assign.copy()
            return
        z = order[i]
        # try edges by locally best completion estimate
        scored = []
        for q in qs:
            assign[z] = q
            lb = partial_cost(i + 1)
            scored.append((lb, q))
        scored.sort()
        for lb, q in scored:
            if lb >= best_cost - 1e-12:
                continue  # prune: bound is monotone
            assign[z] = q
            dfs(i + 1)
        assign[z] = src[z]

    dfs(0)
    return best_assign


def write_lp(inst, path: str) -> None:
    """Export the exact linearized ILP in CPLEX LP format."""
    zs, qs, phi, sizes, src, w, wl, reps, ct = _problem_arrays(inst)
    lines = ["Minimize", " obj: T", "Subject To"]
    # T >= m_q + eta_q(x):  T - m_q - sum coef*x >= c_in_q
    for q in qs:
        terms = " ".join(
            f"- {(phi[q,0]*sizes[z]+phi[q,1])/reps[q]:.9f} x_{z}_{q}"
            for z in zs
            if src[z] != q
        )
        lines.append(f" r_T_{q}: T - m_{q} {terms} >= {wl[q,1]:.9f}")
        # m_q >= mu_q(x)
        terms = " ".join(
            f"- {(phi[q,0]*sizes[z]+phi[q,1])/reps[q]:.9f} x_{z}_{q}"
            for z in zs
            if src[z] == q
        )
        lines.append(f" r_mu_{q}: m_{q} {terms} >= {wl[q,0]:.9f}")
        # m_q >= Ct v_q ; m_q >= t_in_q
        lines.append(f" r_kv_{q}: m_{q} - {ct:.9f} v_{q} >= 0")
        lines.append(f" r_kt_{q}: m_{q} >= {wl[q,2]:.9f}")
        # v_q >= f_z w[src_z,q] x_zq
        for z in zs:
            coef = sizes[z] * w[src[z], q]
            if coef > 0:
                lines.append(f" r_v_{q}_{z}: v_{q} - {coef:.9f} x_{z}_{q} >= 0")
    for z in zs:
        terms = " + ".join(f"x_{z}_{q}" for q in qs)
        lines.append(f" r_one_{z}: {terms} = 1")
    lines.append("Bounds")
    for q in qs:
        lines.append(f" m_{q} >= 0")
        lines.append(f" v_{q} >= 0")
    lines.append("Binaries")
    lines.append(" " + " ".join(f"x_{z}_{q}" for z in zs for q in qs))
    lines.append("End")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
