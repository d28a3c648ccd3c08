"""The paper's scheduling objective, eqs (4)-(11) / reward eqs (18)-(19), in
PyTorch; counterpart of ``repro/core/objective.py``. ``per_edge_times_np``
and ``makespan_np`` are numpy copies of the reference's scalar mirror (the
solvers' objective), equal to it bit for bit.

Conventions: assignment ``x`` maps each request to an edge index;
``T_q = max(kappa_q, mu_q) + eta_q`` (eq 9); objective = max_q T_q (eq 4).
An assignment may carry more leading axes than the instance (for example
S sampled decisions of one instance, (S, Z)): the instance broadcasts.
"""
from __future__ import annotations

import numpy as np
import torch

NEG = -1e9


def phi_eval(phi, sizes):
    """phi: (..., Q, 2); sizes: (..., Z) -> (..., Z, Q) computation times."""
    return phi[..., None, :, 0] * sizes[..., :, None] + phi[..., None, :, 1]


def per_edge_times(inst, assign) -> dict:
    """All per-edge terms for one or many assignments, assign: (..., Z).
    Returns dict with mu, eta, kappa, T each (..., Q)."""
    q_pad = inst["phi"].shape[-2]
    sizes = inst["req_size"]
    src = inst["req_src"].long()
    rmask = inst["req_mask"].to(torch.float32)
    assign = assign.long()

    onehot = torch.nn.functional.one_hot(assign, q_pad).to(torch.float32)
    onehot = onehot * rmask[..., None]
    local = (assign == src).to(torch.float32)  # (..., Z)

    comp = phi_eval(inst["phi"], sizes)  # (..., Z, Q)
    # eq (5): locally-executed new work + local backlog
    mu = ((onehot * local[..., None] * comp).sum(-2) / inst["replicas"]
          + inst["workload"][..., 0])
    # eq (6): transferred-in new work + transferred-in backlog
    eta = ((onehot * (1.0 - local[..., None]) * comp).sum(-2)
           / inst["replicas"] + inst["workload"][..., 1])
    # eq (7): slowest incoming transfer among newly transferred requests;
    # w_src[z, q] is the distance from request z's source to edge q
    w = inst["w"]
    w_src = torch.gather(w, -2, src[..., :, None].expand(*src.shape, q_pad))
    trans = sizes[..., :, None] * w_src * onehot  # zero where not assigned
    v = trans.amax(dim=-2)  # (..., Q)
    # eq (8): include still-in-flight backlog transfers
    kappa = torch.maximum(inst["ct"][..., None] * v, inst["workload"][..., 2])
    # eq (9)
    T = torch.maximum(kappa, mu) + eta
    return {"mu": mu, "eta": eta, "kappa": kappa, "T": T}


def makespan(inst, assign) -> torch.Tensor:
    """Objective eq (4) / reward L(pi) = -u_hat of eq (19): max_q T_q over
    real edges. assign: (..., Z). Returns (...) f32."""
    T = per_edge_times(inst, assign)["T"]
    T = torch.where(inst["edge_mask"], T, NEG)
    return T.amax(dim=-1)


def makespan_batch_samples(inst, assigns) -> torch.Tensor:
    """inst: single instance (no batch axis); assigns: (S, Z). -> (S,)"""
    return makespan(inst, assigns)


# ---------------------------------------------------------------------------
# numpy mirror (scalar, for solvers)
# ---------------------------------------------------------------------------


def per_edge_times_np(inst, assign: np.ndarray) -> dict:
    phi = np.asarray(inst["phi"])
    q_pad = phi.shape[0]
    sizes = np.asarray(inst["req_size"])
    src = np.asarray(inst["req_src"])
    rmask = np.asarray(inst["req_mask"])
    w = np.asarray(inst["w"])
    wl = np.asarray(inst["workload"])
    reps = np.asarray(inst["replicas"])
    ct = float(inst["ct"])

    mu = wl[:, 0].copy()
    eta = wl[:, 1].copy()
    v = np.zeros(q_pad, np.float64)
    for z in np.nonzero(rmask)[0]:
        q = int(assign[z])
        t = float(phi[q, 0] * sizes[z] + phi[q, 1])
        if q == src[z]:
            mu[q] += t / reps[q]
        else:
            eta[q] += t / reps[q]
            v[q] = max(v[q], float(sizes[z] * w[src[z], q]))
    kappa = np.maximum(ct * v, wl[:, 2])
    T = np.maximum(kappa, mu) + eta
    return {"mu": mu, "eta": eta, "kappa": kappa, "T": T}


def makespan_np(inst, assign: np.ndarray) -> float:
    T = per_edge_times_np(inst, assign)["T"]
    emask = np.asarray(inst["edge_mask"])
    return float(np.max(np.where(emask, T, -np.inf)))
