"""System-level state evaluation model (paper §III-C): a numpy copy of
``repro/core/state.py`` for the port.

Shields heterogeneous hardware behind two service-oriented indicators —
the computation-time estimation function ``phi(x)`` and the replica count
``zeta`` — plus the three workload features (c_le, c_in, t_in) computed from
the live queues of Fig. 5. ``LMEdgeBackend`` fits one :class:`PhiEstimator`
per edge from measured prefill latencies, and :func:`snapshot_instance`
freezes the live system into a scheduling instance for the solvers and
the policy. :func:`slot_workload_features` is the torch port of the
reference's array twin, batched over any leading shape, which the rollout
engine calls every round. ``tests/test_torch_lm_serving.py``
holds this copy against the original bit for bit, apart from the one
place where :class:`PhiEstimator` differs on purpose by default (a
history whose least-squares slope is not positive);
``tests/test_torch_simulator.py`` holds ``PhiEstimator(flat_fit=False)``
to the reference's rule bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass
class PhiEstimator:
    """Affine phi(x) = a*x + b fitted online from (data_size, runtime) pairs
    by least squares over a sliding window of the most recent observations
    (the paper's numpy.polyfit procedure, §III-C1). Only *local* history is
    used, preserving per-edge heterogeneity.

    The fit is maintained through running sums (n, Sx, Sy, Sxx, Sxy) with
    O(1) eviction at the window edge, so ``observe`` is O(1) per completed
    request instead of an O(n) refit; the closed-form coefficients equal
    ``np.polyfit(window, 1)`` (pinned by a test). Set ``frozen`` to pin the
    coefficients (oracle mode for engine-equivalence runs).

    Where the window's least-squares slope is not positive, phi is by
    default the least-squares fit with ``a >= 0``: ``a = 0`` and ``b`` the
    mean runtime. The reference keeps its previous coefficients there, at
    first the prior ``a = 1`` s per unit of size, and a dispatch over that
    prior sends the edge nothing. Such a history is what an edge whose
    runtime does not grow with the size measures: an LM prefill that the
    host's launches bound (ROADMAP C4). ``flat_fit=False`` keeps the
    reference's rule, which the rollout engine's ``learn_phi`` refit also
    follows; the simulator's edges (``serving/edge.py``) use it.
    """

    a: float = 1.0
    b: float = 0.0
    min_samples: int = 8
    window: int = 512
    frozen: bool = False
    flat_fit: bool = True
    _xs: list = dataclasses.field(default_factory=list)
    _ys: list = dataclasses.field(default_factory=list)
    _sx: float = 0.0
    _sy: float = 0.0
    _sxx: float = 0.0
    _sxy: float = 0.0
    _n: int = 0

    def observe(self, data_size: float, runtime: float) -> None:
        if self.frozen:
            return
        x, y = float(data_size), float(runtime)
        self._xs.append(x)
        self._ys.append(y)
        if len(self._xs) > 2 * (self.window + 1):
            # amortized O(1) trim: only the trailing window+1 samples are
            # ever read again (the eviction below indexes from the end)
            del self._xs[: len(self._xs) - (self.window + 1)]
            del self._ys[: len(self._ys) - (self.window + 1)]
        self._sx += x
        self._sy += y
        self._sxx += x * x
        self._sxy += x * y
        self._n += 1
        if self._n > self.window:  # evict the sample leaving the window
            xo = self._xs[len(self._xs) - self.window - 1]
            yo = self._ys[len(self._ys) - self.window - 1]
            self._sx -= xo
            self._sy -= yo
            self._sxx -= xo * xo
            self._sxy -= xo * yo
            self._n -= 1
        n = self._n
        if n < self.min_samples:
            return
        var = max(self._sxx / n - (self._sx / n) ** 2, 0.0)
        if var < 1e-18:
            return  # constant-size history: the affine fit is degenerate
        a = (self._sxy - self._sx * self._sy / n) / (self._sxx - self._sx**2 / n)
        b = (self._sy - a * self._sx) / n
        if not (np.isfinite(a) and np.isfinite(b)):
            return
        if a <= 0:  # flat or falling
            if not self.flat_fit:
                return  # the reference's rule: keep the last coefficients
            a, b = 0.0, self._sy / n  # the least-squares fit with a >= 0
        self.a, self.b = float(a), float(max(b, 0.0))

    def __call__(self, data_size) -> float:
        return self.a * np.asarray(data_size) + self.b

    @property
    def coefficients(self) -> tuple[float, float]:
        return self.a, self.b


@dataclasses.dataclass
class QueuedRequest:
    """Brief of a request (paper §III-A): description only, no payload."""

    rid: int
    data_size: float
    source_edge: int
    service: int = 0
    submit_time: float = 0.0
    # Schema-v3 fields: absolute hard-SLO time (inf = no deadline) and an
    # importance level the scheduler may condition on.
    deadline: float = float("inf")
    priority: int = 0
    # Filled by the runtime:
    exec_edge: int = -1
    start_time: float = -1.0
    finish_time: float = -1.0
    # Cache-aside warm-up charged at dispatch when the execution node's
    # service cache missed (repro.serving.cache); 0.0 on a hit.
    miss_penalty: float = 0.0


@dataclasses.dataclass
class EdgeServiceState:
    """Per-(edge, service) view used for workload evaluation eqs (1)-(3)."""

    edge_id: int
    coords: tuple[float, float]
    phi: PhiEstimator
    replicas: int
    q_le: list = dataclasses.field(default_factory=list)   # to execute locally
    q_in: list = dataclasses.field(default_factory=list)   # inbound transfers
    q_out: list = dataclasses.field(default_factory=list)  # outbound transfers
    q_r: list = dataclasses.field(default_factory=list)    # awaiting scheduling
    q_f: list = dataclasses.field(default_factory=list)    # finished

    def workload(self, w_row: np.ndarray, ct: float) -> tuple[float, float, float]:
        """(c_le, c_in, t_in) per eqs (1)-(3). ``w_row[j]`` is the distance
        from edge j to this edge."""
        c_le = sum(float(self.phi(r.data_size)) for r in self.q_le) / self.replicas
        c_in = sum(float(self.phi(r.data_size)) for r in self.q_in) / self.replicas
        t_in = max(
            (ct * r.data_size * float(w_row[r.source_edge]) for r in self.q_in),
            default=0.0,
        )
        return c_le, c_in, t_in


def _edge_sums(e, vals, num_edges):
    """Per-edge sums of ``vals`` (..., Z) by edge index ``e`` (..., Z) as
    (..., Q): an accumulating ``index_put_`` over the flattened leading
    axes, deterministic on the card."""
    lead = e.shape[:-1]
    m = int(np.prod(lead)) if lead else 1
    rows = torch.arange(m, device=e.device)[:, None].expand(m, e.shape[-1])
    out = torch.zeros((m, num_edges), dtype=torch.float32, device=e.device)
    out.index_put_((rows, e.reshape(m, -1)), vals.reshape(m, -1).float(),
                   accumulate=True)
    return out.reshape(*lead, num_edges)


def slot_workload_features(phi_est, replicas, w, ct, slot_size, slot_src,
                           slot_edge, slot_ready, slot_start, t):
    """Array twin of :meth:`EdgeServiceState.workload`: (c_le, c_in, t_in)
    per eqs (1)-(3) for every edge, straight from a rollout engine's slot
    table at time ``t``.

    A committed slot (``slot_edge >= 0``) whose data has not arrived
    (``ready > t``) is in Q^in; one whose data arrived but whose execution
    has not started (``ready <= t < start``) is in Q^le. Started and
    finished slots contribute nothing, as in the oracle's queues.

    Shapes, with any leading batch shape ``...``: phi_est (..., Q, 2),
    replicas (..., Q), w (..., Q, Q), ct and t (...), slot_* (..., Z).
    Returns (..., Q, 3) float32. The per-edge sums are accumulating
    ``index_put_``s: in slot order on the CPU (the reference's order), over
    sorted indices on the card, so two runs give the same bits there too
    (``scatter_add_``'s atomics would not); t_in is a ``scatter_reduce_``
    max on a zero base.
    """
    num_edges = w.shape[-1]
    committed = slot_edge >= 0
    e = torch.clamp(slot_edge, 0, num_edges - 1).long()
    t = t[..., None]
    in_transfer = committed & (slot_ready > t)
    waiting = committed & (slot_ready <= t) & (slot_start > t)
    comp = (torch.gather(phi_est[..., 0], -1, e) * slot_size
            + torch.gather(phi_est[..., 1], -1, e))        # phi(f_z)
    zeros = torch.zeros(e.shape[:-1] + (num_edges,), dtype=torch.float32,
                        device=e.device)
    c_le = _edge_sums(e, torch.where(waiting, comp, 0.0), num_edges) / replicas
    c_in = (_edge_sums(e, torch.where(in_transfer, comp, 0.0), num_edges)
            / replicas)
    dist = torch.gather(w.flatten(-2), -1, slot_src.long() * num_edges + e)
    trans = ct[..., None] * slot_size * dist  # eq (2) terms
    t_in = zeros.scatter_reduce(-1, e, torch.where(in_transfer, trans, 0.0),
                                "amax")
    return torch.stack([c_le, c_in, t_in], dim=-1).to(torch.float32)


def snapshot_instance(
    edges: Sequence[EdgeServiceState],
    pending: Sequence[QueuedRequest],
    w: np.ndarray,
    ct: float,
    q_pad: int | None = None,
    z_pad: int | None = None,
    w_global: np.ndarray | None = None,
):
    """Freeze the live system into a scheduling instance (the CC's step (iv)).

    Returns the same pytree layout as instances.generate_instance, so the
    policy and every solver run unchanged on live serving state.

    ``w`` indexes the *provided* edges (e.g. the alive subset); backlog
    requests in Q^in may reference global edge ids, so pass ``w_global``
    (full distance matrix) for workload evaluation after failures.
    """
    q = len(edges)
    z = len(pending)
    qp = q_pad or q
    zp = z_pad or max(z, 1)
    coords = np.zeros((qp, 2), np.float32)
    phi = np.zeros((qp, 2), np.float32)
    reps = np.ones(qp, np.float32)
    wl = np.zeros((qp, 3), np.float32)
    wpad = np.zeros((qp, qp), np.float32)
    wpad[:q, :q] = w
    for i, e in enumerate(edges):
        coords[i] = e.coords
        phi[i] = e.phi.coefficients
        reps[i] = e.replicas
        w_row = (w_global[:, e.edge_id] if w_global is not None else w[:, i])
        wl[i] = e.workload(w_row, ct)
    req_src = np.zeros(zp, np.int32)
    req_size = np.zeros(zp, np.float32)
    for j, r in enumerate(pending):
        req_src[j] = r.source_edge
        req_size[j] = r.data_size
    edge_mask = np.arange(qp) < q
    req_mask = np.arange(zp) < z
    return {
        "edge_coords": coords,
        "phi": phi,
        "replicas": reps,
        "workload": wl,
        "w": wpad,
        "ct": np.float32(ct),
        "req_src": req_src,
        "req_size": req_size,
        "edge_mask": edge_mask,
        "req_mask": req_mask,
    }
