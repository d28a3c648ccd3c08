"""CoMEC / CoR instances and their synthetic generator (paper §V.A): a numpy
copy of ``InstanceConfig``, ``generate_instance`` and ``generate_batch``
from ``repro/core/instances.py``, which the port cannot import without jax.

An *instance* is one scheduling round, a dict of fixed (padded) shapes:

    edge_coords : (Q, 2) f32   edge positions, U(0,1)^2
    phi         : (Q, 2) f32   phi_q(x) = phi[q,0] * x + phi[q,1]
    replicas    : (Q,)  f32    service replica count zeta_q, U{1..4}
    workload    : (Q, 3) f32   (c_le, c_in, t_in) from eqs (1)-(3)
    w           : (Q, Q) f32   transmission distance matrix (w_ii = 0)
    ct          : ()    f32    transmission speed constant C_t
    req_src     : (Z,)  i32    source edge index of each request
    req_size    : (Z,)  f32    input data size f_z, U(0,1)
    edge_mask   : (Q,)  bool   True for real (non-padding) edges
    req_mask    : (Z,)  bool   True for real requests

Given the same ``numpy.random.Generator`` the copy yields the reference's
instances bit for bit (pinned by ``tests/test_torch_inference.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.workloads.base import SizeSpec, edge_weights

Instance = dict


@dataclasses.dataclass(frozen=True)
class InstanceConfig:
    num_edges: int = 5                 # Q (EN in the paper's tables)
    num_requests: int = 50             # Z (RN in the paper's tables)
    max_edges: Optional[int] = None    # padded Q (defaults to num_edges)
    max_requests: Optional[int] = None
    max_replicas: int = 4              # zeta ~ U{1..max_replicas}
    backlog_high: int = 100            # |Q^le|, |Q^in| ~ U(0, backlog_high)
    ct: float = 1.0                    # C_t
    phi_low: float = 0.0               # phi coefficients ~ U(phi_low, phi_high)
    phi_high: float = 1.0
    # Scenario conditioning: data-size law for requests AND backlogs, plus
    # Zipf source skew. Defaults reproduce the paper's §V.A i.i.d. uniform
    # regime exactly.
    size_dist: str = "uniform"         # uniform | fixed | pareto | lognormal
    size_params: tuple = ()            # family parameters (see SizeSpec)
    size_cap: float = 1.0
    source_skew: float = 0.0           # Zipf exponent over source edges
    hot_edge: int = 0                  # which edge holds the top rank

    @property
    def q_pad(self) -> int:
        return self.max_edges or self.num_edges

    @property
    def z_pad(self) -> int:
        return self.max_requests or self.num_requests

    @property
    def size_spec(self) -> SizeSpec:
        return SizeSpec(self.size_dist, self.size_params, self.size_cap)


def _phi_eval(phi_row: np.ndarray, x: np.ndarray) -> np.ndarray:
    return phi_row[0] * x + phi_row[1]


def _sample_sources(rng: np.random.Generator, cfg: InstanceConfig, n: int,
                    exclude: Optional[int] = None) -> np.ndarray:
    """Source-edge indices under the scenario's Zipf popularity skew.
    ``source_skew=0`` keeps the paper's uniform draw (and its exact rng
    stream). ``exclude`` drops one edge (backlog Q^in senders != receiver)."""
    q = cfg.num_edges
    if cfg.source_skew == 0.0:
        if exclude is None:
            return rng.integers(0, q, size=(n,)).astype(np.int32)
        cands = [j for j in range(q) if j != exclude]
        return rng.choice(cands, size=n).astype(np.int32)
    probs = edge_weights(q, cfg.source_skew, cfg.hot_edge)
    if exclude is not None:
        probs = probs.copy()
        probs[exclude] = 0.0
        probs = probs / probs.sum()
    return rng.choice(q, size=n, p=probs).astype(np.int32)


def generate_instance(rng: np.random.Generator, cfg: InstanceConfig) -> Instance:
    """Sample one instance per the paper's rules (§V.A), optionally
    conditioned on a workload scenario (non-uniform sizes / skewed sources)
    via the cfg's ``size_dist``/``size_params``/``source_skew`` fields."""
    q, z = cfg.num_edges, cfg.num_requests
    size_spec = cfg.size_spec
    qp, zp = cfg.q_pad, cfg.z_pad
    if q > qp or z > zp:
        raise ValueError(f"instance ({q}, {z}) exceeds its padding "
                         f"({qp}, {zp})")

    coords = rng.uniform(0.0, 1.0, size=(qp, 2)).astype(np.float32)
    # phi(x) = a x + b with heterogeneous coefficients ~ U(0, 1)
    phi = rng.uniform(cfg.phi_low, cfg.phi_high, size=(qp, 2)).astype(np.float32)
    replicas = rng.integers(1, cfg.max_replicas + 1, size=(qp,)).astype(np.float32)
    w = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1).astype(np.float32)
    np.fill_diagonal(w, 0.0)

    # Backlogs -> workload features via eqs (1)-(3).
    c_le = np.zeros(qp, np.float32)
    c_in = np.zeros(qp, np.float32)
    t_in = np.zeros(qp, np.float32)
    for i in range(q):
        n_le = rng.integers(0, cfg.backlog_high)
        n_in = rng.integers(0, cfg.backlog_high)
        if n_le:
            sizes = size_spec.sample(rng, n_le).astype(np.float32)
            c_le[i] = _phi_eval(phi[i], sizes).sum() / replicas[i]          # eq (1)
        if n_in:
            sizes = size_spec.sample(rng, n_in).astype(np.float32)
            srcs = _sample_sources(rng, cfg, n_in, exclude=i)
            c_in[i] = _phi_eval(phi[i], sizes).sum() / replicas[i]          # eq (3)
            t_in[i] = float(np.max(cfg.ct * sizes * w[srcs, i]))            # eq (2)

    req_src = _sample_sources(rng, cfg, zp)
    req_size = size_spec.sample(rng, zp).astype(np.float32)

    edge_mask = np.zeros(qp, bool)
    edge_mask[:q] = True
    req_mask = np.zeros(zp, bool)
    req_mask[:z] = True
    # Padding hygiene: dead edges get no requests and zero features.
    req_src[z:] = 0
    req_size[z:] = 0.0
    phi[q:] = 0.0
    replicas[q:] = 1.0
    coords[q:] = 0.0

    return {
        "edge_coords": coords,
        "phi": phi,
        "replicas": replicas,
        "workload": np.stack([c_le, c_in, t_in], axis=-1),
        "w": w,
        "ct": np.float32(cfg.ct),
        "req_src": req_src,
        "req_size": req_size,
        "edge_mask": edge_mask,
        "req_mask": req_mask,
    }


def generate_batch(rng: np.random.Generator, cfg: InstanceConfig, batch: int) -> Instance:
    """Stack ``batch`` instances into one dict with a leading batch axis."""
    insts = [generate_instance(rng, cfg) for _ in range(batch)]
    return {k: np.stack([inst[k] for inst in insts]) for k in insts[0]}
