"""Online serving fast path: bucketed, double-buffered decision loop on the
card; counterpart of ``repro/serving/fastpath.py``.

fixed padding buckets
    Live rounds vary in (q, z). Every snapshot is padded up to the smallest
    (q_pad, z_pad) bucket of a short ladder (:data:`DEFAULT_BUCKETS` covers
    the paper grid), so each bucket reuses one set of device buffers and
    the kernels see a handful of shapes. Decisions are mask-invariant, so
    padding never changes an assignment.

fused in-kernel decode
    Buckets default to ``fused_decode=True``: argmax/top-k happen inside
    the scoring kernel and the (Z, Q) scores are never written to device
    memory; only (z,) int32 comes back. Greedy buckets default to
    ``normalize=False``: the normalizer cannot change an argmax.

double-buffered pinned staging
    :meth:`submit` pads the snapshot into one of two pinned host buffer sets
    of its bucket (ping-pong), copies it ``non_blocking`` into the bucket's
    persistent device tensors, enqueues the decision and returns with it in
    flight; :meth:`result` waits. A CUDA event recorded after each slot's
    copy is waited on before that slot's host memory is written again, so
    round n+2 never overwrites memory that round n's copy may still read.
    Copies and kernels share one stream, so round n+1's copy into the
    device tensors runs after round n's kernels have read them. This is the
    torch counterpart of the reference's donated buffers.

explicit SLOs
    :class:`SLOSpec` states the latency contract (p50/p95/p99 in ms);
    :func:`evaluate_slo` drives a fast path over a workload and returns a
    pass/fail report.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.inference import DecisionSpec, make_decision_fn
from repro_torch.core.policy import CoRaiSPolicy

#: (q_pad, z_pad) ladder covering the paper's serving grid (Q <= 100 edges,
#: Z <= 1000 requests/round). A snapshot lands in the smallest bucket that
#: holds it; oversize snapshots raise.
DEFAULT_BUCKETS = ((10, 100), (25, 250), (50, 500), (100, 1000))

_EDGE_KEYS = ("edge_coords", "phi", "replicas", "workload", "edge_mask")
_REQ_KEYS = ("req_src", "req_size", "req_mask")


def pad_instance(inst: dict, q_pad: int, z_pad: int) -> dict:
    """Zero-pad a host-side instance to (q_pad, z_pad) (numpy, no device
    work). Masks pad with False, so the policy's decision on the real rows
    is unchanged (mask invariance)."""
    q = int(np.shape(inst["edge_mask"])[-1])
    z = int(np.shape(inst["req_mask"])[-1])
    if q > q_pad or z > z_pad:
        raise ValueError(f"instance ({q}, {z}) exceeds pad ({q_pad}, {z_pad})")
    dq, dz = q_pad - q, z_pad - z
    out = dict(inst)
    for k in _EDGE_KEYS:
        a = np.asarray(inst[k])
        out[k] = np.pad(a, ((0, dq),) + ((0, 0),) * (a.ndim - 1))
    out["w"] = np.pad(np.asarray(inst["w"]), ((0, dq), (0, dq)))
    for k in _REQ_KEYS:
        out[k] = np.pad(np.asarray(inst[k]), (0, dz))
    return out


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Latency contract for one decision path, in milliseconds."""

    p50_ms: float
    p95_ms: float
    p99_ms: float
    name: str = "decision"

    def check(self, samples_ms: Sequence[float]) -> dict:
        """Measured percentiles vs the contract -> pass/fail report row."""
        s = np.asarray(list(samples_ms), np.float64)
        if s.size == 0:
            raise ValueError("no latency samples to check against the SLO")
        measured = {p: float(np.percentile(s, p)) for p in (50, 95, 99)}
        target = {50: self.p50_ms, 95: self.p95_ms, 99: self.p99_ms}
        ok = {p: measured[p] <= target[p] for p in measured}
        return {
            "name": self.name,
            "samples": int(s.size),
            "p50_ms": measured[50], "p50_slo_ms": target[50],
            "p95_ms": measured[95], "p95_slo_ms": target[95],
            "p99_ms": measured[99], "p99_slo_ms": target[99],
            "p50_ok": ok[50], "p95_ok": ok[95], "p99_ok": ok[99],
            "pass": all(ok.values()),
        }


class _BucketStage:
    """One bucket's staging: two pinned host buffer sets (ping-pong), the
    event of each set's last copy, and the persistent device tensors."""

    def __init__(self, padded: dict, device: torch.device):
        pin = device.type == "cuda"
        self.host = [{k: torch.empty(np.shape(v),
                                     dtype=torch.from_numpy(np.asarray(v)).dtype,
                                     pin_memory=pin)
                      for k, v in padded.items()} for _ in range(2)]
        self.events: list[Optional[torch.cuda.Event]] = [None, None]
        self.dev = {k: torch.empty_like(t, device=device)
                    for k, t in self.host[0].items()}
        self.slot = 0

    def stage(self, padded: dict) -> dict:
        slot = self.slot
        self.slot = 1 - slot
        if self.events[slot] is not None:
            self.events[slot].synchronize()  # this slot's last copy is done
        host = self.host[slot]
        for k, v in padded.items():
            np.copyto(host[k].numpy(), v, casting="same_kind")
        for k, t in host.items():
            self.dev[k].copy_(t, non_blocking=True)
        if self.dev[next(iter(self.dev))].is_cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.events[slot] = ev
        return self.dev


class DecisionFastPath:
    """Bucketed, double-buffered policy decision loop.

    Per padding bucket it owns a decision function (built by
    :func:`repro_torch.core.inference.make_decision_fn`, fused decode by
    default) and a :class:`_BucketStage`. The round loop is ``submit``
    (stage + enqueue) then ``result`` (wait + strip padding); :meth:`decide`
    does both, :meth:`stream` overlaps them one round deep.

    ``device`` defaults to CUDA and raises without it; the policy must live
    on that device. Sample mode draws from one ``torch.Generator`` on the
    device, seeded with ``seed``, so repeated rounds draw fresh candidates.
    """

    def __init__(self, policy: CoRaiSPolicy, spec: Optional[DecisionSpec] = None,
                 *, mode: str = "greedy", num_samples: int = 64,
                 buckets: Sequence[tuple[int, int]] = DEFAULT_BUCKETS,
                 fused_decode: bool = True,
                 normalize: Optional[bool] = None,
                 num_candidates: Optional[int] = None,
                 backend: Optional[str] = None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        if policy.device != self.device:
            raise ValueError(f"policy lives on {policy.device}, the fast path "
                             f"on {self.device}")
        if spec is None:
            if normalize is None:
                # the normalizer cannot move a greedy argmax; sampling
                # needs true log-probs
                normalize = mode != "greedy"
            spec = DecisionSpec(mode=mode, num_samples=num_samples,
                                backend=backend, fused_decode=fused_decode,
                                num_candidates=num_candidates,
                                normalize=normalize)
        self.spec = spec
        self.mode = spec.mode
        self.buckets = tuple(sorted(tuple(b) for b in buckets))
        self._decide_fn = make_decision_fn(policy, spec)
        self._stages: dict[tuple[int, int], _BucketStage] = {}
        self._generator = None
        if self.mode == "sample":
            self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.warmup_ms: dict[tuple[int, int], float] = {}
        self.latencies_ms: list[float] = []

    # -- bucket machinery ---------------------------------------------------

    def bucket_for(self, q: int, z: int) -> tuple[int, int]:
        """Smallest bucket holding a (q, z) snapshot; raises when none do."""
        for b in self.buckets:
            if q <= b[0] and z <= b[1]:
                return b
        raise ValueError(
            f"snapshot ({q}, {z}) exceeds every fast-path bucket "
            f"{self.buckets}; add a larger bucket")

    def _stage(self, inst: dict, bucket) -> dict:
        padded = pad_instance(inst, *bucket)
        stage = self._stages.get(bucket)
        if stage is None:
            stage = self._stages[bucket] = _BucketStage(padded, self.device)
        return stage.stage(padded)

    # -- decision loop ------------------------------------------------------

    def warmup(self, buckets: Optional[Sequence[tuple[int, int]]] = None):
        """Run one decision per bucket ahead of traffic (allocates the
        staging buffers and, on the first call in a process, builds the CUDA
        kernels); returns {bucket: ms}."""
        for bucket in (buckets or self.buckets):
            bucket = tuple(bucket)
            q, z = bucket
            zero = {
                "edge_coords": np.zeros((q, 2), np.float32),
                "phi": np.zeros((q, 2), np.float32),
                "replicas": np.ones(q, np.float32),
                "workload": np.zeros((q, 3), np.float32),
                "w": np.zeros((q, q), np.float32),
                "ct": np.float32(1.0),
                "req_src": np.zeros(z, np.int32),
                "req_size": np.zeros(z, np.float32),
                "edge_mask": np.arange(q) < 1,
                "req_mask": np.zeros(z, bool),
            }
            t0 = time.perf_counter()
            self.result((self._decide_fn(self._stage(zero, bucket),
                                         self._generator), z))
            self.warmup_ms[bucket] = (time.perf_counter() - t0) * 1e3
        return dict(self.warmup_ms)

    def submit(self, inst: dict):
        """Stage + enqueue one decision; returns an in-flight handle."""
        q = int(np.shape(inst["edge_mask"])[-1])
        z = int(np.shape(inst["req_mask"])[-1])
        dev = self._stage(inst, self.bucket_for(q, z))
        return self._decide_fn(dev, self._generator), z

    def result(self, handle) -> np.ndarray:
        """Wait for an in-flight decision; returns the (z,) int32 assignment
        with bucket padding stripped."""
        out, z = handle
        return out.cpu().numpy()[:z]

    def decide(self, inst: dict) -> np.ndarray:
        """Synchronous submit+result, recording wall latency (ms)."""
        t0 = time.perf_counter()
        assign = self.result(self.submit(inst))
        self.latencies_ms.append((time.perf_counter() - t0) * 1e3)
        return assign

    def stream(self, insts: Iterable[dict]):
        """Pipelined decision stream: round n+1 is staged and enqueued while
        round n's result is awaited. Yields (z,) assignments in order."""
        pending = None
        for inst in insts:
            nxt = self.submit(inst)
            if pending is not None:
                yield self.result(pending)
            pending = nxt
        if pending is not None:
            yield self.result(pending)


def evaluate_slo(fastpath: DecisionFastPath, insts: Sequence[dict],
                 slo: SLOSpec, *, warmup_rounds: int = 2) -> dict:
    """Drive the fast path over a workload and check the SLO contract:
    warm exactly the buckets the workload hits (plus ``warmup_rounds``
    unmeasured decisions per hit bucket), replay ``insts`` through
    :meth:`DecisionFastPath.decide`, and evaluate ``slo`` on the recorded
    wall latencies. Returns the :meth:`SLOSpec.check` report plus bucket
    and device metadata."""
    if not insts:
        raise ValueError("evaluate_slo needs at least one instance")
    first_in_bucket: dict[tuple[int, int], dict] = {}
    for inst in insts:
        q = int(np.shape(inst["edge_mask"])[-1])
        z = int(np.shape(inst["req_mask"])[-1])
        first_in_bucket.setdefault(fastpath.bucket_for(q, z), inst)
    cold = [b for b in first_in_bucket if b not in fastpath.warmup_ms]
    if cold:
        fastpath.warmup(cold)
    before = len(fastpath.latencies_ms)
    for inst in first_in_bucket.values():
        for _ in range(warmup_rounds):
            fastpath.decide(inst)
    del fastpath.latencies_ms[before:]
    for inst in insts:
        fastpath.decide(inst)
    report = slo.check(fastpath.latencies_ms[before:])
    report["buckets"] = [list(b) for b in fastpath.buckets]
    report["warmup_ms"] = {f"{b[0]}x{b[1]}": ms
                           for b, ms in fastpath.warmup_ms.items()}
    report["device"] = str(fastpath.device)
    return report
