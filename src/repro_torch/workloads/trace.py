"""JSONL workload traces: record once, replay against any scheduler backend.

A copy of ``repro/workloads/trace.py``: it reads and writes the same bytes
(held byte for byte against ``tests/data/trace_v1.jsonl`` and
``trace_v2.jsonl`` by ``tests/test_torch_workloads.py``).

Format (schema-versioned, one JSON object per line):

    {"schema": "corais.trace.v1", "num_edges": 5, "meta": {...}}   # header
    {"t": 0.0123, "edge": 3, "size": 0.4567}                       # events...
    {"t": 0.0456, "edge": 0, "size": 0.9876, "service": 1}

Floats are serialized with ``repr`` (Python's json default), which
round-trips IEEE doubles exactly — so record->replay is bit-identical and a
replayed run reproduces the live run's completion metrics under the same
simulator seed. A :class:`TraceWorkload` satisfies the same ``Workload``
protocol as the synthetic generators, so the three consumers (simulator
``drive``, scenario sweep, examples) cannot tell a trace from a process.

Schema v2 adds an optional ``events`` section to the header — the fault
timeline (failures / recoveries / straggler speed changes) captured as
absolute-time :class:`FaultEvent` records:

    {"schema": "corais.trace.v2", "num_edges": 5, "meta": {...},
     "events": [{"t": 0.75, "kind": "fail", "edge": 2},
                {"t": 1.25, "kind": "recover", "edge": 2},
                {"t": 1.25, "kind": "straggle", "edge": 0, "factor": 4.0}]}

A trace without fault events is always written under the v1 schema, byte
for byte what pre-v2 code produced, and v1 files read back unchanged —
``fault_events`` is just empty. ``repro.resilience.faults`` converts
between these records and the engine's per-round event tensors.

Schema v3 adds optional per-event ``deadline`` (relative response budget in
seconds; the hard SLO is ``t + deadline``) and ``priority`` (small integer
importance level) fields, written only when nonzero:

    {"schema": "corais.trace.v3", "num_edges": 5, "meta": {...}}
    {"t": 0.0123, "edge": 3, "size": 0.4567, "service": 2,
     "deadline": 1.5, "priority": 1}

Downgrade is byte-exact: a stream with no deadlines/priorities writes the
same v2 bytes (faults present) or v1 bytes (fault-free) that pre-v3 code
produced, and every older file reads back unchanged under the v3 reader —
the new :class:`Arrival` fields just hold their defaults.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.workloads.base import Arrival, Workload, workload_rng

SCHEMA_V1 = "corais.trace.v1"
SCHEMA_V2 = "corais.trace.v2"
SCHEMA_V3 = "corais.trace.v3"
SCHEMA = SCHEMA_V1  # default write schema (used when a trace has no faults)
_SUPPORTED_SCHEMAS = (SCHEMA_V1, SCHEMA_V2, SCHEMA_V3)

FAULT_KINDS = ("fail", "recover", "straggle")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One entry of a trace's fault timeline: at wall time ``t`` edge
    ``edge`` fails, recovers, or changes straggler speed to ``factor``
    (``factor`` is only meaningful for kind="straggle"; 1.0 = nominal)."""

    t: float
    kind: str
    edge: int
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"supported: {FAULT_KINDS}")


@dataclasses.dataclass(frozen=True)
class TraceWorkload:
    """A recorded arrival stream. ``arrivals`` ignores the rng (a trace is
    already fully determined) and replays events with t <= until. v2 traces
    additionally carry ``fault_events`` — the recorded fault timeline — for
    consumers that replay the chaos alongside the arrivals."""

    events: tuple
    num_edges: int = 0
    meta: Optional[dict] = None
    schema: str = SCHEMA
    fault_events: tuple = ()

    def arrivals(self, rng, num_edges, until):
        for a in self.events:
            if a.t > until:
                return
            yield a

    def __len__(self):
        return len(self.events)


def write_trace(path: str, arrivals: Iterable[Arrival], *, num_edges: int,
                meta: Optional[dict] = None,
                fault_events: Sequence[FaultEvent] = ()) -> int:
    """Write arrivals (any iterable, consumed once) as a JSONL trace.
    Returns the number of events written. The schema is the lowest version
    that can express the stream: any deadline/priority field stamps
    ``corais.trace.v3``, else ``fault_events`` stamp ``corais.trace.v2``,
    else the file is a byte-identical v1 trace."""
    events = list(arrivals)
    has_v3 = any(a.deadline or a.priority for a in events)
    if has_v3:
        schema = SCHEMA_V3
    elif fault_events:
        schema = SCHEMA_V2
    else:
        schema = SCHEMA_V1
    with open(path, "w") as f:
        header = {"schema": schema,
                  "num_edges": int(num_edges), "meta": meta or {}}
        if fault_events:
            header["events"] = [_fault_row(ev, num_edges)
                                for ev in fault_events]
        f.write(json.dumps(header) + "\n")
        for a in events:
            row = {"t": float(a.t), "edge": int(a.edge),
                   "size": float(a.size)}
            if a.service:
                row["service"] = int(a.service)
            if a.deadline:
                row["deadline"] = float(a.deadline)
            if a.priority:
                row["priority"] = int(a.priority)
            f.write(json.dumps(row) + "\n")
    return len(events)


def record_trace(path: str, workload: Workload, *, num_edges: int,
                 until: float, seed: int = 0,
                 rng: Optional[np.random.Generator] = None,
                 meta: Optional[dict] = None,
                 fault_events: Sequence[FaultEvent] = ()) -> int:
    """Materialize ``workload`` over [0, until] and persist it. The same
    (workload, seed, num_edges, until) always records the same trace, and
    it is the exact stream ``MultiEdgeSim.drive(workload, seed=seed)``
    would generate live (both derive :func:`workload_rng`)."""
    rng = workload_rng(seed) if rng is None else rng
    info = {"until": float(until), "seed": int(seed),
            "workload": repr(workload)}
    info.update(meta or {})
    return write_trace(path, workload.arrivals(rng, num_edges, until),
                       num_edges=num_edges, meta=info,
                       fault_events=fault_events)


def _fault_row(ev: FaultEvent, num_edges: int) -> dict:
    if num_edges and not 0 <= int(ev.edge) < num_edges:
        raise ValueError(f"fault event edge {ev.edge} outside the trace's "
                         f"0..{num_edges - 1}")
    row = {"t": float(ev.t), "kind": ev.kind, "edge": int(ev.edge)}
    if ev.kind == "straggle":
        row["factor"] = float(ev.factor)
    return row


def _parse_fault_events(header: dict, path: str) -> tuple:
    rows = header.get("events") or ()
    out, last_t = [], -np.inf
    for i, row in enumerate(rows):
        try:
            ev = FaultEvent(t=float(row["t"]), kind=str(row["kind"]),
                            edge=int(row["edge"]),
                            factor=float(row.get("factor", 1.0)))
        except (KeyError, ValueError) as exc:
            raise ValueError(f"{path}: bad fault event {i}: {exc}") from None
        n_edges = int(header.get("num_edges", 0))
        if n_edges and not 0 <= ev.edge < n_edges:
            raise ValueError(f"{path}: fault event {i}: edge {ev.edge} "
                             f"outside the trace's 0..{n_edges - 1}")
        if ev.t < last_t:
            raise ValueError(f"{path}: fault events out of order")
        last_t = ev.t
        out.append(ev)
    return tuple(out)


def read_trace(path: str) -> TraceWorkload:
    """Load a JSONL trace; validates the schema header."""
    with open(path) as f:
        first = f.readline()
        if not first.strip():
            raise ValueError(f"{path}: empty trace file")
        header = json.loads(first)
        schema = header.get("schema")
        if schema not in _SUPPORTED_SCHEMAS:
            raise ValueError(
                f"{path}: unsupported trace schema {schema!r} "
                f"(supported: {_SUPPORTED_SCHEMAS})")
        if schema == SCHEMA_V1 and "events" in header:
            raise ValueError(f"{path}: fault events require {SCHEMA_V2}")
        fault_events = _parse_fault_events(header, path)
        events = []
        last_t = -np.inf
        for lineno, line in enumerate(f, start=2):
            if not line.strip():
                continue
            row = json.loads(line)
            if schema != SCHEMA_V3 and ("deadline" in row
                                        or "priority" in row):
                raise ValueError(
                    f"{path}:{lineno}: deadline/priority fields require "
                    f"{SCHEMA_V3}")
            a = Arrival(t=float(row["t"]), edge=int(row["edge"]),
                        size=float(row["size"]),
                        service=int(row.get("service", 0)),
                        deadline=float(row.get("deadline", 0.0)),
                        priority=int(row.get("priority", 0)))
            n_edges = int(header.get("num_edges", 0))
            if n_edges and not 0 <= a.edge < n_edges:
                raise ValueError(f"{path}:{lineno}: edge {a.edge} outside "
                                 f"the trace's 0..{n_edges - 1}")
            if a.t < last_t:
                raise ValueError(f"{path}:{lineno}: arrivals out of order")
            last_t = a.t
            events.append(a)
    return TraceWorkload(events=tuple(events),
                         num_edges=int(header.get("num_edges", 0)),
                         meta=header.get("meta") or {}, schema=schema,
                         fault_events=fault_events)
