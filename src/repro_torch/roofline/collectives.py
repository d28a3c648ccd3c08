"""Collective traffic from the collectives a step ran (counterpart of
``repro/roofline/hlo_parse.py``, which reads them from compiled HLO text).

A record is (kind, result bytes, group size n), as
:class:`repro_torch.roofline.trace.DeviceCounter` records each one, kind
named as in HLO. Wire bytes per device follow the reference's
ring-algorithm accounting:

    all-gather:          result * (n-1)/n       (each shard traverses ring)
    reduce-scatter:      result * (n-1)         (input = result*n)
    all-reduce:          result * 2*(n-1)/n     (RS + AG)
    all-to-all:          result * (n-1)/n
    collective-permute:  result                 (point-to-point)
    broadcast:           result                 (sent once)

A group of one moves nothing.
"""
from __future__ import annotations

from collections import defaultdict


def _wire(op: str, size: float, n: int) -> float:
    if op == "all-gather":
        return size * (n - 1) / n
    if op == "reduce-scatter":
        return size * (n - 1)
    if op == "all-reduce":
        return size * 2 * (n - 1) / n
    if op == "all-to-all":
        return size * (n - 1) / n
    return size  # collective-permute, broadcast


def collective_wire_bytes(records) -> dict:
    """Returns {op_kind: wire_bytes_per_device} + '_total' and '_payload'."""
    out = defaultdict(float)
    payload = defaultdict(float)
    for op, size, n in records:
        if n <= 1:
            continue
        out[op] += _wire(op, size, n)
        payload[op] += size
    out["_total"] = sum(v for k, v in out.items() if not k.startswith("_"))
    out["_payload"] = sum(payload.values())
    return dict(out)


def count_ops(records) -> dict:
    counts = defaultdict(int)
    for op, _, _ in records:
        counts[op] += 1
    return dict(counts)
