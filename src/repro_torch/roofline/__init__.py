"""The three-term roofline of a traced step on the H100 (counterpart of
``repro/roofline``): :mod:`~repro_torch.roofline.hw` (the H100's figures),
:mod:`~repro_torch.roofline.trace` (the per-device counter),
:mod:`~repro_torch.roofline.collectives` (ring accounting of the recorded
collectives) and :mod:`~repro_torch.roofline.analysis` (the report)."""
from repro_torch.roofline.analysis import analyze_trace, roofline_terms
from repro_torch.roofline.collectives import collective_wire_bytes
from repro_torch.roofline.hw import HW

__all__ = ["HW", "collective_wire_bytes", "analyze_trace", "roofline_terms"]
