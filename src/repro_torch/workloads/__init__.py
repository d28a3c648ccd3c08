"""Numpy workload vocabulary the port needs (copies from ``repro.workloads``)."""
from repro_torch.workloads.base import SizeSpec, edge_weights

__all__ = ["SizeSpec", "edge_weights"]
