"""Global-norm clipping over a dict of named gradients and the
int8-compressed all-reduce (counterpart of ``repro/optim/grad_utils.py``)."""
from __future__ import annotations

import torch
import torch.distributed as dist


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: dict[str, torch.Tensor], max_norm: float):
    """Scale ``tree`` so its global norm is at most ``max_norm``. Returns
    (clipped dict, raw norm). A non-finite norm (an inf/nan gradient leaf)
    zeroes the whole update instead of poisoning it, and any entry that is
    still non-finite after scaling becomes 0; the raw norm still reports
    the blow-up."""
    norm = global_norm(tree)
    scale = torch.where(torch.isfinite(norm),
                        torch.clamp(max_norm / (norm + 1e-12), max=1.0),
                        torch.zeros_like(norm))

    def clip(x):
        c = x.to(torch.float32) * scale
        return torch.where(torch.isfinite(c), c, 0.0).to(x.dtype)

    return {k: clip(x) for k, x in tree.items()}, norm


def quantize_int8(x: torch.Tensor):
    """Per-tensor absmax int8 quantization. Returns (q, scale)."""
    absmax = torch.max(torch.abs(x.to(torch.float32)))
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-compressed all-reduce over ``group`` (a ``torch.distributed``
    process group; the default world when None).

    Each rank quantizes locally; the scales are reduced with MAX so the
    shared dequantization grid is conservative, every rank re-quantizes
    against it, and the int8 payloads are summed in int32 to avoid overflow
    (safe up to 2**24 ranks). Mean-preserving up to quantization error
    (bounded by scale/2 per element per rank)."""
    _, scale = quantize_int8(x)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    # re-quantize against the shared scale so the sum is coherent
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return (total.to(torch.float32) * scale).to(x.dtype)
