"""Global-norm clipping over a dict of named gradients (counterpart of
``clip_by_global_norm`` and ``global_norm`` in
``repro/optim/grad_utils.py``)."""
from __future__ import annotations

import torch


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
