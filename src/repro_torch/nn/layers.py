"""Layers of the CoRaiS policy: Linear, multi-head attention, the masked
BatchNorm and LayerNorm (counterpart of ``repro/nn/layers.py``).

Weights keep the reference's ``(in, out)`` layout and leaf names, so a
state-dict key is the reference pytree path with ``.`` for ``/`` (for
example ``edge_layers.0.align.mha.wq``) and a reference checkpoint loads
leaf for leaf (:mod:`repro_torch.checkpoint.convert`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.nn.module import uniform_init


class Linear(nn.Module):
    """``y = x @ w + b`` with ``w`` stored (in, out), as the reference
    stores it (``torch.nn.Linear`` stores (out, in))."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True,
                 generator: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(uniform_init(generator, (in_dim, out_dim),
                                           fan_in=in_dim))
        if bias:
            self.b = nn.Parameter(uniform_init(generator, (out_dim,),
                                               fan_in=in_dim))
        else:
            self.register_parameter("b", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y if self.b is None else y + self.b


class MHA(nn.Module):
    """Multi-head attention (paper eqs 12/14/15). ``kv_dim`` lets the
    context decoder attend from 3d-wide context queries to d-wide request
    embeddings."""

    def __init__(self, dim: int, num_heads: int, *, kv_dim: int | None = None,
                 out_dim: int | None = None, generator: torch.Generator):
        super().__init__()
        kv_dim = kv_dim or dim
        out_dim = out_dim or dim
        self.num_heads = num_heads
        self.wq = nn.Parameter(uniform_init(generator, (dim, out_dim), dim))
        self.wk = nn.Parameter(uniform_init(generator, (kv_dim, out_dim),
                                            kv_dim))
        self.wv = nn.Parameter(uniform_init(generator, (kv_dim, out_dim),
                                            kv_dim))
        self.wo = nn.Parameter(uniform_init(generator, (out_dim, out_dim),
                                            out_dim))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """Self-attention if ``kv_in`` is None, else cross-attention.
        ``mask`` broadcasts to (..., H, Nq, Nk), True = keep; masked logits
        are set to -1e9 as in the reference."""
        if kv_in is None:
            kv_in = q_in
        h = self.num_heads
        q = q_in @ self.wq
        k = kv_in @ self.wk
        v = kv_in @ self.wv
        dh = q.shape[-1] // h

        def heads(x):
            return x.reshape(*x.shape[:-1], h, dh).movedim(-2, -3)

        qh, kh, vh = heads(q), heads(k), heads(v)  # (..., H, N, dh)
        logits = (qh @ kh.transpose(-1, -2)) / math.sqrt(dh)
        if mask is not None:
            logits = torch.where(mask, logits, -1e9)
        attn = torch.softmax(logits, dim=-1)
        out = (attn @ vh).movedim(-3, -2).reshape(*q_in.shape[:-1], h * dh)
        return out @ self.wo


class BatchNorm(nn.Module):
    """BatchNorm over all leading axes (batch x nodes), restricted to the
    valid tokens of ``mask``, with the reference's statistics: biased
    variance, momentum 0.9 and a float ``count`` of training updates.

    ``training=True`` normalizes with the batch statistics and updates the
    ``mean``/``var``/``count`` buffers in place (the reference returns the
    new state instead). Otherwise the running statistics are used once
    ``count > 0``; an untrained layer falls back to the masked batch
    statistics (``repro/core/policy.py:211-234``). ``per_instance=True``
    takes that fallback's statistics per instance, over the node axis
    (-2) only, as the reference computes them under ``vmap`` (its rollout
    engine); it is an evaluation-only option."""

    momentum = 0.9
    eps = 1e-5

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        self.register_buffer("count", torch.zeros(()))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None, *,
                training: bool = False,
                per_instance: bool = False) -> torch.Tensor:
        if mask is None:
            m = torch.ones_like(x[..., :1])
        else:
            m = mask[..., None].to(x.dtype)
        if per_instance:
            if training:
                raise ValueError("per-instance statistics are an evaluation "
                                 "fallback; training pools the batch")
            cnt = torch.clamp(m.sum(-2, keepdim=True), min=1.0)
            mean = (x * m).sum(-2, keepdim=True) / cnt
            var = (torch.square(x - mean) * m).sum(-2, keepdim=True) / cnt
        else:
            axes = tuple(range(x.ndim - 1))
            cnt = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(axes) / cnt
            var = (torch.square(x - mean) * m).sum(axes) / cnt
        if training:
            with torch.no_grad():
                mom = self.momentum
                self.mean.copy_(mom * self.mean + (1 - mom) * mean.detach())
                self.var.copy_(mom * self.var + (1 - mom) * var.detach())
                self.count.add_(1)
        else:
            trained = self.count > 0
            mean = torch.where(trained, self.mean, mean)
            var = torch.where(trained, self.var, var)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias


class LayerNorm(nn.Module):
    """LayerNorm over the last axis (the policy's ``norm="layer"`` knob)."""

    eps = 1e-5

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.square(x - mean).mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias


def nonparametric_layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style LayerNorm without learnable parameters (arXiv:2402.00838),
    in f32 (counterpart of ``repro/nn/layers.py:141``)."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.square(x - mean).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)
