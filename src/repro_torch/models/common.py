"""Shared LM building blocks: norm dispatch, qk-norm, rotary position
embeddings (incl. qwen2-vl's multimodal M-RoPE), whisper's sinusoidal
table and the mamba front's causal depthwise conv (counterpart of
``repro/models/common.py``).

Parameters are plain tensors in nested dicts with the reference's leaf
names.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.nn.layers import nonparametric_layernorm


def norm_init(cfg: ModelConfig, dim: int, device=None):
    """The reference's norm leaves: a (0,) placeholder for the
    nonparametric norm (kept, so the weight bridge maps leaf for leaf),
    {"scale", "bias"} for layernorm, {"scale"} for rmsnorm; all f32."""
    if cfg.norm == "nonparametric":
        return torch.zeros((0,), dtype=torch.float32, device=device)
    scale = torch.ones((dim,), dtype=torch.float32, device=device)
    if cfg.norm == "layernorm":
        return {"scale": scale,
                "bias": torch.zeros((dim,), dtype=torch.float32,
                                    device=device)}
    return {"scale": scale}


def norm_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Normalise over the last axis in f32; return x's dtype."""
    dtype = x.dtype
    if cfg.norm == "nonparametric":
        return nonparametric_layernorm(x).to(dtype)
    xf = x.float()
    if cfg.norm == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = torch.square(xf - mean).mean(-1, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + 1e-5) * p["scale"]
                + p["bias"]).to(dtype)
    ms = torch.square(xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * p["scale"]).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype, the model's projections. On the CPU a bf16
    product is formed in f32 and rounded once to bf16: PyTorch runs bf16
    products there on oneDNN's AMX kernel where the CPU has AMX, and that
    kernel returned NaN from finite inputs in a process preempted under
    load (ROADMAP C9). The f32 product has the same exact bf16 products
    and f32 sums; on the card the product stays a bf16 GEMM."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return (x.float() @ w.float()).to(x.dtype)
    return x @ w


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: the rows of an embedding table. On DTensors each
    rank gathers its block of ``ids`` from the whole table (the table
    brought whole first, counted as an "embed" redistribution), so its
    backward is the meshless path's index-add on each rank, summed over
    the ranks that split the ids. DTensor's own sharding rule for this
    index's backward fails on some PyTorch releases (2.11 on the card)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(table, DTensor):
        return table[ids]
    from repro_torch.kernels import ops
    rows = {"batch": 0}
    if not isinstance(ids, DTensor):
        roles = (None,) * table.device_mesh.ndim
    else:
        roles = ops.mesh_roles(ids, rows)
    return ops.run_on_blocks("embed", lambda t, i: t[i], table.device_mesh,
                             roles, [(table, {}), (ids, rows)], rows)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """qk-norm (qwen3): RMSNorm over head_dim with a learned (head_dim,)
    scale."""
    xf = x.float()
    ms = torch.square(xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Split-halves rotation of x (..., S, H, hd) by f32 angles (..., S,
    hd/2); returns x's dtype."""
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-halves RoPE. x: (..., S, H, hd); positions broadcastable to
    (..., S). Angles in f32; returns x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., :, None].float() * freqs)


def _slot_axes(sections, slots: int) -> list[int]:
    """The position row (0 = t, 1 = h, 2 = w) of each of the ``slots``
    frequency slots: ``sections[a]`` slots of row a in turn, cut to
    ``slots`` or padded with the last row (``jnp.repeat`` with
    ``total_repeat_length``)."""
    axes = [a for a, n in enumerate(sections) for _ in range(n)]
    return (axes + axes[-1:] * slots)[:slots]


def apply_mrope(x: torch.Tensor, position_ids: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (..., S, H, hd); position_ids: (3, ...,
    S), the (t, h, w) rows; ``sections`` split the hd/2 frequency slots
    across the three rows. Angles in f32; returns x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    axes = torch.tensor(_slot_axes(sections, hd // 2), device=x.device)
    # (..., S, hd/2): each slot's position, taken from its row
    per_slot = position_ids.float().movedim(0, -1)[..., axes]
    return _rotate(x, per_slot * freqs)


def position_encode(cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """q/k position encoding. positions: (..., S) int, or (3, ..., S) for
    M-RoPE."""
    if cfg.mrope:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def sinusoidal_positions(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal table (S, dim) in f32: sin in the
    even columns, cos in the odd."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(-math.log(10_000.0) * torch.arange(
        0, dim, 2, dtype=torch.float32, device=device) / dim)
    tab = torch.zeros((seq_len, dim), dtype=torch.float32, device=device)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab


# ---------------------------------------------------------------------------
# depthwise causal conv (mamba front)
# ---------------------------------------------------------------------------
# The K taps are explicit f32 multiply-adds, not ``F.conv1d``: cuDNN may run
# an f32 convolution in TF32 (``torch.backends.cudnn.allow_tf32`` defaults
# to True), where the reference's ``conv_general_dilated`` is exact f32.


#: where the conv's tensors keep their batch and channels
_CONV_IN, _CONV_CH = {"batch": 0, "channels": 2}, {"channels": 0}


def causal_depthwise_conv(u: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """u: (B, S, C); w: (C, K); b: (C,). Causal depthwise 1-D conv:
    ``out[t, c] = sum_k u[t - K + 1 + k, c] * w[c, k] + b[c]``, with zeros
    before the start. On a mesh (a DTensor u) it runs on each rank's block
    of lanes and channels (``ops.run_on_blocks``, counted under "conv"
    where the time axis must first be brought whole): it mixes neither."""
    if isinstance(u, DTensor):
        return ops.run_on_blocks(
            "conv", causal_depthwise_conv, u.device_mesh,
            ops.mesh_roles(u, _CONV_IN),
            [(u, _CONV_IN), (w, _CONV_CH), (b, _CONV_CH)], _CONV_IN)
    k = w.shape[-1]
    s = u.shape[1]
    pad = torch.nn.functional.pad(u, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[:, 0]
    for j in range(1, k):
        out = out + pad[:, j:j + s] * w[:, j]
    return out + b


def conv_step(u_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the causal depthwise conv. u_t: (B, C) new input;
    conv_state: (B, K-1, C) previous inputs. Returns (y_t (B, C), new_state
    (B, K-1, C))."""
    window = torch.cat([conv_state, u_t[:, None, :]], dim=1)  # (B, K, C)
    y = (window * w.T).sum(1) + b
    return y, window[:, 1:, :]
