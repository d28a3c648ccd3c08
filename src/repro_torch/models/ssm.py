"""Mamba-1 selective SSM block: falcon-mamba's layer and hymba's SSM branch
(counterpart of ``repro/models/ssm.py``).

The full-sequence block's tail (dt's softplus, the scan, the D skip and
the SiLU gate, the cast before ``out_proj``) goes through
:func:`repro_torch.kernels.ops.mamba_scan_gated`: kernel B6's gated entry on
a CUDA tensor, its plain version (the reference's own ops) on a CPU tensor.
:func:`ssm_scan` is the bare scan. The decode step is plain torch ops, as in
the reference. Casts follow the reference:
the conv input, the conv, the SiLU, dt, B, C and the scan in f32; the
projections in the model's dtype.

``cfg.ssm_chunk`` and ``cfg.ssm_unroll`` choose how the reference's scan is
chunked and unrolled; they do not change the function, and the port ignores
them. ``cfg.ssm_scan_dtype`` is "float32" or "bfloat16" (the reference's
``ssm-bf16`` variant): with the latter the scan rounds exp(dt*A) and
dt*B*u to bf16 and carries its state in bf16 (``bf16_state`` of B6, B6b
and their plain versions), as the reference's ``ssm_scan`` does
(``repro/models/ssm.py:74-87``); the D skip, the gate and the decode step
stay f32, as there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (causal_depthwise_conv, conv_step,
                                       dense)
from repro_torch.nn.module import normal_init, uniform_init


#: the scan dtypes: whether each carries the state in bf16
SCAN_DTYPES = {"float32": False, "bfloat16": True}


def bf16_state(scan_dtype: str) -> bool:
    """Whether ``scan_dtype`` (``cfg.ssm_scan_dtype``) carries the scan's
    state in bf16; raises ValueError for a dtype other than the two."""
    if scan_dtype not in SCAN_DTYPES:
        raise ValueError(f"ssm_scan_dtype={scan_dtype!r}: the scan runs in "
                         f"{' or '.join(map(repr, SCAN_DTYPES))}")
    return SCAN_DTYPES[scan_dtype]


def ssm_init(generator: torch.Generator, cfg: ModelConfig, dtype,
             device=None) -> dict:
    """The reference's leaves and initialisation: projections normal (std
    0.02) in ``dtype``; ``conv_w`` normal (std 0.02) and ``dt_proj``
    uniform (fan-in ``dt_rank``) in f32; ``A_log = log(1..N)`` per channel
    (S4D-real); ``dt_bias`` the inverse softplus of a dt drawn log-uniform
    in [1e-3, 1e-1]; ``conv_b`` zeros and ``D`` ones. Drawn from
    ``generator`` on ``device`` (the generator's own by default)."""
    d, di, ds, dr, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                        cfg.ssm_dt_rank, cfg.ssm_conv)
    device = generator.device if device is None else torch.device(device)
    f32 = torch.float32

    def normal(shape, dt_):
        return normal_init(generator, shape, 0.02, dt_, device)

    in_proj = normal((d, 2 * di), dtype)
    conv_w = normal((di, k), f32)
    x_proj = normal((di, dr + 2 * ds), dtype)
    dt_proj = uniform_init(generator, (dr, di), fan_in=dr, device=device)
    out_proj = normal((di, d), dtype)
    r = torch.rand((di,), generator=generator, dtype=f32, device=device)
    dt = torch.exp(r * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    a = torch.arange(1, ds + 1, dtype=f32, device=device)[None, :]
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), dtype=f32, device=device),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": dt_bias,
        "A_log": torch.log(a.expand(di, ds)).contiguous(),
        "D": torch.ones((di,), dtype=f32, device=device),
        "out_proj": out_proj,
    }


def ssm_scan(u, dt, B_mat, C_mat, A, scan_dtype: str = "float32"):
    """Selective scan from a zero state. u, dt: (B, S, d); B_mat, C_mat:
    (B, S, N); A: (d, N). Returns (y (B, S, d) f32, h_last (B, d, N) f32).
    ``scan_dtype`` "bfloat16" carries the state in bf16 (h_last holds bf16
    values), as the reference's ``scan_dtype``.

    Any S: the reference's ``ssm_scan`` asserts ``S % min(ssm_chunk, S) ==
    0`` and its Pallas kernel ``S % chunk == 0`` and ``d % bd == 0``, but
    neither the function nor its oracle ``mamba_scan_ref`` has that limit,
    and served prompts have any length. On the card this is kernel B6."""
    return ops.mamba_scan(*(t.float().contiguous()
                            for t in (u, dt, B_mat, C_mat, A)),
                          bf16_state=bf16_state(scan_dtype))


def _dt_b_c(p, xdbc, cfg: ModelConfig):
    """dt before its bias and softplus (``dt_low @ dt_proj``), B and C, f32."""
    dr, ds = cfg.ssm_dt_rank, cfg.ssm_state
    dt_low = xdbc[..., :dr].float()
    B_mat = xdbc[..., dr:dr + ds].float()
    C_mat = xdbc[..., dr + ds:].float()
    return dt_low @ p["dt_proj"], B_mat, C_mat


def ssm_apply(p, x, cfg: ModelConfig):
    """Full-sequence mamba block. x: (B, S, D) -> (out (B, S, D) in x's
    dtype, state {"h": (B, d, N), "conv": (B, K-1, d)}), the state in
    :func:`ssm_decode_step`'s format so prefill hands over to decode. The
    scan runs in ``cfg.ssm_scan_dtype`` (:func:`bf16_state`)."""
    bf16 = bf16_state(cfg.ssm_scan_dtype)
    k = cfg.ssm_conv
    uz = dense(x, p["in_proj"])
    u_raw, z = uz.chunk(2, dim=-1)
    u_raw = u_raw.float()
    u = F.silu(causal_depthwise_conv(u_raw, p["conv_w"], p["conv_b"]))
    xdbc = dense(u.to(x.dtype), p["x_proj"])
    dt_raw, B_mat, C_mat = _dt_b_c(p, xdbc, cfg)
    A = -torch.exp(p["A_log"])
    # softplus, scan, D skip, gate and the cast to z's (= x's) dtype
    y, h_last = ops.mamba_scan_gated(u, dt_raw, p["dt_bias"],
                                     B_mat.contiguous(), C_mat.contiguous(),
                                     A, p["D"], z, bf16_state=bf16)
    # conv state = the last K-1 raw (pre-conv) inputs, as conv_step takes;
    # a copy, so the state does not hold all of u_raw (B, S, d) alive
    s_len = u_raw.shape[1]
    if s_len >= k - 1:
        conv_state = u_raw[:, s_len - (k - 1):, :].clone()
    else:
        conv_state = F.pad(u_raw, (0, 0, k - 1 - s_len, 0))
    return dense(y, p["out_proj"]), {"h": h_last, "conv": conv_state}


def ssm_decode_step(p, x_t, state, cfg: ModelConfig):
    """One-token step. x_t: (B, D); state: {"h": (B, d, N), "conv":
    (B, K-1, d)}, both f32, updated in place (the reference returns new
    arrays). Returns y_t (B, D) in x_t's dtype."""
    uz = dense(x_t, p["in_proj"])
    u, z = uz.chunk(2, dim=-1)
    u_c, conv_state = conv_step(u.float(), state["conv"], p["conv_w"],
                                p["conv_b"])
    u_c = F.silu(u_c)
    dt_raw, B_mat, C_mat = _dt_b_c(p, dense(u_c.to(x_t.dtype), p["x_proj"]),
                                   cfg)
    dt = F.softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)  # (B, d, N)
    dBu = dt[..., None] * B_mat[:, None, :] * u_c[..., None]
    h = dA * state["h"] + dBu
    y = (h * C_mat[:, None, :]).sum(-1) + p["D"] * u_c
    y = y * F.silu(z.float())
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    return dense(y.to(x_t.dtype), p["out_proj"])


def ssm_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    return {"h": (batch, cfg.d_inner, cfg.ssm_state),
            "conv": (batch, cfg.ssm_conv - 1, cfg.d_inner)}
