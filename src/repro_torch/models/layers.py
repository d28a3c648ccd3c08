"""Per-layer blocks of the LM: attention (prefill + decode), the MLP or
MoE, the decoder layer of the dense, MoE (mixtral), VLM backbone
(qwen2-vl, M-RoPE), SSM (falcon-mamba) and hybrid (hymba) families, and
whisper's encoder and decoder layers with their cross attention
(counterpart of ``repro/models/layers.py``).

Parameters are nested dicts of tensors with the reference's leaf names and
(in, out) layouts. Whisper (``family == "audio"``) has absolute positions
added at embedding time: its attention takes no RoPE.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (dense, norm_apply, norm_init,
                                       position_encode, rms_head_norm)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.ssm import ssm_apply, ssm_decode_step, ssm_init
from repro_torch.nn.module import normal_init
from repro_torch.sharding.ctx import current, split_heads


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------


def attn_init(generator: torch.Generator, cfg: ModelConfig, dtype,
              device=None, cross: bool = False):
    """wq, wk, wv, wo; the qk-norm scales where the config has them, never
    on a cross attention."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def w(shape):
        return normal_init(generator, shape, 0.02, dtype, device)

    p = {"wq": w((d, h * hd)), "wk": w((d, kv * hd)), "wv": w((d, kv * hd)),
         "wo": w((h * hd, d))}
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    return p


def _project_qkv(p, x, cfg: ModelConfig, positions):
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_heads(dense(x, p["wq"]), h, hd)
    k = split_heads(dense(x, p["wk"]), kv, hd)
    v = split_heads(dense(x, p["wv"]), kv, hd)
    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    if cfg.family != "audio":  # whisper: absolute positions, no RoPE
        q = position_encode(cfg, q, positions)
        k = position_encode(cfg, k, positions)
    return q, k, v


def attn_forward(p, x, positions, cfg: ModelConfig, *, causal: bool = True):
    """Full-sequence attention (prefill, training) through B4. x: (B, S, D).
    Returns (out (B, S, D), (k, v)) with k, v (B, S, KV, hd) after RoPE."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = attn_lib.flash_attention(q, k, v, chunk=cfg.attn_chunk,
                                   causal=causal,
                                   window=cfg.sliding_window,
                                   logit_softcap=cfg.attn_logit_softcap)
    b, s = x.shape[0], x.shape[1]
    out = dense(out.reshape(b, s, cfg.num_heads * cfg.head_dim), p["wo"])
    return out, (k, v)


def attn_decode(p, x_t, layer_cache, slot_pos, pos, cfg: ModelConfig,
                positions=None):
    """One-token attention through B5. x_t: (B, D); layer_cache: {"k", "v"}
    (B, W, KV, hd); slot_pos (B, W) already holds ``pos`` (B,), the
    sequence position, in its slot; ``positions`` (3, B) are the M-RoPE
    rows (``pos`` on each row by default). Inside a sharding context with
    ``cfg.decode_flash_shardmap`` the attention is the flash-decode over
    the sequence-sharded cache (``attention.sharded_decode_attention``),
    as the reference's (``repro/models/layers.py:93-104``); otherwise B5
    takes the cache on the placements it can (``ops.decode_attention``).

    The new K/V row is written into slot ``pos % W`` of the cache in place
    (the reference blends it in with a one-hot mask,
    ``repro/models/layers.py:90-92``; for finite caches the result is the
    same). The slot and the causal mask follow ``pos``, as ``slot_pos``
    does; M-RoPE takes only its angles from ``positions``. (The reference
    keys both by the t row, which disagrees with its ``slot_pos`` wherever
    t is not the sequence position: ROADMAP C10.) Returns (out (B, D),
    layer_cache)."""
    b = x_t.shape[0]
    if cfg.mrope:
        rope_pos = (pos[None].expand(3, b) if positions is None
                    else positions)[..., None]
    else:
        rope_pos = pos[:, None]
    q, k, v = _project_qkv(p, x_t[:, None, :], cfg, rope_pos)
    q = q[:, 0]  # (B, H, hd)
    slot = (pos % layer_cache["k"].shape[1]).long()
    attn_lib.write_slot(layer_cache["k"], slot, k[:, 0])
    attn_lib.write_slot(layer_cache["v"], slot, v[:, 0])
    ctx = current()
    decode = (attn_lib.sharded_decode_attention
              if cfg.decode_flash_shardmap and ctx is not None
              else attn_lib.decode_attention)
    out = decode(q, layer_cache["k"], layer_cache["v"], slot_pos, pos,
                 logit_softcap=cfg.attn_logit_softcap,
                 window=cfg.sliding_window)
    return (dense(out.reshape(b, cfg.num_heads * cfg.head_dim), p["wo"]),
            layer_cache)


def cross_attn_forward(p, x, enc_out, cfg: ModelConfig):
    """Decoder-to-encoder cross attention (whisper): queries from x (B, S,
    D), keys and values from enc_out (B, S_enc, D); no RoPE, no mask, no
    qk-norm. S > 1 runs B4 at Sq = S against Sk = S_enc; a decode step's
    single row runs :func:`attention.cross_decode_attention` (B5 on the
    card), where the reference runs ``naive_attention``. The frames' K/V
    are projected on every call, as the reference does. Returns (B, S,
    D)."""
    b, s = x.shape[0], x.shape[1]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_heads(dense(x, p["wq"]), h, hd)
    k = split_heads(dense(enc_out, p["wk"]), kv, hd)
    v = split_heads(dense(enc_out, p["wv"]), kv, hd)
    if s == 1:
        out = attn_lib.cross_decode_attention(q, k, v)
    else:
        out = attn_lib.flash_attention(q, k, v, chunk=cfg.attn_chunk,
                                       causal=False)
    return dense(out.reshape(b, s, h * hd), p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(generator: torch.Generator, cfg: ModelConfig, dtype,
             device=None):
    d, f = cfg.d_model, cfg.d_ff

    def w(shape):
        return normal_init(generator, shape, 0.02, dtype, device)

    if cfg.act == "silu":
        return {"wg": w((d, f)), "wu": w((d, f)), "wo": w((f, d))}
    return {"wi": w((d, f)), "wo": w((f, d))}


def mlp_apply(p, x, cfg: ModelConfig):
    """SwiGLU, or a GELU MLP with jax's default tanh approximation."""
    if "wg" in p:
        return dense(F.silu(dense(x, p["wg"])) * dense(x, p["wu"]), p["wo"])
    return dense(F.gelu(dense(x, p["wi"]), approximate="tanh"), p["wo"])


# ---------------------------------------------------------------------------
# decoder layer (dense / moe / vlm / ssm / hybrid)
# ---------------------------------------------------------------------------


def layer_init(generator: torch.Generator, cfg: ModelConfig, dtype,
               device=None):
    p = {"ln1": norm_init(cfg, cfg.d_model, device)}
    if cfg.family == "ssm":
        p["ssm"] = ssm_init(generator, cfg, dtype, device)
        return p
    p["attn"] = attn_init(generator, cfg, dtype, device)
    if cfg.hybrid:
        p["ssm"] = ssm_init(generator, cfg, dtype, device)
        p["attn_branch_norm"] = torch.ones((cfg.d_model,),
                                           dtype=torch.float32, device=device)
        p["ssm_branch_norm"] = torch.ones((cfg.d_model,),
                                          dtype=torch.float32, device=device)
    p["ln2"] = norm_init(cfg, cfg.d_model, device)
    if cfg.num_experts:
        p["moe"] = moe_init(generator, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(generator, cfg, dtype, device)
    return p


def _branch_rms(scale, x):
    """hymba's per-branch RMSNorm (eps 1e-6) in f32; returns x's dtype."""
    xf = x.float()
    ms = torch.square(xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale).to(x.dtype)


def _hybrid_mix(p, a, s):
    return 0.5 * (_branch_rms(p["attn_branch_norm"], a)
                  + _branch_rms(p["ssm_branch_norm"], s))


def layer_forward(p, x, positions, cfg: ModelConfig, dp_groups: int = 1):
    """Full-sequence decoder layer. Returns (x, (k, v) or None, SSM state
    {"h", "conv"} or None, the MoE layer's load-balance loss or None
    without experts (the reference's 0))."""
    h = norm_apply(cfg, p["ln1"], x)
    if cfg.family == "ssm":
        y, ssm_state = ssm_apply(p["ssm"], h, cfg)
        return x + y, None, ssm_state, None
    a, kv = attn_forward(p["attn"], h, positions, cfg, causal=True)
    ssm_state = None
    if cfg.hybrid:
        s, ssm_state = ssm_apply(p["ssm"], h, cfg)
        a = _hybrid_mix(p, a, s)
    x = x + a
    h2 = norm_apply(cfg, p["ln2"], x)
    if cfg.num_experts:
        y, aux = moe_apply(p["moe"], h2, cfg, dp_groups)
        return x + y, kv, ssm_state, aux
    return x + mlp_apply(p["mlp"], h2, cfg), kv, ssm_state, None


def layer_decode(p, x_t, layer_cache, slot_pos, pos, cfg: ModelConfig,
                 positions=None):
    """One-token decoder layer. x_t: (B, D); layer_cache holds this layer's
    "k", "v" (attention) and "h", "conv" (SSM) views of the cache, updated
    in place; ``positions`` the M-RoPE rows (:func:`attn_decode`). The MoE
    sees the B tokens as (B, 1, D), as the reference's does. Returns
    x_t."""
    h = norm_apply(cfg, p["ln1"], x_t)
    if cfg.family == "ssm":
        return x_t + ssm_decode_step(p["ssm"], h, layer_cache, cfg)
    a, _ = attn_decode(p["attn"], h, layer_cache, slot_pos, pos, cfg,
                       positions)
    if cfg.hybrid:
        a = _hybrid_mix(p, a, ssm_decode_step(p["ssm"], h, layer_cache, cfg))
    x_t = x_t + a
    h2 = norm_apply(cfg, p["ln2"], x_t)
    if cfg.num_experts:
        return x_t + moe_apply(p["moe"], h2[:, None, :], cfg)[0][:, 0]
    return x_t + mlp_apply(p["mlp"], h2, cfg)


# ---------------------------------------------------------------------------
# whisper encoder / decoder layers
# ---------------------------------------------------------------------------


def enc_layer_init(generator: torch.Generator, cfg: ModelConfig, dtype,
                   device=None):
    return {"ln1": norm_init(cfg, cfg.d_model, device),
            "attn": attn_init(generator, cfg, dtype, device),
            "ln2": norm_init(cfg, cfg.d_model, device),
            "mlp": mlp_init(generator, cfg, dtype, device)}


def enc_layer_forward(p, x, positions, cfg: ModelConfig):
    """Encoder layer: non-causal self attention over the frames, the MLP."""
    h = norm_apply(cfg, p["ln1"], x)
    x = x + attn_forward(p["attn"], h, positions, cfg, causal=False)[0]
    return x + mlp_apply(p["mlp"], norm_apply(cfg, p["ln2"], x), cfg)


def dec_layer_init(generator: torch.Generator, cfg: ModelConfig, dtype,
                   device=None):
    return {"ln1": norm_init(cfg, cfg.d_model, device),
            "attn": attn_init(generator, cfg, dtype, device),
            "ln_x": norm_init(cfg, cfg.d_model, device),
            "xattn": attn_init(generator, cfg, dtype, device, cross=True),
            "ln2": norm_init(cfg, cfg.d_model, device),
            "mlp": mlp_init(generator, cfg, dtype, device)}


def dec_layer_forward(p, x, enc_out, positions, cfg: ModelConfig):
    """Decoder layer over a token sequence: causal self attention, cross
    attention to ``enc_out``, the MLP. Returns (x, (k, v)) with the self
    attention's k, v (B, S, KV, hd)."""
    a, kv = attn_forward(p["attn"], norm_apply(cfg, p["ln1"], x), positions,
                         cfg, causal=True)
    x = x + a
    x = x + cross_attn_forward(p["xattn"], norm_apply(cfg, p["ln_x"], x),
                               enc_out, cfg)
    return x + mlp_apply(p["mlp"], norm_apply(cfg, p["ln2"], x), cfg), kv


def dec_layer_decode(p, x_t, enc_out, layer_cache, slot_pos, pos,
                     cfg: ModelConfig):
    """One-token decoder layer: self attention through the cache (updated
    in place, :func:`attn_decode`), cross attention to ``enc_out``, the
    MLP. x_t: (B, D). Returns x_t."""
    a, _ = attn_decode(p["attn"], norm_apply(cfg, p["ln1"], x_t),
                       layer_cache, slot_pos, pos, cfg)
    x_t = x_t + a
    hx = norm_apply(cfg, p["ln_x"], x_t)
    x_t = x_t + cross_attn_forward(p["xattn"], hx[:, None, :], enc_out,
                                   cfg)[:, 0]
    return x_t + mlp_apply(p["mlp"], norm_apply(cfg, p["ln2"], x_t), cfg)
