"""Mixtral-style MoE layer: top-k routing with grouped capacity dispatch
(counterpart of ``repro/models/moe.py``).

Tokens are dispatched into a dense (experts, groups x capacity, d_model)
buffer and the expert FFN is one batched matmul per weight. The reference
computes all of it in jnp with no Pallas kernel; here it is plain PyTorch
(``torch.bmm``), on the card and on the CPU alike.

What decides the result is kept as the reference has it:

* routing in f32 (``x.float() @ router``); the top k in ``jax.lax.top_k``'s
  order (values descending, the lower expert first on a tie), taken as k
  rounds of ``argmax`` (which returns the first maximal index) with each
  chosen entry masked out for the next round; ``torch.topk`` promises
  neither the order nor the tie rule;
* an entry's slot within its expert is the exclusive cumsum of the one-hot
  over the (N, k) entries in row-major order, so the same entries are
  dropped past the capacity;
* the dispatch writes each kept entry to its distinct (expert, slot) row
  with a plain indexed store, and every dropped entry to one scratch row
  past the grid, which is then sliced off: no scatter-add (float atomics,
  ROADMAP C7) and no duplicate index that could race with a kept row. In
  training the store's backward is a gather, the k copies of a token are
  an ``expand`` (its backward a sum), and the combine's gather backward
  is PyTorch's sorted index-add, which runs duplicates in a fixed order on
  the card: a rerun gives the same bits;
* nothing reads a value back to the host: every shape depends on the token
  count alone.

``dp_groups`` splits the tokens into groups, each with its own capacity, as
the reference's vmap over groups does; here the groups share one buffer per
expert (group g's slots at ``g * cap``), so one ``bmm`` serves them all.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.nn.module import normal_init


def moe_init(generator: torch.Generator, cfg: ModelConfig, dtype,
             device=None) -> dict:
    """The reference's leaves: ``router`` (d, E) in f32; ``wg``, ``wu``
    (E, d, f) and ``wo`` (E, f, d) in ``dtype``; all normal, std 0.02."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def w(shape, dt):
        return normal_init(generator, shape, 0.02, dt, device)

    return {"router": w((d, e), torch.float32), "wg": w((e, d, f), dtype),
            "wu": w((e, d, f), dtype), "wo": w((e, f, d), dtype)}


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``N k / E`` times the capacity factor, rounded up
    to a multiple of 8, at least 8."""
    c = int(n_tokens * cfg.experts_per_token / cfg.num_experts
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched over the leading axis, in a's dtype. On the CPU a
    bf16 product is formed in f32 and rounded once, as
    ``models.common.dense`` does (ROADMAP C9); on the card it stays a bf16
    GEMM."""
    if a.device.type == "cpu" and a.dtype == torch.bfloat16:
        return torch.bmm(a.float(), b.float()).to(a.dtype)
    return torch.bmm(a, b)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, with an f32 result (the reference's
    ``preferred_element_type``). On the card a bf16 product is one bf16
    GEMM writing f32, with no f32 copy of either operand; on the CPU it is
    formed on f32 copies (ROADMAP C9)."""
    if a.device.type == "cpu" or a.dtype == torch.float32:
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


def top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis in
    ``jax.lax.top_k``'s order: descending, the lower index first on a
    tie."""
    masked = logits
    vals, idx = [], []
    for _ in range(k):
        i = masked.argmax(-1, keepdim=True)
        idx.append(i)
        vals.append(logits.gather(-1, i))
        masked = masked.scatter(-1, i, -math.inf)
    return torch.cat(vals, -1), torch.cat(idx, -1)


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """Router logits (..., E) in f32, the chosen experts (..., k) and their
    gates, the softmax over the chosen logits."""
    logits = x.float() @ router
    vals, idx = top_k(logits, k)
    return logits, idx, torch.softmax(vals, -1)


def _aux(logits, idx, e: int, k: int, dims) -> torch.Tensor:
    """Switch-style load-balance loss ``E sum_e f_e / k * P_e``, the means
    over the token axes ``dims``."""
    f_e = F.one_hot(idx, e).float().sum(-2).mean(dims)
    p_e = torch.softmax(logits, -1).mean(dims)
    return e * (f_e / k * p_e).sum(-1)


def slots(idx: torch.Tensor, e: int, cap: int):
    """Each entry's rank within its expert and whether it is kept, for the
    chosen experts idx (G, N, k) of G groups: the exclusive cumsum of the
    one-hot over each group's (N, k) entries in row-major order, kept
    below ``cap``. Returns (pos, keep), both (G, N * k)."""
    flat_e = idx.reshape(idx.shape[0], -1)
    onehot = F.one_hot(flat_e, e)
    rank = onehot.cumsum(1) - onehot
    pos = rank.gather(-1, flat_e[..., None])[..., 0]
    return pos, pos < cap


def _rows(idx, pos, cap: int):
    """Each entry's row in the (E * G * cap) buffer: expert-major, group
    g's slots at ``g * cap``. idx (G, N, k), pos (G, N * k)."""
    g = idx.shape[0]
    group = torch.arange(g, device=idx.device)[:, None]
    return (idx.reshape(g, -1) * g + group) * cap + torch.clamp(pos,
                                                                max=cap - 1)


def _dispatch(x, idx, e: int, cap: int):
    """The capacity dispatch of G groups: (buf (E, G * cap, D), pos, keep)
    for x (G, N, D) and its chosen experts idx (G, N, k)."""
    g, n, d = x.shape
    k = idx.shape[-1]
    pos, keep = slots(idx, e, cap)
    row = _rows(idx, pos, cap)
    # (E, G * cap) rows and one scratch row past them for dropped entries
    buf = x.new_zeros(e * g * cap + 1, d)
    buf[torch.where(keep, row, e * g * cap).reshape(-1)] = (
        x[:, :, None].expand(g, n, k, d).reshape(g * n * k, d))
    return buf[:-1].view(e, g * cap, d), pos, keep


def _combine(out, idx, pos, keep, gates, cap: int):
    """Each token's gate-weighted sum of its kept entries' rows of the
    experts' output ``out`` (E, G * cap, D): (G, N, D)."""
    g, n, k = idx.shape
    d = out.shape[-1]
    w = keep.to(out.dtype) * gates.reshape(g, n * k).to(out.dtype)
    rows = out.reshape(-1, d)[_rows(idx, pos, cap)]
    return (rows * w[..., None]).view(g, n, k, d).sum(2)


#: where the dispatch's tensors keep their groups: x, idx, gates, pos and
#: keep on their first axis, the buffer on its second
_GROUPS, _BUF = {"groups": 0}, {"groups": 1}


def _dispatch_ffn(x: torch.Tensor, p, cfg: ModelConfig):
    """Capacity dispatch + expert FFN + combine of G groups at once, each
    group dispatched alone. x: (G, N, D) -> (y (G, N, D), aux (G,)).

    On a mesh (DTensors) the dispatch and the combine run on each rank's
    groups (``ops.run_on_blocks``, counted under "moe" where the groups
    must first be brought to the axes that split them): both work group
    by group, and the indexed store has no DTensor sharding rule on every
    release."""
    g, n, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = _capacity(n, cfg)

    logits, idx, gates = route(x, p["router"], k)
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        roles = ops.mesh_roles(x, _GROUPS)
        buf, pos, keep = ops.run_on_blocks(
            "moe", lambda *a: _dispatch(*a, e, cap), mesh, roles,
            [(x, _GROUPS), (idx, _GROUPS)], (_BUF, _GROUPS, _GROUPS))
    else:
        buf, pos, keep = _dispatch(x, idx, e, cap)
    h = F.silu(_bmm(buf, p["wg"])) * _bmm(buf, p["wu"])
    out = _bmm(h, p["wo"])
    if isinstance(out, DTensor):
        y = ops.run_on_blocks(
            "moe", lambda *a: _combine(*a, cap), mesh, roles,
            [(out, _BUF), (idx, _GROUPS), (pos, _GROUPS), (keep, _GROUPS),
             (gates, _GROUPS)], _GROUPS)
    else:
        y = _combine(out, idx, pos, keep, gates, cap)
    return y, _aux(logits, idx, e, k, 1)


def _dense_moe(x: torch.Tensor, p, cfg: ModelConfig):
    """Small-token path (``cfg.moe_dense_decode``): every expert on every
    token, combined by gate weight; no capacity, nothing dropped. x: (B, S,
    D) -> (y (B, S, D) in x's dtype, aux). As the reference, h is cast to
    x's dtype and the output product has an f32 result (its
    ``preferred_element_type``, :func:`_bmm_f32`)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    logits, idx, gates = route(x, p["router"], k)
    combine = (F.one_hot(idx, e).float() * gates[..., None]).sum(-2)
    xt = x.reshape(1, b * s, d).expand(e, b * s, d)
    h = F.silu(_bmm(xt, p["wg"])) * _bmm(xt, p["wu"])  # (E, T, F)
    out = _bmm_f32(h, p["wo"])  # (E, T, D) f32
    y = torch.einsum("etd,te->td", out, combine.reshape(b * s, e))
    return y.reshape(b, s, d).to(x.dtype), _aux(logits, idx, e, k, (0, 1))


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, dp_groups: int = 1):
    """x: (B, S, D) -> (y, aux_loss). ``dp_groups`` groups of tokens are
    dispatched alone where it divides B*S; with ``cfg.moe_dense_decode``
    up to 256 tokens take the dense path."""
    b, s, d = x.shape
    tokens = b * s
    if cfg.moe_dense_decode and tokens <= 256:
        return _dense_moe(x, p, cfg)
    g = dp_groups if tokens % dp_groups == 0 else 1
    y, aux = _dispatch_ffn(x.reshape(g, tokens // g, d), p, cfg)
    return y.reshape(b, s, d), aux.mean()
