"""Public wrappers of the port's kernels, dispatching by device.

A CUDA tensor launches the hand-written kernel
(:mod:`repro_torch.kernels.policy_score` for B1-B3,
:mod:`~repro_torch.kernels.flash_attention` for B4,
:mod:`~repro_torch.kernels.flash_attention_bwd` for its backward B4b,
:mod:`~repro_torch.kernels.decode_attention` for B5,
:mod:`~repro_torch.kernels.mamba_scan` for B6, bare and gated, and B6b);
if the build or the launch fails, the call raises. A CPU tensor runs the
plain PyTorch version (:mod:`repro_torch.kernels.ref`). Nothing falls back
from one to the other. B4-B6b (B4b among them) are ``torch.library`` ops
(``torch.ops.repro_torch.*``), so the dispatcher chooses by the tensors'
device, and a fake tensor runs the op's fake implementation: the LM's
steps trace under ``FakeTensorMode`` (:mod:`repro_torch.launch.dryrun`)
with neither a launch nor a build. B1-B3 choose by :func:`_device_type`.
The policy-head wrappers accept any leading batch shape, as the
reference's ``ops`` do; the attention and scan wrappers take the reference
kernels' layouts.

:func:`policy_score` is differentiable through :class:`PolicyScore`, the
counterpart of the reference's ``custom_vjp``: B1 forward and B2 backward
on the card, their plain versions on the CPU. :func:`flash_attention` is
differentiable through :class:`FlashAttention`: B4 forward with its
log-sum-exp and B4b backward on the card, their plain versions (the
backward the reference's pair-scan) on the CPU. :func:`mamba_scan_gated`
is differentiable through :class:`MambaScanGated`: B6's gated entry
saving its chunk states, and B6b, on the card; their plain versions on the
CPU. B5 and B6's bare entry have no backward: on a CUDA tensor that needs
a gradient they raise, rather than return an output cut off from
autograd.

**DTensors.** On a mesh (:mod:`repro_torch.launch.steps`) the attention
and scan wrappers take DTensors and run the kernel, or its plain version,
on each rank's local blocks through ``local_map``. Each declares the
placements it takes: the batch over any mesh axis; for B4 and B5 the
heads over an axis whose size divides both H and KV (q's query heads and
the caches' KV heads split alike, so a rank's query heads read only its
own KV heads); for B6 d_inner (the scan's channels). An input on other
placements (heads split inside a head, a sequence or a cache's slot axis
split, a partial sum) is redistributed to placements the kernel takes
first: never a silent gather, each such redistribution counted under the
kernel's name in :data:`repro_torch.sharding.ctx.REDISTRIBUTES`. The
autograd Functions run on the local blocks; ``local_map``'s
``to_local``/``from_local`` carry the gradients across.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import decode_attention as _b5
from repro_torch.kernels import flash_attention as _b4
from repro_torch.kernels import flash_attention_bwd as _b4b
from repro_torch.kernels import mamba_scan as _b6
from repro_torch.kernels import ref
from repro_torch.kernels.policy_score import (policy_score_bwd_cuda,
                                              policy_score_cuda,
                                              policy_score_decode_cuda)
from repro_torch.sharding.ctx import REDISTRIBUTES


def _flatten(c_emb, h_emb, edge_mask):
    batch_shape = c_emb.shape[:-2]
    q, d = c_emb.shape[-2:]
    z = h_emb.shape[-2]
    maskf = edge_mask.expand(*batch_shape, q).reshape(-1, q)
    return (batch_shape, c_emb.reshape(-1, q, d), h_emb.reshape(-1, z, d),
            maskf.to(torch.float32).contiguous())


def _device_type(c_emb) -> str:
    kind = c_emb.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no kernel implementation for device {kind!r}")
    return kind


class PolicyScore(torch.autograd.Function):
    """The eq 16-17 head on flattened inputs (c (B, Q, d), h (B, Z, d),
    maskf (B, Q) float) with the reference's residuals
    (``repro/kernels/policy_score.py:132``): the backward recomputes ``u``
    from them rather than saving it. Gradients flow to c, h, w_px and w_py;
    the mask and the clip get none."""

    @staticmethod
    def forward(ctx, c, h, w_px, w_py, maskf, tanh_clip):
        if _device_type(c) == "cuda":
            out = policy_score_cuda(c, h, w_px, w_py, maskf,
                                    tanh_clip=tanh_clip)
        else:
            out = ref.policy_score_torch(c, h, w_px, w_py, maskf > 0.5,
                                         tanh_clip)
        ctx.save_for_backward(c, h, w_px, w_py, maskf, out)
        ctx.tanh_clip = tanh_clip
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        c, h, w_px, w_py, maskf, out = ctx.saved_tensors
        fn = (policy_score_bwd_cuda if _device_type(c) == "cuda"
              else ref.policy_score_bwd_torch)
        grads = fn(g.contiguous(), out, c, h, w_px, w_py, maskf,
                   tanh_clip=ctx.tanh_clip)
        return (*grads, None, None)


def policy_score(c_emb, h_emb, w_px, w_py, edge_mask, *, tanh_clip=10.0):
    """Eq 16-17 head: (..., Z, Q) log a_qz, differentiable wrt the
    embeddings and both projections (:class:`PolicyScore`)."""
    batch_shape, c3, h3, maskf = _flatten(c_emb, h_emb, edge_mask)
    out = PolicyScore.apply(c3, h3, w_px, w_py, maskf, float(tanh_clip))
    return out.reshape(*batch_shape, *out.shape[-2:])


def policy_score_decode(c_emb, h_emb, w_px, w_py, edge_mask, *,
                        tanh_clip=10.0, k=1, normalize=True):
    """Fused score + greedy/top-k decode: (top_idx, top_val), (..., Z, K).
    On the card the (Z, Q) scores are never written to device memory."""
    if _device_type(c_emb) == "cpu":
        return ref.policy_score_decode_torch(c_emb, h_emb, w_px, w_py,
                                             edge_mask, tanh_clip, k,
                                             normalize)
    batch_shape, c3, h3, maskf = _flatten(c_emb, h_emb, edge_mask)
    ti, tv = policy_score_decode_cuda(c3, h3, w_px, w_py, maskf,
                                      tanh_clip=tanh_clip, k=k,
                                      normalize=normalize)
    return (ti.reshape(*batch_shape, *ti.shape[-2:]),
            tv.reshape(*batch_shape, *tv.shape[-2:]))


class FlashAttention(torch.autograd.Function):
    """B4 with the reference's flash backward (``_flash`` and its
    ``custom_vjp``, ``repro/models/attention.py:89-233``). The forward is
    the op ``flash_attention`` (B4 on a CUDA tensor, its plain version on
    a CPU tensor); when a gradient is wanted (``train``) it is
    ``flash_attention_lse``, which also gives the rows' log-sum-exp, and
    it saves (q, k, v, out, lse), otherwise it saves nothing and B4 stores
    no lse, as serving needs. The backward is the op
    ``flash_attention_bwd``: B4b on a CUDA tensor (a failed build or
    launch raises), on a CPU tensor its plain version, the pair-scan over
    ``chunk``-sized blocks
    (:func:`repro_torch.kernels.ref.flash_attention_bwd_torch`, which the
    model knows as :func:`repro_torch.models.attention.flash_bwd`).
    The reference's backward is pure jnp, with no Pallas kernel behind it.
    A ``softcap`` above 0 caps the scores in both (saved for the
    backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, train, softcap):
        if not train:
            return _b4.flash_attention_op(q, k, v, causal, window, softcap)
        out, lse = _b4.flash_attention_lse_op(q, k, v, causal, window,
                                              softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.chunk = causal, window, chunk
        ctx.softcap = softcap
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _b4b.flash_attention_bwd_op(
            q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.window,
            ctx.softcap, ctx.chunk)
        return dq, dk, dv, None, None, None, None, None


class MambaScanGated(torch.autograd.Function):
    """B6's gated entry with its backward B6b. The forward is the op
    ``mamba_scan_gated`` (B6 on a CUDA tensor, its plain version on a CPU
    tensor); when a gradient is wanted (``train``) it is
    ``mamba_scan_gated_states``, which also gives the state entering each
    chunk of B6's walk, and it saves the inputs and those states;
    otherwise it saves nothing and B6 stores no states, as serving needs.
    The backward takes the gradients of ``out`` and ``h_last`` (either may
    be unused) and is the op ``mamba_scan_gated_bwd``: B6b on the card,
    :func:`ref.mamba_scan_gated_bwd_torch` (which recomputes the states)
    on the CPU. The reference's gradient is ``jax.grad`` of its jnp
    chunked scan and tail (``repro/models/ssm.py:59-120``): it has no
    Pallas kernel behind it. ``bf16_state`` carries the state in bf16 in
    both (saved for the backward)."""

    @staticmethod
    def forward(ctx, u, dt_raw, dt_bias, B_mat, C_mat, A, D, z, train,
                bf16_state):
        args = (u, dt_raw, dt_bias, B_mat, C_mat, A, D, z)
        if train:
            out, h_last, states = _b6.mamba_scan_gated_states_op(*args,
                                                                 bf16_state)
            ctx.save_for_backward(*args, states)
        else:
            out, h_last = _b6.mamba_scan_gated_op(*args, bf16_state)
        ctx.bf16_state = bf16_state
        ctx.set_materialize_grads(False)
        return out, h_last

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, dh_last):
        *args, states = ctx.saved_tensors
        z = args[-1]
        if dout is None:
            dout = torch.zeros(z.shape, dtype=z.dtype, device=z.device)
        grads = _b6.mamba_scan_gated_bwd_op(*args, states, dout.contiguous(),
                                            dh_last, ctx.bf16_state)
        return (*grads, None, None)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


_MISSING_BACKWARD = {
    "B5": "B5 (decode_attention) has no backward on the card; one-token "
          "decode is inference only",
    "B6": "B6's bare entry (mamba_scan) has no backward on the card; the SSM "
          "block trains through the gated entry, ops.mamba_scan_gated, whose "
          "backward is B6b",
}


def missing_backward(kernel: str) -> RuntimeError:
    """The error for a gradient through ``kernel`` ("B5", or "B6" for B6's
    bare entry) on the card."""
    return RuntimeError(
        f"{_MISSING_BACKWARD[kernel]}. A gradient is wanted: train on the CPU "
        "(device='cpu'), where the plain version is differentiable, or call "
        "under torch.no_grad()")


def _no_card_backward(kernel: str, x) -> None:
    """Raise for a CUDA input (``x``'s device) where a gradient is wanted:
    the kernel has no backward, and its output would be cut off from
    autograd."""
    if _device_type(x) == "cuda":
        raise missing_backward(kernel)


# -- DTensor inputs: the kernels on each rank's local blocks ------------------


def mesh_roles(x: DTensor, dims: dict, ok=lambda role, n: True) -> tuple:
    """For each mesh axis of ``x``: the role ("batch", "heads", ...) whose
    tensor dimension in ``dims`` that axis splits, if ``ok(role, axis
    size)``; None where it splits nothing a kernel can take (it is then
    replicated)."""
    mesh = x.device_mesh
    roles = []
    for i, p in enumerate(x.placements):
        role = None
        if isinstance(p, Shard):
            for r, d in dims.items():
                if p.dim == d and ok(r, mesh.size(i)):
                    role = r
        roles.append(role)
    return tuple(roles)


def role_placements(roles: tuple, dims: dict) -> tuple:
    """The placements of a tensor whose roles sit at ``dims``: each mesh
    axis splits its role's dimension, or nothing."""
    return tuple(Shard(dims[r]) if r in dims else Replicate()
                 for r in roles)


def to_placements(x, mesh, want: tuple, site: str) -> DTensor:
    """``x`` on ``want``: a DTensor redistributed (counted under ``site``
    when that moves anything), a plain tensor taken as replicated (every
    rank holds the same one) and cut to its block."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == want:
        return x
    REDISTRIBUTES[site] += 1
    return x.redistribute(mesh, want)


def run_on_blocks(site: str, fn, mesh, roles: tuple, args, outs):
    """``fn`` on each rank's local blocks: ``args`` is a list of (value,
    dims) with dims None for a non-tensor, each tensor first brought to the
    placements of ``roles`` at its dims; ``outs`` the dims of each output
    (a dict for one output, a tuple of dicts for several)."""
    ins, in_pl, grad_pl = [], [], []
    for x, dims in args:
        if dims is None:
            ins.append(x)
            in_pl.append(None)
            grad_pl.append(None)
        else:
            want = role_placements(roles, dims)
            ins.append(to_placements(x, mesh, want, site))
            in_pl.append(list(want))
            # an input whole on an axis that splits the work (A beside a
            # batch block, B_mat beside a block of channels) gets a part
            # of its gradient on each rank: their sum
            grad_pl.append([Partial() if r is not None and r not in dims
                            else p for r, p in zip(roles, want)])
    # local_map reads a list as one output's placements, a tuple as many
    out_pl = (list(role_placements(roles, outs)) if isinstance(outs, dict)
              else tuple(list(role_placements(roles, d)) for d in outs))
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*ins)


def _heads_ok(h: int, kv: int):
    return lambda role, n: role != "heads" or (h % n == 0 and kv % n == 0)


def flash_attention(q, k, v, *, causal=True, window=None, chunk=512,
                    softcap=0.0):
    """B4: GQA flash attention, q (B, Sq, H, hd), k, v (B, Sk, KV, hd) ->
    (B, Sq, H, hd) in q's dtype, any Sq and Sk, the scaled scores capped
    at ``softcap * tanh(s / softcap)`` where ``softcap`` is above 0;
    differentiable through :class:`FlashAttention`, whose backward is B4b
    on the card and the pair-scan over ``chunk``-sized blocks on the CPU.
    DTensors: the batch and the heads may be split (the module's
    docstring)."""
    train = _wants_grad(q, k, v)

    def run(q, k, v):
        return FlashAttention.apply(q, k, v, bool(causal), window, int(chunk),
                                    train, float(softcap))

    if not isinstance(q, DTensor):
        return run(q, k, v)
    dims = {"batch": 0, "heads": 2}
    roles = mesh_roles(q, dims, _heads_ok(q.shape[2], k.shape[2]))
    return run_on_blocks("B4", run, q.device_mesh, roles,
                         [(q, dims), (k, dims), (v, dims)], dims)


def _decode_local(q, k_cache, v_cache, slot_pos, pos, window, with_lse,
                  softcap=0.0):
    args = (q, k_cache, v_cache, slot_pos, pos, window, float(softcap))
    if _wants_grad(q, k_cache, v_cache):
        _no_card_backward("B5", q)
        # on the CPU, the plain version: differentiable by autograd
        o = ref.decode_attention_torch(q, k_cache, v_cache, slot_pos, pos,
                                       window=window, softcap=softcap)
        if not with_lse:
            return o
        return o, ref.decode_attention_lse_torch(q, k_cache, slot_pos, pos,
                                                 window=window,
                                                 softcap=softcap)
    if with_lse:
        return _b5.decode_attention_lse_op(*args)
    return _b5.decode_attention_op(*args)


#: where B5's inputs keep their roles: q (B, H, hd), the caches (B, W, KV,
#: hd), slot_pos (B, W), pos (B,); the output as q, the lse (B, H)
_B5_Q = {"batch": 0, "heads": 1}
_B5_CACHE = {"batch": 0, "heads": 2, "slots": 1}
_B5_SLOTS = {"batch": 0, "slots": 1}
_B5_POS = {"batch": 0}


def decode_attention(q, k_cache, v_cache, slot_pos, pos, *, window=None,
                     with_lse=False, softcap=0.0):
    """B5: one query token per sequence, q (B, H, hd), over a rolling cache
    (B, W, KV, hd) with slot positions (B, W) and query positions (B,),
    the scaled scores capped where ``softcap`` is above 0; with
    ``with_lse`` also each (lane, head)'s log-sum-exp of its masked scores
    (B, H) f32. DTensors: the batch and the heads may be split; a cache
    split on its slot axis is brought whole to each rank first (counted),
    as B5 reads all of a lane's slots."""
    if not isinstance(q, DTensor):
        return _decode_local(q, k_cache, v_cache, slot_pos, pos, window,
                             with_lse, softcap)
    roles = mesh_roles(q, _B5_Q, _heads_ok(q.shape[1], k_cache.shape[2]))
    outs = (_B5_Q, {"batch": 0, "heads": 1}) if with_lse else _B5_Q
    return run_on_blocks(
        "B5", lambda *a: _decode_local(*a, window, with_lse, softcap),
        q.device_mesh,
        roles, [(q, _B5_Q), (k_cache, _B5_CACHE), (v_cache, _B5_CACHE),
                (slot_pos, _B5_SLOTS), (pos, _B5_POS)], outs)


def mamba_scan(u, dt, B_mat, C_mat, A, bf16_state=False):
    """B6: the mamba-1 selective scan from a zero state, u, dt (B, S, d),
    B_mat, C_mat (B, S, N), A (d, N), f32 -> (y (B, S, d), h_last
    (B, d, N)), any S; ``bf16_state`` carries the state in bf16. Off the
    training path: on the card it has no backward (the SSM block trains
    through :func:`mamba_scan_gated`); on the CPU a gradient goes through
    the plain version."""
    if _wants_grad(u, dt, B_mat, C_mat, A):
        _no_card_backward("B6", u)
        return ref.mamba_scan_torch(u, dt, B_mat, C_mat, A,
                                    bf16_state=bf16_state)
    return _b6.mamba_scan_op(u, dt, B_mat, C_mat, A, bool(bf16_state))


def mamba_scan_gated(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z,
                     bf16_state=False):
    """B6's gated entry, the SSM block's tail: dt = softplus(dt_raw +
    dt_bias), the scan from a zero state, then (y + D*u) * silu(z) in z's
    dtype. u, dt_raw (B, S, d), B_mat, C_mat (B, S, N), A (d, N), dt_bias,
    D (d,) f32; z (B, S, d) bf16 or f32 with a unit last stride ->
    (out (B, S, d), h_last (B, d, N) f32), differentiable with respect to
    all eight inputs through :class:`MambaScanGated`; ``bf16_state``
    carries the scan's state in bf16. DTensors: the batch and d_inner may
    be split (d_inner where u splits it)."""
    train = _wants_grad(u, dt_raw, dt_bias, B_mat, C_mat, A, D, z)

    def run(*args):
        return MambaScanGated.apply(*args, train, bool(bf16_state))

    args = (u, dt_raw, dt_bias, B_mat, C_mat, A, D, z)
    if not isinstance(u, DTensor):
        return run(*args)
    seq = {"batch": 0, "inner": 2}
    chan = {"inner": 0}
    bc = {"batch": 0}
    roles = mesh_roles(u, seq)
    return run_on_blocks(
        "B6", run, u.device_mesh, roles,
        list(zip(args, (seq, seq, chan, bc, bc, chan, chan, seq))),
        (seq, {"batch": 0, "inner": 1}))


__all__ = ["PolicyScore", "FlashAttention", "MambaScanGated",
           "missing_backward",
           "policy_score", "policy_score_decode", "flash_attention",
           "decode_attention", "mamba_scan", "mamba_scan_gated", "ref"]
