"""Attention of the LM layers (counterpart of ``repro/models/attention.py``).

The reference computes prefill attention with a pure-jnp pair-scan flash
formulation and decode attention with a masked softmax; its Pallas kernels
B4 and B5 compute the same two functions for the TPU. Here both go through
:mod:`repro_torch.kernels.ops`: on a CUDA tensor the hand-written kernels
B4 (``flash_attention``) and B5 (``decode_attention``) run, on a CPU tensor
their plain versions. Layouts are the reference's: q (B, S, H, hd) and
k, v (B, S, KV, hd) for prefill; q (B, H, hd) and a (B, W, KV, hd) cache
for decode.

Not ported yet: logit soft-capping (no config sets it, and neither Pallas
kernel has it) and ``sharded_decode_attention`` (ROADMAP A11).
"""
from __future__ import annotations

from repro_torch.kernels import ops, ref


def _no_softcap(logit_softcap: float) -> None:
    if logit_softcap:
        raise NotImplementedError(
            "logit soft-capping is not ported: no config sets it and neither "
            "attention kernel (B4, B5) implements it")


def naive_attention(q, k, v, *, causal=True, window=None, logit_softcap=0.0):
    """Reference O(S^2)-memory attention in plain PyTorch, f32 math (B4's
    plain version, on any device). q: (B, S, H, hd); k, v: (B, S, KV, hd)
    -> (B, S, H, hd) in q's dtype."""
    _no_softcap(logit_softcap)
    return ref.flash_attention_torch(q, k, v, causal=causal, window=window)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    logit_softcap: float = 0.0):
    """Full-sequence (prefill) attention through B4. q: (B, S, H, hd);
    k, v: (B, S, KV, hd), H a multiple of KV, any S."""
    _no_softcap(logit_softcap)
    if k.shape[1] != q.shape[1]:
        raise NotImplementedError(
            "attention over a key sequence of another length (whisper's "
            "cross attention) waits for the audio part of ROADMAP A11")
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, cache_positions, pos, *,
                     logit_softcap: float = 0.0, window=None):
    """Single-token attention against a (possibly rolling) KV cache, through
    B5. q: (B, H, hd); k_cache, v_cache: (B, W, KV, hd); cache_positions:
    (B, W) int32, the absolute position in each slot (-1 = empty); pos:
    (B,) int32, the query token's absolute position."""
    _no_softcap(logit_softcap)
    return ops.decode_attention(q, k_cache, v_cache, cache_positions, pos,
                                window=window)
