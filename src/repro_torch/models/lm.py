"""The LM: init, prefill and decode (counterpart of ``repro/models/lm.py``).

Public surface, as the reference's, on parameters held as nested dicts of
tensors with the reference's leaf names:

    init_params(cfg, generator=..., device=...) -> params
    train_loss(params, batch, cfg, dp_groups)  -> (loss, metrics)
    prefill(params, batch, cfg, max_seq=None, head=None, dp_groups=1)
                                               -> (cache, last_logits)
    decode_step(params, cache, batch, cfg, head=None)
                                               -> (cache, logits)
    init_cache(cfg, batch, max_seq, device)    -> cache

``params["layers"]`` (and whisper's ``params["enc_layers"]``) is a list
with one dict per layer where the reference stacks layers on a leading L
axis for ``lax.scan``; the layer loop is a Python loop. The cache keeps
the reference's layout, by family: ``pos`` (B,) int32 always; with
attention (dense, hybrid, whisper's decoder) ``slot_pos`` (B, W) int32 and
``layers/k``, ``layers/v`` (L, B, W, KV, hd); with an SSM (ssm, hybrid)
``layers/h`` (L, B, d_inner, N) and ``layers/conv`` (L, B, K-1, d_inner),
both f32; whisper adds ``enc_out`` (B, encoder_len, D), the encoder's
output. ``decode_step`` updates the cache in place and returns it.

The dense (olmo, qwen3, mistral-large, llama3), MoE (mixtral), VLM
backbone (qwen2-vl: embeddings in, (3, B, S) M-RoPE positions), SSM
(falcon-mamba), hybrid (hymba) and audio (whisper: frame embeddings into
the encoder, tokens into the decoder) families run here. ``dp_groups`` is
the MoE dispatch's token groups, as in the reference; a decode step
dispatches its B tokens as one group. ``train_loss`` runs every layer
under ``cfg.remat`` (``torch.utils.checkpoint``) and adds the MoE layers'
mean load-balance loss at 0.01; on the card attention trains through B4
and its backward B4b, and the SSM block through B6's gated entry
and its backward B6b (``ops.MambaScanGated``).
The optimizers and checkpoints name every leaf by its "/"-path
(``repro_torch.nn.named_leaves``), a layer's as ``layers/<i>/...`` or
``enc_layers/<i>/...``.

The logits are an f32 product, as in the reference (``_logits``, which
upcasts the head). For a bf16 model with a tied embedding that upcast is a
(d, V) f32 copy, 1.56 GB for qwen3-4b; a caller that runs many steps holds
one copy (:func:`head_f32`) and passes it as ``head``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.common import (norm_apply, norm_init,
                                       sinusoidal_positions, take_rows)
from repro_torch.models.ssm import ssm_state_shapes
from repro_torch.nn.module import normal_init
from repro_torch.sharding.ctx import constrain, redistribute


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


# "dots": keep the matrix products' outputs, recompute the rest (the
# counterpart of jax's dots_with_no_batch_dims_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``: "none" as it is; "dots" keeping only
    the matmul outputs for the backward; otherwise ("full") keeping only
    the inputs, the whole forward run again in the backward."""
    if cfg.remat == "none":
        return fn
    kwargs = {"use_reentrant": False}
    if cfg.remat == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: checkpoint(fn, *args, **kwargs)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None) -> dict:
    """Random weights at the reference's init (normal, std 0.02, drawn in
    f32 and cast to ``cfg.dtype``; norms at ones), drawn from ``generator``
    on ``device`` (the generator's device by default). Whisper's tree, as
    the reference's: ``enc_layers``, decoder ``layers`` with their cross
    attention, ``enc_norm`` and the learned decoder positions ``dec_pos``
    (32,768 x D, std 0.01)."""
    dtype = _dtype(cfg)
    device = generator.device if device is None else torch.device(device)
    params = {"embed": normal_init(generator, (cfg.padded_vocab, cfg.d_model),
                                   0.02, dtype, device)}
    if cfg.encoder_decoder:
        params["enc_layers"] = [L.enc_layer_init(generator, cfg, dtype,
                                                 device)
                                for _ in range(cfg.num_encoder_layers)]
        params["layers"] = [L.dec_layer_init(generator, cfg, dtype, device)
                            for _ in range(cfg.num_layers)]
        params["enc_norm"] = norm_init(cfg, cfg.d_model, device)
        params["dec_pos"] = normal_init(generator, (32_768, cfg.d_model),
                                        0.01, dtype, device)
    else:
        params["layers"] = [L.layer_init(generator, cfg, dtype, device)
                            for _ in range(cfg.num_layers)]
    params["final_norm"] = norm_init(cfg, cfg.d_model, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(generator,
                                        (cfg.d_model, cfg.padded_vocab), 0.02,
                                        dtype, device)
    return params


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _default_positions(cfg: ModelConfig, batch, b: int, s: int, device):
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)
    if cfg.mrope:
        pos = pos[None].expand(3, b, s)
    return pos


def _embed_in(params, cfg: ModelConfig, batch) -> torch.Tensor:
    if "embeds" in batch:
        x = batch["embeds"].to(_dtype(cfg))
    else:
        x = take_rows(params["embed"], batch["tokens"])
    return constrain(x, "residual")


def head_f32(params, cfg: ModelConfig) -> torch.Tensor:
    """The LM head (d, V_pad) in f32: the tied embedding's transpose or
    ``lm_head``. A copy unless the model is f32 already."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.float()


def _logits(params, cfg: ModelConfig, x, head=None) -> torch.Tensor:
    x = norm_apply(cfg, params["final_norm"], x)
    if head is None:
        head = head_f32(params, cfg)
    logits = x.float() @ head
    if cfg.padded_vocab != cfg.vocab_size:
        if isinstance(logits, DTensor):  # no in-place write across shards
            pad = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = torch.where(pad >= cfg.vocab_size, -1e9, logits)
        else:
            logits[..., cfg.vocab_size:] = -1e9
    return constrain(logits, "logits")


def _run_layers(params, cfg: ModelConfig, x, positions, dp_groups=1):
    """The decoder stack. Returns (x, {"k", "v"}: (L, B, S, KV, hd) or None
    without attention, {"h", "conv"}: (L, B, ...) or None without an SSM).
    The MoE layers' load-balance losses are dropped, as the reference's
    prefill drops them."""
    outs = {"k": [], "v": [], "h": [], "conv": []}
    for p_layer in params["layers"]:
        x, kv, ssm_state, _ = L.layer_forward(
            p_layer, constrain(x, "residual"), positions, cfg, dp_groups)
        x = constrain(x, "residual")
        if kv is not None:
            outs["k"].append(kv[0])
            outs["v"].append(kv[1])
        if ssm_state is not None:
            outs["h"].append(ssm_state["h"])
            outs["conv"].append(ssm_state["conv"])

    def stacked(keys):
        return ({key: torch.stack(outs[key]) for key in keys}
                if outs[keys[0]] else None)

    return x, stacked(("k", "v")), stacked(("h", "conv"))


def _train_layers(params, cfg: ModelConfig, x, positions, dp_groups=1):
    """The decoder stack for the loss, each layer under ``cfg.remat``.
    Returns (x, the mean of the MoE layers' load-balance losses, 0 without
    experts); the K/V and SSM states are not kept (the reference's scan
    outputs are dropped by XLA)."""
    def block(p_layer, h):
        y, _, _, aux = L.layer_forward(p_layer, constrain(h, "residual"),
                                       positions, cfg, dp_groups)
        return constrain(y, "residual"), aux

    body = _remat(block, cfg)
    auxs = []
    for p_layer in params["layers"]:
        x, aux = body(p_layer, x)
        auxs.append(aux)
    if auxs and auxs[0] is not None:
        return x, torch.stack(auxs).mean()
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _whisper_encode(params, cfg: ModelConfig, enc_embeds, train=False):
    """The encoder over frame embeddings (B, S_enc, D): the sinusoidal
    table in x's dtype added, the layers (each under ``cfg.remat`` when
    ``train``), ``enc_norm``."""
    x = enc_embeds.to(_dtype(cfg))
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(x.dtype)

    def block(p_layer, h):  # no RoPE: the attention takes no positions
        return L.enc_layer_forward(p_layer, h, None, cfg)

    body = _remat(block, cfg) if train else block
    for p_layer in params["enc_layers"]:
        x = body(p_layer, x)
    return norm_apply(cfg, params["enc_norm"], x)


def _whisper_decode_stack(params, cfg: ModelConfig, tokens, enc_out,
                          train=False):
    """The decoder over tokens (B, S) with learned positions ``dec_pos``
    and cross attention to ``enc_out``. Returns (x, {"k", "v"}: (L, B, S,
    KV, hd)); under ``train`` each layer runs under ``cfg.remat`` and the
    K/V are not kept (None)."""
    s = tokens.shape[1]
    x = take_rows(params["embed"], tokens) + params["dec_pos"][:s][None]
    if train:
        body = _remat(lambda p_layer, h: L.dec_layer_forward(
            p_layer, h, enc_out, None, cfg)[0], cfg)
        for p_layer in params["layers"]:
            x = body(p_layer, x)
        return x, None
    ks, vs = [], []
    for p_layer in params["layers"]:
        x, (k, v) = L.dec_layer_forward(p_layer, x, enc_out, None, cfg)
        ks.append(k)
        vs.append(v)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def train_loss(params, batch, cfg: ModelConfig, dp_groups: int = 1):
    """batch: tokens or embeds (+ positions) and labels (B, S), -100 =
    masked; whisper: frame embeddings ``embeds`` (B, S_enc, D), decoder
    ``tokens`` and ``labels`` (B, S). Returns (total, {"loss", "aux_loss",
    "tokens"}) with the reference's shard-friendly cross entropy: the max
    without gradient, the log-sum-exp of the shifted logits, the label's
    logit picked by comparison with an iota (labels < 0 read label 0 and
    are masked out), the mean over unmasked labels (at least 1); ``total``
    adds 0.01 times ``aux``, the MoE layers' mean load-balance loss (0
    without experts), whose dispatch runs in ``dp_groups`` token groups."""
    labels = batch["labels"]
    if cfg.encoder_decoder:
        enc_out = _whisper_encode(params, cfg, batch["embeds"], train=True)
        x, _ = _whisper_decode_stack(params, cfg, batch["tokens"], enc_out,
                                     train=True)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x = _embed_in(params, cfg, batch)
        b, s = x.shape[0], x.shape[1]
        positions = _default_positions(cfg, batch, b, s, x.device)
        x, aux = _train_layers(params, cfg, x, positions, dp_groups)
    logits = _logits(params, cfg, x)
    m = logits.max(-1, keepdim=True).values.detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(-1))
    vocab_iota = torch.arange(logits.shape[-1], device=x.device)
    safe_labels = torch.clamp(labels.long(), min=0)
    label_logit = torch.where(vocab_iota == safe_labels[..., None], shifted,
                              0.0).sum(-1)
    nll = lse - label_logit
    mask = (labels >= 0).float()
    tokens = mask.sum()
    loss = (nll * mask).sum() / torch.clamp(tokens, min=1.0)
    if isinstance(aux, DTensor):
        # a mean over the ranks' dispatch groups, pending (Partial "avg"):
        # reduced first, since some releases cannot add it to the loss's
        # pending sum
        aux = redistribute(aux, (), "aux_loss")
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": tokens}


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def cache_window(cfg: ModelConfig, max_seq: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_seq)
    return max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Zero cache for ``batch`` sequences with capacity ``max_seq``: K/V
    and slot positions where the family has attention, SSM states where it
    has an SSM, the encoder output where there is an encoder
    (``repro/models/lm.py:226-244``)."""
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    lcache = {}
    if cfg.family != "ssm":
        w = cache_window(cfg, max_seq)
        kvd = (cfg.num_layers, batch, w, cfg.num_kv_heads, cfg.head_dim)
        lcache["k"] = torch.zeros(kvd, dtype=_dtype(cfg), device=device)
        lcache["v"] = torch.zeros(kvd, dtype=_dtype(cfg), device=device)
        cache["slot_pos"] = torch.full((batch, w), -1, dtype=torch.int32,
                                       device=device)
    if cfg.family in ("ssm", "hybrid"):
        for key, shape in ssm_state_shapes(cfg, batch).items():
            lcache[key] = torch.zeros((cfg.num_layers, *shape),
                                      dtype=torch.float32, device=device)
    cache["layers"] = lcache
    if cfg.encoder_decoder:
        cache["enc_out"] = torch.zeros((batch, cfg.encoder_len, cfg.d_model),
                                       dtype=_dtype(cfg), device=device)
    return cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def prefill(params, batch, cfg: ModelConfig, max_seq: int | None = None,
            head=None, dp_groups: int = 1):
    """Process the full prompt (``batch["tokens"]`` (B, S) or
    ``batch["embeds"]``, optional ``batch["positions"]``: (3, B, S) for
    M-RoPE; whisper: frame embeddings ``embeds`` and decoder ``tokens``);
    return (cache, last-token logits (B, V_pad)).

    Whisper's decoder reads every frame, while the cache keeps the first
    ``encoder_len`` (its ``enc_out`` then has fewer rows if fewer frames
    came), as the reference's does (``repro/models/lm.py:255-265``)."""
    if cfg.encoder_decoder:
        enc_out = _whisper_encode(params, cfg, batch["embeds"])
        tokens = batch["tokens"]
        b, s = tokens.shape
        x, kvs = _whisper_decode_stack(params, cfg, tokens, enc_out)
        cache = _prefill_cache(cfg, b, s, max_seq or s, kvs, None, x.device)
        cache["enc_out"] = enc_out[:, :cfg.encoder_len].contiguous()
        return cache, _logits(params, cfg, x[:, -1], head)
    x = _embed_in(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    positions = _default_positions(cfg, batch, b, s, x.device)
    x, kvs, ssm_states = _run_layers(params, cfg, x, positions, dp_groups)
    cache = _prefill_cache(cfg, b, s, max_seq or s, kvs, ssm_states,
                           x.device)
    return cache, _logits(params, cfg, x[:, -1], head)


def _prefill_cache(cfg: ModelConfig, b: int, s: int, max_seq: int, kvs,
                   ssm_states, device):
    """The cache after a prompt of ``s`` tokens, in :func:`init_cache`'s
    layout, made from the layers' outputs (no zero cache written into):
    ``pos`` at s, the K/V and slot positions by :func:`_fill_kv`, the SSM
    states as they came."""
    cache = {"pos": torch.full((b,), s, dtype=torch.int32, device=device)}
    lcache = {}
    if kvs is not None:
        lcache["k"], lcache["v"], cache["slot_pos"] = _fill_kv(
            kvs, cache_window(cfg, max_seq), s)
    if ssm_states is not None:
        lcache.update(ssm_states)
    cache["layers"] = lcache
    return cache


def _fill_kv(kvs, w: int, s: int):
    """The prefill K/V (L, B, S, KV, hd) as a (rolling) cache of ``w``
    slots, with its slot positions (B, W): positions 0..S-1 in slots
    0..S-1 and the rest empty (-1) when they fit, else the last W
    positions at their rolling slots p % W (the reference's ``_fill_kv``,
    ``repro/models/lm.py:278-300``)."""
    k, v = kvs["k"], kvs["v"]
    b = k.shape[1]
    dev = k.device
    if s <= w:
        pad = (0, 0, 0, 0, 0, w - s)
        slot_pos = torch.full((w,), -1, dtype=torch.int32, device=dev)
        slot_pos[:s] = torch.arange(s, dtype=torch.int32, device=dev)
        k, v = F.pad(k, pad), F.pad(v, pad)
    else:
        # slot j holds position s - w + ((j - (s - w)) mod w)
        idx = (torch.arange(w, device=dev) - (s - w)) % w
        k = k[:, :, s - w:].index_select(2, idx)
        v = v[:, :, s - w:].index_select(2, idx)
        slot_pos = (s - w + idx).to(torch.int32)
    return k, v, slot_pos[None].expand(b, w).contiguous()


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_step(params, cache, batch, cfg: ModelConfig, head=None):
    """One token for every sequence. batch: {"token": (B,)} or {"embed":
    (B, D)}, and for M-RoPE optional "positions" (3, B), ``cache["pos"]``
    on each row by default. Updates ``cache`` in place (the new slot
    position and each layer's K/V row where there is attention, each
    layer's SSM state where there is an SSM, ``pos`` + 1) and returns
    (cache, logits (B, V_pad)). The K/V slot and the causal mask follow
    ``cache["pos"]``; the M-RoPE rows only rotate q and k
    (``layers.attn_decode``, ROADMAP C10). Whisper adds ``dec_pos`` at
    ``pos`` (its last row past 32,768) and cross-attends to
    ``cache["enc_out"]``, projecting the frames' K/V in every step."""
    if "embed" in batch:
        x = batch["embed"].to(_dtype(cfg))
    else:
        x = take_rows(params["embed"], batch["token"])
    x = constrain(x, "decode_x")
    pos = cache["pos"]
    if cfg.encoder_decoder:
        dec_pos = params["dec_pos"]
        x = x + take_rows(dec_pos, torch.clamp(pos, max=dec_pos.shape[0] - 1)
                          .long())
    positions = batch.get("positions") if cfg.mrope else None
    slot_pos = cache.get("slot_pos")
    if slot_pos is not None:
        L.attn_lib.write_slot(slot_pos, (pos % slot_pos.shape[1]).long(), pos)
    layers = cache["layers"]
    for i, p_layer in enumerate(params["layers"]):
        layer_cache = {key: t[i] for key, t in layers.items()}
        x = constrain(x, "decode_x")
        if cfg.encoder_decoder:
            x = L.dec_layer_decode(p_layer, x, cache["enc_out"], layer_cache,
                                   slot_pos, pos, cfg)
        else:
            x = L.layer_decode(p_layer, x, layer_cache, slot_pos, pos, cfg,
                               positions)
        x = constrain(x, "decode_x")
    logits = _logits(params, cfg, x, head)
    cache["pos"] = pos + 1
    return cache, logits
