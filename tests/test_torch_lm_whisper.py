"""The port's whisper (encoder-decoder) LM and its attention over a key
sequence of another length, against the JAX reference on the CPU.

Reduced whisper (2 encoder and 2 decoder layers, d = 64, 4 heads of 16,
``encoder_len`` 32, f32) runs on the reference's own weights, bridged
through ``checkpoint/convert.py``, from frame embeddings and tokens drawn
with numpy from a seed: ``prefill`` (the logits, the decoder's K/V cache,
``enc_out`` cut to ``encoder_len`` where more frames came, the slot
positions) and three ``decode_step``s, and ``train_loss`` with the
gradient of every leaf (loss 1e-5, every gradient within 1e-4 of its
largest |entry|; logits atol 1e-4 and K/V 1e-5, ``test_torch_lm.py``'s
bars). One case runs whisper-tiny's widths (d 384, 6 heads of 64, d_ff
1536) at 1 layer each and short lengths.

Attention at Sq != Sk (the decoder's cross attention over the frames):
the plain ``flash_attention`` and ``flash_bwd`` against
``repro.models.attention.flash_attention`` and its VJP, causal and not.
Checkpoints: the ``enc_layers`` stack round-trips through ``convert.py``,
and Adafactor groups ``enc_layers/<i>/`` per stack.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.models import attention as jattention
from repro.models import init_params as j_init_params
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.checkpoint import load_reference_lm_params
from repro_torch.checkpoint.convert import host_array, stack_layers
from repro_torch.models import attention, lm
from repro_torch.nn import named_leaves
from repro_torch.optim.adafactor import _groups

torch.set_num_threads(1)

ARCH = "whisper-tiny"
KV_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=0)   # tests/test_torch_lm.py
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4                       # of each gradient's largest |entry|
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)


def _tiny_widths():
    """whisper-tiny's widths (d, heads, hd, d_ff) at 1 encoder and 1
    decoder layer, f32; the vocabulary cut to 512 rows (the head's width
    is not what the test holds, and 51,865 rows make the reference's
    gradient slow on the CPU)."""
    def cut(cfg):
        return dataclasses.replace(cfg, num_layers=1, num_encoder_layers=1,
                                   vocab_size=512, dtype="float32",
                                   remat="none")
    return cut(configs.get_config(ARCH)), cut(jconfigs.get_config(ARCH))


@functools.lru_cache(maxsize=None)
def _reference_tree(seed, full_width):
    if full_width:
        cfg, jcfg = _tiny_widths()
    else:
        cfg = configs.get_reduced_config(ARCH)
        jcfg = jconfigs.get_reduced_config(ARCH)
    jparams = jax.jit(j_init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, jparams


def _reference(seed=0, full_width=False):
    """Configs, the reference's params and the port's, bridged (fresh port
    tensors on every call)."""
    cfg, jcfg, jparams = _reference_tree(seed, full_width)
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams)[0]}
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(9))
    load_reference_lm_params(params, flat)
    return cfg, jcfg, jparams, params


def _frames(b, s, d, seed=1):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (b, s, d))).astype(np.float32)


def _tokens(b, s, vocab, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _jprefill(jparams, embeds, tokens, jcfg, max_seq):
    return jax.jit(lambda p, e, t: jlm.prefill(
        p, {"embeds": e, "tokens": t}, jcfg, 1, max_seq=max_seq))(
        jparams, jnp.asarray(embeds), jnp.asarray(tokens))


def _assert_cache(cache, jcache):
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]), **KV_TOL)
    for key in ("slot_pos", "pos"):
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(jcache[key]))
    assert cache["enc_out"].shape == jcache["enc_out"].shape
    np.testing.assert_allclose(cache["enc_out"].numpy(),
                               np.asarray(jcache["enc_out"]), **KV_TOL)


def test_whisper_params_bridge_leaf_for_leaf():
    """The port's tree has the reference's leaves, shapes and dtypes: the
    stacked ``enc_layers`` and decoder ``layers`` (cross attention without
    qk-norm), ``enc_norm``, ``dec_pos`` (32,768 x D)."""
    cfg, jcfg, jparams, params = _reference()
    got = stack_layers(named_leaves(params))
    want = dict(_flatten_with_paths(jparams)[0])
    assert set(got) == set(want)
    for key, t in got.items():
        assert tuple(t.shape) == tuple(want[key].shape), key
        np.testing.assert_array_equal(host_array(t), np.asarray(want[key]))
    assert params["dec_pos"].shape == (32_768, cfg.d_model)
    assert len(params["enc_layers"]) == cfg.num_encoder_layers
    assert "q_norm" not in params["layers"][0]["xattn"]


@pytest.mark.parametrize("frames", [20, 40])
def test_whisper_prefill_and_decode_match_reference(frames):
    """Prefill over ``frames`` frames (fewer than ``encoder_len`` = 32, and
    more: the decoder reads all 40, the cache keeps 32) and a 5-token
    prompt into 16 slots, then three decode steps."""
    cfg, jcfg, jparams, params = _reference()
    embeds = _frames(2, frames, cfg.d_model)
    tokens = _tokens(2, 5, cfg.vocab_size)
    jcache, jlogits = _jprefill(jparams, embeds, tokens, jcfg, 16)
    cache, logits = lm.prefill(
        params, {"embeds": torch.from_numpy(embeds),
                 "tokens": torch.from_numpy(tokens)}, cfg, max_seq=16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    assert cache["enc_out"].shape == (2, min(frames, cfg.encoder_len),
                                      cfg.d_model)
    _assert_cache(cache, jcache)
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, c, {"token": t}, jcfg))
    for step, tok in enumerate(_tokens(3, 2, cfg.vocab_size, seed=3)):
        jcache, jlogits = jstep(jparams, jcache, jnp.asarray(tok))
        cache, logits = lm.decode_step(params, cache,
                                       {"token": torch.from_numpy(tok)}, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL, err_msg=f"step {step}")
        _assert_cache(cache, jcache)


def _grads_match(params, jparams, batch, cfg, jcfg, dp_groups=1):
    """train_loss and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's; returns the port's
    metrics."""
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jlm.train_loss(p, bt, jcfg, dp_groups),
        has_aux=True))(jparams, jax.tree.map(jnp.asarray, batch))
    jflat = {k: np.asarray(v) for k, v in _flatten_with_paths(jgrads)[0]}
    leaves = named_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    total, metrics = lm.train_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
        dp_groups)
    grads = dict(zip(leaves, torch.autograd.grad(
        total, list(leaves.values()), allow_unused=True)))
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               **LOSS_TOL)
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(jmetrics[key]), **LOSS_TOL)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"])
    for key, g in grads.items():
        parts = key.split("/")
        want = (jflat["/".join([parts[0]] + parts[2:])][int(parts[1])]
                if parts[0] in ("layers", "enc_layers") else jflat[key])
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert np.abs(got - want).max() <= GRAD_TOL * scale, key
    return metrics


def test_whisper_train_loss_and_gradients_match_reference():
    """The loss over 24 frames and 9 decoder tokens (some labels masked),
    and the gradient of every leaf, the encoder's included."""
    cfg, jcfg, jparams, params = _reference(seed=2)
    b, s = 2, 9
    labels = _tokens(b, s, cfg.vocab_size, seed=6)
    labels[:, :2] = -100
    batch = {"embeds": _frames(b, 24, cfg.d_model, seed=7),
             "tokens": _tokens(b, s, cfg.vocab_size, seed=8),
             "labels": labels}
    metrics = _grads_match(params, jparams, batch, cfg, jcfg)
    assert float(metrics["aux_loss"]) == 0.0


def test_whisper_tiny_widths_match_reference():
    """whisper-tiny's widths (d 384, hd 64, 6 heads, d_ff 1536) at one
    layer each: prefill over 70 frames (B4's 64-row tiles and a ragged
    one) and a 3-token prompt, two decode steps, and train_loss with its
    gradients."""
    cfg, jcfg, jparams, params = _reference(seed=3, full_width=True)
    embeds = _frames(1, 70, cfg.d_model, seed=4)
    tokens = _tokens(1, 3, cfg.vocab_size, seed=5)
    jcache, jlogits = _jprefill(jparams, embeds, tokens, jcfg, 8)
    cache, logits = lm.prefill(
        params, {"embeds": torch.from_numpy(embeds),
                 "tokens": torch.from_numpy(tokens)}, cfg, max_seq=8)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _assert_cache(cache, jcache)
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, c, {"token": t}, jcfg))
    for tok in _tokens(2, 1, cfg.vocab_size, seed=6):
        jcache, jlogits = jstep(jparams, jcache, jnp.asarray(tok))
        cache, logits = lm.decode_step(params, cache,
                                       {"token": torch.from_numpy(tok)}, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)
        _assert_cache(cache, jcache)
    labels = _tokens(1, 4, cfg.vocab_size, seed=9)
    _grads_match(params, jparams, {
        "embeds": _frames(1, 40, cfg.d_model, seed=10),
        "tokens": _tokens(1, 4, cfg.vocab_size, seed=11),
        "labels": labels}, cfg, jcfg)


# -- attention over a key sequence of its own length -------------------------


@pytest.mark.parametrize("sq,sk,causal,chunk", [
    (5, 37, False, 16),    # a decoder prompt over the frames
    (1, 20, False, 16),    # one row
    (33, 20, False, 16),   # more rows than keys, both ragged
    (9, 40, True, 4),      # causal, top-left aligned
    (40, 9, True, 16),     # causal rows past the keys (Sk < Sq)
])
def test_flash_attention_and_backward_at_other_key_lengths(sq, sk, causal,
                                                           chunk):
    """The plain path of ``attention.flash_attention`` (B4's plain version
    forward, the pair-scan ``flash_bwd`` backward) against the reference's
    pair-scan forward and its VJP, G = 2."""
    rng = np.random.default_rng(sq * 100 + sk)
    q, do = (rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
            for _ in range(2))

    @jax.jit
    def jfn(q, k, v, do):
        out, vjp = jax.vjp(lambda *x: jattention.flash_attention(
            *x, chunk=chunk, causal=causal), q, k, v)
        return out, vjp(do)

    jout, jgrads = jfn(*map(jnp.asarray, (q, k, v, do)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = attention.flash_attention(*leaves, chunk=chunk, causal=causal)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **ATTN_TOL)
    for name, t, want in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **ATTN_TOL, err_msg=f"d{name}")


def test_cross_decode_attention_is_the_unmasked_one_row_attention():
    """On the CPU the one-token cross attention is ``naive_attention``; its
    B5 form (the frames' slot map, the query at Sk - 1) gives the same
    rows through B5's plain version."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((3, 1, 6, 16)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((3, 50, 6, 16)).astype(
        np.float32)) for _ in range(2))
    got = attention.cross_decode_attention(q, k, v)
    want = jattention.naive_attention(*map(jnp.asarray, (
        q.numpy(), k.numpy(), v.numpy())), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    slot_pos = torch.arange(50, dtype=torch.int32).expand(3, 50)
    b5 = ref.decode_attention_torch(q[:, 0], k, v, slot_pos,
                                    torch.full((3,), 49, dtype=torch.int32))
    np.testing.assert_allclose(b5[:, None].numpy(), got.numpy(), **ATTN_TOL)


# -- checkpoints and Adafactor -----------------------------------------------


def test_enc_layers_round_trip_through_convert_and_group_in_adafactor():
    """The port's whisper tree stacked into the reference's paths and
    back, bit for bit; Adafactor's stacked-leaf groups hold each
    ``enc_layers/<rest>`` across the encoder's layers, apart from the
    decoder's."""
    cfg = configs.get_reduced_config(ARCH)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(1))
    stacked = stack_layers(named_leaves(params))
    assert stacked["enc_layers/attn/wq"].shape == (
        cfg.num_encoder_layers, cfg.d_model, cfg.num_heads * cfg.head_dim)
    back = lm.init_params(cfg, generator=torch.Generator().manual_seed(2))
    load_reference_lm_params(back, {k: host_array(t)
                                    for k, t in stacked.items()})
    for key, t in named_leaves(params).items():
        assert torch.equal(named_leaves(back)[key], t), key
    groups = {tuple(g) for g in _groups(named_leaves(params)).values()}
    assert tuple(f"enc_layers/{i}/mlp/wi"
                 for i in range(cfg.num_encoder_layers)) in groups
    assert tuple(f"layers/{i}/xattn/wq"
                 for i in range(cfg.num_layers)) in groups
