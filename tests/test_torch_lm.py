"""The port's dense LM (configs, weight bridge, prefill, decode) against the
JAX reference, on the CPU.

The reference's own ``init_params`` makes the weights; the bridge
(``load_reference_lm_params``) copies them, layer by layer, into the port.
Then the same tokens go through both ``prefill`` and ``decode_step`` at the
four dense reduced configs (olmo-1b, qwen3-4b, mistral-large-123b,
llama3-405b; f32, 2 layers, d=64). Tolerances: K/V caches 1e-5 (f32
projections, RoPE and attention in another order), slot positions and
``pos`` exactly, logits atol 1e-4 (a 256-wide f32 head over the residual
stream). Attention runs the plain versions of B4 and B5 here; the kernels
themselves are held against those on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.models import init_params as j_init_params
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.checkpoint import load_reference_lm_params
from repro_torch.checkpoint.convert import lm_param_groups
from repro_torch.models import lm

torch.set_num_threads(1)

DENSE = ["olmo-1b", "qwen3-4b", "mistral-large-123b", "llama3-405b"]
KV_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=0)


def _reference(arch, dtype=None, seed=0):
    cfg = configs.get_reduced_config(arch)
    jcfg = jconfigs.get_reduced_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
    jparams = j_init_params(jax.random.PRNGKey(seed), jcfg)
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams)[0]}
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(9))
    load_reference_lm_params(params, flat)
    return cfg, jcfg, jparams, params, flat


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_cache(cache, jcache):
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]), **KV_TOL)
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_reference_field_for_field(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for got, want in ((configs.get_config(arch), jconfigs.get_config(arch)),
                      (configs.get_reduced_config(arch),
                       jconfigs.get_reduced_config(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.padded_vocab, got.d_inner, got.sub_quadratic) == (
            want.padded_vocab, want.d_inner, want.sub_quadratic)


@pytest.mark.parametrize("arch,dtype", [("qwen3-4b", None),
                                        ("qwen3-4b", "bfloat16"),
                                        ("olmo-1b", "bfloat16"),
                                        ("llama3-405b", None)])
def test_weight_bridge_round_trips(arch, dtype):
    """Every reference leaf lands bit for bit in the port's per-layer
    leaves (bf16 read through int16, without ml_dtypes); the nonparametric
    norm keeps its (0,) placeholder leaf."""
    cfg, _, _, params, flat = _reference(arch, dtype)
    groups = lm_param_groups(params)
    assert set(groups) == set(flat)
    for key, tensors in groups.items():
        got = torch.stack(tensors) if key.startswith("layers/") else tensors[0]
        want = flat[key]
        assert tuple(got.shape) == want.shape, key
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_weight_bridge_raises_on_missing_extra_and_shape():
    cfg, _, _, params, flat = _reference("qwen3-4b")
    with pytest.raises(KeyError, match="missing"):
        load_reference_lm_params(params, {k: v for k, v in flat.items()
                                          if k != "layers/attn/q_norm"})
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_lm_params(params, {**flat, "lm_head": flat["embed"]})
    bad = dict(flat)
    bad["layers/mlp/wo"] = flat["layers/mlp/wo"][:1]
    with pytest.raises(ValueError, match="shape mismatch"):
        load_reference_lm_params(params, bad)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference(arch):
    cfg, jcfg, jparams, params, _ = _reference(arch)
    tokens = _tokens(2, 13)
    jcache, jlogits = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcfg, 1, max_seq=32)
    cache, logits = lm.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               cfg, max_seq=32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _assert_cache(cache, jcache)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("prompt,max_seq", [(13, 32), (40, 24)])
def test_decode_steps_match_reference(arch, prompt, max_seq):
    """Three decode steps after a prefill; (40, 24) is a prompt longer than
    the cache, so ``_fill_kv`` keeps the last 24 positions at their rolling
    slots and the decode steps overwrite the oldest."""
    cfg, jcfg, jparams, params, _ = _reference(arch)
    tokens = _tokens(2, prompt, seed=2)
    jcache, _ = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, 1,
                            max_seq=max_seq)
    cache, _ = lm.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                          max_seq=max_seq)
    _assert_cache(cache, jcache)
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, c, {"token": t}, jcfg))
    for step, tok in enumerate(_tokens(3, 2, seed=3)):
        jcache, jlogits = jstep(jparams, jcache, jnp.asarray(tok))
        cache, logits = lm.decode_step(params, cache,
                                       {"token": torch.from_numpy(tok)}, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL, err_msg=f"step {step}")
        _assert_cache(cache, jcache)


@pytest.mark.parametrize("arch,match", [("whisper-tiny", "whisper")])
def test_other_families_are_not_ported_yet(arch, match):
    """Every family is ported now: whisper's encoder-decoder tree is made
    (its parity is ``tests/test_torch_lm_whisper.py``'s), and its cache
    holds the encoder output."""
    cfg = configs.get_reduced_config(arch)
    assert match in cfg.name
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert len(params["enc_layers"]) == cfg.num_encoder_layers
    assert len(params["layers"]) == cfg.num_layers
    assert "xattn" in params["layers"][0]
    cache = lm.init_cache(cfg, 2, 8)
    assert cache["enc_out"].shape == (2, cfg.encoder_len, cfg.d_model)


def test_mrope_is_not_ported_yet():
    """M-RoPE is ported now: the qwen2-vl backbone prefills from
    embeddings (M-RoPE at its default (p, p, p) positions), where this
    test once expected ``NotImplementedError``; it keeps its name.
    tests/test_torch_lm_mrope.py holds the backbone to the reference."""
    cfg = configs.get_reduced_config("qwen2-vl-72b")
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    embeds = torch.zeros(1, 4, cfg.d_model)
    cache, logits = lm.prefill(params, {"embeds": embeds}, cfg)
    assert logits.shape == (1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    assert cache["pos"].tolist() == [4]


def test_bf16_model_runs_and_holds_one_f32_head():
    """A bf16 model keeps bf16 caches; the f32 head is a copy of the tied
    embedding, made once and passed to every step."""
    cfg = dataclasses.replace(configs.get_reduced_config("qwen3-4b"),
                              dtype="bfloat16")
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    head = lm.head_f32(params, cfg)
    assert head.dtype == torch.float32 and head.shape == (cfg.d_model,
                                                          cfg.padded_vocab)
    cache, logits = lm.prefill(params, {"tokens": torch.from_numpy(
        _tokens(1, 7))}, cfg, max_seq=16, head=head)
    assert cache["layers"]["k"].dtype == torch.bfloat16
    cache, logits2 = lm.decode_step(params, cache, {"token": torch.tensor(
        [5], dtype=torch.int32)}, cfg, head=head)
    assert logits2.dtype == torch.float32 and torch.isfinite(logits2).all()
    assert int(cache["pos"][0]) == 8
