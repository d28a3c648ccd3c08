"""The port's M-RoPE, sinusoidal table and qwen2-vl backbone against the JAX
reference, on the CPU.

``apply_mrope`` (qwen2-vl's multimodal RoPE: the hd/2 frequency slots split
across the t, h and w position rows) and ``sinusoidal_positions`` are held
to the reference's within 1e-6. The qwen2-vl backbone (reduced: 2 layers,
d = 64, hd 16, sections (2, 3, 3); f32) runs on the reference's own
weights, bridged, from patch embeddings drawn with numpy from a seed and
(3, B, S) positions whose three rows differ (a text run, an image of 2 x 3
patches, text again): ``prefill`` and ``decode_step`` with logits atol
1e-4, K/V within 1e-5 and slot positions exactly (``test_torch_lm.py``'s
bars), and ``train_loss`` with its gradients (loss 1e-5, every gradient
within 1e-4 of its largest |entry|).

Decode is held to the reference where the t row of ``positions`` equals
the sequence position ``cache["pos"]``. Elsewhere the two differ
(ROADMAP C10): the reference keys the new K/V row's slot and the causal
mask by the t row while its ``slot_pos`` follows ``cache["pos"]``; the
port keys both by ``cache["pos"]`` and takes only the rotation from
``positions``, so its decode step equals a prefill of the longer sequence
with the same positions. The test shows both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.models import common as jcommon
from repro.models import init_params as j_init_params
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.checkpoint import load_reference_lm_params
from repro_torch.models import common, lm
from repro_torch.nn import named_leaves

torch.set_num_threads(1)

ARCH = "qwen2-vl-72b"
ROPE_TOL = dict(atol=1e-6, rtol=1e-6)
KV_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=0)   # tests/test_torch_lm.py
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4                       # of each gradient's largest |entry|


def _mrope_positions(b, s, image_at=4, rows=2, cols=3):
    """(3, B, S) int32 qwen2-vl ids: text at (p, p, p), then an image of
    rows x cols patches at t = image_at, h = image_at + r, w = image_at +
    c, then text again from one past the largest id so far; lane i's ids
    shifted by i."""
    t, h, w = [], [], []
    for p in range(image_at):
        t.append(p), h.append(p), w.append(p)
    for r in range(rows):
        for c in range(cols):
            t.append(image_at), h.append(image_at + r), w.append(image_at + c)
    nxt = max(t + h + w) + 1
    while len(t) < s:
        t.append(nxt), h.append(nxt), w.append(nxt)
        nxt += 1
    one = np.array([t[:s], h[:s], w[:s]], np.int32)
    return np.stack([one + i for i in range(b)], axis=1)


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128),
                                         ((2, 3, 2), 16), ((3, 3, 3), 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(sections, hd, dtype):
    """qwen2-vl's sections at the reduced and full head width, and
    sections that fall short of hd/2 (the last row fills the rest) or
    exceed it (cut), as ``jnp.repeat``'s ``total_repeat_length`` does."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 7)).astype(np.int32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = common.apply_mrope(tx, torch.from_numpy(pos), 1e6, sections)
    want = jcommon.apply_mrope(jnp.asarray(x, jnp.dtype(dtype)),
                               jnp.asarray(pos), 1e6, sections)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROPE_TOL)
    else:  # the same f32 math rounded once to bf16: at most one ulp apart
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=1e-2, rtol=2 ** -7)


def test_mrope_with_equal_rows_is_rope():
    """With the three rows equal M-RoPE is the plain RoPE of that row."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 5, 3, 16)).astype(np.float32))
    pos = torch.arange(5, dtype=torch.int32)[None].expand(2, 5) + 40
    got = common.apply_mrope(x, pos[None].expand(3, 2, 5), 1e6, (2, 3, 3))
    assert torch.equal(got, common.apply_rope(x, pos, 1e6))


@pytest.mark.parametrize("seq_len,dim", [(1500, 384), (7, 64), (1, 2)])
def test_sinusoidal_positions_match_reference(seq_len, dim):
    """Within 1e-6 plus what one f32 ulp of the frequency moves the angle
    at position p (p 2^-22): the two packages' ``exp`` differ by an ulp
    on some frequencies, which position 1479 turns into 1.2e-4."""
    got = common.sinusoidal_positions(seq_len, dim)
    want = np.asarray(jcommon.sinusoidal_positions(seq_len, dim))
    assert got.dtype == torch.float32 and got.shape == want.shape
    bound = 1e-6 + np.arange(seq_len)[:, None] * 2.0 ** -22
    assert (np.abs(got.numpy() - want) <= bound).all()
    np.testing.assert_array_equal(got[0].numpy(), want[0])


# -- the qwen2-vl backbone ----------------------------------------------------


def _reference(seed=0, attn_scale=1.0):
    """Configs, the reference's params and the port's, bridged; the
    attention projections scaled by ``attn_scale`` in both."""
    cfg = configs.get_reduced_config(ARCH)
    jcfg = jconfigs.get_reduced_config(ARCH)
    jparams = j_init_params(jax.random.PRNGKey(seed), jcfg)
    attn = jparams["layers"]["attn"]
    for key in ("wq", "wk", "wv", "wo"):
        attn[key] = attn[key] * attn_scale
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams)[0]}
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(9))
    load_reference_lm_params(params, flat)
    return cfg, jcfg, jparams, params


def _embeds(b, s, d, seed=1):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (b, s, d))).astype(np.float32)


def _assert_cache(cache, jcache):
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]), **KV_TOL)
    for key in ("slot_pos", "pos"):
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(jcache[key]))


def _prefill_both(cfg, jcfg, jparams, params, embeds, positions, max_seq):
    jcache, jlogits = jlm.prefill(
        jparams, {"embeds": jnp.asarray(embeds),
                  "positions": jnp.asarray(positions)}, jcfg, 1,
        max_seq=max_seq)
    cache, logits = lm.prefill(
        params, {"embeds": torch.from_numpy(embeds),
                 "positions": torch.from_numpy(positions)}, cfg,
        max_seq=max_seq)
    return cache, logits, jcache, jlogits


def test_qwen2_vl_prefill_and_decode_match_reference():
    """Prefill from patch embeddings with three distinct position rows,
    then three decode steps of text tokens whose t row is the sequence
    position and whose h and w rows are not."""
    cfg, jcfg, jparams, params = _reference()
    embeds = _embeds(2, 13, cfg.d_model)
    positions = _mrope_positions(2, 13)
    assert (positions[0] != positions[1]).any()
    assert (positions[1] != positions[2]).any()
    cache, logits, jcache, jlogits = _prefill_both(
        cfg, jcfg, jparams, params, embeds, positions, 32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _assert_cache(cache, jcache)
    jstep = jax.jit(lambda p, c, t, q: jlm.decode_step(
        p, c, {"token": t, "positions": q}, jcfg))
    tokens = np.random.default_rng(3).integers(0, 256, (3, 2)).astype(
        np.int32)
    for step, tok in enumerate(tokens):
        pos = cache["pos"].numpy()
        rows = np.stack([pos, pos + 3, pos + 5]).astype(np.int32)
        jcache, jlogits = jstep(jparams, jcache, jnp.asarray(tok),
                                jnp.asarray(rows))
        cache, logits = lm.decode_step(
            params, cache, {"token": torch.from_numpy(tok),
                            "positions": torch.from_numpy(rows)}, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL, err_msg=f"step {step}")
        _assert_cache(cache, jcache)


def test_qwen2_vl_default_positions_match_reference():
    """Without ``positions`` both prefill at (p, p, p) and decode at
    ``cache["pos"]`` on each row."""
    cfg, jcfg, jparams, params = _reference()
    embeds = _embeds(1, 9, cfg.d_model, seed=4)
    jcache, jlogits = jlm.prefill(jparams, {"embeds": jnp.asarray(embeds)},
                                  jcfg, 1, max_seq=16)
    cache, logits = lm.prefill(params, {"embeds": torch.from_numpy(embeds)},
                               cfg, max_seq=16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    tok = np.array([7], np.int32)
    jcache, jlogits = jlm.decode_step(jparams, jcache,
                                      {"token": jnp.asarray(tok)}, jcfg)
    cache, logits = lm.decode_step(params, cache,
                                   {"token": torch.from_numpy(tok)}, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _assert_cache(cache, jcache)


def test_decode_with_t_row_off_the_sequence_position_c10():
    """ROADMAP C10. A decode step whose t row is not ``cache["pos"]`` (the
    reference's ``make_decode_batch`` passes t = 0; qwen2-vl's text after
    an image runs ahead of the sequence position): the port's step equals
    the last row of a prefill of the longer sequence with the same
    positions; the reference writes the new K/V row into slot t and masks
    every slot above t, so it overwrites position t's K/V and leaves slot
    ``pos`` empty while its ``slot_pos`` says slot ``pos`` holds it. The
    attention projections are scaled to std 0.5, so that attention moves
    the logits (at the init's 0.02 it is below the logit bar)."""
    cfg, jcfg, jparams, params = _reference(attn_scale=25.0)
    s = 11
    embeds = _embeds(1, s, cfg.d_model, seed=5)
    positions = _mrope_positions(1, s)
    for t in (0, s + 3):
        new_rows = np.array([[t], [t + 1], [t + 2]], np.int32)
        token = np.array([9], np.int32)
        x_new = params["embed"][torch.from_numpy(token)].numpy()[:, None]
        longer = lm.prefill(params, {
            "embeds": torch.from_numpy(np.concatenate([embeds, x_new], 1)),
            "positions": torch.from_numpy(np.concatenate(
                [positions, new_rows[:, :, None]], -1))}, cfg, max_seq=16)[1]
        cache, _, jcache, _ = _prefill_both(cfg, jcfg, jparams, params,
                                            embeds, positions, 16)
        cache, logits = lm.decode_step(
            params, cache, {"token": torch.from_numpy(token),
                            "positions": torch.from_numpy(new_rows)},
            cfg)
        np.testing.assert_allclose(logits.numpy(), longer.numpy(),
                                   **LOGIT_TOL)
        k_before = np.asarray(jcache["layers"]["k"]).copy()
        jcache, jlogits = jlm.decode_step(
            jparams, jcache, {"token": jnp.asarray(token),
                              "positions": jnp.asarray(new_rows)},
            jcfg)
        assert np.abs(np.asarray(jlogits) - longer.numpy()).max() > 1e-3
        jk = np.asarray(jcache["layers"]["k"])
        assert int(np.asarray(jcache["slot_pos"])[0, s]) == s
        # the reference's row went to slot t (over position 0's at t = 0)
        assert not np.array_equal(jk[:, :, t], k_before[:, :, t])
        assert not jk[:, :, s].any()  # slot pos was never written
        pk = cache["layers"]["k"].numpy()
        assert pk[:, :, s].any()
        np.testing.assert_allclose(pk[:, :, :s], k_before[:, :, :s],
                                   **KV_TOL)


def test_qwen2_vl_train_loss_and_gradients_match_reference():
    """The backbone's loss from embeddings and (3, B, S) positions, and
    the gradient of every leaf."""
    cfg, jcfg, jparams, params = _reference(seed=2)
    b, s = 2, 13
    rng = np.random.default_rng(6)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, :3] = -100
    batch = {"embeds": _embeds(b, s, cfg.d_model, seed=7),
             "positions": _mrope_positions(b, s), "labels": labels}
    (jtotal, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(p, jax.tree.map(jnp.asarray, batch), jcfg),
        has_aux=True)(jparams)
    jflat = {k: np.asarray(v) for k, v in _flatten_with_paths(jgrads)[0]}
    leaves = named_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    total, metrics = lm.train_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = dict(zip(leaves, torch.autograd.grad(
        total, list(leaves.values()), allow_unused=True)))
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(metrics["loss"].detach()),
                               float(jmetrics["loss"]), **LOSS_TOL)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == b * (s - 3)
    for key, g in grads.items():
        parts = key.split("/")
        want = (jflat["/".join(["layers"] + parts[2:])][int(parts[1])]
                if parts[0] == "layers" else jflat[key])
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert np.abs(got - want).max() <= GRAD_TOL * scale, key
