"""The port's SSM (falcon-mamba) and hybrid (hymba) LMs against the JAX
reference, on the CPU: the weight bridge with the SSM and branch-norm
leaves, the cache layout per family, ``prefill`` and ``decode_step``, and
``_splice_cache``.

The reference's own ``init_params`` makes the weights; the bridge copies
them into the port. Reduced configs in f32 (2 layers, d_model 64, N 4;
hymba's attention window 16, so a 40-token prompt takes the rolling fill).
Tolerances as ``tests/test_torch_lm.py``: logits atol 1e-4, K/V and SSM
states 1e-5 (atol and rtol), slot positions and ``pos`` exactly. The SSM
scan runs B6's plain version here and attention the plain versions of B4
and B5; the kernels themselves are held against those on the card.
``LMEdgeBackend`` in lockstep with the reference's, for both models, is in
``tests/test_torch_lm_serving.py``.
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
from repro.serving import batching as jbatching
from repro_torch import configs
from repro_torch.checkpoint import load_reference_lm_params
from repro_torch.checkpoint.convert import lm_param_groups
from repro_torch.kernels import build
from repro_torch.models import lm
from repro_torch.serving import batching

torch.set_num_threads(1)

ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
SSM_LEAVES = {f"layers/ssm/{k}" for k in (
    "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log",
    "D", "out_proj")}
F32_LEAVES = {f"layers/ssm/{k}" for k in (
    "conv_w", "conv_b", "dt_proj", "dt_bias", "A_log", "D")}


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


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _assert_cache(cache, jcache):
    assert set(cache) == set(jcache)
    assert set(cache["layers"]) == set(jcache["layers"])
    for key, want in jcache["layers"].items():
        got = cache["layers"][key]
        assert str(got.dtype).split(".")[-1] == want.dtype.name, key
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **STATE_TOL,
                                   err_msg=key)
    for key in ("slot_pos", "pos"):
        if key in jcache:
            np.testing.assert_array_equal(cache[key].numpy(),
                                          np.asarray(jcache[key]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_weight_bridge_carries_ssm_and_branch_norm_leaves(arch, dtype):
    """Every reference leaf lands bit for bit in the port's per-layer
    leaves with the reference's dtype: bf16 projections, f32 conv, dt and
    A; hymba's two branch norms in f32."""
    cfg, _, _, params, flat = _reference(arch, dtype)
    groups = lm_param_groups(params)
    assert set(groups) == set(flat)
    assert SSM_LEAVES <= set(groups)
    if cfg.hybrid:
        assert {"layers/attn_branch_norm", "layers/ssm_branch_norm"} <= set(
            groups)
    for key, tensors in groups.items():
        got = torch.stack(tensors) if key.startswith("layers/") else tensors[0]
        want = flat[key]
        assert tuple(got.shape) == want.shape, key
        assert str(got.dtype).split(".")[-1] == want.dtype.name, key
        if key in F32_LEAVES or key.endswith("branch_norm"):
            assert got.dtype == torch.float32, key
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_follows_the_family(arch):
    """No ``slot_pos``, ``k`` or ``v`` for the SSM family; all four for
    the hybrid; ``h`` (L, B, d, N) and ``conv`` (L, B, K-1, d) in f32."""
    cfg = configs.get_reduced_config(arch)
    jcfg = jconfigs.get_reduced_config(arch)
    cache = lm.init_cache(cfg, 3, 24)
    jcache = jlm.init_cache(jcfg, 3, 24)
    _assert_cache(cache, jcache)
    assert ("slot_pos" in cache) == (cfg.family == "hybrid")
    assert cache["layers"]["h"].shape == (cfg.num_layers, 3, cfg.d_inner,
                                          cfg.ssm_state)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("prompt,max_seq", [(2, 32), (13, 32), (40, 64)])
def test_prefill_matches_reference(arch, prompt, max_seq):
    """Last-token logits and the whole cache; a 2-token prompt takes the
    conv state's padding branch, a 40-token one hymba's rolling fill."""
    cfg, jcfg, jparams, params, _ = _reference(arch)
    tokens = _tokens(2, prompt)
    jcache, jlogits = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcfg, 1, max_seq=max_seq)
    cache, logits = lm.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               cfg, max_seq=max_seq)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _assert_cache(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("prompt,max_seq", [(13, 32), (40, 64)])
def test_decode_steps_match_reference(arch, prompt, max_seq):
    """Four decode steps after a prefill: the SSM state and conv window
    advance in place; hymba's rolling window overwrites its oldest slots."""
    cfg, jcfg, jparams, params, _ = _reference(arch)
    tokens = _tokens(2, prompt, seed=2)
    jcache, _ = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, 1,
                            max_seq=max_seq)
    cache, _ = lm.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                          max_seq=max_seq)
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, c, {"token": t}, jcfg))
    for step, tok in enumerate(_tokens(4, 2, seed=3)):
        jcache, jlogits = jstep(jparams, jcache, jnp.asarray(tok))
        cache, logits = lm.decode_step(params, cache,
                                       {"token": torch.from_numpy(tok)}, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL, err_msg=f"step {step}")
        _assert_cache(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_keeps_f32_ssm_states(arch):
    """A bf16 model: f32 SSM states, K/V in bf16, finite f32 logits; the
    same weights on the reference give logits within a bf16 bar."""
    cfg, jcfg, jparams, params, _ = _reference(arch, "bfloat16")
    tokens = _tokens(1, 21, seed=4)
    cache, logits = lm.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               cfg, max_seq=32)
    jcache, jlogits = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcfg, 1, max_seq=32)
    assert cache["layers"]["h"].dtype == torch.float32
    assert cache["layers"]["conv"].dtype == torch.float32
    if cfg.hybrid:
        assert cache["layers"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-2, rtol=0)
    cache, logits = lm.decode_step(params, cache, {"token": torch.tensor(
        [5], dtype=torch.int32)}, cfg)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert int(cache["pos"][0]) == 22


@pytest.mark.parametrize("arch", ARCHS)
def test_splice_cache_copies_ssm_states_whole(arch):
    """An admitted lane's prefill cache lands in its lane of the batch
    cache in place, as the reference's ``_splice_cache`` places it: SSM
    states whole, K/V and slot positions fitted to the batch window (a
    40-token hymba prompt with a 16-slot window), other lanes untouched."""
    cfg, jcfg, jparams, params, _ = _reference(arch)
    tokens = _tokens(1, 40, seed=5)
    one, _ = lm.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                        max_seq=64)
    jone, _ = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, 1,
                          max_seq=64)
    batch = lm.init_cache(cfg, 3, 64)
    layers_before = {k: v for k, v in batch["layers"].items()}
    batching._splice_cache(batch, one, 1)
    jbatch = jbatching._splice_cache(jlm.init_cache(jcfg, 3, 64), jone, 1)
    _assert_cache(batch, jbatch)
    assert all(batch["layers"][k] is v for k, v in layers_before.items())
    for key in ("h", "conv"):
        assert torch.equal(batch["layers"][key][:, 1],
                           one["layers"][key][:, 0])
        assert float(batch["layers"][key][:, [0, 2]].abs().max()) == 0.0
    assert batch["pos"].tolist() == [0, 40, 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_edge_backend_serves_with_ssm_caches(arch):
    """Every request finishes with its generation length, one phi
    observation per admission; on the CPU the scan launches no kernel."""
    cfg = configs.get_reduced_config(arch)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    be = batching.LMEdgeBackend(cfg, params, lanes=2, max_seq=64,
                                device="cpu")
    build.reset_launch_counts()
    for rid, (plen, glen) in enumerate([(30, 4), (2, 3), (9, 5)]):
        be.submit(rid, plen, glen)
    be.drain()
    assert be.finished == {0: 4, 1: 3, 2: 5}
    assert len(be.phi._xs) == 3
    assert sum(build.LAUNCHES.values()) == 0
