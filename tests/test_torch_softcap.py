"""Attention logit soft-capping in the port (the reference's
``logit_softcap``, ``repro/models/attention.py:32-35``) against the JAX
reference, on the CPU.

A cap above 0 replaces each scaled score s by ``cap * tanh(s / cap)``
before the mask. The same numpy inputs (from a seed) go through the port
and the reference, all f32:

* B4's and B5's plain versions (``kernels/ref.py``), B4's log-sum-exp, and
  ``models.attention``'s ``naive_attention``, ``flash_attention`` (the
  pair-scan's chunk padding, windows, Sq != Sk) and ``decode_attention``
  against the reference's, at 1e-5 (atol and rtol), as
  ``tests/test_torch_attention.py`` holds them uncapped;
* ``FlashAttention``'s backward with the cap (``flash_bwd``, whose ds
  carries 1 - tanh^2(s / cap)) against ``jax.vjp`` of the reference's
  ``flash_attention``, at the 1e-5 of ``tests/test_torch_lm_train.py``;
* the capped flash-decode over a cache split on its slots, on a gloo world
  of two ranks (this file re-run as two subprocesses, joined through a
  ``FileStore`` under ``tmp_path``), against the reference's
  ``decode_attention``, at 1e-5;
* reduced qwen3-4b and hymba-1.5b (its attention branch beside its SSM)
  with a cap, through ``checkpoint/convert.py``: prefill and decode logits
  at the 1e-4 of ``tests/test_torch_lm.py``, ``train_loss`` and its
  gradients at ``tests/test_torch_lm_train.py``'s bars.

At the models' random initialisation the scores are small and a cap of
50 (Gemma 2's) changes nothing measurable, so every case takes a cap that
the inputs' scores exceed, and asserts that the capped result differs
from the uncapped one by more than its tolerance. Cross attention stays
uncapped, as in the reference. B4 and B5 with the cap run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import argparse
import dataclasses
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.sharding import ctx as sctx  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
CAP = 1.0          # unit-normal q, k at hd 16: scores up to ~4
HD, KV = 16, 2
MASKS = [(True, None), (True, 5), (False, None), (False, 7)]
RANK_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
#: sharded flash-decode: (B, W, H, KV, hd); cases: a full cache, a window
SHARD_SHAPE = (3, 32, 4, 2, 16)
SHARD_CASES = {"full": None, "window": 9}


def _qkv(b, s, g, sk=None, seed=0):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.normal(size=(b, s, KV * g, HD)).astype(np.float32),
            rng.normal(size=(b, sk, KV, HD)).astype(np.float32),
            rng.normal(size=(b, sk, KV, HD)).astype(np.float32))


def _decode_inputs(g, seed=1, w=24):
    """Three lanes: a partly empty cache, a rolling cache (positions
    30..53 at their slots p % W), and a full cache whose query position is
    mid-way."""
    rng = np.random.default_rng(seed)
    b = 3
    q = rng.normal(size=(b, KV * g, HD)).astype(np.float32)
    kc = rng.normal(size=(b, w, KV, HD)).astype(np.float32)
    vc = rng.normal(size=(b, w, KV, HD)).astype(np.float32)
    slot_pos = np.full((b, w), -1, np.int32)
    slot_pos[0, :10] = np.arange(10)
    tail = np.arange(30, 30 + w)
    slot_pos[1, tail % w] = tail
    slot_pos[2] = np.arange(w)
    pos = np.array([9, 30 + w - 1, 15], np.int32)
    return q, kc, vc, slot_pos, pos


def _differs(capped, uncapped, tol=1e-3):
    """The cap moved the result by more than ``tol`` somewhere."""
    gap = float(np.abs(np.array(capped, np.float32)
                       - np.array(uncapped, np.float32)).max())
    assert gap > tol, f"the cap moved the result by only {gap}"


# -- the plain versions and the model functions --------------------------------


@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_versions_match_reference_naive_attention(causal, window):
    import jax.numpy as jnp
    from repro.models import attention as jattn

    from repro_torch.kernels import ref
    q, k, v = _qkv(2, 12, 2)
    want = jattn.naive_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 window=window, logit_softcap=CAP)
    t = list(map(torch.from_numpy, (q, k, v)))
    for got in (ref.flash_attention_torch(*t, causal=causal, window=window,
                                          softcap=CAP),
                attention.naive_attention(*t, causal=causal, window=window,
                                          logit_softcap=CAP)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _differs(want, ref.flash_attention_torch(*t, causal=causal,
                                             window=window))


# (Sq, Sk, causal, window): a ragged S padded to the chunk grid, a window,
# every column, keys of another length (fewer and more)
FLASH_CASES = [(40, 40, True, None), (40, 40, True, 24), (40, 40, False, None),
               (24, 40, True, None), (40, 24, False, None)]


@pytest.mark.parametrize("sq,sk,causal,window", FLASH_CASES)
def test_flash_attention_and_lse_match_reference_pair_scan(sq, sk, causal,
                                                           window):
    """``models.attention.flash_attention`` (B4's op, its plain version on
    the CPU) and B4's log-sum-exp against the reference's pair-scan
    ``flash_attention`` and the lse of its ``_flash_fwd_impl``, chunk 16."""
    import jax.numpy as jnp
    from repro.models import attention as jattn

    from repro_torch.kernels import ref
    q, k, v = _qkv(2, sq, 2, sk=sk, seed=sq + sk)
    j = list(map(jnp.asarray, (q, k, v)))
    want = jattn.flash_attention(*j, chunk=16, causal=causal, window=window,
                                 logit_softcap=CAP)
    t = list(map(torch.from_numpy, (q, k, v)))
    got = attention.flash_attention(*t, chunk=16, causal=causal,
                                    window=window, logit_softcap=CAP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _differs(got, attention.flash_attention(*t, chunk=16, causal=causal,
                                            window=window))
    # the reference's lse, on its inputs padded to the chunk grid as its
    # flash_attention pads them (columns past Sk masked), rows past Sq cut
    padded = [np.pad(x, ((0, 0), (0, -x.shape[1] % 16), (0, 0), (0, 0)))
              for x in (q, k, v)]
    _, jlse = jattn._flash_fwd_impl(*map(jnp.asarray, padded), 16, causal,
                                    window, CAP, sk)
    b, h = q.shape[0], q.shape[2]
    jlse = np.asarray(jlse).reshape(b, -1, h)[:, :sq].transpose(0, 2, 1)
    lse = ref.flash_attention_lse_torch(t[0], t[1], causal=causal,
                                        window=window, softcap=CAP)
    np.testing.assert_allclose(lse.numpy(), jlse, **TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_reference(window):
    """``models.attention.decode_attention`` and B5's plain version with
    the cap, and B5's log-sum-exp against the reference's capped, masked
    scores' logsumexp."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn

    from repro_torch.kernels import ops, ref
    args = _decode_inputs(2)
    want = jattn.decode_attention(*map(jnp.asarray, args),
                                  logit_softcap=CAP, window=window)
    t = list(map(torch.from_numpy, args))
    got = attention.decode_attention(*t, logit_softcap=CAP, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = ref.decode_attention_torch(*t, window=window, softcap=CAP)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)
    _differs(got, attention.decode_attention(*t, window=window))
    q, kc, _, sp, pos = args
    b, h = q.shape[:2]
    s = jnp.einsum("bkgd,bmkd->bkgm", q.reshape(b, KV, h // KV, HD),
                   kc) / np.sqrt(HD)
    s = jattn._softcap(s, CAP)
    valid = (sp >= 0) & (sp <= pos[:, None])
    if window is not None:
        valid &= sp > pos[:, None] - window
    s = jnp.where(valid[:, None, None, :], s, jattn.NEG_INF)
    jlse = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(b, h)
    out, lse = ops.decode_attention(*t, window=window, with_lse=True,
                                    softcap=CAP)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, **TOL)


def test_cross_attention_stays_uncapped():
    """The layers pass the cap to self attention only: whisper's cross
    attention (``layers.cross_attn_forward``) gives the same output with a
    cap set as without, as the reference's (``repro/models/layers.py:
    117-121``) does."""
    from repro_torch import configs
    from repro_torch.models import layers
    cfg = configs.get_reduced_config("whisper-tiny")
    capped = dataclasses.replace(cfg, attn_logit_softcap=CAP)
    gen = torch.Generator().manual_seed(0)
    p = layers.attn_init(gen, cfg, torch.float32, cross=True)
    p = {k: 30.0 * w for k, w in p.items()}  # scores well past the cap
    x = torch.randn(2, 5, cfg.d_model, generator=gen)
    enc = torch.randn(2, 9, cfg.d_model, generator=gen)
    for s in (5, 1):  # B4's path and the decode step's
        assert torch.equal(layers.cross_attn_forward(p, x[:, :s], enc, cfg),
                           layers.cross_attn_forward(p, x[:, :s], enc,
                                                     capped))


# -- the backward ---------------------------------------------------------------


@pytest.mark.parametrize("kv", [4, 2])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_flash_attention_gradients_match_reference_vjp(kv, causal, window):
    """(2, 40, 4, hd 16) with chunk 16, so S pads to 48; MHA and GQA."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    rng = np.random.default_rng(kv)
    q, k, v, dout = (rng.normal(size=shape).astype(np.float32) for shape in
                     ((2, 40, 4, 16), (2, 40, kv, 16), (2, 40, kv, 16),
                      (2, 40, 4, 16)))
    jout, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(
        q, k, v, chunk=16, causal=causal, window=window, logit_softcap=CAP),
        q, k, v)
    want = vjp(jnp.asarray(dout))

    def grads(cap):
        leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        out = attention.flash_attention(*leaves, chunk=16, causal=causal,
                                        window=window, logit_softcap=cap)
        out.backward(torch.tensor(dout))
        return out.detach(), [x.grad for x in leaves]

    out, got = grads(CAP)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")
    _, uncapped = grads(0.0)
    _differs(got[0], uncapped[0])


# -- the flash-decode over a sharded cache --------------------------------------


def _shard_case(name):
    b, w, h, kv, hd = SHARD_SHAPE
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, w, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, w, kv, hd)).astype(np.float32)
    pos = np.array([w - 1, 20, 27], np.int32)
    slot_pos = np.broadcast_to(np.arange(w, dtype=np.int32), (b, w)).copy()
    slot_pos = np.where(slot_pos <= pos[:, None], slot_pos, -1).astype(
        np.int32)
    return dict(q=q, k=k, v=v, slot_pos=slot_pos, pos=pos,
                window=SHARD_CASES[name])


def _rank(job):
    """One rank: the capped flash-decode and its plain version on a (1, 2)
    mesh, the cache's slots split over ``model``, each case with and
    without the cap."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = make_host_mesh(2, device="cpu")
    ctx = sctx.ShardCtx(mesh=mesh, dp_axes=("data",))
    row, blk = (Shard(0), Replicate()), (Shard(0), Shard(1))
    out = {}
    for name, case in job.items():
        def put(key, pl):
            return distribute_tensor(torch.from_numpy(case[key]), mesh, pl,
                                     src_data_rank=None)

        args = (put("q", row), put("k", blk), put("v", blk),
                put("slot_pos", blk), put("pos", (Shard(0), Replicate())))
        res = {}
        with sctx.use_sharding(ctx):
            for cap in (CAP, 0.0):
                got = attention.sharded_decode_attention(
                    *args, window=case["window"], logit_softcap=cap, ctx=ctx)
                plain = attention.sharded_decode_attention_torch(
                    *args, window=case["window"], logit_softcap=cap, ctx=ctx)
                res[cap] = (got.full_tensor(), plain.full_tensor())
        out[name] = res
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """This file as two gloo ranks on the sharded cases; each rank's
    results."""
    tmp = tmp_path_factory.mktemp("softcap_ranks")
    job = tmp / "job.pt"
    torch.save({name: _shard_case(name) for name in SHARD_CASES}, job)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    logs = [tmp / f"rank{r}.log" for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), "--store",
                 str(tmp / "store"), "--job", str(job)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"a rank did not finish within {RANK_TIMEOUT_S} s")
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            f"rank {r} failed:\n{logs[r].read_text()[-4000:]}"
    return [torch.load(tmp / f"rank{r}.out.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("name", sorted(SHARD_CASES))
def test_sharded_flash_decode_matches_reference(name, ranks):
    """Each rank's B5 (its plain version here) with its lse on its half of
    the slots, the cap applied there, then ``combine_partials``: equal to
    the reference's capped ``decode_attention`` on the whole cache, on
    both ranks, for the kernel path and the plain one."""
    import jax.numpy as jnp
    from repro.models import attention as jattn
    c = _shard_case(name)
    args = [jnp.asarray(c[n]) for n in ("q", "k", "v", "slot_pos", "pos")]
    want = np.asarray(jattn.decode_attention(*args, window=c["window"],
                                             logit_softcap=CAP))
    for rank in ranks:
        got, plain = rank[name][CAP]
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(plain.numpy(), want, **TOL)
        _differs(got, rank[name][0.0][0])


# -- the models ------------------------------------------------------------------


#: caps the reduced models' scores exceed at the reference's initial
#: weights: qwen3-4b normalises q and k per head (scores of order 1),
#: hymba does not (scores of order 0.1)
MODEL_CAPS = {"qwen3-4b": 0.5, "hymba-1.5b": 0.02}


def _reference(arch, cap):
    import jax
    from repro import configs as jconfigs
    from repro.checkpoint.checkpointer import _flatten_with_paths
    from repro.models import init_params as j_init_params

    from repro_torch import configs
    from repro_torch.checkpoint import load_reference_lm_params
    from repro_torch.models import lm
    cfg = dataclasses.replace(configs.get_reduced_config(arch),
                              attn_logit_softcap=cap)
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch),
                               attn_logit_softcap=cap)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams)[0]}
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(9))
    load_reference_lm_params(params, flat)
    return cfg, jcfg, jparams, params


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("arch", sorted(MODEL_CAPS))
def test_prefill_and_decode_match_reference(arch):
    """A 40-token prefill (hymba: past its 16-slot window) and three decode
    steps with the cap, logits against the reference's."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm

    from repro_torch.models import lm
    cfg, jcfg, jparams, params = _reference(arch, MODEL_CAPS[arch])
    tokens = _tokens(2, 40)
    jcache, jlogits = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcfg, 1, max_seq=64)
    cache, logits = lm.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               cfg, max_seq=64)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _, uncapped = lm.prefill(params, {"tokens": torch.from_numpy(tokens)},
                             dataclasses.replace(cfg, attn_logit_softcap=0.0),
                             max_seq=64)
    _differs(logits, uncapped, LOGIT_TOL["atol"])
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, c, {"token": t}, jcfg))
    for step, tok in enumerate(_tokens(3, 2, seed=3)):
        jcache, jlogits = jstep(jparams, jcache, jnp.asarray(tok))
        cache, logits = lm.decode_step(params, cache,
                                       {"token": torch.from_numpy(tok)}, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL, err_msg=f"step {step}")


@pytest.mark.parametrize("arch", sorted(MODEL_CAPS))
def test_train_loss_and_gradients_match_reference(arch):
    """``train_loss`` and every leaf's gradient with the cap: B4's op with
    its lse forward, ``flash_bwd`` with the cap backward."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.checkpointer import _flatten_with_paths
    from repro.models import lm as jlm

    from repro_torch.models import lm
    from repro_torch.nn import named_leaves
    cfg, jcfg, jparams, params = _reference(arch, MODEL_CAPS[arch])
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 256, (2, 40)).astype(np.int32),
             "labels": rng.integers(0, 256, (2, 40)).astype(np.int32)}
    (jtotal, _), jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(p, jax.tree.map(jnp.asarray, batch), jcfg),
        has_aux=True)(jparams)
    jflat = {k: np.asarray(v) for k, v in _flatten_with_paths(jgrads)[0]}

    def loss_and_grads(c):
        leaves = named_leaves(params)
        for t in leaves.values():
            t.requires_grad_(True)
        total, _ = lm.train_loss(params, {k: torch.from_numpy(v)
                                          for k, v in batch.items()}, c)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
        return total.detach(), dict(zip(leaves, grads))

    total, grads = loss_and_grads(cfg)
    np.testing.assert_allclose(float(total), float(jtotal), **TOL)
    for key, g in grads.items():
        parts = key.split("/")
        want = (jflat["/".join([parts[0]] + parts[2:])][int(parts[1])]
                if parts[0] == "layers" else jflat[key])
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=key)
    _, uncapped = loss_and_grads(dataclasses.replace(cfg,
                                                     attn_logit_softcap=0.0))
    wq = "layers/0/attn/wq"
    _differs(grads[wq], uncapped[wq], 1e-6)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--job", required=True)
    a = ap.parse_args()
    dist.init_process_group(
        "gloo", store=dist.FileStore(a.store, 2), rank=a.rank, world_size=2,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        result = _rank(torch.load(a.job, weights_only=False))
        torch.save(result, Path(a.job).parent / f"rank{a.rank}.out.pt")
    finally:
        dist.destroy_process_group()
