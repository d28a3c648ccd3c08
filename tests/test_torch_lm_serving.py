"""The port's LM edge server (``serving/batching.py``) and its numpy copy of
``core/state.py`` against the JAX reference, on the CPU.

``core/state.py`` is a copy and must match bit for bit, apart from
``PhiEstimator`` on a history whose least-squares slope is not positive,
where the port fits ``a = 0`` and the reference keeps its previous
coefficients (tested as such). ``LMEdgeBackend``
runs with the reference's own weights, bridged, at reduced olmo-1b,
qwen3-4b, falcon-mamba-7b (SSM), hymba-1.5b (hybrid, a 16-token window)
and mixtral-8x7b (MoE: 4 experts top-2, the capacity dispatch in prefill
and on the lanes' tokens in decode, a 16-token window) in f32 on the
requests of ``tests/test_data_and_batching.py``, in
lockstep with the reference's backend: the same prompts, the same finished
counts, one phi observation per admission, and the same greedy tokens. A
token is held exactly where the reference's top-2 logit gap exceeds 1e-4;
elsewhere the port is teacher-forced with the reference's logits, so one
near-tie cannot fork the two runs. Logits agree to atol 1e-4 at every
prefill and decode step, the final caches' K/V and SSM states to 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_reduced_config as j_reduced
from repro.core import state as jstate
from repro.models import init_params as j_init_params
from repro.serving.batching import LMEdgeBackend as JBackend
from repro_torch.checkpoint import load_reference_lm_params
from repro_torch.configs import get_reduced_config
from repro_torch.core import state
from repro_torch.models import lm
from repro_torch.serving import batching
from repro_torch.serving.batching import LMEdgeBackend

torch.set_num_threads(1)

GAP = 1e-4
REQUESTS = [(8, 4), (12, 3), (5, 6), (20, 2)]  # (prompt_len, gen_len)


def _stream(n=60, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.integers(1, 400, n).astype(float)
    return xs, 0.003 * xs + 0.05 + rng.normal(0, 0.01, n)


@pytest.mark.parametrize("kw", [{}, {"min_samples": 4, "window": 16},
                                {"a": 0.4, "b": 0.1, "frozen": True}])
def test_phi_estimator_copy_matches_bit_for_bit(kw):
    got, want = state.PhiEstimator(**kw), jstate.PhiEstimator(**kw)
    for x, y in zip(*_stream()):
        got.observe(x, y)
        want.observe(x, y)
        assert got.coefficients == want.coefficients
    assert got._xs == want._xs and got._ys == want._ys
    sizes = np.array([1.0, 17.0, 333.0])
    np.testing.assert_array_equal(got(sizes), want(sizes))


# eight hymba-1.5b prefill times (s) over prompt lengths (tokens), read on
# an H100 whose host's kernel launches bounded every one of them: flat in
# the size, with a least-squares slope below zero
FLAT_X = (256.0, 512.0, 1024.0, 1536.0, 2048.0, 2560.0, 768.0, 1280.0)
FLAT_Y = (0.1203, 0.0765, 0.0956, 0.0871, 0.0702, 0.0742, 0.1058, 0.0710)


@pytest.mark.parametrize("case", ["flat", "falling", "fitted_then_flat"])
def test_phi_estimator_fits_zero_slope_where_the_reference_keeps_its_prior(
        case):
    """A history with no positive least-squares slope gives a = 0 and b the
    mean runtime (the least-squares fit with a >= 0). The reference keeps
    its previous coefficients there, the prior a = 1 at first, so a
    dispatch over it sends the edge nothing. Wherever the slope is positive
    the two stay the same bit for bit."""
    got, want = state.PhiEstimator(window=16), jstate.PhiEstimator(window=16)
    if case == "flat":
        xs, ys = FLAT_X, FLAT_Y
    elif case == "falling":
        xs = np.arange(1.0, 13.0) * 200.0
        ys = 0.2 - 1e-5 * xs
    else:  # a positive fit first, then a whole window of flat readings
        x0, y0 = _stream(16, 1)
        xs = np.concatenate([x0, FLAT_X, FLAT_X])
        ys = np.concatenate([y0, FLAT_Y, FLAT_Y])
    accepted = []
    for x, y in zip(xs, ys):
        got.observe(x, y)
        want.observe(x, y)
        n = len(got._xs[-16:])
        if n < got.min_samples:
            assert got.coefficients == want.coefficients == (1.0, 0.0)
            continue
        wx, wy = np.array(got._xs[-16:]), np.array(got._ys[-16:])
        slope = np.polyfit(wx, wy, 1)[0]
        if slope > 0:
            accepted.append(want.coefficients)
            assert got.coefficients == want.coefficients
        else:
            assert got.a == 0.0
            np.testing.assert_allclose(got.b, wy.mean(), rtol=1e-12)
            # the reference: its last accepted fit, else the prior
            assert want.coefficients == (accepted[-1] if accepted
                                         else (1.0, 0.0))
    assert got.a == 0.0 and want.a != 0.0
    if case != "fitted_then_flat":
        assert want.coefficients == (1.0, 0.0)


def _edges(mod, rng):
    edges = []
    for i in range(3):
        phi = mod.PhiEstimator()
        for x, y in zip(*_stream(12, seed=i)):
            phi.observe(x, y)
        e = mod.EdgeServiceState(edge_id=i, coords=(float(i), 1.0 - i),
                                 phi=phi, replicas=i + 1)
        for j in range(4):
            r = mod.QueuedRequest(rid=10 * i + j, data_size=float(5 + j),
                                  source_edge=j % 3)
            (e.q_le if j % 2 else e.q_in).append(r)
        edges.append(e)
    pending = [mod.QueuedRequest(rid=100 + j, data_size=float(rng.integers(
        8, 80)), source_edge=int(rng.integers(0, 3))) for j in range(5)]
    return edges, pending


@pytest.mark.parametrize("pad", [{}, {"q_pad": 4, "z_pad": 8}])
def test_snapshot_instance_copy_matches_bit_for_bit(pad):
    w = np.abs(np.arange(3)[:, None] - np.arange(3)[None]).astype(np.float32)
    got = state.snapshot_instance(*_edges(state, np.random.default_rng(0)),
                                  w * 1e-3, ct=0.5, **pad)
    want = jstate.snapshot_instance(*_edges(jstate, np.random.default_rng(0)),
                                    w * 1e-3, ct=0.5, **pad)
    assert set(got) == set(want)
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _gapped(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return (top[..., 1] - top[..., 0]) > GAP


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-4b", "falcon-mamba-7b",
                                  "hymba-1.5b", "mixtral-8x7b"])
def test_lm_edge_backend_matches_reference(arch, monkeypatch):
    jcfg = j_reduced(arch)
    cfg = get_reduced_config(arch)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(1))
    load_reference_lm_params(params, {k: np.asarray(v) for k, v in
                                      _flatten_with_paths(jparams)[0]})
    ref = JBackend(jcfg, jparams, lanes=2, max_seq=64)
    port = LMEdgeBackend(cfg, params, lanes=2, max_seq=64, device="cpu")

    # record the reference's logits; hand them to the port's steps
    prefills, decodes = [], []
    j_prefill, j_decode = ref._prefill, ref._decode

    def ref_prefill(p, tokens):
        cache, logits = j_prefill(p, tokens)
        prefills.append(np.asarray(logits))
        return cache, logits

    def ref_decode(p, cache, token):
        cache, logits = j_decode(p, cache, token)
        decodes.append(np.asarray(logits))
        return cache, logits

    ref._prefill, ref._decode = ref_prefill, ref_decode
    forced = []

    def teacher(logits, want):
        """Check the port's logits; where the reference's top two are
        within GAP, continue from the reference's."""
        np.testing.assert_allclose(logits.numpy(), want, atol=1e-4, rtol=0)
        keep = torch.from_numpy(_gapped(want))
        forced.append(int((~keep).sum()))
        return torch.where(keep[..., None], logits, torch.tensor(want))

    port_prefill, port_decode = lm.prefill, lm.decode_step
    done = {"prefill": 0, "decode": 0}  # the port's calls so far, in order

    def prefill(*args, **kw):
        cache, logits = port_prefill(*args, **kw)
        done["prefill"] += 1
        return cache, teacher(logits, prefills[done["prefill"] - 1])

    def decode_step(*args, **kw):
        cache, logits = port_decode(*args, **kw)
        done["decode"] += 1
        return cache, teacher(logits, decodes[done["decode"] - 1])

    monkeypatch.setattr(batching.lm, "prefill", prefill)
    monkeypatch.setattr(batching.lm, "decode_step", decode_step)

    for rid, (plen, glen) in enumerate(REQUESTS):
        ref.submit(rid, plen, glen)
        port.submit(rid, plen, glen)
    for (_, jp, _), (_, p, _) in zip(ref._queue, port._queue):
        np.testing.assert_array_equal(p, jp)  # the same prompt stream

    steps = 0
    while ref._queue or any(s.remaining for s in ref._lane_states):
        assert ref.step() == port.step()
        np.testing.assert_array_equal(port._tokens.numpy(),
                                      np.asarray(ref._tokens))
        assert [dataclasses.astuple(s) for s in port._lane_states] == \
            [dataclasses.astuple(s) for s in ref._lane_states]
        steps += 1
    assert not port._queue and steps == len(decodes) == done["decode"]
    assert port.finished == ref.finished == {0: 4, 1: 3, 2: 6, 3: 2}
    assert len(port.phi._xs) == len(prefills) == done["prefill"] == len(
        REQUESTS)
    assert port.phi._xs == ref.phi._xs  # prompt lengths, one per admission
    assert sum(forced) <= 2, forced
    assert set(port._cache) == set(ref._cache)
    assert set(port._cache["layers"]) == set(ref._cache["layers"])
    for key, want in ref._cache["layers"].items():
        np.testing.assert_allclose(port._cache["layers"][key].numpy(),
                                   np.asarray(want), atol=1e-5, rtol=1e-5)
    for key in ("slot_pos", "pos"):
        if key in ref._cache:
            np.testing.assert_array_equal(port._cache[key].numpy(),
                                          np.asarray(ref._cache[key]))


def test_lm_edge_backend_needs_params_on_its_device():
    cfg = get_reduced_config("olmo-1b")
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    be = LMEdgeBackend(cfg, params, lanes=2, max_seq=32, device="cpu")
    be.submit(0, 6, 3)
    be.drain()
    assert be.finished == {0: 3} and len(be.phi._xs) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LMEdgeBackend(cfg, params)


def test_splice_cache_pads_and_crops_the_window():
    cfg = get_reduced_config("qwen3-4b")
    batch = lm.init_cache(cfg, 2, 8)
    one = lm.init_cache(cfg, 1, 5)
    one["layers"]["k"].fill_(1.0)
    one["slot_pos"][:] = torch.arange(5, dtype=torch.int32)
    one["pos"].fill_(5)
    batching._splice_cache(batch, one, 1)
    assert batch["slot_pos"][1].tolist() == [0, 1, 2, 3, 4, -1, -1, -1]
    assert batch["slot_pos"][0].tolist() == [-1] * 8
    assert float(batch["layers"]["k"][:, 1, :5].min()) == 1.0
    assert float(batch["layers"]["k"][:, 1, 5:].abs().max()) == 0.0
    assert batch["pos"].tolist() == [0, 5]
    long = lm.init_cache(cfg, 1, 12)
    long["slot_pos"][:] = torch.arange(12, dtype=torch.int32)
    batching._splice_cache(batch, long, 0)
    assert batch["slot_pos"][0].tolist() == list(range(4, 12))
