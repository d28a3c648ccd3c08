"""The port's LM attention (B4, B5 and ``models.attention``) against the JAX
reference, on the CPU.

The same numpy inputs (from a seed) go through the port's plain versions
(``kernels/ref.py``, which ``kernels/ops.py`` runs for CPU tensors) and
through the reference's oracles (``repro/kernels/ref.py``), its Pallas
kernels in interpret mode (``repro.kernels.ops``; S a multiple of ``bq``,
W of ``bk``) and its model-level ``flash_attention`` (pair scan, ragged S)
and ``decode_attention``. All f32. Tolerances: 1e-5 (atol and rtol) against
the oracles and the model functions, which do the same f32 math in another
order; 2e-4 against interpret-mode Pallas, the reference's own bar
(``tests/test_kernels.py``). The CUDA kernels run only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models import attention

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
PALLAS_TOL = dict(atol=2e-4, rtol=2e-4)
HD = 16
KV = 2
MASKS = [(True, None), (True, 5), (False, None), (False, 7)]


def _qkv(b, s, g, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, KV * g, HD)).astype(np.float32)
    k = rng.normal(size=(b, s, KV, HD)).astype(np.float32)
    v = rng.normal(size=(b, s, KV, HD)).astype(np.float32)
    return q, k, v


def _decode_inputs(g, seed=1, w=24):
    """Three lanes: a partly empty cache (slots past the prompt hold -1), a
    rolling cache (positions 30..53 at their slots p % W), and a full cache
    whose query position is mid-way (slots past ``pos`` are invalid)."""
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


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **tol)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_flash_attention_matches_reference_oracle(g, causal, window):
    q, k, v = _qkv(2, 13, g)
    got = ref.flash_attention_torch(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, window=window)
    want = jref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _close(got, want, TOL)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_flash_attention_matches_pallas_interpret(g, causal, window):
    q, k, v = _qkv(1, 32, g, seed=2)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window)
    want = jops.flash_attention(q, k, v, causal=causal, window=window,
                                bq=16, bk=16)
    _close(got, want, PALLAS_TOL)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("causal,window", MASKS)
def test_model_flash_attention_matches_reference_at_ragged_length(
        g, causal, window):
    """S = 21 is no multiple of the reference's chunk (8): it pads and
    masks; B4 and its plain version take any S."""
    q, k, v = _qkv(2, 21, g, seed=3)
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, window=window)
    want = jattn.flash_attention(q, k, v, chunk=8, causal=causal,
                                 window=window)
    _close(got, want, TOL)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 5])
def test_plain_decode_attention_matches_reference_oracle(g, window):
    inputs = _decode_inputs(g)
    got = ref.decode_attention_torch(*map(torch.from_numpy, inputs),
                                     window=window)
    want = jref.decode_attention_ref(*inputs, window=window)
    _close(got, want, TOL)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 5])
def test_plain_decode_attention_matches_pallas_interpret(g, window):
    inputs = _decode_inputs(g, seed=4)
    got = ops.decode_attention(*map(torch.from_numpy, inputs), window=window)
    want = jops.decode_attention(*inputs, window=window, bk=8)
    _close(got, want, PALLAS_TOL)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 5])
def test_model_decode_attention_matches_reference(g, window):
    inputs = _decode_inputs(g, seed=5, w=20)
    got = attention.decode_attention(*map(torch.from_numpy, inputs),
                                     window=window)
    want = jattn.decode_attention(*inputs, window=window)
    _close(got, want, TOL)


def test_decode_attention_with_no_valid_slot_matches_reference():
    """An empty cache: every score is masked, and the softmax weighs every
    slot alike, as the reference's does."""
    q, kc, vc, slot_pos, pos = _decode_inputs(2, seed=6)
    slot_pos = np.full_like(slot_pos, -1)
    got = ref.decode_attention_torch(
        *map(torch.from_numpy, (q, kc, vc, slot_pos, pos)))
    want = jref.decode_attention_ref(q, kc, vc, slot_pos, pos)
    _close(got, want, TOL)


@pytest.mark.parametrize("causal,window", MASKS)
def test_naive_attention_matches_reference(causal, window):
    q, k, v = _qkv(1, 11, 2, seed=7)
    got = attention.naive_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, window=window)
    want = jattn.naive_attention(q, k, v, causal=causal, window=window)
    _close(got, want, TOL)


def test_bf16_inputs_return_bf16():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 9, 2))
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    want = ref.flash_attention_torch(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), want, atol=2e-2, rtol=2e-2)


def test_softcap_and_cross_lengths_are_not_ported():
    """Both were refused and both are ported. The soft cap: the three
    model functions with a cap of 1.0 (the scores reach 4 here) against
    the reference's at TOL, and not equal to the uncapped ones
    (``tests/test_torch_softcap.py`` holds the rest)."""
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 2))
    jq, jk, jv = (x.numpy() for x in (q, k, v))
    slots = torch.arange(8, dtype=torch.int32)[None]
    pos = torch.full((1,), 7, dtype=torch.int32)
    cases = (
        (lambda c: attention.flash_attention(q, k, v, chunk=4,
                                             logit_softcap=c),
         lambda c: jattn.flash_attention(jq, jk, jv, chunk=4,
                                         logit_softcap=c)),
        (lambda c: attention.naive_attention(q, k, v, logit_softcap=c),
         lambda c: jattn.naive_attention(jq, jk, jv, logit_softcap=c)),
        (lambda c: attention.decode_attention(q[:, 0], k, v, slots, pos,
                                              logit_softcap=c),
         lambda c: jattn.decode_attention(jq[:, 0], jk, jv, slots.numpy(),
                                          pos.numpy(), logit_softcap=c)))
    for port, reference in cases:
        got = port(1.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(reference(1.0)),
                                   **TOL)
        assert float((got - port(0.0)).abs().max()) > 1e-2
    # keys of another length (whisper's cross attention) are ported now
    got = attention.flash_attention(q, k[:, :4], v[:, :4], causal=False)
    want = ref.flash_attention_torch(q, k[:, :4], v[:, :4], causal=False)
    assert got.shape == q.shape
    torch.testing.assert_close(got, want)


def test_cpu_tensors_run_the_plain_versions_without_launches():
    build.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 2))
    ops.flash_attention(q, k, v)
    ops.decode_attention(*map(torch.from_numpy, _decode_inputs(2)))
    assert build.LAUNCHES["flash_attention"] == 0
    assert build.LAUNCHES["decode_attention"] == 0


def test_cuda_wrappers_reject_cpu_and_bad_inputs_before_building():
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_cuda(q.double(), k, v)
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention_cuda(q[:, :, :3], k, v)
    qd, kc, vc, sp, pos = map(torch.from_numpy, _decode_inputs(2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention_cuda(qd, kc, vc, sp, pos)
    with pytest.raises(ValueError, match="window"):
        decode_attention_cuda(qd, kc, vc, sp, pos, window=0)
