"""B4b, the training attention's backward (``csrc/flash_attention_bwd.cu``),
on a card, against its plain version (the pair-scan).

Every test needs an NVIDIA GPU (``cuda`` marker) and skips without one. The
file imports neither jax nor the reference:

    PYTHONPATH=src python -m pytest -m cuda \
        tests/test_torch_cuda_attention_bwd.py

B4's forward with its log-sum-exp gives the residuals; B4b's gradients are
held against ``ref.flash_attention_bwd_torch`` on the same residuals and
cotangent (its chunk at least Sq, so that one block holds all of Sq), each
within ``ATTN_BWD_TOL`` of the gradient's largest |entry| (f32: sums in
another order; bf16: P and dS carried as hi + lo bf16 terms, the
gradients rounded to bf16), and two calls must give the same bits. In
bf16 the split itself is held too: the gradients stay within
``SPLIT_TOL`` (relative norm) of the bf16 rounding of the pair-scan in f32
on the same bf16 values, which P and dS rounded once to bf16 exceed.
"""
import pytest
import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

pytestmark = pytest.mark.cuda

ATTN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}
SPLIT_TOL = 1e-3
BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _residuals(device, b, sq, sk, h, kv, hd, dtype, causal, window, cap,
               seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(b, n, m, hd, generator=gen).to(device, dtype)
                     for n, m in ((sq, h), (sk, kv), (sk, kv), (sq, h)))
    out, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, causal,
                                                          window, cap)
    return q, k, v, out, lse, dout


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,dtype,causal,window,cap", [
    (2, 256, 256, 8, 8, 128, BF16, True, None, 0.0),
    (2, 256, 256, 8, 8, 128, F32, True, None, 0.0),
    (2, 200, 200, 5, 1, 64, BF16, True, 70, 0.0),
    (2, 130, 300, 6, 6, 64, BF16, False, None, 0.0),
    (1, 97, 97, 4, 2, 80, BF16, True, 33, 30.0),
    (1, 97, 97, 4, 2, 32, F32, True, 33, 30.0),
    (2, 200, 70, 4, 1, 64, BF16, True, 40, 0.0),
    (1, 64, 50, 2, 1, 64, F32, True, 14, 0.0),
    (2, 130, 130, 4, 2, 16, BF16, False, 20, 0.0),
    # the wgmma plan (hd 64 and 128): whisper's ragged cross attention, GQA
    # of five heads with a window, the cap, rows with no allowed column;
    # the kept mma.sync plan at hd 32
    (2, 448, 1500, 6, 6, 64, BF16, False, None, 0.0),
    (1, 448, 1500, 4, 4, 128, BF16, False, None, 0.0),
    (2, 300, 300, 10, 2, 64, BF16, True, 70, 0.0),
    (1, 300, 300, 10, 2, 128, BF16, True, 100, 0.0),
    (1, 200, 200, 4, 2, 64, BF16, True, None, 30.0),
    (1, 256, 256, 4, 4, 128, BF16, True, None, 50.0),
    (1, 64, 50, 2, 1, 64, BF16, True, 14, 0.0),
    (1, 200, 70, 4, 1, 128, BF16, True, 40, 0.0),
    (2, 130, 200, 4, 2, 32, BF16, True, None, 0.0),
    (1, 64, 50, 2, 1, 32, BF16, True, 14, 0.0),
])
def test_kernel_matches_the_pair_scan(cuda_device, b, sq, sk, h, kv, hd,
                                      dtype, causal, window, cap):
    q, k, v, out, lse, dout = _residuals(cuda_device, b, sq, sk, h, kv, hd,
                                         dtype, causal, window, cap)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    again = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    want = ref.flash_attention_bwd_torch(q, k, v, out, lse, dout,
                                         chunk=max(512, sq), **kw)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.equal(g, a), f"{name}: two calls differ"
        err = float((g.float() - w.float()).abs().max())
        assert err <= ATTN_BWD_TOL[dtype] * float(w.float().abs().max()), \
            f"{name}: {err}"


@pytest.mark.parametrize("hd", [32, 64, 80, 128])
def test_an_empty_row_adds_its_dout_to_every_key(cuda_device, hd):
    """Row Sk + window - 1 = Sq - 1 sees no key: lse -1e30, p = 1 at every
    key. Zeroing its dout takes exactly that dout, summed over the G heads,
    off every dv[c] (to the bf16 rounding of dv), and changes neither dq's
    other rows nor dk beyond it."""
    b, sq, sk, h, kv, window = 1, 64, 50, 4, 2, 14
    q, k, v, out, lse, dout = _residuals(cuda_device, b, sq, sk, h, kv, hd,
                                         BF16, True, window, 0.0)
    row = sk + window - 1
    empty = torch.tensor(-1e30).item()  # f32 lse of a row with no column
    assert row == sq - 1 and float(lse[0, 0, row]) == empty
    quiet = dout.clone()
    quiet[:, row] = 0
    dq1, dk1, dv1 = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                             window=window)
    dq0, dk0, dv0 = flash_attention_bwd_cuda(q, k, v, out, lse, quiet,
                                             window=window)
    assert float(dq1[:, row].float().abs().max()) == 0.0
    added = dout[:, row].float().reshape(b, kv, h // kv, hd).sum(2)
    bar = ATTN_BWD_TOL[BF16] * float(dv1.float().abs().max())
    err = float((dv1.float() - dv0.float() - added[:, None]).abs().max())
    assert err <= bar, err
    assert float((dk1.float() - dk0.float()).abs().max()) <= \
        ATTN_BWD_TOL[BF16] * float(dk1.float().abs().max())


def split_err(g, w32):
    """|g - bf16(w32)| / |w32| over the whole gradient (Frobenius)."""
    w = w32.float()
    return float((g.float() - w.to(BF16).float()).norm() / w.norm())


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,window,cap", [
    (2, 256, 256, 8, 8, 128, True, None, 0.0),
    (2, 300, 300, 10, 2, 64, True, 70, 0.0),
    (1, 448, 1500, 4, 4, 64, False, None, 0.0),
    (1, 256, 256, 4, 4, 128, True, None, 50.0),
    (2, 130, 200, 4, 2, 32, True, None, 0.0),
])
def test_the_split_keeps_the_f32_probabilities(cuda_device, b, sq, sk, h, kv,
                                               hd, causal, window, cap):
    """P and dS enter dV, dQ and dK as hi + lo bf16 terms: each bf16
    gradient stays within SPLIT_TOL of the bf16 rounding of the pair-scan
    in f32 on the same bf16 residuals; P and dS as one bf16 term miss it."""
    q, k, v, out, lse, dout = _residuals(cuda_device, b, sq, sk, h, kv, hd,
                                         BF16, causal, window, cap)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = ref.flash_attention_bwd_torch(
            q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
            chunk=max(512, sq), **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert split_err(g, w) <= SPLIT_TOL, (name, split_err(g, w))


def test_flash_attention_trains_through_b4b(cuda_device):
    """``ops.flash_attention``'s backward on CUDA tensors launches B4b once
    and never the plain pair-scan."""
    q, k, v, _, _, dout = _residuals(cuda_device, 1, 128, 128, 4, 2, 64,
                                     BF16, True, None, 0.0)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = build.LAUNCHES["flash_attention_bwd"]
    real = ref.flash_attention_bwd_torch
    ref.flash_attention_bwd_torch = None  # any call raises
    try:
        ops.flash_attention(*leaves).backward(dout)
    finally:
        ref.flash_attention_bwd_torch = real
    assert build.LAUNCHES["flash_attention_bwd"] - before == 1
    assert all(x.grad is not None and x.grad.dtype == BF16 for x in leaves)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q, k, v, out, lse, dout = _residuals(cuda_device, 1, 64, 64, 2, 2, 64,
                                         BF16, True, None, 0.0)
    with pytest.raises(TypeError):
        flash_attention_bwd_cuda(q.half(), k.half(), v.half(), out.half(),
                                 lse, dout.half())
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, k, v, out, lse.transpose(1, 2), dout)
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, k, v, out, lse, dout[:, :32])
