"""B4-B6b as ``torch.library`` ops (``torch.ops.repro_torch.*``), on the CPU.

* ``torch.library.opcheck`` on every op, small f32 and bf16 inputs: its
  schema, its fake implementation against the CPU kernel (shapes, dtypes,
  strides), its dispatch under ``make_fx`` and AOT autograd.
* The ops and ``kernels.ops``' wrappers give the plain versions' bits on
  CPU tensors, as the wrappers did before they went through the
  dispatcher (they called the plain versions); and agree with the JAX
  reference's oracles (``repro.kernels.ref``) at 1e-5.
* Each fake implementation, on fake CUDA tensors at the production shapes
  the kernels run on the card (PERF.md's table), gives the shapes and
  dtypes of its plain version's outputs on fake CPU tensors, contiguous as
  the kernels write them; a fake call neither counts a launch nor builds
  a source.
* The operation and byte counts (``kernels/counts.py``) are the formulas
  ``chip_smoke.py``'s bounds were computed with before they moved there,
  and the FLOP formula each op registers is its count.
* B6's plain version stores the state entering each 128-step chunk, the
  state the plain scan reaches after that many steps.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.kernels import ref as jref
from repro_torch.kernels import build, counts, ops, ref
from repro_torch.kernels import decode_attention as b5
from repro_torch.kernels import flash_attention as b4
from repro_torch.kernels import mamba_scan as b6

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _attn(b, s, sk, h, kv, hd, dtype=torch.float32, seed=0):
    g = _gen(seed)
    return [torch.randn(b, n, heads, hd, generator=g).to(dtype)
            for n, heads in ((s, h), (sk, kv), (sk, kv))]


def _cache(b, w, h, kv, hd, dtype=torch.float32, seed=1):
    g = _gen(seed)
    q = torch.randn(b, h, hd, generator=g).to(dtype)
    kc, vc = (torch.randn(b, w, kv, hd, generator=g).to(dtype)
              for _ in range(2))
    slot_pos = torch.arange(w, dtype=torch.int32).expand(b, w).contiguous()
    slot_pos[0, w // 2:] = -1  # a partly filled lane
    pos = torch.full((b,), w - 1, dtype=torch.int32)
    return q, kc, vc, slot_pos, pos


def _scan(b, s, d, n, seed=2):
    g = _gen(seed)
    u = torch.randn(b, s, d, generator=g)
    dt = 0.1 * torch.nn.functional.softplus(torch.randn(b, s, d, generator=g))
    bm, cm = (torch.randn(b, s, n, generator=g) for _ in range(2))
    a = -torch.exp(0.2 * torch.randn(d, n, generator=g))
    return [u, dt, bm, cm, a]


def _gated(b, s, d, n, zdtype=torch.float32, seed=3):
    g = _gen(seed)
    u, dt_raw = (torch.randn(b, s, d, generator=g) for _ in range(2))
    dt_raw[..., ::5] = 25.0  # softplus is the identity above 20
    bias = torch.log(torch.expm1(torch.full((d,), 0.01)))
    bm, cm = (torch.randn(b, s, n, generator=g) for _ in range(2))
    a = -torch.exp(0.2 * torch.randn(d, n, generator=g))
    dskip = 1 + 0.1 * torch.randn(d, generator=g)
    z = torch.randn(b, s, d, generator=g).to(zdtype)
    return [u, dt_raw, bias, bm, cm, a, dskip, z]


def _bwd_args(b, s, d, n, zdtype=torch.float32, with_dh=True):
    args = _gated(b, s, d, n, zdtype)
    _, _, states = ref.mamba_scan_gated_torch(*args, chunk=b6.STATE_CHUNK)
    g = _gen(4)
    dout = torch.randn(b, s, d, generator=g).to(zdtype)
    dh = torch.randn(b, d, n, generator=g) if with_dh else None
    return [*args, states, dout, dh]


OPCHECK = {
    "flash_attention": lambda dt: (b4.flash_attention_op,
                                   (*_attn(2, 5, 7, 4, 2, 16, dt), True, 3)),
    "flash_attention_noncausal": lambda dt: (
        b4.flash_attention_op, (*_attn(1, 4, 9, 2, 2, 16, dt), False, None)),
    "flash_attention_lse": lambda dt: (
        b4.flash_attention_lse_op, (*_attn(2, 6, 6, 4, 1, 16, dt), True,
                                    None)),
    "decode_attention": lambda dt: (b5.decode_attention_op,
                                    (*_cache(2, 9, 4, 2, 8, dt), None)),
    "decode_attention_lse": lambda dt: (b5.decode_attention_lse_op,
                                        (*_cache(2, 9, 4, 2, 8, dt), 4)),
    "mamba_scan": lambda dt: (b6.mamba_scan_op, tuple(_scan(2, 5, 3, 4))),
    "mamba_scan_gated": lambda dt: (b6.mamba_scan_gated_op,
                                    tuple(_gated(2, 5, 3, 4, dt))),
    "mamba_scan_gated_states": lambda dt: (
        b6.mamba_scan_gated_states_op, tuple(_gated(1, 130, 3, 2, dt))),
    "mamba_scan_gated_bwd": lambda dt: (
        b6.mamba_scan_gated_bwd_op, tuple(_bwd_args(2, 5, 3, 4, dt))),
    "mamba_scan_gated_bwd_no_dh": lambda dt: (
        b6.mamba_scan_gated_bwd_op,
        tuple(_bwd_args(1, 130, 3, 2, dt, with_dh=False))),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(OPCHECK))
def test_opcheck(case, dtype):
    op, args = OPCHECK[case](dtype)
    torch.library.opcheck(op, args)


# -- the same bits as the plain versions ------------------------------------


def test_b4_ops_give_the_plain_bits():
    q, k, v = _attn(2, 9, 9, 4, 2, 16)
    for causal, window in ((True, None), (True, 4), (False, None)):
        want = ref.flash_attention_torch(q, k, v, causal=causal,
                                         window=window)
        lse = ref.flash_attention_lse_torch(q, k, causal=causal,
                                            window=window)
        assert torch.equal(ops.flash_attention(q, k, v, causal=causal,
                                               window=window), want)
        out, got_lse = b4.flash_attention_lse_op(q, k, v, causal, window)
        assert torch.equal(out, want) and torch.equal(got_lse, lse)


def test_b4_train_path_gives_the_plain_bits_and_gradients():
    q, k, v = (t.requires_grad_(True) for t in _attn(1, 7, 7, 2, 1, 16))
    out = ops.flash_attention(q, k, v, chunk=4)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), ref.flash_attention_torch(q, k, v))


def test_b5_ops_give_the_plain_bits():
    q, kc, vc, sp, pos = _cache(3, 70, 8, 2, 8)
    for window in (None, 30):
        want = ref.decode_attention_torch(q, kc, vc, sp, pos, window=window)
        lse = ref.decode_attention_lse_torch(q, kc, sp, pos, window=window)
        assert torch.equal(ops.decode_attention(q, kc, vc, sp, pos,
                                                window=window), want)
        out, got = ops.decode_attention(q, kc, vc, sp, pos, window=window,
                                        with_lse=True)
        assert torch.equal(out, want) and torch.equal(got, lse)


def test_b6_ops_give_the_plain_bits():
    args = _scan(2, 33, 6, 4)
    for got, want in zip(ops.mamba_scan(*args), ref.mamba_scan_torch(*args)):
        assert torch.equal(got, want)
    gargs = _gated(2, 33, 6, 4, torch.bfloat16)
    want = ref.mamba_scan_gated_torch(*gargs)
    for got in (ops.mamba_scan_gated(*gargs),
                b6.mamba_scan_gated_states_op(*gargs)[:2]):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_b6b_op_and_the_function_give_the_plain_bits():
    args = _bwd_args(2, 20, 5, 3)
    *fwd, states, dout, dh = args
    want = ref.mamba_scan_gated_bwd_torch(*fwd, dout, dh)
    got = b6.mamba_scan_gated_bwd_op(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    leaves = [t.clone().requires_grad_(True) for t in fwd]
    out, h_last = ops.mamba_scan_gated(*leaves)
    torch.autograd.backward((out, h_last), (dout, dh))
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))


def test_ops_agree_with_the_reference_oracles():
    q, k, v = _attn(2, 12, 12, 4, 2, 16)
    want = jref.flash_attention_ref(*(jnp.asarray(t.numpy())
                                      for t in (q, k, v)), window=5)
    np.testing.assert_allclose(ops.flash_attention(q, k, v, window=5).numpy(),
                               np.asarray(want), **TOL)
    args = _cache(2, 20, 4, 2, 8)
    want = jref.decode_attention_ref(*(jnp.asarray(t.numpy()) for t in args),
                                     window=6)
    np.testing.assert_allclose(
        ops.decode_attention(*args, window=6).numpy(), np.asarray(want),
        **TOL)
    args = _scan(2, 16, 5, 4)
    want = jref.mamba_scan_ref(*(jnp.asarray(t.numpy()) for t in args))
    for got, w in zip(ops.mamba_scan(*args), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


def test_plain_chunk_states_are_the_states_entering_each_chunk():
    args = _gated(1, 300, 4, 3)
    out, h_last, states = ref.mamba_scan_gated_torch(*args, chunk=128)
    assert states.shape == (1, 3, 4, 3)
    assert torch.equal(states[:, 0], torch.zeros(1, 4, 3))
    u, dt_raw, bias, bm, cm, a = args[:6]
    dt = torch.nn.functional.softplus(dt_raw + bias)
    for c in (1, 2):
        t = 128 * c
        _, h = ref.mamba_scan_torch(u[:, :t], dt[:, :t], bm[:, :t],
                                    cm[:, :t], a)
        assert torch.equal(states[:, c], h)
    want = ref.mamba_scan_gated_torch(*args)
    assert torch.equal(out, want[0]) and torch.equal(h_last, want[1])


# -- fake implementations at the production shapes ---------------------------

# (op, plain version, production inputs as (shape, dtype) or a value)
BF, F32, I32 = torch.bfloat16, torch.float32, torch.int32


def _attn_specs(b, s, sk, h, kv, hd):
    return [((b, s, h, hd), BF), ((b, sk, kv, hd), BF), ((b, sk, kv, hd), BF)]


def _cache_specs(b, w, h, kv, hd):
    return [((b, h, hd), BF), ((b, w, kv, hd), BF), ((b, w, kv, hd), BF),
            ((b, w), I32), ((b,), I32)]


def _gated_specs(b, s, d, n, zdtype=BF):
    return [((b, s, d), F32), ((b, s, d), F32), ((d,), F32), ((b, s, n), F32),
            ((b, s, n), F32), ((d, n), F32), ((d,), F32), ((b, s, d), zdtype)]


def _plain_flash(q, k, v, causal, window):
    return ref.flash_attention_torch(q, k, v, causal=causal, window=window)


def _plain_flash_lse(q, k, v, causal, window):
    return (_plain_flash(q, k, v, causal, window),
            ref.flash_attention_lse_torch(q, k, causal=causal,
                                          window=window))


def _plain_decode(q, kc, vc, sp, pos, window):
    return ref.decode_attention_torch(q, kc, vc, sp, pos, window=window)


def _plain_decode_lse(q, kc, vc, sp, pos, window):
    return (_plain_decode(q, kc, vc, sp, pos, window),
            ref.decode_attention_lse_torch(q, kc, sp, pos, window=window))


def _plain_bwd(*args):
    *fwd, _, dout, dh = args
    return ref.mamba_scan_gated_bwd_torch(*fwd, dout, dh)


PRODUCTION = {
    # qwen3-4b's 2048-token prefill; hymba-1.5b's in its 2048 window
    "B4 qwen3-4b": (b4.flash_attention_op, _plain_flash,
                    _attn_specs(1, 2048, 2048, 32, 8, 128) + [True, None]),
    "B4 hymba-1.5b": (b4.flash_attention_op, _plain_flash,
                      _attn_specs(1, 2048, 2048, 25, 5, 64) + [True, 2048]),
    # olmo-1b's training shape, with its lse
    "B4 olmo-1b training": (b4.flash_attention_lse_op, _plain_flash_lse,
                            _attn_specs(8, 1024, 1024, 16, 16, 128)
                            + [True, None]),
    # whisper-tiny's cross attention over the frames
    "B4 whisper-tiny cross": (b4.flash_attention_op, _plain_flash,
                              _attn_specs(8, 4, 1500, 6, 6, 64)
                              + [False, None]),
    # the 4-lane caches: qwen3-4b, hymba-1.5b (window), qwen3's flash-decode
    "B5 qwen3-4b": (b5.decode_attention_op, _plain_decode,
                    _cache_specs(4, 4096, 32, 8, 128) + [None]),
    "B5 hymba-1.5b": (b5.decode_attention_op, _plain_decode,
                      _cache_specs(4, 2048, 25, 5, 64) + [2048]),
    "B5 qwen3-4b with lse": (b5.decode_attention_lse_op, _plain_decode_lse,
                             _cache_specs(4, 2048, 32, 8, 128) + [None]),
    # falcon-mamba-7b's prefill: bare and gated
    "B6 falcon-mamba-7b bare": (
        b6.mamba_scan_op, ref.mamba_scan_torch,
        [((1, 2048, 8192), F32)] * 2 + [((1, 2048, 16), F32)] * 2
        + [((8192, 16), F32)]),
    "B6 falcon-mamba-7b gated": (b6.mamba_scan_gated_op,
                                 ref.mamba_scan_gated_torch,
                                 _gated_specs(1, 2048, 8192, 16)),
    # hymba-1.5b's training shape: B6 storing its states, then B6b
    "B6 hymba-1.5b with states": (
        b6.mamba_scan_gated_states_op,
        lambda *a: ref.mamba_scan_gated_torch(*a, chunk=b6.STATE_CHUNK),
        _gated_specs(8, 1024, 3200, 16)),
    "B6b hymba-1.5b": (
        b6.mamba_scan_gated_bwd_op, _plain_bwd,
        _gated_specs(8, 1024, 3200, 16)
        + [((8, 8, 3200, 16), F32), ((8, 1024, 3200), BF), None]),
}


def _make(specs, device):
    return [torch.empty(s[0], dtype=s[1], device=device)
            if isinstance(s, tuple) and isinstance(s[0], tuple) else s
            for s in specs]


def _outs(outs):
    return outs if isinstance(outs, tuple) else (outs,)


def _meta(outs):
    return [(tuple(t.shape), t.dtype) for t in _outs(outs)]


@pytest.mark.parametrize("name", list(PRODUCTION))
def test_fake_outputs_match_the_plain_version_at_production_shapes(name):
    op, plain, specs = PRODUCTION[name]
    launches = dict(build.LAUNCHES)
    libs = dict(build._LIBS)
    with FakeTensorMode(allow_non_fake_inputs=True):
        got = op(*_make(specs, "cuda"))
        want = plain(*_make(specs, "cpu"))
    assert _meta(got) == _meta(want)
    # laid out as the kernels lay their outputs, on the inputs' card
    assert all(t.is_contiguous() and t.device.type == "cuda"
               for t in _outs(got))
    assert build.LAUNCHES == launches and build._LIBS == libs


# -- the counts ---------------------------------------------------------------


def _old_head(b, q, z, d):
    in_bytes = 4 * (b * q * d + b * z * d + 2 * d * d) + 4 * b * q
    return 2 * b * (q * d * d + d * d * q + z * d * q), in_bytes


@pytest.mark.parametrize("shape", [(1, 100, 1000, 256), (128, 5, 50, 256),
                                   (256, 100, 130, 256), (16, 5, 16, 256)])
def test_head_counts_are_the_bounds_formulas(shape):
    b, q, z, d = shape
    flops, in_bytes = _old_head(b, q, z, d)
    assert counts.policy_score_counts(b, q, z, d) == (
        flops, in_bytes + 4 * b * z * q)
    assert counts.policy_score_counts(b, q, z, d, folded=False) == (
        2 * b * (q * d * d + z * d * d + z * q * d), in_bytes + 4 * b * z * q)
    for k in (1, q):
        assert counts.policy_score_decode_counts(b, q, z, d, k) == (
            flops, in_bytes + 8 * b * z * k)
    b2_bytes = in_bytes + 8 * b * z * q + 4 * (b * q * d + b * z * d
                                               + 2 * d * d)
    assert counts.policy_score_bwd_counts(b, q, z, d) == (
        2 * b * (6 * q * d * d + 3 * z * q * d), b2_bytes)
    assert counts.policy_score_bwd_counts(b, q, z, d, folded=False) == (
        2 * b * (3 * q * d * d + 3 * z * d * d + 3 * z * q * d), b2_bytes)


@pytest.mark.parametrize("case", [
    (1, 2048, 2048, 32, 8, 128, True, None, False),
    (1, 2048, 2048, 25, 5, 64, True, 2048, False),
    (8, 1024, 1024, 16, 16, 128, True, None, True),
    (1, 4500, 4500, 32, 8, 128, True, 4096, False),
    (8, 1500, 1500, 6, 6, 64, False, None, False),
    (16, 448, 1500, 6, 6, 64, False, None, True)])
def test_b4_counts_are_the_bounds_formulas(case):
    b, s, sk, h, kv, hd, causal, window, lse = case
    if causal:
        w = s if window is None else min(window, s)
        pairs = b * (w * (w + 1) // 2 + (s - w) * w)
    else:
        pairs = b * s * sk
    want = (4 * h * hd * pairs,
            2 * (2 * b * s * h * hd + 2 * b * sk * kv * hd)
            + (4 * b * h * s if lse else 0))
    assert counts.flash_attention_counts(b, s, sk, h, kv, hd, causal=causal,
                                         window=window, with_lse=lse) == want


@pytest.mark.parametrize("case", [(4, 4096, 32, 8, 128, 13788),
                                  (4, 2048, 25, 5, 64, 4898),
                                  (8, 1500, 6, 6, 64, 12000)])
def test_b5_counts_are_the_bounds_formulas(case):
    b, w, h, kv, hd, n_valid = case
    base = 2 * n_valid * kv * hd * 2 + 2 * 2 * b * h * hd + 4 * b * w + 4 * b
    assert counts.decode_attention_counts(b, w, h, kv, hd,
                                          n_valid=n_valid) == (
        4 * h * hd * n_valid, base)
    assert counts.decode_attention_counts(b, w, h, kv, hd, n_valid=n_valid,
                                          with_lse=True)[1] == base + 4 * b * h
    # without the data, a filled cache: every slot (or the window) valid
    assert counts.decode_attention_counts(b, w, h, kv, hd, window=100) == \
        counts.decode_attention_counts(b, w, h, kv, hd, n_valid=b * 100)


@pytest.mark.parametrize("shape", [(1, 2048, 8192, 16), (8, 1024, 3200, 16),
                                   (8, 1024, 8192, 16)])
def test_scan_counts_are_the_bounds_formulas(shape):
    b, s, d, n = shape
    chunks = -(-s // 128)
    assert counts.mamba_scan_counts(b, s, d, n) == (
        8 * b * s * d * n,
        4 * (3 * b * s * d + 2 * b * s * n + d * n + b * d * n))
    assert counts.mamba_scan_gated_counts(b, s, d, n) == (
        (8 * n + 9) * b * s * d,
        b * s * d * (4 + 4 + 2 + 2) + 4 * (2 * b * s * n + d * n + 2 * d
                                           + b * d * n))
    assert counts.mamba_scan_gated_counts(b, s, d, n, chunks=chunks) == (
        (8 * n + 9) * b * s * d,
        b * s * d * 12 + 4 * (2 * b * s * n + d * n + 2 * d + b * d * n
                              + b * chunks * d * n))
    assert counts.mamba_scan_gated_bwd_counts(b, s, d, n, chunks) == (
        15 * b * s * d * n + 30 * b * s * d,
        b * s * d * 22 + b * s * n * 16 + 4 * b * chunks * d * n
        + 4 * 2 * (d * n + 2 * d))


def _flops(op, args):
    with FlopCounterMode(display=False) as fc:
        op(*args)
    return fc.get_total_flops()


def test_registered_flop_formulas_are_the_counts():
    q, k, v = _attn(2, 9, 12, 4, 2, 16)
    assert _flops(b4.flash_attention_op, (q, k, v, True, 5)) == \
        counts.flash_attention_counts(2, 9, 12, 4, 2, 16, window=5)[0]
    assert _flops(b4.flash_attention_lse_op, (q, k, v, False, None)) == \
        4 * 4 * 16 * 2 * 9 * 12
    args = _cache(2, 20, 4, 2, 8)
    assert _flops(b5.decode_attention_op, (*args, 6)) == \
        counts.decode_attention_counts(2, 20, 4, 2, 8, window=6)[0]
    assert _flops(b6.mamba_scan_op, _scan(2, 9, 5, 4)) == \
        counts.mamba_scan_counts(2, 9, 5, 4)[0]
    gargs = _gated(2, 9, 5, 4)
    for op in (b6.mamba_scan_gated_op, b6.mamba_scan_gated_states_op):
        assert _flops(op, gargs) == counts.mamba_scan_gated_counts(
            2, 9, 5, 4)[0]
    assert _flops(b6.mamba_scan_gated_bwd_op, _bwd_args(2, 9, 5, 4)) == \
        counts.mamba_scan_gated_bwd_counts(2, 9, 5, 4, 1)[0]


def test_state_chunk_and_window_arguments():
    assert b6.STATE_CHUNK == 128
    assert counts.attention_pairs(1, 10, 10, True, None) == 55
    assert counts.attention_pairs(1, 10, 10, True, 3) == 6 + 7 * 3
    assert counts.attention_pairs(2, 3, 5, False, None) == 30
    assert math.isclose(counts.flash_attention_counts(
        1, 4, 4, 2, 2, 8, itemsize=4)[1], 4 * (2 * 4 * 2 * 8 + 2 * 4 * 2 * 8))
