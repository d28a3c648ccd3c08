"""The port's policy-head kernels against the JAX reference.

On the CPU the port's ops run the plain PyTorch versions; they are held
against the reference's ``ops`` (Pallas in interpret mode) and its
``kernels/ref.py`` oracles on the same numpy inputs. Tolerances: log-probs
and decode values atol 1e-5 (f32, different summation order); indices
exactly, on seeds whose every row has a gap above 1e-5 between consecutive
valid scores of its top K+1 (asserted). The head's backward (B2's plain
version and the ``PolicyScore`` Function) is held against ``jax.vjp`` of the
reference's custom VJP (Pallas interpret) and against autograd through the
plain forward, each gradient to 1e-5 of its largest entry (sums over Z, Q
and d in another order). The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py`` skips without one, and ``chip_smoke.py`` holds
them at full width.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.policy_score import policy_score_fwd as j_policy_score_fwd
from repro_torch.kernels import ops, policy_score, ref

torch.set_num_threads(1)

D = 32
ATOL = 1e-5
GAP = 1e-5
# (valid edges, padded edges): all valid, padded, a single valid edge (the
# fast path's warm-up instance has exactly one)
MASKS = {"full": (5, 5), "padded": (3, 6), "single": (1, 4)}


def _inputs(b, q_valid, q_pad, z, seed=0):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(D)
    c = rng.normal(size=(b, q_pad, D)).astype(np.float32)
    h = rng.normal(size=(b, z, D)).astype(np.float32)
    wx = rng.uniform(-bound, bound, size=(D, D)).astype(np.float32)
    wy = rng.uniform(-bound, bound, size=(D, D)).astype(np.float32)
    mask = np.zeros((b, q_pad), bool)
    mask[:, :q_valid] = True
    if b > 1:  # a different valid set per instance
        mask[1] = np.roll(mask[1], q_pad - q_valid)
    return c, h, wx, wy, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_gapped(scores, mask, k):
    """Every row's top-(k+1) valid scores are separated by more than GAP."""
    s = np.where(mask[:, None, :], scores, -np.inf)
    top = -np.sort(-s, axis=-1)[..., :k + 1]
    n = min(k + 1, int(mask.sum(-1).min()))
    if n > 1:
        assert np.min(top[..., :n - 1] - top[..., 1:n]) > GAP


# Every mask case meets every Z, and each with both batch sizes; each case
# compiles the interpret-mode reference anew, so the sweep is not a full
# product.
CASES = [(b, m, z) for m in MASKS for b, z in ((1, 1), (3, 12), (1, 37))]


@pytest.mark.parametrize("b,mask_case,z", CASES)
def test_policy_score_plain_matches_reference(b, mask_case, z):
    c, h, wx, wy, mask = _inputs(b, *MASKS[mask_case], z)
    want = np.asarray(jops.policy_score(c, h, wx, wy, mask))
    tc, th, twx, twy, tm = _t(c, h, wx, wy, mask)
    got = ops.policy_score(tc, th, twx, twy, tm).numpy()
    assert got.shape == (b, z, mask.shape[1])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    per_inst = np.stack([ref.policy_score_ref(tc[i], th[i], twx, twy, tm[i]).numpy()
                         for i in range(b)])
    np.testing.assert_allclose(per_inst, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,mask_case,z", CASES)
def test_policy_score_decode_plain_matches_reference(b, mask_case, z):
    q_valid, q_pad = MASKS[mask_case]
    c, h, wx, wy, mask = _inputs(b, q_valid, q_pad, z)
    tc, th, twx, twy, tm = _t(c, h, wx, wy, mask)
    lp = np.asarray(jops.policy_score(c, h, wx, wy, mask))
    for normalize in (True, False):
        # Both references emit edges in rank order (running top-k, stable
        # argsort), so their top-k is the first k slots of their top-q_valid.
        ti_p, tv_p = (np.asarray(x) for x in jops.policy_score_decode(
            c, h, wx, wy, mask, k=q_valid, normalize=normalize))
        for k in sorted({1, 3, q_valid}):
            if k > q_valid:
                continue  # slots past the valid edges are undefined upstream
            _assert_gapped(lp, mask, k)
            ti, tv = ops.policy_score_decode(tc, th, twx, twy, tm, k=k,
                                             normalize=normalize)
            assert ti.dtype == torch.int32 and ti.shape == (b, z, k)
            np.testing.assert_array_equal(ti.numpy(), ti_p[..., :k])
            np.testing.assert_allclose(tv.numpy(), tv_p[..., :k], atol=ATOL,
                                       rtol=0)
            ri, rv = zip(*(ref.policy_score_decode_ref(
                tc[i], th[i], twx, twy, tm[i], 10.0, k, normalize)
                for i in range(b)))
            np.testing.assert_array_equal(torch.stack(ri).numpy(), ti_p[..., :k])
            np.testing.assert_allclose(torch.stack(rv).numpy(), tv_p[..., :k],
                                       atol=ATOL, rtol=0)


@pytest.mark.parametrize("normalize", [True, False])
def test_plain_versions_match_reference_oracles(normalize):
    """The port's plain versions against the reference's ``kernels/ref.py``
    oracles (vmapped over the batch), padded mask, top-3."""
    c, h, wx, wy, mask = _inputs(3, 4, 6, 12, seed=1)
    tc, th, twx, twy, tm = _t(c, h, wx, wy, mask)
    oracle = np.asarray(jax.vmap(
        lambda ci, hi, mi: jref.policy_score_ref(ci, hi, wx, wy, mi))(c, h, mask))
    np.testing.assert_allclose(ops.policy_score(tc, th, twx, twy, tm).numpy(),
                               oracle, atol=ATOL, rtol=0)
    _assert_gapped(oracle, mask, 3)
    oi, ov = (np.asarray(x) for x in jax.vmap(
        lambda ci, hi, mi: jref.policy_score_decode_ref(
            ci, hi, wx, wy, mi, 10.0, 3, normalize))(c, h, mask))
    ti, tv = ops.policy_score_decode(tc, th, twx, twy, tm, k=3,
                                     normalize=normalize)
    np.testing.assert_array_equal(ti.numpy(), oi)
    np.testing.assert_allclose(tv.numpy(), ov, atol=ATOL, rtol=0)


def test_decode_ties_go_to_lowest_index():
    """Equal scores rank by edge index in both plain versions, as the
    reference's stable argsort and running top-k do."""
    c = torch.zeros(4, D)  # every score is 0: all edges tie
    h = torch.ones(3, D)
    w = torch.eye(D)
    mask = torch.tensor([True, False, True, True])
    for normalize in (True, False):
        ti, _ = ref.policy_score_decode_torch(c, h, w, w, mask, 10.0, 4,
                                              normalize)
        np.testing.assert_array_equal(ti.numpy(), [[0, 2, 3, 1]] * 3)
        ri, _ = ref.policy_score_decode_ref(c, h, w, w, mask, 10.0, 4,
                                            normalize)
        np.testing.assert_array_equal(ri.numpy(), [[0, 2, 3, 1]] * 3)


def test_unbatched_and_broadcast_mask_shapes():
    c, h, wx, wy, mask = _inputs(1, 3, 6, 12)
    tc, th, twx, twy, tm = _t(c[0], h[0], wx, wy, mask[0])
    lp = ops.policy_score(tc, th, twx, twy, tm)
    assert lp.shape == (12, 6)
    ti, tv = ops.policy_score_decode(tc, th, twx, twy, tm, k=2)
    assert ti.shape == tv.shape == (12, 2)
    want = np.asarray(jops.policy_score(c[0], h[0], wx, wy, mask[0]))
    np.testing.assert_allclose(lp.numpy(), want, atol=ATOL, rtol=0)


def test_cpu_tensors_never_touch_the_kernels():
    """Dispatch is by device: CPU tensors run the plain versions, forward
    and backward, and leave the launch counters at 0; the CUDA wrappers
    refuse CPU tensors."""
    c, h, wx, wy, mask = _t(*_inputs(3, 3, 6, 12))
    policy_score.reset_launch_counts()
    c.requires_grad_(True)
    ops.policy_score(c, h, wx, wy, mask).sum().backward()
    assert c.grad is not None
    c = c.detach()
    ops.policy_score_decode(c, h, wx, wy, mask, k=2, normalize=False)
    assert {"policy_score", "policy_score_bwd",
            "policy_score_decode"} <= set(policy_score.LAUNCHES)
    assert set(policy_score.LAUNCHES.values()) == {0}
    maskf = mask.to(torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        policy_score.policy_score_cuda(c, h, wx, wy, maskf)
    with pytest.raises(ValueError, match="CUDA tensors"):
        policy_score.policy_score_decode_cuda(c, h, wx, wy, maskf, k=1)
    g = torch.zeros(3, 12, 6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        policy_score.policy_score_bwd_cuda(g, g, c, h, wx, wy, maskf)


@pytest.mark.parametrize("q,d", [(129, 32), (5, 513)])
def test_cuda_wrappers_reject_shapes_beyond_the_kernel_limits(q, d):
    c = torch.zeros(1, q, d)
    h = torch.zeros(1, 4, d)
    w = torch.zeros(d, d)
    with pytest.raises(ValueError, match="unsupported shape"):
        policy_score.policy_score_cuda(c, h, w, w, torch.ones(1, q))
    g = torch.zeros(1, 4, q)
    with pytest.raises(ValueError, match="unsupported shape"):
        policy_score.policy_score_bwd_cuda(g, g, c, h, w, w, torch.ones(1, q))


# -- the backward (B2) ---------------------------------------------------------

GRAD_TOL = 1e-5  # of each gradient's largest entry


def _close_rel(got, want, tol=GRAD_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


BWD_CASES = [(1, "full", 1), (3, "padded", 12), (2, "single", 37)]


@pytest.mark.parametrize("b,mask_case,z", BWD_CASES)
def test_backward_matches_reference_vjp_and_autograd(b, mask_case, z):
    """B2's plain version and the PolicyScore Function against jax.vjp of
    the reference's Pallas custom VJP, and against autograd through the
    plain forward, on the same cotangent."""
    c, h, wx, wy, mask = _inputs(b, *MASKS[mask_case], z, seed=3)
    g = np.random.default_rng(4).normal(size=(b, z, mask.shape[1])).astype(
        np.float32)
    out, vjp = jax.vjp(lambda *a: j_policy_score_fwd(*a, mask, interpret=True),
                       c, h, wx, wy)
    want = [np.asarray(x) for x in vjp(g)]

    tc, th, twx, twy, tm, tg = _t(c, h, wx, wy, mask, g)
    maskf = tm.to(torch.float32)
    got = ref.policy_score_bwd_torch(tg, torch.from_numpy(np.array(out)),
                                     tc, th, twx, twy, maskf)
    for x, w in zip(got, want):
        _close_rel(x, w)

    leaves = [t.clone().requires_grad_(True) for t in (tc, th, twx, twy)]
    ops.policy_score(*leaves, tm).backward(tg)
    for x, w in zip(leaves, want):
        _close_rel(x.grad, w)
    leaves = [t.clone().requires_grad_(True) for t in (tc, th, twx, twy)]
    ref.policy_score_torch(*leaves, tm).backward(tg)
    for x, w in zip(leaves, want):
        _close_rel(x.grad, w)


def test_backward_over_any_leading_batch_shape():
    """(2, 3) leading axes flatten to B = 6 and sum the weight gradients
    over all six."""
    c, h, wx, wy, mask = _inputs(6, 3, 6, 12, seed=5)
    tc, th, twx, twy, tm = _t(c, h, wx, wy, mask)
    leaves = [tc.reshape(2, 3, 6, D), th.reshape(2, 3, 12, D), twx, twy]
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    out = ops.policy_score(*leaves, tm.reshape(2, 3, 6))
    assert out.shape == (2, 3, 12, 6)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(g)
    flat = [t.clone().requires_grad_(True) for t in (tc, th, twx, twy)]
    ref.policy_score_torch(*flat, tm).backward(g.reshape(6, 12, 6))
    for x, w in zip(leaves, flat):
        _close_rel(x.grad.reshape(w.grad.shape), w.grad.numpy())


def test_policy_score_function_gradcheck_f64():
    """torch.autograd.gradcheck on the Function in f64. Masked entries of
    the output sit at -1e9 - lse, which central differences cannot resolve
    in f64, so the checked function zeroes them."""
    gen = torch.Generator().manual_seed(0)
    c, h = torch.randn(2, 4, 6, generator=gen), torch.randn(2, 5, 6, generator=gen)
    wx, wy = torch.randn(6, 6, generator=gen), torch.randn(6, 6, generator=gen)
    maskf = torch.tensor([[1., 1., 0., 1.], [0., 1., 1., 1.]])
    leaves = [t.double().requires_grad_(True) for t in (c, h, wx, wy)]

    def fn(*a):
        return ops.PolicyScore.apply(*a, maskf, 10.0) * maskf[:, None, :]

    assert torch.autograd.gradcheck(fn, leaves)
