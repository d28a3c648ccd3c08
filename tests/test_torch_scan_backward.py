"""The backward of B6's gated entry (the SSM block's tail: dt's softplus, the
selective scan, the D skip and the SiLU gate) on the CPU: B6b's plain
version ``kernels/ref.py::mamba_scan_gated_bwd_torch``, the autograd
Function ``kernels/ops.py::MambaScanGated`` that carries it, and the SSM
block's parameter gradients, against autograd through the plain forward
and against the JAX reference.

The same numpy inputs (from a seed) go through the port and through the
reference: ``jax.vjp`` of the reference's chunked scan
(``repro.models.ssm.ssm_scan``, S a multiple of its chunk) followed by the
tail of its ``ssm_apply`` (``repro/models/ssm.py:114-120``), and
``jax.grad`` of its ``ssm_apply`` for reduced falcon-mamba-7b and
hymba-1.5b. Tolerances, of each gradient's largest |entry|: 1e-5 against
autograd through the same f32 ops; 1e-4 against the reference, whose
associative scan sums in another order; a bf16 dz within one bf16 ulp
(2^-8), where the two f32 values may round apart. Some dt_raw + dt_bias
lie above 20, where F.softplus is the identity and its derivative 1. The
kernel B6b itself runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm

torch.set_num_threads(1)

NAMES = ("u", "dt_raw", "dt_bias", "B_mat", "C_mat", "A", "D", "z")
BF16_ULP = 2.0 ** -8


def _inputs(b, s, d, n, *, seed=0):
    """u normal; dt_raw 0.5 * normal with every 5th channel at 30 (with
    dt_bias in [-6.9, -2.3], above softplus's threshold); dt_bias the
    inverse softplus of a dt in [1e-3, 0.1] (the model's initialisation);
    B, C normal; A = -exp(0.2 * normal); D near 1; z, dout and dh_last
    normal, f32 (``_torch`` casts z and dout)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    dt_raw = 0.5 * normal(b, s, d)
    dt_raw[..., ::5] = 30.0
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), size=d))
    bias = (dt0 + np.log(-np.expm1(-dt0))).astype(np.float32)
    a = (-np.exp(0.2 * normal(d, n))).astype(np.float32)
    args = [normal(b, s, d), dt_raw, bias, normal(b, s, n), normal(b, s, n),
            a, (1 + 0.1 * normal(d)).astype(np.float32), normal(b, s, d)]
    return args, normal(b, s, d), normal(b, d, n)


def _torch(args, dout, zdtype):
    """The inputs as torch tensors, z and dout in ``zdtype``."""
    t = [torch.from_numpy(x) for x in args]
    t[-1] = t[-1].to(zdtype)
    return t, torch.from_numpy(dout).to(zdtype)


def _close(name, got, want, tol):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, name
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()) + 1e-30, (name, err)


def _check(got, want, tol, zdtype):
    for name, g, w in zip(NAMES, got, want):
        bf16 = name == "z" and zdtype == torch.bfloat16
        _close(f"d{name}", g, w, BF16_ULP if bf16 else tol)


def _autograd(args, dout, dh_last):
    """Gradients of (out, h_last) by autograd through the plain forward."""
    leaves = [x.clone().requires_grad_(True) for x in args]
    out, h_last = ref.mamba_scan_gated_torch(*leaves)
    cot = [dout, torch.zeros_like(h_last) if dh_last is None else dh_last]
    torch.autograd.backward([out, h_last], cot)
    return [x.grad for x in leaves]


def _jax_vjp(args, dout, dh_last, chunk, zdtype):
    """The reference's chunked scan and its ssm_apply tail, differentiated
    with ``jax.vjp`` at the cotangents (dout, dh_last)."""
    jdt = jnp.bfloat16 if zdtype == torch.bfloat16 else jnp.float32

    def tail(u, dt_raw, dt_bias, bm, cm, a, dskip, z):
        dt = jax.nn.softplus(dt_raw + dt_bias)
        y, h_last = jssm.ssm_scan(u, dt, bm, cm, a, chunk=chunk)
        y = y + dskip * u
        y = y * jax.nn.silu(z.astype(jnp.float32))
        return y.astype(z.dtype), h_last

    jargs = [jnp.asarray(x) for x in args]
    jargs[-1] = jargs[-1].astype(jdt)
    _, vjp = jax.vjp(tail, *jargs)
    dh = (jnp.zeros(args[3].shape[:1] + args[5].shape, jnp.float32)
          if dh_last is None else jnp.asarray(dh_last))
    grads = vjp((jnp.asarray(dout).astype(jdt), dh))
    return [torch.from_numpy(np.array(g.astype(jnp.float32)))
            for g in grads]


CASES = [((2, 37, 24, 4), None), ((1, 64, 16, 16), 16), ((2, 48, 20, 4), 48)]


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("zdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,chunk", CASES)
def test_plain_backward_matches_autograd(shape, chunk, zdtype, seeded):
    """B6b's plain version against autograd through the plain forward
    (1e-5 of each gradient's largest entry), dz in z's dtype."""
    args, dout, dh = _inputs(*shape, seed=sum(shape))
    targs, tdout = _torch(args, dout, zdtype)
    dh_last = torch.from_numpy(dh) if seeded else None
    got = ref.mamba_scan_gated_bwd_torch(*targs, tdout, dh_last)
    assert got[-1].dtype == zdtype
    assert all(g.dtype == torch.float32 for g in got[:-1])
    _check(got, _autograd(targs, tdout, dh_last), 1e-5, zdtype)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("zdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,chunk", [c for c in CASES if c[1]])
def test_plain_backward_matches_reference_vjp(shape, chunk, zdtype, seeded):
    """B6b's plain version against ``jax.vjp`` of the reference's chunked
    scan and tail at a chunk that divides S (1e-4)."""
    args, dout, dh = _inputs(*shape, seed=sum(shape))
    targs, tdout = _torch(args, dout, zdtype)
    dh_last = torch.from_numpy(dh) if seeded else None
    got = ref.mamba_scan_gated_bwd_torch(*targs, tdout, dh_last)
    want = _jax_vjp(args, np.asarray(tdout.float()), dh if seeded else None,
                    chunk, zdtype)
    _check(got, want, 1e-4, zdtype)


def test_softplus_threshold_passes_the_gradient_through():
    """Where dt_raw + dt_bias is above 20, d dt_raw equals ddt (F.softplus's
    derivative is 1 there); the threshold rows are in every case above."""
    args, dout, _ = _inputs(1, 9, 10, 4, seed=5)
    targs, tdout = _torch(args, dout, torch.float32)
    x = targs[1] + targs[2]
    assert bool((x[..., ::5] > 20).all()) and bool((x[..., 1::5] < 20).all())
    got = _autograd(targs, tdout, None)
    plain = ref.mamba_scan_gated_bwd_torch(*targs, tdout)
    # above the threshold: autograd's F.softplus backward passes ddt as is
    _close("ddt_raw above 20", plain[1][..., ::5], got[1][..., ::5], 1e-5)
    assert bool((plain[1][..., ::5] != 0).all())


@pytest.mark.parametrize("zdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_h_last", [False, True])
def test_function_on_the_cpu_matches_plain_and_reference(zdtype, use_h_last):
    """``ops.mamba_scan_gated`` (``MambaScanGated``) on CPU tensors that
    need a gradient: its output is the plain forward's; its gradients are
    the plain backward's bit for bit, and the reference's ``jax.vjp``'s
    within 1e-4; h_last's gradient is used or left unused."""
    shape, chunk = (2, 64, 24, 4), 16
    args, dout, dh = _inputs(*shape, seed=11)
    targs, tdout = _torch(args, dout, zdtype)
    leaves = [x.clone().requires_grad_(True) for x in targs]
    out, h_last = ops.mamba_scan_gated(*leaves)
    want_out, want_h = ref.mamba_scan_gated_torch(*targs)
    assert torch.equal(out, want_out) and torch.equal(h_last, want_h)
    assert type(out.grad_fn).__name__ == "MambaScanGatedBackward"
    dh_last = torch.from_numpy(dh) if use_h_last else None
    if use_h_last:
        torch.autograd.backward([out, h_last], [tdout, dh_last])
    else:
        out.backward(tdout)
    got = [x.grad for x in leaves]
    plain = ref.mamba_scan_gated_bwd_torch(*targs, tdout, dh_last)
    for name, g, p in zip(NAMES, got, plain):
        assert torch.equal(g, p), name
    want = _jax_vjp(args, np.asarray(tdout.float()),
                    dh if use_h_last else None, chunk, zdtype)
    _check(got, want, 1e-4, zdtype)


def test_function_saves_nothing_without_a_gradient():
    """Serving's call: no input needs a gradient (or grad mode is off), so
    the output carries no graph."""
    args, _, _ = _inputs(1, 9, 8, 4, seed=2)
    targs, _ = _torch(args, args[0], torch.float32)
    out, h_last = ops.mamba_scan_gated(*targs)
    assert out.grad_fn is None and h_last.grad_fn is None
    with torch.no_grad():
        out, _ = ops.mamba_scan_gated(*[x.requires_grad_(True)
                                        for x in targs])
    assert out.grad_fn is None


def _block(arch, seed):
    """One SSM block of a reduced config with the reference's initial
    weights, bridged; the conv and the projections scaled up 10x from their
    init (std 0.02) so that the state, y and the gate are of order 1."""
    cfg = configs.get_reduced_config(arch)
    jcfg = jconfigs.get_reduced_config(arch)
    jp = jssm.ssm_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    jp = {k: v * 10.0 if k in ("conv_w", "in_proj", "x_proj", "out_proj")
          else v for k, v in jp.items()}
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, jcfg, p, jp


@pytest.mark.parametrize("s", [40, 512])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_apply_gradients_match_reference(arch, s):
    """The block's parameter and input gradients of sum(out * w) through
    ``MambaScanGated`` against ``jax.grad`` of the reference's
    ``ssm_apply`` (1e-4 of each gradient's largest entry); 512 spans two of
    the reference's 256-step chunks."""
    cfg, jcfg, p, jp = _block(arch, seed=s)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)

    def jloss(jp, x):
        out, _ = jssm.ssm_apply(jp, x, jcfg)
        return jnp.sum(out * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = ssm.ssm_apply(leaves, tx, cfg)
    (out * torch.from_numpy(w)).sum().backward()
    assert set(leaves) == set(jgp)
    for key, leaf in leaves.items():
        _close(key, leaf.grad, torch.from_numpy(np.asarray(jgp[key])), 1e-4)
    _close("x", tx.grad, torch.from_numpy(np.asarray(jgx)), 1e-4)
