"""The port's optimizer (``repro_torch.optim``) against the reference's
``repro.optim`` on the same numpy trees: Adam over several steps with a
constant and a scheduled learning rate and with other betas and eps, the
global norm, the clip (including inf and nan leaves) and both schedules.
Tolerance: rtol 1e-6 (the same f32 formulas, term for term; only the order
of the global-norm sum may differ)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt

torch.set_num_threads(1)

RTOL = 1e-6
SHAPES = {"w": (4, 3), "b": (3,), "layers/0/scale": (5,), "count": ()}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _close(got: dict, want: dict, rtol=RTOL, atol=0.0):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


CONFIGS = {
    "constant": dict(lr=1e-3),
    "betas": dict(lr=3e-4, b1=0.8, b2=0.99, eps=1e-6),
    "cosine": "cosine",
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_adam_matches_reference_over_steps(name):
    if name == "cosine":
        jcfg = jopt.AdamConfig(lr=jopt.warmup_cosine(1e-3, 2, 6))
        tcfg = topt.AdamConfig(lr=topt.warmup_cosine(1e-3, 2, 6))
    else:
        jcfg = jopt.AdamConfig(**CONFIGS[name])
        tcfg = topt.AdamConfig(**CONFIGS[name])
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _torch(params)
    jstate = jopt.adam_init(jp, jcfg)
    tstate = topt.adam_init(tp, tcfg)
    for step in range(5):
        grads = _tree(10 + step, scale=10.0 ** (step - 2))
        jp, jstate = jopt.adam_update(jp, jax.tree.map(jnp.asarray, grads),
                                      jstate, jcfg)
        tstate = topt.adam_update(tp, _torch(grads), tstate, tcfg)
        _close(tp, jp)
        _close(tstate["m"], jstate["m"])
        _close(tstate["v"], jstate["v"])
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        assert tstate["step"].dtype == torch.int32


def test_adam_init_matches_reference():
    """Zero f32 moments keyed by the parameters' paths, step 0 as int32."""
    params = _tree(3)
    jstate = jopt.adam_init(jax.tree.map(jnp.asarray, params), jopt.AdamConfig())
    tstate = topt.adam_init(_torch(params), topt.AdamConfig())
    assert int(tstate["step"]) == int(jstate["step"]) == 0
    assert tstate["step"].dtype == torch.int32
    for part in ("m", "v"):
        _close(tstate[part], jstate[part])
        for k in SHAPES:
            assert tstate[part][k].dtype == torch.float32
            assert tstate[part][k].shape == tuple(jstate[part][k].shape)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_global_norm_and_clip_match_reference(scale):
    tree = _tree(1, scale=scale)
    jt = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(float(topt.global_norm(_torch(tree))),
                               float(jopt.global_norm(jt)), rtol=RTOL)
    for max_norm in (0.5, 1e6):
        got, gnorm = topt.clip_by_global_norm(_torch(tree), max_norm)
        want, wnorm = jopt.clip_by_global_norm(jt, max_norm)
        np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=RTOL)
        _close(got, want)


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_clip_zeroes_the_update_on_a_non_finite_leaf(bad):
    tree = _tree(2)
    tree["w"][1, 2] = bad
    got, gnorm = topt.clip_by_global_norm(_torch(tree), 1.0)
    want, wnorm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    assert not np.isfinite(float(gnorm)) and not np.isfinite(float(wnorm))
    _close(got, want)
    for v in got.values():
        assert float(v.abs().max()) == 0.0 if v.ndim else float(v) == 0.0


def test_schedules_match_reference():
    steps = np.arange(0, 12, dtype=np.int32)
    for jf, tf in ((jopt.constant_lr(3e-4), topt.constant_lr(3e-4)),
                   (jopt.warmup_cosine(1e-3, 3, 10),
                    topt.warmup_cosine(1e-3, 3, 10)),
                   (jopt.warmup_cosine(2e-3, 0, 5, floor_frac=0.0),
                    topt.warmup_cosine(2e-3, 0, 5, floor_frac=0.0))):
        for s in steps:
            got = tf(torch.tensor(s))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(jf(jnp.asarray(s))),
                                       rtol=RTOL)
