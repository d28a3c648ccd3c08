"""The port's Adafactor and Adam's weight decay and moment dtype
(``repro_torch.optim``) against the reference's ``repro.optim`` on the same
numpy trees, over three steps.

Adafactor's leaves: factored (both trailing dims at least 128), a 3-D
factored one, unfactored 2-D and 1-D ones, a scalar, and an LM layer leaf
held per layer in the port (``layers/<i>/w``) and stacked on a leading L
axis in the reference, whose RMS clip and parameter scale are taken over
all layers at once. Tolerance: 1e-6 relative to each entry plus 1e-6 of
the leaf's largest |entry| (the same f32 formulas, term for term; the
means over a stacked leaf are summed per layer here, and an update that
cancels a parameter to near 0 keeps only the absolute error); bf16
parameters and moments within one bf16 ulp (2^-7 relative) plus the same
1e-6 of the leaf's largest |entry|: one rounding of f32 values that agree
to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch.optim.adafactor import stack_key

torch.set_num_threads(1)

RTOL = 1e-6
SHAPES = {"w": (130, 200), "e": (2, 128, 160), "small": (40, 7),
          "b": (300,), "s": ()}
LAYERS = 3
LAYER_SHAPES = {"w": (128, 144), "norm": (64,)}


def _trees(seed, scale=1.0):
    """(port tree, reference tree) of the same numbers: the reference's
    layer leaves stacked on a leading L axis."""
    rng = np.random.default_rng(seed)
    port = {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}
    ref = dict(port)
    for name, shape in LAYER_SHAPES.items():
        stacked = (scale * rng.normal(size=(LAYERS, *shape))).astype(np.float32)
        ref[f"layers/{name}"] = stacked
        for i in range(LAYERS):
            port[f"layers/{i}/{name}"] = stacked[i]
    return port, ref


def _stack(port: dict) -> dict:
    out = {}
    for key, v in port.items():
        out.setdefault(stack_key(key), []).append(np.asarray(v))
    return {k: vs[0] if len(vs) == 1 and "layers/" not in k else np.stack(vs)
            for k, vs in out.items()}


def _close(got: dict, want: dict, rtol=RTOL):
    """Entries within ``rtol`` relative plus RTOL of the leaf's largest."""
    assert set(got) == set(want)
    for k in want:
        got_k = np.asarray(got[k], np.float32)
        want_k = np.asarray(want[k]).astype(np.float32)
        atol = RTOL * float(np.abs(want_k).max()) if want_k.size else 0.0
        np.testing.assert_allclose(got_k, want_k, rtol=rtol, atol=atol,
                                   err_msg=k)


BF16_RTOL = 2 ** -7


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adafactor_matches_reference_over_steps(weight_decay):
    jcfg = jopt.AdafactorConfig(lr=1e-2, weight_decay=weight_decay)
    tcfg = topt.AdafactorConfig(lr=1e-2, weight_decay=weight_decay)
    port, ref = _trees(0)
    tp = {k: torch.tensor(v) for k, v in port.items()}
    jp = {k: jnp.asarray(v) for k, v in ref.items()}
    jstate = jopt.adafactor_init(jp, jcfg)
    tstate = topt.adafactor_init(tp, tcfg)
    assert {k: set(s) for k, s in tstate["v"].items()
            if not k.startswith("layers/")} == {
        k: set(s) for k, s in jstate["v"].items() if "/" not in k}
    assert set(tstate["v"]["w"]) == {"vr", "vc"}
    assert set(tstate["v"]["small"]) == {"v"}
    for step in range(3):
        gport, gref = _trees(10 + step, scale=10.0 ** (step - 1))
        jp, jstate = jopt.adafactor_update(
            jp, {k: jnp.asarray(v) for k, v in gref.items()}, jstate, jcfg)
        tstate = topt.adafactor_update(
            tp, {k: torch.tensor(v) for k, v in gport.items()}, tstate, tcfg)
        _close(_stack({k: t.numpy() for k, t in tp.items()}), jp)
        for slot in ("vr", "vc", "v"):
            got = _stack({k: s[slot].numpy() for k, s in tstate["v"].items()
                          if slot in s})
            want = {k: s[slot] for k, s in jstate["v"].items() if slot in s}
            _close(got, want)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1


def test_adafactor_scheduled_lr_and_bf16_parameters():
    """A callable lr, and bf16 parameters updated in f32 and cast back."""
    sched = dict(peak=1e-2, warmup_steps=2, total_steps=6)
    jcfg = jopt.AdafactorConfig(lr=jopt.warmup_cosine(**sched))
    tcfg = topt.AdafactorConfig(lr=topt.warmup_cosine(**sched))
    rng = np.random.default_rng(3)
    p = rng.normal(size=(128, 136)).astype(np.float32)
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    tp = {"w": torch.tensor(p).to(torch.bfloat16)}
    jstate, tstate = jopt.adafactor_init(jp, jcfg), topt.adafactor_init(tp, tcfg)
    for step in range(3):
        g = rng.normal(size=p.shape).astype(np.float32)
        jp, jstate = jopt.adafactor_update(jp, {"w": jnp.asarray(g)}, jstate,
                                           jcfg)
        tstate = topt.adafactor_update(tp, {"w": torch.tensor(g)}, tstate,
                                       tcfg)
        _close({"w": tp["w"].float().numpy()}, jp, rtol=BF16_RTOL)
        _close({"vr": tstate["v"]["w"]["vr"].numpy()},
               {"vr": jstate["v"]["w"]["vr"]})


def test_adafactor_refuses_a_stacked_1d_leaf_the_reference_factors():
    """Once refused, now factored as the reference factors it: 128
    per-layer 1-D leaves of width 128 are the reference's stacked (128,
    128) leaf, one slot {"vr" (128,), "vc" (128,)} under the stacked path,
    over three updates against ``repro.optim.adafactor`` (with a 2-D
    factored leaf and a short stack of 1-D leaves beside it, unfactored
    per layer), at this file's bars."""
    layers, width = 128, 128
    rng = np.random.default_rng(5)
    stacked = rng.normal(size=(layers, width)).astype(np.float32)
    short = rng.normal(size=(3, 130)).astype(np.float32)
    w = rng.normal(size=(128, 136)).astype(np.float32)
    ref = {"layers/norm": stacked, "enc_layers/scale": short, "w": w}
    port = {"w": w, **{f"layers/{i}/norm": stacked[i] for i in range(layers)},
            **{f"enc_layers/{i}/scale": short[i] for i in range(3)}}
    jcfg, tcfg = jopt.AdafactorConfig(lr=1e-2), topt.AdafactorConfig(lr=1e-2)
    jp = {k: jnp.asarray(v) for k, v in ref.items()}
    tp = {k: torch.tensor(v) for k, v in port.items()}
    jstate, tstate = jopt.adafactor_init(jp, jcfg), topt.adafactor_init(tp,
                                                                        tcfg)
    assert {k: {n: tuple(v.shape) for n, v in slot.items()}
            for k, slot in tstate["v"].items()
            if k.startswith("layers")} == {
        "layers/norm": {"vr": (layers,), "vc": (width,)}}
    assert set(tstate["v"]["enc_layers/1/scale"]) == {"v"}
    for step in range(3):
        g = {k: (10.0 ** (step - 1) * rng.normal(size=v.shape)).astype(
            np.float32) for k, v in ref.items()}
        gport = {"w": g["w"],
                 **{f"layers/{i}/norm": g["layers/norm"][i]
                    for i in range(layers)},
                 **{f"enc_layers/{i}/scale": g["enc_layers/scale"][i]
                    for i in range(3)}}
        jp, jstate = jopt.adafactor_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate, jcfg)
        tstate = topt.adafactor_update(
            tp, {k: torch.tensor(v) for k, v in gport.items()}, tstate, tcfg)
        _close(_stack({k: t.numpy() for k, t in tp.items()}), jp)
        for slot in ("vr", "vc"):
            _close({k: s[slot].numpy() for k, s in tstate["v"].items()
                    if slot in s},
                   {k: s[slot] for k, s in jstate["v"].items() if slot in s})
        _close(_stack({k: s["v"].numpy() for k, s in tstate["v"].items()
                       if "v" in s}),
               {k: s["v"] for k, s in jstate["v"].items() if "v" in s})
    # the training checkpoint's leaves are the reference's, shape for shape
    from repro.checkpoint.checkpointer import _flatten_with_paths
    from repro_torch.checkpoint import lm_train_tree
    flat = lm_train_tree(tp, tstate)
    want = dict(_flatten_with_paths({"params": jp, "opt_state": jstate})[0])
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adam_weight_decay_and_moment_dtype_match_reference(moment_dtype):
    jcfg = jopt.AdamConfig(lr=1e-2, weight_decay=0.1,
                           moment_dtype=getattr(jnp, moment_dtype))
    tcfg = topt.AdamConfig(lr=1e-2, weight_decay=0.1,
                           moment_dtype=getattr(torch, moment_dtype))
    port, _ = _trees(1)
    jp = {k: jnp.asarray(v) for k, v in port.items()}
    tp = {k: torch.tensor(v) for k, v in port.items()}
    jstate, tstate = jopt.adam_init(jp, jcfg), topt.adam_init(tp, tcfg)
    assert all(m.dtype == getattr(torch, moment_dtype)
               for m in tstate["m"].values())
    for step in range(3):
        g, _ = _trees(20 + step, scale=10.0 ** (step - 1))
        jp, jstate = jopt.adam_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate, jcfg)
        tstate = topt.adam_update(tp, {k: torch.tensor(v) for k, v in
                                       g.items()}, tstate, tcfg)
        _close({k: t.numpy() for k, t in tp.items()}, jp)
        for slot in ("m", "v"):
            _close({k: t.float().numpy() for k, t in tstate[slot].items()},
                   jstate[slot], rtol=BF16_RTOL if moment_dtype == "bfloat16"
                   else RTOL)
