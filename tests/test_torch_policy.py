"""The port's policy network against the JAX reference on the same
parameters: reference params from ``corais_init`` flattened by pytree path
and loaded through the weight bridge, in three configs (flat,
``tier_features``, ``admit_head``). Encoder outputs, log-probs, admission
logits and the new norm state agree to atol 1e-5 (f32, different reduction
order), in eval mode at ``count == 0`` (batch-statistics fallback) and at
``count > 0``, and in a ``training=True`` pass."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree
from repro.core import InstanceConfig as JInstanceConfig
from repro.core import generate_batch as j_generate_batch
from repro.core import policy as jpol
from repro.nn.module import param_count as j_param_count
from repro_torch.checkpoint import (load_reference_params,
                                    read_reference_checkpoint, split_prefix)
from repro_torch.core import policy as tpol
from repro_torch.nn import param_count

torch.set_num_threads(1)

ATOL = 1e-5
SMALL = dict(d_model=32, ff_hidden=64, edge_layers=2, request_layers=1)
CONFIGS = {
    "flat": {},
    "tier": {"tier_features": True},
    "admit": {"admit_head": True},
}
TIER_KEYS = (("tier", "q"), ("cache_frac", "q"), ("req_slack", "z"),
             ("req_priority", "z"), ("req_cached", "z"))


def _flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(leaf)
    return out


def _pair(name, seed=0, **over):
    """(jax cfg, params, state) and the port's policy with the same weights."""
    kw = {**SMALL, **CONFIGS[name], **over}
    jcfg = jpol.PolicyConfig(**kw)
    params, state = _init(jax.random.PRNGKey(seed), jcfg)
    policy = tpol.CoRaiSPolicy(tpol.PolicyConfig(**kw), device="cpu")
    load_reference_params(policy, _flat(params), _flat(state))
    return jcfg, params, state, policy


def _batch(name="flat", seed=0, b=3, q=4, z=9, q_pad=6, z_pad=13):
    rng = np.random.default_rng(seed)
    batch = j_generate_batch(rng, JInstanceConfig(
        num_edges=q, num_requests=z, max_edges=q_pad, max_requests=z_pad), b)
    if name == "tier":
        qp, zp = batch["edge_mask"].shape[-1], batch["req_mask"].shape[-1]
        for key, axis in TIER_KEYS:
            n = qp if axis == "q" else zp
            batch[key] = rng.uniform(0, 1, size=(b, n)).astype(np.float32)
    return batch


def _j(batch):
    return jax.tree.map(jnp.asarray, batch)


# jit'd reference entry points: one compile per config and shape, far
# cheaper than op-by-op dispatch of the eager reference
_init = jax.jit(jpol.corais_init, static_argnums=1)
_encode = jax.jit(jpol.corais_encode, static_argnames=("cfg", "training"))
_score = jax.jit(jpol.corais_score, static_argnames=("cfg", "backend"))
_admit = jax.jit(jpol.corais_admit, static_argnames=("cfg",))


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bridge_loads_every_leaf_and_counts_match(name):
    jcfg, params, state, policy = _pair(name)
    assert param_count(policy) == j_param_count(params)
    sd = policy.state_dict()
    for key, arr in {**_flat(params), **_flat(state)}.items():
        np.testing.assert_array_equal(sd[key.replace("/", ".")].numpy(), arr)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_eval_forward_matches_reference_at_count_zero(name):
    """Untrained norms fall back to the masked batch statistics."""
    jcfg, params, state, policy = _pair(name)
    batch = _batch(name)
    c, h, _ = _encode(params, state, _j(batch), cfg=jcfg)
    lp = _score(params, c, h, batch["edge_mask"], cfg=jcfg)
    tb = _t(batch)
    tc, th = tpol.corais_encode(policy, tb)
    _close(tc, c)
    _close(th, h)
    for backend in tpol.list_score_backends():
        _close(tpol.corais_score(policy, tc, th, tb["edge_mask"],
                                 backend=backend), lp)
    _close(tpol.corais_apply(policy, tb), lp)
    if name == "admit":
        want = _admit(params, c, h, batch["edge_mask"], cfg=jcfg)
        _close(tpol.corais_admit(policy, tc, th, tb["edge_mask"]), want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_training_pass_and_trained_eval_match_reference(name):
    """One ``training=True`` pass: outputs and the new mean/var/count agree;
    then an eval pass on the trained running statistics (count > 0)."""
    jcfg, params, state, policy = _pair(name)
    batch = _batch(name, seed=1)
    c, h, new_state = _encode(params, state, _j(batch), cfg=jcfg,
                              training=True)
    tb = _t(batch)
    tc, th = tpol.corais_encode(policy, tb, training=True)
    _close(tc, c)
    _close(th, h)
    sd = policy.state_dict()
    for key, arr in _flat(new_state).items():
        _close(sd[key.replace("/", ".")], arr)
    assert float(sd["edge_layers.0.norm1.count"]) == 1.0

    other = _batch(name, seed=2)
    c2, h2, _ = _encode(params, new_state, _j(other), cfg=jcfg)
    lp2 = _score(params, c2, h2, other["edge_mask"], cfg=jcfg)
    to = _t(other)
    tc2, th2 = tpol.corais_encode(policy, to)
    _close(tc2, c2)
    _close(tpol.corais_score(policy, tc2, th2, to["edge_mask"]), lp2)
    assert float(policy.state_dict()["edge_layers.0.norm1.count"]) == 1.0


def test_layer_norm_and_mlp_alignment_ablation():
    """The FC3 ablation layout (MLP alignment, LayerNorm) loads and agrees."""
    jcfg, params, state, policy = _pair("flat", norm="layer",
                                        edge_align="mlp", req_align="mlp")
    batch = _batch()
    c, h, _ = _encode(params, state, _j(batch), cfg=jcfg)
    tc, th = tpol.corais_encode(policy, _t(batch))
    _close(tc, c)
    _close(th, h)


def test_checkpoint_round_trip_through_reference_writer(tmp_path):
    jcfg, params, state, _ = _pair("admit", seed=3)
    save_pytree({"params": params, "state": state}, str(tmp_path / "ckpt"))
    flat = read_reference_checkpoint(str(tmp_path / "ckpt"))
    policy = tpol.CoRaiSPolicy(tpol.PolicyConfig(**SMALL, admit_head=True),
                               device="cpu")
    load_reference_params(policy, split_prefix(flat, "params"),
                          split_prefix(flat, "state"))
    batch = _batch()
    c, h, _ = _encode(params, state, _j(batch), cfg=jcfg)
    lp = _score(params, c, h, batch["edge_mask"], cfg=jcfg)
    _close(tpol.corais_apply(policy, _t(batch)), lp)


def test_bridge_rejects_missing_extra_and_misshapen_leaves():
    _, params, state, policy = _pair("flat")
    p, s = _flat(params), _flat(state)
    missing = dict(p)
    missing.pop("w_px")
    with pytest.raises(KeyError, match="w_px"):
        load_reference_params(policy, missing, s)
    with pytest.raises(KeyError, match="bogus"):
        load_reference_params(policy, {**p, "bogus/w": np.zeros(1)}, s)
    bad = {**p, "w_py": np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError, match="w_py"):
        load_reference_params(policy, bad, s)
    with pytest.raises(KeyError):  # admission head absent from the policy
        _, ap, ast, _ = _pair("admit")
        load_reference_params(policy, _flat(ap), _flat(ast))


def test_padding_invariance():
    """Padding edges and requests leaves real rows unchanged (to 1e-5:
    masked batch statistics reduce in another order, ROADMAP C2)."""
    _, _, _, policy = _pair("flat")
    rng = np.random.default_rng(4)
    inst = _batch(q=5, z=12, q_pad=None, z_pad=None, b=2)
    small = _t(inst)
    padded = dict(inst)
    dq, dz = 3, 7
    for k in ("edge_coords", "phi", "replicas", "workload", "edge_mask"):
        a = inst[k]
        pad = rng.uniform(0, 1, size=(2, dq) + a.shape[2:]).astype(a.dtype)
        padded[k] = np.concatenate([a, np.zeros_like(pad) if a.dtype == bool
                                    else pad], axis=1)
    padded["w"] = np.pad(inst["w"], ((0, 0), (0, dq), (0, dq)))
    for k in ("req_src", "req_size", "req_mask"):
        padded[k] = np.pad(inst[k], ((0, 0), (0, dz)))
    lp_small = tpol.corais_apply(policy, small)
    lp_pad = tpol.corais_apply(policy, _t(padded))
    np.testing.assert_allclose(lp_pad[:, :12, :5].detach().numpy(),
                               lp_small.detach().numpy(), atol=ATOL, rtol=0)
    assert float(lp_pad[:, :12, 5:].exp().max().detach()) == 0.0


def test_unknown_backend_raises():
    _, _, _, policy = _pair("flat")
    c = torch.zeros(4, 32)
    with pytest.raises(ValueError, match="unknown score backend"):
        tpol.corais_score(policy, c, c, torch.ones(4, dtype=torch.bool),
                          backend="pallas")
    with pytest.raises(ValueError, match="unknown decode backend"):
        tpol.corais_score_decode(policy, c, c, torch.ones(4, dtype=torch.bool),
                                 backend="xla")


def test_defaults_mirror_reference_except_the_backend():
    """Same defaults as the reference config, except that the port's head
    defaults to the CUDA kernel (the Pallas kernel's counterpart)."""
    ref_fields = dataclasses.asdict(jpol.PolicyConfig())
    port_fields = dataclasses.asdict(tpol.PolicyConfig())
    assert ref_fields.pop("score_backend") == "xla"
    assert port_fields.pop("score_backend") == "cuda"
    assert ref_fields == port_fields


def test_policy_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device is CUDA here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpol.CoRaiSPolicy(tpol.PolicyConfig(**SMALL))
