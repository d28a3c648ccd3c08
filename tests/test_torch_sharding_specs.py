"""The port's LM placement rules (``repro_torch/sharding/specs.py`` and
``ctx.py``) against the reference's ``PartitionSpec``s, entry for entry.

Every architecture at its full ``CONFIG`` width, on the reference's two
production meshes as ``AbstractMesh``es (16 x 16 and 2 x 16 x 16) and as
the port's shape-only meshes (dicts of axis sizes): the parameters, the
optimizer slots (Adam and Adafactor), the batch of every applicable shape
in ``SHAPES`` and the decode caches.

The port's layer leaves are per layer (``layers/<i>/attn/wq``) where the
reference stacks them on a leading L axis (``layers.attn.wq``): each is
held to the reference's spec of the stacked leaf without its leading entry
(the reference pads that axis with None). The caches keep the reference's
(L, ...) layout and are compared whole. JAX writes a one-axis tuple
("data",) as "data"; the comparison reads both alike.
"""
import dataclasses
import re

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import shape_applicable
from repro.data.synthetic import input_specs as j_input_specs
from repro.launch import steps as jsteps
from repro.sharding import ctx as jctx
from repro.sharding import specs as JS
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.data.synthetic import input_specs
from repro_torch.launch import steps
from repro_torch.sharding import ctx as tctx
from repro_torch.sharding import specs as TS

MESHES = {
    "single": (("data", 16), ("model", 16)),
    "multi": (("pod", 2), ("data", 16), ("model", 16)),
}
_LAYER = re.compile(r"^((?:enc_)?layers)/(\d+)/")


def _abstract(axes):
    return AbstractMesh(tuple(s for _, s in axes), tuple(n for n, _ in axes))


def _sizes(axes):
    return dict(axes)


def _norm(entry):
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _spec(s) -> tuple:
    return tuple(_norm(e) for e in s)


def _reference_specs(spec_tree) -> dict:
    """{reference "."-path: spec tuple} of a NamedSharding tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: hasattr(x, "spec"))
    return {JS._path_str(p): _spec(ns.spec) for p, ns in flat}


def _reference_key(path: str) -> tuple[str, bool]:
    """(the reference's path of the port's leaf, whether it is one layer
    of a stacked leaf)."""
    head, sep, rest = path.partition("/")
    prefix = ""
    if head in ("m", "v") and sep and rest:  # an optimizer slot
        prefix, path = head + ".", rest
    stacked = _LAYER.match(path) is not None
    return prefix + _LAYER.sub(r"\1/", path).replace("/", "."), stacked


def _assert_port_equals_reference(port: dict, ref: dict, where: str):
    seen = set()
    for path, spec in port.items():
        key, stacked = _reference_key(path)
        assert key in ref, f"{where}: {path} -> {key} not in the reference"
        want = ref[key][1:] if stacked else ref[key]
        assert _spec(spec) == want, f"{where} {path}: {spec} != {want}"
        seen.add(key)
    assert seen == set(ref), f"{where}: {sorted(set(ref) - seen)} unmatched"


def _configs(arch, optimizer):
    cfg = dataclasses.replace(get_config(arch), optimizer=optimizer)
    jcfg = dataclasses.replace(j_get_config(arch), optimizer=optimizer)
    return cfg, jcfg


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_the_reference(arch, optimizer,
                                                 mesh_name):
    cfg, jcfg = _configs(arch, optimizer)
    axes = MESHES[mesh_name]
    jparams, jopt = jsteps.param_and_opt_shapes(jcfg, jsteps.TrainKnobs())
    jmesh = _abstract(axes)
    jp = JS.param_specs(jparams, jcfg, jmesh)
    ref_params = _reference_specs(jp)
    ref_opt = _reference_specs(JS.opt_state_specs(jopt, jp, jcfg, jmesh))
    params, opt = steps.param_and_opt_shapes(cfg, steps.TrainKnobs())
    mesh = _sizes(axes)
    _assert_port_equals_reference(TS.param_specs(params, cfg, mesh),
                                  ref_params, f"{arch} params")
    _assert_port_equals_reference(TS.opt_state_specs(opt, cfg, mesh),
                                  ref_opt, f"{arch} {optimizer} state")


def _shape_cases():
    for arch in ARCH_IDS:
        for name in SHAPES:
            ok, _ = shape_applicable(j_get_config(arch), J_SHAPES[name])
            if ok:
                yield arch, name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", list(_shape_cases()))
def test_batch_and_cache_specs_equal_the_reference(arch, shape_name,
                                                   mesh_name):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    axes = MESHES[mesh_name]
    jmesh, mesh = _abstract(axes), _sizes(axes)
    shape, jshape = SHAPES[shape_name], J_SHAPES[shape_name]
    jio, io = j_input_specs(jcfg, jshape), input_specs(cfg, shape)
    ref = _reference_specs(JS.batch_specs(jio["batch"], jcfg, jshape, jmesh))
    got = TS.batch_specs(io["batch"], cfg, shape, mesh)
    assert {k: _spec(v) for k, v in got.items()} == ref
    assert ("cache" in io) == ("cache" in jio)
    if "cache" in io:
        ref = _reference_specs(JS.cache_specs(jio["cache"], jcfg, jshape,
                                              jmesh))
        got = TS.cache_specs(io["cache"], cfg, shape, mesh)
        assert {k.replace("/", "."): _spec(v) for k, v in got.items()} == ref


def test_split_inside_a_head_is_visible_at_production_tp():
    """qwen3-4b's wk is (d, KV * hd) = (2560, 1024): at tp = 16 its column
    shard is 64 wide, half of a 128-wide head; the rule tests the
    flattened dimension, as the reference's does."""
    cfg = get_config("qwen3-4b")
    params, _ = steps.param_and_opt_shapes(cfg, steps.TrainKnobs())
    spec = TS.param_specs(params, cfg, {"data": 16, "model": 16})
    assert spec["layers/0/attn/wk"] == ("data", "model")
    assert cfg.num_kv_heads * cfg.head_dim // 16 < cfg.head_dim


@pytest.mark.parametrize("layout", ["tp", "tp-serve", "dp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_axes_equal_the_reference(layout, mesh_name):
    axes = MESHES[mesh_name]
    want = JS.mesh_axes(_abstract(axes), layout)
    assert TS.mesh_axes(_sizes(axes), layout) == want


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("divisible", [True, False])
@pytest.mark.parametrize("kind,ndim", [("residual", 3), ("tokens", 2),
                                       ("logits", 3), ("logits", 2),
                                       ("decode_x", 2)])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ctx_spec_for_equals_the_reference(kind, ndim, divisible, seq_shard,
                                           mesh_name):
    axes = MESHES[mesh_name]
    ax = JS.mesh_axes(_abstract(axes))
    kw = dict(dp_axes=ax["dp"], tp_axis=ax["tp"], fsdp_axis=ax["fsdp"],
              seq_shard=seq_shard, batch_divisible=divisible)
    want = jctx._spec_for(kind, jctx.ShardCtx(mesh=_abstract(axes), **kw),
                          ndim)
    got = tctx._spec_for(kind, tctx.ShardCtx(mesh=_sizes(axes), **kw), ndim)
    assert _spec(got) == _spec(want)


def test_ctx_spec_for_refuses_an_unknown_kind():
    ctx = tctx.ShardCtx(mesh={"data": 2, "model": 1}, dp_axes=("data",))
    with pytest.raises(ValueError):
        tctx._spec_for("hidden", ctx, 3)


def test_constrain_is_the_identity_outside_a_context_and_refuses_plain():
    x = torch.ones(2, 3, 4)
    assert tctx.constrain(x, "residual") is x
    ctx = tctx.ShardCtx(mesh={"data": 1, "model": 1}, dp_axes=("data",))
    with tctx.use_sharding(ctx), pytest.raises(TypeError, match="plain"):
        tctx.constrain(x, "residual")
    assert tctx.current() is None


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert TS.placements((("pod", "data"), None, "model"), Mesh()) == (
        Shard(0), Shard(0), Shard(2))
    assert TS.placements((None, None), Mesh()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        TS.placements((("data", "pod"),), Mesh())
