"""Placement rules for every LM parameter, optimizer, input and cache leaf,
and the rollout engine's fleet placements (counterpart of
``repro/sharding/specs.py``).

**The LM.** FSDP over the ``data`` axis and tensor parallelism over
``model``; the batch over ("pod", "data"); KV caches with their sequence
(slot) axis over ``model`` (flash-decode style, any KV head count); MoE
experts replicated on the expert axis, TP on d_ff, FSDP on d_model. Every
rule checks divisibility against the mesh and replicates a dimension that
does not divide, so one rule set serves all ten architectures.

A rule returns a spec: a tuple with one entry per tensor dimension, each
an axis name, a tuple of axis names or None, the reference's
``PartitionSpec`` entries. The rules are pure functions of a path, a shape
and the mesh's axis sizes, so they run on a shape-only mesh (a dict such
as ``{"data": 16, "model": 16}``) as well as on a
:class:`~torch.distributed.device_mesh.DeviceMesh`; :func:`placements`
turns a spec into DTensor placements for a ``DeviceMesh``.

The port's LM leaves are per layer (``layers/<i>/attn/wq``,
:func:`repro_torch.nn.named_leaves`) where the reference stacks them on a
leading L axis. A rule matches the reference's path with the layer index
dropped (:func:`repro_torch.optim.adafactor.stack_key`) on the leaf's own
shape; the reference pads its stacked leaf's spec with a leading None, so
the port's spec is the reference's without that entry. The cache keeps the
reference's (L, ...) layout, and its specs are the reference's entry for
entry.

**The fleet.** Every leaf of a batched engine state
(:func:`repro_torch.serving.engine.init_batch`) or arrival batch
(``materialize_round_batch``) carries a
leading (B,) instance axis. Its placement is ``(Shard(0),)``: the instance
axis split into equal contiguous blocks over the mesh's one axis, the rest
whole. Instances are independent clusters, so per-instance state never
crosses ranks; only summary partials and gradients do.
"""
from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.nn.module import named_leaves
from repro_torch.optim.adafactor import stack_key

__all__ = ["mesh_axes", "param_specs", "opt_state_specs", "batch_specs",
           "cache_specs", "replicated", "placements", "mesh_sizes",
           "engine_state_specs", "arrival_specs", "local_block"]


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a shape-only mesh (a
    dict, returned as it is)."""
    if isinstance(mesh, dict):
        return mesh
    names = mesh.mesh_dim_names
    if not names:
        raise ValueError("the LM's placements need a mesh with named axes")
    return {n: mesh.size(i) for i, n in enumerate(names)}


def mesh_axes(mesh, layout: str = "tp") -> dict:
    """The roles of the mesh's axes: {"dp": batch axes, "fsdp": the axes
    the weights are stored across, "tp": the tensor-parallel axis}.
    ``layout="tp"``: batch over data (and pod), FSDP over data, TP over
    model. ``"tp-serve"``: the same with the weights replicated over data
    (no FSDP). ``"dp"``: every axis is data parallelism, the weights FSDP
    over all of them, no TP."""
    names = tuple(mesh_sizes(mesh))
    if layout == "dp":
        return {"dp": names, "fsdp": names, "tp": None}
    pod_dp = ("pod", "data") if "pod" in names else ("data",)
    if layout == "tp-serve":
        return {"dp": pod_dp, "fsdp": None, "tp": "model"}
    return {"dp": pod_dp, "fsdp": "data", "tp": "model"}


def _axsize(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def _fit(mesh, dim: int, axis):
    """``axis`` if its size divides ``dim``, else None (replicate)."""
    return axis if axis is not None and dim % _axsize(mesh, axis) == 0 \
        else None


def _param_rule(path: str, shape, mesh, ax: dict) -> tuple:
    """The spec of the parameter at ``path`` (the reference's path, "/"-
    joined, no layer index) of ``shape``; ``ax`` is :func:`mesh_axes`'
    roles with ``shard_heads``."""
    fsdp, tp = ax["fsdp"], ax["tp"]
    nd = len(shape)

    def spec(*entries):
        # leading dimensions the rule does not name stay whole
        pad = (None,) * (nd - len(entries))
        return pad + tuple(_fit(mesh, shape[len(pad) + i], a)
                           for i, a in enumerate(entries))

    if "embed" in path and "dec_pos" not in path:
        return spec(tp, fsdp)
    if "lm_head" in path:
        return spec(fsdp, tp)
    if "dec_pos" in path:
        return (None,) * nd
    attn_tp = tp if ax.get("shard_heads", True) else None
    if path.endswith(("wq", "wk", "wv")):
        return spec(fsdp, attn_tp)
    if path.endswith("wo") and ("attn" in path or "xattn" in path):
        return spec(attn_tp, fsdp)
    if "moe" in path:
        if "router" in path:
            return spec(fsdp, None)
        if path.endswith(("wg", "wu")):
            return spec(None, fsdp, tp)
        if path.endswith("wo"):
            return spec(None, tp, fsdp)
    if path.endswith(("wg", "wu", "wi")):
        return spec(fsdp, tp)
    if path.endswith("wo"):
        return spec(tp, fsdp)
    if "in_proj" in path:
        return spec(fsdp, tp)
    if "x_proj" in path:
        return spec(tp, None)
    if "dt_proj" in path:
        return spec(None, tp)
    if "out_proj" in path:
        return spec(tp, fsdp)
    if "conv_w" in path:
        return spec(tp, None)
    if any(k in path for k in ("conv_b", "dt_bias", "A_log")) \
            or path.endswith("D"):
        return spec(tp) if nd >= 1 else ()
    return (None,) * nd


def _roles(cfg: ModelConfig, mesh) -> dict:
    ax = mesh_axes(mesh, cfg.layout)
    ax["shard_heads"] = cfg.shard_heads
    return ax


def _shape(x):
    return tuple(x.shape)


def param_specs(params, cfg: ModelConfig, mesh) -> dict:
    """{"/"-path: spec} of every leaf of an LM parameter tree (tensors of
    any device, ``meta`` included, or anything with a ``shape``)."""
    ax = _roles(cfg, mesh)
    return {k: _param_rule(stack_key(k), _shape(x), mesh, ax)
            for k, x in named_leaves(params).items()}


def _strip_slot(path: str) -> str:
    """The parameter path of an optimizer slot's path: Adam's ``m/<p>`` and
    ``v/<p>``, Adafactor's ``v/<p>/v``."""
    slot, _, rest = path.partition("/")
    if slot not in ("m", "v") or not rest:
        return path
    if slot == "v" and rest.endswith("/v"):  # no parameter is named "v"
        return rest[:-2]
    return rest


def opt_state_specs(opt_state, cfg: ModelConfig, mesh) -> dict:
    """{"/"-path: spec} of every leaf of an optimizer state keyed as
    :func:`repro_torch.launch.steps.make_optimizer`'s (Adam: ``step``,
    ``m/<p>``, ``v/<p>``; Adafactor: ``step``, ``v/<p>/vr``, ``v/<p>/vc``,
    ``v/<p>/v``). Adam's moments and Adafactor's unfactored ``v`` take
    their parameter's spec; the factored ``vr``/``vc`` shard their last
    dimension over the FSDP axes where it divides; scalars replicate."""
    ax = _roles(cfg, mesh)
    out = {}
    for k, x in named_leaves(opt_state).items():
        shape = _shape(x)
        if k.endswith(("/vr", "/vc")):
            out[k] = ((None,) * (len(shape) - 1)
                      + (_fit(mesh, shape[-1], ax["fsdp"]),)) if shape \
                else ()
        elif not shape:
            out[k] = ()
        else:
            out[k] = _param_rule(stack_key(_strip_slot(k)), shape, mesh, ax)
    return out


def _batch_axes_for(mesh, ax: dict, b: int):
    dp = ax["dp"]
    return dp if b % _axsize(mesh, dp) == 0 else None


def batch_specs(batch, cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """{name: spec} of a batch: its leading axis over the batch axes when
    ``shape.global_batch`` divides, M-RoPE positions (3, B, ...) on their
    second."""
    dp = _batch_axes_for(mesh, mesh_axes(mesh, cfg.layout),
                         shape.global_batch)
    out = {}
    for k, x in named_leaves(batch).items():
        nd = len(_shape(x))
        if k.endswith("positions") and nd >= 2 and x.shape[0] == 3:
            out[k] = (None, dp) + (None,) * (nd - 2)
        else:
            out[k] = (dp,) + (None,) * (nd - 1)
    return out


def cache_specs(cache, cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """{"/"-path: spec} of a decode cache: K/V (L, B, W, KV, hd) with the
    batch over the batch axes and the slots over the TP axis; SSM states
    with d_inner over TP; ``slot_pos`` (B, W) as the K/V; ``enc_out`` and
    ``pos`` over the batch axes only. Dimensions that do not divide
    replicate (B = 1)."""
    ax = mesh_axes(mesh, cfg.layout)
    dp = _batch_axes_for(mesh, ax, shape.global_batch)
    tp = ax["tp"]
    out = {}
    for k, x in named_leaves(cache).items():
        s = _shape(x)
        if k.endswith(("/k", "/v")):
            out[k] = (None, dp, _fit(mesh, s[2], tp), None, None)
        elif k.endswith("/h"):
            out[k] = (None, dp, _fit(mesh, s[2], tp), None)
        elif k.endswith("/conv"):
            out[k] = (None, dp, None, _fit(mesh, s[3], tp))
        elif k.endswith("slot_pos"):
            out[k] = (dp, _fit(mesh, s[1], tp))
        elif k.endswith("enc_out"):
            out[k] = (dp, None, None)
        elif k.endswith("pos"):
            out[k] = (dp,)
        else:
            out[k] = (dp,) + (None,) * (len(s) - 1)
    return out


def replicated(tree) -> dict:
    """{"/"-path: spec} with every dimension whole."""
    return {k: (None,) * len(_shape(x))
            for k, x in named_leaves(tree).items()}


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: for each mesh
    axis, ``Shard(d)`` where tensor dimension d's entry names it,
    ``Replicate()`` where none does. A dimension over several axes (the
    reference's ("pod", "data")) is split over them in mesh order, as a
    ``PartitionSpec`` is."""
    names = mesh.mesh_dim_names
    out = []
    for name in names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} names axis {name!r} twice")
        out.append(Shard(dims[0]) if dims else Replicate())
    for e in spec:
        if isinstance(e, tuple) and list(e) != [n for n in names if n in e]:
            raise ValueError(f"spec {spec}: axes {e} are not in mesh order "
                             f"{names}")
    return tuple(out)


# ---------------------------------------------------------------------------
# rollout-engine fleet sharding (repro_torch.serving.fleet)
# ---------------------------------------------------------------------------


def _leading_axis_spec(x):
    if getattr(x, "ndim", 0) == 0:
        raise ValueError(
            "fleet sharding needs a leading instance axis on every leaf; "
            "got a scalar — batch the pytree first (engine.init_batch / "
            "workloads.materialize_round_batch)")
    return (Shard(0),)


def engine_state_specs(state: dict) -> dict:
    """``{name: (Shard(0),)}`` for a batched engine state."""
    return {k: _leading_axis_spec(v) for k, v in state.items()}


def arrival_specs(arrivals: dict) -> dict:
    """``{name: (Shard(0),)}`` for batched (B, R, A) arrivals, and for any
    other per-instance input of a fleet rollout ((B,) displacement
    flags)."""
    return {k: _leading_axis_spec(v) for k, v in arrivals.items()}


def local_block(tree: dict, specs: dict, index: int, count: int) -> dict:
    """Rank ``index``'s block of each leaf of ``tree`` (numpy arrays or
    tensors, a view where the type allows) under ``specs`` on an axis of
    ``count`` ranks. Every sharded dimension must divide by ``count``."""
    out = {}
    for k, x in tree.items():
        (placement,) = specs[k]
        dim = placement.dim
        n = x.shape[dim]
        if n % count:
            raise ValueError(f"leaf {k!r}: {n} rows along dim {dim} do not "
                             f"divide over {count} ranks")
        size = n // count
        idx = (slice(None),) * dim + (slice(index * size,
                                            (index + 1) * size),)
        out[k] = x[idx]
    return out
