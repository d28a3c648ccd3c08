"""The port's multi-pod dry run (``repro_torch/launch/dryrun.py``) on the
CPU, against the reference's conventions.

The dry run needs a fake world of its own, so the file re-runs itself as
one subprocess (``python tests/test_torch_dryrun.py --out DIR``), which
runs, with ``device="cpu"`` at the configs' full widths:

* ``python -m repro_torch.launch.dryrun --all --mesh single --layers 1
  --jobs 4 --out DIR/all.json`` (every architecture x shape, one layer);
* beside it, in two more processes, three cells at 2 and 3 layers
  (olmo-1b training: B4 and its backward B4b; falcon-mamba-7b
  training: B6 with its states and B6b; qwen3-4b decode: B5), and olmo-1b
  training at 8 x 1024 tokens on the pod and on a fake world of one, and
  on the 512-rank multi-pod mesh;
* ``make_fleet_mesh(dry_run=True)``;
* reduced olmo-1b's step traced on a fake world of one and run on a gloo
  world of one, both counted.

The tests then hold each cell: ``ok``, or skipped with the reference's
reason; its argument bytes per device equal the sum of the local shard
bytes of the reference's ``repro.sharding.specs`` on an ``AbstractMesh``
(each entry's axes' sizes dividing each dimension, rounded up, as a shard
is), exactly; the FLOPs and bytes per device are linear in depth,
exactly; the JSON has the reference's keys; the trace counts what the
real step runs, exactly.
"""
import argparse
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
DEPTH_CELLS = (("olmo-1b", "train_4k"), ("falcon-mamba-7b", "train_4k"),
               ("qwen3-4b", "decode_32k"))
CHILD_TIMEOUT_S = 240

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))


def _child(out: Path) -> None:
    """The subprocess: the sweep, the depth cells and the fleet mesh."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fleet_mesh

    knobs = dryrun.TrainKnobs()
    jobs = [(a, s, "single", knobs, "baseline", "cpu", n)
            for n in (2, 3) for a, s in DEPTH_CELLS]
    jobs += [("olmo-1b", "train_4k", mesh, knobs, "baseline", "cpu", 1, 8,
              1024) for mesh in ("single", "one")]
    jobs.append(("olmo-1b", "train_4k", "multi", knobs, "baseline", "cpu",
                 1))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(2, mp_context=ctx,
                             initializer=torch.set_num_threads,
                             initargs=(1,)) as pool:
        futures = [pool.submit(dryrun._run_or_fail, *job) for job in jobs]
        dryrun.main(["--all", "--mesh", "single", "--device", "cpu",
                     "--layers", "1", "--jobs", "4", "--out",
                     str(out / "all.json")])
        extra = [f.result() for f in futures]
    mesh = make_fleet_mesh(dry_run=True, device="cpu")
    extra.append({"fleet_shape": list(mesh.shape),
                  "fleet_axes": list(mesh.mesh_dim_names),
                  "world": torch.distributed.get_world_size()})
    extra.append(_trace_and_real_step())
    (out / "extra.json").write_text(json.dumps(extra))


def _trace_and_real_step() -> dict:
    """Reduced olmo-1b (remat "full", Adam) at 4 x 64 tokens on a (1, 1)
    mesh: traced on fake tensors over a fake world of one, then a real
    step on a gloo world of one (after one step to make the Adam state),
    both counted by the same counter."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_reduced_config
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_fake_mesh, make_host_mesh
    from repro_torch.models import lm
    from repro_torch.nn import named_leaves
    from repro_torch.roofline.trace import DeviceCounter

    cfg = dataclasses.replace(get_reduced_config("olmo-1b"), remat="full")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=4,
                                seq_len=64)
    knobs = steps.TrainKnobs()
    dist.destroy_process_group()
    run = dryrun.trace_step(cfg, shape, make_fake_mesh(
        (1, 1), ("data", "model"), device="cpu"), knobs)
    dist.destroy_process_group()
    mesh = make_host_mesh(1, device="cpu")
    step = steps.build_train_step(cfg, mesh, knobs, shape)
    pspecs, ospecs, bspecs = step.in_specs
    _, opt_init, _ = steps.make_optimizer(cfg, knobs)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    opt = steps.place(opt_init(named_leaves(params)), ospecs, mesh)
    params = steps.place(params, pspecs, mesh)
    batch = steps.place({k: torch.from_numpy(v) for k, v in next(
        SyntheticTokens(cfg.vocab_size, 4, 64)).items()}, bspecs, mesh)
    params, opt, _ = step(params, opt, batch)
    real = DeviceCounter()
    with real:
        real.hold((params, opt, batch))
        step(params, opt, batch)
    dist.destroy_process_group()
    return {name: {"flops": c.flops, "bytes": c.bytes,
                   "peak": c.peak_bytes, "ops": dict(c.ops),
                   "collectives": c.collectives}
            for name, c in (("trace", run["counter"]), ("real", real))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    log = out / "child.log"
    t0 = time.monotonic()
    with open(log, "w") as f:
        # a session of its own, so that a child past its time is stopped
        # with the worker processes it started
        proc = subprocess.Popen([sys.executable, __file__, "--out", str(out)],
                                env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            proc.wait(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            pytest.fail(f"the dry run did not finish within "
                        f"{CHILD_TIMEOUT_S} s:\n{log.read_text()[-6000:]}")
    assert proc.returncode == 0, log.read_text()[-6000:]
    cells = {(r["arch"], r["shape"]): r
             for r in json.loads((out / "all.json").read_text())}
    extra = json.loads((out / "extra.json").read_text())
    depth = {(r["arch"], r["shape"], r["num_layers"]): r for r in extra[:-5]}
    return {"cells": cells, "depth": depth, "small": extra[-5:-3],
            "multi": extra[-3], "fleet": extra[-2], "against_real": extra[-1],
            "seconds": time.monotonic() - t0}


# -- the reference's side -----------------------------------------------------

def _jcell(arch, shape_name, layers=1):
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_config as j_get_config
    jcfg = j_get_config(arch)
    repl = {"num_layers": layers}
    if jcfg.encoder_decoder:
        repl["num_encoder_layers"] = layers
    return dataclasses.replace(jcfg, **repl), J_SHAPES[shape_name]


def _cells():
    from repro.configs import SHAPES as J_SHAPES
    from repro_torch.configs import ARCH_IDS
    return [(a, s) for a in ARCH_IDS for s in J_SHAPES]


def _applicable():
    from repro.configs import shape_applicable as j_applicable
    return [(a, s) for a, s in _cells() if j_applicable(*_jcell(a, s))[0]]


def _local_bytes(leaf, spec, sizes) -> int:
    import numpy as np
    n = np.dtype(leaf.dtype).itemsize
    spec = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
    for dim, entry in zip(leaf.shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n *= -(-dim // math.prod(sizes[a] for a in axes))
    return n


def _reference_arg_bytes(arch, shape_name, axes=(("data", 16),
                                                 ("model", 16))) -> int:
    """The sum over the reference's step arguments (``lowering_inputs``) of
    each leaf's local shard bytes on its spec, on an AbstractMesh of
    ``axes`` (16 x 16 by default)."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.launch import steps as jsteps
    from repro.sharding import specs as JS
    jcfg, jshape = _jcell(arch, shape_name)
    sizes = dict(axes)
    jmesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    args = jsteps.lowering_inputs(jcfg, jshape, jsteps.TrainKnobs())
    pspecs = JS.param_specs(args[0], jcfg, jmesh)
    specs = [pspecs]
    if jshape.kind == "train":
        specs += [JS.opt_state_specs(args[1], pspecs, jcfg, jmesh),
                  JS.batch_specs(args[2], jcfg, jshape, jmesh)]
    elif jshape.kind == "prefill":
        specs += [JS.batch_specs(args[1], jcfg, jshape, jmesh)]
    else:
        specs += [JS.cache_specs(args[1], jcfg, jshape, jmesh),
                  JS.batch_specs(args[2], jcfg, jshape, jmesh)]
    total = 0
    for tree, spec_tree in zip(args, specs):
        leaves = jax.tree_util.tree_leaves(tree)
        shardings = jax.tree_util.tree_leaves(
            spec_tree, is_leaf=lambda x: hasattr(x, "spec"))
        assert len(leaves) == len(shardings)
        total += sum(_local_bytes(leaf, ns.spec, sizes)
                     for leaf, ns in zip(leaves, shardings))
    return total


# -- the tests ----------------------------------------------------------------


@pytest.mark.parametrize("arch,shape_name", _cells())
def test_every_cell_is_ok_or_skipped_with_the_reference_reason(
        arch, shape_name, run):
    from repro.configs import shape_applicable as j_applicable
    cell = run["cells"][(arch, shape_name)]
    ok, why = j_applicable(*_jcell(arch, shape_name))
    if ok:
        assert cell["status"] == "ok", cell.get("error")
        assert cell["chips"] == 256 and cell["num_layers"] == 1
        assert cell["hlo_flops_per_device"] > 0
        assert cell["hlo_bytes_per_device"] > 0
        assert cell["terms"]["bound_s"] > 0
    else:
        assert cell == {"arch": arch, "shape": shape_name, "mesh": "single",
                        "status": "skipped", "reason": why,
                        "variant": "baseline"}


@pytest.mark.parametrize("arch,shape_name", _applicable())
def test_argument_bytes_are_the_reference_specs_local_shards(
        arch, shape_name, run):
    cell = run["cells"][(arch, shape_name)]
    want = _reference_arg_bytes(arch, shape_name)
    assert cell["arg_bytes_per_device"] == want
    assert cell["memory_analysis"]["argument_size_in_bytes"] == want


@pytest.mark.parametrize("arch,shape_name", DEPTH_CELLS)
def test_costs_are_linear_in_depth(arch, shape_name, run):
    one = run["cells"][(arch, shape_name)]
    two, three = (run["depth"][(arch, shape_name, n)] for n in (2, 3))
    for key in ("hlo_flops_per_device", "hlo_bytes_per_device"):
        c1, c2, c3 = one[key], two[key], three[key]
        assert c2 > c1 and c3 == c1 + 2 * (c2 - c1), key
    assert three["kernel_ops"] == {
        k: v + 2 * (two["kernel_ops"][k] - v)
        for k, v in one["kernel_ops"].items()}


def test_each_family_runs_its_kernels(run):
    cells = run["cells"]
    assert set(cells[("olmo-1b", "train_4k")]["kernel_ops"]) == {
        "flash_attention_lse", "flash_attention_bwd"}
    assert set(cells[("qwen3-4b", "decode_32k")]["kernel_ops"]) == {
        "decode_attention"}
    assert set(cells[("falcon-mamba-7b", "prefill_32k")]["kernel_ops"]) == {
        "mamba_scan_gated"}
    assert set(cells[("hymba-1.5b", "train_4k")]["kernel_ops"]) == {
        "flash_attention_lse", "flash_attention_bwd",
        "mamba_scan_gated_states", "mamba_scan_gated_bwd"}


def test_json_has_the_reference_keys(run):
    from repro.roofline.analysis import CellReport
    fields = {f.name for f in dataclasses.fields(CellReport)}
    want = fields | {"terms", "status", "lower_seconds", "raw_scan_counted",
                     "memory_analysis"}
    dummy = CellReport(**{f: 0 for f in fields if f not in (
        "arch", "shape", "mesh", "variant", "collective_ops",
        "collective_breakdown")}, arch="x", shape="y", mesh="single",
        collective_ops={}, collective_breakdown={})
    for cell in run["cells"].values():
        if cell["status"] != "ok":
            continue
        assert want <= set(cell), want - set(cell)
        assert set(cell["terms"]) == set(dummy.terms())
        assert set(cell["memory_analysis"]) == {
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes"}
        assert cell["raw_scan_counted"] == {
            "flops": cell["hlo_flops_per_device"],
            "bytes": cell["hlo_bytes_per_device"],
            "wire": cell["wire_bytes_per_device"]}


def test_a_world_of_one_counts_the_whole_step(run):
    """olmo-1b at 8 x 1024 tokens: on the (1, 1) mesh over a fake world of
    one the rank holds every argument whole and does every product, which
    the pod's 256 ranks do between them (or more, where they repeat one)."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import steps
    pod, one = run["small"]
    assert (pod["chips"], one["chips"]) == (256, 1) and one["mesh"] == "one"
    assert (one["global_batch"], one["seq_len"]) == (8, 1024)
    assert one["kernel_launches"] == 0
    assert one["kernel_ops"] == pod["kernel_ops"] == {
        "flash_attention_lse": 2, "flash_attention_bwd": 1}
    cfg = dataclasses.replace(get_config("olmo-1b"), num_layers=1)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=8,
                                seq_len=1024)
    metas = steps.lowering_inputs(cfg, shape)
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(metas))
    assert one["arg_bytes_per_device"] == whole
    assert one["model_flops"] == pod["model_flops"]
    assert 256 * pod["hlo_flops_per_device"] >= one["hlo_flops_per_device"]


def test_multi_pod_cell_runs_on_512_ranks(run):
    multi = run["multi"]
    assert multi["status"] == "ok", multi.get("error")
    assert (multi["chips"], multi["mesh"]) == (512, "multi")
    assert multi["kernel_ops"] == {"flash_attention_lse": 2,
                                   "flash_attention_bwd": 1}
    assert multi["arg_bytes_per_device"] == _reference_arg_bytes(
        "olmo-1b", "train_4k", (("pod", 2), ("data", 16), ("model", 16)))


def test_fleet_mesh_flattens_the_pod(run):
    assert run["fleet"] == {"fleet_shape": [256], "fleet_axes": ["fleet"],
                            "world": 256}


def test_the_trace_counts_what_a_real_step_runs(run):
    """The same step traced on fake tensors and run on real ones: the same
    ops, FLOPs, bytes, collectives and peak of live storage, exactly."""
    trace, real = run["against_real"]["trace"], run["against_real"]["real"]
    assert trace == real
    assert trace["ops"]["repro_torch.flash_attention_lse"] == 4  # 2 layers,
    assert trace["flops"] > 0 and trace["peak"] > 0  # forward and remat


def test_the_variants_the_port_refuses_raise():
    """An unknown component raises; ``ssm-bf16``, once refused, applies
    like any variant and its step traces on a reduced cell (a fake world
    of one, in this process): B6 with its states and B6b run as the
    f32 scan's do, with the same FLOPs and bytes (the memory term does
    not move: B6 writes no per-step tensors for bf16 to halve)."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_config, get_reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh
    cfg = get_config("falcon-mamba-7b")
    got, _ = dryrun.apply_variant(cfg, dryrun.TrainKnobs(), "ssm-bf16")
    assert got.ssm_scan_dtype == "bfloat16"
    small = get_reduced_config("falcon-mamba-7b")
    bf16, knobs = dryrun.apply_variant(small, dryrun.TrainKnobs(),
                                       "ssm-bf16")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=2,
                                seq_len=64)
    runs = {}
    try:
        for name, c in (("f32", small), ("bf16", bf16)):
            mesh = make_fake_mesh((1, 1), ("data", "model"), device="cpu")
            counter = dryrun.trace_step(c, shape, mesh, knobs)["counter"]
            runs[name] = (dict(counter.ops), counter.flops, counter.bytes)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert runs["bf16"] == runs["f32"]
    assert runs["bf16"][0]["repro_torch.mamba_scan_gated_bwd"] > 0
    with pytest.raises(KeyError, match="unknown variant"):
        dryrun.apply_variant(cfg, dryrun.TrainKnobs(), "nope")
    got, knobs = dryrun.apply_variant(cfg, dryrun.TrainKnobs(),
                                      "mb2+accum-bf16")
    assert got.num_microbatches == 2 and knobs.grad_accum_dtype == "bfloat16"


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    _child(Path(ap.parse_args().out))
