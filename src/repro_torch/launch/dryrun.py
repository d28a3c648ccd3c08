"""Multi-pod dry run (counterpart of ``repro/launch/dryrun.py``).

For every (architecture x input-shape x mesh) cell: build the sharded step
on the production mesh, run it once on fake tensors placed as DTensors on
a fake world of 256 or 512 ranks in this process, count one rank's local
work (:class:`repro_torch.roofline.trace.DeviceCounter`: FLOPs, bytes
accessed, collectives, live memory), and append a
:class:`~repro_torch.roofline.analysis.CellReport` to the results JSON.
Nothing runs on a device and no kernel is launched or built: the kernels
are ``torch.library`` ops whose fake implementations give their outputs'
shapes. Every layer is traced, so unlike the reference (whose XLA counts a
loop body once and which corrects that with unrolled probes) the headline
counts need no correction, and ``raw_scan_counted`` holds the same values.

The fake world is the process's only process group: run the dry run as a
process of its own (``python -m repro_torch.launch.dryrun ...``), never
beside a real world (the tests' gloo groups, a card's NCCL world).
``--device cuda`` (the default) traces the card's path on fake CUDA
tensors and needs a CUDA build of PyTorch; ``--device cpu`` traces the
CPU's (whose collectives differ: gloo has no all-to-all, so DTensor
gathers and chunks).

Beside the reference's options: ``--device``; ``--layers N`` (trace N
layers), ``--batch``/``--seq`` (another global batch or length), ``--mesh
one`` (a (1, 1) mesh over a fake world of one, whose counts a step on one
card can be held to) and ``--jobs N`` (the cells in N processes, each with
its own fake world).

Usage:
    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out results/torch_dryrun.json
    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed import tensor as dtensor
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.kernels.build import LAUNCHES
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.steps import TrainKnobs, build_for_shape, lowering_inputs
from repro_torch.roofline.analysis import analyze_trace
from repro_torch.roofline.trace import DeviceCounter, kernel_ops, patched
from repro_torch.sharding import specs as S

# The reference's variants, composable with "+" (e.g. "flashdecode+mb2").
# Model-config overrides:
CFG_VARIANTS = {
    "flashdecode": {"decode_flash_shardmap": True},
    "ssm-bf16": {"ssm_scan_dtype": "bfloat16"},
    "ssm-chunk32": {"ssm_chunk": 32},
    "ssm-chunk64": {"ssm_chunk": 64},
    "ssm-chunk128": {"ssm_chunk": 128},
    "ssm-chunk1024": {"ssm_chunk": 1024},
    "ssm-chunk4096": {"ssm_chunk": 4096},
    "remat-dots": {"remat": "dots"},
    "remat-none": {"remat": "none"},
    "mb1": {"num_microbatches": 1},
    "mb2": {"num_microbatches": 2},
    "mb4": {"num_microbatches": 4},
    "mb16": {"num_microbatches": 16},
    "dp-layout": {"layout": "dp"},
    "tpserve": {"layout": "tp-serve"},
    "densemoe": {"moe_dense_decode": True},
    "seqshard": {"seq_shard_activations": True},
    "noseqshard": {"seq_shard_activations": False},
    "adam": {"optimizer": "adam"},
    "adafactor": {"optimizer": "adafactor"},
}
# Execution-knob overrides:
KNOB_VARIANTS = {
    "accum-bf16": {"grad_accum_dtype": "bfloat16"},
}
#: The meshes a cell runs on: the reference's pod and two pods, and a
#: (1, 1) mesh over a fake world of one, to hold a trace against a step on
#: one card.
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "one": ((1, 1), ("data", "model"))}


def apply_variant(cfg, knobs: TrainKnobs, variant: str):
    """``cfg`` and ``knobs`` with ``variant``'s overrides. Raises for an
    unknown component. ``ssm-bf16`` runs the scan with its state in bf16
    (B6 and B6b's flag); its memory term does not move, as B6 never writes
    the (B, c, d, N) tensors that the reference's XLA scan materializes
    and bf16 halves."""
    if variant in ("", "baseline"):
        return cfg, knobs
    for part in variant.split("+"):
        if part in CFG_VARIANTS:
            cfg = dataclasses.replace(cfg, **CFG_VARIANTS[part])
        elif part in KNOB_VARIANTS:
            knobs = dataclasses.replace(knobs, **KNOB_VARIANTS[part])
        else:
            raise KeyError(f"unknown variant component {part!r}; known: "
                           f"{sorted(CFG_VARIANTS) + sorted(KNOB_VARIANTS)}")
    return cfg, knobs


def cut_depth(cfg, num_layers: int):
    """``cfg`` with ``num_layers`` layers (and as many encoder layers)."""
    repl = {"num_layers": num_layers}
    if cfg.encoder_decoder:
        repl["num_encoder_layers"] = num_layers
    return dataclasses.replace(cfg, **repl)


def fake_inputs(tree, specs: dict, mesh, prefix: str = ""):
    """``tree`` of ``meta`` tensors (:func:`lowering_inputs`) as DTensors on
    ``specs``' placements whose local blocks are the only storage, made
    under the caller's ``FakeTensorMode``: one rank's argument memory."""
    if isinstance(tree, dict):
        return {k: fake_inputs(v, specs, mesh, f"{prefix}/{k}" if prefix
                               else k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fake_inputs(v, specs, mesh, f"{prefix}/{i}")
                for i, v in enumerate(tree)]
    return dtensor.empty(tuple(tree.shape), dtype=tree.dtype,
                         device_mesh=mesh,
                         placements=S.placements(specs[prefix], mesh))


def _storages(tree) -> dict:
    """{id: (storage, bytes)} of the local blocks of ``tree``'s tensors,
    each storage once."""
    out = {}
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, DTensor):
            leaf = leaf._local_tensor
        if isinstance(leaf, torch.Tensor):
            st = leaf.untyped_storage()
            out[id(st)] = (st, st.nbytes())
    return out


def memory_analysis(args, outs, peak_bytes: int, held_bytes: int) -> dict:
    """One rank's memory of a step, the keys of XLA's ``memory_analysis``:

    * argument: the bytes of the arguments' local blocks (parameters,
      optimizer state, cache, batch), each storage once, unrounded;
    * output: the bytes of the outputs' local blocks, each storage once;
    * alias: the part of the output bytes that is argument storage
      updated in place (parameters and optimizer state, the decode cache);
    * temp: the most the step held beyond its arguments, the counter's
      peak of live storage (each rounded to the allocator's 512-byte
      blocks) less the arguments' (``held_bytes``, rounded alike).
    """
    ins, res = _storages(args), _storages(outs)
    return {
        "argument_size_in_bytes": sum(n for _, n in ins.values()),
        "output_size_in_bytes": sum(n for _, n in res.values()),
        "temp_size_in_bytes": peak_bytes - held_bytes,
        "alias_size_in_bytes": sum(n for k, (_, n) in res.items()
                                   if k in ins),
    }


#: DTensor's modules that ask whether a compiler is tracing
_DTENSOR_MODULES = ("torch.distributed._functional_collectives",
                    "torch.distributed.tensor._dispatch",
                    "torch.distributed.tensor._sharding_prop",
                    "torch.distributed.tensor._redistribute",
                    "torch.distributed.tensor._collective_utils",
                    "torch.distributed.tensor._decompositions")


@contextlib.contextmanager
def eager_dtensor():
    """DTensor as it runs a step eagerly on real tensors, fake ones here.

    * Told that no compiler traces: it takes any active fake mode for a
      compiler's trace, and then caches nothing (each op's sharding is
      propagated anew, each redistribution planned anew), which makes a
      trace tens of times slower. The dry run runs the step once on fixed
      shapes, where those caches are right.
    * On a mesh of three axes (the multi-pod mesh), a redistribution
      involving a strided shard planned greedily, one mesh axis at a time,
      as DTensor plans every other one: its minimum-cost search over such
      placements, which it forces there, explores a state space growing
      with the axes' factorial and took 300 s for one olmo-1b layer on a
      CPU core. This planner also prices the candidate strategies, so a
      multi-pod cell's schedule may differ from the one DTensor would
      pick on a real pod.
    """
    from torch.distributed.tensor import _redistribute
    planner = getattr(_redistribute, "DTensorRedistributePlanner", None)
    graph = getattr(planner, "generate_graph_based_transform_infos", None)

    def plan(self, src_spec, dst_spec, *args, **kwargs):
        if src_spec.mesh.ndim >= 3:
            return self.generate_greedy_transform_infos(src_spec, dst_spec)
        return graph(self, src_spec, dst_spec, *args, **kwargs)

    with contextlib.ExitStack() as stack:
        for name in _DTENSOR_MODULES:
            module = importlib.import_module(name)
            if hasattr(module, "_are_we_tracing"):
                stack.enter_context(patched(module, "_are_we_tracing",
                                            lambda: False))
        if graph is not None:  # releases that plan greedily need no patch
            stack.enter_context(patched(
                planner, "generate_graph_based_transform_infos", plan))
        yield


def trace_step(cfg, shape, mesh, knobs: TrainKnobs = TrainKnobs()) -> dict:
    """Build ``shape``'s step for ``cfg`` on ``mesh`` and run it once on
    fake arguments, counted. Returns {"counter", "memory", "params",
    "build_seconds", "trace_seconds"}."""
    t0 = time.time()
    step = build_for_shape(cfg, mesh, shape, knobs)
    metas = lowering_inputs(cfg, shape, knobs)
    with FakeTensorMode(allow_non_fake_inputs=True), eager_dtensor():
        args = tuple(fake_inputs(t, spec, mesh)
                     for t, spec in zip(metas, step.in_specs))
        build_s = time.time() - t0
        counter = DeviceCounter()
        with counter:
            held = counter.hold(args)
            t0 = time.time()
            outs = step(*args)
            trace_s = time.time() - t0
        memory = memory_analysis(args, outs, counter.peak_bytes, held)
    return {"counter": counter, "memory": memory, "params": metas[0],
            "build_seconds": build_s, "trace_seconds": trace_s}


def run_cell(arch: str, shape_name: str, mesh_name: str,
             knobs: TrainKnobs = TrainKnobs(), variant: str = "baseline",
             verbose: bool = True, cfg_override=None, *, device=None,
             num_layers: int | None = None, batch: int | None = None,
             seq: int | None = None) -> dict:
    """One cell's JSON: the reference's keys, and ``device``, ``num_layers``
    (the depth traced), ``global_batch`` and ``seq_len`` (the shape's, or
    ``batch`` and ``seq`` in their place), ``peak_bytes_per_device``,
    ``kernel_ops`` (the port's kernel ops the step ran, calls by name),
    ``kernel_launches`` (kernels launched: none) and
    ``largest_collectives`` (the five with the most result bytes, as
    (kind, bytes, group size))."""
    cfg = cfg_override or get_config(arch)
    cfg, knobs = apply_variant(cfg, knobs, variant)
    if num_layers is not None:
        cfg = cut_depth(cfg, num_layers)
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(shape, global_batch=batch or
                                shape.global_batch,
                                seq_len=seq or shape.seq_len)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why, "variant": variant}
    device = resolve_device(device)
    mesh = make_fake_mesh(*MESHES[mesh_name], device=device)
    chips = mesh.size()
    launches = sum(LAUNCHES.values())
    run = trace_step(cfg, shape, mesh, knobs)
    counter = run["counter"]
    report = analyze_trace(counter, cfg, shape, mesh_name, chips,
                           run["params"], run["memory"],
                           run["trace_seconds"], variant)
    out = report.to_json()
    out["status"] = "ok"
    out["lower_seconds"] = run["build_seconds"]
    out["raw_scan_counted"] = {"flops": report.hlo_flops_per_device,
                               "bytes": report.hlo_bytes_per_device,
                               "wire": report.wire_bytes_per_device}
    out["memory_analysis"] = run["memory"]
    out["device"] = device.type
    out["num_layers"] = cfg.num_layers
    out["peak_bytes_per_device"] = counter.peak_bytes
    out["kernel_ops"] = kernel_ops(counter)
    out["largest_collectives"] = sorted(counter.collectives,
                                        key=lambda c: -c[1])[:5]
    out["kernel_launches"] = sum(LAUNCHES.values()) - launches
    out["global_batch"], out["seq_len"] = shape.global_batch, shape.seq_len
    if verbose:
        print(f"== {arch} x {shape_name} x {mesh_name} [{variant}] "
              f"({cfg.num_layers} layers, {device.type}) ==")
        print("memory_analysis:", out["memory_analysis"])
        t = out["terms"]
        print(f"flops/dev={out['hlo_flops_per_device']:.3e} "
              f"bytes/dev={out['hlo_bytes_per_device']:.3e} "
              f"wire/dev={out['wire_bytes_per_device']:.3e}")
        print(f"terms: compute={t['compute_s']:.4f}s memory={t['memory_s']:.4f}s "
              f"collective={t['collective_s']:.4f}s dominant={t['dominant']} "
              f"useful_ratio={t['useful_flop_ratio']:.3f}")
        print(f"collectives: {out['collective_ops']}  kernels: "
              f"{out['kernel_ops']}  (build {out['lower_seconds']:.1f}s "
              f"trace {out['compile_seconds']:.1f}s)", flush=True)
    return out


def _key(r: dict) -> tuple:
    return (r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline"))


def _cost(job) -> int:
    """A cell's ops to trace, roughly: layers times microbatches, thrice
    for training (forward, recompute, backward)."""
    arch, shape = job[0], SHAPES[job[1]]
    cfg = get_config(arch)
    layers = job[6] or cfg.num_layers
    if shape.kind != "train":
        return layers
    return 3 * layers * max(cfg.num_microbatches, 1)


def _run_or_fail(arch, shape, mesh_name, knobs, variant, device, layers,
                 batch=None, seq=None):
    """:func:`run_cell`, a failure recorded as the cell's result."""
    try:
        return run_cell(arch, shape, mesh_name, knobs, variant=variant,
                        device=device, num_layers=layers, batch=batch,
                        seq=seq)
    except Exception as e:  # a failed cell is a bug; record + continue
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "failed", "error": repr(e), "variant": variant}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=(*MESHES, "both"), default="single",
                    help="both: single and multi")
    ap.add_argument("--all", action="store_true", help="run every (arch x shape)")
    ap.add_argument("--out", default=None, help="append JSON results here")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--grad-accum-dtype", default="float32")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells already present (ok/skipped) in --out")
    ap.add_argument("--device", default=None,
                    help="the ranks' device type: cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="trace this many layers in place of the config's")
    ap.add_argument("--batch", type=int, default=None,
                    help="this global batch in place of the shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="this sequence length in place of the shape's")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the cells in this many processes, each "
                         "with its own fake world")
    args = ap.parse_args(argv)

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    knobs = TrainKnobs(grad_accum_dtype=args.grad_accum_dtype, lr=args.lr)
    results = []

    def flush():
        if not args.out:
            return
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        # replace any prior entry for the same (arch, shape, mesh, variant)
        done = {_key(r) for r in results}
        existing = [r for r in existing if _key(r) not in done]
        existing.extend(results)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out + ".tmp", "w") as f:
            json.dump(existing, f, indent=1)
        os.replace(args.out + ".tmp", args.out)

    already = set()
    if args.skip_existing and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            already = {_key(r) for r in json.load(f)
                       if r["status"] in ("ok", "skipped")}
    todo = [(arch, shape, mesh_name, knobs, args.variant, args.device,
             args.layers, args.batch, args.seq)
            for arch, shape in cells for mesh_name in meshes
            if (arch, shape, mesh_name, args.variant) not in already]
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx,
                                 initializer=torch.set_num_threads,
                                 initargs=(1,)) as pool:
            # the longest traces first, so that none starts last
            futures = {job: pool.submit(_run_or_fail, *job)
                       for job in sorted(todo, key=_cost, reverse=True)}
            for job in todo:
                results.append(futures[job].result())
                flush()
    else:
        for job in todo:
            results.append(_run_or_fail(*job))
            flush()  # incremental: partial progress survives interruption
    failures = sum(1 for r in results if r["status"] == "failed")
    if args.out:
        print(f"wrote {len(results)} cell results -> {args.out}")
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    print(f"dryrun: {n_ok} ok, {n_skip} skipped (documented), {failures} FAILED")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
