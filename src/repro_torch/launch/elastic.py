"""Elastic restart: train, checkpoint, and resume on a world of another
size (node failure, pod resize); counterpart of
``repro/launch/elastic.py``.

    python -m repro_torch.launch.elastic --steps 8               # 8 cards
    python -m repro_torch.launch.elastic --steps 2 --device cpu  # 8 CPU ranks

Phase A trains a reduced LM on a (4, 2) ("data", "model") mesh of 8 ranks
and checkpoints. Phase B starts a new world with half the ranks (a failed
pod), builds a (2, 2) mesh, restores the same checkpoint onto its
placements and trains on. The checkpointer stores whole arrays under
logical paths, so any mesh that fits the divisibility rules works
(:class:`repro_torch.checkpoint.Checkpointer`).

A rank is a process with one device (:mod:`repro_torch.launch.mesh`). The
orchestrator starts each phase's ranks as subprocesses of this module,
joined through a ``FileStore`` in a fresh temporary directory (no TCP
port): on the CPU over gloo, one thread each; on CUDA rank r takes card r
over NCCL, and a phase that needs more cards than are visible raises. A
phase also runs under ``torchrun`` (``--phase A`` on 8 ranks).
"""
from __future__ import annotations

import argparse
import datetime
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer, lm_train_tree
from repro_torch.checkpoint.convert import whole
from repro_torch.configs import ShapeConfig, get_reduced_config
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import _shard_ctx, _value_and_grad, place
from repro_torch.models import lm
from repro_torch.nn.module import named_leaves
from repro_torch.optim import AdamConfig, adam_init, adam_update
from repro_torch.sharding import specs as S
from repro_torch.sharding.ctx import use_sharding

#: each phase's mesh, as the reference's: 8 ranks, then half of them
PHASES = {"A": (4, 2), "B": (2, 2)}
BATCH, SEQ = 8, 32
GROUP_TIMEOUT_S = 600


def restore_phase(mesh_shape, ckpt_dir: str, arch: str, *, cfg=None,
                  device=None) -> dict:
    """The reference's ``run_phase`` up to its first step
    (``repro/launch/elastic.py:34-61``): the mesh, the specs, and the
    training state restored from the latest checkpoint onto the mesh's
    placements, or initialised from seed 0 and placed when there is none.
    Returns {"cfg", "mesh", "adam", "params", "opt_state", "pspecs",
    "ospecs", "pipe", "ckpt", "start", "restored", "restore_s"}
    (``restore_s``: reading and placing, 0 without a checkpoint)."""
    device = resolve_device(device)
    cfg = get_reduced_config(arch) if cfg is None else cfg
    mesh = make_host_mesh(mesh_shape[1], device=device)
    if tuple(mesh.shape) != tuple(mesh_shape):
        raise ValueError(f"a {tuple(mesh_shape)} mesh needs "
                         f"{math.prod(mesh_shape)} ranks; the world has "
                         f"{dist.get_world_size()}")
    adam = AdamConfig(lr=1e-3)
    params_shapes = lm.init_params(cfg, generator=torch.Generator(),
                                   device="meta")
    opt_shapes = adam_init(named_leaves(params_shapes), adam)
    pspecs = S.param_specs(params_shapes, cfg, mesh)
    ospecs = S.opt_state_specs(opt_shapes, cfg, mesh)

    ckpt = Checkpointer(ckpt_dir, every=1, async_save=False)
    pipe = SyntheticTokens(cfg.vocab_size, batch=BATCH, seq=SEQ)
    t0 = time.perf_counter()
    restored = ckpt.restore_latest(
        {"params": params_shapes, "opt_state": opt_shapes},
        specs={"params": pspecs, "opt_state": ospecs}, mesh=mesh)
    if restored is None:
        params = lm.init_params(cfg, generator=torch.Generator(
            device=device).manual_seed(0), device=device)
        opt_state = adam_init(named_leaves(params), adam)
        params = place(params, pspecs, mesh)
        opt_state = place(opt_state, ospecs, mesh)
        start, restore_s = 0, 0.0
    else:
        params = restored["tree"]["params"]
        opt_state = restored["tree"]["opt_state"]
        pipe.load_state_dict(restored["extras"]["pipeline"])
        start = restored["step"]
        restore_s = time.perf_counter() - t0
    return {"cfg": cfg, "mesh": mesh, "adam": adam, "params": params,
            "opt_state": opt_state, "pspecs": pspecs, "ospecs": ospecs,
            "pipe": pipe, "ckpt": ckpt, "start": start,
            "restored": restored is not None, "restore_s": restore_s}


def make_step(run: dict):
    """The reference's elastic step on ``run``'s mesh: the value and
    gradient of ``lm.train_loss(..., dp_groups=1)``, then Adam at
    ``run["adam"]``; no clip (so not ``steps.build_train_step``).
    ``step(params, opt_state, batch) -> (params, opt_state, loss)``: the
    parameters updated in place, the batch (plain tensors, the same on
    every rank) cut to each rank's block, the loss a plain scalar."""
    cfg, mesh, adam = run["cfg"], run["mesh"], run["adam"]
    shape = ShapeConfig("elastic", SEQ, BATCH, "train")
    ctx = _shard_ctx(mesh, cfg, shape)

    def step(params, opt_state, batch):
        batch = place(batch, S.batch_specs(batch, cfg, shape, mesh), mesh)
        with use_sharding(ctx), implicit_replication():
            leaves = named_leaves(params)
            for t in leaves.values():
                t.requires_grad_(True)
            loss, _, grads = _value_and_grad(params, leaves, batch, cfg, 1)
            opt_state = adam_update(leaves, grads, opt_state, adam)
            opt_state = place(opt_state, run["ospecs"], mesh)
        return params, opt_state, whole(loss)

    return step


def _say(*args) -> None:
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*args, flush=True)


def run_phase(phase: str, mesh_shape, steps: int, ckpt_dir: str, arch: str,
              *, cfg=None, device=None) -> dict:
    """One phase of the reference's flow (``repro/launch/elastic.py:34-77``)
    on the world this process belongs to: restore or initialise
    (:func:`restore_phase`), ``steps`` steps of 8 x 32 tokens from
    ``SyntheticTokens`` (:func:`make_step`), then a checkpoint at
    ``start + steps`` with the pipeline's state, written by rank 0. Resumes
    at the checkpoint's step, as the reference does. Returns
    :func:`restore_phase`'s dict with "losses", "step_ms" (each step's wall
    time to its loss on the host) and "save_s" (gathering and writing)."""
    run = restore_phase(mesh_shape, ckpt_dir, arch, cfg=cfg, device=device)
    mesh, start = run["mesh"], run["start"]
    device = torch.device(mesh.device_type)
    if run["restored"]:
        _say(f"[{phase}] restored step {start} onto mesh {tuple(mesh_shape)} "
             f"({dist.get_world_size()} devices)")
    step = make_step(run)
    params, opt_state = run["params"], run["opt_state"]
    losses, step_ms = [], []
    for i in range(start, start + steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(run["pipe"]).items()}
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        _say(f"[{phase}] step {i} mesh={tuple(mesh_shape)} "
             f"loss={losses[-1]:.4f}")
    t0 = time.perf_counter()
    run["ckpt"].save(start + steps, lm_train_tree(params, opt_state),
                     extras={"pipeline": run["pipe"].state_dict()})
    run["ckpt"].wait()
    run.update(params=params, opt_state=opt_state, losses=losses,
               step_ms=step_ms, save_s=time.perf_counter() - t0)
    return run


def _join_world(rank: int, world: int, store: str, device) -> None:
    """This rank's process group: NCCL on card ``LOCAL_RANK`` (the rank on
    one host) or gloo on one CPU thread, joined through the ``FileStore``
    at ``store``."""
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _run_world(phase: str, world: int, args, device) -> None:
    """Start ``world`` ranks of this module on ``phase`` and wait for
    them; one rank failing stops the others and raises."""
    if device.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"phase {phase} needs {world} CUDA devices, one a rank; "
            f"{torch.cuda.device_count()} visible")
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    tmp = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.elastic",
                 "--phase", phase, "--devices", str(world), "--rank", str(r),
                 "--store", os.path.join(tmp, "store"), "--steps",
                 str(args.steps), "--ckpt", args.ckpt, "--arch", args.arch,
                 "--device", device.type], env=dict(env, LOCAL_RANK=str(r))))
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    failed = [r for r, p in enumerate(procs) if p.returncode]
    if failed:
        raise RuntimeError(f"phase {phase}: rank(s) {failed} of {world} "
                           f"failed (exit codes "
                           f"{[procs[r].returncode for r in failed]})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_elastic_ckpt"))
    ap.add_argument("--phase", default=None, help="internal")
    ap.add_argument("--devices", type=int, default=None, help="internal")
    ap.add_argument("--rank", type=int, default=None, help="internal")
    ap.add_argument("--store", default=None, help="internal")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.phase is not None:
        if args.store is not None:
            _join_world(args.rank, args.devices, args.store, device)
        try:
            run_phase(args.phase, PHASES[args.phase], args.steps, args.ckpt,
                      args.arch, device=device)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        return

    # orchestrate: phase A on 8 ranks, phase B on 4 (simulated pod loss)
    shutil.rmtree(args.ckpt, ignore_errors=True)
    for phase, devs in (("A", 8), ("B", 4)):
        print(f"== phase {phase}: {devs} devices ==", flush=True)
        _run_world(phase, devs, args, device)
    print("elastic restart OK: trained, shrank the mesh 8->4, resumed.")


if __name__ == "__main__":
    main()
