"""LM pretraining example (counterpart of ``examples/train_lm.py``).

Trains a reduced-config architecture on the deterministic synthetic
pipeline with asynchronous checkpoints, then kills and resumes mid-run to
show that a preemption loses nothing: the resumed run takes the batches
the lost one would have taken.

    python -m repro_torch.examples.train_lm --arch qwen3-4b --steps 60
    python -m repro_torch.examples.train_lm --device cpu
"""
import argparse
import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.convert import stack_layers
from repro_torch.configs import get_reduced_config
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.launch.steps import TrainKnobs, build_train_step
from repro_torch.models import lm
from repro_torch.nn.module import named_leaves
from repro_torch.optim import AdamConfig, adam_init


def build(cfg, lr: float):
    """The example's step, global-norm clip at 1.0 then Adam at ``lr``:
    ``step(params, opt_state, batch) -> (params, opt_state, loss)``."""
    adam = AdamConfig(lr=lr)
    train_cfg = dataclasses.replace(cfg, num_microbatches=1, optimizer="adam")
    inner = build_train_step(train_cfg, knobs=TrainKnobs(lr=lr, grad_clip=1.0))

    def step(params, opt_state, batch):
        params, opt_state, metrics = inner(params, opt_state, batch)
        return params, opt_state, float(metrics["loss_total"])

    return step, adam


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def pretrain(cfg, *, steps: int, interrupt: int, batch: int, seq: int,
             lr: float, ckpt_dir: str, device, arch: str = "",
             init: dict | None = None) -> dict:
    """The example's run: train to step ``interrupt`` with a checkpoint
    every 10 steps (keep 2), drop everything, restore the latest
    checkpoint into a fresh run and go on to ``steps``. ``init``: the
    starting parameters (default: the seed-0 init). Returns {"losses"
    (every step taken, the repeated ones too), "start" (the step resumed
    at), "pipeline_step"}."""
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = Checkpointer(ckpt_dir, every=10, keep=2)
    step, adam = build(cfg, lr)

    def fresh():
        if init is None:
            params = lm.init_params(cfg, generator=torch.Generator(
                device=device).manual_seed(0), device=device)
        else:
            params = _to(init, device)
        return (params, adam_init(named_leaves(params), adam),
                SyntheticTokens(cfg.vocab_size, batch, seq))

    def tree(params, opt_state):  # the reference's {"params", "opt"} paths
        return stack_layers({**named_leaves(params, "params"),
                             **named_leaves(opt_state, "opt")})

    def take(pipe):
        return {k: torch.from_numpy(v).to(device)
                for k, v in next(pipe).items()}

    params, opt_state, pipe = fresh()
    losses = []
    print(f"== phase 1: train {arch} (reduced) to step {interrupt}, "
          f"then 'crash' ==")
    for i in range(interrupt):
        params, opt_state, loss = step(params, opt_state, take(pipe))
        losses.append(loss)
        if ckpt.should_save(i):
            ckpt.save(i, tree(params, opt_state),
                      extras={"pipeline": pipe.state_dict()})
        if i % 20 == 0:
            print(f"  step {i:4d} loss {loss:.4f}")
    ckpt.wait()
    del params, opt_state, pipe  # the "crash"

    print("== phase 2: restore latest checkpoint and continue ==")
    _, _, pipe = fresh()
    shapes = lm.init_params(cfg, generator=torch.Generator(), device="meta")
    restored = ckpt.restore_latest(
        {"params": shapes, "opt": adam_init(named_leaves(shapes), adam)})
    params = _to(restored["tree"]["params"], device)
    opt_state = _to(restored["tree"]["opt"], device)
    pipe.load_state_dict(restored["extras"]["pipeline"])
    start = restored["step"] + 1
    print(f"  resumed at step {start} (pipeline step {pipe.step})")
    for i in range(start, steps):
        params, opt_state, loss = step(params, opt_state, take(pipe))
        losses.append(loss)
        if i % 20 == 0:
            print(f"  step {i:4d} loss {loss:.4f}")
    return {"losses": losses, "start": start, "pipeline_step": pipe.step}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--interrupt-at", type=int, default=None,
                    help="simulate preemption at this step (default: steps//2)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    interrupt = args.interrupt_at or args.steps // 2

    run = pretrain(get_reduced_config(args.arch), steps=args.steps,
                   interrupt=interrupt, batch=args.batch, seq=args.seq,
                   lr=args.lr, ckpt_dir=args.ckpt,
                   device=resolve_device(args.device), arch=args.arch)
    losses = run["losses"]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"== loss {first:.4f} -> {last:.4f} across the preemption ==")
    assert last < first, "training did not improve"
    print("OK: checkpoint/restart training converged")
    return run


if __name__ == "__main__":
    main()
