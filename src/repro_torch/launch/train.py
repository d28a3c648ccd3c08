"""Training command line: CoRaiS RL (the paper's training, §IV-B) or LM
pretraining; counterpart of ``repro/launch/train.py``.

Checkpoints are asynchronous and keep-K in the reference's format
(``arrays.npz`` plus ``manifest.json``), so either package loads and
resumes the other's. ``corais`` resumes at the batch after the latest
checkpoint; ``lm`` resumes at the latest checkpoint's step with the token
pipeline's state from its extras, as the reference does. Runs on CUDA
unless ``--device cpu`` is given.

    python -m repro_torch.launch.train corais --batches 200 --ckpt /tmp/corais
    python -m repro_torch.launch.train lm --arch olmo-1b --steps 50 --scale reduced
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (Checkpointer, load_lm_train_state,
                                    load_train_state, lm_train_tree,
                                    train_tree)
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.instances import InstanceConfig
from repro_torch.core.policy import CoRaiSPolicy, PolicyConfig
from repro_torch.core.train import RLConfig, train as rl_train
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.launch.steps import (TrainKnobs, build_train_step,
                                      make_optimizer)
from repro_torch.models import lm
from repro_torch.nn.module import named_leaves


def train_corais(args):
    """Train (or resume) the policy; returns (policy, opt_state, history)."""
    cfg = RLConfig(
        policy=PolicyConfig(d_model=args.policy_dim),
        instance=InstanceConfig(num_edges=args.edges,
                                num_requests=args.requests,
                                backlog_high=args.backlog),
        batch_size=args.batch_size,
        num_samples=args.samples,
        lr=args.lr,
        num_batches=args.batches,
        seed=args.seed,
    )
    device = resolve_device(args.device)
    ckpt = Checkpointer(args.ckpt, every=args.ckpt_every) if args.ckpt else None
    policy = opt_state = None
    start = 0
    if ckpt is not None:
        restored = ckpt.restore_latest()
        if restored:
            start = restored["step"] + 1
            policy = CoRaiSPolicy(
                cfg.policy, generator=torch.Generator().manual_seed(cfg.seed),
                device=device)
            opt_state = load_train_state(policy, restored["tree"])
            print(f"resumed from batch {restored['step']}")

    def log(m):
        print(f"batch {m['batch']:5d} loss {m['loss']:+9.3f} "
              f"cost_mean {m['cost_mean']:7.3f} cost_best {m['cost_best']:7.3f} "
              f"H {m['entropy']:7.2f} ({m['sec']*1e3:6.1f} ms)")

    policy, opt_state, hist = rl_train(
        cfg, policy=policy, opt_state=opt_state, callback=log,
        checkpointer=ckpt, start_batch=start, device=device)
    if ckpt is not None:
        ckpt.save(start + cfg.num_batches, train_tree(policy, opt_state))
        ckpt.wait()
    print("final cost_mean:", hist[-1]["cost_mean"])
    return policy, opt_state, hist


def train_lm(args) -> dict:
    """Pretrain an LM on the synthetic Zipf stream with Adam (``--lr``,
    global-norm clip 1.0), as the reference's ``train lm``: random weights
    from ``--seed``, checkpoints every ``--ckpt-every`` steps; every
    token-input family (dense, MoE with its load-balance term and one
    dispatch group, SSM, hybrid). Returns
    {"cfg", "params", "opt_state", "pipeline", "start", "losses",
    "aux_losses", "grad_norms", "step_ms"}, each step's wall ms taken to
    the loss on the host (``aux_losses``: the MoE load-balance loss, 0
    without experts)."""
    cfg = (get_reduced_config(args.arch) if args.scale == "reduced"
           else get_config(args.arch))
    if cfg.encoder_decoder or not cfg.embed_input:
        raise SystemExit(f"{args.arch}: synthetic token pretrain applies to "
                         "token-input decoder archs; pick a dense/moe/ssm arch")
    device = resolve_device(args.device)
    # the reference's step: one batch, the clip at 1.0, Adam at --lr
    train_cfg = dataclasses.replace(cfg, num_microbatches=1, optimizer="adam")
    knobs = TrainKnobs(lr=args.lr, grad_clip=1.0)
    _, opt_init, _ = make_optimizer(train_cfg, knobs)
    params = lm.init_params(cfg, generator=torch.Generator(
        device=device).manual_seed(args.seed), device=device)
    opt_state = opt_init(named_leaves(params))
    pipe = SyntheticTokens(cfg.vocab_size, args.batch_size, args.seq,
                           seed=args.seed)
    ckpt = Checkpointer(args.ckpt, every=args.ckpt_every) if args.ckpt else None
    start = 0
    if ckpt is not None:
        restored = ckpt.restore_latest()
        if restored:
            start = restored["step"]
            load_lm_train_state(params, opt_state, restored["tree"])
            pipe.load_state_dict(restored["extras"]["pipeline"])
            print(f"resumed from step {start}")
    step = build_train_step(train_cfg, knobs=knobs)

    losses, aux_losses, grad_norms, step_ms = [], [], [], []
    for i in range(start, start + args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(pipe).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        loss = float(metrics["loss_total"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        aux_losses.append(float(metrics["aux_loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        if i % args.log_every == 0:
            print(f"step {i:5d} loss {loss:8.4f} gnorm {grad_norms[-1]:8.2f} "
                  f"({step_ms[-1]:7.1f} ms)")
        if ckpt is not None and ckpt.should_save(i):
            ckpt.save(i, lm_train_tree(params, opt_state),
                      extras={"pipeline": pipe.state_dict()})
    if ckpt is not None:
        ckpt.wait()
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} over {len(losses)} steps")
    return {"cfg": cfg, "params": params, "opt_state": opt_state,
            "pipeline": pipe, "start": start, "losses": losses,
            "aux_losses": aux_losses, "grad_norms": grad_norms,
            "step_ms": step_ms}


def main(argv=None):
    """Parse ``argv`` (default: the command line) and run the subcommand;
    returns :func:`train_corais`'s or :func:`train_lm`'s result."""
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)

    c = sub.add_parser("corais")
    c.add_argument("--edges", type=int, default=5)
    c.add_argument("--requests", type=int, default=50)
    c.add_argument("--backlog", type=int, default=100)
    c.add_argument("--batch-size", type=int, default=128)
    c.add_argument("--samples", type=int, default=64)
    c.add_argument("--batches", type=int, default=40000)
    c.add_argument("--lr", type=float, default=1e-5)
    c.add_argument("--policy-dim", type=int, default=256)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--ckpt", default=None)
    c.add_argument("--ckpt-every", type=int, default=100)
    c.add_argument("--device", default=None,
                   help="cuda (default) or cpu")

    l = sub.add_parser("lm")
    l.add_argument("--arch", required=True)
    l.add_argument("--scale", choices=("reduced", "full"), default="reduced")
    l.add_argument("--steps", type=int, default=100)
    l.add_argument("--batch-size", type=int, default=8)
    l.add_argument("--seq", type=int, default=128)
    l.add_argument("--lr", type=float, default=3e-4)
    l.add_argument("--seed", type=int, default=0)
    l.add_argument("--ckpt", default=None)
    l.add_argument("--ckpt-every", type=int, default=50)
    l.add_argument("--log-every", type=int, default=10)
    l.add_argument("--device", default=None,
                   help="cuda (default) or cpu")

    args = ap.parse_args(argv)
    if args.mode == "corais":
        return train_corais(args)
    return train_lm(args)


if __name__ == "__main__":
    main()
