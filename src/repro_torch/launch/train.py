"""Training command line: CoRaiS RL (the paper's training, §IV-B); counterpart
of ``repro/launch/train.py``'s ``corais`` subcommand.

Checkpoints are asynchronous and keep-K in the reference's format
(``arrays.npz`` plus ``manifest.json``), so either package's ``serve``
loads them; a rerun on the same ``--ckpt`` resumes from the latest one at
the batch after it. Runs on CUDA unless ``--device cpu`` is given.

    python -m repro_torch.launch.train corais --batches 200 --ckpt /tmp/corais

The ``lm`` subcommand (LM pretraining) is not ported (ROADMAP A11).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer, load_train_state, train_tree
from repro_torch.core.instances import InstanceConfig
from repro_torch.core.policy import CoRaiSPolicy, PolicyConfig
from repro_torch.core.train import RLConfig, train as rl_train


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


def main(argv=None):
    """Parse ``argv`` (default: the command line) and run the subcommand;
    ``corais`` returns :func:`train_corais`'s result."""
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

    sub.add_parser("lm")

    args, unknown = ap.parse_known_args(argv)
    if args.mode == "lm":
        raise SystemExit("train lm (LM pretraining) is not ported to the "
                         "PyTorch package yet: ROADMAP A11")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    return train_corais(args)


if __name__ == "__main__":
    main()
