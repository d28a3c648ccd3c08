"""Elastic-scaling example: train on an 8-rank mesh, lose half the ranks,
resume on a 4-rank mesh from the same checkpoint (counterpart of
``examples/elastic_restart.py``).

    python -m repro_torch.examples.elastic_restart               # 8 cards
    python -m repro_torch.examples.elastic_restart --device cpu  # 8 CPU ranks

A thin wrapper over :mod:`repro_torch.launch.elastic`, which starts each
phase's ranks itself; this passes on its exit code.
"""
import argparse
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cmd = [sys.executable, "-m", "repro_torch.launch.elastic", "--steps", "4"]
    if args.device is not None:
        cmd += ["--device", args.device]
    return subprocess.run(cmd).returncode


if __name__ == "__main__":
    raise SystemExit(main())
