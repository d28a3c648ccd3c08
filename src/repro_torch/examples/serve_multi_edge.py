"""End-to-end run of the paper's setting, multi-edge cooperative
serving (counterpart of ``examples/serve_multi_edge.py``).

Three heterogeneous edges each run a real reduced LM (``--arch``, default
the olmo-1b family) through the continuous-batching backend; phi(x) is
fitted from measured prefill latencies (the paper's §III-C1 observation
that LM serving is an ideal service), and the central controller
dispatches a burst of prompt requests with the greedy scheduler. Requests
batch into decode lanes and run to completion.

    python -m repro_torch.examples.serve_multi_edge              # the card
    python -m repro_torch.examples.serve_multi_edge --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced_config
from repro_torch.core.heuristics import solve_greedy
from repro_torch.core.state import (EdgeServiceState, QueuedRequest,
                                    snapshot_instance)
from repro_torch.models import init_params
from repro_torch.serving.batching import LMEdgeBackend

LANES = (1, 2, 4)
WARM = 100_000  # rid offset so warmups never collide with real requests
WARM_PROMPTS = (8, 16, 32, 48, 64, 80, 24, 40)


def spin_up(cfg, device, lanes=LANES) -> list:
    """One edge a lane count, same model, distinct weights (independent
    replicas; edge i's from seed i): the paper's zeta replicas."""
    return [LMEdgeBackend(cfg, init_params(cfg, generator=torch.Generator(
        device=device).manual_seed(i), device=device), lanes=ln, max_seq=96,
        seed=i, device=device) for i, ln in enumerate(lanes)]


def fit_phi(edges) -> None:
    """Warm each edge's phi with a few measured prefills (paper Fig. 4)."""
    print("== fitting phi(x) from measured prefill latencies ==")
    for i, be in enumerate(edges):
        for rid, plen in enumerate(WARM_PROMPTS):
            be.submit(WARM + 1000 * i + rid, plen, 1)
        be.drain()
        a, b = be.phi.coefficients
        print(f"  edge {i}: phi(x) = {a:.5f}*x + {b:.5f}  "
              f"(affine fit over {len(be.phi._xs)} measurements)")


def burst(n: int, rng: np.random.Generator) -> list:
    """A burst of requests (prompt length = the paper's data size)."""
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(8, 80))
        reqs.append(QueuedRequest(rid=rid, data_size=float(plen),
                                  source_edge=int(rng.integers(0, 3))))
    return reqs


def dispatch(edges, reqs):
    """The central controller: the edges' states, eqs (4)-(9) scheduled
    greedily. Returns (assignment, {edge: requests dispatched})."""
    states = [EdgeServiceState(edge_id=i, coords=(float(i), 0.0),
                               phi=be.phi, replicas=be.lanes)
              for i, be in enumerate(edges)]
    w = np.abs(np.arange(3)[:, None] - np.arange(3)[None]).astype(np.float32) \
        * 1e-4  # fast interconnect; transfer cost per token
    inst = snapshot_instance(states, reqs, w, ct=1.0)
    assign = solve_greedy(inst)
    share = {i: int(np.sum(assign[:len(reqs)] == i)) for i in range(3)}
    print(f"== controller dispatch (greedy over fitted phi): {share} ==")
    return assign, share


def real_done(edges) -> int:
    return sum(len([r for r in be.finished if r < WARM]) for be in edges)


def serve(edges, reqs, assign) -> float:
    """Submit each request to its edge (4 generated tokens) and step every
    edge until all are served; returns the wall seconds."""
    t0 = time.time()
    for r, target in zip(reqs, assign):
        edges[int(target)].submit(r.rid, int(r.data_size), gen_len=4)
    while real_done(edges) < len(reqs):
        for be in edges:
            be.step()
    wall = time.time() - t0
    print(f"== all {len(reqs)} requests served in {wall:.1f}s wall ==")
    for i, be in enumerate(edges):
        mine = [r for r in be.finished if r < WARM]
        print(f"  edge {i} (lanes={be.lanes}): served {len(mine)} requests")
    return wall


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=18)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch)
    rng = np.random.default_rng(args.seed)
    print(f"== spinning up 3 edges serving {args.arch} (reduced), "
          f"lanes={list(LANES)} ==")
    edges = spin_up(cfg, resolve_device(args.device))
    fit_phi(edges)
    reqs = burst(args.requests, rng)
    assign, share = dispatch(edges, reqs)
    wall = serve(edges, reqs, assign)
    assert real_done(edges) == len(reqs)
    # capability-aware: the 4-lane edge should serve the most
    assert share[2] >= share[0], share
    print("OK: more capable edges absorbed more load (heterogeneity awareness)")
    return {"share": share, "wall_s": wall}


if __name__ == "__main__":
    main()
