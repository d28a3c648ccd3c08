"""The examples' twins (``repro_torch.examples``) against the reference's
examples (``examples/*.py``) on the CPU, through the twins' functions at
small sizes.

* quickstart: on the example's numpy instance the classical solvers'
  makespans equal the reference's (ILS, whose budget is wall time, between
  B&B and greedy on both) and ``write_lp`` writes the reference's bytes;
  REINFORCE lowers the cost; with the reference's trained parameters
  bridged in, the greedy decision is the reference's (above the 1e-4
  top-2 gap) and the best of 256 samples costs no more.
* workload_replay: at the example's defaults the live run equals its
  replay and the reference's live run (the wall-clock keys apart), as
  ``tests/test_torch_simulator.py`` holds the simulator.
* train_lm: from the reference's init the twin's losses across its crash
  are the reference example's step's (1e-5), the steps after the resume
  the ones after the checkpoint, and the mid-run checkpoint is read by the
  reference's ``restore_latest`` with the example's ``{"params", "opt"}``
  template, equal to the reference's state at that step (1e-5).
* serve_multi_edge: with phi pinned, the dispatch is the reference's
  ``solve_greedy`` on the reference's snapshot, every request is served,
  and the 4-lane edge takes no fewer than the 1-lane edge.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_reduced_config as jreduced
from repro.core import heuristics as jheur
from repro.core import ilp as jilp
from repro.core import policy as jpol
from repro.core import InstanceConfig as JInstanceConfig
from repro.core import PolicyConfig as JPolicyConfig
from repro.core import RLConfig as JRLConfig
from repro.core import state as jstate
from repro.core.decode import greedy_decode as jgreedy
from repro.core.objective import makespan_np as jmakespan
from repro.core.train import train as jtrain
from repro.models import lm as jlm
from repro.optim import adam_init as jadam_init
from repro.serving import CentralController as JCC
from repro.serving import MultiEdgeSim as JSim
from repro.serving import SimConfig as JCfg
from repro.workloads import scenario as jscenario
from repro_torch.checkpoint import load_reference_lm_params
from repro_torch.checkpoint import load_reference_params
from repro_torch.configs import get_reduced_config
from repro_torch.core.instances import generate_instance
from repro_torch.core.policy import CoRaiSPolicy
from repro_torch.core.state import PhiEstimator
from repro_torch.examples import (quickstart, serve_multi_edge, train_lm,
                                  workload_replay)
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
GAP = 1e-4


def _reference_example(name):
    """A reference example's module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(tree) -> dict:
    from repro.checkpoint.checkpointer import _flatten_with_paths
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree)[0]}


# -- quickstart ------------------------------------------------------------------


@pytest.fixture(scope="module")
def instance():
    return generate_instance(np.random.default_rng(0), quickstart.ICFG)


def test_quickstart_solvers_equal_the_reference(instance, tmp_path, capsys):
    got = quickstart.classical(instance, str(tmp_path / "port.lp"))
    want = {
        "Local": jheur.solve_local(instance),
        "Random(100)": jheur.solve_random(instance, 100),
        "Greedy": jheur.solve_greedy(instance),
        "BranchAndBound*": jilp.solve_branch_and_bound(instance),
    }
    for name, assign in want.items():
        assert got[name] == jmakespan(instance, assign), name
    ils = jmakespan(instance, jheur.solve_ils(instance, budget_s=0.5))
    for side in (got["ILS(0.5s)"], ils):
        assert got["BranchAndBound*"] <= side <= got["Greedy"]
    jilp.write_lp(instance, str(tmp_path / "reference.lp"))
    assert (tmp_path / "port.lp").read_bytes() == \
        (tmp_path / "reference.lp").read_bytes()
    assert f"(exact ILP exported to {tmp_path / 'port.lp'})" in \
        capsys.readouterr().out


def test_quickstart_training_lowers_the_cost():
    _, hist = quickstart.train_policy(quickstart.rl_config(), "cpu")
    cost = [h["cost_mean"] for h in hist]
    assert len(cost) == 60 and all(np.isfinite(cost))
    assert np.mean(cost[-10:]) < np.mean(cost[:10])


def test_quickstart_decision_with_the_reference_policy(instance, capsys):
    cfg = quickstart.rl_config(num_batches=3)
    jcfg = JRLConfig(
        policy=JPolicyConfig(d_model=32, ff_hidden=64, edge_layers=2,
                             request_layers=1),
        instance=JInstanceConfig(**dataclasses.asdict(quickstart.ICFG)),
        batch_size=cfg.batch_size, num_samples=cfg.num_samples, lr=cfg.lr,
        num_batches=cfg.num_batches, seed=cfg.seed)
    params, state, _, _ = jtrain(jcfg)
    policy = CoRaiSPolicy(cfg.policy, device="cpu")
    load_reference_params(policy, _flat(params), _flat(state))
    got = quickstart.schedule(policy, instance,
                              torch.Generator().manual_seed(0))
    jinst = jax.tree.map(jnp.asarray, instance)
    lp = np.asarray(jpol.corais_apply(params, state, jinst, jcfg.policy,
                                      training=False)[0])
    want = np.asarray(jgreedy(lp))
    z = int(instance["req_mask"].sum())
    top2 = np.sort(lp[:z], -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > GAP
    assert clear.sum() >= z // 2
    np.testing.assert_array_equal(got["greedy"][:z][clear], want[:z][clear])
    assert got["greedy_makespan"] == jmakespan(instance, want)
    assert got["sampled_makespan"] <= got["greedy_makespan"] + 1e-6
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("  CoRaiS(256)      makespan=")


# -- workload_replay -------------------------------------------------------------


def test_workload_replay_equals_live_and_the_reference(capsys):
    got = workload_replay.main([])
    assert capsys.readouterr().out.splitlines()[-1] == "OK"
    live = workload_replay.completion_metrics(got["live"])
    assert live == workload_replay.completion_metrics(got["replay"])
    sim = JSim(JCfg(num_edges=5, seed=0), JCC(scheduler="greedy"))
    want = sim.drive(jscenario("flash_crowd_10x"), until=3.0, run_until=400.0)
    assert live == workload_replay.completion_metrics(want)
    assert live["completed"] == live["submitted"] > 0


# -- train_lm --------------------------------------------------------------------

STEPS, INTERRUPT, BATCH, SEQ, LR = 16, 12, 4, 16, 1e-3


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The twin from the reference's init, and the reference example's
    step run without a break from the same init (losses, and the state
    after step 10, where the twin's run checkpoints)."""
    jcfg = jreduced("olmo-1b")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_reduced_config("olmo-1b")
    init = lm.init_params(cfg, generator=torch.Generator().manual_seed(5))
    load_reference_lm_params(init, _flat(jparams))
    ckpt = tmp_path_factory.mktemp("train_lm") / "ckpt"
    port = train_lm.pretrain(cfg, steps=STEPS, interrupt=INTERRUPT,
                             batch=BATCH, seq=SEQ, lr=LR, ckpt_dir=str(ckpt),
                             device="cpu", arch="olmo-1b", init=init)

    ref = _reference_example("train_lm")
    step, adam = ref.build(jcfg, LR)
    params, opt = jparams, jadam_init(jparams, adam)
    pipe = ref.SyntheticTokens(jcfg.vocab_size, BATCH, SEQ)
    losses, at_10 = [], None
    for i in range(STEPS):
        params, opt, loss = step(params, opt,
                                 jax.tree.map(jnp.asarray, next(pipe)))
        losses.append(float(loss))
        if i == 10:
            at_10 = _flat({"params": params, "opt": opt})
    return {"port": port, "losses": losses, "at_10": at_10, "ckpt": ckpt,
            "jcfg": jcfg, "adam": adam}


def test_train_lm_losses_across_the_crash(train_runs):
    port, want = train_runs["port"], train_runs["losses"]
    assert port["start"] == 11 and port["pipeline_step"] == STEPS
    np.testing.assert_allclose(port["losses"],
                               want[:INTERRUPT] + want[11:], **TOL)


def test_train_lm_checkpoint_reads_in_the_reference(train_runs):
    jcfg, adam = train_runs["jcfg"], train_runs["adam"]
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    restored = JCheckpointer(str(train_runs["ckpt"])).restore_latest(
        {"params": shapes, "opt": jax.eval_shape(
            lambda: jadam_init(shapes, adam))})
    assert restored["step"] == 10
    assert restored["extras"] == {"pipeline": {"seed": 0, "step": 11}}
    got = _flat(restored["tree"])
    assert set(got) == set(train_runs["at_10"])
    for k, w in train_runs["at_10"].items():
        np.testing.assert_allclose(got[k], w, **TOL, err_msg=k)


# -- serve_multi_edge ------------------------------------------------------------

PHI = (0.004, 0.01)  # a, b of every edge: the lanes make the difference


def test_serve_multi_edge_dispatch_and_service(capsys):
    edges = serve_multi_edge.spin_up(get_reduced_config("olmo-1b"), "cpu")
    for be in edges:
        be.phi = PhiEstimator(a=PHI[0], b=PHI[1], frozen=True)
    reqs = serve_multi_edge.burst(9, np.random.default_rng(0))
    assign, share = serve_multi_edge.dispatch(edges, reqs)

    states = [jstate.EdgeServiceState(
        edge_id=i, coords=(float(i), 0.0),
        phi=jstate.PhiEstimator(a=PHI[0], b=PHI[1], frozen=True),
        replicas=ln) for i, ln in enumerate(serve_multi_edge.LANES)]
    jreqs = [jstate.QueuedRequest(rid=r.rid, data_size=r.data_size,
                                  source_edge=r.source_edge) for r in reqs]
    w = np.abs(np.arange(3)[:, None] - np.arange(3)[None]).astype(
        np.float32) * 1e-4
    want = jheur.solve_greedy(jstate.snapshot_instance(states, jreqs, w,
                                                       ct=1.0))
    np.testing.assert_array_equal(assign, want)

    serve_multi_edge.serve(edges, reqs, assign)
    assert serve_multi_edge.real_done(edges) == len(reqs)
    for i, be in enumerate(edges):
        assert sorted(r for r in be.finished if r < serve_multi_edge.WARM) \
            == [r.rid for r, t in zip(reqs, assign) if t == i]
    assert share[2] >= share[0] and sum(share.values()) == len(reqs)
    assert "== all 9 requests served in" in capsys.readouterr().out
