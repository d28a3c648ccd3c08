"""The port's central controller, its decode helpers, the ``train`` and
``serve`` command lines and the asynchronous checkpointer, against the JAX
package's, on the CPU.

* The controller: ``tests/test_serving.py``'s small policy (d = 32) with
  the reference's parameters carried across by ``load_reference_params``.
  On every round's padded snapshot as the reference's controller recorded
  it, the port's greedy decision equals the reference's wherever the top-2
  gap exceeds 1e-4 (materialized and fused decode); a whole run (4 edges,
  40 requests) gives the reference's metrics, on a seed whose rounds hold
  no near-tie (asserted); ``corais-sample`` never costs more than greedy;
  the dead-source remap is the reference's.
* ``sampling_decode`` with injected samples picks the reference's
  candidate (cost within 1e-5); ``makespan_batch_samples`` within 1e-5;
  ``register_score_backend`` reaches ``corais_score``.
* Checkpoints written by either package's ``train corais`` are served by
  the other's ``serve``; an asynchronous save writes what a synchronous one
  does, and a second save waits for the first.
* ``evaluate_methods``' policy timer starts after the instance is staged.
"""
import json
import os
import sys
import threading
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode as jdec
from repro.core import objective as jobj
from repro.core import policy as jpol
from repro.core.instances import InstanceConfig as JInstanceConfig
from repro.core.instances import generate_instance
from repro.core.state import QueuedRequest as JRequest
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.serving import CentralController as JCC
from repro.serving import MultiEdgeSim as JSim
from repro.serving import SimConfig as JCfg
from repro_torch.checkpoint import (Checkpointer, load_reference_params,
                                    read_reference_checkpoint, train_tree)
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.core import decode as tdec
from repro_torch.core import evaluate as teval
from repro_torch.core import objective as tobj
from repro_torch.core import policy as tpol
from repro_torch.core.state import QueuedRequest
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain_cli
from repro_torch.serving import CentralController, MultiEdgeSim, SimConfig

torch.set_num_threads(1)

GAP = 1e-4
SMALL = dict(d_model=32, ff_hidden=64, edge_layers=1, request_layers=1)
WALL_KEYS = ("scheduler_decision_s", "decision_mean_s", "decision_p95_s",
             "decision_max_s")


def _flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.array(leaf)
    return out


@pytest.fixture(scope="module")
def pair():
    """The reference's small serving policy and the port's copy of it."""
    jcfg = jpol.PolicyConfig(**SMALL)
    params, state = jpol.corais_init(jax.random.PRNGKey(0), jcfg)
    policy = tpol.CoRaiSPolicy(tpol.PolicyConfig(**SMALL), device="cpu")
    load_reference_params(policy, _flat(params), _flat(state))
    return jcfg, params, state, policy


def _submit(sim, n=40, seed=0, window=2.0):
    """``tests/test_serving.py``'s open-loop workload."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        sim.submit(int(rng.integers(0, sim.cfg.num_edges)),
                   float(rng.uniform(0.1, 1.0)),
                   t=float(rng.uniform(0, window)))


def _t(inst):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in inst.items()}


def _gapped(policy, inst):
    """Real requests whose top-2 gap (plain head, eq-16 values) exceeds
    GAP."""
    tinst = _t(inst)
    with torch.no_grad():
        c, h = tpol.corais_encode(policy, tinst)
        _, tv = tpol.corais_score_decode(policy, c, h, tinst["edge_mask"],
                                         k=2, normalize=False,
                                         backend="torch")
    return (((tv[:, 0] - tv[:, 1]) > GAP) & tinst["req_mask"]).numpy()


@pytest.fixture(scope="module")
def reference_run(pair):
    """The reference's controller over a whole run, every round's padded
    snapshot and decision recorded, for both decode settings."""
    jcfg, params, state, _ = pair
    out = {}
    for fused in (False, True):
        cc = JCC(scheduler="corais", policy_params=params, policy_state=state,
                 policy_cfg=jcfg, z_pad=32, fused_decode=fused)
        rounds = []
        decide = cc._policy_assign

        def recording(inst, decide=decide, rounds=rounds):
            assign = decide(inst)
            rounds.append((inst, np.array(assign)))
            return assign

        cc._policy_assign = recording
        sim = JSim(JCfg(num_edges=4, seed=0), cc)
        _submit(sim)
        out[fused] = (rounds, sim.run(until=240.0))
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_controller_decisions_match_reference_on_its_snapshots(
        pair, reference_run, fused):
    _, _, _, policy = pair
    rounds, _ = reference_run[fused]
    cc = CentralController(scheduler="corais", policy=policy, z_pad=32,
                           fused_decode=fused)
    assert len(rounds) > 5
    for inst, want in rounds:
        got = cc._policy_assign(inst)
        assert got.dtype == np.int32 and got.shape == want.shape
        gapped = _gapped(policy, inst)
        np.testing.assert_array_equal(got[gapped], want[gapped])


def test_controller_run_matches_reference_metrics(pair, reference_run):
    _, _, _, policy = pair
    rounds, want = reference_run[False]
    # the seed's rounds hold no near-tie, so every decision is compared: a
    # request is gapped, or (a round of one request, whose normalized
    # embedding is exactly 0) every edge scores the same bits, and the
    # first-index rule sends it to edge 0 in both packages
    exact_ties = 0
    for inst, decided in rounds:
        n = int(inst["req_mask"].sum())
        tinst = _t(inst)
        with torch.no_grad():
            c, h = tpol.corais_encode(policy, tinst)
            lp = tpol.corais_score(policy, c, h, tinst["edge_mask"],
                                   backend="torch")[:n][:, inst["edge_mask"]]
        tied = (lp == lp[:, :1]).all(-1).numpy()
        assert (_gapped(policy, inst)[:n] | tied).all()
        assert (decided[:n][tied] == 0).all()
        exact_ties += int(tied.sum())
    assert exact_ties <= 1
    cc = CentralController(scheduler="corais", policy=policy, z_pad=32)
    sim = MultiEdgeSim(SimConfig(num_edges=4, seed=0), cc)
    _submit(sim)
    got = sim.run(until=240.0)
    assert got["completed"] == 40
    assert ({k: v for k, v in got.items() if k not in WALL_KEYS}
            == {k: v for k, v in want.items() if k not in WALL_KEYS})
    assert cc.last_decision_time < 1.0


@pytest.mark.parametrize("fused", [False, True])
def test_sampled_controller_never_costs_more_than_greedy(pair, reference_run,
                                                         fused):
    _, _, _, policy = pair
    rounds, _ = reference_run[False]
    greedy = CentralController(scheduler="corais", policy=policy, z_pad=32)
    sample = CentralController(scheduler="corais-sample", policy=policy,
                               z_pad=32, sample_n=16, fused_decode=fused)
    assert sample.decision_spec().mode == "sample"
    better = 0
    for inst, _ in rounds:
        tinst = _t(inst)
        costs = [float(tobj.makespan(tinst, torch.as_tensor(cc._policy_assign(
            inst)))) for cc in (greedy, sample)]
        assert costs[1] <= costs[0] * (1 + 1e-6)
        better += costs[1] < costs[0]
    assert better > 0  # the draws do find cheaper dispatches


def _dead_source_round(pkg):
    """One round on a 6-edge cluster whose edges 0 and 3 are dead, with
    requests from dead and alive sources: the snapshot's sources and the
    dispatch."""
    sim_cls, cfg_cls, cc_cls, req_cls, snap_mod = pkg
    seen = []
    cc = cc_cls(scheduler="greedy", z_pad=8)
    sim = sim_cls(cfg_cls(num_edges=6, seed=4), cc)
    for e in (0, 3):
        sim.edges[e].alive = False
    pending = [req_cls(rid=i, data_size=0.2 + 0.1 * i, source_edge=src)
               for i, src in enumerate((0, 3, 1, 0, 5, 3))]
    real = snap_mod.snapshot_instance

    def recording(*args, **kwargs):
        inst = real(*args, **kwargs)
        seen.append(inst)
        return inst

    with mock.patch.object(snap_mod, "snapshot_instance", recording):
        out = cc.schedule(sim.edges, pending, sim.w, 1.0)
    return seen[0], [(r.rid, e) for r, e in out]


def test_dead_source_remap_matches_reference():
    import repro.serving.controller as jctl
    import repro_torch.serving.controller as tctl
    want_inst, want = _dead_source_round((JSim, JCfg, JCC, JRequest, jctl))
    got_inst, got = _dead_source_round((MultiEdgeSim, SimConfig,
                                        CentralController, QueuedRequest,
                                        tctl))
    assert got == want
    for k in want_inst:
        np.testing.assert_array_equal(got_inst[k], want_inst[k], err_msg=k)
    assert all(e not in (0, 3) for _, e in got)
    assert want_inst["edge_mask"].sum() == 4


# -- decode helpers -------------------------------------------------------------


def _decode_case(seed=0, s=24):
    rng = np.random.default_rng(seed)
    inst = generate_instance(rng, JInstanceConfig(num_edges=5,
                                                  num_requests=12,
                                                  max_edges=7,
                                                  max_requests=16))
    q, z = inst["edge_mask"].shape[0], inst["req_mask"].shape[0]
    logits = rng.normal(size=(z, q)).astype(np.float32)
    logits[:, ~inst["edge_mask"]] = -1e9
    log_probs = logits - np.log(np.exp(logits - logits.max(-1, keepdims=True))
                                .sum(-1, keepdims=True)) - logits.max(
        -1, keepdims=True)
    samples = rng.integers(0, 5, size=(s, z)).astype(np.int32)
    samples[7] = samples[3]  # a duplicated minimum goes to the first
    samples[11] = np.argmax(log_probs, -1)  # a copy of the greedy candidate
    return inst, log_probs.astype(np.float32), samples


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampling_decode_with_injected_samples_matches_reference(seed):
    inst, log_probs, samples = _decode_case(seed)
    jinst = jax.tree.map(jnp.asarray, inst)
    with mock.patch.object(jdec, "sample_assignments",
                           lambda key, lp, n: jnp.asarray(samples)):
        want_a, want_c = jdec.sampling_decode(jax.random.PRNGKey(0), jinst,
                                              jnp.asarray(log_probs),
                                              len(samples))
    with mock.patch.object(tdec, "sample_assignments",
                           lambda g, lp, n: torch.as_tensor(samples).long()):
        got_a, got_c = tdec.sampling_decode(torch.Generator(), _t(inst),
                                            torch.as_tensor(log_probs),
                                            len(samples))
    assert got_a.dtype == torch.int32
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(float(got_c), float(want_c), rtol=1e-5)


def test_sampling_decode_draws_keep_the_greedy_candidate():
    inst, log_probs, _ = _decode_case(3)
    tinst, lp = _t(inst), torch.as_tensor(log_probs)
    greedy = tdec.greedy_decode(lp)
    for seed in range(4):
        a, c = tdec.sampling_decode(torch.Generator().manual_seed(seed),
                                    tinst, lp, 32)
        assert float(c) <= float(tobj.makespan(tinst, greedy))
        assert float(c) == float(tobj.makespan(tinst, a))
        assert bool((a[inst["req_mask"]] < 5).all())


def test_makespan_batch_samples_matches_reference():
    inst, _, samples = _decode_case(4, s=40)
    want = jobj.makespan_batch_samples(jax.tree.map(jnp.asarray, inst),
                                       jnp.asarray(samples))
    got = tobj.makespan_batch_samples(_t(inst), torch.as_tensor(samples))
    assert got.shape == (40,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_register_score_backend_is_reached_by_corais_score(pair):
    _, _, _, policy = pair
    calls = []

    def probe(c, h, wx, wy, mask, clip):
        calls.append(c.shape)
        return tpol.SCORE_BACKENDS["torch"](c, h, wx, wy, mask, clip)

    inst, _, _ = _decode_case(5)
    tinst = _t(inst)
    tpol.register_score_backend("probe", probe)
    try:
        assert "probe" in tpol.list_score_backends()
        with torch.no_grad():
            c, h = tpol.corais_encode(policy, tinst)
            got = tpol.corais_score(policy, c, h, tinst["edge_mask"],
                                    backend="probe")
            want = tpol.corais_score(policy, c, h, tinst["edge_mask"],
                                     backend="torch")
    finally:
        tpol.SCORE_BACKENDS.pop("probe")
    assert calls == [c.shape]
    assert torch.equal(got, want)


# -- command lines and checkpoints ---------------------------------------------


def _served_metrics(module, argv, monkeypatch):
    """Run a ``serve`` module's ``main`` on ``argv`` (through ``sys.argv``
    for the reference) and return the metrics its simulator ran to."""
    runs = []
    sim_cls = module.MultiEdgeSim

    class Recording(sim_cls):
        def run(self, until):
            runs.append(super().run(until))
            return runs[-1]

    monkeypatch.setattr(module, "MultiEdgeSim", Recording)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    module.main()
    return runs[0]


SERVE = ["--scheduler", "corais", "--policy-dim", "32", "--edges", "4",
         "--requests", "40", "--until", "240"]


def test_port_trained_checkpoint_is_served_by_both_packages(tmp_path,
                                                            monkeypatch):
    ck = str(tmp_path / "ck")
    policy, opt, hist = ttrain_cli.main(
        ["corais", "--device", "cpu", "--batch-size", "8", "--samples", "4",
         "--batches", "2", "--policy-dim", "32", "--ckpt", ck,
         "--ckpt-every", "1"])
    assert [h["batch"] for h in hist] == [0, 1]
    assert sorted(os.listdir(ck)) == ["LATEST", "step_0000000001",
                                      "step_0000000002"]
    with open(os.path.join(ck, "step_0000000002", "manifest.json")) as f:
        keys = {e["key"] for e in json.load(f)["leaves"]}
    want_keys = set(tckpt.flatten_tree(train_tree(policy, opt)))
    assert keys == want_keys
    assert {"params/w_px", "state/edge_layers/0/norm1/count",
            "opt_state/step"} <= keys
    argv = SERVE + ["--policy-ckpt", ck]
    want = _served_metrics(jserve, argv, monkeypatch)
    got = tserve.main(argv + ["--device", "cpu"])
    assert want["completed"] == got["completed"] == 40
    assert ({k: v for k, v in got.items() if k not in WALL_KEYS}
            == {k: v for k, v in want.items() if k not in WALL_KEYS})


def test_reference_trained_checkpoint_is_served_by_the_port(tmp_path,
                                                            monkeypatch):
    ck = str(tmp_path / "ck")
    monkeypatch.setattr(sys, "argv", [
        "train", "corais", "--batch-size", "4", "--samples", "2",
        "--batches", "1", "--policy-dim", "32", "--edges", "3",
        "--requests", "8", "--ckpt", ck])
    jtrain.main()
    m = tserve.main(SERVE + ["--policy-ckpt", ck, "--device", "cpu"])
    assert m["completed"] == 40 and m["decision_rounds"] > 0


def test_train_resumes_at_the_batch_after_the_checkpoint(tmp_path):
    """A rerun on the same directory resumes at ``step + 1`` (the
    reference's rule) and ends where the same batches continued in memory
    end, bit for bit."""
    ck = str(tmp_path / "ck")
    argv = ["corais", "--device", "cpu", "--batch-size", "8", "--samples",
            "4", "--batches", "2", "--policy-dim", "32", "--ckpt", ck,
            "--ckpt-every", "1"]
    live, opt, _ = ttrain_cli.main(argv)
    resumed, _, hist = ttrain_cli.main(argv)
    assert [h["batch"] for h in hist] == [3, 4]
    from repro_torch.core import train as ttrain
    cfg = ttrain.RLConfig(policy=tpol.PolicyConfig(d_model=32), batch_size=8,
                          num_samples=4)
    live, _, _ = ttrain.train(cfg, num_batches=2, policy=live, opt_state=opt,
                              start_batch=3)
    for k, v in live.state_dict().items():
        assert torch.equal(v, resumed.state_dict()[k]), k


def test_train_lm_names_what_is_missing(monkeypatch):
    """``train lm`` runs every token-input family
    (tests/test_torch_lm_train.py); what it refuses, as the reference's
    does, is named before anything is allocated: an encoder-decoder arch
    (whisper), on a device this machine has no memory on. MoE training is
    no longer refused: mixtral gets as far as allocating its weights
    there."""
    monkeypatch.setattr(ttrain_cli, "resolve_device", torch.device)
    with pytest.raises(SystemExit, match="token-input decoder"):
        ttrain_cli.main(["lm", "--arch", "whisper-tiny", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain_cli.main(["lm", "--arch", "mixtral-8x7b", "--device",
                         "cuda"])


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 3, generator=g),
                       "layers": {"0": {"b": torch.randn(3, generator=g)}}},
            "opt_state": {"step": torch.tensor(3, dtype=torch.int32)}}


def test_async_save_writes_what_a_synchronous_save_writes(tmp_path):
    tree = _tree()
    a = Checkpointer(str(tmp_path / "async"))
    s = Checkpointer(str(tmp_path / "sync"), async_save=False)
    saved = tree["params"]["w"].clone()
    a.save(5, tree, extras={"k": 1})
    # the tree may change in place once save returns
    tree["params"]["w"].add_(1.0)
    a.wait()
    tree["params"]["w"].copy_(saved)
    s.save(5, tree, extras={"k": 1})
    for ck in (a, s):
        assert ck.latest_step() == 5
    with open(os.path.join(a._dir(5), "manifest.json")) as f:
        ma = json.load(f)
    with open(os.path.join(s._dir(5), "manifest.json")) as f:
        assert json.load(f) == ma
    ra = read_reference_checkpoint(a._dir(5))
    rs = read_reference_checkpoint(s._dir(5))
    assert sorted(ra) == sorted(rs)
    for k in ra:
        assert ra[k].dtype == rs[k].dtype
        np.testing.assert_array_equal(ra[k], rs[k], err_msg=k)


def test_second_save_waits_for_the_first(tmp_path, monkeypatch):
    gate = threading.Event()
    real = tckpt.save_pytree
    calls = []

    def gated(tree, directory, extras=None):
        calls.append(os.path.basename(directory))
        if len(calls) == 1:
            assert gate.wait(timeout=30)
        real(tree, directory, extras)

    monkeypatch.setattr(tckpt, "save_pytree", gated)
    ck = Checkpointer(str(tmp_path / "ck"), every=1)
    ck.save(1, _tree(1))  # returns with its write held at the gate
    second = threading.Thread(target=ck.save, args=(2, _tree(2)))
    second.start()
    time.sleep(0.3)
    assert second.is_alive()  # waiting for the first save
    assert calls == ["step_0000000001"] and ck.latest_step() is None
    gate.set()
    second.join(timeout=30)
    assert not second.is_alive()
    ck.wait()
    assert calls == ["step_0000000001", "step_0000000002"]
    assert ck.latest_step() == 2
    assert sorted(d for d in os.listdir(ck.root) if d.startswith("step_")) \
        == ["step_0000000001", "step_0000000002"]


def test_a_failed_background_save_raises_on_wait(tmp_path, monkeypatch):
    def broken(tree, directory, extras=None):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "save_pytree", broken)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # raised once


# -- the policy timer in evaluate_methods ---------------------------------------


def test_policy_solve_time_excludes_staging(pair, monkeypatch):
    """The timed region of ``_policy_method`` holds no host-to-device
    staging: no numpy array becomes a tensor and no tensor moves to a
    device between its two clock reads."""
    _, _, _, policy = pair
    window = {"open": False, "reads": 0}
    staged = {"inside": 0, "outside": 0}

    class Clock:
        @staticmethod
        def perf_counter():
            window["reads"] += 1
            window["open"] = not window["open"]
            return time.perf_counter()

    def count(fn):
        def wrapped(*args, **kwargs):
            staged["inside" if window["open"] else "outside"] += 1
            return fn(*args, **kwargs)
        return wrapped

    real_to = torch.Tensor.to

    def to(self, *args, **kwargs):
        if any(isinstance(a, (str, torch.device)) for a in args) or \
                "device" in kwargs:
            staged["inside" if window["open"] else "outside"] += 1
        return real_to(self, *args, **kwargs)

    run = teval._policy_method(policy, "greedy", 1, 0)
    inst, _, _ = _decode_case(6)
    monkeypatch.setattr(teval, "time", Clock)
    monkeypatch.setattr(torch, "as_tensor", count(torch.as_tensor))
    monkeypatch.setattr(torch, "from_numpy", count(torch.from_numpy))
    monkeypatch.setattr(torch.Tensor, "to", to)
    assign, dt = run(inst)
    assert window["reads"] == 2 and not window["open"]
    assert staged["outside"] >= len(inst) and staged["inside"] == 0
    assert dt >= 0 and assign.shape == inst["req_mask"].shape
