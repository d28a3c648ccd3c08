"""The paper's tables on the port (``repro_torch.paper``: ``common``,
Tables II-IV, Fig. 7) against the reference's scripts
(``benchmarks/*.py``) on the CPU.

The policy is the reference's ``corais_init`` at d = 32 with a fresh Adam
state, written with the reference's ``Checkpointer`` under the static
getter's tag at 800 batches into a temporary cache that both packages'
``RESULTS`` point to, inside the test only; the scripts' getters are
pointed at d = 32 the same way. The reference does not train.

* ``eval_instances``, ``scenario(kind)`` and ``csv_line`` equal the
  reference's bit for bit.
* Each package loads the other's cached policy, both ways, and the
  port's getters write the reference's tags and trees (1-2 batches of
  port training on the CPU, then the reference's getter loads them).
* The resilient getter trains only a fresh admit head on the static
  dispatch; the cloud getter's warm start scores exactly as the static
  policy.
* Table II/III rows equal the reference's on the deterministic methods
  (ILS, Local, Random(n), CoRaiS(greedy): ``cost=`` and ``gap=`` to 1e-5
  relative), with the same row names in the same order. ILS is
  time-budgeted, so both packages' ``solve_ils`` is patched to one fixed
  function inside the test.
* Sampled outcomes (Table IV's EReqN and LCost, Fig. 7's gap) are held
  by their law: within 5 standard errors of the reference's.
"""
import functools
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference's scripts import `benchmarks`
    sys.path.insert(0, str(ROOT))

import benchmarks.common as bcommon  # noqa: E402
import benchmarks.fig7_sampling as bfig7  # noqa: E402
import benchmarks.table2_conventional as btable2  # noqa: E402
import benchmarks.table3_generalization as btable3  # noqa: E402
import benchmarks.table4_characteristics as btable4  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.core import evaluate as jeval  # noqa: E402
from repro.core import heuristics as jheur  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.optim import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim import adam_init as jadam_init  # noqa: E402
from repro_torch.core import evaluate as teval  # noqa: E402
from repro_torch.core.policy import corais_apply  # noqa: E402
from repro_torch.nn.module import param_tree, state_tree  # noqa: E402
from repro_torch.paper import common as tcommon  # noqa: E402
from repro_torch.paper import fig7_sampling as tfig7  # noqa: E402
from repro_torch.paper import table2_conventional as ttable2  # noqa: E402
from repro_torch.paper import table3_generalization as ttable3  # noqa: E402
from repro_torch.paper import table4_characteristics as ttable4  # noqa: E402

torch.set_num_threads(2)
# the module: `repro.core.train` as an attribute is the function
jtrain = importlib.import_module("repro.core.train")

D = 32          # the tests' policy width
STATIC = 800    # the static getter's budget that the warm starts read
REL = 1e-5
SE = 5.0


def _flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.array(leaf)
    return out


def _write_reference(root, tag, pcfg, with_opt=True, step=STATIC):
    """The reference's seeded policy (and a fresh Adam state) saved with the
    reference's Checkpointer under ``root/tag``; its flat tree."""
    params, state = jpol.corais_init(jax.random.PRNGKey(0), pcfg)
    tree = {"params": params, "state": state}
    if with_opt:
        tree["opt_state"] = jadam_init(params, JAdamConfig(lr=3e-4))
    ck = JCheckpointer(os.path.join(root, tag), every=10**9, async_save=False)
    ck.save(step, tree)
    ck.wait()
    return _flat(tree)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A cache root holding the reference's d = 32 static policy."""
    root = str(tmp_path_factory.mktemp("paper_cache"))
    flat = _write_reference(root, f"policy_en5_rn50_d{D}_b{STATIC}",
                            jpol.PolicyConfig(d_model=D))
    return root, flat


@pytest.fixture
def paper(monkeypatch, cache):
    """Both packages' caches at ``cache`` and the scripts' getters at d = 32."""
    root, _ = cache
    monkeypatch.setattr(bcommon, "RESULTS", root)
    monkeypatch.setattr(tcommon, "RESULTS", root)
    for mod, common in ((btable2, bcommon), (btable3, bcommon),
                        (bfig7, bcommon), (ttable2, tcommon),
                        (ttable3, tcommon), (tfig7, tcommon)):
        monkeypatch.setattr(mod, "get_trained_policy", functools.partial(
            common.get_trained_policy, d_model=D))
    return root


def _fixed_ils(inst, budget_s=1.0, seed=0):
    """A deterministic stand-in for the time-budgeted ILS."""
    return jheur.solve_greedy(inst)


@pytest.fixture
def fixed_ils(monkeypatch):
    for mod in (jeval, teval, bfig7, tfig7):
        monkeypatch.setattr(mod, "solve_ils", _fixed_ils)


def _assert_params(policy, flat):
    for k, p in param_tree(policy).items():
        np.testing.assert_array_equal(p.detach().numpy(), flat[f"params/{k}"],
                                      err_msg=k)
    for k, b in state_tree(policy).items():
        np.testing.assert_array_equal(b.numpy(), flat[f"state/{k}"],
                                      err_msg=k)


def _manifest_keys(directory) -> set:
    step = open(os.path.join(directory, "LATEST")).read().strip()
    with open(os.path.join(directory, f"step_{int(step):010d}",
                           "manifest.json")) as f:
        return {e["key"] for e in json.load(f)["leaves"]}


# -- common ----------------------------------------------------------------------


def test_paper_twins_import_neither_jax_nor_the_reference():
    code = ("import sys; import repro_torch.paper.common, "
            "repro_torch.paper.table2_conventional, "
            "repro_torch.paper.table3_generalization, "
            "repro_torch.paper.table4_characteristics, "
            "repro_torch.paper.fig7_sampling, "
            "repro_torch.paper.scenario_sweep; "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', "
            "'benchmarks') or m.startswith(('jax.', 'repro.', "
            "'benchmarks.'))); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("en,rn,n", [(5, 50, 3), (10, 100, 2), (15, 150, 1)])
def test_eval_instances_equal_the_reference(en, rn, n):
    got = tcommon.eval_instances(en, rn, n)
    want = bcommon.eval_instances(en, rn, n)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


@pytest.mark.parametrize("kind", ttable4.KINDS)
def test_table4_scenarios_equal_the_reference(kind):
    got, want = ttable4.scenario(kind), btable4.scenario(kind)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_csv_line_and_rl_config_equal_the_reference():
    for args in (("a/b", 12.345, "gap=1.0"), ("x", 0.0, ""),
                 ("t", 1e6 / 3, "EReqN=1.00")):
        assert tcommon.csv_line(*args) == bcommon.csv_line(*args)
    assert tcommon.POLICY_DIM == bcommon.POLICY_DIM
    got, want = tcommon.rl_config(10, 100, 7), bcommon.rl_config(10, 100, 7)
    for field in ("batch_size", "num_samples", "lr", "num_batches", "seed"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.policy.d_model == want.policy.d_model
    assert (got.instance.num_edges, got.instance.num_requests) == \
        (want.instance.num_edges, want.instance.num_requests)
    assert tcommon.RESULTS.endswith(os.path.join("results", "torch"))


# -- the cached policies across the packages -----------------------------------


def test_port_loads_the_reference_cached_policy(paper, cache):
    _, flat = cache
    policy, cfg = tcommon.get_trained_policy(5, 50, STATIC, d_model=D,
                                             device="cpu")
    assert cfg.policy.d_model == D and policy.device.type == "cpu"
    _assert_params(policy, flat)


def test_reference_loads_the_port_trained_policy(paper, monkeypatch):
    policy, cfg = tcommon.get_trained_policy(5, 50, 2, d_model=D,
                                             device="cpu", verbose=False)
    tag = os.path.join(paper, f"policy_en5_rn50_d{D}_b2")
    want_keys = ({f"params/{k}" for k in param_tree(policy)}
                 | {f"state/{k}" for k in state_tree(policy)})
    assert want_keys < _manifest_keys(tag)
    assert {"opt_state/step", "opt_state/m/w_px",
            "opt_state/v/w_px"} <= _manifest_keys(tag)

    def no_training(*a, **k):
        raise AssertionError("the reference trained instead of loading")

    monkeypatch.setattr(bcommon, "train", no_training)
    params, state, jcfg = bcommon.get_trained_policy(5, 50, 2, d_model=D,
                                                     verbose=False)
    _assert_params(policy, _flat({"params": params, "state": state}))
    # and the port's reload of its own checkpoint is the same bits
    again, _ = tcommon.get_trained_policy(5, 50, 2, d_model=D, device="cpu")
    _assert_params(again, _flat({"params": params, "state": state}))


def _no_reference_training(monkeypatch):
    def no_training(*a, **k):
        raise AssertionError("the reference trained instead of loading")
    monkeypatch.setattr(jtrain, "temporal_train", no_training)


def test_temporal_getter_writes_the_reference_tree(paper, monkeypatch):
    policy, cfg = tcommon.get_temporal_policy(5, 1, d_model=D,
                                              device="cpu", verbose=False)
    assert (cfg.batch_size, cfg.lr, cfg.epoch_len, cfg.device_episodes) == \
        (8, 3e-4, 25, True)
    tag = os.path.join(paper, f"policy_temporal_en5_d{D}_b1_uniform_iid")
    _no_reference_training(monkeypatch)
    params, state, _ = bcommon.get_temporal_policy(5, 1, d_model=D,
                                                   verbose=False)
    flat = _flat({"params": params, "state": state})
    assert _manifest_keys(tag) == set(flat)
    _assert_params(policy, flat)


def test_port_loads_a_reference_resilient_policy(paper, cache):
    pcfg = jpol.PolicyConfig(d_model=D, admit_head=True, admit_bias=1.0)
    tag = (f"policy_resilient_admit_en5_d{D}_b3_chaos-rolling-failure")
    flat = _write_reference(paper, tag, pcfg, with_opt=False, step=3)
    policy, cfg = tcommon.get_resilient_policy(5, 3, d_model=D,
                                               device="cpu")
    assert cfg.freeze_dispatch and cfg.admission and cfg.policy.admit_head
    _assert_params(policy, flat)


def test_resilient_getter_trains_only_a_fresh_admit_head(paper, cache,
                                                         monkeypatch):
    _, static = cache
    policy, cfg = tcommon.get_resilient_policy(5, 1, d_model=D,
                                               device="cpu", verbose=False)
    assert (cfg.engine.max_per_round, cfg.lr, cfg.slo, cfg.slo_penalty) == \
        (64, 1e-3, 3.0, 10.0)
    params = param_tree(policy)
    assert any(k.startswith("admit/") for k in params)
    for k, p in params.items():  # the dispatch is the static policy's, frozen
        if not k.startswith("admit/"):
            np.testing.assert_array_equal(p.detach().numpy(),
                                          static[f"params/{k}"], err_msg=k)
    tag = os.path.join(
        paper, f"policy_resilient_admit_en5_d{D}_b1_chaos-rolling-failure")
    _no_reference_training(monkeypatch)
    jparams, jstate, _ = bcommon.get_resilient_policy(5, 1, d_model=D,
                                                      verbose=False)
    flat = _flat({"params": jparams, "state": jstate})
    assert _manifest_keys(tag) == set(flat)
    _assert_params(policy, flat)


def _tier_instance():
    inst = tcommon.eval_instances(5, 50, 1)[0]
    rng = np.random.default_rng(3)
    t = {k: torch.as_tensor(np.asarray(v)) for k, v in inst.items()}
    t["tier"] = torch.zeros(5)
    t["cache_frac"] = torch.as_tensor(rng.uniform(size=5), dtype=torch.float32)
    for key in ("req_slack", "req_priority", "req_cached"):
        t[key] = torch.as_tensor(rng.uniform(size=50), dtype=torch.float32)
    return t


def test_cloud_warm_start_scores_as_the_static_policy(paper, monkeypatch):
    seen = {}

    def no_steps(cfg, policy=None, callback=None, **kw):
        seen["policy"], seen["cfg"] = policy, cfg
        return policy, None, [{"cost_mean": 0.0, "batch": 0}]

    monkeypatch.setattr(tcommon, "temporal_train", no_steps)
    policy, cfg = tcommon.get_cloud_policy(5, 2, d_model=D, device="cpu",
                                           verbose=False)
    assert seen["policy"] is policy and cfg.policy.tier_features
    assert (cfg.deadline_penalty, cfg.engine.max_per_round) == (8.0, 64)
    static, _ = tcommon.get_trained_policy(5, 50, STATIC, d_model=D,
                                           device="cpu")
    w = param_tree(policy)
    assert w["edge_proj/w"].shape[0] == 10 and w["req_proj/w"].shape[0] == 6
    assert not w["edge_proj/w"][8:].any() and not w["req_proj/w"][3:].any()
    inst = _tier_instance()
    with torch.no_grad():
        got = corais_apply(policy, inst)
        want = corais_apply(static, inst)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_cloud_getter_writes_the_reference_tree(paper, monkeypatch):
    policy, _ = tcommon.get_cloud_policy(5, 1, d_model=D, device="cpu",
                                         verbose=False)
    tag = os.path.join(paper, f"policy_cloud_en5_d{D}_b1_cloud-cache-churn")
    _no_reference_training(monkeypatch)
    params, state, _ = bcommon.get_cloud_policy(5, 1, d_model=D,
                                                verbose=False)
    flat = _flat({"params": params, "state": state})
    assert _manifest_keys(tag) == set(flat)
    _assert_params(policy, flat)


# -- Tables II and III ----------------------------------------------------------


DETERMINISTIC = ("ILS(", "Local", "Random(", "CoRaiS(greedy)")


def _parse(rows):
    """{row name: {field: value}} in row order; the time is left out."""
    out = {}
    for row in rows:
        name, _, derived = row.split(",")
        out[name] = {k: float(v) for k, v in
                     (kv.split("=") for kv in derived.split(";"))}
    return out


def _assert_rows(got_rows, want_rows):
    got, want = _parse(got_rows), _parse(want_rows)
    assert list(got) == list(want)
    compared = 0
    for name, fields in want.items():
        if not name.rsplit("/", 1)[1].startswith(DETERMINISTIC):
            continue
        compared += 1
        for k, v in fields.items():
            assert got[name][k] == pytest.approx(v, rel=REL), (name, k)
    return compared


def _top2_gap(policy, instances):
    """The smallest top-2 log-prob gap over the instances' real requests:
    greedy decisions compare across the packages only above a tie."""
    gaps = []
    with torch.no_grad():
        for inst in instances:
            t = {k: torch.as_tensor(np.asarray(v)) for k, v in inst.items()}
            lp = corais_apply(policy, t)
            top = lp.topk(2, dim=-1).values
            gaps.append((top[..., 0] - top[..., 1])[t["req_mask"]].min())
    return float(min(gaps))


def test_table2_rows_equal_the_reference(paper, fixed_ils):
    kw = dict(n_instances=4, batches=STATIC, ref_budget=0.5,
              sample_ns=(100,), verbose=False)
    want = btable2.run(5, 50, **kw)
    got = ttable2.run(5, 50, device="cpu", **kw)
    policy, _ = tcommon.get_trained_policy(5, 50, STATIC, d_model=D,
                                           device="cpu")
    assert _top2_gap(policy, tcommon.eval_instances(5, 50, 4)) > 1e-4
    assert _assert_rows(got, want) == 6   # ILS, Local, Random x3, greedy
    assert [r.split(",")[0].rsplit("/", 1)[1] for r in got] == [
        "ILS(0.5s)", "Local", "Random(1)", "Random(100)", "Random(1000)",
        "CoRaiS(greedy)", "CoRaiS(100)"]
    assert _parse(got)["table2/EN5_RN50/ILS(0.5s)"]["gap"] == 1.0


def test_table3_rows_equal_the_reference(paper, fixed_ils):
    kw = dict(test_scales=((10, 100),), n_instances=2, batches=STATIC,
              ref_budget=0.5, verbose=False)
    want = btable3.run(**kw)
    got = ttable3.run(device="cpu", **kw)
    assert _assert_rows(got, want) == 4   # ILS, Local, Random(100), greedy
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]


# -- Table IV and Fig. 7: sampled, held by their law -----------------------------


@pytest.mark.parametrize("kind", ttable4.KINDS)
def test_table4_outcomes_within_5_se_of_the_reference(paper, cache, kind):
    trials = 100
    policy, cfg = tcommon.get_trained_policy(5, 50, STATIC, d_model=D,
                                             device="cpu")
    params, state, jcfg = bcommon.get_trained_policy(5, 50, STATIC,
                                                     d_model=D, verbose=False)
    want = btable4.run(kind, params, state, jcfg.policy, trials=trials)
    counts, costs = ttable4.draws(kind, policy, trials=trials)
    got = ttable4.run(kind, policy, trials=trials)
    np.testing.assert_array_equal(got[0], counts.mean(0))
    for g, w, per_trial, name in ((got[0], want[0], counts, "EReqN"),
                                  (got[1], want[1], costs, "LCost")):
        assert g.shape == w.shape == (5,)
        # the two means' difference: each a mean of `trials` draws of the
        # same law, whose variance the port's draws estimate
        se = np.sqrt(2 * per_trial.var(0, ddof=1) / trials)
        assert np.all(np.abs(g - w) <= SE * se + 1e-9), (name, g, w, se)
    assert counts.sum(1).tolist() == [50.0] * trials


def test_fig7_gap_within_5_se_of_the_reference(paper, fixed_ils, monkeypatch,
                                               capsys):
    samples, n_inst, runs = (1, 10), 2, 6
    monkeypatch.setattr(sys, "argv", [
        "fig7", "--instances", str(n_inst), "--batches", str(STATIC),
        "--samples", *map(str, samples)])
    bfig7.main()
    want = {r.split(",")[0]: _parse([r])[r.split(",")[0]]["gap"]
            for r in capsys.readouterr().out.splitlines()
            if r.startswith("fig7/")}
    gaps = {name: [] for name in want}
    for k in range(runs):   # the port's gap over independent draws
        rows = tfig7.run(10, 100, n_inst, STATIC, samples, seed=1000 * k,
                         verbose=False, device="cpu")
        assert [r.split(",")[0] for r in rows] == list(want)
        for name, fields in _parse(rows).items():
            gaps[name].append(fields["gap"])
    for name, w in want.items():
        g = np.asarray(gaps[name])
        se = np.sqrt(g.var(ddof=1) * (1 + 1 / runs))
        # (+ 1e-4: both gaps are printed to 4 decimals)
        assert abs(g.mean() - w) <= SE * se + 1e-4, (name, g, w)
