"""The scenario sweep on the port (``repro_torch.paper.scenario_sweep``)
against the reference's (``benchmarks/scenario_sweep.py``) on the CPU.

``run_sweep``'s report for the event-driven greedy, local and random
columns and the batched greedy, local and corais columns, on uniform_iid,
a chaos scenario and an edge-cloud scenario at a short arrival window and
horizon, equals the reference's in every field but the host-clock ones
(``wall_s``, ``decision_*_s``, ``scheduler_decision_s``): counts, names
and winners exactly; the event-driven cells' floats exactly (the port's
simulator reproduces the reference's metrics bit for bit); the batched
engine's floats to 1e-4 relative, the bar of a whole rollout held across
float32 arithmetics (ROADMAP "How parity is held"). The corais column's
policy is injected: the reference's ``corais_init`` at d = 32, written with
the reference's ``Checkpointer`` into a temporary cache that both
packages' getters read, inside the test only; the greedy decisions it
makes are compared only where they are not near-ties, which the test
checks first. An unknown ``batched-*`` backend fails fast with the
reference's ``ValueError`` in both packages.
"""
import functools
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference's script imports `benchmarks`
    sys.path.insert(0, str(ROOT))

import benchmarks.common as bcommon  # noqa: E402
import benchmarks.scenario_sweep as bsweep  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.optim import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim import adam_init as jadam_init  # noqa: E402
from repro_torch.paper import common as tcommon  # noqa: E402
from repro_torch.paper import scenario_sweep as tsweep  # noqa: E402

torch.set_num_threads(2)

D = 32
BATCHES = 800
SCENARIOS = ["uniform_iid", "chaos-rolling-failure", "cloud-cache-churn"]
BACKENDS = ["greedy", "local", "random", "batched-greedy", "batched-local",
            "batched-corais"]
SHORT = dict(until=1.0, horizon=60.0)
TIMING = ("wall_s", "decision_mean_s", "decision_p95_s", "decision_max_s",
          "scheduler_decision_s")
BATCHED_REL = 1e-4


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sweep_cache"))
    params, state = jpol.corais_init(jax.random.PRNGKey(0),
                                     jpol.PolicyConfig(d_model=D))
    ck = JCheckpointer(os.path.join(root, f"policy_en5_rn50_d{D}_b{BATCHES}"),
                       every=10**9, async_save=False)
    ck.save(BATCHES, {"params": params, "state": state,
                      "opt_state": jadam_init(params, JAdamConfig(lr=3e-4))})
    ck.wait()
    return root


@pytest.fixture(scope="module")
def reports(cache):
    """The reference's and the port's reports on the same scenarios and
    backends, the corais column's policy injected into both."""
    with pytest.MonkeyPatch.context() as mp:
        for common in (bcommon, tcommon):
            mp.setattr(common, "RESULTS", cache)
            mp.setattr(common, "get_trained_policy", functools.partial(
                common.get_trained_policy, d_model=D))
        want = bsweep.run_sweep(SCENARIOS, BACKENDS, batches=BATCHES,
                                verbose=False, **SHORT)
        got = tsweep.run_sweep(SCENARIOS, BACKENDS, batches=BATCHES,
                               verbose=False, device="cpu", **SHORT)
    return got, want


def _compare(got, want, where, rel):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            if k not in TIMING:
                _compare(got[k], want[k], f"{where}/{k}", rel)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, f"{where}/{i}", rel)
    elif isinstance(want, float) and not isinstance(got, str):
        assert got == pytest.approx(want, rel=rel, abs=rel * 1e-3), where
    else:
        assert type(got) is type(want) or (
            isinstance(got, (int, np.integer))
            and isinstance(want, (int, np.integer))), where
        assert got == want, where


def test_report_header_and_winners_equal_the_reference(reports):
    got, want = reports
    assert got["schema"] == want["schema"] == tsweep.REPORT_SCHEMA
    _compare(got["config"], want["config"], "config", 0.0)
    for key in ("winners", "slo_winners", "deadline_winners"):
        assert got[key] == want[key], key
    assert set(got["slo_winners"]) == {"chaos-rolling-failure"}
    assert set(got["deadline_winners"]) == {"cloud-cache-churn"}
    json.dumps(got, sort_keys=True)  # the report is JSON, as the script writes it


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_cell_equals_the_reference(reports, name, backend):
    got, want = reports
    g, w = got["results"][name][backend], want["results"][name][backend]
    assert set(TIMING) <= set(g)
    rel = BATCHED_REL if backend.startswith("batched-") else 0.0
    _compare(g, w, f"{name}/{backend}", rel)
    assert g["completed"] > 0


def test_injected_policy_has_no_near_ties_on_the_corais_cells(cache):
    """The batched corais cells compare greedy decisions across two float32
    arithmetics: every round's top-2 log-prob gap lies above 1e-4."""
    from repro_torch.core.policy import corais_apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcommon, "RESULTS", cache)
        policy, _ = tcommon.get_trained_policy(5, 50, BATCHES, d_model=D,
                                               device="cpu")
    gaps = []

    def recording(generator, inst):
        with torch.no_grad():
            lp = corais_apply(policy, inst)
        top = lp.topk(2, dim=-1).values
        real = inst["req_mask"]
        if real.any():
            gaps.append(float((top[..., 0] - top[..., 1])[real].min()))
        return lp.argmax(-1).to(torch.int32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsweep, "_engine_assign_fn",
                   lambda *a, **k: recording)
        for name in SCENARIOS:
            tsweep._run_batched("batched-corais", name, num_edges=5,
                                until=SHORT["until"], seed=0,
                                batches=BATCHES, device="cpu")
    assert gaps and min(gaps) > 1e-4, min(gaps)


@pytest.mark.parametrize("backend", ["batched-random", "batched-nope"])
def test_unknown_batched_backend_fails_fast(backend):
    messages = []
    for mod, kw in ((bsweep, {}), (tsweep, {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            mod.run_sweep(["uniform_iid"], ["greedy", backend], verbose=False,
                          **kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert f"no batched-engine backend {backend.split('-', 1)[1]!r}" \
        in messages[1]


def test_policy_backends_equal_the_reference():
    assert tsweep.POLICY_BACKENDS == bsweep.POLICY_BACKENDS
    assert tsweep.DEFAULT_SLO == bsweep.DEFAULT_SLO


def test_main_writes_the_report(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    report = tsweep.main(["--device", "cpu", "--scenarios", "uniform_iid",
                          "--backends", "greedy,local,batched-local",
                          "--until", "0.5", "--horizon", "20",
                          "--out", str(out)])
    written = json.loads(out.read_text())
    assert written["schema"] == "corais.scenario_sweep.v3"
    assert written["config"]["backends"] == ["greedy", "local",
                                             "batched-local"]
    assert written["results"]["uniform_iid"]["batched-local"]["engine"] == \
        "batched"
    assert report["winners"] == written["winners"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "== scenario sweep: 1 scenarios x 3 backends =="
    assert lines[-1] == f"== report written to {out} =="
    assert tsweep.RESULTS_DIR == os.path.dirname(tcommon.RESULTS)
