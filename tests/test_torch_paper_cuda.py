"""The paper's tables and the scenario sweep (``repro_torch.paper``) on a
card against the same twins on the CPU.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one. The file imports neither jax nor the reference, so it runs on a GPU
machine that has only torch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_paper_cuda.py

The policy is a narrow one (d = 32) that the port trains for two batches
on the CPU into a temporary cache, which both devices then load. Greedy
rows and deterministic sweep cells must equal the CPU's (decisions are
compared only above a 1e-4 top-2 gap, which the tests check first);
sampled outcomes lie within 5 standard errors of the CPU's. B1 launches
on every forward of the card runs.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import evaluate as teval
from repro_torch.core.heuristics import solve_greedy
from repro_torch.core.policy import corais_apply
from repro_torch.kernels import build
from repro_torch.nn.module import param_tree
from repro_torch.paper import common, scenario_sweep
from repro_torch.paper import table2_conventional as table2
from repro_torch.paper import table4_characteristics as table4

pytestmark = pytest.mark.cuda

D = 32
BATCHES = 2
TIMING = ("wall_s", "decision_mean_s", "decision_p95_s", "decision_max_s",
          "scheduler_decision_s")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cached(cuda_device, tmp_path, monkeypatch):
    """A narrow policy trained on the CPU into a temporary cache, the
    getters of the scripts pointed at its width."""
    monkeypatch.setattr(common, "RESULTS", str(tmp_path))
    getter = functools.partial(common.get_trained_policy, d_model=D)
    monkeypatch.setattr(table2, "get_trained_policy", getter)
    monkeypatch.setattr(common, "get_trained_policy", getter)
    cpu, _ = getter(5, 50, BATCHES, device="cpu", verbose=False)
    return cpu


def _rows(rows):
    return {r.split(",")[0]: r.split(",")[2] for r in rows}


def test_getter_loads_the_cpu_trained_policy_on_the_card(cached):
    policy, _ = common.get_trained_policy(5, 50, BATCHES, device="cuda")
    assert policy.device.type == "cuda"
    cpu = param_tree(cached)
    for k, p in param_tree(policy).items():
        assert torch.equal(p.cpu(), cpu[k]), k


def test_table2_on_the_card_equals_the_cpu(cached, monkeypatch):
    monkeypatch.setattr(teval, "solve_ils",
                        lambda inst, budget_s=1.0, seed=0: solve_greedy(inst))
    # one instance: the narrow policy's top-2 gaps lie above 1e-4 there
    kw = dict(n_instances=1, batches=BATCHES, ref_budget=0.5,
              sample_ns=(100,), verbose=False)
    gaps = []
    with torch.no_grad():
        for inst in common.eval_instances(5, 50, 1):
            t = {k: torch.as_tensor(np.asarray(v)) for k, v in inst.items()}
            top = corais_apply(cached, t).topk(2, dim=-1).values
            gaps.append(float((top[:, 0] - top[:, 1])[t["req_mask"]].min()))
    assert min(gaps) > 1e-4
    build.reset_launch_counts()
    card = _rows(table2.run(5, 50, device="cuda", **kw))
    launched = dict(build.LAUNCHES)
    cpu = _rows(table2.run(5, 50, device="cpu", **kw))
    assert list(card) == list(cpu)
    for name in cpu:
        if not name.endswith("CoRaiS(100)"):
            assert card[name] == cpu[name], name
    # CoRaiS(greedy) and CoRaiS(100): one forward an instance each
    assert launched["policy_score"] == 2
    assert launched["policy_score_decode"] == 0


def test_table4_on_the_card_within_5_se_of_the_cpu(cached):
    policy, _ = common.get_trained_policy(5, 50, BATCHES, device="cuda")
    for kind in table4.KINDS:
        card = table4.draws(kind, policy, trials=100)
        cpu = table4.draws(kind, cached, trials=100)
        for g, w in zip(card, cpu):
            se = np.sqrt((g.var(0, ddof=1) + w.var(0, ddof=1)) / 100)
            assert np.all(np.abs(g.mean(0) - w.mean(0)) <= 5 * se + 1e-9)
        assert card[0].sum(1).tolist() == [50.0] * 100


def test_sweep_on_the_card_equals_the_cpu(cached):
    backends = ["greedy", "local", "corais", "batched-greedy",
                "batched-local", "batched-corais"]
    scenarios = ["uniform_iid", "chaos-rolling-failure", "cloud-cache-churn"]
    kw = dict(batches=BATCHES, until=1.0, horizon=60.0, verbose=False)
    build.reset_launch_counts()
    card = scenario_sweep.run_sweep(scenarios, backends, device="cuda", **kw)
    assert build.LAUNCHES["policy_score"] > 0
    cpu = scenario_sweep.run_sweep(scenarios, backends, device="cpu", **kw)
    for name in scenarios:
        for b in backends:
            g, w = card["results"][name][b], cpu["results"][name][b]
            for k in w:
                if k in TIMING:
                    continue
                if isinstance(w[k], float):
                    assert g[k] == pytest.approx(w[k], rel=1e-4,
                                                 abs=1e-7), (name, b, k)
                else:
                    assert g[k] == w[k], (name, b, k)
