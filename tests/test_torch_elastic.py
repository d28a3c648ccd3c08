"""Elastic restart (``repro_torch.launch.elastic``) and the checkpointer's
sharded save and restore, on the CPU over gloo.

This file re-runs itself as a world of ranks (``python
tests/test_torch_elastic.py --world w --store ... --job ...``: one process
that imports torch and the port once and forks the ``w`` ranks) joined
through a ``FileStore`` under ``tmp_path`` (no TCP port), 240 s a stage
and 120 s a collective, and as the reference's phases (``--reference
A|B``, with 8 or 4 XLA host devices). Each rank writes its result beside
the job and its output to ``rankN.log``, which a failing test prints. The
stages run one after another, so that the file holds no more CPU cores
than its largest world.

* The checkpointer on a world of 2 with reduced olmo-1b's training state
  placed on (2, 1) and (1, 2) meshes: ``host_array`` gathers a DTensor
  whole; ``save`` writes one checkpoint from rank 0 alone, which the
  reference's ``restore_pytree`` reads back equal to the full tensors;
  ``restore_latest(template, specs=, mesh=)`` gives each rank exactly its
  spec's block of the saved arrays; a missing leaf raises ``KeyError``, a
  wrong shape ``ValueError``; an async save followed by ``wait()`` on
  every rank is readable.
* The flow against the reference, from a step-0 checkpoint of the
  reference's own init (its ``lm.init_params(PRNGKey(0))``, ``adam_init``,
  a fresh pipeline) written by the reference's ``Checkpointer``: the
  reference's phase A (8 devices, (4, 2)) and the port's (8 ranks) each
  restore it and train 2 steps; then the port's phase B (4 ranks, (2, 2))
  on the reference's A checkpoint and the reference's phase B on the
  port's, each against the reference's B on its own: losses and saved
  arrays within 1e-5. Every port rank's restored blocks equal their
  specs' slices of the file bit for bit (worlds of 8 and 4).
* The orchestrator end to end (``--device cpu --steps 2``: 8 ranks, then
  4) and the example's wrapper around it.

The reference's children patch ``jax.make_mesh`` to the ``Auto`` axis
types: jax 0.9.0 makes ``Explicit`` axes by default, on which the
reference's elastic step does not trace (its embedding gather needs an
out sharding; ROADMAP C3 shows the same in ``test_multidevice.py``).
"""
import argparse
import datetime
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint import checkpointer as tckpt  # noqa: E402
from repro_torch.checkpoint.convert import (host_array,  # noqa: E402
                                            lm_train_tree,
                                            read_reference_checkpoint,
                                            reference_tensor)
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.launch import elastic  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import place  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import named_leaves  # noqa: E402
from repro_torch.optim import AdamConfig, adam_init  # noqa: E402
from repro_torch.sharding import specs as S  # noqa: E402

RANK_TIMEOUT_S = 240
GROUP_TIMEOUT_S = 120
TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "olmo-1b"
STEPS = 2
MESHES = {"data": (2, 1), "model": (1, 2)}


# -- what a rank checks --------------------------------------------------------


def _block(full: torch.Tensor, spec: tuple, sizes: dict, coord: dict):
    """The block of ``full`` that ``spec`` gives the rank at ``coord``
    ({axis: index}), cut by hand: each dimension split into equal parts
    over its entry's axes, row-major."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        parts, index = 1, 0
        for a in axes:
            parts, index = parts * sizes[a], index * sizes[a] + coord[a]
        n = full.shape[dim] // parts
        full = full.narrow(dim, index * n, n)
    return full


def _file_leaves(directory: str, template: dict) -> dict:
    """{port path: full tensor} of a checkpoint's leaves, each layer's row
    of a stacked leaf picked by hand."""
    flat = read_reference_checkpoint(directory)
    out = {}
    for path in named_leaves(template):
        parts = path.split("/")
        if "layers" in parts:
            i = parts.index("layers")
            key = "/".join(parts[:i + 1] + parts[i + 2:])
            out[path] = reference_tensor(flat[key])[int(parts[i + 1])]
        else:
            out[path] = reference_tensor(flat[path])
    return out


def _blocks_off(tree: dict, specs: dict, mesh, directory: str) -> list:
    """The leaves of ``tree`` (DTensors) whose local block is not their
    spec's slice of the checkpoint in ``directory`` bit for bit."""
    names = mesh.mesh_dim_names
    sizes = S.mesh_sizes(mesh)
    coord = dict(zip(names, mesh.get_coordinate()))
    want = _file_leaves(directory, tree)
    flat_specs = named_leaves(specs)
    bad = []
    for path, x in named_leaves(tree).items():
        block = _block(want[path], flat_specs[path], sizes, coord)
        local = x.to_local()
        if local.dtype != block.dtype or not torch.equal(local, block):
            bad.append(path)
    return bad


def _state(cfg, mesh=None, seed=3):
    """Reduced olmo-1b's parameters and an Adam state with random moments
    (the same on every rank), placed on ``mesh`` when given."""
    gen = torch.Generator().manual_seed(seed)
    params = lm.init_params(cfg, generator=gen)
    opt = adam_init(named_leaves(params), AdamConfig(lr=1e-3))
    for slot in ("m", "v"):
        opt[slot] = {k: torch.rand(v.shape, generator=gen)
                     for k, v in opt[slot].items()}
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    if mesh is None:
        return params, opt
    pspecs = S.param_specs(params, cfg, mesh)
    ospecs = S.opt_state_specs(opt, cfg, mesh)
    return (place(params, pspecs, mesh), place(opt, ospecs, mesh), pspecs,
            ospecs)


def _shapes(cfg):
    params = lm.init_params(cfg, generator=torch.Generator(), device="meta")
    return params, adam_init(named_leaves(params), AdamConfig(lr=1e-3))


def _checkpoint_job(rank: int, job: dict) -> dict:
    """The checkpointer on this world of 2: per mesh, the gather, one
    writer, the restore onto the mesh, the two errors, an async save."""
    cfg = get_reduced_config(ARCH)
    full_params, full_opt = _state(cfg)
    full = {**named_leaves(full_params, "params"),
            **named_leaves(full_opt, "opt_state")}
    out = {}
    for name, shape in MESHES.items():
        mesh = make_host_mesh(shape[1], device="cpu")
        params, opt, pspecs, ospecs = _state(cfg, mesh)
        placed = {**named_leaves(params, "params"),
                  **named_leaves(opt, "opt_state")}
        gathered_off = [k for k, x in placed.items() if not np.array_equal(
            host_array(x), host_array(full[k]))]
        root = os.path.join(job["dir"], name)
        writes = []
        real = tckpt.save_pytree
        with mock.patch.object(tckpt, "save_pytree", lambda *a, **k: (
                writes.append(a[1]), real(*a, **k))):
            Checkpointer(root, async_save=False).save(
                0, lm_train_tree(params, opt), extras={"pipeline": {
                    "seed": 0, "step": 5}})
        template = dict(zip(("params", "opt_state"), _shapes(cfg)))
        specs = {"params": pspecs, "opt_state": ospecs}
        ckpt = Checkpointer(root)
        restored = ckpt.restore_latest(template, specs=specs, mesh=mesh)
        off = _blocks_off(restored["tree"], specs, mesh,
                          os.path.join(root, "step_0000000000"))
        errors = {}
        missing = dict(template, extra=torch.empty(3, device="meta"))
        wrong = {"params": dict(template["params"], embed=torch.empty(
            3, 5, device="meta")), "opt_state": template["opt_state"]}
        for label, bad in (("missing", missing), ("shape", wrong)):
            try:
                ckpt.restore_latest(bad)
            except (KeyError, ValueError) as e:
                errors[label] = type(e).__name__
        ckpt.save(1, lm_train_tree(params, opt))  # async, then every rank
        ckpt.wait()
        again = ckpt.restore_latest(template, specs=specs, mesh=mesh)
        out[name] = {
            "gathered_off": gathered_off, "writes": writes,
            "step": restored["step"], "extras": restored["extras"],
            "blocks_off": off, "errors": errors,
            "async_step": again["step"],
            "async_blocks_off": _blocks_off(
                again["tree"], specs, mesh,
                os.path.join(root, "step_0000000001")),
            "placements_ok": all(
                tuple(x.placements) == S.placements(named_leaves(specs)[k],
                                                    mesh)
                for k, x in named_leaves(restored["tree"]).items())}
    return out


def _phase_job(rank: int, job: dict) -> dict:
    """``run_phase`` on this world, each rank's restored blocks checked
    against the checkpoint they came from."""
    checked = {}
    real = elastic.restore_phase

    def restore_and_check(*args, **kwargs):
        latest = Checkpointer(job["ckpt"]).latest_step()
        run = real(*args, **kwargs)
        directory = os.path.join(job["ckpt"], f"step_{latest:010d}")
        checked["blocks_off"] = _blocks_off(
            {"params": run["params"], "opt_state": run["opt_state"]},
            {"params": run["pspecs"], "opt_state": run["ospecs"]},
            run["mesh"], directory)
        return run

    with mock.patch.object(elastic, "restore_phase", restore_and_check):
        run = elastic.run_phase(job["phase"], elastic.PHASES[job["phase"]],
                                STEPS, job["ckpt"], ARCH, device="cpu")
    return {"losses": run["losses"], "start": run["start"], **checked}


# -- the spawn -----------------------------------------------------------------


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env.update(extra)
    return env


def _start(cmd, log: Path, env):
    # a session of its own, so that a child past its time is stopped with
    # the ranks it forked or the processes it started
    with open(log, "w") as f:
        return subprocess.Popen(cmd, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)


def _join(procs: dict, timeout=RANK_TIMEOUT_S) -> None:
    """Wait for {log path: process}; on a timeout kill them all, and fail
    on any non-zero exit with that child's log."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs.values():
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        pytest.fail(f"a child did not finish within {timeout} s")
    for log, p in procs.items():
        assert p.returncode == 0, \
            f"{log.name} failed:\n{log.read_text()[-4000:]}"


def _spawn_ranks(tmp: Path, job: dict, world: int) -> dict:
    """This file as a world of ``world`` ranks on ``job``; {log: process}
    (the process that forks the ranks)."""
    tmp.mkdir(parents=True, exist_ok=True)
    job_file = tmp / "job.pt"
    torch.save(job, job_file)
    log = tmp / "ranks.log"
    return {log: _start(
        [sys.executable, __file__, "--world", str(world), "--store",
         str(tmp / "store"), "--job", str(job_file)], log, _env())}


def _rank_results(tmp: Path, world: int) -> list:
    return [torch.load(tmp / f"rank{r}.out.pt", weights_only=False)
            for r in range(world)]


def _spawn_reference(tmp: Path, phase: str, ckpt: Path) -> dict:
    """The reference's phase in a child with its phase's device count."""
    tmp.mkdir(parents=True, exist_ok=True)
    devices = 8 if phase == "A" else 4
    env = _env(XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu")
    log = tmp / f"reference_{phase}.log"
    return {log: _start([sys.executable, __file__, "--reference", phase,
                         "--ckpt", str(ckpt), "--out",
                         str(tmp / f"reference_{phase}.json")], log, env)}


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """Destroy any process group a test started."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _write_reference_step0(directory: Path) -> None:
    """A step-0 checkpoint of the reference's own init, written by the
    reference's checkpointer, as its elastic phase A would save it."""
    import jax
    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.configs import get_reduced_config as jreduced
    from repro.data.synthetic import SyntheticTokens as JTokens
    from repro.models import lm as jlm
    from repro.optim import AdamConfig as JAdam
    from repro.optim import adam_init as jadam_init
    cfg = jreduced(ARCH)
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    opt = jadam_init(params, JAdam(lr=1e-3))
    pipe = JTokens(cfg.vocab_size, batch=elastic.BATCH, seq=elastic.SEQ)
    JCheckpointer(str(directory), every=1, async_save=False).save(
        0, {"params": params, "opt_state": opt},
        extras={"pipeline": pipe.state_dict()})


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """The elastic flows, the checkpointer's world of 2 and the
    orchestrator, one stage after another, none of more than 8 ranks.
    Returns the directories and the children's results."""
    tmp = tmp_path_factory.mktemp("elastic")
    ck = {n: tmp / n for n in ("ref", "port", "ref_for_port", "port_for_ref",
                               "cli")}
    _write_reference_step0(ck["ref"])
    shutil.copytree(ck["ref"], ck["port"])
    _join({**_spawn_ranks(tmp / "checkpoint", {"dir": str(
        tmp / "checkpoint")}, 2),
        **_spawn_reference(tmp / "ref_A", "A", ck["ref"])})
    _join(_spawn_ranks(tmp / "port_A", {"phase": "A", "ckpt": str(
        ck["port"])}, 8))
    shutil.copytree(ck["ref"], ck["ref_for_port"])
    shutil.copytree(ck["port"], ck["port_for_ref"])
    _join({**_spawn_reference(tmp / "ref_B", "B", ck["ref"]),
           **_spawn_reference(tmp / "ref_B_on_port", "B",
                              ck["port_for_ref"]),
           **_spawn_ranks(tmp / "port_B", {"phase": "B", "ckpt": str(
               ck["ref_for_port"])}, 4)})
    cli_log = tmp / "cli.log"
    _join({cli_log: _start(
        [sys.executable, "-m", "repro_torch.launch.elastic", "--device",
         "cpu", "--steps", str(STEPS), "--ckpt", str(ck["cli"])], cli_log,
        _env())})

    def ref(name, phase):
        return json.loads((tmp / name / f"reference_{phase}.json").read_text())

    return {
        "ck": ck, "cli_log": cli_log.read_text(),
        "checkpoint": _rank_results(tmp / "checkpoint", 2),
        "port_A": _rank_results(tmp / "port_A", 8),
        "port_B": _rank_results(tmp / "port_B", 4),
        "port_B_log": (tmp / "port_B" / "rank0.log").read_text(),
        "ref_A": ref("ref_A", "A"), "ref_B": ref("ref_B", "B"),
        "ref_B_on_port": ref("ref_B_on_port", "B")}


# -- the checkpointer on a world of 2 ------------------------------------------


@pytest.mark.parametrize("mesh_name", MESHES)
def test_host_array_gathers_a_dtensor_whole(flow, mesh_name):
    for rank in flow["checkpoint"]:
        assert rank[mesh_name]["gathered_off"] == []


@pytest.mark.parametrize("mesh_name", MESHES)
def test_one_rank_writes_one_checkpoint(flow, mesh_name):
    r0, r1 = flow["checkpoint"]
    assert r1[mesh_name]["writes"] == []
    assert [Path(d).name for d in r0[mesh_name]["writes"]] == [
        "step_0000000000"]
    root = Path(r0[mesh_name]["writes"][0]).parent
    assert sorted(p.name for p in root.iterdir()) == [
        "LATEST", "step_0000000000", "step_0000000001"]


@pytest.mark.parametrize("mesh_name", MESHES)
def test_the_reference_reads_the_sharded_save(flow, mesh_name):
    """The reference's ``restore_pytree`` reads the world's checkpoint; its
    leaves are the full tensors the ranks held in blocks."""
    import jax
    from repro.checkpoint.checkpointer import (_flatten_with_paths,
                                               restore_pytree)
    from repro.configs import get_reduced_config as jreduced
    from repro.models import lm as jlm
    from repro.optim import AdamConfig as JAdam
    from repro.optim import adam_init as jadam_init
    jcfg = jreduced(ARCH)
    jparams = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    jopt = jax.eval_shape(lambda: jadam_init(jparams, JAdam(lr=1e-3)))
    root = Path(flow["checkpoint"][0][mesh_name]["writes"][0]).parent
    tree, extras = restore_pytree({"params": jparams, "opt_state": jopt},
                                  str(root / "step_0000000000"))
    assert extras == {"pipeline": {"seed": 0, "step": 5}}
    params, opt = _state(get_reduced_config(ARCH))
    want = lm_train_tree(params, opt)
    got = {k: np.asarray(v) for k, v in _flatten_with_paths(tree)[0]}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w.numpy(), err_msg=k)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_restore_lays_each_rank_its_block(flow, mesh_name):
    for rank in flow["checkpoint"]:
        got = rank[mesh_name]
        assert got["step"] == 0
        assert got["extras"] == {"pipeline": {"seed": 0, "step": 5}}
        assert got["blocks_off"] == [] and got["placements_ok"]


@pytest.mark.parametrize("mesh_name", MESHES)
def test_restore_refuses_a_missing_leaf_and_a_wrong_shape(flow, mesh_name):
    for rank in flow["checkpoint"]:
        assert rank[mesh_name]["errors"] == {"missing": "KeyError",
                                             "shape": "ValueError"}


@pytest.mark.parametrize("mesh_name", MESHES)
def test_an_async_save_is_readable_after_every_rank_waits(flow, mesh_name):
    for rank in flow["checkpoint"]:
        assert rank[mesh_name]["async_step"] == 1
        assert rank[mesh_name]["async_blocks_off"] == []


def test_restore_latest_without_a_template_is_unchanged(tmp_path):
    """No process group: one writer, and ``restore_latest()`` gives the
    file's {path: ndarray} as before."""
    params, opt = _state(get_reduced_config(ARCH))
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(4, lm_train_tree(params, opt))
    got = ckpt.restore_latest()
    want = lm_train_tree(params, opt)
    assert got["step"] == 4 and set(got["tree"]) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got["tree"][k], w.numpy())


def test_restore_with_a_template_unstacks_the_layers(tmp_path):
    """Meshless, with a template: CPU tensors in the template's structure,
    each layer's row of the stacked leaf, the saved bits."""
    cfg = get_reduced_config(ARCH)
    params, opt = _state(cfg)
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    ckpt.save(2, lm_train_tree(params, opt))
    template = dict(zip(("params", "opt_state"), _shapes(cfg)))
    tree = ckpt.restore_latest(template)["tree"]
    want = {**named_leaves(params, "params"),
            **named_leaves(opt, "opt_state")}
    got = named_leaves(tree)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "cpu" and torch.equal(got[k], w), k
    assert isinstance(tree["params"]["layers"], list)


# -- the flow against the reference --------------------------------------------


def _saved(directory: Path, step: int) -> dict:
    return read_reference_checkpoint(str(directory / f"step_{step:010d}"))


def _arrays_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, **TOL, err_msg=k)


def test_port_phase_a_matches_the_reference(flow):
    ours = flow["port_A"][0]
    assert ours["start"] == 0
    np.testing.assert_allclose(ours["losses"], flow["ref_A"]["losses"],
                               **TOL)
    _arrays_close(_saved(flow["ck"]["port"], STEPS),
                  _saved(flow["ck"]["ref"], STEPS))


def test_port_phase_b_on_the_reference_checkpoint(flow):
    """The port restores the reference's A checkpoint onto (2, 2) and goes
    on as the reference's own phase B does."""
    ours = flow["port_B"][0]
    assert ours["start"] == STEPS
    np.testing.assert_allclose(ours["losses"], flow["ref_B"]["losses"],
                               **TOL)
    _arrays_close(_saved(flow["ck"]["ref_for_port"], 2 * STEPS),
                  _saved(flow["ck"]["ref"], 2 * STEPS))
    assert (f"[B] restored step {STEPS} onto mesh (2, 2) (4 devices)"
            in flow["port_B_log"])


def test_reference_phase_b_on_the_port_checkpoint(flow):
    np.testing.assert_allclose(flow["ref_B_on_port"]["losses"],
                               flow["ref_B"]["losses"], **TOL)
    _arrays_close(_saved(flow["ck"]["port_for_ref"], 2 * STEPS),
                  _saved(flow["ck"]["ref"], 2 * STEPS))


@pytest.mark.parametrize("phase,world", [("A", 8), ("B", 4)])
def test_each_rank_restores_its_block_of_the_file(flow, phase, world):
    ranks = flow[f"port_{phase}"]
    assert len(ranks) == world
    for rank in ranks:
        assert rank["blocks_off"] == []
        assert rank["losses"] == ranks[0]["losses"]


def test_the_orchestrator_shrinks_the_world(flow):
    log = flow["cli_log"]
    for line in ("== phase A: 8 devices ==", "== phase B: 4 devices ==",
                 f"[B] restored step {STEPS} onto mesh (2, 2) (4 devices)",
                 "elastic restart OK: trained, shrank the mesh 8->4, "
                 "resumed."):
        assert line in log, log[-3000:]
    assert Checkpointer(str(flow["ck"]["cli"])).latest_step() == 2 * STEPS


def test_the_example_wraps_the_launcher():
    from repro_torch.examples import elastic_restart
    ran = []
    with mock.patch.object(elastic_restart.subprocess, "run", lambda cmd: (
            ran.append(cmd), mock.Mock(returncode=3))[1]):
        assert elastic_restart.main(["--device", "cpu"]) == 3
    assert ran == [[sys.executable, "-m", "repro_torch.launch.elastic",
                    "--steps", "4", "--device", "cpu"]]


def test_a_phase_needs_its_world():
    """A (4, 2) phase refuses a world of one; on CUDA the orchestrator
    refuses a phase with fewer cards than ranks, naming both."""
    with pytest.raises(ValueError, match="host mesh"):
        elastic.restore_phase((4, 2), "unused", ARCH, device="cpu")
    args = argparse.Namespace(steps=1, ckpt="unused", arch=ARCH)
    with mock.patch.object(torch.cuda, "device_count", return_value=1), \
            pytest.raises(RuntimeError, match="needs 8 CUDA devices.*1 "
                          "visible"):
        elastic._run_world("A", 8, args, torch.device("cuda"))


def test_the_launcher_and_the_examples_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.launch.elastic\n"
        "from repro_torch.examples import (elastic_restart, quickstart,"
        " serve_multi_edge, train_lm, workload_replay)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr


# -- the children --------------------------------------------------------------


def _reference_child(phase: str, ckpt: str, out: str) -> None:
    """The reference's ``run_phase`` with its losses recorded unrounded."""
    import jax
    from jax.sharding import AxisType
    import repro.launch.elastic as E
    make_mesh = jax.make_mesh
    jax.make_mesh = lambda shape, names, **kw: make_mesh(
        shape, names, axis_types=(AxisType.Auto,) * len(shape), **kw)
    losses = []
    E.float = lambda x: (losses.append(float(x)), float(x))[1]
    E.run_phase(phase, elastic.PHASES[phase], STEPS, ckpt, ARCH)
    Path(out).write_text(json.dumps({"losses": losses}))


def _rank_main(rank: int, world: int, store: str, job_path: str) -> None:
    """One rank: join the world over gloo on one thread, run its job and
    save the result beside the job."""
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        fn = _phase_job if "phase" in job else _checkpoint_job
        result = fn(rank, job)
        torch.save(result, Path(job_path).parent / f"rank{rank}.out.pt")
    finally:
        dist.destroy_process_group()


def _launch_ranks(world: int, store: str, job_path: str) -> int:
    """Fork ``world`` ranks from this process, which has imported torch and
    the port once for all of them; rank r writes its output to
    ``rank{r}.log`` beside the job. One rank failing stops the others, and
    its log is printed. Returns the exit code."""
    directory = Path(job_path).parent
    sys.stdout.flush()
    sys.stderr.flush()
    pids = {}
    for r in range(world):
        pid = os.fork()
        if pid == 0:
            code = 1
            try:
                fd = os.open(directory / f"rank{r}.log",
                             os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
                os.dup2(fd, 1)
                os.dup2(fd, 2)
                _rank_main(r, world, store, job_path)
                code = 0
            except BaseException:
                traceback.print_exc()
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
        pids[pid] = r
    failed = None
    while pids:
        pid, status = os.wait()
        r = pids.pop(pid)
        if os.waitstatus_to_exitcode(status) != 0 and failed is None:
            failed = r
            for other in pids:
                os.kill(other, signal.SIGKILL)
    if failed is None:
        return 0
    print(f"rank {failed} of {world} failed:\n"
          + (directory / f"rank{failed}.log").read_text()[-4000:])
    return 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int)
    ap.add_argument("--store")
    ap.add_argument("--job")
    ap.add_argument("--reference", choices=("A", "B"))
    ap.add_argument("--ckpt")
    ap.add_argument("--out")
    a = ap.parse_args()
    if a.reference is not None:
        _reference_child(a.reference, a.ckpt, a.out)
        sys.exit(0)
    sys.exit(_launch_ranks(a.world, a.store, a.job))
