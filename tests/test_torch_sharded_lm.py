"""The LM's sharded steps (``repro_torch.launch.steps`` on a ("data",
"model") mesh, ROADMAP A4) on the CPU, at W = 2 over gloo.

This file re-runs itself as one subprocess per rank (``python
tests/test_torch_sharded_lm.py --rank r --world 2 --store ... --job
...``), joined through a ``FileStore`` under ``tmp_path`` (no TCP port),
each subprocess given 240 s and the group 120 s. Two worlds run at once:
mesh (2, 1), the batch over ``data`` with FSDP, and mesh (1, 2), tensor
parallelism over ``model``. The weights are the reference's, bridged into
the port; tokens come from numpy.

* Sharded equals meshless: the train step (two steps), prefill and three
  decode steps of reduced olmo-1b (train), qwen3-4b (prefill and decode,
  ``decode_flash_shardmap`` off and on), hymba-1.5b (all three; its
  attention weights replicated, its SSM leaves over ``model``) and, at
  (2, 1), mixtral-8x7b's train step with 2 dispatch groups, against the
  port's meshless steps: loss and metrics 1e-5 relative, parameters and
  Adam state 1e-5, logits 1e-5 of the largest. The other six
  architectures' prefill and decode at (1, 2) likewise.
* Sharded equals the reference: the same steps against the reference's
  single-device ``build_train_step`` on a 1 x 1 mesh (mixtral's with the
  same 2 dispatch groups), ``lm.prefill`` and ``lm.decode_step``, at
  ``tests/test_torch_lm_train.py``'s 1e-5. Adam's eps is 1e-3 on every
  side, for the reason ``tests/train_child.py`` gives (a near-zero
  gradient's reassociation noise would otherwise move a parameter by a
  sign-like lr).
* Storage: each rank holds its spec's share of every parameter, optimizer
  and cache leaf, no more, on the spec's placements.
* ``sharded_decode_attention`` at tp = 2 (a full cache, a window, an upper
  shard with no valid slot, a lane with none) equals the reference's
  ``decode_attention`` to 1e-5, and so does its plain version.
"""
import argparse
import contextlib
import dataclasses
import datetime
import functools
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ShapeConfig, get_reduced_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.nn import named_leaves  # noqa: E402
from repro_torch.optim import AdamConfig  # noqa: E402
from repro_torch.sharding import ctx as sctx  # noqa: E402
from repro_torch.sharding import specs as S  # noqa: E402

RANK_TIMEOUT_S = 240
GROUP_TIMEOUT_S = 120
TOL = dict(atol=1e-5, rtol=1e-5)
ADAM_EPS = 1e-3
LR = 1e-2
TRAIN = dict(batch=4, seq=32, steps=2)
SERVE = dict(batch=4, prompt=10, max_seq=24, decode=3)
MESHES = {"data": (2, 1), "model": (1, 2)}
# (arch, mesh) of the floor's train steps; (arch, flag, mesh) of its serving
TRAIN_CASES = [("olmo-1b", "data"), ("olmo-1b", "model"),
               ("hymba-1.5b", "data"), ("hymba-1.5b", "model"),
               ("mixtral-8x7b", "data")]
SERVE_CASES = [(arch, flag, m) for m in MESHES
               for arch, flag in (("qwen3-4b", False), ("qwen3-4b", True),
                                  ("hymba-1.5b", False))]
OTHER_ARCHS = ["mixtral-8x22b", "mistral-large-123b", "llama3-405b",
               "qwen2-vl-72b", "falcon-mamba-7b", "whisper-tiny"]
MOE_GROUPS = 2
# sharded_decode_attention: (B, W, H, KV, hd) and each case's positions
ATTN_SHAPE = (3, 32, 4, 2, 16)
ATTN_CASES = ["full", "window", "empty-upper-shard", "empty-lane"]


def _cfg(arch, flag=False):
    return dataclasses.replace(get_reduced_config(arch),
                               decode_flash_shardmap=flag)


def _train_shape():
    return ShapeConfig("t", TRAIN["seq"], TRAIN["batch"], "train")


def _serve_shape(kind):
    return ShapeConfig("s", SERVE["max_seq"], SERVE["batch"], kind)


def _to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _full_tree(tree):
    return {k: _full(v).detach().clone() for k, v in named_leaves(tree).items()}


def _patched_adam():
    return mock.patch.object(steps, "AdamConfig",
                             functools.partial(AdamConfig, eps=ADAM_EPS))


def _clone(params):
    if isinstance(params, dict):
        return {k: _clone(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_clone(v) for v in params]
    return params.clone()


# -- one run of each step, with or without a mesh -----------------------------


def run_train(case, mesh):
    """(params, opt_state, [metrics per step]) after TRAIN["steps"] steps,
    as full tensors; with a mesh also the leaves not on their spec's
    share."""
    cfg, params = case["cfg"], _clone(case["params"])
    knobs = steps.TrainKnobs(lr=LR)
    shape = _train_shape()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched_adam())
        if mesh is None:  # the sharded step's own rule gives these groups
            stack.enter_context(mock.patch.object(
                steps, "_dp_groups", return_value=case["groups"]))
        step = steps.build_train_step(cfg, mesh, knobs, shape)
        _, opt_init, _ = steps.make_optimizer(cfg, knobs)
    opt = opt_init(named_leaves(params))
    mets = []
    for batch in case["batches"]:
        params, opt, m = step(params, opt, _to_torch(batch))
        mets.append({k: float(_full(v)) for k, v in m.items()})
    out = {"params": _full_tree(params), "opt": _full_tree(opt),
           "metrics": mets}
    if mesh is not None:
        pspecs, ospecs, _ = step.in_specs
        out["off_share"] = (_off_share(params, pspecs, mesh)
                            + _off_share(opt, ospecs, mesh))
    return out


def run_serve(case, mesh):
    """The prefill's logits, each decode step's logits and the final
    cache, as full tensors; with a mesh also the parameter and cache leaves
    not on their share (the cache after the prefill and after the last
    step) and the redistributions."""
    cfg, params = case["cfg"], case["params"]
    prefill = steps.build_prefill(cfg, mesh, _serve_shape("prefill"))
    decode = steps.build_decode_step(cfg, mesh, _serve_shape("decode"))
    if mesh is not None:  # held on their placements, as a server holds them
        params = steps.place(params, prefill.in_specs[0], mesh)
    sctx.REDISTRIBUTES.clear()
    cache, logits = prefill(params, _to_torch(case["prompt"]))
    out = {"prefill": _full(logits).clone(), "decode": [], "off_share": []}
    if mesh is not None:
        out["off_share"] += _off_share(cache, decode.in_specs[1], mesh)
    for batch in case["decode"]:
        cache, logits = decode(params, cache, _to_torch(batch))
        out["decode"].append(_full(logits).clone())
    out["cache"] = _full_tree(cache)
    if mesh is not None:
        out["off_share"] += _off_share(cache, decode.in_specs[1], mesh)
        out["off_share"] += _off_share(params, decode.in_specs[0], mesh)
        out["redistributes"] = dict(sctx.REDISTRIBUTES)
    return out


def _off_share(tree, specs, mesh):
    """The leaves of ``tree`` that are not DTensors on their spec's
    placements holding exactly their spec's share of the bytes."""
    from torch.distributed.tensor import DTensor
    sizes = S.mesh_sizes(mesh)
    bad = []
    for k, x in named_leaves(tree).items():
        spec = specs[k]
        parts = 1
        for entry in spec:
            parts *= S._axsize(sizes, entry)
        if not isinstance(x, DTensor) or \
                tuple(x.placements) != S.placements(spec, mesh):
            bad.append((k, "placements"))
            continue
        local = x.to_local()
        if local.numel() * local.element_size() != \
                x.numel() // parts * x.element_size():
            bad.append((k, tuple(local.shape)))
    return bad


def run_attention(case, mesh):
    """``sharded_decode_attention`` and its plain version on DTensors
    placed as the reference's shard_map takes them."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    q, k, v, sp, pos, window = (case[n] for n in
                                ("q", "k", "v", "slot_pos", "pos", "window"))
    ctx = sctx.ShardCtx(mesh=mesh, dp_axes=("data",))
    row = (Shard(0), Replicate())
    blk = (Shard(0), Shard(1))

    def put(x, pl):
        return distribute_tensor(torch.from_numpy(x), mesh, pl,
                                 src_data_rank=None)

    args = (put(q, row), put(k, blk), put(v, blk), put(sp, blk),
            put(pos, (Shard(0),) * 1 + (Replicate(),)))
    with sctx.use_sharding(ctx):
        got = attention.sharded_decode_attention(*args, window=window,
                                                 ctx=ctx)
        plain = attention.sharded_decode_attention_torch(*args,
                                                         window=window,
                                                         ctx=ctx)
    return {"kernel": _full(got), "plain": _full(plain),
            "placements": tuple(got.placements)}


def _rank(rank, world, job):
    mesh = make_host_mesh(job["mesh"][1], device="cpu")
    out = {"train": {}, "serve": {}, "attention": {}}
    for name, case in job["train"].items():
        out["train"][name] = run_train(case, mesh)
    for name, case in job["serve"].items():
        out["serve"][name] = run_serve(case, mesh)
    for name, case in job["attention"].items():
        out["attention"][name] = run_attention(case, mesh)
    out["groups"] = steps._dp_groups(mesh, _cfg("mixtral-8x7b"),
                                     _train_shape())
    return out


# -- the spawn -----------------------------------------------------------------


def _spawn_ranks(tmp_path, job, world=2):
    """Start this file as ``world`` ranks on ``job``; returns a join
    function giving each rank's saved result."""
    job_file = tmp_path / "job.pt"
    torch.save(job, job_file)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), "--world",
                 str(world), "--store", str(tmp_path / "store"), "--job",
                 str(job_file)],
                env=env, stdout=log, stderr=subprocess.STDOUT))

    def join():
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            pytest.fail(f"a rank did not finish within {RANK_TIMEOUT_S} s")
        for r, p in enumerate(procs):
            assert p.returncode == 0, \
                f"rank {r} failed:\n{logs[r].read_text()[-4000:]}"
        return [torch.load(tmp_path / f"rank{r}.out.pt", weights_only=False)
                for r in range(world)]

    return join


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """Destroy any process group a test started."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# -- the inputs: the reference's weights, numpy batches -----------------------


def _reference_model(arch, flag=False):
    """(port cfg, reference cfg, reference params, port params), the
    reference's weights bridged into the port."""
    import jax
    from repro import configs as jconfigs
    from repro.checkpoint.checkpointer import _flatten_with_paths
    from repro.models import init_params as j_init_params
    from repro_torch.checkpoint import load_reference_lm_params
    cfg = _cfg(arch, flag)
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch),
                               decode_flash_shardmap=flag)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams)[0]}
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(9))
    load_reference_lm_params(params, flat)
    return cfg, jcfg, jparams, params


def _train_batches(cfg):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(TRAIN["steps"]):
        shape = (TRAIN["batch"], TRAIN["seq"])
        tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        labels[0, :5] = -100
        out.append({"tokens": tokens, "labels": labels})
    return out


def _serve_inputs(cfg):
    from repro_torch.data.synthetic import make_batch, make_decode_batch
    rng = np.random.default_rng(2)
    prompt = make_batch(rng, cfg, SERVE["batch"], SERVE["prompt"],
                        kind="prefill")
    if cfg.encoder_decoder:  # decoder tokens beside the frames
        prompt["tokens"] = rng.integers(
            0, cfg.vocab_size, (SERVE["batch"], SERVE["prompt"])).astype(
                np.int32)
    decode = []
    for i in range(SERVE["decode"]):
        b = make_decode_batch(rng, cfg, SERVE["batch"])
        if cfg.mrope:
            b["positions"] = np.full((3, SERVE["batch"]),
                                     SERVE["prompt"] + i, np.int32)
        decode.append(b)
    return prompt, decode


def _attention_case(name):
    b, w, h, kv, hd = ATTN_SHAPE
    rng = np.random.default_rng(ATTN_CASES.index(name))
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, w, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, w, kv, hd)).astype(np.float32)
    pos = np.array([w - 1, 20, 27], np.int32)
    slot_pos = np.broadcast_to(np.arange(w, dtype=np.int32), (b, w)).copy()
    window = None
    if name == "window":
        window = 9
    elif name == "empty-upper-shard":   # positions below W / 2 only
        pos = np.array([5, 15, 9], np.int32)
        slot_pos[:, w // 2:] = -1
    elif name == "empty-lane":          # lane 1 has no valid slot at all
        slot_pos[1] = -1
    slot_pos = np.where(slot_pos <= pos[:, None], slot_pos, -1).astype(
        np.int32)
    return dict(q=q, k=k, v=v, slot_pos=slot_pos, pos=pos, window=window)


@pytest.fixture(scope="module")
def cases():
    """{"train", "serve", "other"}: the port's inputs, with the
    reference's config and parameters beside them."""
    out = {"train": {}, "serve": {}, "other": {}}
    for arch, _ in TRAIN_CASES:
        if arch not in out["train"]:
            cfg, jcfg, jparams, params = _reference_model(arch)
            groups = MOE_GROUPS if cfg.num_experts else 1
            out["train"][arch] = dict(cfg=cfg, jcfg=jcfg, jparams=jparams,
                                      params=params, groups=groups,
                                      batches=_train_batches(cfg))
    for arch, flag, _ in SERVE_CASES:
        key = f"{arch}-flash" if flag else arch
        if key not in out["serve"]:
            cfg, jcfg, jparams, params = _reference_model(arch, flag)
            prompt, decode = _serve_inputs(cfg)
            out["serve"][key] = dict(cfg=cfg, jcfg=jcfg, jparams=jparams,
                                     params=params, prompt=prompt,
                                     decode=decode)
    for arch in OTHER_ARCHS:
        cfg = _cfg(arch)
        params = lm.init_params(cfg, generator=torch.Generator().manual_seed(3))
        prompt, decode = _serve_inputs(cfg)
        out["other"][arch] = dict(cfg=cfg, params=params, prompt=prompt,
                                  decode=decode)
    return out


def _port_only(case):
    return {k: v for k, v in case.items() if k not in ("jcfg", "jparams")}


@pytest.fixture(scope="module")
def spawned(cases, tmp_path_factory):
    """The two worlds started at once: {mesh name: join}."""
    joins = {}
    for mesh_name, shape in MESHES.items():
        job = {"mesh": shape,
               "train": {a: _port_only(cases["train"][a])
                         for a, m in TRAIN_CASES if m == mesh_name},
               "serve": {(f"{a}-flash" if f else a):
                         _port_only(cases["serve"][f"{a}-flash" if f else a])
                         for a, f, m in SERVE_CASES if m == mesh_name},
               "attention": {}}
        if mesh_name == "model":
            job["serve"].update(cases["other"])
            job["attention"] = {n: _attention_case(n) for n in ATTN_CASES}
        joins[mesh_name] = _spawn_ranks(
            tmp_path_factory.mktemp(f"sharded_{mesh_name}"), job)
    return joins


@pytest.fixture(scope="module")
def ranks(spawned, meshless, reference):
    """{mesh name: the ranks' results}, joined after this process has run
    the meshless and reference steps beside them."""
    return {name: join() for name, join in spawned.items()}


@pytest.fixture(scope="module")
def meshless(cases):
    """The port's meshless runs of every case."""
    return {"train": {a: run_train(c, None)
                      for a, c in cases["train"].items()},
            "serve": {k: run_serve(c, None)
                      for k, c in {**cases["serve"],
                                   **cases["other"]}.items()}}


# -- the reference -------------------------------------------------------------


def _reference_train(case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.launch import steps as jsteps
    from repro.optim.adam import AdamConfig as JAdamConfig
    jcfg = case["jcfg"]
    shape = JShapeConfig("t", TRAIN["seq"], TRAIN["batch"], "train")
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    knobs = jsteps.TrainKnobs(lr=LR, donate=False)
    with mock.patch.object(jsteps, "AdamConfig",
                           functools.partial(JAdamConfig, eps=ADAM_EPS)), \
            mock.patch.object(jsteps, "_dp_groups",
                              return_value=case["groups"]):
        step, _, _ = jsteps.build_train_step(jcfg, mesh, shape, knobs)
        _, opt_init, _ = jsteps.make_optimizer(jcfg, knobs)
    params = case["jparams"]
    opt = opt_init(params)
    mets = []
    for batch in case["batches"]:
        with mesh:
            params, opt, m = step(params, opt,
                                  jax.tree.map(jnp.asarray, batch))
        mets.append({k: float(v) for k, v in m.items()})
    return params, opt, mets


def _stacked(port_tree: dict, prefix: str) -> dict:
    """The port's per-layer leaves stacked as the reference's."""
    from repro_torch.checkpoint.convert import stack_layers
    return stack_layers({f"{prefix}/{k}": v for k, v in port_tree.items()})


@pytest.fixture(scope="module")
def reference(cases):
    """The reference's train steps (params and state flattened to the
    port's stacked paths, metrics) and serving logits."""
    import jax.numpy as jnp
    from repro.checkpoint.checkpointer import _flatten_with_paths
    from repro.models import lm as jlm
    out = {"train": {}, "serve": {}}
    for arch, case in cases["train"].items():
        params, opt, mets = _reference_train(case)
        flat = {k: np.asarray(v) for k, v in _flatten_with_paths(
            {"params": params, "opt_state": opt})[0]}
        out["train"][arch] = (flat, mets)
    for key, case in cases["serve"].items():
        jcfg, jparams = case["jcfg"], case["jparams"]
        cache, logits = jlm.prefill(
            jparams, {k: jnp.asarray(v) for k, v in case["prompt"].items()},
            jcfg, max_seq=SERVE["max_seq"])
        got = {"prefill": np.asarray(logits), "decode": []}
        for batch in case["decode"]:
            cache, logits = jlm.decode_step(
                jparams, cache, {k: jnp.asarray(v) for k, v in batch.items()},
                jcfg)
            got["decode"].append(np.asarray(logits))
        out["serve"][key] = got
    return out


# -- the tests -----------------------------------------------------------------


def _close(got, want, tol=TOL, where=""):
    torch.testing.assert_close(got.float(), want.float(), **tol,
                               msg=lambda m: f"{where}: {m}")


def _close_logits(got, want, where):
    """1e-5 of the largest |logit|."""
    scale = float(want.abs().max())
    _close(got, want, dict(atol=1e-5 * scale, rtol=0), where)


def _metrics_close(got, want, where):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w), where
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-6), \
                f"{where} {k}"


@pytest.mark.parametrize("arch,mesh_name", TRAIN_CASES)
def test_sharded_train_step_equals_meshless(arch, mesh_name, ranks, meshless):
    got = ranks[mesh_name][0]["train"][arch]
    want = meshless["train"][arch]
    _metrics_close(got["metrics"], want["metrics"], arch)
    for tree in ("params", "opt"):
        assert set(got[tree]) == set(want[tree])
        for k, w in want[tree].items():
            _close(got[tree][k], w, where=f"{arch} {tree} {k}")


@pytest.mark.parametrize("arch,mesh_name", TRAIN_CASES)
def test_sharded_train_step_equals_the_reference(arch, mesh_name, ranks,
                                                 reference):
    got = ranks[mesh_name][0]["train"][arch]
    flat, mets = reference["train"][arch]
    _metrics_close(got["metrics"], mets, arch)
    ours = {**_stacked(got["params"], "params"),
            **_stacked(got["opt"], "opt_state")}
    assert set(ours) == set(flat)
    for k, w in flat.items():
        _close(ours[k], torch.from_numpy(np.array(w, np.float32)),
               where=f"{arch} {k}")


@pytest.mark.parametrize("arch,mesh_name", TRAIN_CASES)
def test_ranks_hold_only_their_share_of_the_training_state(arch, mesh_name,
                                                           ranks):
    for rank in ranks[mesh_name]:
        assert rank["train"][arch]["off_share"] == []


def test_both_ranks_hold_the_same_state(ranks):
    for mesh_name, (r0, r1) in ranks.items():
        for arch, res in r0["train"].items():
            for tree in ("params", "opt"):
                for k, v in res[tree].items():
                    assert torch.equal(v, r1["train"][arch][tree][k]), \
                        (mesh_name, arch, k)


def test_mixtral_dispatches_in_two_groups_on_the_data_axis(ranks):
    assert ranks["data"][0]["groups"] == MOE_GROUPS
    assert ranks["model"][0]["groups"] == 1


def _serve_key(arch, flag):
    return f"{arch}-flash" if flag else arch


def _serve_close(got, want, where):
    _close_logits(got["prefill"], torch.as_tensor(want["prefill"]),
                  f"{where} prefill")
    assert len(got["decode"]) == len(want["decode"]) == SERVE["decode"]
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        _close_logits(g, torch.as_tensor(w), f"{where} decode {i}")


@pytest.mark.parametrize("arch,flag,mesh_name", SERVE_CASES)
def test_sharded_serving_equals_meshless(arch, flag, mesh_name, ranks,
                                         meshless):
    key = _serve_key(arch, flag)
    got, want = ranks[mesh_name][0]["serve"][key], meshless["serve"][key]
    _serve_close(got, want, key)
    assert set(got["cache"]) == set(want["cache"])
    for k, w in want["cache"].items():
        _close(got["cache"][k], w, where=f"{key} cache {k}")


@pytest.mark.parametrize("arch,flag,mesh_name", SERVE_CASES)
def test_sharded_serving_equals_the_reference(arch, flag, mesh_name, ranks,
                                              reference):
    key = _serve_key(arch, flag)
    _serve_close(ranks[mesh_name][0]["serve"][key], reference["serve"][key],
                 key)


@pytest.mark.parametrize("arch,flag,mesh_name", SERVE_CASES)
def test_ranks_hold_only_their_share_of_the_cache(arch, flag, mesh_name,
                                                  ranks):
    for rank in ranks[mesh_name]:
        assert rank["serve"][_serve_key(arch, flag)]["off_share"] == []


def test_flash_decode_keeps_the_cache_on_its_slot_shards(ranks):
    """At (1, 2) the cache's slots are split over ``model``. Without the
    flag each decode layer brings its K/V (and slot positions) to B5's
    placements, counted; with it B5 reads its own slots and only q and the
    positions move, under "flash_decode"."""
    off = ranks["model"][0]["serve"]["qwen3-4b"]["redistributes"]
    on = ranks["model"][0]["serve"]["qwen3-4b-flash"]["redistributes"]
    layers = _cfg("qwen3-4b").num_layers * SERVE["decode"]
    assert off.get("B5", 0) == 3 * layers          # k, v, slot_pos
    assert "B5" not in on and on["flash_decode"] == layers


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_other_archs_serve_on_the_model_axis(arch, ranks, meshless):
    got, want = ranks["model"][0]["serve"][arch], meshless["serve"][arch]
    _serve_close(got, want, arch)
    for rank in ranks["model"]:
        assert rank["serve"][arch]["off_share"] == []


@pytest.mark.parametrize("name", ATTN_CASES)
def test_sharded_decode_attention_equals_the_reference(name, ranks):
    import jax.numpy as jnp
    from repro.models import attention as jattn
    from torch.distributed.tensor import Replicate, Shard
    c = _attention_case(name)
    want = torch.from_numpy(np.asarray(jattn.decode_attention(
        *(jnp.asarray(c[n]) for n in ("q", "k", "v", "slot_pos", "pos")),
        window=c["window"])))
    for rank in ranks["model"]:
        got = rank["attention"][name]
        _close(got["kernel"], want, where=f"{name} kernel path")
        _close(got["plain"], want, where=f"{name} plain")
        assert got["placements"] == (Shard(0), Replicate())


def test_attention_cases_hit_the_traps():
    """The upper shard of "empty-upper-shard" and lane 1 of "empty-lane"
    hold no valid slot."""
    w = ATTN_SHAPE[1]
    assert (_attention_case("empty-upper-shard")["slot_pos"][:, w // 2:]
            < 0).all()
    assert (_attention_case("empty-lane")["slot_pos"][1] < 0).all()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--job", required=True)
    a = ap.parse_args()
    torch.set_num_threads(1)
    job = torch.load(a.job, weights_only=False)
    dist.init_process_group(
        "gloo", store=dist.FileStore(a.store, a.world), rank=a.rank,
        world_size=a.world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        result = _rank(a.rank, a.world, job)
        torch.save(result, Path(a.job).parent / f"rank{a.rank}.out.pt")
    finally:
        dist.destroy_process_group()
