"""LM pretraining in the port (``models.lm.train_loss``, the flash backward,
remat, ``launch.steps``, ``launch.train lm`` and the checkpoint bridge)
against the JAX reference, on the CPU.

The reference's ``init_params`` makes the weights, carried into the port
by ``load_reference_lm_params``; tokens and labels come from numpy. All
f32 at the reduced configs. Tolerances:

* the attention's gradients 1e-5 (atol and rtol) against ``jax.vjp`` of
  the reference's pair-scan ``flash_attention``, the same f32 blocks
  summed in another order; the log-sum-exp 1e-5 against
  ``_flash_fwd_impl``'s;
* the loss 1e-5; each parameter's gradient 1e-5 + 1e-4 relative against
  ``jax.value_and_grad(train_loss)`` (sums over the batch, the layers and
  a 256-wide head in another order);
* ``remat`` "full" and "dots" recompute the same ops as "none": equal bits;
* the train step (Adafactor, two microbatches) 1e-5 after two steps;
* a resumed ``train lm`` equals the uninterrupted run bit for bit in the
  port, and the other package's printed loss (4 decimals) across the
  checkpoint bridge.

On the CPU the attention forward is B4's plain version; B4 and the
backward against it on the card are in ``tests/test_torch_cuda.py``.
"""
import argparse
import dataclasses
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import init_params as j_init_params
from repro.models import lm as jlm
from repro.optim import adafactor_init as j_adafactor_init
from repro_torch import configs
from repro_torch.checkpoint import (Checkpointer, load_lm_train_state,
                                    load_reference_lm_params, lm_train_tree)
from repro_torch.kernels import decode_attention as b5
from repro_torch.kernels import mamba_scan as b6
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import attention, lm
from repro_torch.nn import named_leaves
from repro_torch.optim import AdamConfig, adam_init

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
TRAIN_ARCHS = ["olmo-1b", "qwen3-4b", "mistral-large-123b",
               "falcon-mamba-7b", "hymba-1.5b"]
LAYER = re.compile(r"^layers/(\d+)/(.*)$")


def _reference(arch, seed=0, **overrides):
    cfg = dataclasses.replace(configs.get_reduced_config(arch), **overrides)
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch), **overrides)
    jparams = j_init_params(jax.random.PRNGKey(seed), jcfg)
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams)[0]}
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(9))
    load_reference_lm_params(params, flat)
    return cfg, jcfg, jparams, params


def _batch(vocab, b=2, s=40, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -100  # masked labels
    labels[-1, -3:] = -100
    return {"tokens": tokens, "labels": labels}


def _reference_leaf(flat, key):
    """The reference's value of the port's leaf ``key`` (a layer's leaf is
    its row of the stacked one)."""
    m = LAYER.match(key)
    return flat[f"layers/{m[2]}"][int(m[1])] if m else flat[key]


def _grads(params, batch, cfg):
    leaves = named_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    total, metrics = lm.train_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True)
    return total.detach(), metrics, dict(zip(leaves, grads))


# -- the attention's backward -------------------------------------------------


def _qkv(b, s, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd))]


ATTN_CASES = [(kv, causal, window) for kv in (4, 2)
              for causal, window in ((True, None), (True, 24), (False, None))]


@pytest.mark.parametrize("kv,causal,window", ATTN_CASES)
def test_flash_attention_gradients_match_reference_vjp(kv, causal, window):
    """(2, 40, 4, 16) with chunk 16, so S pads to 48; MHA and GQA."""
    q, k, v, dout = _qkv(2, 40, 4, kv, 16)
    jout, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(
        q, k, v, chunk=16, causal=causal, window=window), q, k, v)
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = attention.flash_attention(tq, tk, tv, chunk=16, causal=causal,
                                    window=window)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    out.backward(torch.tensor(dout))
    for name, got, w in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_plain_lse_matches_reference_pair_scan(causal, window):
    q, k, v, _ = _qkv(2, 40, 4, 2, 16, seed=3)
    pad = ((0, 0), (0, 8), (0, 0), (0, 0))  # to the chunk grid, as the
    qp, kp, vp = (np.pad(x, pad) for x in (q, k, v))  # reference pads
    _, jlse = jattn._flash_fwd_impl(qp, kp, vp, 16, causal, window, 0.0, 40)
    # (B, n, chunk, KV, G) -> (B, H, S)
    want = np.asarray(jlse).reshape(2, 48, 4).transpose(0, 2, 1)[:, :, :40]
    got = ref.flash_attention_lse_torch(torch.tensor(q), torch.tensor(k),
                                        causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_bwd_is_the_pair_scan_over_the_reference_blocks():
    assert attention._block_pairs(3, 3, None, True) == [
        tuple(p) for p in jattn._block_pairs(3, 3, None, True)]
    assert attention._block_pairs(4, 4, 1, True) == [
        tuple(p) for p in jattn._block_pairs(4, 4, 1, True)]
    assert attention._block_pairs(2, 3, None, False) == [
        tuple(p) for p in jattn._block_pairs(2, 3, None, False)]
    for i, j, window in ((1, 0, None), (2, 1, 20), (2, 2, None)):
        got = attention._block_mask(i, j, 16, 16, True, window, 40, "cpu")
        want = jattn._block_mask(i, j, 16, 16, True, window, 40)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_without_grad_saves_no_residuals():
    """Under no_grad (serving) the forward computes no lse and keeps no
    graph; with grad it is differentiable."""
    q, k, v, _ = _qkv(1, 20, 4, 2, 16)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    with mock.patch.object(ref, "flash_attention_lse_torch",
                           side_effect=AssertionError("lse computed")):
        with torch.no_grad():
            out = ops.flash_attention(tq, tk, tv)
        assert out.grad_fn is None
        out = ops.flash_attention(tq.detach(), tk.detach(), tv.detach())
        assert out.grad_fn is None
    assert ops.flash_attention(tq, tk, tv).grad_fn is not None


# -- the loss ---------------------------------------------------------------


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_loss_and_gradients_match_reference(arch):
    cfg, jcfg, jparams, params = _reference(arch)
    batch = _batch(cfg.vocab_size)
    (jtotal, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(p, jax.tree.map(jnp.asarray, batch), jcfg),
        has_aux=True)(jparams)
    jflat = {k: np.asarray(v) for k, v in _flatten_with_paths(jgrads)[0]}
    total, metrics, grads = _grads(params, batch, cfg)
    np.testing.assert_allclose(float(total), float(jtotal), **TOL)
    for key in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(jmetrics[key]),
                                   **TOL, err_msg=key)
    assert float(metrics["tokens"]) == 2 * 40 - 8
    assert len(grads) == sum(np.prod(v.shape[:1]) if k.startswith("layers/")
                             else 1 for k, v in jflat.items())
    for key, g in grads.items():
        want = _reference_leaf(jflat, key)
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=key)


@pytest.mark.parametrize("arch", ["olmo-1b", "hymba-1.5b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients(arch, remat):
    batch = _batch(256, seed=4)
    out = {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(configs.get_reduced_config(arch),
                                  remat=mode)
        params = lm.init_params(cfg, generator=torch.Generator().manual_seed(2))
        out[mode] = _grads(params, batch, cfg)
    assert torch.equal(out["none"][0], out[remat][0])
    for key, g in out["none"][2].items():
        other = out[remat][2][key]
        assert (g is None) == (other is None), key
        assert g is None or torch.equal(g, other), key


def test_dots_policy_saves_only_matmul_outputs():
    policy = lm._save_dots
    assert policy(None, torch.ops.aten.mm.default) == \
        lm.CheckpointPolicy.MUST_SAVE
    assert policy(None, torch.ops.aten.bmm.default) == \
        lm.CheckpointPolicy.MUST_SAVE
    assert policy(None, torch.ops.aten.exp.default) == \
        lm.CheckpointPolicy.PREFER_RECOMPUTE


# -- the step and the command line ------------------------------------------


def test_train_step_with_adafactor_and_microbatches_matches_reference():
    cfg, jcfg, jparams, params = _reference("mistral-large-123b",
                                            num_microbatches=2)
    assert cfg.optimizer == "adafactor"
    shape = JShapeConfig("tiny_train", seq_len=16, global_batch=4,
                         kind="train")
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    jstep, _, _ = jsteps.build_train_step(
        jcfg, mesh, shape, jsteps.TrainKnobs(lr=1e-2, donate=False))
    knobs = steps.TrainKnobs(lr=1e-2)
    step = steps.build_train_step(cfg, knobs=knobs)
    _, opt_init, _ = steps.make_optimizer(cfg, knobs)
    opt_state = opt_init(named_leaves(params))
    jopt = j_adafactor_init(jparams, jsteps.make_optimizer(jcfg, jsteps.TrainKnobs(
        lr=1e-2))[0])
    for i in range(2):
        batch = _batch(cfg.vocab_size, b=4, s=16, seed=10 + i)
        with mesh:
            jparams, jopt, jmetrics = jstep(jparams, jopt,
                                            jax.tree.map(jnp.asarray, batch))
        params, opt_state, metrics = step(
            params, opt_state, {k: torch.from_numpy(v) for k, v in
                                batch.items()})
        for key in ("loss", "tokens", "grad_norm", "loss_total"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(jmetrics[key]), **TOL,
                                       err_msg=key)
    want = {k: np.asarray(v) for k, v in _flatten_with_paths(
        {"params": jparams, "opt_state": jopt})[0]}
    got = lm_train_tree(params, opt_state)
    assert set(got) == set(want)
    for key, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), want[key], **TOL,
                                   err_msg=key)


def _fake_world(n):
    """PyTorch's fake process group of ``n`` ranks: meshes and placements
    build, and nothing runs a collective."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return dist


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_a_mesh_of_two_builds_all_three_steps(model_parallel):
    """A ("data", "model") mesh of 2 builds the train step, prefill and
    decode step, each holding the specs it places its inputs by; a mesh
    without the cell's shape is refused."""
    dist = _fake_world(2)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(model_parallel, device="cpu")
        assert tuple(mesh.shape) == (2 // model_parallel, model_parallel)
        cfg = configs.get_reduced_config("qwen3-4b")
        for kind in ("train", "prefill", "decode"):
            shape = configs.ShapeConfig(kind, seq_len=16, global_batch=4,
                                        kind=kind)
            step = steps.build_for_shape(cfg, mesh, shape)
            specs = step.in_specs[0]
            assert specs["embed"] == ("model", "data")
            assert specs["layers/0/attn/wq"] == ("data", "model")
        with pytest.raises(ValueError, match="ShapeConfig"):
            steps.build_decode_step(cfg, mesh)
    finally:
        dist.destroy_process_group()


def test_make_host_mesh_rejects_a_world_that_does_not_divide():
    """The twin of ``tests/test_fleet.py``'s: a ValueError naming both
    numbers, on a world of 3."""
    dist = _fake_world(3)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        with pytest.raises(ValueError, match=r"3 available device\(s\)"):
            make_host_mesh(model_parallel=2, device="cpu")
        with pytest.raises(ValueError, match="model_parallel=0"):
            make_host_mesh(model_parallel=0, device="cpu")
        assert tuple(make_host_mesh(3, device="cpu").shape) == (1, 3)
    finally:
        dist.destroy_process_group()


def test_prefill_and_decode_steps_wrap_the_model():
    cfg = configs.get_reduced_config("qwen3-4b")
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_batch(cfg.vocab_size, b=2, s=6)["tokens"])
    shape = configs.ShapeConfig("p", seq_len=8, global_batch=2,
                                kind="prefill")
    cache, logits = steps.build_prefill(cfg, None, shape)(
        params, {"tokens": tokens})
    want_cache, want = lm.prefill(params, {"tokens": tokens}, cfg, max_seq=8)
    assert torch.equal(logits, want) and not logits.requires_grad
    assert cache["layers"]["k"].shape[2] == 8
    cache, logits = steps.build_decode_step(cfg)(params, cache,
                                                 {"token": tokens[:, 0]})
    _, want = lm.decode_step(params, want_cache, {"token": tokens[:, 0]}, cfg)
    assert torch.equal(logits, want)


def _lm_args(tmp, *extra, steps=4):
    return ["lm", "--arch", "olmo-1b", "--steps", str(steps), "--batch-size",
            "2", "--seq", "16", "--device", "cpu", "--log-every", "1",
            *(["--ckpt", str(tmp), "--ckpt-every", "2"] if tmp else []),
            *extra]


def test_train_lm_runs_and_resumes_bit_for_bit(tmp_path, capsys):
    whole = launch_train.main(_lm_args(None, steps=5))
    assert all(np.isfinite(whole["losses"])) and len(whole["losses"]) == 5
    assert whole["losses"][-1] < whole["losses"][0]
    first = launch_train.main(_lm_args(tmp_path, steps=3))
    assert first["losses"] == whole["losses"][:3]
    assert (tmp_path / "LATEST").read_text() == "2"
    # the checkpoint at step 2 holds the state after three updates and the
    # pipeline at batch 3; the rerun resumes there, at step 2
    resumed = launch_train.main(_lm_args(tmp_path, steps=2))
    assert resumed["start"] == 2 and resumed["pipeline"].step == 5
    assert resumed["losses"] == whole["losses"][3:]
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert re.search(r"loss \d+\.\d{4} -> \d+\.\d{4} over 2 steps", out)
    for key, t in named_leaves(resumed["params"]).items():
        assert torch.equal(t, named_leaves(whole["params"])[key]), key


@pytest.mark.parametrize("arch,match", [
    ("whisper-tiny", "token-input decoder"),
    ("qwen2-vl-72b", "token-input decoder")])
def test_train_lm_rejects_embedding_input_archs(arch, match):
    with pytest.raises(SystemExit, match=match):
        launch_train.main(["lm", "--arch", arch, "--device", "cpu"])


def test_train_lm_refuses_families_before_allocating():
    """No token-input family is refused any more: MoE trains with its
    load-balance term (``tests/test_torch_moe_train.py`` holds it to the
    reference), here through ``train lm`` at the reduced mixtral, as the
    dense, SSM and hybrid families do."""
    run = launch_train.main(["lm", "--arch", "mixtral-8x7b", "--device",
                             "cpu", "--steps", "3", "--batch-size", "2",
                             "--seq", "16", "--log-every", "1"])
    assert run["cfg"].num_experts and len(run["losses"]) == 3
    assert all(np.isfinite(run["losses"] + run["grad_norms"]))


# -- checkpoints across the packages ----------------------------------------


def _reference_args(tmp, steps):
    return argparse.Namespace(arch="olmo-1b", scale="reduced", steps=steps,
                              batch_size=2, seq=16, lr=3e-4, seed=0,
                              ckpt=str(tmp), ckpt_every=2, log_every=1)


def _printed_losses(out):
    return {int(m[1]): float(m[2]) for m in
            re.finditer(r"step\s+(\d+) loss\s+([\d.]+)", out)}


def test_reference_checkpoint_resumes_in_the_port(tmp_path, capsys):
    jtrain.train_lm(_reference_args(tmp_path, steps=4))
    want = _printed_losses(capsys.readouterr().out)
    # the leaves load exactly, and write back to the same file layout
    flat = Checkpointer(str(tmp_path)).restore_latest()["tree"]
    cfg = configs.get_reduced_config("olmo-1b")
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    opt_state = adam_init(named_leaves(params), AdamConfig(lr=3e-4))
    load_lm_train_state(params, opt_state, flat)
    tree = lm_train_tree(params, opt_state)
    assert set(tree) == set(flat)
    for key, t in tree.items():
        np.testing.assert_array_equal(t.numpy(), flat[key], err_msg=key)
    # the port resumes at step 2 with the batch the reference's step 3 took
    resumed = launch_train.main(_lm_args(tmp_path, steps=1))
    assert resumed["start"] == 2
    assert abs(resumed["losses"][0] - want[3]) <= 6e-5


def test_port_checkpoint_resumes_in_the_reference(tmp_path, capsys):
    ours = launch_train.main(_lm_args(tmp_path, steps=4))
    capsys.readouterr()
    jtrain.train_lm(_reference_args(tmp_path, steps=1))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert abs(_printed_losses(out)[2] - ours["losses"][3]) <= 6e-5


# -- no silent detach -------------------------------------------------------


def _on_card(monkeypatch, request, launched):
    """``ops`` taking the tensors as CUDA ones (the gradient refusals), and
    the ops' kernels on these CPU tensors replaced by recorders, named
    after the CUDA entry each op launches on the card, that return their
    plain versions' outputs (and, where B6's chunk states are asked for, a
    stand-in); the plain kernels are registered back afterwards."""
    monkeypatch.setattr(ops, "_device_type", lambda t: "cuda")
    for op, name, kernel, plain in (
            (b5.decode_attention_op, "decode_attention_cuda", b5._plain,
             b5._plain),
            (b6.mamba_scan_op, "mamba_scan_cuda", b6._plain, b6._plain),
            (b6.mamba_scan_gated_op, "mamba_scan_gated_cuda",
             b6._plain_gated, b6._plain_gated),
            (b6.mamba_scan_gated_states_op, "mamba_scan_gated_cuda",
             b6._plain_gated_states, b6._plain_gated)):
        def entry(*args, _name=name, _plain=plain, _states=kernel != plain):
            launched.append(_name)
            out = _plain(*args)
            return (*out, torch.zeros(())) if _states else out
        op.register_kernel("cpu")(entry)
        request.addfinalizer(
            lambda op=op, kernel=kernel: op.register_kernel("cpu")(kernel))


def _b5_b6_inputs(requires_grad):
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32),
                            requires_grad=requires_grad)

    slot_pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
    pos = torch.full((2,), 5, dtype=torch.int32)
    return {
        "decode_attention": lambda: ops.decode_attention(
            t(2, 4, 8), t(2, 6, 2, 8), t(2, 6, 2, 8), slot_pos, pos),
        "mamba_scan": lambda: ops.mamba_scan(
            t(1, 5, 4), torch.rand(1, 5, 4), t(1, 5, 3), t(1, 5, 3),
            -torch.rand(4, 3)),
        "mamba_scan_gated": lambda: ops.mamba_scan_gated(
            t(1, 5, 4), t(1, 5, 4), t(4), t(1, 5, 3), t(1, 5, 3),
            -torch.rand(4, 3), t(4), t(1, 5, 4)),
    }


@pytest.mark.parametrize("name", ["decode_attention", "mamba_scan",
                                  "mamba_scan_gated"])
def test_b5_b6_never_return_a_detached_kernel_output(monkeypatch, request,
                                                    name):
    """On CUDA inputs that need a gradient, B5 and B6's bare entry raise;
    B6's gated entry launches and returns an output on the graph of
    ``MambaScanGated``, whose backward is B6b."""
    launched = []
    _on_card(monkeypatch, request, launched)
    if name == "mamba_scan_gated":
        out, _ = _b5_b6_inputs(True)[name]()
        assert type(out.grad_fn).__name__ == "MambaScanGatedBackward"
        assert launched == [f"{name}_cuda"]
        launched.clear()
    else:
        with pytest.raises(RuntimeError, match="no backward on the card"):
            _b5_b6_inputs(True)[name]()
        assert launched == []
    with torch.no_grad():  # inference launches the kernel
        _b5_b6_inputs(True)[name]()
    _b5_b6_inputs(False)[name]()
    assert launched == [f"{name}_cuda"] * 2
