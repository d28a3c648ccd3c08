"""The port's roofline (``repro_torch/roofline``) against the reference's
(``repro/roofline``), on the CPU.

* ``collective_wire_bytes`` and ``count_ops`` over recorded collectives
  equal the reference's over the HLO text of ``tests/test_roofline.py``,
  each of its five collectives alone and all together, exactly.
* ``CellReport.terms(hw)`` equals the reference's ``terms`` with the same
  figures passed in, exactly.
* ``_param_counts`` and ``model_flops`` equal the reference's for all ten
  architectures and every applicable shape, the reference's parameters
  from ``jax.eval_shape`` of its ``init_params``, exactly.
* The counter counts 2mnk for an ``mm``; for a DTensor ``mm`` on a fake
  (16, 16) world one rank's work, the global FLOPs / 256, exactly (the
  sharding propagator's run on the global shapes is not counted), and on a
  (1, 1) world the global FLOPs.
* The H100's figures, and none of the TPU's.
"""
import dataclasses

import jax
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.roofline import analysis as janalysis
from repro.roofline import hlo_parse
from repro.roofline import hw as jhw
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.roofline import analysis, collectives, hw, trace

HEAD = "ENTRY %main {\n  %p0 = f32[16,128]{1,0} parameter(0)\n"
# (HLO line, the same collective as a record: kind, result bytes, group)
CASES = {
    "all-reduce": (
        "  %all-reduce.1 = f32[16,128]{1,0} all-reduce(%p0), "
        "replica_groups={{0,1,2,3}}, to_apply=%add",
        ("all-reduce", 16 * 128 * 4, 4)),
    "all-gather": (
        "  %all-gather.2 = bf16[64,128]{1,0} all-gather(%x), "
        "replica_groups=[4,16]<=[64], dimensions={0}",
        ("all-gather", 64 * 128 * 2, 16)),
    "reduce-scatter": (
        "  %reduce-scatter.3 = f32[4,128]{1,0} reduce-scatter(%y), "
        "replica_groups={{0,1},{2,3}}, dimensions={0}",
        ("reduce-scatter", 4 * 128 * 4, 2)),
    "collective-permute": (
        "  %cp = f32[8]{0} collective-permute(%z), "
        "source_target_pairs={{0,1}}",
        ("collective-permute", 8 * 4, 2)),
    "all-reduce-start": (
        "  %all-reduce-start.9 = f32[10]{0} all-reduce-start(%w), "
        "replica_groups={{0,1,2,3,4}}",
        ("all-reduce", 10 * 4, 5)),
}


def _hlo(names):
    return HEAD + "".join(CASES[n][0] + "\n" for n in names) + "}\n"


@pytest.mark.parametrize("names", [[n] for n in CASES] + [list(CASES)],
                         ids=list(CASES) + ["all five"])
def test_wire_bytes_and_counts_equal_the_reference(names):
    records = [CASES[n][1] for n in names]
    hlo = _hlo(names)
    assert collectives.collective_wire_bytes(records) == \
        hlo_parse.collective_wire_bytes(hlo)
    assert collectives.count_ops(records) == hlo_parse.count_ops(hlo)


def test_a_group_of_one_moves_nothing():
    wire = collectives.collective_wire_bytes([("all-gather", 1024, 1),
                                              ("broadcast", 64, 4)])
    assert wire == {"broadcast": 64.0, "_total": 64.0, "_payload": 64.0}


REPORTS = [
    # tests/test_roofline.py's: 1 s compute, 0.5 s memory, 0.25 s wire
    lambda h: dict(hlo_flops_per_device=h.peak_flops_bf16,
                   hlo_bytes_per_device=h.hbm_bw / 2,
                   wire_bytes_per_device=h.ici_link_bw / 4,
                   model_flops=h.peak_flops_bf16 * 256 * 0.8),
    # memory-bound, with argument and output bytes
    lambda h: dict(hlo_flops_per_device=3.1e12, hlo_bytes_per_device=7.7e11,
                   wire_bytes_per_device=1.3e9, model_flops=5.5e14,
                   arg_bytes_per_device=2.2e9, out_bytes_per_device=1.1e9),
    # collective-bound
    lambda h: dict(hlo_flops_per_device=1e12, hlo_bytes_per_device=1e9,
                   wire_bytes_per_device=9e10, model_flops=1e14),
    # nothing to do
    lambda h: dict(hlo_flops_per_device=0.0, hlo_bytes_per_device=0.0,
                   wire_bytes_per_device=0.0, model_flops=0.0),
]


def _report(cls, fields):
    base = dict(arch="x", shape="train_4k", mesh="single", chips=256,
                collective_ops={}, collective_breakdown={},
                temp_bytes_per_device=0, arg_bytes_per_device=0,
                out_bytes_per_device=0, params_total=1e9, params_active=1e9,
                compile_seconds=1.0)
    return cls(**{**base, **fields})


@pytest.mark.parametrize("case", range(len(REPORTS)))
def test_terms_equal_the_reference_with_the_same_figures(case):
    fields = REPORTS[case](hw.HW)
    same = jhw.HWModel(**dataclasses.asdict(hw.HW))
    want = _report(janalysis.CellReport, fields).terms(same)
    got = _report(analysis.CellReport, fields).terms(hw.HW)
    assert got == want
    assert analysis.roofline_terms(_report(analysis.CellReport, fields)) \
        == got


def test_cell_report_fields_are_the_reference():
    names = [f.name for f in dataclasses.fields(analysis.CellReport)]
    assert names == [f.name for f in dataclasses.fields(janalysis.CellReport)]


def test_hw_is_the_h100_with_the_reference_fields():
    names = [f.name for f in dataclasses.fields(hw.HWModel)]
    assert names == [f.name for f in dataclasses.fields(jhw.HWModel)]
    assert (hw.HW.peak_flops_bf16, hw.HW.hbm_bw, hw.HW.hbm_bytes,
            hw.HW.vmem_bytes, hw.HW.ici_link_bw) == (
        989e12, 3.35e12, 80e9, 228 * 1024, 50e9)
    tpu = dataclasses.asdict(jhw.HW)
    for k, v in dataclasses.asdict(hw.HW).items():
        if k != "name":
            assert v != tpu[k] or k == "ici_link_bw", k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    jparams = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    params, _ = steps.param_and_opt_shapes(cfg, steps.TrainKnobs())
    got = analysis._param_counts(cfg, params)
    assert got == janalysis._param_counts(jcfg, jparams)
    for name, shape in SHAPES.items():
        if shape_applicable(cfg, shape)[0]:
            jshape = jconfigs.SHAPES[name]
            assert analysis.model_flops(cfg, shape, got[1]) == \
                janalysis.model_flops(jcfg, jshape, got[1]), name


# -- the counter --------------------------------------------------------------


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """Destroy any process group a test started."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_counter_counts_2mnk_for_an_mm():
    a, b = torch.randn(64, 48), torch.randn(48, 32)
    with trace.DeviceCounter() as c:
        out = a @ b
    assert c.flops == 2 * 64 * 48 * 32
    assert c.bytes == 4 * (64 * 48 + 48 * 32 + 64 * 32)
    assert c.ops["aten.mm"] == 1 and c.collectives == []
    assert c.peak_bytes == trace.BLOCK * -(-out.nbytes // trace.BLOCK)


def test_counter_counts_views_and_broadcasts_as_no_extra_bytes():
    x = torch.randn(8, 16)
    with trace.DeviceCounter() as c:
        y = x.t()                      # a view: no bytes
        z = torch.ones(16) + y.sum(1)  # 16 floats out, 128 read
        w = x + torch.ones(1, 16).expand(8, 16)  # a broadcast read once
    assert z.shape == (16,) and w.shape == (8, 16)
    assert c.ops["aten.t"] == 1
    assert c.bytes == 4 * (16          # ones
                           + 128 + 16  # sum
                           + 16 + 16 + 16  # add
                           + 16        # ones (1, 16)
                           + 128 + 16 + 128)  # x + broadcast


def _mm_counts(mesh, m, k, n):
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(m, k), mesh, (Shard(0), Replicate()),
                              src_data_rank=None)
        b = distribute_tensor(torch.empty(k, n), mesh, (Replicate(), Shard(1)),
                              src_data_rank=None)
        with trace.DeviceCounter() as c:
            out = a @ b
    return c, out


@pytest.mark.parametrize("m,k,n", [(4096, 2048, 512), (1024, 256, 4096)])
def test_dtensor_mm_counts_one_rank_on_a_16x16_world(m, k, n):
    mesh = tmesh.make_production_mesh(device="cpu")
    assert mesh.shape == (16, 16) and dist.get_world_size() == 256
    c, out = _mm_counts(mesh, m, k, n)
    assert c.flops == 2 * m * k * n // 256
    assert c.ops["aten.mm"] == 1
    assert out.to_local().shape == (m // 16, n // 16)
    assert c.collectives == []


def test_dtensor_mm_counts_everything_on_a_world_of_one():
    tmesh._fake_world(1)
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    c, _ = _mm_counts(mesh, 512, 256, 128)
    assert c.flops == 2 * 512 * 256 * 128


def test_collectives_are_recorded_with_their_group():
    mesh = tmesh.make_production_mesh(device="cpu")
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 32), mesh,
                              (Shard(0), Shard(1)), src_data_rank=None)
        with trace.DeviceCounter() as c:
            x.redistribute(mesh, (Replicate(), Shard(1)))
    # the rows gathered over "data": 16 blocks of (4, 2) f32 -> (64, 2)
    assert c.collectives == [("all-gather", 64 * 2 * 4, 16)]
    assert collectives.collective_wire_bytes(c.collectives)["_total"] == \
        64 * 2 * 4 * 15 / 16


def test_production_mesh_refuses_a_real_world_and_resizes_a_fake_one():
    multi = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert multi.shape == (2, 16, 16)
    assert multi.mesh_dim_names == ("pod", "data", "model")
    assert tmesh.make_production_mesh(device="cpu").shape == (16, 16)
    assert dist.get_world_size() == 256
    dist.destroy_process_group()
    tmesh.make_host_mesh(1, device="cpu")  # a gloo world of one
    with pytest.raises(RuntimeError, match="process of its own"):
        tmesh.make_production_mesh(device="cpu")
