"""Three-term roofline analysis from a traced step (counterpart of
``repro/roofline/analysis.py``).

    compute term    = per_device_FLOPs / peak_FLOP/s
    memory term     = per_device_bytes_accessed / HBM_bw
    collective term = per_device_wire_bytes / link_bw

The counts are one rank's local work, as
:class:`repro_torch.roofline.trace.DeviceCounter` records it while the
sharded step runs (on fake tensors in the dry run), so no division by the
device count is needed. MODEL_FLOPS is the analytic useful work (6*N*D for
training; 2*N_active*tokens for inference, + exact attention FLOPs), giving
the usefulness ratio MODEL_FLOPS / (FLOPs * chips). The counter counts
tensor-core and formula FLOPs only, where XLA also counts element-wise
work, so this ratio and the reference's are not comparable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.nn.module import named_leaves
from repro_torch.roofline.collectives import collective_wire_bytes, count_ops
from repro_torch.roofline.hw import HW, HWModel


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    wire_bytes_per_device: float
    collective_ops: dict
    collective_breakdown: dict
    temp_bytes_per_device: float
    arg_bytes_per_device: float
    out_bytes_per_device: float
    model_flops: float
    params_total: float
    params_active: float
    compile_seconds: float
    variant: str = "baseline"

    def terms(self, hw: HWModel = HW) -> dict:
        t_comp = self.hlo_flops_per_device / hw.peak_flops_bf16
        t_mem = self.hlo_bytes_per_device / hw.hbm_bw
        # Floor: every argument byte (sharded params/opt/cache/inputs) read
        # once + outputs written once; the bytes accessed above count every
        # op's operands, an eager step's traffic with nothing fused.
        t_mem_floor = ((self.arg_bytes_per_device + self.out_bytes_per_device)
                       / hw.hbm_bw)
        t_coll = self.wire_bytes_per_device / hw.ici_link_bw
        dominant = max(
            (("compute", t_comp), ("memory", t_mem), ("collective", t_coll)),
            key=lambda kv: kv[1],
        )[0]
        total_flops = self.hlo_flops_per_device * self.chips
        bound = max(t_comp, t_mem, t_coll)
        return {
            "compute_s": t_comp,
            "memory_s": t_mem,
            "memory_floor_s": t_mem_floor,
            "collective_s": t_coll,
            "dominant": dominant,
            "bound_s": bound,
            "useful_flop_ratio": (self.model_flops / total_flops
                                  if total_flops else 0.0),
            "roofline_fraction": t_comp / bound if bound > 0 else 0.0,
            "model_mfu_bound": (
                (self.model_flops / (self.chips * hw.peak_flops_bf16)) / bound
                if bound > 0 else 0.0),
        }

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["terms"] = self.terms()
        return d


def _param_counts(cfg: ModelConfig, params_tree) -> tuple[float, float]:
    """(total, active) parameters: a leaf under a ``moe`` key but not its
    router is an expert's, of which ``experts_per_token`` of
    ``num_experts`` are active."""
    total = 0
    expert = 0
    for path, leaf in named_leaves(params_tree).items():
        n = 1
        for s in leaf.shape:
            n *= s
        total += n
        parts = path.split("/")
        if any("moe" in p for p in parts) and \
           not any("router" in p for p in parts):
            expert += n
    active = total
    if cfg.num_experts:
        active = total - expert * (cfg.num_experts - cfg.experts_per_token) / cfg.num_experts
    return float(total), float(active)


def model_flops(cfg: ModelConfig, shape: ShapeConfig, params_active: float) -> float:
    """Analytic useful FLOPs per step: matmul term + exact attention term."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0  # fwd 2 + bwd 4
        ctx = shape.seq_len
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
        ctx = shape.seq_len
    else:  # decode: one token per sequence against a seq_len context
        tokens = shape.global_batch
        mult = 2.0
        ctx = shape.seq_len
    core = mult * params_active * tokens
    # attention score+value FLOPs: 4 * tokens * ctx_avg * H * hd per layer
    if cfg.family != "ssm" and cfg.num_heads:
        win = cfg.sliding_window
        if shape.kind == "decode":
            ctx_avg = min(ctx, win) if win else ctx
        else:
            ctx_avg = ctx / 2 if win is None else min(win, ctx / 2)
        attn = (mult / 2.0) * 4 * tokens * ctx_avg * cfg.num_heads * cfg.head_dim \
            * cfg.num_layers
        core += attn
    return core


def analyze_trace(counter, cfg: ModelConfig, shape: ShapeConfig,
                  mesh_name: str, chips: int, params_tree, memory: dict,
                  trace_seconds: float,
                  variant: str = "baseline") -> CellReport:
    """The cell's report from the counter of its traced step and its
    ``memory`` analysis (:func:`repro_torch.launch.dryrun.memory_analysis`:
    argument, output and temp bytes per device)."""
    wire = collective_wire_bytes(counter.collectives)
    total, active = _param_counts(cfg, params_tree)
    return CellReport(
        arch=cfg.name,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        hlo_flops_per_device=float(counter.flops),
        hlo_bytes_per_device=float(counter.bytes),
        wire_bytes_per_device=float(wire.get("_total", 0.0)),
        collective_ops=count_ops(counter.collectives),
        collective_breakdown={k: v for k, v in wire.items()
                              if not k.startswith("_")},
        temp_bytes_per_device=float(memory["temp_size_in_bytes"]),
        arg_bytes_per_device=float(memory["argument_size_in_bytes"]),
        out_bytes_per_device=float(memory["output_size_in_bytes"]),
        model_flops=model_flops(cfg, shape, active),
        params_total=total,
        params_active=active,
        compile_seconds=trace_seconds,
        variant=variant,
    )


def roofline_terms(report: CellReport, hw: Optional[HWModel] = None) -> dict:
    return report.terms(hw or HW)
