"""Architecture + run-shape configuration dataclasses.

Every assigned architecture is a :class:`ModelConfig` in its own module under
``repro.configs``; the registry in ``repro.configs.__init__`` resolves
``--arch <id>``. Shape cells (train_4k / prefill_32k / decode_32k /
long_500k) are :class:`ShapeConfig` constants shared by all LM archs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # normalization / activation / attention details
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparametric
    act: str = "silu"                # silu (SwiGLU) | gelu (plain MLP)
    rope_theta: float = 10_000.0
    qk_norm: bool = False            # qwen3
    sliding_window: Optional[int] = None  # mixtral/hymba SWA
    tie_embeddings: bool = False
    attn_logit_softcap: float = 0.0

    # MoE (mixtral)
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # SSM (falcon-mamba / hymba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 -> ceil(d_model / 16)

    # hybrid (hymba): attention + SSM heads in parallel per layer
    hybrid: bool = False

    # encoder-decoder (whisper): encoder layer count; frontend is a stub
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    cross_attention: bool = False
    encoder_len: int = 1500          # cross-attn source length for decode cells

    # VLM backbone (qwen2-vl): multimodal RoPE; frontend is a stub
    mrope: bool = False
    mrope_sections: Tuple[int, ...] = ()
    embed_input: bool = True         # False -> input_specs provides embeddings

    # numerics / execution
    dtype: str = "bfloat16"
    remat: str = "full"              # none | full | dots
    scan_layers: bool = True
    num_microbatches: int = 1
    seq_shard_activations: bool = False
    optimizer: str = "adam"          # adam | adafactor
    use_pallas_kernels: bool = False  # TPU target path (tests use interpret)
    attn_chunk: int = 512            # pure-jnp blocked-attention q-chunk
    # Unroll flags exist for the dry-run cost probes: XLA's HloCostAnalysis
    # counts a while-loop body once, so FLOP/byte/collective accounting uses
    # small unrolled probe configs (see launch/dryrun.py).
    attn_unroll: bool = False
    ssm_chunk: int = 256
    ssm_unroll: bool = False
    # False for archs whose head count does not divide the TP axis (hymba's
    # 25H/5KV, whisper's 6H): replicating attention weights avoids GSPMD
    # "involuntary full rematerialization" on the (B,S,H,hd) reshapes, which
    # otherwise explodes compile time and wire bytes. MLP/SSM stay TP-sharded.
    shard_heads: bool = True
    # --- beyond-paper perf knobs (EXPERIMENTS.md §Perf variants) ---
    # explicit shard_map flash-decode over the seq-sharded KV cache instead
    # of GSPMD auto-partitioned softmax (collective-bound decode cells)
    decode_flash_shardmap: bool = False
    # dtype of the selective-scan discretized tensors (memory-bound ssm)
    ssm_scan_dtype: str = "float32"
    # "tp": batch over data(+pod), TP over model (default).
    # "dp": every mesh axis is data parallelism (small models; §Perf)
    layout: str = "tp"
    # dense-expert evaluation for small token counts (decode): no dispatch
    # machinery / capacity padding; k/E of FLOPs useful (§Perf variant)
    moe_dense_decode: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.ssm_state and self.ssm_dt_rank == 0:
            object.__setattr__(self, "ssm_dt_rank", -(-self.d_model // 16))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so the embedding/lm_head shard evenly on any mesh
        axis up to 256; logits beyond vocab_size are masked in the loss."""
        return round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (see DESIGN.md shape-cell skips)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable, reason-if-not). Encodes the DESIGN.md skip rules."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, "pure full-attention arch: no sub-quadratic mode at 500k"
    return True, ""
