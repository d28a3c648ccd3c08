"""CoRaiS matching-on-demand policy network (paper §IV-A, Fig. 6) in
PyTorch; counterpart of ``repro/core/policy.py``.

Edge encoder (L attention layers) + request encoder (K attention layers)
align heterogeneous features; the context decoder attends the system context
[f_hat, h_hat, f_q] over request embeddings; the policy head scores every
(edge, request) pair with C*tanh compatibilities and softmaxes over edges
(eqs 12-17).

    CoRaiSPolicy         — the parameters (an ``nn.Module`` whose state-dict
                           keys are the reference's pytree paths)
    corais_encode        — encoders + context decoder -> (c_emb, h_emb)
    corais_score         — the eq 16-17 head over SCORE_BACKENDS
    corais_score_decode  — the fused head + top-k decode over DECODE_BACKENDS
    corais_admit         — the optional admission head
    corais_apply         — encode + score

Backends keep the reference's roles under the port's names: ``"ref"``
(per-instance oracle), ``"torch"`` (batched plain head, the twin of the
reference's ``"xla"``) and ``"cuda"`` (the hand-written kernel, the
counterpart of ``"pallas"``; on CPU tensors it runs the plain version).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.nn import MHA, BatchNorm, LayerNorm, Linear, uniform_init

EDGE_FEATURES = 8   # coords(2) + phi coeffs(2) + replicas(1) + workload(3)
REQ_FEATURES = 3    # source coords(2) + data size(1)
# Schema-v3 tier extras (PolicyConfig.tier_features): per-node cloud flag +
# cache locality, per-request deadline slack / priority / source residency.
TIER_EDGE_FEATURES = 2   # tier(1) + cache_frac(1)
TIER_REQ_FEATURES = 3    # req_slack(1) + req_priority(1) + req_cached(1)


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    # d_model=256 lands the parameter count at the paper's "about 4 million
    # learnable parameters" with the stated L=5/K=3/8-head/512-FC layout.
    d_model: int = 256
    num_heads: int = 8
    edge_layers: int = 5        # L (paper: 5)
    request_layers: int = 3     # K (paper: 3)
    ff_hidden: int = 512        # FC hidden dim (paper: 512, ReLU)
    tanh_clip: float = 10.0     # C in eq (16)
    norm: str = "batch"         # "batch" (paper) | "layer" (ablation knob)
    edge_align: str = "mha"     # "mha" (CoRaiS) | "mlp" (FC1/FC3)
    req_align: str = "mha"      # "mha" (CoRaiS) | "mlp" (FC2/FC3)
    feature_scale: float = 0.1  # static input scaling for workload features
    score_backend: str = "cuda"  # eq 16-17 head: "cuda" | "torch" | "ref"
    # Admission head: a per-request admit logit on top of the shared
    # encoders. Off by default so fault-free checkpoints keep their
    # parameter count.
    admit_head: bool = False
    admit_hidden: int = 64
    admit_bias: float = 2.0     # initial logit offset: start near admit-all
    # Edge–cloud tier conditioning (schema v3): widen both encoders' input
    # projections with the tier/cache-locality and deadline-slack/priority
    # features (zeros when an instance predates the tier).
    tier_features: bool = False


# ---------------------------------------------------------------------------
# feature builders
# ---------------------------------------------------------------------------


def edge_feature_dim(cfg: PolicyConfig) -> int:
    return EDGE_FEATURES + (TIER_EDGE_FEATURES if cfg.tier_features else 0)


def req_feature_dim(cfg: PolicyConfig) -> int:
    return REQ_FEATURES + (TIER_REQ_FEATURES if cfg.tier_features else 0)


def _tier_col(inst, key, like) -> torch.Tensor:
    """A (..., K, 1) tier-feature column, zeros when the instance predates
    schema v3."""
    if key in inst:
        return inst[key][..., None].to(torch.float32)
    return torch.zeros(like.shape[:-1] + (1,), dtype=torch.float32,
                       device=like.device)


def edge_features(inst, cfg: PolicyConfig | None = None) -> torch.Tensor:
    cols = [inst["edge_coords"], inst["phi"], inst["replicas"][..., None],
            inst["workload"]]
    if cfg is not None and cfg.tier_features:
        cols.append(_tier_col(inst, "tier", inst["phi"]))
        cols.append(_tier_col(inst, "cache_frac", inst["phi"]))
    return torch.cat(cols, dim=-1).to(torch.float32)


def request_features(inst, cfg: PolicyConfig | None = None) -> torch.Tensor:
    src = inst["req_src"][..., None].long()
    coords = torch.gather(inst["edge_coords"], -2,
                          src.expand(*src.shape[:-1], 2))
    size = inst["req_size"][..., None]
    cols = [coords, size]
    if cfg is not None and cfg.tier_features:
        cols.append(_tier_col(inst, "req_slack", size))
        cols.append(_tier_col(inst, "req_priority", size))
        cols.append(_tier_col(inst, "req_cached", size))
    return torch.cat(cols, dim=-1).to(torch.float32)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def _norm(cfg: PolicyConfig) -> nn.Module:
    return BatchNorm(cfg.d_model) if cfg.norm == "batch" else LayerNorm(cfg.d_model)


class EncoderLayer(nn.Module):
    """Alignment sublayer (MHA, or the parameter-matched bias-free d->2d->d
    MLP of the FC1/FC2/FC3 ablations), norm, FC(relu), norm."""

    def __init__(self, cfg: PolicyConfig, align: str, generator):
        super().__init__()
        d = cfg.d_model
        if align == "mha":
            self.align = nn.ModuleDict(
                {"mha": MHA(d, cfg.num_heads, generator=generator)})
        else:
            self.align = nn.ModuleDict({"mlp": nn.ModuleDict({
                "l1": Linear(d, 2 * d, bias=False, generator=generator),
                "l2": Linear(2 * d, d, bias=False, generator=generator)})})
        self.norm1 = _norm(cfg)
        self.fc = nn.ModuleDict({
            "l1": Linear(d, cfg.ff_hidden, generator=generator),
            "l2": Linear(cfg.ff_hidden, d, generator=generator)})
        self.norm2 = _norm(cfg)

    def forward(self, x, mask, *, training: bool = False,
                per_instance: bool = False):
        if "mha" in self.align:
            attn_mask = mask[..., None, None, :] & mask[..., None, :, None]
            a = self.align["mha"](x, mask=attn_mask)
        else:
            mlp = self.align["mlp"]
            a = mlp["l2"](torch.relu(mlp["l1"](x)))
        h = _apply_norm(self.norm1, x + a, mask, training, per_instance)
        f = self.fc["l2"](torch.relu(self.fc["l1"](h)))
        x = _apply_norm(self.norm2, h + f, mask, training, per_instance)
        return x * mask[..., None]


def _apply_norm(norm, x, mask, training, per_instance=False):
    if isinstance(norm, LayerNorm):
        return norm(x)
    return norm(x, mask, training=training, per_instance=per_instance)


class CoRaiSPolicy(nn.Module):
    """The CoRaiS policy parameters (about 4M at the paper's config).

    ``generator`` is a CPU ``torch.Generator`` for the uniform init (seeded
    0 when omitted); the parameters are then moved to ``device``, which
    defaults to CUDA and raises without it (``device="cpu"`` for the CPU)."""

    def __init__(self, cfg: PolicyConfig = PolicyConfig(), *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        d = cfg.d_model
        self.cfg = cfg
        self.edge_proj = Linear(edge_feature_dim(cfg), d, generator=g)
        self.req_proj = Linear(req_feature_dim(cfg), d, generator=g)
        self.edge_layers = nn.ModuleList(
            EncoderLayer(cfg, cfg.edge_align, g) for _ in range(cfg.edge_layers))
        self.req_layers = nn.ModuleList(
            EncoderLayer(cfg, cfg.req_align, g) for _ in range(cfg.request_layers))
        # eq (15): queries from [f_hat, h_hat, f_q] (3d), kv from requests
        self.ctx_mha = MHA(3 * d, cfg.num_heads, kv_dim=d, out_dim=d,
                           generator=g)
        self.w_px = nn.Parameter(uniform_init(g, (d, d), fan_in=d))
        self.w_py = nn.Parameter(uniform_init(g, (d, d), fan_in=d))
        if cfg.admit_head:
            # per-request MLP on [h_z ; f_hat]
            self.admit = nn.ModuleDict({
                "l1": Linear(2 * d, cfg.admit_hidden, generator=g),
                "l2": Linear(cfg.admit_hidden, 1, generator=g)})
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.w_px.device


def _masked_max(x, mask):
    """Max over the valid rows of axis -2; 0 where no row is valid. The
    reference's is -inf there, which the forward never reads (every key of
    the context attention is masked then), but whose gradient is -inf * 0 =
    NaN in the context attention's query and key weights (ROADMAP C6)."""
    m = x.masked_fill(~mask[..., None], -torch.inf).amax(dim=-2)
    return torch.where(mask.any(-1, keepdim=True), m, 0.0)


def corais_encode(policy: CoRaiSPolicy, inst, *, training: bool = False,
                  per_instance: bool = False):
    """Encoders + context decoder (eqs 12-15) on an instance dict of
    tensors (any leading batch shape). Returns (c_emb (..., Q, d), h_emb
    (..., Z, d)). ``training=True`` normalizes with batch statistics and
    updates the BatchNorm buffers in place. ``per_instance=True`` keeps the
    instances of the leading axes apart where an untrained BatchNorm falls
    back to batch statistics, as under the reference's ``vmap``."""
    cfg = policy.cfg
    emask = inst["edge_mask"]
    rmask = inst["req_mask"]
    # Static rescale of the heavy workload features (columns 5:8) and, with
    # tier features, of deadline slack and priority (request columns 3:5).
    ef = edge_features(inst, cfg)
    fs = cfg.feature_scale
    ef = torch.cat([ef[..., :5], ef[..., 5:8] * fs, ef[..., 8:]], dim=-1)
    rf = request_features(inst, cfg)
    if cfg.tier_features:
        rf = torch.cat([rf[..., :3], rf[..., 3:5] * fs, rf[..., 5:]], dim=-1)

    f = policy.edge_proj(ef)
    h = policy.req_proj(rf)
    for layer in policy.edge_layers:
        f = layer(f, emask, training=training, per_instance=per_instance)
    for layer in policy.req_layers:
        h = layer(h, rmask, training=training, per_instance=per_instance)

    f_hat = _masked_max(f, emask)  # (..., d)
    h_hat = _masked_max(h, rmask)
    q_ctx = torch.cat([f_hat[..., None, :].expand_as(f),
                       h_hat[..., None, :].expand_as(f), f], dim=-1)
    # attend only real requests
    c = policy.ctx_mha(q_ctx, kv_in=h, mask=rmask[..., None, None, :])
    return c, h


# ---------------------------------------------------------------------------
# eq 16-17 head and fused decode: registries
# ---------------------------------------------------------------------------


def _per_instance(fn, c_emb, h_emb, edge_mask):
    """Run a one-instance oracle over the flattened leading batch shape."""
    batch = c_emb.shape[:-2]
    q = c_emb.shape[-2]
    cf = c_emb.reshape(-1, *c_emb.shape[-2:])
    hf = h_emb.reshape(-1, *h_emb.shape[-2:])
    mf = edge_mask.expand(*batch, q).reshape(-1, q)
    outs = [fn(c, h, m) for c, h, m in zip(cf, hf, mf)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o).reshape(*batch, *o[0].shape)
                     for o in zip(*outs))
    return torch.stack(outs).reshape(*batch, *outs[0].shape)


def _score_ref(c_emb, h_emb, w_px, w_py, edge_mask, tanh_clip):
    return _per_instance(
        lambda c, h, m: ref.policy_score_ref(c, h, w_px, w_py, m, tanh_clip),
        c_emb, h_emb, edge_mask)


def _score_torch(c_emb, h_emb, w_px, w_py, edge_mask, tanh_clip):
    return ref.policy_score_torch(c_emb, h_emb, w_px, w_py, edge_mask,
                                  tanh_clip)


def _score_cuda(c_emb, h_emb, w_px, w_py, edge_mask, tanh_clip):
    return ops.policy_score(c_emb, h_emb, w_px, w_py, edge_mask,
                            tanh_clip=tanh_clip)


#: name -> fn(c_emb, h_emb, w_px, w_py, edge_mask, tanh_clip) -> (..., Z, Q)
SCORE_BACKENDS: dict[str, Callable] = {
    "torch": _score_torch,  # batched plain head (kernels/ref.py)
    "ref": _score_ref,      # per-instance oracle (kernels/ref.py)
    "cuda": _score_cuda,    # hand-written kernel (kernels/policy_score.py)
}


def _decode_ref(c_emb, h_emb, w_px, w_py, edge_mask, tanh_clip, k,
                normalize):
    return _per_instance(
        lambda c, h, m: ref.policy_score_decode_ref(c, h, w_px, w_py, m,
                                                    tanh_clip, k, normalize),
        c_emb, h_emb, edge_mask)


def _decode_torch(c_emb, h_emb, w_px, w_py, edge_mask, tanh_clip, k,
                  normalize):
    return ref.policy_score_decode_torch(c_emb, h_emb, w_px, w_py, edge_mask,
                                         tanh_clip, k, normalize)


def _decode_cuda(c_emb, h_emb, w_px, w_py, edge_mask, tanh_clip, k,
                 normalize):
    return ops.policy_score_decode(c_emb, h_emb, w_px, w_py, edge_mask,
                                   tanh_clip=tanh_clip, k=k,
                                   normalize=normalize)


#: name -> fn(c_emb, h_emb, w_px, w_py, edge_mask, tanh_clip, k, normalize)
#: -> ((..., Z, K) int32 top edges, (..., Z, K) float32 values)
DECODE_BACKENDS: dict[str, Callable] = {
    "torch": _decode_torch,  # materialized head + stable top-k
    "ref": _decode_ref,      # per-instance sort oracle
    "cuda": _decode_cuda,    # fused kernel, (Z, Q) never in device memory
}


def _lookup(registry: dict, kind: str, name: str) -> Callable:
    try:
        return registry[name]
    except KeyError:
        raise ValueError(f"unknown {kind} backend {name!r}; registered: "
                         f"{', '.join(sorted(registry))}") from None


def register_score_backend(name: str, fn: Callable) -> None:
    """Register a scoring implementation (see SCORE_BACKENDS signature)."""
    SCORE_BACKENDS[name] = fn


def list_score_backends() -> list[str]:
    return sorted(SCORE_BACKENDS)


def corais_score(policy: CoRaiSPolicy, c_emb, h_emb, edge_mask, *,
                 backend: str | None = None):
    """The eq 16-17 head on encoder outputs: log a_qz as (..., Z, Q).
    ``backend`` overrides ``cfg.score_backend``."""
    cfg = policy.cfg
    fn = _lookup(SCORE_BACKENDS, "score", backend or cfg.score_backend)
    return fn(c_emb, h_emb, policy.w_px, policy.w_py, edge_mask,
              cfg.tanh_clip)


def corais_score_decode(policy: CoRaiSPolicy, c_emb, h_emb, edge_mask, *,
                        k: int = 1, normalize: bool = True,
                        backend: str | None = None):
    """Fused eq 16-17 head + decode: per-request top-k edges as
    ``(top_idx, top_val)``, both (..., Z, K). ``top_idx[..., 0]`` is the
    greedy decision; ``normalize=True`` values are eq-17 log-probs,
    otherwise the clipped eq-16 compatibilities (the serving fast path)."""
    cfg = policy.cfg
    fn = _lookup(DECODE_BACKENDS, "decode", backend or cfg.score_backend)
    return fn(c_emb, h_emb, policy.w_px, policy.w_py, edge_mask,
              cfg.tanh_clip, k, normalize)


def corais_admit(policy: CoRaiSPolicy, c_emb, h_emb, edge_mask):
    """Admission-head logits on encoder outputs: (..., Z) per-request
    admit/shed scores (> 0 -> admit under greedy decoding), offset by
    ``cfg.admit_bias``."""
    if not hasattr(policy, "admit"):
        raise ValueError("policy has no admission head; build it with "
                         "PolicyConfig(admit_head=True)")
    f_hat = _masked_max(c_emb, edge_mask)  # (..., d) cluster context
    x = torch.cat([h_emb, f_hat[..., None, :].expand_as(h_emb)], dim=-1)
    hid = torch.relu(policy.admit["l1"](x))
    return policy.admit["l2"](hid)[..., 0] + policy.cfg.admit_bias


def corais_apply(policy: CoRaiSPolicy, inst, *, training: bool = False,
                 backend: str | None = None):
    """Full forward = corais_encode + corais_score: (..., Z, Q) log a_qz."""
    c, h = corais_encode(policy, inst, training=training)
    return corais_score(policy, c, h, inst["edge_mask"], backend=backend)
