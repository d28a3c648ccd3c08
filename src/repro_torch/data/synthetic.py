"""Synthetic LM data: the deterministic token pipeline and the input specs
(counterpart of ``repro/data/synthetic.py``).

The batches and the token stream are numpy, copied from the reference so
that the same seed gives the same tokens bit for bit; ``input_specs``
returns tensors on the ``meta`` device (shape and dtype, no storage) where
the reference returns ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm


def _float(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _train_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    d = {}
    if cfg.encoder_decoder:
        d["embeds"] = ((batch, seq, cfg.d_model), _float(cfg))
        d["tokens"] = ((batch, seq), torch.int32)
    elif not cfg.embed_input:
        d["embeds"] = ((batch, seq, cfg.d_model), _float(cfg))
        if cfg.mrope:
            d["positions"] = ((3, batch, seq), torch.int32)
    else:
        d["tokens"] = ((batch, seq), torch.int32)
    d["labels"] = ((batch, seq), torch.int32)
    return d


def _prefill_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    d = _train_shapes(cfg, batch, seq)
    d.pop("labels")
    return d


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _decode_cache(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The decode cache's shapes and dtypes on ``meta``: the port's
    ``init_cache``, the reference's layout (``repro/models/lm.py:226-244``)
    for every family, whisper's encoder output included."""
    return lm.init_cache(cfg, batch, max_seq, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors for one (arch x shape) cell: train/prefill ->
    {"batch": ...}; decode -> {"cache": ..., "batch": ...}, a cache filled
    to ``seq_len`` and one new token per sequence."""
    b, s = shape.global_batch, shape.seq_len

    def specs(d):
        return {k: _meta(sh, dt) for k, (sh, dt) in d.items()}

    if shape.kind == "train":
        return {"batch": specs(_train_shapes(cfg, b, s))}
    if shape.kind == "prefill":
        return {"batch": specs(_prefill_shapes(cfg, b, s))}
    batch = {"token": _meta((b,), torch.int32)}
    if cfg.mrope:
        batch["positions"] = _meta((3, b), torch.int32)
    return {"cache": _decode_cache(cfg, b, s), "batch": batch}


def make_batch(rng: np.random.Generator, cfg: ModelConfig, batch: int,
               seq: int, kind: str = "train") -> dict:
    """A numpy batch with the structure of ``input_specs``' train/prefill
    batch, drawn from ``rng`` in the reference's order."""
    shapes = (_train_shapes(cfg, batch, seq) if kind == "train"
              else _prefill_shapes(cfg, batch, seq))
    out = {}
    for k, (sh, _) in shapes.items():
        if k in ("tokens", "labels"):
            out[k] = rng.integers(0, cfg.vocab_size, size=sh).astype(np.int32)
        elif k == "positions":
            out[k] = np.broadcast_to(np.arange(sh[-1], dtype=np.int32),
                                     sh).copy()
        else:  # embeds
            out[k] = (0.02 * rng.standard_normal(size=sh)).astype(np.float32)
    return out


def make_decode_batch(rng: np.random.Generator, cfg: ModelConfig,
                      batch: int) -> dict:
    out = {"token": rng.integers(0, cfg.vocab_size,
                                 size=(batch,)).astype(np.int32)}
    if cfg.mrope:
        out["positions"] = np.zeros((3, batch), np.int32)
    return out


@dataclasses.dataclass
class SyntheticTokens:
    """Deterministic, checkpointable synthetic token stream.

    Sequences are Zipf(1.3) draws seeded by (seed, step), so a restored
    pipeline resumes exactly where it left off."""

    vocab_size: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0

    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, d: dict) -> None:
        self.seed = int(d["seed"])
        self.step = int(d["step"])

    def __next__(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = (z % self.vocab_size).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        return self
