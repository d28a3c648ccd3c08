"""Continuous batching of dispatched requests into a real LM backend
(counterpart of ``repro/serving/batching.py``).

``LMEdgeBackend`` runs an actual model on one device: prefill on
admission (on the card, kernel B4 in every attention layer and kernel B6 in
every SSM layer), then decode steps over the active batch (kernel B5 in
every attention layer; the SSM step is plain torch ops), admitting queued
requests into free lanes between steps (vLLM-style continuous batching
with a fixed batch shape). Measured (prompt_tokens, latency) pairs feed the edge's
PhiEstimator: the live demonstration that LM serving is an *ideal service*
in the paper's sense (§III-C1, runtime affine in input size), closing the
loop between the serving substrate and the paper's state-evaluation model.

Against the reference: the batch cache is updated in place (the splice of
an admitted lane's prefill cache, and every decode step), where the
reference returns new arrays; prompts come from the same numpy stream, so
the same seed draws the same prompts.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.state import PhiEstimator
from repro_torch.models import lm


@dataclasses.dataclass
class LaneState:
    rid: int = -1
    remaining: int = 0
    generated: int = 0


class LMEdgeBackend:
    """One edge's model server: ``lanes`` concurrent sequences (the edge's
    service-replica count), fixed ``max_seq`` ring cache per lane.
    ``params`` (from :func:`repro_torch.models.init_params`) must live on
    ``device`` (CUDA by default)."""

    def __init__(self, cfg: ModelConfig, params, lanes: int = 4,
                 max_seq: int = 128, seed: int = 0, device=None):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"backend on {self.device}")
        self.cfg = cfg
        self.params = params
        self.lanes = lanes
        self.max_seq = max_seq
        self.phi = PhiEstimator()
        self._lane_states = [LaneState() for _ in range(lanes)]
        self._queue: list[tuple[int, np.ndarray, int]] = []  # rid, prompt, gen_len
        self._rng = np.random.default_rng(seed)
        self.finished: dict[int, int] = {}  # rid -> generated tokens
        self._cache = lm.init_cache(cfg, lanes, max_seq, self.device)
        self._tokens = torch.zeros((lanes,), dtype=torch.int32,
                                   device=self.device)
        self._head = lm.head_f32(params, cfg)  # one f32 copy, every step

    # -- admission --------------------------------------------------------

    def submit(self, rid: int, prompt_len: int, gen_len: int) -> None:
        prompt = self._rng.integers(
            0, self.cfg.vocab_size, size=(1, max(prompt_len, 2))).astype(np.int32)
        self._queue.append((rid, prompt, gen_len))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _admit(self) -> None:
        for lane, st in enumerate(self._lane_states):
            if st.remaining > 0 or not self._queue:
                continue
            rid, prompt, gen_len = self._queue.pop(0)
            t0 = time.perf_counter()
            cache1, logits = lm.prefill(
                self.params, {"tokens": torch.from_numpy(prompt).to(self.device)},
                self.cfg, max_seq=self.max_seq, head=self._head)
            self._sync()
            dt = time.perf_counter() - t0
            self.phi.observe(prompt.shape[1], dt)  # ideal-service fit
            _splice_cache(self._cache, cache1, lane)
            self._tokens[lane] = int(torch.argmax(logits[0])) % self.cfg.vocab_size
            self._lane_states[lane] = LaneState(rid=rid, remaining=gen_len)

    # -- decode loop --------------------------------------------------------

    def step(self) -> int:
        """Admit + one decode step over the whole batch. Returns #active."""
        self._admit()
        active = [i for i, s in enumerate(self._lane_states) if s.remaining > 0]
        if not active:
            return 0
        self._cache, logits = lm.decode_step(
            self.params, self._cache, {"token": self._tokens}, self.cfg,
            head=self._head)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        live = torch.tensor([s.remaining > 0 for s in self._lane_states],
                            device=self.device)
        self._tokens = torch.where(live, nxt % self.cfg.vocab_size,
                                   self._tokens)
        for i in active:
            st = self._lane_states[i]
            st.remaining -= 1
            st.generated += 1
            if st.remaining == 0:
                self.finished[st.rid] = st.generated
                self._lane_states[i] = LaneState()
        return len(active)

    def drain(self, max_steps: int = 10_000) -> None:
        steps = 0
        while (self._queue or any(s.remaining for s in self._lane_states)) \
                and steps < max_steps:
            self.step()
            steps += 1


def _splice_cache(batch_cache, one_cache, lane: int):
    """Insert a single-sequence cache into lane ``lane`` of a batched cache,
    in place (``repro/serving/batching.py:117-137``). The slot positions
    and the K/V window axis are padded or cropped to the batch's window
    where the family has attention; SSM states ``h`` and ``conv`` do not
    depend on length and are copied whole."""
    batch_cache["pos"][lane] = one_cache["pos"][0]
    if "slot_pos" in batch_cache:
        w_b = batch_cache["slot_pos"].shape[1]
        sp = _fit_axis(one_cache["slot_pos"], w_b, axis=1, fill=-1)
        batch_cache["slot_pos"][lane] = sp[0]
    for key, b in batch_cache["layers"].items():
        o = one_cache["layers"][key]
        if key in ("k", "v"):
            o = _fit_axis(o, b.shape[2], axis=2, fill=0)
        b[:, lane] = o[:, 0]
    return batch_cache


def _fit_axis(x: torch.Tensor, size: int, axis: int, fill=0) -> torch.Tensor:
    """``x`` cropped to its last ``size`` entries along ``axis``, or padded
    at the end with ``fill``."""
    cur = x.shape[axis]
    if cur == size:
        return x
    if cur > size:
        return x.narrow(axis, cur - size, size)
    shape = list(x.shape)
    shape[axis] = size - cur
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=axis)
