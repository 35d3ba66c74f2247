"""Deterministic, checkpointable synthetic token pipeline: a numpy copy of
``repro.data.pipeline`` over the port's ``ModelConfig``, bit for bit (the
same ``SeedSequence(entropy=seed, spawn_key=(step,))`` generator per
batch, the same draws in the same order).

The iterator's whole state is (seed, step), so a restore replays the
exact same batches; batches are sharded per data-parallel rank by slicing
the global batch. Geometric document lengths create the packing
irregularity the GLB balancer cares about.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d):
        return DataState(int(d["seed"]), int(d["step"]))


class SyntheticTokens:
    """Zipf-ish token stream with geometric document lengths, packed into
    fixed (B, S) batches with EOS separators. Deterministic in (seed,
    step). Batches are numpy arrays: tokens int32 ((B, S, K) for audio),
    or for vlm embeds float32 (B, S, D), positions (B, S, 3) and labels."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 eos: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.eos = eos
        self.state = DataState(seed=seed, step=0)

    def _gen(self, rng: np.random.Generator, n: int) -> np.ndarray:
        # zipf-flavored unigram stream, clipped to vocab
        z = rng.zipf(1.3, size=n).astype(np.int64)
        return np.minimum(z + 1, self.cfg.vocab - 1)

    def next_batch(self) -> Dict[str, np.ndarray]:
        st = self.state
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=st.seed, spawn_key=(st.step,)))
        B, S = self.batch, self.seq
        toks = self._gen(rng, B * S).reshape(B, S)
        # document boundaries (geometric lengths, mean S/4)
        for b in range(B):
            pos = 0
            while pos < S:
                pos += int(rng.geometric(4.0 / S)) + 1
                if pos < S:
                    toks[b, pos] = self.eos
        self.state = DataState(st.seed, st.step + 1)
        cfg = self.cfg
        if cfg.n_codebooks:
            q = np.stack([(toks * (k + 3)) % cfg.vocab
                          for k in range(cfg.n_codebooks)], axis=-1)
            return {"tokens": q.astype(np.int32)}
        if cfg.family == "vlm":
            embeds = rng.standard_normal((B, S, cfg.d_model)).astype(
                np.float32)
            pos3 = np.broadcast_to(
                np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3)).copy()
            return {"embeds": embeds, "positions": pos3,
                    "labels": toks.astype(np.int32)}
        return {"tokens": toks.astype(np.int32)}

    def shard(self, batch: Dict[str, np.ndarray], rank: int, world: int):
        per = self.batch // world
        return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
