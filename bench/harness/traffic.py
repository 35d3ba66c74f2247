"""The one traffic generator: reads a traffic mix's parameters (a data file
under ``bench/traffic/``) and makes its requests from the run's seed.

A mix file holds:

* ``prompt`` and ``output``: token lengths, ``{"dist": "lognormal",
  "median": m, "sigma": s, "min": a, "max": b, "block": n}``;
* ``load``: ``{"kind": "backlog"}`` (a closed loop that keeps at least
  ``max_slots`` requests queued) or ``{"kind": "poisson", "rate_per_s":
  r, "warmup_s": w}`` (an open loop).

Every seed gets the same set of sizes in another order: the lengths come
in blocks of ``block`` requests, each block a permutation, drawn from the
seed, of the ``block`` stratified quantiles of the distribution, clipped
to [min, max]. So a window's work depends on the seed only through the
order. Arrivals are a Poisson process: independent exponential gaps of
mean ``1 / rate_per_s``, drawn from the seed. Token ids are uniform over
the vocabulary, drawn from the seed.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 128), *stream]))


def quantiles(spec: dict) -> List[float]:
    """The ``block`` stratified quantiles of a length distribution, before
    rounding."""
    n = spec["block"]
    qs = [(j + 0.5) / n for j in range(n)]
    if spec["dist"] == "lognormal":
        nd = NormalDist()
        return [spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf(q))
                for q in qs]
    raise ValueError(f"unknown distribution {spec['dist']!r}")


def lengths(spec: dict) -> List[int]:
    return [int(min(max(round(x), spec["min"]), spec["max"]))
            for x in quantiles(spec)]


class Traffic:
    """Request ``i`` of a mix under one seed: its prompt ids, its output
    budget and (open loop) its due time from the start of arrivals."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed), vocab
        self.load = mix["load"]
        self._prompt = lengths(mix["prompt"])
        self._output = lengths(mix["output"])
        self._gaps = _rng(self.seed, 4)
        self._perm = {}
        self._due = [0.0]

    def _pick(self, table: list, stream: int, i: int):
        n = len(table)
        k = (stream, i // n)
        if k not in self._perm:
            self._perm[k] = _rng(self.seed, stream, i // n).permutation(n)
        return table[self._perm[k][i % n]]

    def prompt_len(self, i: int) -> int:
        return self._pick(self._prompt, 1, i)

    def max_new(self, i: int) -> int:
        return self._pick(self._output, 2, i)

    def prompt(self, i: int) -> List[int]:
        return _rng(self.seed, 3, i).integers(
            0, self.vocab, self.prompt_len(i)).tolist()

    def request(self, i: int) -> Tuple[List[int], int]:
        return self.prompt(i), self.max_new(i)

    def due(self, i: int) -> float:
        """Seconds from the start of arrivals to request ``i``'s due time
        (open loop)."""
        while len(self._due) <= i:
            self._due.append(self._due[-1] + self._gaps.exponential(
                1.0 / self.load["rate_per_s"]))
        return self._due[i]
