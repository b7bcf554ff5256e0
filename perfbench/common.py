"""Helpers the loops and metric readers share."""

from __future__ import annotations

import contextlib
import math

import numpy as np

__all__ = ["rhs_pool", "RhsStream", "annotator", "percentile", "seed_rng"]

# scales a right-hand side's pool rows are multiplied by: a prime count, so
# that the pairs (pool row, scale) of consecutive requests do not repeat
# before pool * SCALES of them
SCALES = 1021


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream ``stream`` of the run's seed."""
    return np.random.default_rng([int(seed) % 2**64, int(stream)])


def rhs_pool(n: int, count: int, seed: int, device) -> np.ndarray:
    """``[count, n]`` float32 right-hand sides drawn from the seed, made on
    ``device`` in one call and brought to the host: row i is the i-th
    right-hand side, a contiguous ``[n]`` view."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    pool = torch.randn(count, n, generator=g, device=device,
                       dtype=torch.float32)
    return pool.cpu().numpy()


class RhsStream:
    """Right-hand sides that differ at every request, drawn from the seed.

    Request i's ``k`` columns are pool rows ``first .. first + k - 1``, each
    multiplied by the float32 scale ``i % SCALES`` (uniform in [0.5, 2]
    with a random sign): before ``pool * SCALES`` requests no two of them
    hold the same numbers, while the pool is drawn once before the window.
    ``fill(i, first, k, out)`` writes request i's columns as rows into
    ``out`` (``[k, n]`` float32); ``make`` returns a new array, and calling
    either again gives the same numbers.
    """

    def __init__(self, n: int, pool: int, seed: int, device):
        self.pool = rhs_pool(n, pool, seed, device)
        rng = seed_rng(seed, 4)
        self.scales = (rng.uniform(0.5, 2.0, SCALES)
                       * rng.choice([-1.0, 1.0], SCALES)).astype(np.float32)

    def fill(self, i: int, first: int, k: int, out: np.ndarray) -> np.ndarray:
        return np.multiply(self.pool[first:first + k], self.scales[i % SCALES],
                           out=out)

    def make(self, i: int, first: int, k: int) -> np.ndarray:
        return self.pool[first:first + k] * self.scales[i % SCALES]


def annotator(on: bool):
    """``span(name)``: a ``record_function`` range in a traced run and
    nothing otherwise."""
    if not on:
        null = contextlib.nullcontext()
        return lambda name: null
    from torch.profiler import record_function

    return record_function


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (linear between order statistics), or None
    for no values.  An ``inf`` (a request never answered) stays in the
    population: a percentile that reaches it reads ``inf``."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    v = v[~np.isnan(v)]
    if v.size == 0:
        return None
    pos = (v.size - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, v.size - 1)
    a, b = float(v[lo]), float(v[hi])
    if pos == lo or a == b:
        return a
    return a + (b - a) * (pos - lo)
