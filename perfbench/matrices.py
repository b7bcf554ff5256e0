"""The benchmark's own, frozen copy of the port's matrix archetypes.

`banded` and `circuit` are copies of the generators of
``repro_torch.core.matrices`` (the same draws in the same order, so the same
sparsity pattern from the same pattern seed); `values` is that module's
``_finish`` with one change: the values are drawn from the run's ``--seed``
instead of continuing the pattern's generator.  Every seed therefore
compiles the same schedule and solves different numbers.  A test
(`tests/test_perfbench_inputs.py`) holds the copy's pattern to the port's.

A matrix here is plain numpy: strictly lower COO ``(rows, cols, vals)``
sorted by row then column, without duplicates, and the diagonal ``diag``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["GENERATORS", "pattern", "values", "to_csr"]


def banded(n: int, bandwidth: int, fill: float, seed: int):
    """FEM-style band (jagmesh / dw2048 / rdb archetype)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(1, n):
        lo = max(0, i - bandwidth)
        cand = np.arange(lo, i)
        take = cand[rng.random(len(cand)) < fill]
        if len(take) == 0 and i > 0:
            take = np.array([i - 1])
        rows.extend([i] * len(take))
        cols.extend(take.tolist())
    return rows, cols


def circuit(n: int, hubs: int, avg_deg: float, seed: int):
    """Circuit-Jacobian archetype (add20 / rajat / circuit204): a few hub
    columns consumed by many rows plus sparse random filler."""
    rng = np.random.default_rng(seed)
    hub_ids = np.sort(rng.choice(np.arange(n // 8), size=hubs, replace=False))
    rows, cols = [], []
    for i in range(1, n):
        deg = 1 + rng.poisson(max(avg_deg - 1.0, 0.1))
        picked = set()
        for _ in range(deg):
            if rng.random() < 0.45:
                h = hub_ids[rng.integers(len(hub_ids))]
                if h < i:
                    picked.add(int(h))
            else:
                span = max(1, min(i, int(n * 0.05)))
                picked.add(int(i - 1 - rng.integers(span)))
        picked.discard(i)
        for j in sorted(picked):
            rows.append(i)
            cols.append(j)
    return rows, cols


GENERATORS = {"banded": banded, "circuit": circuit}


def pattern(cfg: dict) -> tuple[int, np.ndarray, np.ndarray]:
    """``(n, rows, cols)`` of the configuration's strictly lower pattern."""
    gen = cfg["generator"]
    rows, cols = GENERATORS[gen["kind"]](**gen["args"])
    return (int(gen["args"]["n"]), np.asarray(rows, dtype=np.int64),
            np.asarray(cols, dtype=np.int64))


def values(n: int, nnz_off: int, seed: int, scale: float = 0.5,
           diag_range=(1.0, 2.0)) -> tuple[np.ndarray, np.ndarray]:
    """``_finish``'s draws from the run's seed: off-diagonals
    U(-scale, scale), |diag| in ``diag_range`` with a random sign."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    vals = rng.uniform(-scale, scale, size=nnz_off)
    lo, hi = diag_range
    diag = rng.uniform(lo, hi, size=n) * rng.choice([-1.0, 1.0], size=n)
    return vals, diag


def to_csr(n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """Row pointers over the row-sorted strictly lower COO: ``(rowptr,
    cols, vals)``, the diagonal kept apart."""
    if len(rows) and np.any(np.diff(rows * n + cols) <= 0):
        raise ValueError("COO must be sorted by (row, column) without "
                         "duplicates")
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=rowptr[1:])
    return rowptr, cols, vals
