"""The plain reference: forward substitution Lx = b over the CSR arrays.

It reads the arrays the benchmark made (`matrices`), never anything the
program made, and imports nothing of the program.  `solve` runs in float64
and is what `correct` is decided against.  `solve_lowered` is the same
sweep with every value and every operation in a lower precision
(bfloat16): the control, which the limit has to fail (`control.py`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["solve", "solve_lowered", "rel_err"]


def solve(rowptr, cols, vals, diag, b) -> np.ndarray:
    """x of ``L x = b`` in float64 for ``b`` of shape ``[n]`` or ``[n, k]``.

    Row i: ``x[i] = (b[i] - sum_j L[i, j] x[j]) / L[i, i]``, one row after
    another, all columns at once.
    """
    b = np.asarray(b, dtype=np.float64)
    single = b.ndim == 1
    x = np.array(b[:, None] if single else b, dtype=np.float64, order="C")
    vals = np.asarray(vals, dtype=np.float64)
    diag = np.asarray(diag, dtype=np.float64)
    for i in range(len(diag)):
        s, e = rowptr[i], rowptr[i + 1]
        if e > s:
            x[i] -= vals[s:e] @ x[cols[s:e]]
        x[i] /= diag[i]
    return x[:, 0] if single else x


def solve_lowered(rowptr, cols, vals, diag, b, dtype=None) -> np.ndarray:
    """The same sweep with values, x and every operation in ``dtype``
    (bfloat16 by default, the precision below the configurations'
    float32); returns float64."""
    import torch

    dtype = torch.bfloat16 if dtype is None else dtype
    b = np.asarray(b, dtype=np.float64)
    single = b.ndim == 1
    x = torch.from_numpy(b[:, None] if single else b).to(dtype).contiguous()
    v = torch.from_numpy(np.asarray(vals, dtype=np.float64)).to(dtype)
    d = torch.from_numpy(np.asarray(diag, dtype=np.float64)).to(dtype)
    c = torch.from_numpy(np.asarray(cols, dtype=np.int64))
    for i in range(len(diag)):
        s, e = int(rowptr[i]), int(rowptr[i + 1])
        if e > s:
            x[i] = x[i] - v[s:e] @ x[c[s:e]]
        x[i] = x[i] / d[i]
    out = x.to(torch.float64).numpy()
    return out[:, 0] if single else out


def rel_err(x, x_ref) -> np.ndarray:
    """Per column ``max|x - x_ref| / max|x_ref|`` (the inf-norm relative
    error); a non-finite answer reads ``inf``."""
    x = np.asarray(x, dtype=np.float64)
    x_ref = np.asarray(x_ref, dtype=np.float64)
    if x.ndim == 1:
        x, x_ref = x[:, None], x_ref[:, None]
    scale = np.abs(x_ref).max(axis=0)
    err = np.abs(x - x_ref).max(axis=0) / np.where(scale > 0, scale, 1.0)
    return np.where(np.isfinite(x).all(axis=0), err, np.inf)
