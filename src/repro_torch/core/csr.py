"""Compressed-sparse-row storage for sparse lower-triangular systems.

Follows the paper's convention (Fig. 1b / Algo. 1):
  * the matrix is lower triangular with a non-zero diagonal,
  * within each row the off-diagonal entries come first (ascending column)
    and the diagonal entry is stored LAST (``rowptr[i+1]-1``),
  * ``rowptr`` has length ``n+1`` with ``rowptr[n] == nnz``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from .errors import MatrixValidationError

__all__ = [
    "TriCSR",
    "UpperCSR",
    "serial_solve",
    "serial_solve_upper",
    "from_coo",
    "transpose_upper",
    "random_rhs",
]


def _reject(name: str, msg: str, row: int | None = None):
    """Raise a `MatrixValidationError` naming the matrix (and row).

    Structured replacement for the historical bare ``assert``s: the checks
    keep running under ``python -O`` and the message pinpoints the defect.
    """
    where = f"matrix {name!r}" + (f", row {row}" if row is not None else "")
    raise MatrixValidationError(
        f"{where}: {msg}",
        detail={"matrix": name, **({"row": int(row)} if row is not None else {})},
    )


def _first_bad_row(rowptr: np.ndarray, mask: np.ndarray) -> int:
    """Map a per-nnz boolean defect mask to its (first) row index."""
    pos = int(np.argmax(mask))
    return int(np.searchsorted(rowptr, pos, side="right") - 1)


@dataclasses.dataclass(frozen=True)
class TriCSR:
    """A sparse lower-triangular matrix in the paper's CSR layout."""

    n: int
    rowptr: np.ndarray  # int64 [n+1]
    colidx: np.ndarray  # int64 [nnz]
    values: np.ndarray  # float64 [nnz]
    name: str = "unnamed"

    # ------------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.rowptr[-1])

    @property
    def n_edges(self) -> int:
        """Off-diagonal non-zeros == DAG edge count."""
        return self.nnz - self.n

    @property
    def binary_nodes(self) -> int:
        """Paper Table III: number of binary nodes == flop count == 2*nnz - n."""
        return 2 * self.nnz - self.n

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Check the layout contract; raises `MatrixValidationError`
        naming this matrix and the first offending row (vectorized —
        the per-row python loop only runs to localize a failure)."""
        rp, ci = self.rowptr, self.colidx
        if rp.shape != (self.n + 1,) or rp[0] != 0 or ci.shape[0] != rp[-1]:
            _reject(self.name, f"rowptr/colidx envelope broken "
                               f"(rowptr shape {rp.shape}, nnz {ci.shape})")
        deg = np.diff(rp)
        if np.any(deg < 1):
            _reject(self.name, "missing diagonal (empty row)",
                    int(np.argmax(deg < 1)))
        rows = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        if not np.array_equal(ci[rp[1:] - 1], np.arange(self.n)):
            bad = int(np.argmax(ci[rp[1:] - 1] != np.arange(self.n)))
            _reject(self.name, "diagonal must be stored last", bad)
        off = np.ones(ci.shape[0], dtype=bool)
        off[rp[1:] - 1] = False  # mask the diagonal slots
        if np.any(ci[off] >= rows[off]):
            m = np.zeros_like(off)
            m[off] = ci[off] >= rows[off]
            _reject(self.name, "super-diagonal entry",
                    _first_bad_row(rp, m))
        run = np.zeros(ci.shape[0], dtype=bool)
        run[1:] = (np.diff(ci) <= 0) & off[1:] & off[:-1] \
            & (rows[1:] == rows[:-1])
        if np.any(run):
            _reject(self.name, "unsorted/duplicate columns",
                    _first_bad_row(rp, run))
        if np.any(self.values[rp[1:] - 1] == 0.0):
            _reject(self.name, "zero diagonal",
                    int(np.argmax(self.values[rp[1:] - 1] == 0.0)))

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.rowptr[i], self.rowptr[i + 1]
        return self.colidx[lo:hi], self.values[lo:hi]

    def diag(self) -> np.ndarray:
        return self.values[self.rowptr[1:] - 1]

    def in_degree(self) -> np.ndarray:
        """Number of input edges (off-diagonal nnz) per node."""
        return np.diff(self.rowptr) - 1

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.n))
        for i in range(self.n):
            cols, vals = self.row(i)
            out[i, cols] = vals
        return out


def from_coo(
    n: int,
    rows: Iterable[int],
    cols: Iterable[int],
    vals: Iterable[float],
    diag: np.ndarray,
    name: str = "unnamed",
) -> TriCSR:
    """Build a TriCSR from strictly-lower COO triples plus a diagonal vector."""
    rows = np.asarray(list(rows), dtype=np.int64)
    cols = np.asarray(list(cols), dtype=np.int64)
    vals = np.asarray(list(vals), dtype=np.float64)
    if np.any(cols >= rows):
        bad = int(np.argmax(cols >= rows))
        _reject(name, f"COO part must be strictly lower triangular "
                      f"(entry ({rows[bad]}, {cols[bad]}))", int(rows[bad]))
    # de-duplicate (keep last) and sort row-major
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    rows, cols, vals, key = rows[order], cols[order], vals[order], key[order]
    keep = np.ones(len(key), dtype=bool)
    keep[:-1] = key[:-1] != key[1:]
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    counts = np.bincount(rows, minlength=n) + 1  # +1 diagonal per row
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=rowptr[1:])
    colidx = np.empty(rowptr[-1], dtype=np.int64)
    values = np.empty(rowptr[-1], dtype=np.float64)
    cursor = rowptr[:-1].copy()
    for r, c, v in zip(rows, cols, vals):
        colidx[cursor[r]] = c
        values[cursor[r]] = v
        cursor[r] += 1
    # diagonal last
    colidx[rowptr[1:] - 1] = np.arange(n)
    values[rowptr[1:] - 1] = np.asarray(diag, dtype=np.float64)
    mat = TriCSR(n=n, rowptr=rowptr, colidx=colidx, values=values, name=name)
    mat.validate()
    return mat


@dataclasses.dataclass(frozen=True)
class UpperCSR:
    """A sparse upper-triangular matrix, the mirror of `TriCSR`'s layout.

    Within each row the columns are ascending with the diagonal stored
    FIRST (``rowptr[i]``) — the natural output of transposing a `TriCSR`
    row-major.  Solved by backward substitution (`serial_solve_upper`) or
    compiled through the upper/transpose frontend
    (`core/frontends/upper.py`), which reverses the row order so the
    system becomes lower-triangular in the internal node numbering.
    """

    n: int
    rowptr: np.ndarray  # int64 [n+1]
    colidx: np.ndarray  # int64 [nnz]
    values: np.ndarray  # float64 [nnz]
    name: str = "unnamed"

    @property
    def nnz(self) -> int:
        return int(self.rowptr[-1])

    @property
    def n_edges(self) -> int:
        return self.nnz - self.n

    def validate(self) -> None:
        """Mirror of `TriCSR.validate` for the upper layout (diagonal
        first, strictly super-diagonal ascending tail); raises
        `MatrixValidationError` naming this matrix and row."""
        rp, ci = self.rowptr, self.colidx
        if rp.shape != (self.n + 1,) or rp[0] != 0 or ci.shape[0] != rp[-1]:
            _reject(self.name, f"rowptr/colidx envelope broken "
                               f"(rowptr shape {rp.shape}, nnz {ci.shape})")
        deg = np.diff(rp)
        if np.any(deg < 1):
            _reject(self.name, "missing diagonal (empty row)",
                    int(np.argmax(deg < 1)))
        rows = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        if not np.array_equal(ci[rp[:-1]], np.arange(self.n)):
            bad = int(np.argmax(ci[rp[:-1]] != np.arange(self.n)))
            _reject(self.name, "diagonal must be stored first", bad)
        off = np.ones(ci.shape[0], dtype=bool)
        off[rp[:-1]] = False  # mask the diagonal slots
        if np.any(ci[off] <= rows[off]):
            m = np.zeros_like(off)
            m[off] = ci[off] <= rows[off]
            _reject(self.name, "sub-diagonal entry", _first_bad_row(rp, m))
        run = np.zeros(ci.shape[0], dtype=bool)
        run[1:] = (np.diff(ci) <= 0) & off[1:] & off[:-1] \
            & (rows[1:] == rows[:-1])
        if np.any(run):
            _reject(self.name, "unsorted/duplicate columns",
                    _first_bad_row(rp, run))
        if np.any(self.values[rp[:-1]] == 0.0):
            _reject(self.name, "zero diagonal",
                    int(np.argmax(self.values[rp[:-1]] == 0.0)))

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.rowptr[i], self.rowptr[i + 1]
        return self.colidx[lo:hi], self.values[lo:hi]

    def diag(self) -> np.ndarray:
        return self.values[self.rowptr[:-1]]

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.n))
        for i in range(self.n):
            cols, vals = self.row(i)
            out[i, cols] = vals
        return out


def transpose_upper(mat: TriCSR, name: str | None = None) -> UpperCSR:
    """Return ``U = Lᵀ`` as an `UpperCSR` (CSR of Lᵀ == CSC of L).

    Row j of U collects every L[i, j] sorted by i ascending; since L is
    lower triangular with a full diagonal, the first entry of each U row
    is automatically the diagonal.
    """
    n = mat.n
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(mat.rowptr))
    order = np.argsort(mat.colidx * n + rows, kind="stable")
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(mat.colidx, minlength=n), out=rowptr[1:])
    out = UpperCSR(
        n=n,
        rowptr=rowptr,
        colidx=rows[order],
        values=mat.values[order],
        name=name if name is not None else f"{mat.name}^T",
    )
    out.validate()
    return out


def serial_solve(mat: TriCSR, b: np.ndarray) -> np.ndarray:
    """Algorithm 1 of the paper — the ground-truth oracle."""
    x = np.zeros(mat.n, dtype=np.float64)
    for i in range(mat.n):
        lo, hi = mat.rowptr[i], mat.rowptr[i + 1]
        s = 0.0
        for j in range(lo, hi - 1):
            s += mat.values[j] * x[mat.colidx[j]]
        x[i] = (b[i] - s) / mat.values[hi - 1]
    return x


def serial_solve_upper(mat: UpperCSR, b: np.ndarray) -> np.ndarray:
    """Backward substitution for Ux=b — the upper-frontend oracle."""
    x = np.zeros(mat.n, dtype=np.float64)
    for i in range(mat.n - 1, -1, -1):
        lo, hi = mat.rowptr[i], mat.rowptr[i + 1]
        s = 0.0
        for j in range(lo + 1, hi):
            s += mat.values[j] * x[mat.colidx[j]]
        x[i] = (b[i] - s) / mat.values[lo]
    return x


def random_rhs(mat: TriCSR, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(mat.n)
