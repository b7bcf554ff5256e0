"""Upper-triangular / transpose-solve frontend (CSC-row reversal).

An upper-triangular system Ux=b is a lower-triangular system in reversed
row order: with the reversal permutation ``r(i) = n-1-i``, the matrix
``P U Pᵀ`` (P the reversal) is lower triangular, so node ``k = r(i)``
solves unknown ``i`` and its sources ``r(j), j > i`` are strictly smaller
node ids — exactly the `ComputeDag` contract.  The lowering therefore
returns ``(dag, perm)`` where ``perm[k] = n-1-k`` maps internal node ids
back to user-space rows: feed the compiled program ``b[perm]``, read the
solution as ``x[perm] = x_internal`` (the reversal is an involution).

The transpose solve Lᵀx=b — the backward sweep of an incomplete-Cholesky
preconditioner application — is the special case ``U = Lᵀ``
(`csr.transpose_upper`); `api.compile_pair` packages both sweeps.
"""

from __future__ import annotations

import numpy as np

from ..compiler.ir import ComputeDag
from ..csr import TriCSR, UpperCSR, transpose_upper

__all__ = ["lower_upper", "lower_transpose"]


def lower_upper(mat: UpperCSR) -> tuple[ComputeDag, np.ndarray]:
    """Lower Ux=b to a `ComputeDag` via row reversal; returns (dag, perm).

    ``perm[k]`` is the user-space row solved by internal node ``k``
    (``perm = [n-1, ..., 0]``, its own inverse).
    """
    n = mat.n
    counts = np.diff(mat.rowptr) - 1          # off-diagonals per U row
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts[::-1], out=ptr[1:])      # node k == U row n-1-k
    # U row i holds the diag first, then cols j > i ascending; under the
    # reversal the entry (i, j) becomes edge src n-1-j of node n-1-i, so a
    # stable sort by (node, src) yields the per-node-ascending edge order.
    off = np.ones(mat.nnz, dtype=bool)
    off[mat.rowptr[:-1]] = False              # drop the leading diagonals
    node = n - 1 - np.repeat(np.arange(n, dtype=np.int64), counts + 1)[off]
    srcs = n - 1 - mat.colidx[off]
    order = np.argsort(node * n + srcs, kind="stable")
    src = srcs[order]
    weight = mat.values[off][order]
    scale = (1.0 / mat.diag())[::-1]
    perm = np.arange(n - 1, -1, -1, dtype=np.int64)
    dag = ComputeDag(name=f"{mat.name}+rev", n=n, ptr=ptr, src=src,
                     weight=weight, scale=scale)
    return dag, perm


def lower_transpose(mat: TriCSR) -> tuple[ComputeDag, np.ndarray]:
    """Lower the transpose solve Lᵀx=b; returns (dag, perm) as above."""
    return lower_upper(transpose_upper(mat))
