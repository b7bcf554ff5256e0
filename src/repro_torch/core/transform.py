"""Beyond-paper optimization: medium-node splitting for load balance.

The paper's §V-E identifies the residual bottleneck of the medium
granularity dataflow: "a small number of coarse nodes have significantly
more edges than other coarse nodes ... transforming coarse nodes into fine
or medium nodes may help mitigate load imbalance.  A medium node is a node
that performs the same basic operations as a coarse node but has fewer
input edges ... further research is required."  This module is that
research step, done as pure matrix surgery so the unmodified compiler and
hardware model run it:

A row i with in-degree k > max_indegree is split by introducing auxiliary
unknowns (one per chunk of `max_indegree` edges)

    y_c = sum_{j in chunk c} L_ij x_j        (aux row: diag 1, rhs 0)
    x_i = (b_i - sum_c y_c - sum_{rest} L_ij x_j) / L_ii

which yields an EQUIVALENT, still lower-triangular system whose DAG has
bounded in-degree: the aux nodes are medium nodes allocatable to different
CUs, parallelizing what was a serial k-edge accumulation chain on one CU.
Cost: one extra edge + one extra finalize per chunk (the psum feedback
keeps each chunk's accumulation local, exactly the paper's locality
argument).  `solve` results map back through `orig_index`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .csr import TriCSR

__all__ = ["SplitResult", "split_heavy_nodes"]


@dataclasses.dataclass(frozen=True)
class SplitResult:
    mat: TriCSR
    orig_index: np.ndarray   # position of original row i in the new system
    n_aux: int

    def expand_rhs(self, b: np.ndarray) -> np.ndarray:
        """Lift ``b`` (``[n]`` or ``[n, B]``) into the split system's space.

        Aux rows get rhs 0; any trailing batch axes are preserved so the
        transform composes with the batched and sharded solve paths.
        """
        b = np.asarray(b)
        nb = np.zeros((self.mat.n, *b.shape[1:]), dtype=b.dtype)
        nb[self.orig_index] = b
        return nb

    def extract(self, x_new: np.ndarray) -> np.ndarray:
        """Project a split-system solution back to the original unknowns
        (row gather — trailing batch axes pass through untouched)."""
        return np.asarray(x_new)[self.orig_index]


def split_heavy_nodes(mat: TriCSR, max_indegree: int = 48) -> SplitResult:
    """Split every row with more than `max_indegree` off-diagonals."""
    n = mat.n
    new_rows: list[tuple[np.ndarray, np.ndarray, float]] = []  # cols,vals,diag
    orig_index = np.zeros(n, dtype=np.int64)
    old2new: dict[int, int] = {}
    n_aux = 0

    for i in range(n):
        cols, vals = mat.row(i)
        off_c, off_v, diag = cols[:-1], vals[:-1], vals[-1]
        k = len(off_c)
        mapped = np.array([old2new[int(c)] for c in off_c], dtype=np.int64)
        if k <= max_indegree:
            new_rows.append((mapped, off_v.copy(), float(diag)))
        else:
            # chunk the edges; keep the LAST chunk inline on the parent so
            # the parent still has direct work while aux nodes compute
            n_chunks = -(-k // max_indegree)
            aux_ids = []
            for c in range(n_chunks - 1):
                lo, hi = c * max_indegree, (c + 1) * max_indegree
                # solver computes y = (0 - sum(v * x)) / 1, so negate to get
                # y_c = +sum(L_ij x_j); the parent then subtracts 1 * y_c
                new_rows.append((mapped[lo:hi], -off_v[lo:hi], 1.0))
                aux_ids.append(len(new_rows) - 1)
                n_aux += 1
            lo = (n_chunks - 1) * max_indegree
            par_cols = np.concatenate([mapped[lo:], np.array(aux_ids, np.int64)])
            par_vals = np.concatenate([off_v[lo:], np.full(len(aux_ids), 1.0)])
            order = np.argsort(par_cols)
            new_rows.append((par_cols[order], par_vals[order], float(diag)))
        old2new[i] = len(new_rows) - 1
        orig_index[i] = len(new_rows) - 1

    m = len(new_rows)
    rowptr = np.zeros(m + 1, dtype=np.int64)
    for r, (c, v, d) in enumerate(new_rows):
        rowptr[r + 1] = rowptr[r] + len(c) + 1
    colidx = np.empty(rowptr[-1], dtype=np.int64)
    values = np.empty(rowptr[-1], dtype=np.float64)
    for r, (c, v, d) in enumerate(new_rows):
        lo = rowptr[r]
        colidx[lo : lo + len(c)] = c
        values[lo : lo + len(c)] = v
        colidx[rowptr[r + 1] - 1] = r
        values[rowptr[r + 1] - 1] = d
    out = TriCSR(n=m, rowptr=rowptr, colidx=colidx, values=values,
                 name=f"{mat.name}+split{max_indegree}")
    out.validate()
    return SplitResult(mat=out, orig_index=orig_index, n_aux=n_aux)
