"""Lower-triangular SpTRSV frontend: `TriCSR` → `ComputeDag`.

The paper's workload.  Row i of Lx=b computes

    x[i] = (b[i] - sum_{j<i} L_ij x[j]) / L_ii

which is the `ComputeDag` node contract with edge weights L_ij and node
scale 1/L_ii (division as multiplication by the compiler-computed
reciprocal, §III-B).  Row order is already a topological order, so the
lowering is a pure re-slicing of the CSR arrays: drop the trailing
per-row diagonal, invert it into the scale vector.
"""

from __future__ import annotations

import numpy as np

from ..compiler.ir import ComputeDag
from ..csr import TriCSR

__all__ = ["lower_tri"]


def lower_tri(mat: TriCSR) -> ComputeDag:
    n = mat.n
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.diff(mat.rowptr) - 1, out=ptr[1:])
    off = np.ones(mat.nnz, dtype=bool)
    off[mat.rowptr[1:] - 1] = False  # the per-row trailing diagonal
    return ComputeDag(
        name=mat.name,
        n=n,
        ptr=ptr,
        src=mat.colidx[off],
        weight=mat.values[off],
        scale=1.0 / mat.diag(),
    )
