"""Workload frontends: lower concrete problems onto the compiler IR.

Every frontend produces a `compiler.ComputeDag` (plus, where the node
numbering differs from the user's, an index permutation) and the staged
pipeline (`core/compiler/`) does the rest — the emitted `Program` format
is unchanged, so all executors, batching, sharding and the packed
encoding serve every workload here for free.

  * `sptrsv`  — the classic lower-triangular solve Lx=b (paper workload);
  * `upper`   — upper-triangular solve Ux=b and the transpose solve
    Lᵀx=b via CSC-row reversal (the backward sweep of an incomplete-
    Cholesky preconditioner application);
  * `dagcirc` — general SpTRSV-like DAGs: DPU-v2-style weighted-
    accumulate circuits with a numpy oracle.
"""

from . import dagcirc, sptrsv, upper  # noqa: F401
from .sptrsv import lower_tri  # noqa: F401
from .upper import lower_transpose, lower_upper  # noqa: F401
from .dagcirc import DagCircuit, lower_circuit, random_circuit  # noqa: F401
