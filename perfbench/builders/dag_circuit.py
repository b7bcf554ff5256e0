"""Builder ``dag_circuit``: the DAG of a sparse lower-triangular solve.

Node i of the DAG computes ``x[i] = scale[i] * (u[i] + sum_k w[k] *
x[src[k]])`` over its predecessors, in topological order.  The benchmark
makes the matrix L as the ``tri_csr`` builder does (`perfbench.matrices`,
pattern from the configuration, values from ``--seed``) and hands its solve
to the port as a ``DagCircuit``: ``src`` L's columns, ``w = -L[i, src]``,
``scale = 1 / L[i, i]``.  The reference keeps L's arrays, so that
`perfbench.reference.solve` sweeps the same DAG.  The loop compiles
through ``api.compile_circuit``.
"""

from __future__ import annotations

import dataclasses
import time

from perfbench import matrices
from perfbench.builders.tri_csr import TriSystem


@dataclasses.dataclass(eq=False)
class DagSystem(TriSystem):
    """A `TriSystem` whose ``mat`` is the port's ``DagCircuit``."""

    def compile(self):
        """``api.compile_circuit`` of the port's circuit; records the
        compile's own seconds and the program's emitted cycles."""
        from repro_torch.core import api

        t0 = time.perf_counter()
        prog = api.compile_circuit(self.mat, schedule=self.schedule).program
        self.note_program(prog, time.perf_counter() - t0)
        return prog


def build(cfg: dict, seed: int) -> DagSystem:
    from repro_torch.core.frontends import DagCircuit

    n, rows, cols = matrices.pattern(cfg)
    vals, diag = matrices.values(n, len(rows), seed, **cfg["values"])
    rowptr, _, _ = matrices.to_csr(n, rows, cols, vals)
    circ = DagCircuit(name=cfg["name"], n=n, ptr=rowptr, src=cols,
                      weight=-vals, scale=1.0 / diag)
    return DagSystem(cfg=cfg, n=n, nnz=len(rows) + n, mat=circ,
                     ref=(rowptr, cols, vals, diag))
