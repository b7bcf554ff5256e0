"""Builder ``tri_csr``: a sparse lower-triangular system from a generator.

The benchmark makes the matrix itself (`perfbench.matrices`, pattern from
the configuration, values from ``--seed``), hands the arrays to the port
through ``repro_torch.core.csr.from_coo`` and keeps the same arrays for the
reference.  Compiling is left to the loop: a solve loop compiles through
``api.compile``, a service compiles in its own program cache.
"""

from __future__ import annotations

import dataclasses
import time

from perfbench import matrices


@dataclasses.dataclass(eq=False)
class TriSystem:
    cfg: dict
    n: int
    nnz: int          # stored entries, the diagonal included
    mat: object       # the port's TriCSR
    ref: tuple        # (rowptr, cols, vals, diag) for the reference
    compile_s: float | None = None
    program_cycles: int | None = None

    @property
    def solver_opts(self) -> dict:
        return {"placement": self.cfg["solver"]["placement"]}

    @property
    def schedule(self) -> str:
        return self.cfg["solver"]["schedule"]

    def compile(self):
        """``api.compile`` of the port's matrix; records the compile's own
        seconds and the program's emitted cycles."""
        from repro_torch.core import api

        t0 = time.perf_counter()
        prog = api.compile(self.mat, schedule=self.schedule)
        self.note_program(prog, time.perf_counter() - t0)
        return prog

    def note_program(self, prog, span_s: float | None = None) -> None:
        st = prog.stats
        self.compile_s = float(st.compile_seconds or span_s or 0.0)
        self.program_cycles = int(st.emitted_cycles)


def build(cfg: dict, seed: int) -> TriSystem:
    from repro_torch.core.csr import from_coo

    n, rows, cols = matrices.pattern(cfg)
    vals, diag = matrices.values(n, len(rows), seed, **cfg["values"])
    mat = from_coo(n, rows, cols, vals, diag, name=cfg["name"])
    rowptr, _, _ = matrices.to_csr(n, rows, cols, vals)
    return TriSystem(cfg=cfg, n=n, nnz=len(rows) + n, mat=mat,
                     ref=(rowptr, cols, vals, diag))
