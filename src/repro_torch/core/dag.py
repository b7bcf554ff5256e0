"""DAG view + the paper's structural statistics, for any workload.

Historically this module analyzed sparse triangular systems only (nodes =
matrix rows, edges = off-diagonal non-zeros).  With the staged compiler's
generic frontend boundary (DESIGN.md §6) every function here accepts
either a `TriCSR` *or* a `compiler.ComputeDag` — the workloads of the
upper/transpose/circuit frontends get the same Table III treatment as the
paper's matrices.  Node ids are a topological order in both cases.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .csr import TriCSR

__all__ = ["DagInfo", "analyze", "compute_levels", "edge_view", "out_adjacency"]


def edge_view(g) -> tuple[int, np.ndarray, np.ndarray]:
    """Normalize a workload to ``(n, ptr, src)`` edge arrays.

    Accepts a `TriCSR` (off-diagonal non-zeros are the edges) or anything
    already shaped like a `compiler.ComputeDag` (``n`` / ``ptr`` / ``src``
    attributes, e.g. a `frontends.dagcirc.DagCircuit`).
    """
    if isinstance(g, TriCSR):
        from .frontends.sptrsv import lower_tri  # lazy: avoids import cycle

        d = lower_tri(g)  # single home for the diag-last CSR convention
        return d.n, d.ptr, d.src
    return g.n, g.ptr, g.src


def out_adjacency(g) -> tuple[np.ndarray, np.ndarray]:
    """CSC-style adjacency: for each node j, the consumers i with edge j -> i.

    Returns (outptr [n+1], outidx [n_edges]) sorted by consumer id.
    """
    n, ptr, srcs = edge_view(g)
    dsts = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    order = np.lexsort((dsts, srcs))
    outptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(srcs, minlength=n), out=outptr[1:])
    return outptr, dsts[order]


@dataclasses.dataclass(frozen=True)
class DagInfo:
    """Table III statistics for one benchmark DAG."""

    name: str
    n: int
    nnz: int
    binary_nodes: int
    levels: np.ndarray            # level (longest-path depth) per node
    n_levels: int
    level_width: np.ndarray       # nodes per level
    cdu_threshold: int
    cdu_node_ratio: float         # % of nodes that are CDU
    cdu_edge_ratio: float         # % of input edges landing on CDU nodes
    cdu_level_ratio: float        # % of levels that contain CDU nodes
    cdu_edges_per_node: float     # average in-degree of CDU nodes
    max_in_degree: int

    def row(self) -> dict:
        return {
            "name": self.name,
            "n": self.n,
            "nnz": self.nnz,
            "binary_nodes": self.binary_nodes,
            "levels": self.n_levels,
            "cdu_nodes_pct": round(self.cdu_node_ratio * 100, 1),
            "cdu_edges_pct": round(self.cdu_edge_ratio * 100, 1),
            "cdu_levels_pct": round(self.cdu_level_ratio * 100, 1),
            "cdu_edges_per_node": round(self.cdu_edges_per_node, 1),
            "max_in_degree": self.max_in_degree,
        }


def _levels(n: int, ptr: np.ndarray, src: np.ndarray) -> np.ndarray:
    level = np.zeros(n, dtype=np.int64)
    for i in range(n):
        off = src[ptr[i] : ptr[i + 1]]
        if len(off):
            level[i] = int(level[off].max()) + 1
    return level


def compute_levels(g) -> np.ndarray:
    """Longest-path level per node (level-scheduling / Fig. 1c)."""
    return _levels(*edge_view(g))


def analyze(g, num_cus: int = 64, cdu_fraction: float = 0.2) -> DagInfo:
    """CDU statistics exactly as defined in the paper (§II-C, Table III).

    A CDU node sits in a level whose width is below ``cdu_fraction *
    num_cus`` (the paper sets the threshold at 20% of max parallelism).
    """
    n, ptr, src = edge_view(g)
    level = _levels(n, ptr, src)
    n_levels = int(level.max()) + 1
    width = np.bincount(level, minlength=n_levels)
    threshold = max(1, int(round(cdu_fraction * num_cus)))
    cdu_level = width < threshold
    is_cdu = cdu_level[level]
    indeg = np.diff(ptr)
    n_edges = int(indeg.sum())
    nnz = n_edges + n  # one final op per node (== matrix nnz for SpTRSV)
    total_edges = max(1, n_edges)
    cdu_nodes = int(is_cdu.sum())
    cdu_edges = int(indeg[is_cdu].sum())
    return DagInfo(
        name=g.name,
        n=n,
        nnz=nnz,
        binary_nodes=2 * nnz - n,
        levels=level,
        n_levels=n_levels,
        level_width=width,
        cdu_threshold=threshold,
        cdu_node_ratio=cdu_nodes / n,
        cdu_edge_ratio=cdu_edges / total_edges,
        cdu_level_ratio=float(cdu_level.sum()) / n_levels,
        cdu_edges_per_node=(cdu_edges / cdu_nodes) if cdu_nodes else 0.0,
        max_in_degree=int(indeg.max()) if n else 0,
    )
