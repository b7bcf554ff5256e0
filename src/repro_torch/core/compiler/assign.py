"""CU-assign pass: `PartitionIR` → `AssignIR` (node → CU allocation).

Nodes are handed to CUs in topological order (== node-id order): the
``least_edges`` policy gives each next node to the CU with the least
accumulated work (edges + finalize), the ``roundrobin`` policy stripes
ids.  This is the paper's coarse-node allocation step, generalized from
matrix rows to generic DAG nodes.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..program import AccelConfig
from .ir import AssignIR, PartitionIR

__all__ = ["allocate", "run"]


def allocate(n: int, in_degree: np.ndarray, cfg: AccelConfig) -> list[list[int]]:
    """Allocate nodes ``0..n-1`` to ``cfg.num_cus`` CUs; returns task lists."""
    p = cfg.num_cus
    tasks: list[list[int]] = [[] for _ in range(p)]
    if cfg.alloc == "roundrobin":
        for i in range(n):
            tasks[i % p].append(i)
        return tasks
    if cfg.alloc != "least_edges":
        raise ValueError(f"unknown alloc policy {cfg.alloc!r}")
    heap = [(0, c) for c in range(p)]  # (load, cu) — least accumulated work
    heapq.heapify(heap)
    for i in range(n):
        w, c = heapq.heappop(heap)
        tasks[c].append(i)
        heapq.heappush(heap, (w + int(in_degree[i]) + 1, c))
    return tasks


def run(part: PartitionIR, cfg: AccelConfig) -> AssignIR:
    n = part.dag.n
    task_lists = allocate(n, part.in_degree, cfg)
    owner = np.empty(n, dtype=np.int64)
    for c, ts in enumerate(task_lists):
        for nid in ts:
            owner[nid] = c
    # planned per-CU load (edges + finalizes) — the allocation objective
    load = np.array([int(part.in_degree[ts].sum()) + len(ts)
                     for ts in task_lists], dtype=np.float64)
    cv = float(100.0 * load.std() / max(load.mean(), 1e-12))
    metrics = {"alloc": cfg.alloc, "num_cus": cfg.num_cus,
               "planned_load_cv_pct": round(cv, 2)}
    return AssignIR(part=part, owner=owner, task_lists=task_lists,
                    metrics=metrics)
