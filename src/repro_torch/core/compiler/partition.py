"""Partition pass: frontend `ComputeDag` → medium-granularity `PartitionIR`.

The paper's medium-granularity dataflow (§IV-A) fixes the partitioning of
work: each DAG node is the minimal *allocation* unit (all its input edges
run on one CU, accumulating into that CU's psum feedback) and each edge is
the minimal *scheduling* unit (edges of one node may execute in any order,
interleaved with other nodes via the psum cache).  This pass materializes
that view: it enforces the frontend contract (`ComputeDag.validate`) and
builds the consumer adjacency + in-degrees the scheduler wakes nodes with.
"""

from __future__ import annotations

from .ir import ComputeDag, PartitionIR

__all__ = ["run"]


def run(dag: ComputeDag) -> PartitionIR:
    dag.validate()
    n = dag.n
    consumers: list[list[int]] = [[] for _ in range(n)]
    ptr, src = dag.ptr, dag.src
    for i in range(n):
        for j in src[ptr[i] : ptr[i + 1]]:
            consumers[j].append(i)
    in_degree = dag.in_degree()
    metrics = {
        "nodes": n,
        "edges": dag.n_edges,
        "max_in_degree": int(in_degree.max()) if n else 0,
        "source_nodes": int((in_degree == 0).sum()),
    }
    return PartitionIR(dag=dag, consumers=consumers, in_degree=in_degree,
                       metrics=metrics)
