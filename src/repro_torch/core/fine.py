"""Fine-dataflow (DPU-v2-style) cycle model — the paper's main baseline.

DPU-v2 (paper §II-C / Fig. 3) converts the coarse DAG into a *binary* DAG:
row i with k off-diagonal inputs becomes k multiply leaves + a cascade of
accumulate nodes + one final update, i.e. 2k+1 binary nodes (Table III's
"binary nodes" column = 2*nnz - n).  The binary DAG is mapped onto
tree-shaped PE arrays; whenever a node's cascade exceeds the tree depth the
partial result is written back to the register files (costing the pipeline +
RF round-trip that Fig. 3 and the Fig. 6 example charge at ~2 cycles per
tree-block plus one).

Model (matching the paper's own Fig. 6 accounting, documented in
DESIGN.md §5):
  * the machine has ``num_pes`` PEs organised as ``num_trees`` trees of depth
    ``tree_depth`` (DPU-v2 default: 56 PEs, 8 trees of 7 PEs / depth 3);
  * each tree executes one *block* (a ≤(2^depth - 1)-op fragment of one
    coarse node's binary cascade) per ``block_ii`` cycles (initiation
    interval, 1 with perfect pipelining — we use 2 per the Fig. 6 example);
  * a block may only launch once its input blocks / source nodes completed
    ``rf_latency`` cycles earlier (register-file round trip);
  * DPU-v2 runs at 2x our clock with 1-op PEs vs our 2-op PEs (paper §V-A),
    so reported *effective* cycles at the common 150 MHz clock = cycles / 2.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .csr import TriCSR

__all__ = ["FineConfig", "FineStats", "schedule_fine"]


@dataclasses.dataclass(frozen=True)
class FineConfig:
    num_pes: int = 56
    tree_depth: int = 3
    block_ii: int = 2      # cycles per tree-block launch (Fig. 6: 9 blocks/19 cyc)
    rf_latency: int = 1    # extra cycles when a value crosses blocks via the RF
    clock_ratio: float = 2.0  # DPU-v2 clock vs ours (300 MHz vs 150 MHz)

    @property
    def num_trees(self) -> int:
        return max(1, self.num_pes // (2 ** self.tree_depth - 1))

    @property
    def block_ops(self) -> int:
        return 2 ** self.tree_depth - 1


@dataclasses.dataclass
class FineStats:
    name: str
    n: int
    nnz: int
    binary_nodes: int
    blocks: int
    raw_cycles: int           # at the 2x clock
    effective_cycles: float   # normalized to the common clock

    def throughput_gops(self, clock_mhz: float = 150.0) -> float:
        flops = 2 * self.nnz - self.n
        return flops * (clock_mhz * 1e6) / self.effective_cycles / 1e9


def schedule_fine(mat: TriCSR, cfg: FineConfig | None = None) -> FineStats:
    """List-schedule the binary DAG onto the tree machine; return cycle count.

    Blocks per coarse node i with k inputs: ceil(2k+1 ops / block_ops), in a
    sequential cascade (each block consumes the previous block's partial sum
    — Fig. 3: a 4-input node on a depth-2 tree needs 4 mappings).  Block b of
    node i is ready when block b-1 finished (+rf_latency) and the source
    values consumed by its leaves are available.
    """
    cfg = cfg or FineConfig()
    n = mat.n
    solve_t = np.zeros(n, dtype=np.int64)  # completion cycle of x_i
    # per-tree next-free cycle, as a heap for earliest-available tree
    trees = [0] * cfg.num_trees
    heapq.heapify(trees)
    total_blocks = 0
    # process nodes in topological (row) order; list scheduling with the
    # earliest-ready block first is approximated by row order + readiness.
    for i in range(n):
        cols, _ = mat.row(i)
        srcs = cols[:-1]
        k = len(srcs)
        n_ops = 2 * k + 1
        n_blocks = max(1, -(-n_ops // cfg.block_ops))
        # leaves per block: assign sources to blocks round-robin in order
        per_block = max(1, -(-k // n_blocks)) if k else 0
        prev_done = 0
        for blk in range(n_blocks):
            lo = blk * per_block
            hi = min(k, (blk + 1) * per_block)
            src_ready = int(solve_t[srcs[lo:hi]].max()) + cfg.rf_latency if hi > lo else 0
            chain_ready = prev_done + (cfg.rf_latency if blk else 0)
            tree_free = heapq.heappop(trees)
            start = max(src_ready, chain_ready, tree_free)
            done = start + cfg.block_ii
            heapq.heappush(trees, done)
            prev_done = done
            total_blocks += 1
        solve_t[i] = prev_done
    raw = int(solve_t.max())
    return FineStats(
        name=mat.name,
        n=n,
        nnz=mat.nnz,
        binary_nodes=mat.binary_nodes,
        blocks=total_blocks,
        raw_cycles=raw,
        effective_cycles=raw / cfg.clock_ratio,
    )
