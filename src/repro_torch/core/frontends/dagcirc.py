"""General SpTRSV-like DAG frontend: weighted-accumulate circuits.

DPU-v2 (the paper's fine-granularity comparison point) is evaluated on
general sparse DAG workloads, not just triangular matrices.  This
frontend opens the same door for our stack: a `DagCircuit` is a DAG whose
node ``i`` computes the affine combination

    x[i] = scale[i] * (u[i] + sum_k weight[k] * x[src[k]])

over its predecessors — the linear slice of DPU-v2's sum-product
workloads (sparse neural accumulation layers, probabilistic-circuit
marginals with fixed evidence, signal-flow graphs).  Leaves (no sources,
scale 1) pass their input through.  The lowering to the compiler IR is a
sign flip: the executor contract is ``x[i] = (b[i] - Σ w·x) * scale``, so
circuit weights negate and the circuit input vector ``u`` rides in as b.

`eval` is the numpy oracle the property tests round-trip against;
`random_circuit` generates well-conditioned instances (per-node ``Σ|w|``
bounded < 1, |scale| ≤ 1) so f32 executor parity stays tight.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..compiler.ir import ComputeDag

__all__ = ["DagCircuit", "lower_circuit", "random_circuit"]


@dataclasses.dataclass(frozen=True)
class DagCircuit:
    """A weighted-accumulate DAG circuit in topological node order."""

    name: str
    n: int
    ptr: np.ndarray     # int64 [n+1]
    src: np.ndarray     # int64 [E] — predecessors, ascending per node
    weight: np.ndarray  # float64 [E]
    scale: np.ndarray   # float64 [n]

    @property
    def n_edges(self) -> int:
        return int(self.ptr[-1])

    def eval(self, u: np.ndarray) -> np.ndarray:
        """Numpy oracle: evaluate the circuit on input ``u`` ([n] or [n, B])."""
        u = np.asarray(u, dtype=np.float64)
        x = np.zeros_like(u)
        for i in range(self.n):
            lo, hi = int(self.ptr[i]), int(self.ptr[i + 1])
            acc = u[i]
            if hi > lo:
                w = self.weight[lo:hi]
                xs = x[self.src[lo:hi]]
                acc = acc + (w @ xs if u.ndim > 1 else np.dot(w, xs))
            x[i] = self.scale[i] * acc
        return x


def lower_circuit(circ: DagCircuit) -> ComputeDag:
    """Lower a circuit to the compiler IR (pure sign flip on the weights)."""
    return ComputeDag(name=circ.name, n=circ.n, ptr=circ.ptr, src=circ.src,
                      weight=-circ.weight, scale=circ.scale)


def random_circuit(
    n: int,
    *,
    max_fan_in: int = 6,
    leaf_frac: float = 0.2,
    locality: int | None = None,
    seed: int = 0,
    name: str | None = None,
) -> DagCircuit:
    """Generate a well-conditioned random circuit in topological order.

    ``leaf_frac`` of the nodes (always including node 0) are leaves;
    internal nodes draw 1..``max_fan_in`` predecessors, biased toward
    recent nodes when ``locality`` is set (window of candidate sources).
    Per-node ``Σ|w|`` is normalized below 0.9 and ``|scale| ≤ 1`` so
    values stay O(|u|) at any depth — keeps the f32 executors within
    1e-5 of the f64 oracle.
    """
    rng = np.random.default_rng(seed)
    ptr = np.zeros(n + 1, dtype=np.int64)
    srcs: list[np.ndarray] = []
    weights: list[np.ndarray] = []
    for i in range(n):
        if i == 0 or rng.random() < leaf_frac:
            srcs.append(np.empty(0, dtype=np.int64))
            weights.append(np.empty(0, dtype=np.float64))
        else:
            k = int(rng.integers(1, max_fan_in + 1))
            lo = max(0, i - locality) if locality else 0
            cand = np.arange(lo, i)
            k = min(k, len(cand))
            pick = np.sort(rng.choice(cand, size=k, replace=False))
            w = rng.uniform(-1.0, 1.0, size=k)
            norm = np.abs(w).sum()
            if norm > 0.9:
                w *= 0.9 / norm
            srcs.append(pick.astype(np.int64))
            weights.append(w)
        ptr[i + 1] = ptr[i] + len(srcs[-1])
    scale = rng.uniform(0.5, 1.0, size=n) * rng.choice([-1.0, 1.0], size=n)
    return DagCircuit(
        name=name or f"circ_n{n}_s{seed}",
        n=n,
        ptr=ptr,
        src=np.concatenate(srcs) if srcs else np.empty(0, np.int64),
        weight=np.concatenate(weights) if weights else np.empty(0, np.float64),
        scale=scale,
    )
