"""Oracles for the SpTRSV kernels.

Two oracles:
  * `solve_dense` — dense lower-triangular forward substitution in torch
    float64 (mathematical ground truth, independent of the compiler);
  * `solve_program` — the torch executor over the instruction stream
    (checks the kernels against the exact program semantics).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.csr import TriCSR
from repro_torch.core.executor import execute_torch
from repro_torch.core.program import Program

__all__ = ["solve_dense", "solve_program"]


def solve_dense(mat: TriCSR, b: np.ndarray) -> np.ndarray:
    """Dense forward substitution in float64 on the CPU (O(n^2), oracle only)."""
    dense = torch.from_numpy(mat.to_dense()).to(torch.float64)
    b = torch.as_tensor(np.asarray(b), dtype=torch.float64)
    x = torch.zeros(mat.n, dtype=torch.float64)
    for i in range(mat.n):
        s = torch.dot(dense[i, :i], x[:i])
        x[i] = (b[i] - s) / dense[i, i]
    return x.numpy()


def solve_program(prog: Program, b: np.ndarray, *, device=None) -> np.ndarray:
    return execute_torch(prog, b, device=device)
