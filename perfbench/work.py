"""The yardstick: the work a solve needs, counted from the CSR matrix and
the number of right-hand-side columns alone, and the chip's peaks.

Nothing here reads the compiled `Program`: a change that packs the
instruction stream tighter moves the kernel, not the yardstick.

For ``L x = B`` with ``n`` rows, ``nnz`` stored entries (the diagonal
included) and ``k`` columns solved in one launch:

* FLOPs: each off-diagonal entry is a multiply and an add, each row one
  division: ``k * (2 * (nnz - n) + n)``.
* Bytes, each input read once and each output written once: the matrix
  (``nnz`` values and column indices of 4 bytes each, ``n + 1`` row
  pointers of 4 bytes) once per launch, and ``b`` read and ``x`` written
  in float32 per column: ``nnz * 8 + (n + 1) * 4 + k * 2 * n * 4``.

The least time is the larger of FLOPs over the float32 peak and bytes
over the memory bandwidth.  Peaks: NVIDIA H100 SXM data sheet, dense, at
the card's full 700 W; the run prints the card's power limit beside them.
"""

from __future__ import annotations

__all__ = ["PEAK_F32_FLOPS", "PEAK_HBM_BYTES", "flops", "bytes_moved",
           "roofline_s"]

PEAK_F32_FLOPS = 67e12   # FLOP/s, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # B/s, HBM3


def flops(n: int, nnz: int, columns: int = 1) -> int:
    return columns * (2 * (nnz - n) + n)


def bytes_moved(n: int, nnz: int, columns: int = 1) -> int:
    return nnz * 8 + (n + 1) * 4 + columns * 2 * n * 4


def roofline_s(n: int, nnz: int, columns: int = 1) -> float:
    """The least time one launch solving ``columns`` columns can take."""
    return max(flops(n, nnz, columns) / PEAK_F32_FLOPS,
               bytes_moved(n, nnz, columns) / PEAK_HBM_BYTES)
