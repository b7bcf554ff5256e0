"""Hopper kernels executing a compiled SpTRSV VLIW stream, and their plain twins.

Ports `repro/kernels/sptrsv/kernel.py`.  Two kernels, written by hand in
CUDA C++ for ``sm_90a`` (`csrc/sptrsv.cu`, whose head note gives the
design), each beside a plain PyTorch version of the same algorithm:

  * `sptrsv_cuda` replaces ``sptrsv_pallas``: the whole padded x vector per
    CTA, in shared memory where it fits, else in device memory.
    Plain version: `sptrsv_plain`.
  * `sptrsv_cuda_blocked` replaces ``sptrsv_pallas_blocked``: a ring of
    ``window`` x rows in shared memory that advances ``stride`` rows per
    cycle block, with retired rows flushed to device memory.
    Plain version: `sptrsv_blocked_plain` (the same window sweep).

What bounds them on an H100: the cycle-serial dependency chain, one CTA
barrier per emitted cycle; the bytes and flops of a solve are far below it
(see the source note).

Both kernels keep b off the chain by seeding x with b: a FINAL lane reads
b[src] from its own, not yet final, row.  The plain versions do the same,
so kernel and twin round identically.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  Each wrapper counts its kernel
launches in ``<wrapper>.launches``.  The CUDA library is built on first use
(`build`, through `common.build_library`) with ``nvcc`` into ``build/`` at
the repository root and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.program import (
    OP_EDGE,
    OP_FINAL,
    PS_LOAD,
    PS_RESET,
    PS_STORE_RESET,
    PS_SWAP,
    decode_instructions,
)
from repro_torch.kernels.common import build_library

__all__ = [
    "build",
    "sptrsv_cuda",
    "sptrsv_cuda_blocked",
    "sptrsv_plain",
    "sptrsv_blocked_plain",
    "MAX_THREADS_PER_CTA",
    "PREFETCH_CYCLES",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "sptrsv.cu"
MAX_THREADS_PER_CTA = 256  # P * cols_per_cta; csrc/sptrsv.cu MAX_THREADS
PREFETCH_CYCLES = 16       # csrc/sptrsv.cu GROUP
MAX_SLOTS = 256            # the packed word's 8-bit slot field

_LIB: ctypes.CDLL | None = None
_P, _I = ctypes.c_void_p, ctypes.c_int


def build() -> ctypes.CDLL:
    """Build (once per source version, `common.build_library`) and load the
    kernels' library; `common.BUILD_LOGS` keeps the compiler's output."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library("sptrsv", SOURCE)))
    lib.sptrsv_error_string.argtypes = [_I]
    lib.sptrsv_error_string.restype = ctypes.c_char_p
    lib.sptrsv_resident.argtypes = [_P] * 4 + [_I] * 8 + [_P]
    lib.sptrsv_resident.restype = _I
    lib.sptrsv_blocked.argtypes = [_P] * 4 + [_I] * 9 + [_P]
    lib.sptrsv_blocked.restype = _I
    _LIB = lib
    return lib


# ---------------------------------------------------------------------------
# input checks shared by both wrappers
# ---------------------------------------------------------------------------
def _check_inputs(instr, values, b, num_slots: int) -> None:
    if instr.dtype != torch.int32 or instr.dim() != 3 or instr.shape[1] not in (1, 2):
        raise ValueError(f"instr must be int32 [T, planes in (1, 2), P], got "
                         f"{instr.dtype} {tuple(instr.shape)}")
    t, _, p = instr.shape
    if values.dtype != torch.float32 or tuple(values.shape) != (t, p):
        raise ValueError(f"values must be float32 {(t, p)}, got "
                         f"{values.dtype} {tuple(values.shape)}")
    if b.dtype != torch.float32 or b.dim() != 2:
        raise ValueError(f"b must be float32 [rows, B], got {b.dtype} "
                         f"{tuple(b.shape)}")
    if not all(a.is_contiguous() for a in (instr, values, b)):
        raise ValueError("instr, values and b must be contiguous")
    if not instr.device == values.device == b.device:
        raise ValueError(f"instr, values and b must share a device, got "
                         f"{instr.device}, {values.device}, {b.device}")
    if not 1 <= num_slots <= MAX_SLOTS:
        raise ValueError(f"num_slots must be in [1, {MAX_SLOTS}], got {num_slots}")


def _check_cuda(instr, b, cols_per_cta: int) -> None:
    if b.device.type != "cuda":
        raise ValueError(f"the SpTRSV kernels run on CUDA or CPU tensors, "
                         f"got {b.device}")
    p, nb = instr.shape[2], b.shape[1]
    if cols_per_cta < 1 or nb % cols_per_cta:
        raise ValueError(f"cols_per_cta={cols_per_cta} must divide the "
                         f"{nb} RHS columns")
    if p * cols_per_cta > MAX_THREADS_PER_CTA:
        raise ValueError(f"{p} lanes x {cols_per_cta} columns exceeds "
                         f"{MAX_THREADS_PER_CTA} threads per CTA")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.sptrsv_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def _decode(instr):
    """Whole-stream decode into long ``[T, P]`` (op, src, ctl, slot)."""
    return [f.long() for f in decode_instructions(instr, instr.shape[1])]


def _exec_cycle(op, idx, ct, sl, v, xw, fb, rf, lanes, dummy):
    """One cycle over all lanes and columns; returns the new feedback.

    ``xw`` holds x rows where final and b rows where not yet final;
    ``idx`` is each lane's row of ``xw``, ``dummy`` a spare row of ``xw``
    that absorbs the scatter of non-FINAL lanes unchanged.  ``rf`` and
    ``xw`` are updated in place.
    """
    ct = ct[:, None]
    v = v[:, None]
    slot_val = rf[lanes, sl]
    pv = torch.where(ct == PS_RESET, 0.0, fb)
    pv = torch.where(ct == PS_LOAD, slot_val, pv)
    store = (ct == PS_STORE_RESET) | (ct == PS_SWAP)
    rf[lanes, sl] = torch.where(store, fb, slot_val)
    pv = torch.where(ct == PS_STORE_RESET, 0.0, pv)
    pv = torch.where(ct == PS_SWAP, slot_val, pv)
    xs = xw[idx]
    pv = torch.where((op == OP_EDGE)[:, None], pv + v * xs, pv)
    fin = op == OP_FINAL
    widx = torch.where(fin, idx, dummy)
    xw[widx] = torch.where(fin[:, None], (xs - pv) * v, xw[dummy])
    return pv


def sptrsv_plain(instr, values, b, *, num_slots: int):
    """Plain PyTorch version of `sptrsv_cuda` (any device).

    ``b`` is ``[n + 1, B]``; its last row is the padding row the scatter of
    non-FINAL lanes lands on.  Returns ``x`` of the same shape.
    """
    _check_inputs(instr, values, b, num_slots)
    p = instr.shape[2]
    op, src, ct, sl = _decode(instr)
    x = b.clone()
    fb = b.new_zeros(p, b.shape[1])
    rf = b.new_zeros(p, num_slots, b.shape[1])
    lanes = torch.arange(p, device=b.device)
    dummy = b.shape[0] - 1
    for t in range(instr.shape[0]):
        fb = _exec_cycle(op[t], src[t], ct[t], sl[t], values[t], x, fb, rf,
                         lanes, dummy)
    return x


def sptrsv_blocked_plain(instr, values, b, *, window: int, stride: int,
                         cycles_per_block: int, num_slots: int):
    """Plain PyTorch version of `sptrsv_cuda_blocked` (any device).

    The same window sweep: row r lives in ring slot ``r % window``; at each
    block boundary the ``stride`` oldest rows retire to ``x`` and their
    slots take b of the rows entering the window.
    """
    _check_inputs(instr, values, b, num_slots)
    _check_sweep(instr, b, window, stride, cycles_per_block)
    t_pad, _, p = instr.shape
    op, src, ct, sl = _decode(instr)
    slot = src % window
    x = torch.empty_like(b)
    ring = b.new_zeros(window + 1, b.shape[1])  # row `window`: the dummy
    ring[:window] = b[:window]
    fb = b.new_zeros(p, b.shape[1])
    rf = b.new_zeros(p, num_slots, b.shape[1])
    lanes = torch.arange(p, device=b.device)
    for g in range(t_pad // cycles_per_block):
        if g > 0:
            rows = torch.arange((g - 1) * stride, g * stride, device=b.device)
            x[rows] = ring[rows % window]
            ring[rows % window] = b[rows + window]
        for t in range(g * cycles_per_block, (g + 1) * cycles_per_block):
            fb = _exec_cycle(op[t], slot[t], ct[t], sl[t], values[t], ring, fb,
                             rf, lanes, window)
    last = (t_pad // cycles_per_block - 1) * stride
    rows = torch.arange(last, last + window, device=b.device)
    x[rows] = ring[rows % window]
    return x


def _check_sweep(instr, b, window, stride, cycles_per_block) -> None:
    t_pad = instr.shape[0]
    if cycles_per_block < 1 or t_pad % cycles_per_block:
        raise ValueError(f"{t_pad} cycles are not a multiple of "
                         f"cycles_per_block={cycles_per_block}")
    if stride < 1 or window < 2 * stride:
        raise ValueError(f"need stride >= 1 and window >= 2*stride, got "
                         f"window={window}, stride={stride}")
    n_hbm = (t_pad // cycles_per_block - 1) * stride + window
    if b.shape[0] != n_hbm:
        raise ValueError(f"b rows {b.shape[0]} != window sweep {n_hbm}")


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def sptrsv_cuda(instr, values, b, *, num_slots: int, x_in_smem: bool = True,
                cols_per_cta: int = 1):
    """Resident solve: ``b[n + 1, B] -> x[n + 1, B]`` (replaces ``sptrsv_pallas``).

    ``x_in_smem`` keeps each CTA's x columns in shared memory (the caller
    checks that ``(n + 1) * cols_per_cta`` rows plus the psum register
    file fit, see `ops.state_bytes`); otherwise x stays in device memory.
    CPU tensors go to `sptrsv_plain`.
    """
    _check_inputs(instr, values, b, num_slots)
    if b.device.type == "cpu":
        return sptrsv_plain(instr, values, b, num_slots=num_slots)
    _check_cuda(instr, b, cols_per_cta)
    lib = build()
    t, planes, p = instr.shape
    x = torch.empty_like(b)
    with torch.cuda.device(b.device):
        rc = lib.sptrsv_resident(
            instr.data_ptr(), values.data_ptr(), b.data_ptr(), x.data_ptr(),
            t, planes, p, b.shape[0], b.shape[1], num_slots, cols_per_cta,
            int(bool(x_in_smem)), _stream())
    _raise_on(lib, rc, "sptrsv_resident")
    sptrsv_cuda.launches += 1
    return x


def sptrsv_cuda_blocked(instr, values, b, *, window: int, stride: int,
                        cycles_per_block: int, num_slots: int,
                        cols_per_cta: int = 1):
    """Row-blocked solve: ``b[n_hbm, B] -> x[n_hbm, B]`` (replaces
    ``sptrsv_pallas_blocked``).

    ``n_hbm = (T / cycles_per_block - 1) * stride + window``; the caller
    has checked that cycle block g touches only rows ``[g*stride,
    g*stride + window)`` (`ops.plan_window`).  CPU tensors go to
    `sptrsv_blocked_plain`.
    """
    _check_inputs(instr, values, b, num_slots)
    _check_sweep(instr, b, window, stride, cycles_per_block)
    if b.device.type == "cpu":
        return sptrsv_blocked_plain(instr, values, b, window=window,
                                    stride=stride,
                                    cycles_per_block=cycles_per_block,
                                    num_slots=num_slots)
    _check_cuda(instr, b, cols_per_cta)
    lib = build()
    t, planes, p = instr.shape
    x = torch.empty_like(b)
    with torch.cuda.device(b.device):
        rc = lib.sptrsv_blocked(
            instr.data_ptr(), values.data_ptr(), b.data_ptr(), x.data_ptr(),
            t, planes, p, b.shape[1], num_slots, cols_per_cta, window, stride,
            cycles_per_block, _stream())
    _raise_on(lib, rc, "sptrsv_blocked")
    sptrsv_cuda_blocked.launches += 1
    return x


sptrsv_cuda.launches = 0
sptrsv_cuda_blocked.launches = 0
