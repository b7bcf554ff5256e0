"""Hopper kernel for online-softmax attention, and its plain twin.

Ports `repro/kernels/flash_attention/kernel.py`.  `flash_attention_cuda`
replaces ``flash_attention_pallas``; it is written by hand in CUDA C++ for
``sm_90a`` (`csrc/flash_attention.cu`, whose head note gives the design and
what bounds it).  It chooses its own tiles (64 query rows per CTA, 64 key
rows per step) in place of the TPU kernel's VMEM block sizes.  bf16 inputs
run FlashAttention-2 on the tensor cores (``mma.sync``, f32 accumulation);
f32 inputs run the products in f32 on the CUDA cores, so they keep f32
accuracy.  `check_kernel_limits` states the shapes each kernel takes.
`flash_attention_plain` is its plain twin: the same online softmax over kv
tiles of `BLOCK_K` rows (`ref.attention_blocked`).

A wrapper runs the plain twin only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.  ``flash_attention_cuda.launches`` counts
the launches.  The CUDA library is built on first use (`build`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.common import build_library

from .ref import attention_blocked

__all__ = ["build", "check_kernel_limits", "flash_attention_cuda",
           "flash_attention_plain", "BLOCK_K", "MAX_D", "P_VARIANT"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BLOCK_K = 64   # csrc/flash_attention.cu BK
MAX_D = 128    # csrc/flash_attention.cu MAX_D (f32) and the largest bf16 instance
MMA_D_STEP = 16  # bf16: D is a whole number of m16n8k16 k-steps
BLOCK_Q = 64   # csrc/flash_attention.cu BQ
# csrc/flash_attention.cu: the bf16 kernel rounds P to bf16 for the PV product
# (f32 accumulation), as scaled_dot_product_attention does
P_VARIANT = "bf16"
MAX_GRID_Y = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB: ctypes.CDLL | None = None
_P, _I = ctypes.c_void_p, ctypes.c_int


def build() -> ctypes.CDLL:
    """Build (once per source version, `common.build_library`) and load the
    kernel's library; `common.BUILD_LOGS` keeps the compiler's output."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library("flash_attention", SOURCE)))
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention.argtypes = [_P] * 4 + [_I] * 4 + [ctypes.c_float] + [_I] * 2 + [_P]
    lib.flash_attention.restype = _I
    _LIB = lib
    return lib


def _check(q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 3 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be [BH, Lq, D], k and v [BH, Lk, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in "
                         f"BH or D")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share one of {list(_DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v must share a device, got {q.device}, "
                         f"{k.device}, {v.device}")


def check_kernel_limits(bh: int, lq: int, lk: int, d: int, dtype) -> None:
    """Raise ``ValueError`` for a shape or type the CUDA kernels cannot take.

    Pure (no device, no library): the CUDA branch of `flash_attention_cuda`
    calls it before it launches, so such a shape raises and never reaches
    the plain twin.  f32: ``D <= MAX_D``, ``BH <= 65535`` (grid y).  bf16:
    ``D`` a multiple of `MMA_D_STEP` up to `MAX_D` (one compiled instance per
    width), at most 65535 query tiles of `BLOCK_Q` rows (grid y).
    """
    if dtype not in _DTYPES:
        raise ValueError(f"the kernels take {list(_DTYPES)}, got {dtype}")
    if bh < 1 or lq < 1 or lk < 0:
        raise ValueError(f"the kernels take BH >= 1, Lq >= 1, got BH={bh}, Lq={lq}, Lk={lk}")
    if dtype == torch.bfloat16:
        if d % MMA_D_STEP or not MMA_D_STEP <= d <= MAX_D:
            raise ValueError(f"the bf16 kernel takes D a multiple of {MMA_D_STEP} up to "
                             f"{MAX_D}, got D={d}")
        if -(-lq // BLOCK_Q) > MAX_GRID_Y or bh > 2**31 - 1:
            raise ValueError(f"the bf16 kernel takes Lq <= {BLOCK_Q * MAX_GRID_Y} and "
                             f"BH < 2**31, got Lq={lq}, BH={bh}")
    elif not 1 <= d <= MAX_D or bh > MAX_GRID_Y:
        raise ValueError(f"the f32 kernel takes D <= {MAX_D} and BH <= {MAX_GRID_Y}, "
                         f"got D={d}, BH={bh}")


def flash_attention_plain(q, k, v, *, scale: float, causal: bool = True):
    """Plain PyTorch twin of `flash_attention_cuda` (any device).

    q: ``[BH, Lq, D]``; k, v: ``[BH, Lk, D]``; returns ``[BH, Lq, D]`` in
    q's dtype.  Causal keeps key columns ``c <= row`` (no offset for
    Lq != Lk, the reference's convention).
    """
    _check(q, k, v)
    return attention_blocked(q, k, v, scale=scale, causal=causal, block_k=BLOCK_K)


def flash_attention_cuda(q, k, v, *, scale: float, causal: bool = True):
    """Attention (replaces ``flash_attention_pallas``); arguments as
    `flash_attention_plain`.  CPU tensors go to `flash_attention_plain`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on CUDA or CPU tensors, got {q.device}")
    bh, lq, d = q.shape
    check_kernel_limits(bh, lq, k.shape[1], d, q.dtype)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lib = build()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                 bh, lq, k.shape[1], d, float(scale), int(bool(causal)),
                                 _DTYPES[q.dtype],
                                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc} ({msg})")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
