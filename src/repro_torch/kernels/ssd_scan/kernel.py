"""Hopper kernel for the chunked gated linear recurrence, and its plain twin.

Ports `repro/kernels/ssd_scan/kernel.py`.  `chunked_scan_cuda` replaces
``chunked_scan_pallas``; it is written by hand in CUDA C++ for ``sm_90a``
(`csrc/ssd_scan.cu`, whose head note gives the design and what bounds it).
`chunked_scan_plain` is the same algorithm in plain PyTorch: the
``_chunked_jnp`` algorithm over the kernel's tiles of `TILE` rows.

The kernel runs its products on the tensor cores in the 3xTF32 split
(~f32 accuracy), one CTA per b*h and 128 state columns; `check_kernel_limits`
states the shapes it takes.

Both walk the sequence in tiles of 64 rows and carry the state from tile to
tile; they take no chunk.  The recurrence is the same function under any
chunking, and a 64-row tile keeps ``exp(-cumsum(w))`` within e^16 under the
op's decay clamp, where the reference's 512-row serving chunk would overflow
f32.  Any length is taken: the last tile's rows past the sequence are zeros
(decay 1, key 0), which leave the state as it is.

A wrapper runs the plain twin only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.  ``chunked_scan_cuda.launches`` counts the
launches.  The CUDA library is built on first use (`build`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.common import build_library

__all__ = ["build", "check_kernel_limits", "chunked_scan_cuda", "chunked_scan_plain",
           "TILE", "MAX_K"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
TILE = 64   # csrc/ssd_scan.cu TILE
MAX_K = 64  # csrc/ssd_scan.cu KP
ROW_ALIGN = 4  # K and V in whole 16-byte copies (cp.async) of f32
MAX_GRID_Y = 65535

_LIB: ctypes.CDLL | None = None
_P, _I = ctypes.c_void_p, ctypes.c_int


def build() -> ctypes.CDLL:
    """Build (once per source version, `common.build_library`) and load the
    kernel's library; `common.BUILD_LOGS` keeps the compiler's output."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library("ssd_scan", SOURCE)))
    lib.ssd_scan_error_string.argtypes = [_I]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    lib.ssd_scan.argtypes = [_P] * 7 + [_I] * 5 + [_P]
    lib.ssd_scan.restype = _I
    _LIB = lib
    return lib


def _check(q, k, v, w, s0) -> None:
    f32 = torch.float32
    if q.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q must be [BH, L, K] and v [BH, L, V], got "
                         f"{tuple(q.shape)} and {tuple(v.shape)}")
    bh, seq, kdim = q.shape
    want = {"q": (q, (bh, seq, kdim)), "k": (k, (bh, seq, kdim)),
            "w": (w, (bh, seq, kdim)), "v": (v, (bh, seq, v.shape[2])),
            "s0": (s0, (bh, kdim, v.shape[2]))}
    for name, (a, shape) in want.items():
        if a.dtype != f32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")


def check_kernel_limits(bh: int, seq: int, kdim: int, vdim: int) -> None:
    """Raise ``ValueError`` for a shape the CUDA kernel cannot take.

    Pure (no device, no library): the CUDA branch of `chunked_scan_cuda`
    calls it before it launches, so such a shape raises and never reaches
    the plain twin.  K <= `MAX_K`; K and V multiples of `ROW_ALIGN` (rows
    load as 16-byte copies); 1 <= BH <= 65535 (grid y); any L >= 0.
    """
    if not 1 <= kdim <= MAX_K or kdim % ROW_ALIGN:
        raise ValueError(f"the kernel takes K a multiple of {ROW_ALIGN} up to {MAX_K}, "
                         f"got K={kdim}")
    if vdim < 1 or vdim % ROW_ALIGN:
        raise ValueError(f"the kernel takes V a multiple of {ROW_ALIGN}, got V={vdim}")
    if not 1 <= bh <= MAX_GRID_Y or seq < 0:
        raise ValueError(f"the kernel takes 1 <= BH <= {MAX_GRID_Y} and L >= 0, got "
                         f"BH={bh}, L={seq}")


def chunked_scan_plain(q, k, v, w, s0, *, inclusive: bool = True):
    """Plain PyTorch twin of `chunked_scan_cuda` (any device).

    q, k, w: ``[BH, L, K]`` f32 (w the log-decay, <= 0); v: ``[BH, L, V]``;
    s0: ``[BH, K, V]``.  Returns ``(y [BH, L, V], final state [BH, K, V])``.
    """
    _check(q, k, v, w, s0)
    bh, seq, kdim = q.shape
    vdim = v.shape[2]
    pad = (-seq) % TILE
    nt = (seq + pad) // TILE

    def tiles(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x
        return x.reshape(bh, nt, TILE, x.shape[2])

    q, k, v, w = tiles(q), tiles(k), tiles(v), tiles(w)
    cums = torch.cumsum(w, dim=2)
    total = cums[:, :, -1:, :]
    qd = q * torch.exp(cums if inclusive else cums - w)
    kn = k * torch.exp(-cums)
    ke = k * torch.exp(total - cums)
    rows = torch.arange(TILE, device=q.device)
    mask = (rows[:, None] >= rows[None, :]) if inclusive else (rows[:, None] > rows[None, :])
    scores = torch.where(mask, qd @ kn.transpose(-1, -2), 0.0)
    y = scores @ v
    s = s0
    decay = torch.exp(total[:, :, 0, :])[..., None]    # [BH, nt, K, 1]
    for i in range(nt):
        y[:, i] += qd[:, i] @ s
        s = s * decay[:, i] + ke[:, i].transpose(-1, -2) @ v[:, i]
    return y.reshape(bh, nt * TILE, vdim)[:, :seq], s


def chunked_scan_cuda(q, k, v, w, s0, *, inclusive: bool = True):
    """Chunked scan (replaces ``chunked_scan_pallas``); arguments as
    `chunked_scan_plain`.  CPU tensors go to `chunked_scan_plain`."""
    _check(q, k, v, w, s0)
    if q.device.type == "cpu":
        return chunked_scan_plain(q, k, v, w, s0, inclusive=inclusive)
    if q.device.type != "cuda":
        raise ValueError(f"the scan runs on CUDA or CPU tensors, got {q.device}")
    bh, seq, kdim = q.shape
    vdim = v.shape[2]
    check_kernel_limits(bh, seq, kdim, vdim)
    q, k, v, w, s0 = (a.contiguous() for a in (q, k, v, w, s0))
    lib = build()
    y = torch.empty_like(v)
    sf = torch.empty_like(s0)
    with torch.cuda.device(q.device):
        rc = lib.ssd_scan(q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                          s0.data_ptr(), y.data_ptr(), sf.data_ptr(), bh, seq, kdim,
                          vdim, int(bool(inclusive)),
                          ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc} ({msg})")
    chunked_scan_cuda.launches += 1
    return y, sf


chunked_scan_cuda.launches = 0
