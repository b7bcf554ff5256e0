"""The paper's dataflow taxonomy on a sequence model, in the PyTorch port.

    PYTHONPATH=src python examples/torch_ssm_as_sptrsv.py                # CUDA
    PYTHONPATH=src python examples/torch_ssm_as_sptrsv.py --device cpu   # plain versions

The port's counterpart of `examples/ssm_as_sptrsv.py`, at its sizes.  A
linear SSM recurrence h_t = a_t h_{t-1} + u_t IS a bidiagonal SpTRSV.  This
example shows the equivalence numerically (SpTRSV solver == SSM scan on the
same system, one right-hand side and a batch of 8 through one pass of the
compiled VLIW stream), then runs the three execution granularities of a
batched multi-head recurrence S_t = diag(exp w_t) S_{t-1} + k_t v_t^T,
y_t = S_t^T q_t (B, L, H, K, V = 4, 4096, 8, 32, 32) and times them:

    coarse = sequential scan, one step at a time (`ssd_scan.ref.scan_ref`)
    fine   = log-depth parallel prefix scan over (decay, state) pairs,
             2x the combines of the sequential scan (the odd/even scheme
             of `jax.lax.associative_scan`, written in plain PyTorch)
    medium = chunked scan (`linear_recurrence(use_kernels=True)`): on a
             CUDA device one launch of the hand-written `chunked_scan_cuda`
             a call, on the CPU its plain chunked twin — the paper's
             coarse-allocation / fine-computation idea

The reference's medium calls ``linear_recurrence(..., chunk=64)``, which
runs its plain chunked path unless asked for Pallas.  The port's
`linear_recurrence` takes no chunk: both its paths walk 64-row tiles, so
there is nothing to pass, and on the card its medium runs the kernel.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core.csr import from_coo, serial_solve
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.ssd_scan.ops import linear_recurrence
from repro_torch.kernels.ssd_scan.ref import scan_ref

N, N_RHS = 512, 8
SIZES = (4, 4096, 8, 32, 32)      # B, L, H, K, V
TOL = 2e-3                        # the reference's rtol = atol


def bidiagonal(n: int, rng):
    """(I - sub-diag(a)) h = u, the system of h_t = a_t h_{t-1} + u_t:
    returns (matrix, a, u)."""
    a = rng.uniform(0.5, 0.99, n - 1)          # decay
    u = rng.standard_normal(n)                 # input
    mat = from_coo(n, range(1, n), range(0, n - 1), -a, np.ones(n), "ssm")
    return mat, a, u


def equivalence(mat, a, u, U, *, device=None) -> dict:
    """The SpTRSV solve against the SSM scan on one right-hand side ``u``,
    and the compiled program's batched solve of ``U`` [n, n_rhs] (one pass
    of the stream on ``device``) against per-column serial solves."""
    n = mat.n
    h_sptrsv = serial_solve(mat, u)
    h_scan = np.zeros(n)
    h_scan[0] = u[0]
    for t in range(1, n):
        h_scan[t] = a[t - 1] * h_scan[t - 1] + u[t]
    prog = api.compile(mat)
    H_bat = api.solve_batch(prog, U, device=device)
    H_ref = np.stack([serial_solve(mat, U[:, i]) for i in range(U.shape[1])], axis=1)
    return {"sptrsv_eq_scan": bool(np.allclose(h_sptrsv, h_scan)),
            "batched_eq_scans": bool(np.allclose(H_bat, H_ref, rtol=1e-4, atol=1e-4)),
            "prog": prog, "H_ref": H_ref}


def _merge(x):
    """[B, L, H, D] -> [B*H, L, D] f32."""
    b, seq, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, seq, d).float()


def _unmerge(y, b):
    """[B*H, L, V] -> [B, L, H, V]."""
    bh, seq, v = y.shape
    return y.reshape(b, bh // b, seq, v).permute(0, 2, 1, 3)


def coarse(q, k, v, w):
    """The sequential scan: one step at a time, the [K, V] state carried."""
    b = q.shape[0]
    s0 = torch.zeros(q.shape[0] * q.shape[2], q.shape[3], v.shape[3], device=q.device)
    y, _ = scan_ref(_merge(q), _merge(k), _merge(v), _merge(w), s0)
    return _unmerge(y, b)


def medium(q, k, v, w):
    """The chunked scan: `chunked_scan_cuda` on a CUDA device (one launch),
    its plain chunked twin on the CPU."""
    y, _ = linear_recurrence(q, k, v, w, use_kernels=True)
    return y


def _combine(earlier, later):
    """(d1, s1) then (d2, s2) -> (d1 d2, s2 + d2 s1)."""
    (d1, s1), (d2, s2) = earlier, later
    return d1 * d2, torch.addcmul(s2, d2, s1)


def _prefix(d, s):
    """Inclusive scan along dim 1 of the pairs (d [BH, L, K, 1], s [BH, L,
    K, V]), the odd/even recursion of `jax.lax.associative_scan`: combine
    neighbours, scan the half, fill in the even positions.  ~2L combines
    at depth 2 log2 L; each level's temporaries are freed before the next."""
    n = d.shape[1]
    if n < 2:
        return d, s
    odd_d, odd_s = _prefix(*_combine((d[:, 0:-1:2], s[:, 0:-1:2]), (d[:, 1::2], s[:, 1::2])))
    m = (n - 1) // 2                         # even positions 2, 4, ... below n
    even_d, even_s = _combine((odd_d[:, :m], odd_s[:, :m]), (d[:, 2::2], s[:, 2::2]))
    out_d, out_s = torch.empty_like(d), torch.empty_like(s)
    out_d[:, 0], out_s[:, 0] = d[:, 0], s[:, 0]
    out_d[:, 2::2], out_s[:, 2::2] = even_d, even_s
    del even_d, even_s
    out_d[:, 1::2], out_s[:, 1::2] = odd_d, odd_s
    return out_d, out_s


def fine(q, k, v, w):
    """The parallel prefix scan over (decay, state) pairs, 2x the work."""
    b = q.shape[0]
    qm, km, vm, wm = _merge(q), _merge(k), _merge(v), _merge(w)
    kv = torch.einsum("blk,blv->blkv", km, vm)
    _, s = _prefix(torch.exp(wm)[..., None], kv)
    del kv
    return _unmerge(torch.einsum("blk,blkv->blv", qm, s), b)


def recurrence_inputs(rng, sizes, device):
    """q, k, v, w [B, L, H, .] f32 on ``device``, drawn as the reference
    draws them (k scaled by 0.3, the log-decay w in [-0.2, 0])."""
    b, seq, h, kdim, vdim = sizes
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)
    q = as_t(rng.standard_normal((b, seq, h, kdim)).astype(np.float32))
    k = as_t(rng.standard_normal((b, seq, h, kdim)).astype(np.float32)) * 0.3
    v = as_t(rng.standard_normal((b, seq, h, vdim)).astype(np.float32))
    w = as_t((-rng.uniform(0.0, 0.2, (b, seq, h, kdim))).astype(np.float32))
    return q, k, v, w


def timed(fn, args, dev) -> tuple[torch.Tensor, float]:
    """(fn(*args), ms a call): a warm-up call, then the mean of 3 calls,
    synchronised on a CUDA device."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    y = fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        y = fn(*args)
    sync()
    return y, (time.perf_counter() - t0) / 3 * 1e3


GRANULARITIES = (("coarse", coarse), ("medium", medium), ("fine", fine))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (CUDA by default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- equivalence: (I - sub-diag(a)) h = u  <=>  h_t = a_t h_{t-1} + u_t;
    # then many input sequences through the same L in one pass of the
    # compiled stream, as a batch of SSM channels shares the recurrence
    mat, a, u = bidiagonal(N, rng)
    U = rng.standard_normal((N, N_RHS))
    eq = equivalence(mat, a, u, U, device=dev)
    print("SpTRSV == SSM scan:", eq["sptrsv_eq_scan"])
    print(f"batched SpTRSV (B={N_RHS}) == per-column scans:", eq["batched_eq_scans"])

    # --- the three granularities on a batched multi-head recurrence
    inputs = recurrence_inputs(rng, SIZES, dev)
    ys, ms = {}, {}
    for name, fn in GRANULARITIES:
        y, ms[name] = timed(fn, inputs, dev)
        ys[name] = y.cpu().numpy()
        print(f"{name:7s} {ms[name]:8.1f} ms/call")
    checks = {"medium_eq_coarse": bool(np.allclose(ys["medium"], ys["coarse"],
                                                   rtol=TOL, atol=TOL)),
              "fine_eq_coarse": bool(np.allclose(ys["fine"], ys["coarse"],
                                                 rtol=TOL, atol=TOL))}
    print("medium == coarse:", checks["medium_eq_coarse"])
    print("fine   == coarse:", checks["fine_eq_coarse"])
    return {"checks": {"sptrsv_eq_scan": eq["sptrsv_eq_scan"],
                       "batched_eq_scans": eq["batched_eq_scans"], **checks},
            "ms": ms, "device": str(dev), "mat": mat, "prog": eq["prog"], "U": U,
            "H_ref": eq["H_ref"], "inputs": inputs}


if __name__ == "__main__":
    main()
