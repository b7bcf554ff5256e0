"""The port's chunked scan against the JAX package's, on the CPU.

The JAX side runs as tests/test_kernels.py runs it (``use_pallas=True,
interpret=True``); the port runs on ``device="cpu"``, so its kernel wrapper
takes the plain twin (`chunked_scan_plain`).  Inputs are made from a seed
with numpy and handed to both.  Tolerance rtol/atol 2e-4, as
tests/test_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan.kernel import chunked_scan_pallas
from repro.kernels.ssd_scan.ref import scan_ref as jscan_ref
from repro_torch.kernels.ssd_scan import kernel, ops
from repro_torch.kernels.ssd_scan.ref import scan_ref

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, B, L, H, K, V, inclusive):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = rng.standard_normal((B, L, H, K)).astype(f)
    k = (rng.standard_normal((B, L, H, K)) * 0.3).astype(f)
    v = rng.standard_normal((B, L, H, V)).astype(f)
    w = (-rng.uniform(0, 0.2, (B, L, H, K))).astype(f)
    s0 = (rng.standard_normal((B, H, K, V)) * 0.1).astype(f)
    u = None if inclusive else (rng.standard_normal((H, K)) * 0.1).astype(f)
    return q, k, v, w, s0, u


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("B,L,H,K,V", [
    (1, 64, 1, 8, 8),
    (2, 128, 2, 16, 32),
    (2, 200, 3, 32, 48),   # L not a 64 multiple -> padding path
    (1, 320, 2, 64, 64),
])
@pytest.mark.parametrize("inclusive", [True, False])
def test_linear_recurrence_matches_jax(B, L, H, K, V, inclusive):
    arrs = _inputs(B * 1000 + L + H + K + V + int(inclusive), B, L, H, K, V, inclusive)
    yj, sfj = jops.linear_recurrence(*map(_j, arrs), chunk=64, inclusive=inclusive,
                                     use_pallas=True, interpret=True)
    for use_kernels in (True, False):
        y, sf = ops.linear_recurrence(*map(_t, arrs), inclusive=inclusive,
                                      use_kernels=use_kernels)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(sf.numpy(), np.asarray(sfj), **TOL)


@pytest.mark.parametrize("inclusive", [True, False])
def test_plain_twin_matches_pallas_kernel(inclusive):
    q, k, v, w, s0, _ = _inputs(11, 1, 192, 3, 32, 48, True)
    merge = lambda x: np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(3, 192, x.shape[-1]))
    args = [merge(a) for a in (q, k, v, w)] + [s0.reshape(3, 32, 48)]
    yj, sfj = chunked_scan_pallas(*map(_j, args), chunk=64, inclusive=inclusive,
                                  interpret=True)
    y, sf = kernel.chunked_scan_cuda(*map(_t, args), inclusive=inclusive)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sfj), **TOL)
    assert kernel.chunked_scan_cuda.launches == 0  # CPU tensors: the plain twin


@pytest.mark.parametrize("inclusive", [True, False])
def test_scan_ref_matches_jax(inclusive):
    q, k, v, w, s0, _ = _inputs(12, 1, 50, 2, 8, 8, True)
    merge = lambda x: np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(2, 50, x.shape[-1]))
    args = [merge(a) for a in (q, k, v, w)] + [s0.reshape(2, 8, 8)]
    yj, sfj = jscan_ref(*map(_j, args), inclusive=inclusive)
    y, sf = scan_ref(*map(_t, args), inclusive=inclusive)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sfj), **TOL)


def test_bf16_matches_jax():
    rng = np.random.default_rng(0)
    B, L, H, K, V = 1, 128, 2, 16, 16
    mk = lambda s: np.asarray(jnp.asarray(rng.standard_normal(s), jnp.bfloat16),
                              np.float32)
    q, k, v = mk((B, L, H, K)), mk((B, L, H, K)), mk((B, L, H, V))
    w = np.asarray(-jnp.abs(jnp.asarray(mk((B, L, H, K)), jnp.bfloat16)) * 0.1,
                   np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    y16, _ = ops.linear_recurrence(bf(q), bf(k), bf(v), bf(w), use_kernels=True)
    y32, _ = ops.linear_recurrence(*map(_t, (q, k, v, w)), use_kernels=True)
    yj, _ = jops.linear_recurrence(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, w)),
                                   use_pallas=True, interpret=True)
    assert y16.dtype == torch.bfloat16
    # as tests/test_kernels.py: bf16 against f32 within bf16's rounding
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), rtol=0.1, atol=0.15)
    # against JAX: both round the same f32 sums to bf16, so a few bf16 ulps
    np.testing.assert_allclose(y16.float().numpy(), np.asarray(yj, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_chunk_invariance():
    """The recurrence is exact under any chunking: the port, which takes no
    chunk (64-row tiles), matches the reference at every chunk it takes."""
    q, k, v, w, _, _ = _inputs(5, 2, 256, 2, 16, 16, True)
    y, _ = ops.linear_recurrence(*map(_t, (q, k, v, w)), use_kernels=True)
    for c in (16, 64, 256):
        yj, _ = jops.linear_recurrence(*map(_j, (q, k, v, w)), chunk=c,
                                       use_pallas=True, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL, err_msg=f"chunk {c}")


@pytest.mark.parametrize("inclusive", [True, False])
def test_decode_fast_path(inclusive):
    rng = np.random.default_rng(9)
    B, H, K, V = 2, 3, 16, 16
    f = np.float32
    s0 = (rng.standard_normal((B, H, K, V)) * 0.2).astype(f)
    q = rng.standard_normal((B, 1, H, K)).astype(f)
    k = rng.standard_normal((B, 1, H, K)).astype(f)
    v = rng.standard_normal((B, 1, H, V)).astype(f)
    w = (-rng.uniform(0, 0.2, (B, 1, H, K))).astype(f)
    u = None if inclusive else (rng.standard_normal((H, K)) * 0.1).astype(f)
    args = (q, k, v, w, s0, u)
    y1, s1 = ops.linear_recurrence(*map(_t, args), inclusive=inclusive)
    yj, sj = jops.linear_recurrence(*map(_j, args), inclusive=inclusive)
    np.testing.assert_allclose(y1.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(sj), **TOL)
    # the same step through the chunked path (token replicated to seq 8)
    tile = lambda a: np.tile(a, (1, 8, 1, 1))
    y8, _ = ops.linear_recurrence(*map(_t, (tile(q), tile(k), tile(v), tile(w), s0, u)),
                                  inclusive=inclusive, use_kernels=True)
    np.testing.assert_allclose(y1[:, 0].numpy(), y8[:, 0].numpy(), **TOL)


@pytest.mark.parametrize("inclusive", [True, False])
def test_chunk_512_at_the_decay_clamp_is_finite(inclusive):
    """At the reference's serving chunk of 512 with the log-decay at the
    clamp (-0.25 every step), its exp(-cumsum) reaches e^128 and overflows
    f32 (its plain and Pallas paths give NaN).  The port takes no chunk: its
    64-row tiles keep the exponent within e^16 over the same 1024 rows."""
    rng = np.random.default_rng(13)
    B, L, H, K, V = 1, 1024, 2, 64, 16
    f = np.float32
    q, k = (rng.standard_normal((B, L, H, K)).astype(f) for _ in range(2))
    v = rng.standard_normal((B, L, H, V)).astype(f)
    w = np.full((B, L, H, K), -0.25, f)
    y, sf = ops.linear_recurrence(*map(_t, (q, k, v, w)), inclusive=inclusive,
                                  use_kernels=True)
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    merge = lambda x: torch.from_numpy(x).transpose(1, 2).reshape(B * H, L, -1)
    yr, sfr = scan_ref(merge(q), merge(k), merge(v), merge(w),
                       torch.zeros(B * H, K, V), inclusive=inclusive)
    np.testing.assert_allclose(y.transpose(1, 2).reshape(B * H, L, V).numpy(),
                               yr.numpy(), **TOL)
    np.testing.assert_allclose(sf.reshape(B * H, K, V).numpy(), sfr.numpy(), **TOL)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(2, 64, 8)
    v = torch.zeros(2, 64, 4)
    s0 = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError, match=r"\[BH, L, K\]"):
        kernel.chunked_scan_cuda(q[0], q, v, q, s0)
    with pytest.raises(ValueError, match="float32"):
        kernel.chunked_scan_cuda(q.double(), q, v, q, s0)
    with pytest.raises(ValueError, match="s0"):
        kernel.chunked_scan_cuda(q, q, v, q, torch.zeros(2, 4, 8))
    # the CUDA kernel's own limits, checked before any launch (pure, so here
    # on the CPU): a shape it cannot take raises and never reaches the twin
    for bh, seq, kdim, vdim, match in ((2, 64, 65, 4, "K a multiple of 4 up to 64"),
                                       (2, 64, 6, 4, "K a multiple of 4"),
                                       (2, 64, 8, 6, "V a multiple of 4"),
                                       (70000, 64, 8, 4, "BH <= 65535"),
                                       (0, 64, 8, 4, "BH <= 65535")):
        with pytest.raises(ValueError, match=match):
            kernel.check_kernel_limits(bh, seq, kdim, vdim)


@pytest.mark.parametrize("bh,seq,kdim,vdim", [
    (320, 1000, 64, 128),   # the serve shape
    (3, 0, 32, 48),
    (1, 65, 4, 200),        # V past one CTA's 128 columns: a second CTA column
])
def test_kernel_limits_accept(bh, seq, kdim, vdim):
    kernel.check_kernel_limits(bh, seq, kdim, vdim)


def _tf32(x):
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest on the bit
    pattern (add 0x1000), then clear the 13 low mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul(a, b, mode):
    """a @ b with operands rounded as the tensor cores take them: "tf32"
    (one product of rounded operands) or "tf32x3" (x = hi + lo, both TF32,
    and a_lo b_hi + a_hi b_lo + a_hi b_hi summed in f32)."""
    ah, bh = _tf32(a), _tf32(b)
    if mode == "tf32":
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _scan_emulated(q, k, v, w, s0, mode):
    """`chunked_scan_plain` (inclusive) with every product as `_matmul`."""
    bh, seq, kdim = q.shape
    t = kernel.TILE
    pad = (-seq) % t
    nt = (seq + pad) // t
    tiles = lambda x: torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(bh, nt, t, -1)
    q, k, v, w = tiles(q), tiles(k), tiles(v), tiles(w)
    cums = torch.cumsum(w, dim=2)
    total = cums[:, :, -1:, :]
    qd, kn, ke = q * torch.exp(cums), k * torch.exp(-cums), k * torch.exp(total - cums)
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool))
    s, ys = s0, []
    for i in range(nt):
        scores = torch.where(mask, _matmul(qd[:, i], kn[:, i].transpose(-1, -2), mode), 0.0)
        ys.append(_matmul(scores, v[:, i], mode) + _matmul(qd[:, i], s, mode))
        s = (s * torch.exp(total[:, i, 0, :])[..., None]
             + _matmul(ke[:, i].transpose(-1, -2), v[:, i], mode))
    return torch.cat(ys, dim=1)[:, :seq], s


@pytest.mark.parametrize("mode", ["tf32x3", "tf32"])
@pytest.mark.parametrize("what", ["tile", "scan"])
def test_tf32x3_split_keeps_the_scan_within_its_tolerance(what, mode):
    """The precision argument of the kernel's 3xTF32 products, on the CPU.

    ``tile``: one serve-shaped tile's output y = A v + qd S (64 rows, K 64,
    V 128; A the masked 64 x 64 x 64 score product, S a state of unit
    scale).  ``scan``: the whole recurrence at the serve widths over 1000
    rows.  Against f32, the split stays within 2e-4 of the largest value
    (the scan's tolerance) by three orders of magnitude; a single TF32
    product does not stay within it.
    """
    rng = np.random.default_rng(21)
    f = np.float32
    bh, seq, kdim, vdim = (1, 64, 64, 128) if what == "tile" else (2, 1000, 64, 128)
    q = torch.from_numpy(rng.standard_normal((bh, seq, kdim)).astype(f))
    k = torch.from_numpy((rng.standard_normal((bh, seq, kdim)) * 0.3).astype(f))
    v = torch.from_numpy(rng.standard_normal((bh, seq, vdim)).astype(f))
    w = torch.from_numpy((-rng.uniform(0, 0.25, (bh, seq, kdim))).astype(f))
    s0 = torch.from_numpy((rng.standard_normal((bh, kdim, vdim))
                           * (3.0 if what == "tile" else 0.1)).astype(f))
    yp, sp = kernel.chunked_scan_plain(q, k, v, w, s0)
    y, s = _scan_emulated(q, k, v, w, s0, mode)
    err = max((y - yp).abs().max().item(), (s - sp).abs().max().item())
    rel = err / max(yp.abs().max().item(), sp.abs().max().item())
    if mode == "tf32x3":
        assert rel <= 2e-4 * 1e-2, rel
    else:
        assert rel > 2e-4, rel
