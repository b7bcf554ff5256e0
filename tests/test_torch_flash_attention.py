"""The port's attention against the JAX package's, on the CPU.

The JAX side runs as tests/test_kernels.py runs it (``use_pallas=True,
interpret=True``); the port runs on ``device="cpu"``, so its kernel wrapper
takes the plain twin (`flash_attention_plain`).  Inputs are made from a
seed with numpy and handed to both.  Tolerance 2e-5 in f32 (as
tests/test_kernels.py), 0.05 in bf16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ops import gqa_attention as jgqa
from repro.kernels.flash_attention.ref import attention_blocked as jblocked
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ops import gqa_attention
from repro_torch.kernels.flash_attention.ref import attention_blocked, attention_ref

TOL32 = dict(rtol=2e-5, atol=2e-5)
TOL16 = dict(rtol=0.05, atol=0.05)


def _qkv(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("B,Lq,Hq,Hkv,D,bq,bk", [
    (1, 128, 2, 2, 32, 64, 64),
    (2, 200, 8, 2, 64, 64, 128),     # ragged lengths + GQA
    (1, 96, 4, 1, 128, 32, 32),      # MQA
    (2, 150, 4, 4, 80, 64, 64),      # Zamba2's head width
])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_attention_matches_jax(B, Lq, Hq, Hkv, D, bq, bk, causal):
    q, k, v = _qkv(Lq * 10 + Hq + int(causal),
                   [(B, Lq, Hq, D), (B, Lq, Hkv, D), (B, Lq, Hkv, D)])
    oj = jgqa(*map(jnp.asarray, (q, k, v)), causal=causal, use_pallas=True,
              interpret=True, block_q=bq, block_k=bk)
    for use_kernels in (True, False):
        o = gqa_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          use_kernels=use_kernels)
        np.testing.assert_allclose(o.numpy(), np.asarray(oj), **TOL32)


@pytest.mark.parametrize("D", [64, 80])
def test_bf16_matches_jax(D):
    q, k, v = _qkv(1, [(1, 128, 4, D), (1, 128, 2, D), (1, 128, 2, D)])
    oj = jgqa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), use_pallas=True,
              interpret=True, block_q=64, block_k=64)
    o = gqa_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                      use_kernels=True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), np.asarray(oj, np.float32), **TOL16)


@pytest.mark.parametrize("lq,lk", [(100, 160), (130, 70)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_twin_matches_pallas_kernel(lq, lk, causal):
    """Lq != Lk keeps the reference's causal convention (rows >= cols)."""
    q, k, v = _qkv(lq + lk, [(3, lq, 80), (3, lk, 80), (3, lk, 80)])
    oj = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), scale=80 ** -0.5,
                                causal=causal, block_q=32, block_k=64,
                                interpret=True)
    o = kernel.flash_attention_cuda(*map(torch.from_numpy, (q, k, v)),
                                    scale=80 ** -0.5, causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), **TOL32)
    assert kernel.flash_attention_cuda.launches == 0  # CPU tensors: the plain twin


@pytest.mark.parametrize("bh,l,d,bk,causal", [
    (4, 256, 32, 64, True), (2, 300, 64, 128, False), (1, 512, 16, 512, True)])
def test_attention_blocked_matches_exact_and_jax(bh, l, d, bk, causal):
    q, k, v = _qkv(7 + l, [(bh, l, d)] * 3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    a = attention_ref(tq, tk, tv, scale=d ** -0.5, causal=causal)
    b = attention_blocked(tq, tk, tv, scale=d ** -0.5, causal=causal, block_k=bk)
    bj = jblocked(*map(jnp.asarray, (q, k, v)), scale=d ** -0.5, causal=causal,
                  block_k=bk)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL32)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), **TOL32)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="share one of"):
        kernel.flash_attention_cuda(q, q.double(), q.double(), scale=1.0)
    with pytest.raises(ValueError, match="BH or D"):
        kernel.flash_attention_cuda(q, torch.zeros(2, 16, 4), torch.zeros(2, 16, 4),
                                    scale=1.0)
    with pytest.raises(ValueError, match="multiple"):
        gqa_attention(torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 2, 8),
                      torch.zeros(1, 4, 2, 8))
    # the CUDA kernels' own limits, checked before any launch (pure, so here
    # on the CPU): a shape they cannot take raises and never reaches the twin
    bf16, f32 = torch.bfloat16, torch.float32
    for bh, lq, lk, d, dtype, match in (
            (2, 16, 16, 40, bf16, "multiple of 16"),   # not whole mma k-steps
            (2, 16, 16, 8, bf16, "multiple of 16"),
            (2, 16, 16, 144, bf16, "multiple of 16 up to 128"),
            (2, 16, 16, 144, f32, "D <= 128"),
            (70000, 16, 16, 64, f32, "BH <= 65535"),   # grid y of the f32 kernel
            (2, 64 * 65535 + 1, 16, 64, bf16, "Lq <="),  # grid y of the bf16 kernel
            (2, 0, 16, 64, bf16, "Lq >= 1"),
            (2, 16, 16, 64, torch.float16, "take")):
        with pytest.raises(ValueError, match=match):
            kernel.check_kernel_limits(bh, lq, lk, d, dtype)


@pytest.mark.parametrize("bh,lq,lk,d,dtype", [
    (256, 1000, 1000, 80, torch.bfloat16),   # the serve shape
    (70000, 64, 64, 80, torch.bfloat16),     # b*h on grid x: past 65535
    (6, 200, 200, 80, torch.float32),
    (6, 100, 170, 36, torch.float32),        # f32 takes any D up to 128
])
def test_kernel_limits_accept(bh, lq, lk, d, dtype):
    kernel.check_kernel_limits(bh, lq, lk, d, dtype)


def _online_softmax_p_rounded(q, k, v, *, scale, causal):
    """The bf16 kernel's arithmetic in plain torch: online softmax over 64-key
    tiles in f32, P rounded to bf16 for the PV product (f32 accumulation),
    the row sums over f32 P, the output rounded to bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    bh, lq, _ = q.shape
    lk = k.shape[1]
    qf = q.to(f32)
    rows = torch.arange(lq)[None, :, None]
    m = torch.full((bh, lq), -1e30)
    l = torch.zeros(bh, lq)
    acc = torch.zeros(bh, lq, q.shape[2])
    for k0 in range(0, lk, kernel.BLOCK_K):
        kc, vc = k[:, k0:k0 + kernel.BLOCK_K].to(f32), v[:, k0:k0 + kernel.BLOCK_K].to(f32)
        s = torch.einsum("bqd,bkd->bqk", qf, kc) * scale
        if causal:
            cols = k0 + torch.arange(kc.shape[1])[None, None, :]
            s = torch.where(rows >= cols, s, -1e30)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqk,bkd->bqd", p.to(bf16).to(f32), vc)
        m = m_cur
    return (acc / l[..., None]).to(q.dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_p_rounded_to_bf16_stays_within_tolerance(causal):
    """The precision argument of the bf16 kernel, on the CPU: P rounded to
    bf16 in the blocked online softmax at D = 80 stays within 2e-2 of the
    twin's largest value, the tolerance the kernel is held to on the card,
    and moves some outputs by a bf16 step that f32 P does not."""
    assert kernel.P_VARIANT == "bf16"
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(80 + causal, [(4, 1000, 80)] * 3))
    want = kernel.flash_attention_plain(q, k, v, scale=80 ** -0.5, causal=causal).float()
    got = _online_softmax_p_rounded(q, k, v, scale=80 ** -0.5, causal=causal).float()
    err = (got - want).abs().max().item()
    assert 0 < err <= 2e-2 * want.abs().max().item(), err
