"""Mamba2 (SSD) block, executed with the medium-granularity chunked scan.

Ports `repro/models/mamba2.py`.  The SSD recurrence h_t = exp(a_t) h_{t-1}
+ b_t x_t is a unit-bidiagonal SpTRSV; `repro_torch.kernels.ssd_scan` runs
it chunk-wise (the paper's medium granularity).

Structure per block: in_proj -> [z (gate), xBC, dt]; depthwise causal conv
on xBC (its last ``ssm_conv - 1`` inputs carried as decode state); split
into x (per-head values), B (state input) and C (state output); per-head
scalar decay a = -exp(a_log) * softplus(dt + dt_bias); y = SSD(x, B, C, a);
gated RMSNorm; out_proj.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.distributed.sharding import reduce_grad, unshard
from repro_torch.kernels.ssd_scan.ops import linear_recurrence

from .layers import Linear, RuntimeFlags, gain, linear, pad_local, rms_norm, shard

__all__ = ["Mamba2Block", "mamba2_block", "mamba2_decode", "init_mamba2_state"]


def _dims(cfg):
    d_inner = 2 * cfg.d_model
    nh = cfg.ssm_heads
    hd = d_inner // nh             # value head dim
    ds = cfg.ssm_state             # state width per head (key dim)
    return d_inner, nh, hd, ds


class Mamba2Block(nn.Module):
    """Parameters of one block, named and drawn as ``init_mamba2``."""

    def __init__(self, cfg, *, gen=None, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        d_inner, nh, hd, ds = _dims(cfg)
        conv_ch = d_inner + 2 * nh * ds
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.in_proj = Linear(d, 2 * d_inner + 2 * nh * ds + nh, **kw)
        self.conv_w = nn.Parameter(
            (torch.randn((cfg.ssm_conv, conv_ch), generator=gen, device=device)
             * 0.2).to(dtype), requires_grad=False)
        self.a_log = gain(nh, device, 0.0)      # log A (per head)
        self.dt_bias = gain(nh, device, -2.0)
        self.d_skip = gain(nh, device)
        self.norm_g = gain(d_inner, device)
        self.out_proj = Linear(d_inner, d, scale=d_inner ** -0.5, **kw)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv + SiLU. x: ``[B, L, C]``; w: ``[K, C]``.

    Returns the output and the last ``K - 1`` inputs (the decode state).
    """
    kw = w.shape[0]
    if state is None:
        xp = pad_local(x, (0, 0, kw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = xp[:, 0:x.shape[1]] * w[0].to(x.dtype)
    for i in range(1, kw):
        out = out + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return F.silu(out), (xp[:, -(kw - 1):] if kw > 1 else None)


def mamba2_block(p: Mamba2Block, u, cfg, flags: RuntimeFlags,
                 conv_state=None, ssm_state=None):
    """u: ``[B, L, d]`` -> ``(out [B, L, d], (conv_state, ssm_state))``."""
    b, l, _ = u.shape
    d_inner, nh, hd, ds = _dims(cfg)
    # in_proj is column-parallel where "model" divides its output (its input
    # gradient summed there once); whole before it is cut in parts
    zxbcdt = unshard(linear(p.in_proj, reduce_grad(u)), -1)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * nh * ds]
    dt = zxbcdt[..., -nh:]
    # the conv weight whole, as xbc is: its channels are then cut into
    # x, B and C at offsets that no split over "model" follows
    xbc, conv_state = _causal_conv(xbc, unshard(p.conv_w, -1), conv_state)
    x = xbc[..., :d_inner].reshape(b, l, nh, hd)
    bmat = xbc[..., d_inner:d_inner + nh * ds].reshape(b, l, nh, ds)
    cmat = xbc[..., d_inner + nh * ds:].reshape(b, l, nh, ds)

    dt_s = F.softplus(dt.float() + p.dt_bias)                  # [B, L, nh]
    a = -torch.exp(p.a_log)[None, None, :] * dt_s              # log-decay
    w = a[..., None].expand(b, l, nh, ds)                      # per key

    # discretized input: x_bar = dt * x ; recurrence S += (B dt x)
    v_in = x * dt_s[..., None].to(x.dtype)
    # on a mesh the heads split over "model" inside linear_recurrence
    y, ssm_state = linear_recurrence(
        cmat, bmat, v_in, w, s0=ssm_state, inclusive=True,
        use_kernels=flags.use_kernels, flags=flags)
    y = y + x * p.d_skip[None, None, :, None].to(x.dtype)
    y = y.reshape(b, l, d_inner)
    y = rms_norm(y * F.silu(z), p.norm_g, cfg.norm_eps)
    # row-parallel out_proj: its partial sums reduced here, the residual whole
    return shard(linear(p.out_proj, y), flags, "dp", None, None), (conv_state, ssm_state)


def init_mamba2_state(cfg, batch: int, dtype=torch.float32, device=None):
    """Zero ``(conv_state [B, K-1, C] in dtype, ssm_state [B, nh, ds, hd] f32)``."""
    d_inner, nh, hd, ds = _dims(cfg)
    conv_ch = d_inner + 2 * nh * ds
    return (torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
            torch.zeros((batch, nh, ds, hd), dtype=torch.float32, device=device))


def mamba2_decode(p: Mamba2Block, u, cfg, flags, conv_state, ssm_state):
    """Single-step decode: u ``[B, 1, d]``; O(1) state update."""
    return mamba2_block(p, u, cfg, flags, conv_state, ssm_state)
