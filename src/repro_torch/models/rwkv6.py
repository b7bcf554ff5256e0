"""RWKV6 "Finch" block — attention-free, data-dependent per-channel decay.
Ports `repro/models/rwkv6.py`.

The WKV recurrence S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T with exclusive
output and the u-bonus maps onto the medium-granularity chunked scan
(`linear_recurrence(inclusive=False, u_bonus=u)`, the `chunked_scan_cuda`
kernel on the card; a decode step takes the scan's direct recurrence).

The reference's simplifications of the released model are kept: single
learned token-shift mixes per channel in place of the LoRA interpolators,
and a direct decay projection — the dataflow (token shift -> r/k/v/w/g ->
WKV -> gated norm -> output) and every tensor shape match.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels.ssd_scan.ops import linear_recurrence

from .layers import Linear, RuntimeFlags, linear, rms_norm

__all__ = ["RWKVTimeMix", "RWKVChannelMix", "rwkv_time_mix", "rwkv_channel_mix",
           "init_rwkv_state"]


def _dims(cfg):
    nh, ds = cfg.ssm_heads, cfg.ssm_state
    return nh, ds, nh * ds  # heads, key width, inner width (== d_model)


def _full(shape, value: float, device):
    """An f32 parameter filled with ``value`` (mixes, biases, gains)."""
    return nn.Parameter(torch.full(shape, value, device=device), requires_grad=False)


class RWKVTimeMix(nn.Module):
    """Parameters named and drawn as ``init_rwkv_time_mix``."""

    def __init__(self, cfg, *, gen=None, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        nh, ds, inner = _dims(cfg)
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.mix = _full((5, d), 0.5, device)     # r, k, v, w, g token-shift mixes
        self.wr = Linear(d, inner, **kw)
        self.wk = Linear(d, inner, **kw)
        self.wv = Linear(d, inner, **kw)
        self.ww = Linear(d, inner, scale=1e-2, **kw)
        self.wg = Linear(d, inner, **kw)
        self.w_bias = _full((inner,), -6.0, device)
        self.u_bonus = _full((nh, ds), 0.0, device)
        self.ln_g = _full((inner,), 1.0, device)
        self.wo = Linear(inner, d, scale=inner ** -0.5, **kw)


class RWKVChannelMix(nn.Module):
    """Parameters named and drawn as ``init_rwkv_channel_mix``."""

    def __init__(self, cfg, *, gen=None, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.mix = _full((2, cfg.d_model), 0.5, device)
        self.wk = Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wv = Linear(cfg.d_ff, cfg.d_model, scale=cfg.d_ff ** -0.5, **kw)


def _shifted(x, shift_state):
    """x one token later: the carried last token (zeros) in front."""
    prev = (torch.zeros_like(x[:, :1]) if shift_state is None
            else shift_state.to(x.dtype))
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv_time_mix(p: RWKVTimeMix, x, cfg, flags: RuntimeFlags,
                  shift_state=None, wkv_state=None):
    """x: ``[B, L, d]`` -> ``(out, (shift_state [B, 1, d], wkv_state
    [B, H, K, V] f32))``."""
    b, l, d = x.shape
    nh, ds, inner = _dims(cfg)
    x_prev = _shifted(x, shift_state)
    mix = p.mix.to(x.dtype)
    xs = [x + (x_prev - x) * mix[i][None, None, :] for i in range(5)]
    r = linear(p.wr, xs[0]).reshape(b, l, nh, ds)
    k = linear(p.wk, xs[1]).reshape(b, l, nh, ds)
    v = linear(p.wv, xs[2]).reshape(b, l, nh, ds)
    w_raw = linear(p.ww, xs[3]).float() + p.w_bias
    # data-dependent decay in (0, 1): log-decay = -exp(w) (RWKV6 convention)
    w = -torch.exp(w_raw).reshape(b, l, nh, ds)
    g = F.silu(linear(p.wg, xs[4]))

    y, wkv_state = linear_recurrence(r, k, v, w, s0=wkv_state, u_bonus=p.u_bonus,
                                     inclusive=False, use_kernels=flags.use_kernels,
                                     flags=flags)
    y = y.reshape(b, l, inner)
    y = rms_norm(y, p.ln_g, cfg.norm_eps) * g
    return linear(p.wo, y), (x[:, -1:, :], wkv_state)


def rwkv_channel_mix(p: RWKVChannelMix, x, shift_state=None):
    """Squared-ReLU channel mix: ``(out [B, L, d], shift_state [B, 1, d])``."""
    x_prev = _shifted(x, shift_state)
    xk = x + (x_prev - x) * p.mix.to(x.dtype)[0][None, None, :]
    h = torch.square(F.relu(linear(p.wk, xk)))
    return linear(p.wv, h), x[:, -1:, :]


def init_rwkv_state(cfg, batch: int, dtype=torch.float32, device=None):
    """Zero ``(time shift [B, 1, d], wkv [B, H, K, K] f32, channel shift
    [B, 1, d])``."""
    nh, ds, _ = _dims(cfg)
    return (torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
            torch.zeros((batch, nh, ds, ds), dtype=torch.float32, device=device),
            torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device))
