"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's
`repro.models.moe.moe_ffn`, alone, on the CPU, in f32.

The same numpy-seeded tokens and the reference's ``init_moe`` weights go
through both at the reduced granite-moe (swiglu) and arctic configs and a
gelu variant; outputs and the aux loss agree at 1e-5.  The reduced
configs set ``capacity_factor=8.0``, which drops nothing, so the overflow
case runs the real 1.25 on 128 tokens that share an offset (every router
leans the same way, so an expert overflows: 19 of 256 pairs dropped at
top-2): the pairs each package
keeps are computed on both sides (the reference's lines, k-minor pairs
ranked by an exclusive cumsum, replayed in jnp; the port's `moe.route`)
and must be the same pairs, with some dropped, and the tokens whose output
changes when the layer runs dropless are the same tokens on both sides.
Ties: `moe.top_k` takes the lower expert first on an exact tie, as
lax.top_k does (tested on exact ties; torch.topk does not, and bf16 router
logits tie often); seeded f32 inputs make exact ties of router
probabilities improbable.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models.layers import linear as jlinear
from repro.models.moe import init_moe as jinit_moe
from repro.models.moe import moe_ffn as jmoe_ffn
from repro_torch.configs import get_config
from repro_torch.models import moe

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, **kw):
    cut = lambda c: dataclasses.replace(c.reduced(), **kw)
    return cut(jget_config(arch)), cut(get_config(arch))


def _flatten(node, path=()):
    if isinstance(node, dict):
        for key, child in node.items():
            yield from _flatten(child, path + (key,))
    else:
        yield ".".join(path), node


def _pair(cfg_j, cfg, seed=0):
    """The reference's MoE weights and the port's module holding them."""
    jp = jinit_moe(jax.random.PRNGKey(seed), cfg_j)
    port = moe.MoE(cfg, device="meta")
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _flatten(jp)},
                         assign=True)
    return jp, port


def _x(cfg, b, s, seed, offset=0.0):
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)) + offset
    return x.astype(np.float32)


def _both(jp, port, cfg_j, cfg, x, dropless=False):
    yj, aj = jmoe_ffn(jp, jnp.asarray(x), cfg_j, dropless=dropless)
    yt, at = moe.moe_ffn(port, torch.from_numpy(x), cfg, dropless=dropless)
    return (np.asarray(yj), float(aj)), (yt.numpy(), float(at))


@pytest.mark.parametrize("arch,mlp", [("granite-moe-1b-a400m", "swiglu"),
                                      ("arctic-480b", "swiglu"),
                                      ("granite-moe-1b-a400m", "gelu")])
@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("b,s", [(2, 16), (1, 1), (3, 7)])
def test_moe_ffn_matches_jax(arch, mlp, dropless, b, s):
    cfg_j, cfg = _cfgs(arch, mlp=mlp)
    jp, port = _pair(cfg_j, cfg)
    (yj, aj), (yt, at) = _both(jp, port, cfg_j, cfg, _x(cfg, b, s, b * s), dropless)
    assert yt.shape == (b, s, cfg.d_model)
    np.testing.assert_allclose(yt, yj, **TOL)
    np.testing.assert_allclose(at, aj, **TOL)


def _jax_keep(jp, x, cfg_j, dropless=False):
    """The pairs the reference keeps: its routing lines, replayed."""
    e, k = cfg_j.moe_experts, cfg_j.moe_topk
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    t = xt.shape[0]
    probs = jax.nn.softmax(jlinear(jp["router"], xt).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    cap = t * k if dropless else int(max(1, t * k / e * cfg_j.capacity_factor))
    eid = top_e.reshape(t * k)
    onehot = jax.nn.one_hot(eid, e, dtype=jnp.int32)
    rank = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.take_along_axis(rank, eid[:, None], axis=-1)[:, 0]
    return np.asarray(slot < cap), np.asarray(eid), cap


@pytest.mark.parametrize("topk", [1, 2])
def test_overflow_drops_the_same_pairs(topk):
    cfg_j, cfg = _cfgs("granite-moe-1b-a400m", capacity_factor=1.25, moe_topk=topk)
    jp, port = _pair(cfg_j, cfg, seed=1)
    x = _x(cfg, 2, 64, 5, offset=4.0)
    keep_j, eid_j, cap_j = _jax_keep(jp, x, cfg_j)
    r = moe.route(port, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg)
    assert r.cap == cap_j == int(128 * cfg.moe_topk / cfg.moe_experts * 1.25)
    np.testing.assert_array_equal(r.eid.numpy(), eid_j)
    np.testing.assert_array_equal(r.keep.numpy(), keep_j)
    dropped = int((~keep_j).sum())
    assert dropped > 0, "no expert overflowed: the case does not test drops"
    # the dropped pairs' slots point at the trash row
    assert (r.slot.numpy()[~keep_j] == r.cap).all()
    # black box: the tokens a dropless run changes, on each side
    (yj, aj), (yt, at) = _both(jp, port, cfg_j, cfg, x)
    (yj_all, _), (yt_all, _) = _both(jp, port, cfg_j, cfg, x, dropless=True)
    np.testing.assert_allclose(yt, yj, **TOL)
    np.testing.assert_allclose(at, aj, **TOL)
    changed = lambda a, c: set(np.nonzero(np.abs(a - c).reshape(128, -1).max(-1) > 1e-6)[0])
    want = set(np.nonzero(~keep_j.reshape(128, cfg.moe_topk).all(-1))[0])
    assert changed(yt, yt_all) == changed(yj, yj_all) == want


def test_dropless_capacity_holds_every_pair():
    cfg_j, cfg = _cfgs("granite-moe-1b-a400m", capacity_factor=1.25)
    jp, port = _pair(cfg_j, cfg, seed=1)
    x = _x(cfg, 2, 64, 5, offset=4.0)
    r = moe.route(port, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg, dropless=True)
    keep_j, _, cap_j = _jax_keep(jp, x, cfg_j, dropless=True)
    assert r.cap == cap_j == 128 * cfg.moe_topk and bool(r.keep.all()) and keep_j.all()


def test_topk_ties_take_the_lower_index_on_both_sides():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    _, ej = jax.lax.top_k(jnp.asarray(probs), 2)
    _, et = moe.top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(et.numpy(), [[0, 1], [1, 2], [0, 2]])


def test_moe_bf16_output_close_to_jax():
    """bf16 on the same bf16 tokens: both packages round the router's
    product from identical inputs, so they route alike (checked pair by
    pair), and the outputs agree to bf16 rounding (`_close` of
    tests/test_torch_families.py)."""
    cfg_j, cfg = _cfgs("granite-moe-1b-a400m", dtype="bfloat16")
    jp, port = _pair(cfg_j, cfg, seed=2)
    xb = torch.from_numpy(_x(cfg, 2, 16, 3)).bfloat16()
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    keep_j, eid_j, _ = _jax_keep(jp, xj, cfg_j)
    r = moe.route(port, xb.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(r.eid.numpy(), eid_j)
    np.testing.assert_array_equal(r.keep.numpy(), keep_j)
    yj, _ = jmoe_ffn(jp, xj, cfg_j)
    yt, _ = moe.moe_ffn(port, xb, cfg)
    yj = np.asarray(yj.astype(jnp.float32))
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0.05,
                               atol=0.05 * np.abs(yj).max())
