"""The port's RWKV6 mixes (`repro_torch.models.rwkv6`) against the JAX
package's `repro.models.rwkv6`, alone, on the CPU, in f32.

The reference's ``init_rwkv_time_mix`` / ``init_rwkv_channel_mix``
weights, with seeded noise on the leaves it initialises to constants (the
five token-shift mixes, the decay bias, the gain, and the u-bonus, which
starts at zero and would hide the bonus term), go through both packages on
the same numpy-seeded inputs: a prompt with no state, a prompt continuing
from a carried shift and WKV state, and a one-token decode step (the scan's
direct recurrence).  The reference runs its scan in Pallas interpret mode
and on its plain path; the port on the kernel's plain twin and on its own
plain path.  Outputs and states agree at 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import RuntimeFlags as JFlags
from repro.models import rwkv6 as jrw
from repro_torch.configs import get_config
from repro_torch.models import RuntimeFlags, rwkv6

TOL = dict(rtol=1e-4, atol=1e-4)
B = 2


def _cfgs(**kw):
    cut = lambda c: dataclasses.replace(c.reduced(), **kw)
    return cut(jget_config("rwkv6-1.6b")), cut(get_config("rwkv6-1.6b"))


def _flatten(node, path=()):
    if isinstance(node, dict):
        for key, child in node.items():
            yield from _flatten(child, path + (key,))
    else:
        yield ".".join(path), node


def _load(jp, port):
    """Seeded noise on the constant leaves of ``jp``; the port holds the same."""
    rng = np.random.default_rng(7)
    out = {}
    for name, a in _flatten(jp):
        a = np.array(a, np.float32)
        if a.std() == 0:
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        out[name] = a
    port.load_state_dict({k: torch.from_numpy(v) for k, v in out.items()}, assign=True)
    nest = {}
    for name, a in out.items():
        *head, last = name.split(".")
        node = nest
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(a)
    return nest


@pytest.fixture(scope="module")
def time_mix():
    cfg_j, cfg = _cfgs()
    port = rwkv6.RWKVTimeMix(cfg, device="meta")
    jp = _load(jrw.init_rwkv_time_mix(jax.random.PRNGKey(3), cfg_j), port)
    assert float(jnp.abs(jp["u_bonus"]).max()) > 0
    return cfg_j, cfg, jp, port


def _inputs(cfg, seq, seed, state=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32)
    if not state:
        return x, None, None
    shift = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    wkv = 0.3 * rng.standard_normal((B, cfg.ssm_heads, cfg.ssm_state,
                                     cfg.ssm_state)).astype(np.float32)
    return x, shift, wkv


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("interpret", [True, False])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("seq,state", [(40, False), (37, True), (1, True), (3, False)])
def test_time_mix_matches_jax(time_mix, interpret, use_kernels, seq, state):
    cfg_j, cfg, jp, port = time_mix
    x, shift, wkv = _inputs(cfg, seq, seq, state)
    jflags = JFlags(use_pallas=interpret, interpret=True, remat=False, ssm_chunk=16)
    yj, (sj, wj) = jrw.rwkv_time_mix(jp, jnp.asarray(x), cfg_j, jflags,
                                     shift_state=_j(shift), wkv_state=_j(wkv))
    yt, (st, wt) = rwkv6.rwkv_time_mix(port, torch.from_numpy(x), cfg,
                                       RuntimeFlags(use_kernels=use_kernels),
                                       shift_state=_t(shift), wkv_state=_t(wkv))
    assert yt.shape == (B, seq, cfg.d_model) and wt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TOL)


def test_time_mix_carries_state_across_a_split(time_mix):
    """A prompt in two pieces, the state carried, equals the whole prompt."""
    _, cfg, _, port = time_mix
    x = torch.from_numpy(_inputs(cfg, 50, 9)[0])
    flags = RuntimeFlags(use_kernels=True)
    y, (s, w) = rwkv6.rwkv_time_mix(port, x, cfg, flags)
    y1, (s1, w1) = rwkv6.rwkv_time_mix(port, x[:, :29], cfg, flags)
    y2, (s2, w2) = rwkv6.rwkv_time_mix(port, x[:, 29:], cfg, flags, s1, w1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **TOL)
    torch.testing.assert_close(w2, w, **TOL)
    torch.testing.assert_close(s2, s, rtol=0, atol=0)


@pytest.mark.parametrize("seq,state", [(40, False), (5, True), (1, True)])
def test_channel_mix_matches_jax(seq, state):
    cfg_j, cfg = _cfgs()
    port = rwkv6.RWKVChannelMix(cfg, device="meta")
    jp = _load(jrw.init_rwkv_channel_mix(jax.random.PRNGKey(4), cfg_j), port)
    x, shift, _ = _inputs(cfg, seq, 11 + seq, state)
    yj, sj = jrw.rwkv_channel_mix(jp, jnp.asarray(x), shift_state=_j(shift))
    yt, st = rwkv6.rwkv_channel_mix(port, torch.from_numpy(x), shift_state=_t(shift))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rwkv_state_matches_jax(dtype):
    cfg_j, cfg = _cfgs()
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jrw.init_rwkv_state(cfg_j, 3, jdt)
    got = rwkv6.init_rwkv_state(cfg, 3, tdt, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_params_named_and_drawn_as_the_reference():
    cfg_j, cfg = _cfgs()
    jp = jrw.init_rwkv_time_mix(jax.random.PRNGKey(0), cfg_j)
    port = rwkv6.RWKVTimeMix(cfg, gen=torch.Generator().manual_seed(0), device="cpu")
    got = dict(port.named_parameters())
    want = dict(_flatten(jp))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        assert g.shape == w.shape, name
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g.std(), w.std(), rtol=5 * w.size ** -0.5,
                                       err_msg=name)
