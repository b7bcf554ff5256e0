"""The port's Zamba2 serving path against the JAX package's, on the CPU.

Reduced Zamba2 with ``n_layers=6`` (two groups of three Mamba2 layers, the
shared block applied twice, so the stacking over groups is exercised).
The JAX parameters (``init_params(PRNGKey(0))``) are carried across with
`params_from_jax`; the JAX path runs its Pallas kernels in interpret mode
with ``ssm_chunk=16`` and ``attn_block_q=attn_block_k=16`` (the port's scan
takes no chunk: it walks 64-row tiles, the same function).  Prefill logits,
the cache (conv state, SSM state, padded KV) and 4 greedy decode steps are
held against it at rtol/atol 1e-4 in f32, and at 0.05 in bf16 (`_close`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import RuntimeFlags as JFlags
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import (
    RuntimeFlags,
    decode_step,
    init_cache,
    init_params,
    params_from_jax,
    prefill,
)

B, S, PAD_TO, STEPS = 2, 40, 48, 4


def _close(have, want, dtype, **kw):
    """f32: rtol/atol 1e-4.  bf16: rtol 0.05 and atol 0.05 of the largest
    value: XLA keeps fused elementwise chains in f32 where eager PyTorch
    rounds every op to bf16, and over 6 layers that moves a few activations
    by several bf16 ulps (up to ~4% of the tensor's largest value)."""
    if dtype == "float32":
        np.testing.assert_allclose(have, want, rtol=1e-4, atol=1e-4, **kw)
    else:
        np.testing.assert_allclose(have, want, rtol=0.05,
                                   atol=0.05 * float(np.abs(want).max()), **kw)


def _cfgs(dtype):
    cut = lambda c: dataclasses.replace(c.reduced(), n_layers=6, dtype=dtype)
    return cut(jget_config("zamba2-2.7b")), cut(get_config("zamba2-2.7b"))


def _np(a):
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def runs(request):
    """Both packages' prefill and 4 greedy decode steps on the same weights."""
    dtype = request.param
    cfg_j, cfg = _cfgs(dtype)
    params = jinit_params(jax.random.PRNGKey(0), cfg_j)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    jflags = JFlags(use_pallas=True, interpret=True, remat=False, ssm_chunk=16,
                    attn_block_q=16, attn_block_k=16)
    flags = RuntimeFlags(use_kernels=True)

    def trace(logits, cache, step, to_np):
        out = {"logits": [to_np(logits)],
               "prefill_cache": jax.tree.map(to_np, cache)}
        for _ in range(STEPS):
            tok = np.argmax(out["logits"][0][:, -1], axis=-1)[:, None]  # JAX's choice
            logits, cache = step(tok, cache)
            out["logits"].append(to_np(logits))
        out["cache"] = jax.tree.map(to_np, cache)
        return out

    lj, cj = jprefill(params, jnp.asarray(tokens, jnp.int32), cfg_j, jflags,
                      pad_to=PAD_TO)
    ref = trace(lj, cj, lambda t, c: jdecode_step(
        params, jnp.asarray(t, jnp.int32), c, cfg_j, jflags), _np)
    # decode_step updates the cache in place: snapshot by copy
    tnp = lambda a: a if isinstance(a, int) else a.float().numpy().copy()
    lt, ct = prefill(model, torch.from_numpy(tokens), cfg, flags, pad_to=PAD_TO)
    got = trace(lt, ct, lambda t, c: decode_step(
        model, torch.from_numpy(t), c, cfg, flags), tnp)
    return dtype, ref, got


def _leaves(cache):
    return {"conv": cache["state"][0], "ssm": cache["state"][1],
            "k": cache["kv"]["k"], "v": cache["kv"]["v"], "pos": cache["pos"]}


def test_prefill_logits_match_jax(runs):
    dtype, ref, got = runs
    assert got["logits"][0].shape == (B, 1, 256)
    _close(got["logits"][0], ref["logits"][0], dtype)


@pytest.mark.parametrize("when", ["prefill_cache", "cache"])
@pytest.mark.parametrize("part", ["conv", "ssm", "k", "v", "pos"])
def test_cache_matches_jax(runs, when, part):
    dtype, ref, got = runs
    want, have = _leaves(ref[when])[part], _leaves(got[when])[part]
    if part == "pos":
        assert int(have) == int(want) == S + (STEPS if when == "cache" else 0)
        return
    assert have.shape == want.shape  # [G, P, ...] state, [G, B, PAD_TO, H, D] kv
    _close(have, want, dtype)


def test_decode_logits_match_jax(runs):
    dtype, ref, got = runs
    for step in range(1, STEPS + 1):
        _close(got["logits"][step], ref["logits"][step], dtype,
               err_msg=f"decode step {step}")


def test_kernel_and_plain_paths_agree():
    _, cfg = _cfgs("float32")
    model = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))
    outs = [prefill(model, tokens, cfg, RuntimeFlags(use_kernels=k))
            for k in (True, False)]
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(), rtol=1e-4,
                               atol=1e-4)


def test_decode_from_empty_cache_matches_prefill():
    """Decoding a prompt token by token from `init_cache` gives prefill's
    last logits (the recurrent state and the KV cache carry exactly)."""
    _, cfg = _cfgs("float32")
    model = init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (B, 6)))
    flags = RuntimeFlags(use_kernels=True)
    want, _ = prefill(model, tokens, cfg, flags)
    cache = init_cache(cfg, B, 8, device="cpu")
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(model, tokens[:, t:t + 1], cache, cfg, flags)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_init_scales_match_jax():
    """The port's seeded init draws at the reference's scales."""
    cfg_j, cfg = _cfgs("float32")
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(0), cfg_j))
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    got = {n: p.float().numpy() for n, p in model.named_parameters()}
    ref = {"emb.emb": jp["emb"]["emb"], "lm_head.w": jp["lm_head"]["w"],
           "shared.attn.wo.w": jp["shared"]["attn"]["wo"]["w"],
           "shared.mlp.w2.w": jp["shared"]["mlp"]["w2"]["w"],
           "groups.1.mamba.2.mamba.in_proj.w":
               jp["groups"]["mamba"]["mamba"]["in_proj"]["w"][1, 2],
           "groups.0.mamba.0.mamba.conv_w": jp["groups"]["mamba"]["mamba"]["conv_w"][0, 0],
           "groups.0.mamba.1.mamba.dt_bias": jp["groups"]["mamba"]["mamba"]["dt_bias"][0, 1],
           "groups.1.mamba.0.ln": jp["groups"]["mamba"]["ln"][1, 0]}
    for name, want in ref.items():
        assert got[name].shape == want.shape, name
        np.testing.assert_allclose(got[name].std(), want.std(), rtol=0.2, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(got[name].mean(), want.mean(), atol=0.2 * want.std()
                                   + 1e-6, err_msg=name)


def test_serve_main_on_cpu():
    result = serve.main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
                         "--requests", "2",
                         "--prefill-len", "20", "--decode-steps", "3"])
    assert result["requests"] == 2
    assert result["prefill_tokens_per_s"] > 0 and result["decode_tokens_per_s"] > 0
    assert len(result["sample_output"]) == 3
    assert all(0 <= t < 256 for t in result["sample_output"])
    # CPU tensors take the kernels' plain twins: no launch anywhere
    assert result["launches"] == {
        phase: {"chunked_scan_cuda": 0, "flash_attention_cuda": 0}
        for phase in ("prefill", "decode")}
