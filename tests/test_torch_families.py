"""The port's dense, moe, ssm, encdec and vlm families against the JAX
package's, on the CPU.

Reduced configs (4 layers, d_model 64) of smollm-360m (dense, GQA),
granite-moe-1b-a400m (moe), arctic-480b (moe with the dense residual),
rwkv6-1.6b (ssm), whisper-base (encdec: a bidirectional roped encoder,
cross-attention Lq != Lk) and llama-3.2-vision-11b (vlm: cross blocks
over 16 vision tokens).  The JAX parameters (``init_params(PRNGKey(0))``)
are carried across with `params_from_jax`, after every leaf that the
reference initialises to a constant (norm gains, RWKV's mixes, decay bias
and u-bonus, which starts at zero) has had seeded noise added, so that
each of them reaches the result.  ``vision`` / ``frames`` are seeded
normal inputs, not the serving stub's zeros, so a fault in a cross block
shows.

In bf16 the moe runs pin the routing: which experts a token takes is a
discrete choice, and in bf16 it flips on rounding alone at a near-tie (XLA
keeps fused chains in f32 that eager PyTorch rounds to bf16, so the router
inputs drift by bf16 ulps; measured on granite's reduced config: layer 1,
token 35, the 2nd and 3rd experts 3.7e-4 apart at 0.255, an exact tie in
the port's bf16).  A flipped token's output is no rounding error away, so
the port's `moe.top_k` takes the reference's choices (recorded with
``jax.debug.callback``), everything else of the layer is compared, and a
separate test holds every choice the port would have made differently to a
near-tie of the reference's probabilities.  In f32 nothing is pinned.
Ties: the port's `moe.top_k` takes the lower expert first on an exact
tie, as lax.top_k does (`tests/test_torch_moe.py`); seeded f32 inputs make
exact ties improbable.  The reference runs its Pallas kernels in interpret mode for the
attention families smollm, whisper and llama-vision and for rwkv6, and its
plain path for the two moe configs.

Prefill logits, every cache leaf and 4 greedy decode steps are held
against it at rtol/atol 1e-4 in f32, and in bf16 at `_close` (0.05 of the
largest value).  Decoding a prompt token by token from `init_cache`
equals prefill for every family.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.model as jmodel
from repro.configs import get_config as jget_config
from repro.models import RuntimeFlags as JFlags
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models.layers import linear as jlinear
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models import (
    MODELS,
    RuntimeFlags,
    decode_step,
    init_cache,
    init_params,
    params_from_jax,
    prefill,
)

B, S, PAD_TO, STEPS = 2, 40, 48, 4
ARCHS = ("smollm-360m", "granite-moe-1b-a400m", "arctic-480b", "rwkv6-1.6b",
         "whisper-base", "llama-3.2-vision-11b")
INTERPRET = {"smollm-360m", "rwkv6-1.6b", "whisper-base", "llama-3.2-vision-11b"}
# a bf16 routing flip must be a near-tie of the reference's probabilities:
# 1.6% of the 0.25 an expert holds at init (measured: 1 flipped token of
# 352 on granite, gap 3.5e-4; 7 on arctic, gap at most 7.7e-4)
NEAR_TIE = 0.004


def _close(have, want, dtype, **kw):
    """f32: rtol/atol 1e-4.  bf16: rtol 0.05 and atol 0.05 of the largest
    value (XLA keeps fused elementwise chains in f32 where eager PyTorch
    rounds every op to bf16; tests/test_torch_models.py)."""
    if dtype == "float32":
        np.testing.assert_allclose(have, want, rtol=1e-4, atol=1e-4, **kw)
    else:
        np.testing.assert_allclose(have, want, rtol=0.05,
                                   atol=0.05 * float(np.abs(want).max()), **kw)


def _cfgs(arch, dtype="float32"):
    cut = lambda c: dataclasses.replace(c.reduced(), dtype=dtype)
    return cut(jget_config(arch)), cut(get_config(arch))


def _extra(cfg, seed=0):
    """Seeded normal stand-ins for the stubbed modality frontends."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"vision": rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)}
    return {}


def _jax_params(cfg_j, seed=0):
    """The reference's init with seeded noise on its constant leaves."""
    rng = np.random.default_rng(seed + 100)

    def perturb(a):
        a = np.array(a, np.float32)
        if a.size > 1 and a.std() == 0:
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree.map(perturb, jinit_params(jax.random.PRNGKey(0), cfg_j))


def _flat(node, path=""):
    """{path: leaf} of a cache (dicts and tuples)."""
    if isinstance(node, dict):
        out = {}
        for key, child in node.items():
            out.update(_flat(child, f"{path}/{key}"))
        return out
    if isinstance(node, (tuple, list)):
        out = {}
        for i, child in enumerate(node):
            out.update(_flat(child, f"{path}/{i}"))
        return out
    return {path: node}


def _np(a):
    return np.asarray(a, np.float32)


def _tnp(a):
    # decode_step updates the cache in place: snapshot by copy
    return a if isinstance(a, int) else a.float().numpy().copy()


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def runs(request):
    """Both packages' prefill and 4 greedy decode steps on the same weights."""
    arch, dtype = request.param
    cfg_j, cfg = _cfgs(arch, dtype)
    params = _jax_params(cfg_j)
    model = params_from_jax(params, cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    extra = _extra(cfg)
    jflags = JFlags(use_pallas=arch in INTERPRET, interpret=True, remat=False,
                    ssm_chunk=16, attn_block_q=16, attn_block_k=16)
    flags = RuntimeFlags(use_kernels=True)

    def trace(logits, cache, step, to_np):
        out = {"logits": [to_np(logits)], "prefill_cache": _flat(jax.tree.map(
            to_np, cache, is_leaf=lambda a: isinstance(a, (int, torch.Tensor))))}
        for _ in range(STEPS):
            tok = np.argmax(out["logits"][0][:, -1], axis=-1)[:, None]  # JAX's choice
            logits, cache = step(tok, cache)
            out["logits"].append(to_np(logits))
        out["cache"] = _flat(jax.tree.map(
            to_np, cache, is_leaf=lambda a: isinstance(a, (int, torch.Tensor))))
        return out

    pin = cfg.family == "moe" and dtype == "bfloat16"
    routes, flips = [], []
    jparams = jax.tree.map(jnp.asarray, params)
    with pytest.MonkeyPatch.context() as mp:
        if pin:
            mp.setattr(jmodel, "moe_ffn", _recording_moe_ffn(routes))
        lj, cj = jprefill(jparams, jnp.asarray(tokens, jnp.int32), cfg_j, jflags,
                          {k: jnp.asarray(v) for k, v in extra.items()}, pad_to=PAD_TO)
        ref = trace(lj, cj, lambda t, c: jdecode_step(
            jparams, jnp.asarray(t, jnp.int32), c, cfg_j, jflags), _np)
    with pytest.MonkeyPatch.context() as mp:
        if pin:
            mp.setattr(moe, "top_k", _pinned_top_k(list(routes), flips))
        lt, ct = prefill(model, torch.from_numpy(tokens), cfg, flags,
                         {k: torch.from_numpy(v) for k, v in extra.items()},
                         pad_to=PAD_TO)
        got = trace(lt, ct, lambda t, c: decode_step(
            model, torch.from_numpy(t), c, cfg, flags), _tnp)
    if pin:
        assert len(routes) == cfg.n_layers * (1 + STEPS) and not routes[len(flips):]
    got["flips"] = flips
    return cfg, ref, got


def _recording_moe_ffn(routes):
    """The reference's `moe_ffn`, also recording each call's router
    probabilities and top-k experts (computed as it computes them)."""
    orig = jmodel.moe_ffn

    def recording(p, x, cfg, flags=None, dropless=False):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(jlinear(p["router"], xt).astype(jnp.float32), axis=-1)
        top_e = jax.lax.top_k(probs, cfg.moe_topk)[1]
        jax.debug.callback(lambda pr, te: routes.append((np.asarray(pr), np.asarray(te))),
                           probs, top_e, ordered=True)
        return orig(p, x, cfg, flags, dropless)

    return recording


def _pinned_top_k(routes, flips):
    """`moe.top_k` taking the reference's experts, call by call; records
    per call the reference's probabilities and experts and the port's own
    choice."""
    def pinned(probs, k):
        ref_probs, ref_e = routes.pop(0)
        flips.append((ref_probs, ref_e, torch.topk(probs, k, dim=-1)[1].numpy()))
        e = torch.from_numpy(np.asarray(ref_e, np.int64))
        return probs.gather(-1, e), e

    return pinned


def test_moe_routing_differs_only_at_near_ties(runs):
    """Where the bf16 port would choose other experts than the reference,
    the reference's probabilities of the two choices are within
    `NEAR_TIE` of each other (and in f32 nothing is pinned)."""
    cfg, _, got = runs
    if cfg.family != "moe" or cfg.dtype == "float32":
        assert got["flips"] == []
        return
    worst = 0.0
    for ref_probs, ref_e, own_e in got["flips"]:
        for t in range(len(ref_e)):
            theirs, mine = set(ref_e[t]), set(own_e[t])
            if theirs == mine:
                continue
            gap = (min(ref_probs[t, list(theirs - mine)])
                   - max(ref_probs[t, list(mine - theirs)]))
            worst = max(worst, gap)
    assert worst <= NEAR_TIE, worst


def test_prefill_logits_match_jax(runs):
    cfg, ref, got = runs
    assert got["logits"][0].shape == (B, 1, cfg.vocab)
    _close(got["logits"][0], ref["logits"][0], cfg.dtype)


@pytest.mark.parametrize("when", ["prefill_cache", "cache"])
def test_every_cache_leaf_matches_jax(runs, when):
    cfg, ref, got = runs
    want, have = ref[when], got[when]
    assert sorted(have) == sorted(want)
    for path, w in want.items():
        h = have[path]
        if path == "/pos":
            assert int(h) == int(w) == S + (STEPS if when == "cache" else 0)
            continue
        assert h.shape == w.shape, path
        _close(h, w, cfg.dtype, err_msg=path)


def test_decode_logits_match_jax(runs):
    cfg, ref, got = runs
    for step in range(1, STEPS + 1):
        _close(got["logits"][step], ref["logits"][step], cfg.dtype,
               err_msg=f"decode step {step}")


def test_cache_layout(runs):
    """The leaves each family keeps, with the reference's stacking."""
    cfg, _, got = runs
    c = got["prefill_cache"]
    kv = (B, PAD_TO, cfg.n_kv_heads, cfg.hd)
    want = {
        "dense": {"/kv/k": (cfg.n_layers, *kv)},
        "moe": {"/kv/k": (cfg.n_layers, *kv)},
        "encdec": {"/kv/k": (cfg.n_layers, *kv),
                   "/_enc_out": (B, cfg.enc_frames, cfg.d_model)},
        "vlm": {"/kv/k": (cfg.n_layers // 2, 1, *kv),
                "/cross_kv/k": (cfg.n_layers // 2, B, cfg.vision_tokens,
                                cfg.n_kv_heads, cfg.hd),
                "/_vis_embed": (B, cfg.vision_tokens, cfg.d_model)},
        "ssm": {"/state/0": (cfg.n_layers, B, 1, cfg.d_model),
                "/state/1": (cfg.n_layers, B, cfg.ssm_heads, cfg.ssm_state,
                             cfg.ssm_state),
                "/state/2": (cfg.n_layers, B, 1, cfg.d_model)},
    }[cfg.family]
    for path, shape in want.items():
        assert c[path].shape == shape, path


def _prompt(cfg, seed, length=6):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (B, length)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_empty_cache_matches_prefill(arch):
    """Decoding a prompt token by token from `init_cache` gives prefill's
    last logits; vlm's cross KV and encdec's encoder output come from a
    prefill's cache (they do not depend on the tokens)."""
    _, cfg = _cfgs(arch)
    model = init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    tokens = _prompt(cfg, 2)
    extra = {k: torch.from_numpy(v) for k, v in _extra(cfg, 2).items()}
    flags = RuntimeFlags(use_kernels=True)
    want, full = prefill(model, tokens, cfg, flags, extra)
    cache = init_cache(cfg, B, 8, device="cpu")
    for leaf in ("cross_kv", "_enc_out"):
        if leaf in cache:
            cache[leaf] = full[leaf]
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(model, tokens[:, t:t + 1], cache, cfg, flags)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    assert cache["pos"] == tokens.shape[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_and_plain_paths_agree(arch):
    _, cfg = _cfgs(arch)
    model = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    tokens = _prompt(cfg, 1, S)
    extra = {k: torch.from_numpy(v) for k, v in _extra(cfg, 1).items()}
    outs = [prefill(model, tokens, cfg, RuntimeFlags(use_kernels=k), extra)[0]
            for k in (True, False)]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_names_shapes_and_scales(arch):
    """The port's seeded init holds the reference's parameters (names after
    unstacking, shapes) drawn at the reference's scales."""
    cfg_j, cfg = _cfgs(arch)
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(0), cfg_j))
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert isinstance(model, MODELS[cfg.family])
    got = {n: p.float().numpy() for n, p in model.named_parameters()}
    want = {n: p.float().numpy() for n, p in
            params_from_jax(jp, cfg, device="cpu").named_parameters()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        if w.size < 256:
            continue
        # two draws of n values: their stds and means agree to ~n^-0.5 of
        # the std; 5 of those (a wrong scale is off by 40% or more)
        tol = 5 * w.size ** -0.5
        np.testing.assert_allclose(got[name].std(), w.std(), rtol=tol, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(got[name].mean(), w.mean(), atol=tol * w.std()
                                   + 1e-6, err_msg=name)


def test_params_from_jax_refuses_another_family():
    _, cfg = _cfgs("smollm-360m")
    cfg_j, _ = _cfgs("rwkv6-1.6b")
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(0), cfg_j))
    with pytest.raises(ValueError, match="parameter names differ"):
        params_from_jax(jp, cfg, device="cpu")
    with pytest.raises(ValueError, match="family"):
        MODELS["dense"](get_config("rwkv6-1.6b").reduced(), device="meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(arch):
    result = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--requests", "2", "--prefill-len", "12",
                         "--decode-steps", "3"])
    assert result["requests"] == 2 and len(result["sample_output"]) == 3
    assert all(0 <= t < 256 for t in result["sample_output"])
    assert result["launches"] == {
        phase: {"chunked_scan_cuda": 0, "flash_attention_cuda": 0}
        for phase in ("prefill", "decode")}
