"""The step memory that `launch/hlo_analysis.analyze_step` measures from the
dispatch trace, and which the dry run reports as the reference's
``temp_size_in_bytes`` (`launch/dryrun.py`).

  * a hand-sized chain, two products and a GELU under backward, whose peak
    is worked out below to the byte;
  * views and in-place updates of the step's arguments count nothing, and
    ``empty``, ``empty_like`` and ``empty_strided`` count their bytes;
  * a DTensor product on a fake (2, 4) world (a subprocess of its own, so
    the process group reaches no other test) counts its local result, not
    the global shapes that DTensor's sharding propagation allocates on
    fake tensors;
  * the six families' reduced train, prefill and decode steps on no mesh:
    the tracker on meta tensors (as the dry run runs them) equals the
    tracker on CPU tensors, to the byte.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.steps import (
    extra_specs,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models import RuntimeFlags, init_cache, init_params
from repro_torch.optim import adamw_init

REPO = Path(__file__).resolve().parent.parent
ARCHS = ["smollm-360m", "granite-moe-1b-a400m", "rwkv6-1.6b", "zamba2-2.7b",
         "whisper-base", "llama-3.2-vision-11b"]
F32 = 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_hand_sized_chain_peaks_where_worked_out(device):
    b, d, h, o = 3, 5, 7, 11
    x = torch.ones(b, d, device=device)
    w1 = torch.ones(d, h, device=device, requires_grad=True)
    w2 = torch.ones(h, o, device=device, requires_grad=True)

    def step(x, w1, w2):
        (F.gelu(x @ w1) @ w2).sum().backward()

    s = hlo_analysis.analyze_step(step, x, w1, w2)
    # forward: a = x @ w1 [b, h], g = gelu(a) [b, h] (a kept for its
    # backward), y = g @ w2 [b, o] (g kept), l = y.sum() (y freed after);
    # backward: the seed ones_like(l), then y's product makes w2's gradient
    # [h, o] and g's [b, h] while a, g, l and the seed live: the peak,
    # 3 [b, h] + [h, o] + two 0-d.  gelu's backward ties it (g freed, its
    # [b, h] gradient made); w1's [d, h] gradient comes after a is freed.
    assert [n for n, _ in s.allocations] == ["mm", "gelu", "mm", "sum", "ones_like", "mm",
                                             "mm", "gelu_backward", "mm"]
    assert s.peak_bytes == F32 * (3 * b * h + h * o + 2)
    assert s.result_bytes == 0 and s.result is None
    # what the step leaves: the two gradients, on the parameters
    assert w1.grad.shape == (d, h) and w2.grad.shape == (h, o)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_views_and_updates_of_arguments_count_nothing_and_empty_counts(device):
    x = torch.ones(6, 4, device=device)
    s = hlo_analysis.analyze_step(
        lambda x: (x.t(), x.mul_(2), x[1:], x.view(24), x.add_(x)), x)
    assert s.allocations == [] and s.peak_bytes == 0 and s.result_bytes == 0
    s = hlo_analysis.analyze_step(
        lambda x: (torch.empty(7, device=device), torch.empty_like(x),
                   torch.empty_strided((2, 3), (3, 1), device=device)), x)
    assert [n for n, _ in s.allocations] == ["empty", "empty_like", "empty_strided"]
    assert s.peak_bytes == s.result_bytes == F32 * (7 + 24 + 6)
    # a storage counts once, whatever views of it the step makes or returns
    s = hlo_analysis.analyze_step(lambda x: [(y := x * 2), y.t(), y[2:], y.reshape(4, 6)], x)
    assert s.peak_bytes == s.result_bytes == F32 * 24
    # freed before the step ends: in the peak, not in the result
    s = hlo_analysis.analyze_step(lambda x: (x * 2).sum(), x)
    assert s.peak_bytes == F32 * (24 + 1) and s.result_bytes == F32


DTENSOR = r"""
import json
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import dryrun, hlo_analysis

dryrun.fake_world(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
put = lambda shape, p: distribute_tensor(torch.empty(shape, device="meta"), mesh, p,
                                         src_data_rank=None)
x = put((64, 32), [Shard(0), Replicate()])
w = put((32, 48), [Replicate(), Shard(1)])
mm = hlo_analysis.analyze_step(lambda x, w: x @ w, x, w)
full = hlo_analysis.analyze_step(
    lambda x, w: (x @ w).redistribute(mesh, [Replicate(), Replicate()]), x, w)
print(json.dumps({"mm": [mm.allocations, mm.peak_bytes, mm.result_bytes],
                  "full": [full.allocations, full.peak_bytes, full.result_bytes,
                           full.collective_bytes]}))
"""


def test_dtensor_product_counts_its_local_result():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", DTENSOR], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    local = F32 * (64 // 2) * (48 // 4)
    # the product's local [32, 12] block; DTensor's sharding propagation
    # allocates the global [64, 48] and its inputs on fake tensors, uncounted
    assert got["mm"] == [[["mm", local]], local, local]
    allocations, peak, result, coll = got["full"]
    assert result == F32 * 64 * 48                   # replicated: the whole result
    assert peak <= local + coll + sum(n for name, n in allocations if name == "cat")
    # a functional collective's result wraps its storage; its meta kernel's
    # copy takes the bytes over and adds none
    assert "_wrap_tensor_autograd" not in [name for name, _ in allocations]


def _cell(arch, kind, device, batch=2, seq=32):
    """A reduced family's step and its arguments on ``device``: on ``meta``
    as the dry run builds them, on the CPU with seeded values."""
    cfg = get_config(arch).reduced()
    flags = RuntimeFlags(use_kernels=False, remat=kind == "train")
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    model = init_params(gen, cfg, device=device, param_dtype=torch.float32)

    def tokens(n):
        if device == "meta":
            return torch.empty((batch, n), dtype=torch.long, device="meta")
        return torch.randint(0, cfg.vocab, (batch, n), generator=gen)

    extra = {k: v if device == "meta" else torch.randn(v.shape, generator=gen)
             for k, v in extra_specs(cfg, batch).items()}
    if kind == "train":
        return make_train_step(cfg, flags), (
            model, adamw_init(model), {"tokens": tokens(seq), "labels": tokens(seq), **extra})
    if kind == "prefill":
        return make_prefill_step(cfg, flags, pad_to=seq), (
            model, {"tokens": tokens(seq), **extra})
    return make_decode_step(cfg, flags), (
        model, tokens(1), init_cache(cfg, batch, seq, device=device))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_step_holds_what_the_cpu_step_holds(arch, kind):
    got = {}
    for device in ("meta", "cpu"):
        fn, args = _cell(arch, kind, device)
        s = hlo_analysis.analyze_step(fn, *args)
        updated = args[:2] if kind == "train" else ()
        got[device] = (dryrun.memory_analysis(args, s, updated), s.peak_bytes,
                       s.result_bytes)
    assert got["meta"] == got["cpu"], got
    mem, peak, result = got["cpu"]
    assert mem["temp_size_in_bytes"] == peak - result > 0
    if kind == "train":    # the outputs that are not arguments: the metrics, 0-d
        assert mem["output_size_in_bytes"] - mem["alias_size_in_bytes"] == result
        assert dryrun.device_peak_bytes(mem) == mem["argument_size_in_bytes"] + peak
