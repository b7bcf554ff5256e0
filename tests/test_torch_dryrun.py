"""The port's dry run (`launch/dryrun.py`), its dispatch-trace analysis
(`launch/hlo_analysis.py`) and its roofline (`launch/roofline.py`).

Each case that needs a process group runs in a subprocess of its own, as
the reference's `test_dryrun_small` does, so the fake process group never
reaches another test:

  * a fake world of 8 on a (2, 4) mesh: `build_cell` and `run_cell` for the
    six families, reduced, train and decode.  Each record has the
    reference's keys, and the per-device bytes of the parameters (and, for
    train, AdamW's moments) equal the sum over the reference's
    ``abstract_params`` (and ``adamw_init``) of each leaf's bytes divided
    by the shard factor of its reference spec; the record's
    ``argument_size_in_bytes`` adds the batch (or token and cache);
  * `analyze_step`: a plain chain counts 2·m·k·n per product; on a fake
    world of 4 a replicated product counts its full FLOPs per device and a
    column-sharded one a quarter, and a sharded sum moves collective bytes;
  * `roofline.analyze_record` on a fixed record gives the reference's
    formulas with the H100 datasheet constants.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ARCHS = ["smollm-360m", "granite-moe-1b-a400m", "rwkv6-1.6b", "zamba2-2.7b",
         "whisper-base", "llama-3.2-vision-11b"]
REFERENCE_KEYS = {"arch", "shape", "mesh", "kind", "seq_len", "global_batch", "params",
                  "active_params", "lower_s", "compile_s", "memory_analysis",
                  "cost_analysis", "hlo", "collective_bytes", "devices"}

SMALL_CELL = r"""
import json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import dp_axes
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.steps import build_cell
from repro_torch.models import RuntimeFlags
from torch.distributed.device_mesh import init_device_mesh

arch, kind, out = sys.argv[1], sys.argv[2], sys.argv[3]
dryrun.fake_world(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
cfg = get_config(arch).reduced()
shape = ShapeSpec("small_" + kind, kind, 64 if kind == "train" else 128, 4)
flags = RuntimeFlags(use_kernels=False, remat=kind == "train", mesh=mesh, dp=dp_axes(mesh))
fn, args, in_plc, out_plc = build_cell(cfg, shape, mesh, flags)
parts = {"params": hlo_analysis.tensor_bytes(args[0])}
if kind == "train":
    parts["opt"] = hlo_analysis.tensor_bytes((args[1]["m"], args[1]["v"]))
parts["rest"] = hlo_analysis.tensor_bytes(args) - sum(parts.values())
assert set(in_plc[0]) == {n for n, _ in args[0].named_parameters()}
rec = dryrun.run_cell(arch, shape.name, "2x4", out, cfg=cfg, shape=shape, mesh=mesh)
print(json.dumps({"record": rec, "parts": parts}))
"""

COUNTS = r"""
import json
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import dryrun, hlo_analysis

m, k, n, p = 64, 32, 48, 16
a, b, c = (torch.empty(s, device="meta") for s in ((m, k), (k, n), (n, p)))
chain = hlo_analysis.analyze_step(lambda: (a @ b) @ c)
dryrun.fake_world(4)
mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
put = lambda t, pl: distribute_tensor(t, mesh, [Replicate(), pl], src_data_rank=None)
x = put(a, Replicate())
rep = hlo_analysis.analyze_step(lambda: x @ put(b, Replicate()))
col = hlo_analysis.analyze_step(lambda: x @ put(b, Shard(1)))
row = hlo_analysis.analyze_step(
    lambda: (x @ put(b, Shard(0))).redistribute(mesh, [Replicate(), Replicate()]))
print(json.dumps({name: dict(s, collective_bytes=s.collective_bytes) for name, s in
                  (("chain", chain), ("rep", rep), ("col", col), ("row", row))}))
"""


def _run(code, *argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code, *argv], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _reference_bytes(arch, kind):
    """Per-device bytes of the reference's parameters (and AdamW moments)
    on a 2 x 4 mesh: each leaf's bytes over its spec's shard factor."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config
    from repro.distributed import sharding as jsh
    from repro.launch.steps import abstract_params

    mesh = AbstractMesh((2, 4), ("data", "model"))
    shapes = abstract_params(get_config(arch).reduced())
    shard = jsh.param_shardings(mesh, shapes)
    total = 0
    for leaf, s in zip(jax.tree_util.tree_leaves(shapes), jax.tree_util.tree_leaves(shard)):
        factor = 1
        for entry in s.spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                factor *= dict(mesh.shape)[a] if a is not None else 1
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // factor
    return {"params": total, "opt": 2 * total if kind == "train" else 0}


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_small_mesh_cell(arch, kind, tmp_path):
    got = _run(SMALL_CELL, arch, kind, str(tmp_path))
    rec, parts = got["record"], got["parts"]
    assert REFERENCE_KEYS <= set(rec), sorted(REFERENCE_KEYS - set(rec))
    assert rec["devices"] == 8 and rec["kind"] == kind
    want = _reference_bytes(arch, kind)
    assert parts["params"] == want["params"], (parts, want)
    assert parts.get("opt", 0) == want["opt"], (parts, want)
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == sum(parts.values())
    assert "temp_size_in_bytes" not in mem and "not measured" in rec["memory_analysis_note"]
    assert rec["hlo"]["dot_flops"] > 0 and rec["hlo"]["hbm_bytes"] > 0
    assert rec["hlo"]["dynamic_trip_warnings"] == 0
    assert rec["cost_analysis"]["flops"] == rec["hlo"]["dot_flops"]
    assert rec["collective_bytes"] == pytest.approx(
        sum(v for k, v in rec["hlo"].items() if k.startswith("coll/")))
    assert (tmp_path / f"{arch}__small_{kind}__2x4.json").exists()


def test_analyze_step_counts_per_device():
    s = _run(COUNTS)
    m, k, n, p = 64, 32, 48, 16
    assert s["chain"]["dot_flops"] == 2 * m * k * n + 2 * m * n * p
    assert s["chain"]["collective_bytes"] == 0 and s["chain"]["hbm_bytes"] > 0
    assert s["rep"]["dot_flops"] == 2 * m * k * n        # every device: all of it
    assert s["col"]["dot_flops"] == 2 * m * k * n / 4    # a quarter of the columns
    assert s["col"]["collective_bytes"] == 0
    assert s["row"]["dot_flops"] == 2 * m * k * n / 4
    assert s["row"]["collective_bytes"] > 0              # the partial sums reduce
    assert s["row"]["coll/all-reduce"] == m * n * 4
    assert s["row"]["largest_collective_bytes"] == m * n * 4   # the one reduction
    assert s["chain"]["largest_collective_bytes"] == 0


RECORD = {"arch": "smollm-360m", "shape": "train_4k", "mesh": "pod", "kind": "train",
          "seq_len": 4096, "global_batch": 256, "params": 361_821_120,
          "active_params": 361_821_120, "compile_s": 1.5, "devices": 256,
          "hlo": {"dot_flops": 3.2e13, "hbm_bytes": 4.1e11}, "collective_bytes": 2.2e10,
          "memory_analysis": {"argument_size_in_bytes": 7e8, "output_size_in_bytes": 7e8}}


def test_roofline_is_the_references_with_h100_peaks(tmp_path, monkeypatch):
    from repro.launch import roofline as jroof
    from repro_torch.launch import roofline

    # the H100 SXM5 80 GB datasheet: bf16 dense, HBM3, InfiniBand NDR per GPU
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989.4e12, 3.35e12,
                                                                        50e9)
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroof, name, getattr(roofline, name))
    got, want = roofline.analyze_record(RECORD), jroof.analyze_record(RECORD)
    assert got == want
    assert got["compute_s"] == 3.2e13 / 989.4e12
    assert got["dominant"] == "collective"
    skipped = dict(RECORD, skipped="full-attention arch")
    assert roofline.analyze_record(skipped) is None
    (tmp_path / "a.json").write_text(json.dumps(RECORD))
    (tmp_path / "b.json").write_text(json.dumps(dict(RECORD, mesh="multipod")))
    rows = roofline.load_all("pod", str(tmp_path))
    assert rows == [want]
    assert roofline.to_markdown(rows) == jroof.to_markdown([want])
