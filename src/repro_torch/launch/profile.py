"""Where the serving and training time goes on the card: one prefill and
one decode step of `launch/serve.py`, or one train step of
`launch/train.py`, under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch zamba2-2.7b \\
        --requests 8 --prefill-len 1000 --decode-steps 32
    PYTHONPATH=src python -m repro_torch.launch.profile --train \\
        --arch smollm-360m --batch 8 --seq 256

Takes the server's flags and runs any arch the server runs (the vlm and
encdec stubs' inputs included).  After one warm-up prefill and decode step it
profiles one more of each and prints, per phase: the host wall time, the
device's busy time (the sum of its kernels' times: one stream, so they do
not overlap) and idle share, the busy time by kind (the port's two
kernels, matrix products, copies and casts, the other elementwise work)
and the kernels that take the most device time.  ``--train`` takes the
trainer's flags instead and profiles the third train step (two warm-up
steps before it) of `train.setup`'s trainer (f32 master weights, the
config's compute dtype, AdamW, remat) and also prints
the host time of the step's phases (`steps.SPANS`: forward, backward,
clip, AdamW).  Needs a CUDA device: a CPU run has no device time.
"""

from __future__ import annotations

import collections
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve, train
from repro_torch.launch.steps import SPANS
from repro_torch.models import decode_step, prefill

__all__ = ["main", "train_main", "device_breakdown"]

KINDS = (("chunked scan kernel", ("scan_kernel",)),
         ("attention kernel", ("flash_kernel",)),
         ("matrix products", ("gemm", "Gemm", "nvjet", "cutlass", "xmma", "sm90_")),
         ("copies and casts", ("copy_kernel", "Memcpy")))
TOP = 12


def _kind(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other elementwise"


def device_breakdown(prof, wall_ms: float) -> dict:
    """Device busy time, idle share and time by kind and kernel (ms)."""
    by_name = collections.Counter()
    for evt in prof.events():
        # a profiler span also shows on the device's timeline: not a kernel
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and evt.name not in SPANS):
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    busy = sum(by_name.values())
    by_kind = collections.Counter()
    for name, ms in by_name.items():
        by_kind[_kind(name)] += ms
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "by_kind_ms": dict(by_kind.most_common()),
            "top_kernels_ms": dict(by_name.most_common(TOP))}


def _profiled(fn, spans=()):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    r = device_breakdown(prof, wall_ms)
    if spans:
        host = collections.Counter()
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CPU and evt.name in spans:
                host[evt.name] += evt.time_range.elapsed_us() / 1e3
        r["host_spans_ms"] = {name: host[name] for name in spans}
    return out, r


def _print(result: dict) -> None:
    for phase, r in result.items():
        print(f"{phase}: wall {r['wall_ms']:.3f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share {r['device_idle_share']:.4f}")
        for span, ms in r.get("host_spans_ms", {}).items():
            print(f"  host span {span:22s} {ms:10.3f} ms")
        for kind, ms in r["by_kind_ms"].items():
            print(f"  {kind:22s} {ms:10.3f} ms")
        for name, ms in r["top_kernels_ms"].items():
            print(f"    {ms:10.3f} ms  {name[:110]}")


def train_main(argv) -> dict:
    """Profiles the third step of `train.setup`'s trainer, which takes
    `launch/train.py`'s own flags."""
    tr = train.setup(train.parse_args(argv))
    if tr.device.type != "cuda":
        raise RuntimeError("profiling needs the CUDA device")
    step = lambda b: float(tr.train_step(tr.model, tr.opt_state, b)["loss"])
    for s in range(2):                                              # warm-up
        step(tr.batch(s))
    b = tr.batch(2)
    _, r = _profiled(lambda: step(b), spans=SPANS)
    result = {"train_step": r}
    _print(result)
    return result


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--train" in argv:
        argv.remove("--train")
        return train_main(argv)
    srv = serve.setup(serve.parse_args(argv))
    if srv.tokens.device.type != "cuda":
        raise RuntimeError("profiling needs the CUDA device")
    cfg, flags, model = srv.cfg, srv.flags, srv.model
    run_prefill = lambda: prefill(model, srv.tokens, cfg, flags, srv.extra,
                                  pad_to=srv.max_seq)
    logits, cache = run_prefill()                                  # warm-up
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    decode_step(model, tok, cache, cfg, flags)
    (logits, cache), pre = _profiled(run_prefill)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    _, dec = _profiled(lambda: decode_step(model, tok, cache, cfg, flags))
    result = {"prefill": pre, "decode_step": dec}
    _print(result)
    return result


if __name__ == "__main__":
    main()
