"""Where the serving, training and solving time goes on the card: one
prefill and one decode step of `launch/serve.py`, one train step of
`launch/train.py`, or the SpTRSV solve path, under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch zamba2-2.7b \\
        --requests 8 --prefill-len 1000 --decode-steps 32
    PYTHONPATH=src python -m repro_torch.launch.profile --train \\
        --arch smollm-360m --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.profile \\
        --solve "banded(65536, 24, 0.55, 1)"
    PYTHONPATH=src python -m repro_torch.launch.profile \\
        --service "circuit(32768, 328, 3.1, 11)" --columns 2

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

``--solve MATRIX`` profiles ``--calls`` single-RHS calls of an
`api.make_solver` closure (``backend="cuda"``), each taking its answer to
the host; ``--service MATRIX`` as many flushes of an `api.make_service`
service, each of one request of ``--columns`` columns.  MATRIX names an
entry of `core.matrices.SUITE` or calls one of that module's generators
without its name, as above.  After a warm-up it prints a call's median
wall time with no profiler, under a CPU profiler and under a CPU and CUDA
profiler (what the tracing costs; the states take turns over `ROUNDS`
rounds), what the program's spans add to a call under each profiler (every
other call keeps `spans.span` at its null context, so drift falls on both
halves alike), one empty span's cost in each state and, from one more
profile of ``--calls`` calls under the last, each span of `spans.NAMES`
(count, median host time, and its self time: less the spans inside it) and
the device's idle time a call split by the innermost span open over it
(``profile.solve`` or ``profile.flush`` where none of the program's is).  With ``--device
cpu`` (the kernels' plain versions) it runs without the card and reports
the host's numbers alone.
"""

from __future__ import annotations

import argparse
import ast
import collections
import statistics
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.core import api, matrices
from repro_torch.launch import serve, train
from repro_torch.launch.steps import SPANS
from repro_torch.models import decode_step, prefill

__all__ = ["main", "train_main", "solve_main", "device_breakdown",
           "span_times", "idle_by_span"]

KINDS = (("chunked scan kernel", ("scan_kernel",)),
         ("attention kernel", ("flash_kernel",)),
         ("matrix products", ("gemm", "Gemm", "nvjet", "cutlass", "xmma", "sm90_")),
         ("copies and casts", ("copy_kernel", "Memcpy")))
TOP = 12
ROUNDS = 4             # turns of the profiler states in ``--solve``/``--service``


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


def span_times(host) -> dict:
    """``{name: {"count", "median_ms", "self_ms"}}`` of host spans
    ``[(name, start_us, end_us)]``; ``self_ms`` is the median of each span's
    time less the spans directly inside it."""
    host = sorted(host, key=lambda h: (h[1], -h[2]))
    self_us = [e - s for _, s, e in host]
    open_ = []                                   # the spans enclosing this one
    for i, (_, s, e) in enumerate(host):
        while open_ and host[open_[-1]][2] <= s:
            open_.pop()
        if open_:
            self_us[open_[-1]] -= e - s
        open_.append(i)
    by = collections.defaultdict(lambda: ([], []))
    for (name, s, e), own in zip(host, self_us):
        by[name][0].append(e - s)
        by[name][1].append(own)
    return {name: {"count": len(t), "median_ms": statistics.median(t) / 1e3,
                   "self_ms": statistics.median(own) / 1e3}
            for name, (t, own) in by.items()}


def idle_by_span(host, device) -> dict:
    """The device's idle time (ms) from the first host span's start to the
    last one's end, by the innermost host span ``(name, start_us, end_us)``
    open over it, ``"between calls"`` where none is; ``device`` holds the
    device's operations as ``(start_us, end_us)``."""
    if not host:
        return {}
    host = sorted(host, key=lambda h: (h[1], -h[2]))
    lo, hi = host[0][1], max(e for _, _, e in host)
    busy = []
    for s, e in sorted(device):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    cuts = sorted({lo, hi} | {t for _, s, e in host for t in (s, e)}
                  | {t for iv in busy for t in iv if lo < t < hi})
    out = collections.Counter()
    j = 0
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        while j < len(busy) and busy[j][1] <= mid:
            j += 1
        if j < len(busy) and busy[j][0] <= mid:
            continue                                     # the device works
        inner = "between calls"
        for name, s, e in host:                          # the last to open
            if s <= mid < e:
                inner = name
        out[inner] += (b - a) / 1e3
    return dict(out.most_common())


def _matrix(spec: str):
    if spec in matrices.SUITE:
        return matrices.generate(spec)
    kind, _, args = spec.partition("(")
    return getattr(matrices, kind.strip())(*ast.literal_eval("(" + args),
                                           name=spec)


def _timed_calls(call, calls: range, activities=None):
    """Each call's wall time (ms), with no profiler or under one with
    ``activities``; returns ``(with spans, without)``: under a profiler
    every other call keeps the program's spans at their null context."""
    on, off = [], []
    for i in calls:
        bare = activities is not None and i % 2 == 1
        if bare:   # the flag `spans.span` reads; nothing else on the path does
            torch.autograd.profiler._set_is_profiler_enabled(False)
        t0 = time.perf_counter()
        call(i)
        (off if bare else on).append((time.perf_counter() - t0) * 1e3)
        if bare:
            torch.autograd.profiler._set_is_profiler_enabled(True)
    return on, off


def _empty_span_us(activities=None, n: int = 2000) -> float:
    def run():
        t0 = time.perf_counter()
        for _ in range(n):
            with spans.span("profile.empty"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    if activities is None:
        return run()
    with profile(activities=activities):
        return run()


def solve_main(argv) -> dict:
    """Profiles the solve path: ``--solve`` / ``--service`` (see above)."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile")
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--solve", metavar="MATRIX")
    which.add_argument("--service", metavar="MATRIX")
    ap.add_argument("--columns", type=int, default=1)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mat = _matrix(args.solve or args.service)
    dev = torch.device(args.device)
    opts = {"backend": "cuda", "device": dev}
    rng = np.random.default_rng(0)
    shape = (mat.n,) if args.solve else (mat.n, args.columns)
    rhs = [rng.standard_normal(shape).astype(np.float32)
           for _ in range(args.calls)]
    if args.solve:
        phase = "profile.solve"
        solve = api.make_solver(api.compile(mat), **opts)
        placement = solve.placement

        def call(i):
            with record_function(phase):
                solve(rhs[i]).cpu().numpy()
    else:
        phase = "profile.flush"
        svc = api.make_service({"m": mat}, max_batch=max(16, args.columns),
                               **opts)
        placement = "auto"

        def call(i):
            with record_function(phase):
                tk = svc.submit("m", rhs[i])
                svc.drain()
                tk.result()
    for i in range(3):                                             # warm-up
        call(i % args.calls)
    states = [("no profiler", None), ("CPU profiler", [ProfilerActivity.CPU])]
    if dev.type == "cuda":
        states.append(("CPU+CUDA profiler",
                       [ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    walls = {state: ([], []) for state, _ in states}
    per_round = max(2, args.calls // ROUNDS)
    for r in range(ROUNDS):
        calls = range(r * per_round, (r + 1) * per_round)
        for state, acts in states:
            if acts is None:
                on, off = _timed_calls(lambda i: call(i % args.calls), calls)
            else:
                with profile(activities=acts):
                    on, off = _timed_calls(lambda i: call(i % args.calls),
                                           calls, acts)
            walls[state][0].extend(on)
            walls[state][1].extend(off)
    wall = {state: statistics.median(on) for state, (on, _) in walls.items()}
    spans_cost = {state: wall[state] - statistics.median(off)
                  for state, (_, off) in walls.items() if off}
    empty = {state: _empty_span_us(acts) for state, acts in states}
    with profile(activities=states[-1][1]) as prof:
        for i in range(args.calls):
            call(i)
    cuda = torch.autograd.DeviceType.CUDA
    names = set(spans.NAMES) | {phase}
    host, device = [], []
    for evt in prof.events():
        if evt.device_type == cuda:
            if (not getattr(evt, "is_user_annotation", False)
                    and evt.name not in names):
                device.append((evt.time_range.start, evt.time_range.end))
        elif evt.name in names:
            host.append((evt.name, evt.time_range.start, evt.time_range.end))
    result = {"matrix": mat.name, "n": mat.n,
              "columns": 1 if args.solve else args.columns,
              "calls": args.calls, "placement": placement,
              "wall_ms": wall, "empty_span_us": empty,
              "spans_cost_ms": spans_cost, "spans": span_times(host)}
    if device:
        calls = [(s, e) for name, s, e in host if name == phase]
        result["device_busy_ms"] = sum(e - s for s, e in device) / 1e3 / len(calls)
        result["idle_ms"] = {name: ms / len(calls)
                             for name, ms in idle_by_span(host, device).items()}
    _print_solve(result, phase)
    return result


def _print_solve(r: dict, phase: str) -> None:
    print(f"{phase} {r['matrix']}: n {r['n']}, {r['columns']} column(s) a call, "
          f"{r['calls']} calls, placement {r['placement']}")
    for state, ms in r["wall_ms"].items():
        print(f"  call wall, {state:18s} {ms:10.4f} ms   empty span "
              f"{r['empty_span_us'][state]:8.3f} us")
    print(f"  {'span':22s} {'count':>6s} {'median ms':>10s} {'self ms':>10s}")
    for name, t in r["spans"].items():
        print(f"  {name:22s} {t['count']:6d} {t['median_ms']:10.4f} "
              f"{t['self_ms']:10.4f}")
    n_spans = sum(t["count"] for name, t in r["spans"].items()
                  if name in spans.NAMES) / r["calls"]
    for state, ms in r["spans_cost_ms"].items():
        print(f"  {state}: the program's {n_spans:g} spans a call cost "
              f"{ms * 1e3 / n_spans:8.3f} us each")
    if "idle_ms" in r:
        print(f"  device busy {r['device_busy_ms']:.4f} ms a call; idle a call "
              "by innermost span:")
        for name, ms in r["idle_ms"].items():
            print(f"    {name:22s} {ms:10.4f} ms")


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--solve" in argv or "--service" in argv:
        return solve_main(argv)
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
