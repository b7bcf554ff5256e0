"""§Roofline: three-term roofline from the dry-run artifacts.  Ports
`repro/launch/roofline.py`; the formulas are the reference's.

Reads build/dryrun/<arch>__<shape>__<mesh>.json (written by dryrun.py) and
derives, per cell:

    compute_s    = dot_flops_per_device / PEAK_FLOPS        (dispatch trace)
    memory_s     = hbm_bytes_per_device / HBM_BW            (eager op boundaries)
    collective_s = collective_bytes_per_device / LINK_BW

(the per-device counts make the global device factor cancel out of the
formulas).  Also reports MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference)
on ACTIVE params, the useful/counted compute ratio, the dominant term, and
an MFU-style roofline fraction:

    roofline_fraction = (model_flops/devices/PEAK) / max(terms)

The constants are the NVIDIA H100 SXM5 80 GB's DATASHEET peaks, not
measurements: 989.4 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of
HBM3, and 50 GB/s per GPU for the links: InfiniBand NDR (400 Gb/s per
GPU), because a 16-wide model axis spans two 8-GPU NVLink nodes.

Usage:  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod] [--md]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

# H100 SXM5 80 GB datasheet peaks (not measured)
PEAK_FLOPS = 989.4e12  # bf16 dense, tensor cores, per GPU
HBM_BW = 3.35e12       # bytes/s of HBM3 per GPU
LINK_BW = 50e9         # bytes/s per GPU: InfiniBand NDR (the model axis spans nodes)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")


def model_flops(rec: dict) -> float:
    n_active = rec["active_params"]
    if rec["kind"] == "train":
        tokens = rec["global_batch"] * rec["seq_len"]
        return 6.0 * n_active * tokens
    if rec["kind"] == "prefill":
        tokens = rec["global_batch"] * rec["seq_len"]
        return 2.0 * n_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_active * rec["global_batch"]


def analyze_record(rec: dict) -> dict | None:
    if "skipped" in rec:
        return None
    hlo = rec["hlo"]
    dev = rec["devices"]
    compute_s = hlo["dot_flops"] / PEAK_FLOPS
    memory_s = hlo["hbm_bytes"] / HBM_BW
    coll_s = rec["collective_bytes"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec)
    useful_ratio = mf / max(1.0, hlo["dot_flops"] * dev)
    ideal_s = mf / dev / PEAK_FLOPS
    frac = ideal_s / max(terms.values()) if max(terms.values()) > 0 else 0.0
    mem_an = rec.get("memory_analysis", {})
    hbm_gb = (mem_an.get("argument_size_in_bytes", 0)
              + mem_an.get("temp_size_in_bytes", 0)
              + mem_an.get("output_size_in_bytes", 0)) / 1e9
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"],
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s,
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": useful_ratio,
        "roofline_fraction": frac,
        "mem_gb_per_dev": hbm_gb,
        "compile_s": rec.get("compile_s"),
    }


def load_all(mesh: str | None = None, d: str | None = None) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(d or RESULTS_DIR, "*.json"))):
        rec = json.load(open(path))
        if mesh and rec.get("mesh") != mesh:
            continue
        row = analyze_record(rec)
        if row:
            out.append(row)
    return out


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute (s) | memory (s) | collective (s)"
           " | dominant | useful/compiled | roofline frac | HBM GB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    body = ""
    for r in rows:
        body += (
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2%} "
            f"| {r['mem_gb_per_dev']:.1f} |\n"
        )
    return hdr + body


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None, choices=[None, "pod", "multipod"])
    ap.add_argument("--dir", default=os.path.normpath(RESULTS_DIR))
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args()
    rows = load_all(args.mesh, args.dir)
    if args.md:
        print(to_markdown(rows))
    else:
        for r in rows:
            print(json.dumps(r))


if __name__ == "__main__":
    main()
