"""Batched serving example of the PyTorch port: prefill + decode with a KV cache.

    PYTHONPATH=src python examples/torch_serve_batch.py [--arch granite-moe-1b-a400m]
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu

The port's counterpart of `examples/serve_batch.py`: drives
`repro_torch.launch.serve` for a reduced-config model, 8 concurrent
requests, batched prefill (on a CUDA device through the hand-written
attention kernel), 32 decode steps, throughput report.  Without
``--device`` it runs on CUDA.
"""

import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--device", default=None, help="torch device (CUDA by default)")
    args = ap.parse_args(argv)
    result = serve_main([
        "--arch", args.arch, "--reduced", "--requests", "8",
        "--prefill-len", "64", "--decode-steps", "32",
    ] + (["--device", args.device] if args.device else []))
    assert result["decode_tokens_per_s"] > 0
    print("OK")
    return result


if __name__ == "__main__":
    main()
