"""End-to-end training driver of the PyTorch port: a ~100M-param LM for a
few hundred steps.

    PYTHONPATH=src python examples/torch_train_lm.py                # ~100M, 300 steps
    PYTHONPATH=src python examples/torch_train_lm.py --tiny         # CI-sized
    PYTHONPATH=src python examples/torch_train_lm.py --tiny --device cpu

The port's counterpart of `examples/train_lm.py`, with its flags and
settings, through `repro_torch.launch.train`: config registry, synthetic
data pipeline, AdamW + cosine schedule + clipping, async checkpointing.
Training loss on the synthetic Markov corpus should drop from ~ln(vocab)
toward ~ln(branch)=1.39.  Without ``--device`` it runs on CUDA.

The default checkpoint directory is ``repro_torch_train_lm`` under the
temporary directory, not the reference's ``/tmp/repro_train_lm``: the
port restores the reference's checkpoints, so a shared directory would
let one example resume the other's run.
"""

import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default=None, help="torch device (CUDA by default)")
    args = ap.parse_args(argv)

    if args.tiny:
        steps = args.steps or 30
        argv = ["--arch", "smollm-360m", "--reduced", "--steps", str(steps),
                "--batch", "4", "--seq", "128", "--lr", "3e-3",
                "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "10"]
    else:
        # ~110M params (see repro_torch/configs/lm_100m.py)
        steps = args.steps or 300
        argv = ["--arch", "lm-100m", "--steps", str(steps),
                "--batch", "4", "--seq", "256", "--lr", "1e-3",
                "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
                "--log-every", "10"]
    if args.device:
        argv += ["--device", args.device]
    result = train_main(argv)
    assert result["last_loss"] < result["first_loss"], "loss must decrease"
    print("OK: loss decreased", result)
    return result


if __name__ == "__main__":
    main()
