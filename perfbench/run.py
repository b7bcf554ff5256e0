"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard output
(`perfbench.harness`); exits 3 without a result where the cell's CUDA
devices are missing.  The build and kernel caches stay in ``build/`` of the
checkout.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

if __name__ == "__main__":
    # import perfbench as a package, never its modules as top-level names
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for var, sub in (("CUDA_CACHE_PATH", "cuda_cache"),
                     ("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    from perfbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
