"""PyTorch/CUDA port of the SpTRSV medium-granularity dataflow system.

A second package beside the JAX reference ``repro``: the same compiler,
frontends, static analysis and `Program` format with its checksummed
on-disk form (copied, numpy only), a torch executor, and the two
VLIW-stream kernels written by hand in CUDA C++ for Hopper (`sm_90a`); and
the sequence-model serving path of the ``hybrid`` family (Zamba2: `models`,
`launch.serve`) on hand-written chunked-scan and attention kernels.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.  Nothing here imports jax or ``repro``.

    from repro_torch.core import api
    prog = api.compile(api.matrix("band_cz"))
    X = api.solve_batch(prog, B, backend="cuda")   # hand-written kernels
    pair = api.compile_pair(api.matrix("band_cz"))  # Ly=b then Lᵀx=y
    x = pair.solve(b, backend="cuda")

    python -m repro_torch.launch.serve --arch zamba2-2.7b --prefill-len 1000
"""

from . import core, kernels  # noqa: F401
