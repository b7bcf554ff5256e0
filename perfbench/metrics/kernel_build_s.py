"""kernel_build_s: seconds the run's process spent building the kernels'
libraries with ``nvcc`` during set-up, summed over the libraries it loaded
(`repro_torch.kernels.common.BUILD_SECONDS`, which splits a build call's
wall time over the libraries built in it, so builds that overlap count
once): 0.0 where it found them
built, None where it loaded none (the kernels' plain versions on the CPU)
or the program keeps no such count."""

import sys


def read(rec):
    common = sys.modules.get("repro_torch.kernels.common")
    secs = getattr(common, "BUILD_SECONDS", None)
    return float(sum(secs.values())) if secs else None
