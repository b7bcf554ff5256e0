"""setup_s: seconds from the process's start to the first timed request
(import, CUDA init, loading or building the kernels' library, making the
matrix, compiling, staging, warming this cell's widths)."""


def read(rec):
    return rec.get("setup_s")
