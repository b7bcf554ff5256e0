"""sptrsv_cuda_ns_per_cycle: the resident kernel's mean device time a
launch over the program's emitted cycles, in ns: the latency of one cycle
of the dependency chain, which the bytes roofline does not see."""


def read(rec):
    tr = rec.get("trace")
    cycles = rec.get("program_cycles")
    if tr is None or not cycles:
        return None
    launches = tr.kernels("resident_kernel")
    if not launches:
        return None
    device = sum(e - s for _, s, e in launches)
    return 1e9 * device / len(launches) / cycles
