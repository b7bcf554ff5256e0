"""sptrsv_cuda_roofline: the resident kernel's share of its roofline: the
least time of the window's launches (`perfbench.work.roofline_s` of each
launch's columns, 1 in a solve loop, 1 to 16 in a service's flushes) over
their device time."""

from perfbench.metrics_common import kernel_roofline_pct


def read(rec):
    return kernel_roofline_pct(rec, "resident_kernel")
