"""sptrsv_cuda_blocked_roofline: the row-blocked kernel's share of its
roofline, reckoned as sptrsv_cuda_roofline's."""

from perfbench.metrics_common import kernel_roofline_pct


def read(rec):
    return kernel_roofline_pct(rec, "blocked_kernel")
