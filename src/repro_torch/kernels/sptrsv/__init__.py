"""SpTRSV VLIW-stream kernels for Hopper (resident and row-blocked)."""
