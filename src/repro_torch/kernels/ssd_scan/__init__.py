"""Chunked gated linear-recurrence (SSD/GLA/WKV) kernel for Hopper."""
