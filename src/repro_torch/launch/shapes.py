"""Assigned input-shape sets (the 40-cell grid) + skip rules.  A copy of
`repro/launch/shapes.py`."""

from __future__ import annotations

import dataclasses

__all__ = ["ShapeSpec", "SHAPES", "cells", "cell_skipped"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_skipped(cfg, shape: ShapeSpec) -> str | None:
    """Returns a skip reason or None (DESIGN.md §3)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: O(L^2) at 512k — long_500k assigned to "
                "sub-quadratic archs only")
    return None


def cells(configs: list) -> list[tuple]:
    return [(c, s) for c in configs for s in SHAPES.values()]
