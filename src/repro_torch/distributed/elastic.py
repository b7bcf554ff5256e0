"""Elastic re-meshing: recompute the largest valid mesh after failures.

Policy: the "model" (TP/EP) axis is load-bearing — parameter shards assume
its exact size — so it is preserved; capacity shrinks along the DP axes
("pod" first, then "data").  The returned plan says which mesh to rebuild,
the new global batch (per-replica batch is kept constant), and whether a
checkpoint restore is required (always, after in-flight step loss).

A copy of `repro/distributed/elastic.py` (plain Python).
"""

from __future__ import annotations

import dataclasses

__all__ = ["ElasticPlan", "plan_remesh"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    chips_used: int
    chips_idle: int
    new_global_batch: int
    restore_required: bool = True

    @property
    def dp_size(self) -> int:
        out = 1
        for n, s in zip(self.axis_names, self.mesh_shape):
            if n in ("pod", "data"):
                out *= s
        return out


def plan_remesh(
    healthy_chips: int,
    model_axis: int = 16,
    chips_per_pod: int = 256,
    per_replica_batch: int = 16,
    min_data_axis: int = 1,
) -> ElasticPlan:
    """Largest (pod, data, model) mesh runnable on `healthy_chips`.

    Raises if even a single model-parallel group no longer fits.
    """
    if healthy_chips < model_axis * min_data_axis:
        raise RuntimeError(
            f"cannot re-mesh: {healthy_chips} chips < one model group "
            f"({model_axis})"
        )
    pods = max(1, healthy_chips // chips_per_pod)
    while pods > 1:
        data = chips_per_pod // model_axis
        if pods * data * model_axis <= healthy_chips:
            break
        pods -= 1
    if pods > 1:
        data = chips_per_pod // model_axis
        shape: tuple[int, ...] = (pods, data, model_axis)
        names: tuple[str, ...] = ("pod", "data", "model")
    else:
        data = max(min_data_axis, healthy_chips // model_axis)
        shape = (data, model_axis)
        names = ("data", "model")
    used = 1
    for s in shape:
        used *= s
    dp = used // model_axis
    return ElasticPlan(
        mesh_shape=shape,
        axis_names=names,
        chips_used=used,
        chips_idle=healthy_chips - used,
        new_global_batch=dp * per_replica_batch,
    )
