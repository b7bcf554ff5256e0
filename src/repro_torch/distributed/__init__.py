"""Distributed substrate of the port: the sharding rules as DTensor
placements (`sharding`), failure detection, straggler policy and elastic
re-meshing (plain Python copies of the JAX package's)."""

from .fault_tolerance import HeartbeatMonitor, StragglerPolicy  # noqa: F401
from .elastic import plan_remesh  # noqa: F401
