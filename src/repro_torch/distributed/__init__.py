"""Distributed substrate of the port: failure detection, straggler policy and
elastic re-meshing (plain Python copies of the JAX package's).  The sharding
rules wait for the multi-device slice (ROADMAP Queue 1, item 4)."""

from .fault_tolerance import HeartbeatMonitor, StragglerPolicy  # noqa: F401
from .elastic import plan_remesh  # noqa: F401
