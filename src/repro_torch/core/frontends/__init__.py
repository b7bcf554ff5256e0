"""Workload frontends: lower concrete problems onto the compiler IR.

Every frontend produces a `compiler.ComputeDag` and the staged pipeline
(`core/compiler/`) does the rest.  The port carries the lower-triangular
solve Lx=b (`sptrsv`, the paper workload) so far.
"""

from . import sptrsv  # noqa: F401
from .sptrsv import lower_tri  # noqa: F401
