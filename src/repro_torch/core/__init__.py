"""Core library of the port: compiler, `Program` format, executors, api.

The compiler, `Program`, CSR and the matrix suite are numpy-only copies of
the JAX package's modules; `executor` and `api` run on torch.
"""

from . import api, compiler, dag, frontends, matrices  # noqa: F401
from .compiler import ComputeDag, compile_dag  # noqa: F401
from .csr import TriCSR, UpperCSR, serial_solve, serial_solve_upper  # noqa: F401
from .program import AccelConfig, Program, ScheduleStats  # noqa: F401
from .schedule import compile_program  # noqa: F401
from .executor import (  # noqa: F401
    execute_numpy,
    execute_torch,
    make_torch_executor,
    pad_batch,
)
