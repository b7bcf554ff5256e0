"""Core library of the port: compiler, `Program` format, executors, api.

The compiler and its frontends, `Program`, CSR, the matrix suite, the
coarse/fine baselines, node splitting (`transform`), static analysis
(`analysis`), `serialize` and `robust.verify_program` are numpy-only
copies of the JAX package's modules; `executor` and `api` run on torch.
"""

from . import analysis, api, compiler, dag, frontends, matrices  # noqa: F401
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
from .fine import FineConfig, schedule_fine  # noqa: F401
