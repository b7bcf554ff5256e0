"""Profiler spans inside the port's hot paths.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
``torch.profiler`` is recording, and one shared null context otherwise, so
a span left in the code costs a flag read when nothing records it;
``@spanned(name)`` puts a whole function in one.  A
recorded span lands in the profiler's trace beside the device's kernels
and copies, on the same clock: the benchmark's ``--trace 1`` runs and
`launch/profile.py` record them, and nothing else turns them on.
``python -m repro_torch.launch.profile --solve`` / ``--service`` reads them:
each span's host time and the device's idle time by the innermost span.

`NAMES` lists every span the solve path records, outermost first:

* ``serve.flush``: one `SolveService._flush`, from taking the bucket to
  the cache's stats;
* ``serve.cache_get``: `ProgramCache.get` (the LRU lookup and the hashing;
  on a miss the refresh, rehydrate or compile), holding
  ``serve.fingerprint`` (SHA-256 over the pattern) and
  ``serve.values_crc`` (CRC-32 over the values);
* ``serve.solve``: a flush's solve, from the solve closure's lookup to the
  answer on the host;
* ``exec.h2d``: the executor's entry moving a right-hand side to the
  device (`executor._to_device`);
* ``sptrsv.rhs_stage``: the kernels' zeroed, padded copy of b;
* ``sptrsv.launch``: the kernel wrapper's call (checks, output, launch).
"""

from __future__ import annotations

import contextlib
import functools

from torch.autograd import profiler

__all__ = ["span", "spanned", "NAMES"]

NAMES = ("serve.flush", "serve.cache_get", "serve.fingerprint",
         "serve.values_crc", "serve.solve", "exec.h2d", "sptrsv.rhs_stage",
         "sptrsv.launch")

_NULL = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records, else the shared null context."""
    # read through the module at every call: the profiler sets the flag
    if profiler._is_profiler_enabled:
        return profiler.record_function(name)
    return _NULL


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``,
    the gate read at the call."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
