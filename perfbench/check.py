"""The comparison that decides ``correct``.

The answers the window returned (a sample drawn from the seed) are held to
the float64 reference (`perfbench.reference.solve`) of the same arrays and
right-hand sides.  Numbers compared, each against the configuration's
``limits``:

* ``max_rel_err``: the largest per-column ``max|x - x_ref| / max|x_ref|``
  over the compared columns (``inf`` for a non-finite answer, or for no
  answer to compare at all);
* ``missing``: requests of the window whose answer never came, all of
  them, as the loop counts them;
* ``failed``: requests of the window that the program failed.
"""

from __future__ import annotations

import math

import numpy as np

from perfbench import reference

__all__ = ["compare", "BLOCK"]

BLOCK = 256  # reference columns per sweep, so that the float64 x fits


def compare(answers, ref, limits: dict, failed: int, missing: int):
    """``(correct, {name: (value, limit)})`` for ``answers`` =
    ``[(b [n, k], x [n, k] or None)]``."""
    got = [(b, x) for b, x in answers if x is not None]
    worst = math.inf
    if got and all(np.shape(x) == np.shape(b) for b, x in got):
        b_all = np.concatenate([np.asarray(b, dtype=np.float64).reshape(
            b.shape[0], -1) for b, _ in got], axis=1)
        x_all = np.concatenate([np.asarray(x).reshape(x.shape[0], -1)
                                for _, x in got], axis=1)
        worst = 0.0
        for c in range(0, b_all.shape[1], BLOCK):
            x_ref = reference.solve(*ref, b_all[:, c:c + BLOCK])
            errs = reference.rel_err(x_all[:, c:c + BLOCK], x_ref)
            worst = max(worst, float(errs.max()))
    numbers = {"max_rel_err": (worst, limits["max_rel_err"]),
               "missing": (missing, limits["missing"]),
               "failed": (failed, limits["failed"])}
    correct = all(v <= lim for v, lim in numbers.values())
    return correct, numbers
