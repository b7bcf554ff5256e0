"""The port's compiler emits the same programs as the JAX package's.

The compiler is a numpy-only copy, so the packed words, value plane,
stream, row envelopes, configuration and schedule statistics must be
byte-identical.  `assert_same_program` is shared with the other twin
tests of the port's compile entry points.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import api as ref_api
from repro.core import matrices as ref_matrices
from repro_torch.core import api
from repro_torch.core import matrices

SMALL = ref_matrices.suite_names(max_n=5000)
AUTO = ["band_cz", "ckt_rajat04", "chem_bp", "hub_small"]


def assert_same_program(got, ref):
    """``got`` (the port's) and ``ref`` (the JAX package's) are the same
    program: every array bit for bit, the configuration, every schedule
    statistic but the compile time, and the same passes on ``pass_stats``
    (the ``"verify_ir"`` entry's metrics included)."""
    for field in ("instr", "val_idx", "stream", "row_lo", "row_hi", "stream_src"):
        a, b = getattr(got, field), getattr(ref, field)
        if b is None:
            assert a is None, field
            continue
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.n == ref.n and got.num_slots == ref.num_slots
    assert dataclasses.asdict(got.config) == dataclasses.asdict(ref.config)
    for f in dataclasses.fields(ref.stats):
        if f.name in ("compile_seconds", "pass_stats"):
            continue
        a, b = getattr(got.stats, f.name), getattr(ref.stats, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    passes = [(p.name, p.metrics if p.name == "verify_ir" else None)
              for p in got.stats.pass_stats or []]
    assert passes == [(p.name, p.metrics if p.name == "verify_ir" else None)
                      for p in ref.stats.pass_stats or []]


def test_small_suite_has_23_matrices():
    assert len(SMALL) == 23
    assert matrices.suite_names() == ref_matrices.suite_names()


@pytest.mark.parametrize("name", SMALL)
def test_paper_schedule_matches_reference(name):
    mat = matrices.generate(name)
    ref_mat = ref_matrices.generate(name)
    np.testing.assert_array_equal(mat.values, ref_mat.values)
    assert_same_program(api.compile(mat), ref_api.compile(ref_mat))


@pytest.mark.parametrize("name", AUTO)
def test_auto_schedule_matches_reference(name):
    got = api.compile(matrices.generate(name), schedule="auto")
    ref = ref_api.compile(ref_matrices.generate(name), schedule="auto")
    assert_same_program(got, ref)
    assert got.stats.schedule_costs == ref.stats.schedule_costs


def test_recompile_values_matches_reference():
    mat, ref_mat = matrices.generate("band_cz"), ref_matrices.generate("band_cz")
    new_vals = mat.values * 1.5
    from repro.core.csr import TriCSR as RefTriCSR
    from repro_torch.core.csr import TriCSR

    got = api.recompile_values(api.compile(mat), TriCSR(
        mat.n, mat.rowptr, mat.colidx, new_vals, "band_cz"))
    ref = ref_api.recompile_values(ref_api.compile(ref_mat), RefTriCSR(
        mat.n, mat.rowptr, mat.colidx, new_vals, "band_cz"))
    np.testing.assert_array_equal(got.stream, ref.stream)
