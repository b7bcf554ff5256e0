"""The benchmark's frozen matrices against the port's generators, and its
float64 reference against the port's float64 oracle."""

import json

import numpy as np
import pytest

from perfbench import harness, matrices, reference
from perfbench.builders import tri_csr
from repro_torch.core import api
from repro_torch.core import matrices as port_matrices
from repro_torch.core.executor import execute_numpy


def _config(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


def _split(mat):
    """The port's CSR (diagonal last in each row) as off-diagonal CSR plus
    the diagonal."""
    last = mat.rowptr[1:] - 1
    off = np.ones(mat.nnz, dtype=bool)
    off[last] = False
    rowptr = mat.rowptr - np.arange(mat.n + 1)
    return rowptr, mat.colidx[off], mat.values[off], mat.values[last]


# every configuration file that records the port's registered archetype
# it was scaled from
ARCHETYPES = sorted(
    p.stem for p in (harness.HERE / "configs").glob("*.json")
    if "archetype" in json.loads(p.read_text())["generator"])


@pytest.mark.parametrize("name", ARCHETYPES)
def test_pattern_is_the_port_generators(name):
    cfg = _config(name)
    n, rows, cols = matrices.pattern(cfg)
    rowptr, _, _ = matrices.to_csr(n, rows, cols, np.zeros(len(rows)))
    gen = cfg["generator"]
    port = getattr(port_matrices, gen["kind"])(**gen["args"], name=name)
    port_rowptr, port_cols, _, _ = _split(port)
    assert n == port.n
    np.testing.assert_array_equal(rowptr, port_rowptr)
    np.testing.assert_array_equal(cols, port_cols)


@pytest.mark.parametrize("name", ARCHETYPES)
def test_only_the_scale_departs_from_the_archetype(name):
    """The configuration's ``archetype`` is the port's registered matrix
    (the same pattern from its arguments), and the configuration keeps its
    shape (band width and fill; degree and hub share), changing only keys
    of scale, each listed in ``reduced``."""
    cfg = _config(name)
    assert cfg["name"] == name
    gen, arch = cfg["generator"], cfg["generator"]["archetype"]
    assert arch["name"] in cfg["source"]
    rows, cols = matrices.GENERATORS[gen["kind"]](**arch["args"])
    n = arch["args"]["n"]
    rowptr, _, _ = matrices.to_csr(n, np.asarray(rows), np.asarray(cols),
                                   np.zeros(len(rows)))
    port_rowptr, port_cols, _, _ = _split(port_matrices.generate(arch["name"]))
    np.testing.assert_array_equal(rowptr, port_rowptr)
    np.testing.assert_array_equal(cols, port_cols)
    changed = {k for k, v in gen["args"].items() if arch["args"][k] != v}
    assert changed == set(cfg["reduced"])
    spec = {c["name"]: c for c in harness.load_spec()["configs"]}
    assert set(spec[name]["reduced"]) == set(cfg["reduced"])
    if "hubs" in changed:
        share = arch["args"]["hubs"] / arch["args"]["n"]
        assert gen["args"]["hubs"] == round(share * gen["args"]["n"])


def test_builder_hands_the_port_the_benchmarks_arrays():
    cfg = json.loads((harness.HERE / "tests" / "data" / "band_jagmesh64k.json")
                     .read_text())
    sys_ = tri_csr.build(cfg, 2**31 + 5)
    rowptr, cols, vals, diag = _split(sys_.mat)
    for got, want in zip((rowptr, cols, vals, diag), sys_.ref):
        np.testing.assert_array_equal(got, want)
    assert sys_.nnz == sys_.mat.nnz


@pytest.mark.parametrize("name", ["band_cz", "ckt_add20", "chem_bp",
                                  "hub_small"])
def test_reference_matches_execute_numpy(name):
    mat = api.matrix(name)
    b = np.random.default_rng(3).standard_normal((mat.n, 3))
    want = execute_numpy(api.compile(mat), b)
    # the oracle sweeps in float64 over the program's value stream, which
    # holds the matrix's values (and the diagonal's inverses) in float32
    got = reference.solve(*_split(mat), b)
    assert reference.rel_err(got, want).max() < 1e-6


def test_lowered_reference_reads_as_bfloat16():
    mat = api.matrix("band_cz")
    arrays = _split(mat)
    b = np.random.default_rng(4).standard_normal((mat.n, 4))
    err = reference.rel_err(reference.solve_lowered(*arrays, b),
                            reference.solve(*arrays, b))
    assert np.all((err > 1e-4) & (err < 0.1))


def test_rel_err_reads_a_non_finite_answer_as_inf():
    x = np.ones((5, 2))
    y = x.copy()
    y[1, 1] = np.nan
    assert np.isinf(reference.rel_err(y, x)[1])
    assert reference.rel_err(y, x)[0] == 0.0
