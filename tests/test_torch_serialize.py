"""The port's `Program` serialization against the JAX package's.

Twins tests/test_serialize.py: round-trip fidelity, the corruption
contract (targeted defects and the seeded k-byte corruption sweep, each
raising `ProgramCorruptionError` with the JAX package's message), the
load-time structural verify, and the cross-format contract: both packages
write the same ``SPTRSVPG`` bytes for the same program, and a blob saved
by either loads in the other.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import api as ref_api
from repro.core import serialize as ref_serialize
from repro.core.errors import ProgramCorruptionError as RefCorruption
from repro.core.robust import FaultInjector
from repro_torch.core import api, serialize
from repro_torch.core.csr import from_coo, random_rhs, transpose_upper
from repro_torch.core.errors import ProgramCorruptionError
from repro_torch.core.frontends import random_circuit
from repro_torch.core.matrices import generate
from repro_torch.core.program import ScheduleStats
from test_torch_compiler import assert_same_program


def tiny_matrix(n: int = 24, seed: int = 3):
    """A small random lower-tri system — keeps blobs byte-cheap."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(1, n):
        for j in rng.choice(i, size=min(i, int(rng.integers(1, 4))), replace=False):
            rows.append(i), cols.append(int(j))
    vals = rng.standard_normal(len(rows)) * 0.3
    diag = rng.standard_normal(n) + 4.0
    return from_coo(n, rows, cols, vals, diag, name=f"tiny{n}")


@pytest.fixture(scope="module")
def prog():
    return api.compile(generate("band_cz"))


KINDS = ["lower", "lower_auto", "pair_forward", "pair_backward", "upper",
         "circuit", "split", "coarse", "tiny"]


@pytest.fixture(scope="module")
def programs():
    """A program of every compile entry point of the port, by kind."""
    mat = generate("ckt_rajat04")
    pair = api.compile_pair(generate("band_cz"))
    out = {
        "lower": api.compile(mat),
        "lower_auto": api.compile(generate("hub_small"), schedule="auto"),
        "pair_forward": pair.forward.program,
        "pair_backward": pair.backward.program,
        "upper": api.compile_upper(transpose_upper(mat)).program,
        "circuit": api.compile_circuit(random_circuit(500, seed=2, locality=40)).program,
        "split": api.compile_split(generate("hub_wall"), max_indegree=48)[0],
        "coarse": api.baseline_coarse(generate("chem_bp")),
        "tiny": api.compile(tiny_matrix()),
    }
    assert sorted(out) == sorted(KINDS)
    return out


@pytest.fixture(scope="module")
def tiny_blob(programs):
    return serialize.dumps_program(programs["tiny"])


# ------------------------------------------------------------- round trip
def test_roundtrip_bit_exact(prog, tmp_path):
    path = tmp_path / "band_cz.prog"
    api.save_program(prog, path)
    p2 = api.load_program(path)
    for name in ("instr", "val_idx", "stream", "row_lo", "row_hi"):
        np.testing.assert_array_equal(getattr(prog, name), getattr(p2, name))
    assert p2.config == prog.config
    assert (p2.n, p2.num_slots) == (prog.n, prog.num_slots)
    assert p2.content_crc32() == prog.content_crc32()
    for f in dataclasses.fields(ScheduleStats):
        if f.name in ("per_cu_edges", "pass_stats"):
            continue
        assert getattr(p2.stats, f.name) == getattr(prog.stats, f.name), f.name
    np.testing.assert_array_equal(p2.stats.per_cu_edges, prog.stats.per_cu_edges)
    assert p2.stats.pass_stats is None  # compile-run telemetry, not artifact
    b = random_rhs(generate("band_cz"), seed=1)
    np.testing.assert_array_equal(api.solve_numpy(prog, b), api.solve_numpy(p2, b))


def test_roundtrip_without_row_metadata(prog):
    stripped = dataclasses.replace(prog, row_lo=None, row_hi=None)
    p2 = serialize.loads_program(serialize.dumps_program(stripped))
    assert p2.row_lo is None and p2.row_hi is None


def test_loaded_program_solves_to_the_same_bits(programs, tmp_path):
    """Compile once, save, load with verification, solve: the same x, bit
    for bit, as the in-memory program on the kernels' plain versions."""
    backward = programs["pair_backward"]
    path = tmp_path / "backward.prog"
    api.save_program(backward, path)
    loaded = api.load_program(path, verify=True)
    b = np.random.default_rng(3).standard_normal((backward.n, 4))
    kw = dict(backend="cuda", device="cpu")
    np.testing.assert_array_equal(api.solve_batch(loaded, b, **kw),
                                  api.solve_batch(backward, b, **kw))


# ------------------------------------------------------------- cross format
@pytest.mark.parametrize("kind", KINDS)
def test_blobs_match_and_cross_load(programs, kind, tmp_path):
    port_prog = programs[kind]
    blob = serialize.dumps_program(port_prog)
    ref_prog = ref_serialize.loads_program(blob)           # port -> reference
    assert ref_serialize.dumps_program(ref_prog) == blob   # same bytes back
    back = serialize.loads_program(ref_serialize.dumps_program(ref_prog))
    assert_same_program(back, ref_prog)                    # reference -> port
    path = tmp_path / "p.prog"
    ref_api.save_program(ref_prog, path)
    assert_same_program(api.load_program(path), ref_prog)
    assert port_prog.content_crc32() == ref_prog.content_crc32()


def test_reference_compiles_to_the_same_blob():
    """Both packages compile ckt_rajat04 to the same bytes on disk, but for
    the header's compile time, which is the compile run's own."""
    ref = ref_api.compile(ref_api.matrix("ckt_rajat04"))
    got = api.compile(generate("ckt_rajat04"))
    got = dataclasses.replace(got, stats=dataclasses.replace(
        got.stats, compile_seconds=ref.stats.compile_seconds))
    assert serialize.dumps_program(got) == ref_serialize.dumps_program(ref)


# ------------------------------------------------------------- targeted defects
def test_bad_magic_version_truncation(prog):
    blob = serialize.dumps_program(prog)
    with pytest.raises(ProgramCorruptionError, match="magic"):
        serialize.loads_program(b"NOTPROG!" + blob[8:])
    bad_ver = blob[:8] + (99).to_bytes(4, "little") + blob[12:]
    with pytest.raises(ProgramCorruptionError, match="version"):
        serialize.loads_program(bad_ver)
    with pytest.raises(ProgramCorruptionError, match="truncated"):
        serialize.loads_program(blob[:10])
    with pytest.raises(ProgramCorruptionError, match="truncated|length"):
        serialize.loads_program(blob[:len(blob) // 2])
    with pytest.raises(ProgramCorruptionError, match="length"):
        serialize.loads_program(blob + b"\x00")


def test_corruption_is_a_valueerror(prog):
    """Taxonomy leaves keep the historical builtin for old callers."""
    blob = serialize.dumps_program(prog)
    with pytest.raises(ValueError):
        serialize.loads_program(blob[:10])


def test_load_verifies_structure(programs, tmp_path):
    """CRC-clean but structurally corrupt content is stopped at load, with
    the JAX package's message."""
    bad = FaultInjector(5).corrupt_stream(programs["tiny"], k=1, mode="nan")
    path = tmp_path / "bad.prog"
    serialize.save_program(bad, path)  # checksums computed over bad bytes
    with pytest.raises(ProgramCorruptionError, match="non-finite") as got:
        api.load_program(path)
    with pytest.raises(RefCorruption) as want:
        ref_api.load_program(path)
    assert str(got.value) == str(want.value)
    assert got.value.detail == want.value.detail
    p2 = api.load_program(path, verify=False)  # opt-out parses fine
    assert np.isnan(p2.stream).any()


# ------------------------------------------------------------- random corruption
def _flip_k_bytes(blob: bytes, k: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    buf = bytearray(blob)
    for i in rng.integers(len(buf), size=k):
        buf[int(i)] ^= int(rng.integers(1, 256))
    return bytes(buf)


def _same_refusal(bad: bytes) -> None:
    with pytest.raises(ProgramCorruptionError) as got:
        serialize.loads_program(bad)
    with pytest.raises(RefCorruption) as want:
        ref_serialize.loads_program(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("seed", range(12))
def test_any_byte_corruption_detected(tiny_blob, k, seed):
    """save -> flip k random bytes -> load raises ProgramCorruptionError,
    with the message the JAX package gives for the same bytes."""
    _same_refusal(_flip_k_bytes(tiny_blob, k, seed))


def test_any_byte_corruption_detected_hypothesis(tiny_blob):
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=60, deadline=None)
    @given(st.integers(1, 8), st.integers(0, 2**31 - 1))
    def run(k, seed):
        _same_refusal(_flip_k_bytes(tiny_blob, k, seed))

    run()
