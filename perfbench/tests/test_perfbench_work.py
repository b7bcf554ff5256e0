"""The yardstick's counts, worked out by hand from n and nnz."""

import json

import pytest

from perfbench import harness, matrices, work

# n, nnz (diagonal included), FLOPs a column, bytes of one column's launch
HAND = {
    # 2 * (931,074 - 65,536) + 65,536; 931,074 * 8 + 65,537 * 4 + 2 * 65,536 * 4
    "band_jagmesh64k": (65536, 931074, 1796612, 8235028),
    # 2 * (131,359 - 32,768) + 32,768; 131,359 * 8 + 32,769 * 4 + 2 * 32,768 * 4
    "ckt_add20_32k": (32768, 131359, 229950, 1444092),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_counts_per_column(name):
    n, nnz, fl, by = HAND[name]
    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    pn, rows, _ = matrices.pattern(cfg)
    assert (pn, len(rows) + pn) == (n, nnz)
    assert work.flops(n, nnz) == fl
    assert work.bytes_moved(n, nnz) == by
    assert work.roofline_s(n, nnz) == pytest.approx(by / 3.35e12)


@pytest.mark.parametrize("name", sorted(HAND))
def test_matrix_is_read_once_a_launch(name):
    n, nnz, fl, by = HAND[name]
    assert work.flops(n, nnz, 16) == 16 * fl
    assert work.bytes_moved(n, nnz, 16) == by + 15 * 2 * n * 4


def test_roofline_takes_the_larger_bound():
    # a dense row block: FLOPs over 67 TFLOP/s outweigh bytes over 3.35 TB/s
    n, nnz = 10, 10 + 10**9
    assert work.roofline_s(n, nnz, 1000) == pytest.approx(
        work.flops(n, nnz, 1000) / work.PEAK_F32_FLOPS)
