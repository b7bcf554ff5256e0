"""Synthetic benchmark-matrix suite.

The paper evaluates 245 SuiteSparse matrices; this container is offline, so we
generate matrices spanning the same *structural archetypes* as the paper's
Table III (FEM bands, circuit Jacobians, power networks, chemical-process
chains, near-empty wide DAGs).  Every generator produces a well-conditioned
lower-triangular system (unit-ish diagonal, bounded off-diagonals) so the
f32 executor comparison against the f64 oracle stays tight.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .csr import TriCSR, from_coo

__all__ = ["SUITE", "generate", "suite_names", "paper_like_suite"]


def _finish(n, rows, cols, rng, name, scale=0.5) -> TriCSR:
    vals = rng.uniform(-scale, scale, size=len(rows))
    # diagonally dominant-ish: |diag| in [1, 2]
    diag = rng.uniform(1.0, 2.0, size=n) * rng.choice([-1.0, 1.0], size=n)
    return from_coo(n, rows, cols, vals, diag, name=name)


def banded(n: int, bandwidth: int, fill: float, seed: int, name: str) -> TriCSR:
    """FEM-style band (jagmesh / dw2048 / rdb archetype): dense-ish band,
    long dependency chains, narrow levels -> CDU-heavy."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(1, n):
        lo = max(0, i - bandwidth)
        cand = np.arange(lo, i)
        take = cand[rng.random(len(cand)) < fill]
        if len(take) == 0 and i > 0:
            take = np.array([i - 1])
        rows.extend([i] * len(take))
        cols.extend(take.tolist())
    return _finish(n, rows, cols, rng, name)


def circuit(n: int, hubs: int, avg_deg: float, seed: int, name: str) -> TriCSR:
    """Circuit-Jacobian archetype (add20 / rajat / fpga_*): a few hub columns
    consumed by many rows (power-law fan-out) + sparse random filler."""
    rng = np.random.default_rng(seed)
    hub_ids = np.sort(rng.choice(np.arange(n // 8), size=hubs, replace=False))
    rows, cols = [], []
    for i in range(1, n):
        deg = 1 + rng.poisson(max(avg_deg - 1.0, 0.1))
        picked = set()
        for _ in range(deg):
            if rng.random() < 0.45:
                h = hub_ids[rng.integers(len(hub_ids))]
                if h < i:
                    picked.add(int(h))
            else:
                span = max(1, min(i, int(n * 0.05)))
                picked.add(int(i - 1 - rng.integers(span)))
        picked.discard(i)
        for j in sorted(picked):
            rows.append(i)
            cols.append(j)
    return _finish(n, rows, cols, rng, name)


def powergrid(n: int, seed: int, name: str) -> TriCSR:
    """Power-network archetype (ACTIVSg / gemat): 2D-grid locality plus a few
    long-range ties; moderate CDU ratio."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    rows, cols = [], []
    for i in range(1, n):
        nbrs = [i - 1, i - side, i - side + 1, i - side - 1]
        for j in nbrs:
            if 0 <= j < i and rng.random() < 0.75:
                rows.append(i)
                cols.append(j)
        if rng.random() < 0.08:  # long-range tie line
            rows.append(i)
            cols.append(int(rng.integers(max(1, i))))
    return _finish(n, rows, cols, rng, name)


def chain_process(n: int, width: int, seed: int, name: str) -> TriCSR:
    """Chemical-process archetype (west / bp / bayer): block recycle streams —
    near-diagonal couplings with periodic long feedback edges -> long chains."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(1, n):
        k = 1 + rng.integers(3)
        for _ in range(k):
            j = i - 1 - rng.integers(min(i, width))
            rows.append(i)
            cols.append(int(j))
        if i % 37 == 0 and i > width * 2:
            rows.append(i)
            cols.append(int(rng.integers(i - width)))
    return _finish(n, rows, cols, rng, name)


def sparse_wide(n: int, seed: int, name: str) -> TriCSR:
    """c-36 archetype: ~0.6 off-diag nnz/row, very wide levels — the coarse
    dataflow's best case (CDU ratio ~0)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(1, n):
        if rng.random() < 0.6:
            rows.append(i)
            cols.append(int(rng.integers(i)))
    return _finish(n, rows, cols, rng, name)


def serial_chain(n: int, extra: int, seed: int, name: str) -> TriCSR:
    """Bidiagonal + a few extras: the fully-serial worst case; also the exact
    structure of a linear SSM recurrence (see DESIGN.md §1)."""
    rng = np.random.default_rng(seed)
    rows = list(range(1, n))
    cols = list(range(0, n - 1))
    for _ in range(extra):
        i = int(rng.integers(2, n))
        rows.append(i)
        cols.append(int(rng.integers(i - 1)))
    return _finish(n, rows, cols, rng, name)


def hub_wall(n_src: int, n_hubs: int, hub_deg: int, seed: int,
             name: str) -> TriCSR:
    """Pure load-imbalance stressor: n_src independent source rows followed
    by n_hubs rows each consuming hub_deg of them.  All hub inputs become
    ready simultaneously, so a coarse/medium CU must grind hub_deg serial
    MACs while most CUs idle — the case the paper's §V-E leaves open and
    `transform.split_heavy_nodes` addresses."""
    rng = np.random.default_rng(seed)
    n = n_src + n_hubs
    rows, cols = [], []
    for h in range(n_hubs):
        i = n_src + h
        take = rng.choice(np.arange(n_src), size=min(hub_deg, n_src),
                          replace=False)
        rows.extend([i] * len(take))
        cols.extend(sorted(take.tolist()))
    return _finish(n, rows, cols, rng, name)


def heavy_hub(n: int, hub_deg: int, seed: int, name: str) -> TriCSR:
    """Load-imbalance stressor (bp_200 / rajat04 archetype): a handful of rows
    carry 10-100x the average in-degree -> medium dataflow's known weak spot
    (paper §V-B), used to reproduce that negative result too."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(1, n):
        rows.append(i)
        cols.append(i - 1)
    for h in range(6):
        i = int(n * (0.35 + 0.1 * h))
        take = rng.choice(np.arange(i - 1), size=min(hub_deg, i - 1), replace=False)
        rows.extend([i] * len(take))
        cols.extend(take.tolist())
    return _finish(n, rows, cols, rng, name)


# ---------------------------------------------------------------------------
# Registry.  Sizes bracket the paper's Table III (n = 628 .. 7479) plus larger
# entries toward the 85k upper end of the 245-matrix sweep.
# ---------------------------------------------------------------------------
SUITE: dict[str, Callable[[], TriCSR]] = {}


def _reg(name: str, fn: Callable[[], TriCSR]) -> None:
    SUITE[name] = fn


def _build_suite() -> None:
    # FEM band archetypes (jagmesh4, rdb968, dw2048, bcsstm10, nnc1374, cz628)
    _reg("band_jagmesh", lambda: banded(1440, 24, 0.55, 1, "band_jagmesh"))
    _reg("band_rdb", lambda: banded(968, 28, 0.6, 2, "band_rdb"))
    _reg("band_dw2048", lambda: banded(2048, 26, 0.55, 3, "band_dw2048"))
    _reg("band_bcsstm", lambda: banded(1086, 22, 0.6, 4, "band_bcsstm"))
    _reg("band_nnc", lambda: banded(1374, 22, 0.55, 5, "band_nnc"))
    _reg("band_cz", lambda: banded(628, 24, 0.6, 6, "band_cz"))
    _reg("band_wide4k", lambda: banded(4096, 40, 0.35, 7, "band_wide4k"))
    _reg("band_big16k", lambda: banded(16384, 24, 0.4, 8, "band_big16k"))
    # toward the 85k upper end of the paper's sweep — the row-blocked
    # HBM-resident Pallas placement's target regime (DESIGN.md §1)
    _reg("band_huge64k", lambda: banded(65536, 16, 0.35, 9, "band_huge64k"))
    # circuit archetypes (add20, add32, rajat04, rajat19, fpga_*, circuit204)
    _reg("ckt_add20", lambda: circuit(2395, 24, 3.1, 11, "ckt_add20"))
    _reg("ckt_add32", lambda: circuit(4960, 20, 1.9, 12, "ckt_add32"))
    _reg("ckt_rajat04", lambda: circuit(1041, 30, 6.3, 13, "ckt_rajat04"))
    _reg("ckt_rajat19", lambda: circuit(1157, 28, 4.8, 14, "ckt_rajat19"))
    _reg("ckt_fpga", lambda: circuit(1220, 16, 3.4, 15, "ckt_fpga"))
    _reg("ckt_c204", lambda: circuit(1020, 18, 6.8, 16, "ckt_c204"))
    _reg("ckt_big8k", lambda: circuit(8192, 48, 4.0, 17, "ckt_big8k"))
    _reg("ckt_huge32k", lambda: circuit(32768, 96, 3.5, 18, "ckt_huge32k"))
    # power networks (ACTIVSg2000, gemat12, bips98)
    _reg("grid_activsg", lambda: powergrid(4000, 21, "grid_activsg"))
    _reg("grid_gemat", lambda: powergrid(4929, 22, "grid_gemat"))
    _reg("grid_bips", lambda: powergrid(7135, 23, "grid_bips"))
    _reg("grid_big20k", lambda: powergrid(20164, 24, "grid_big20k"))
    # chemical-process chains (west2021, bp_200, bayer07)
    _reg("chem_west", lambda: chain_process(2021, 40, 31, "chem_west"))
    _reg("chem_bp", lambda: chain_process(822, 25, 32, "chem_bp"))
    _reg("chem_bayer", lambda: chain_process(3268, 60, 33, "chem_bayer"))
    # wide sparse (c-36) — coarse dataflow's best case
    _reg("wide_c36", lambda: sparse_wide(7479, 41, "wide_c36"))
    _reg("wide_10k", lambda: sparse_wide(10240, 42, "wide_10k"))
    # serial chains — worst case / SSM analogue
    _reg("chain_1k", lambda: serial_chain(1024, 64, 51, "chain_1k"))
    _reg("chain_4k", lambda: serial_chain(4096, 256, 52, "chain_4k"))
    # load-imbalance stressors (paper's bp_200/rajat negative results)
    _reg("hub_small", lambda: heavy_hub(1200, 280, 61, "hub_small"))
    _reg("hub_mid", lambda: heavy_hub(3000, 700, 62, "hub_mid"))
    _reg("hub_wall", lambda: hub_wall(2048, 8, 512, 63, "hub_wall"))
    _reg("hub_wall_big", lambda: hub_wall(6144, 12, 1536, 64, "hub_wall_big"))


_build_suite()
_CACHE: dict[str, TriCSR] = {}


def generate(name: str) -> TriCSR:
    if name not in _CACHE:
        _CACHE[name] = SUITE[name]()
    return _CACHE[name]


def suite_names(max_n: int | None = None) -> list[str]:
    names = list(SUITE)
    if max_n is None:
        return names
    return [m for m in names if generate(m).n <= max_n]


def paper_like_suite() -> list[TriCSR]:
    return [generate(m) for m in suite_names()]
