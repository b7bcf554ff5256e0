"""The JAX package's hypothesis strategies, copied onto the port.

`random_triangular` and `accel_config` are those of
`tests/test_sptrsv_property.py`, `packed_fields` that of
`tests/test_packed_property.py`, drawing the same values; each builds the
port's objects.  They import only the port (no jax, no ``repro``), so the
card's tests (`tests/test_torch_cuda.py`) draw them too.  `row_sweep`
plans a row-blocked sweep of any program, without the 8-row alignment of
`ops.plan_window`, so that small random programs get windows too.
"""

import numpy as np
from hypothesis import strategies as st

from repro_torch.core.csr import from_coo
from repro_torch.core.program import SRC_BITS, AccelConfig


@st.composite
def random_triangular(draw):
    n = draw(st.integers(min_value=2, max_value=90))
    seed = draw(st.integers(min_value=0, max_value=2**31 - 1))
    density = draw(st.floats(min_value=0.0, max_value=0.5))
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(1, n):
        m = rng.random(i) < density
        for j in np.nonzero(m)[0]:
            rows.append(i)
            cols.append(int(j))
    vals = rng.uniform(-1, 1, len(rows))
    diag = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
    return from_coo(n, rows, cols, vals, diag, name=f"hyp_{seed}")


@st.composite
def accel_config(draw):
    return AccelConfig(
        num_cus=draw(st.sampled_from([4, 8, 16, 64])),
        psum_words=draw(st.sampled_from([1, 2, 8])),
        xi_words=draw(st.sampled_from([8, 64])),
        num_banks=draw(st.sampled_from([8, 64])),
        icr=draw(st.booleans()),
        psum_cache=draw(st.booleans()),
        alloc=draw(st.sampled_from(["least_edges", "roundrobin"])),
        icr_window=draw(st.sampled_from([2, 16])),
    )


@st.composite
def packed_fields(draw):
    planes = draw(st.sampled_from([1, 2]))
    t = draw(st.integers(min_value=1, max_value=8))
    p = draw(st.integers(min_value=1, max_value=16))
    shape = (t, p)
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    src_hi = (1 << SRC_BITS) - 1 if planes == 1 else np.iinfo(np.int32).max
    return planes, (
        rng.integers(0, 4, shape),
        rng.integers(0, int(src_hi) + 1, shape),
        rng.integers(0, 8, shape),
        rng.integers(0, 256, shape),
    )


def row_sweep(prog, cpb):
    """``(window, stride, n_hbm)`` of the widest-stride sweep in which each
    block of ``cpb`` cycles touches only rows ``[g*stride, g*stride +
    window)``, or None where some block reaches back before its base for
    every stride >= 1."""
    g = -(-prog.cycles // cpb)
    lo = np.full(g * cpb, prog.n, np.int64)
    hi = np.full(g * cpb, -1, np.int64)
    lo[:prog.cycles], hi[:prog.cycles] = prog.row_lo, prog.row_hi
    lo, hi = lo.reshape(g, cpb).min(1), hi.reshape(g, cpb).max(1)
    live = hi >= 0
    stride = min([int(lo[i]) // i for i in range(1, g) if live[i]] or [prog.n])
    if stride < 1:
        return None
    base = np.arange(g) * stride
    window = max(int((hi[live] - base[live]).max()) + 1, 2 * stride)
    return window, stride, (g - 1) * stride + window
