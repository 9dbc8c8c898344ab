"""Test/benchmark matrix generators matching the reference's workloads
(SURVEY.md section 5; BASELINE.json:7-10): banded, random block-sparse,
and near-dense patterns.  Host-side (numpy) — these model the reference's
test-driver matrix builders, not a device code path.
"""

from __future__ import annotations

import numpy as np


def banded_coo(n: int, bandwidth: int, seed: int = 0, dtype=np.float32):
    """Dense band: all entries with |i-j| <= bandwidth (BASELINE.json:7)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for d in range(-bandwidth, bandwidth + 1):
        i = np.arange(max(0, -d), min(n, n - d))
        rows.append(i)
        cols.append(i + d)
    rows = np.concatenate(rows).astype(np.int32)
    cols = np.concatenate(cols).astype(np.int32)
    vals = rng.standard_normal(rows.size).astype(dtype)
    return rows, cols, vals


def random_block_sparse_coo(
    n: int,
    block_size: int,
    block_density: float,
    seed: int = 0,
    dtype=np.float32,
):
    """Uniformly random nonzero blocks, each filled dense
    (BASELINE.json:8: 5% block density)."""
    rng = np.random.default_rng(seed)
    nb = -(-n // block_size)
    n_blocks = max(1, int(round(block_density * nb * nb)))
    chosen = rng.choice(nb * nb, size=n_blocks, replace=False)
    brow, bcol = chosen // nb, chosen % nb
    b = block_size
    r_in = np.arange(b)
    rows = (brow[:, None, None] * b + r_in[None, :, None] + 0 * r_in).reshape(-1)
    cols = (bcol[:, None, None] * b + 0 * r_in[None, :, None] + r_in).reshape(-1)
    mask = (rows < n) & (cols < n)
    rows, cols = rows[mask].astype(np.int32), cols[mask].astype(np.int32)
    vals = rng.standard_normal(rows.size).astype(dtype)
    return rows, cols, vals


def dense_oracle(rows, cols, vals, n_rows: int, n_cols: int | None = None):
    n_cols = n_rows if n_cols is None else n_cols
    d = np.zeros((n_rows, n_cols), dtype=np.asarray(vals).dtype)
    np.add.at(d, (rows, cols), vals)
    return d


def block_ids_banded(n: int, bandwidth: int, block_size: int):
    """Exact stored-block count for a banded matrix (for sizing caps)."""
    nb = -(-n // block_size)
    ids = set()
    for br in range(nb):
        lo_col = max(0, br * block_size - bandwidth)
        hi_col = min(n - 1, (br + 1) * block_size - 1 + bandwidth)
        for bc in range(lo_col // block_size, hi_col // block_size + 1):
            ids.add(br * nb + bc)
    return len(ids)


def b5_mix(nb, b, band_halfwidth_blocks=1, random_density=0.002, seed=7,
           dtype=np.float32):
    """The B5 structure (BASELINE.json:11 'banded+random mix') at block
    granularity: a block band of half-width `band_halfwidth_blocks` plus a
    uniform random sprinkle of `random_density` of all blocks, on an
    nb x nb block grid of b x b blocks (values scaled by 1/b).  Returns a
    BlockMatrix."""
    import jax.numpy as jnp

    from hierarchical_block_sparse_lib.core.block_matrix import BlockMatrix

    rng = np.random.default_rng(seed)
    rows = np.arange(nb, dtype=np.int64)
    band = []
    for d in range(-band_halfwidth_blocks, band_halfwidth_blocks + 1):
        cc = rows + d
        ok = (cc >= 0) & (cc < nb)
        band.append(rows[ok] * nb + cc[ok])
    n_rand = int(random_density * nb * nb)
    rand = rng.choice(nb * nb, n_rand, replace=False)
    ids = np.unique(np.concatenate(band + [rand])).astype(np.int32)
    data = (rng.standard_normal((ids.size, b, b)) / b).astype(dtype)
    return BlockMatrix(
        ids=jnp.asarray(ids),
        data=jnp.asarray(data),
        nnz=jnp.asarray(ids.size, jnp.int32),
        n_rows=nb * b,
        n_cols=nb * b,
        block_size=b,
    )


def random_block_matrix(n, b, density, seed=0, dtype=np.float32):
    """Random block-sparse BlockMatrix built directly in block form:
    round(density * nb^2) uniformly chosen b x b blocks of standard
    normal values (BASELINE.json:8 at scale, without a COO detour)."""
    import jax.numpy as jnp

    from hierarchical_block_sparse_lib.core.block_matrix import BlockMatrix

    rng = np.random.default_rng(seed)
    nb = n // b
    n_blocks = max(1, int(round(density * nb * nb)))
    chosen = np.sort(rng.choice(nb * nb, n_blocks, replace=False))
    data = rng.standard_normal((n_blocks, b, b)).astype(dtype)
    return BlockMatrix(
        ids=jnp.asarray(chosen.astype(np.int32)),
        data=jnp.asarray(data),
        nnz=jnp.asarray(n_blocks, jnp.int32),
        n_rows=n,
        n_cols=n,
        block_size=b,
    )


def banded_block_matrix(n, bandwidth, b, seed=0):
    """Banded BlockMatrix (BASELINE.json:7): the dense band of
    `banded_coo` assembled at leaf 16 and, for b > 16, coarsened to b
    with a tight capacity."""
    from hierarchical_block_sparse_lib.core.assembly import from_coo
    from hierarchical_block_sparse_lib.ops.repack import coarsen, plan_coarsen

    r, c, v = banded_coo(n, bandwidth, seed=seed)
    base = 16 if b % 16 == 0 and b > 16 else b
    m = from_coo(r, c, v, n, block_size=base)
    if base != b:
        m = coarsen(m, b // base, cap=plan_coarsen(m, b // base))
    return m
