"""Element assembly / extraction.

Reference parity (SURVEY.md C3): ``assign_from_vectors(rows, cols, values)``,
``get_values``, ``get_all_values``.  The reference descends the quadtree
per element (SURVEY.md section 4.1 — O(nnz * depth) pointer chasing); here
assembly is one vectorized sort-by-block-id + segment scatter.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    check_geometry,
    compact_sorted,
)


def empty(
    n_rows: int,
    n_cols: int,
    block_size: int,
    cap: int,
    dtype=jnp.float32,
) -> BlockMatrix:
    """All-zero matrix with storage capacity for `cap` blocks."""
    check_geometry(n_rows, n_cols, block_size)
    return BlockMatrix(
        ids=jnp.full((cap,), SENTINEL, jnp.int32),
        data=jnp.zeros((cap, block_size, block_size), dtype),
        nnz=jnp.zeros((), jnp.int32),
        n_rows=n_rows,
        n_cols=n_cols,
        block_size=block_size,
    )


def eye(n: int, block_size: int, dtype=jnp.float32, cap: int | None = None):
    """Identity matrix: one dense diagonal block per block-row."""
    check_geometry(n, n, block_size)
    nb = -(-n // block_size)
    cap = cap if cap is not None else nb
    ids = jnp.concatenate(
        [
            jnp.arange(nb, dtype=jnp.int32) * (nb + 1),
            jnp.full((cap - nb,), SENTINEL, jnp.int32),
        ]
    )
    block = jnp.eye(block_size, dtype=dtype)
    # Trim trailing diagonal entries that fall outside n (padded edge).
    row_in = jnp.arange(block_size)[:, None] + jnp.arange(nb)[:, None, None] * block_size
    edge_mask = (row_in < n).astype(dtype)
    diag = block[None] * edge_mask
    data = jnp.concatenate(
        [diag, jnp.zeros((cap - nb, block_size, block_size), dtype)]
    )
    return BlockMatrix(
        ids=ids,
        data=data,
        nnz=jnp.asarray(nb, jnp.int32),
        n_rows=n,
        n_cols=n,
        block_size=block_size,
    )


@partial(jax.jit, static_argnames=("n_rows", "n_cols", "block_size", "cap"))
def _from_coo_jit(rows, cols, vals, n_rows, n_cols, block_size, cap):
    b = block_size
    nbc = -(-n_cols // b)
    valid = vals == vals  # all true; hook for future masked assembly
    bid = jnp.where(
        valid, (rows // b) * nbc + (cols // b), SENTINEL
    ).astype(jnp.int32)
    order = jnp.argsort(bid)
    bid_s = bid[order]
    rows_s = rows[order]
    cols_s = cols[order]
    vals_s = vals[order]
    first = jnp.concatenate([jnp.ones((1,), bool), bid_s[1:] != bid_s[:-1]])
    slot = jnp.cumsum(first) - 1
    slot = jnp.where(bid_s != SENTINEL, slot, cap)
    ids = jnp.full((cap,), SENTINEL, jnp.int32).at[slot].set(bid_s, mode="drop")
    data = (
        jnp.zeros((cap, b, b), vals.dtype)
        .at[slot, rows_s % b, cols_s % b]
        .add(vals_s, mode="drop")
    )
    nnz = jnp.sum(first & (bid_s != SENTINEL)).astype(jnp.int32)
    return ids, data, nnz


def from_coo(
    rows,
    cols,
    vals,
    n_rows: int,
    n_cols: int | None = None,
    block_size: int = 128,
    cap: int | None = None,
) -> BlockMatrix:
    """Build from COO triplets (duplicate entries sum).

    Reference parity: ``assign_from_vectors`` (SURVEY.md C3, section 4.1).
    `cap` defaults to the exact number of touched blocks (computed on
    host); pass it explicitly inside jit.
    """
    n_cols = n_rows if n_cols is None else n_cols
    check_geometry(n_rows, n_cols, block_size)
    rows = jnp.asarray(rows, jnp.int32)
    cols = jnp.asarray(cols, jnp.int32)
    vals = jnp.asarray(vals)
    if cap is None:
        b = block_size
        nbc = -(-n_cols // b)
        bid = (np.asarray(rows) // b) * nbc + np.asarray(cols) // b
        cap = max(int(np.unique(bid).size), 1)
    ids, data, nnz = _from_coo_jit(
        rows, cols, vals, n_rows, n_cols, block_size, cap
    )
    return BlockMatrix(
        ids=ids, data=data, nnz=nnz,
        n_rows=n_rows, n_cols=n_cols, block_size=block_size,
    )


def from_dense(
    x, block_size: int = 128, cap: int | None = None, threshold: float = 0.0
) -> BlockMatrix:
    """Blockify a dense matrix, storing blocks with frob norm > threshold."""
    x = jnp.asarray(x)
    n_rows, n_cols = x.shape
    check_geometry(n_rows, n_cols, block_size)
    b = block_size
    nbr, nbc = -(-n_rows // b), -(-n_cols // b)
    xp = jnp.zeros((nbr * b, nbc * b), x.dtype).at[:n_rows, :n_cols].set(x)
    blocks = xp.reshape(nbr, b, nbc, b).transpose(0, 2, 1, 3).reshape(-1, b, b)
    acc = jnp.promote_types(blocks.dtype, jnp.float32)
    norms2 = jnp.sum(jnp.square(blocks.astype(acc)), axis=(1, 2))
    keep = norms2 > jnp.asarray(threshold, acc) ** 2
    all_ids = jnp.arange(nbr * nbc, dtype=jnp.int32)
    ids = jnp.where(keep, all_ids, SENTINEL)
    blocks = jnp.where(keep[:, None, None], blocks, 0)
    if cap is None:
        cap = max(int(jnp.sum(keep)), 1)
    out_ids, out_data, nnz = compact_sorted(ids, blocks, cap)
    return BlockMatrix(
        ids=out_ids, data=out_data, nnz=nnz,
        n_rows=n_rows, n_cols=n_cols, block_size=block_size,
    )


@jax.jit
def to_dense(a: BlockMatrix) -> jax.Array:
    """Densify (the test oracle path; SURVEY.md section 5)."""
    b = a.block_size
    nbr, nbc = a.nb_rows, a.nb_cols
    brow = jnp.where(a.valid_mask(), a.ids // nbc, nbr)  # trash row nbr
    bcol = jnp.where(a.valid_mask(), a.ids % nbc, 0)
    grid = (
        jnp.zeros((nbr + 1, nbc, b, b), a.dtype)
        .at[brow, bcol]
        .add(a.data, mode="drop")
    )[:nbr]
    full = grid.transpose(0, 2, 1, 3).reshape(nbr * b, nbc * b)
    return full[: a.n_rows, : a.n_cols]


@jax.jit
def to_coo(a: BlockMatrix):
    """All stored elements as (rows, cols, vals, mask) — reference
    ``get_all_values`` (SURVEY.md C3).  Length cap*b*b; `mask` marks
    entries belonging to valid blocks inside the logical bounds."""
    b = a.block_size
    brow = a.ids // a.nb_cols
    bcol = a.ids % a.nb_cols
    r_in = jnp.arange(b, dtype=jnp.int32)
    rows = (brow[:, None, None] * b + r_in[None, :, None]).astype(jnp.int32)
    cols = (bcol[:, None, None] * b + r_in[None, None, :]).astype(jnp.int32)
    mask = (
        a.valid_mask()[:, None, None]
        & (rows < a.n_rows)
        & (cols < a.n_cols)
    )
    rows = jnp.where(mask, rows, 0)
    cols = jnp.where(mask, cols, 0)
    return (
        rows.reshape(-1),
        cols.reshape(-1),
        a.data.reshape(-1),
        mask.reshape(-1),
    )


@partial(jax.jit, static_argnames=("chunk",))
def _coo_window(a: BlockMatrix, start, chunk: int):
    """Fixed-size window of `to_coo` starting at block slot `start`.
    One compiled program serves every chunk (dynamic_slice clamps the
    start near the end; slots before `start` are masked out so the
    clamped window never re-emits blocks)."""
    b = a.block_size
    ids = jax.lax.dynamic_slice(a.ids, (start,), (chunk,))
    data = jax.lax.dynamic_slice(a.data, (start, 0, 0), (chunk, b, b))
    slot = jnp.minimum(start, a.cap - chunk) + jnp.arange(chunk)
    brow = ids // a.nb_cols
    bcol = ids % a.nb_cols
    r_in = jnp.arange(b, dtype=jnp.int32)
    rows = (brow[:, None, None] * b + r_in[None, :, None]).astype(jnp.int32)
    cols = (bcol[:, None, None] * b + r_in[None, None, :]).astype(jnp.int32)
    mask = (
        ((slot >= start) & (slot < a.nnz))[:, None, None]
        & (ids != SENTINEL)[:, None, None]
        & (rows < a.n_rows)
        & (cols < a.n_cols)
    )
    rows = jnp.where(mask, rows, 0)
    cols = jnp.where(mask, cols, 0)
    return (
        rows.reshape(-1),
        cols.reshape(-1),
        data.reshape(-1),
        mask.reshape(-1),
    )


def to_coo_chunks(a: BlockMatrix, chunk_blocks: int = 2048, drop_zeros=False):
    """Stream stored elements to host as (rows, cols, vals) numpy chunks.

    The streaming counterpart of `to_coo` for huge matrices (reference
    ``get_all_values``, SURVEY.md C3): peak host memory is one
    `chunk_blocks * b^2` window instead of four `cap * b^2` arrays
    (~92M triplets for a B5-order export).  Chunks arrive mask-filtered
    (padding slots and out-of-bounds elements removed); `drop_zeros`
    additionally removes explicit zeros inside stored blocks.
    """
    nnz = int(a.nnz)
    chunk = min(chunk_blocks, a.cap)
    for s in range(0, nnz, chunk):
        r, c, v, m = _coo_window(a, jnp.asarray(s, jnp.int32), chunk)
        m = np.asarray(m)
        if drop_zeros:
            m = m & (np.asarray(v) != 0)
        yield np.asarray(r)[m], np.asarray(c)[m], np.asarray(v)[m]


@jax.jit
def get_values(a: BlockMatrix, rows, cols) -> jax.Array:
    """Random-access element reads (reference ``get_values``, SURVEY.md C3).

    Binary search over the sorted id array; absent blocks read as zero.
    """
    rows = jnp.asarray(rows, jnp.int32)
    cols = jnp.asarray(cols, jnp.int32)
    b = a.block_size
    bid = (rows // b) * a.nb_cols + cols // b
    pos = jnp.searchsorted(a.ids, bid, method="sort")
    pos_c = jnp.minimum(pos, a.cap - 1)
    hit = a.ids[pos_c] == bid
    vals = a.data[pos_c, rows % b, cols % b]
    return jnp.where(hit, vals, 0)
