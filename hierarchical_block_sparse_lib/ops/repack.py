"""Capacity management and block-size coarsening.

`repack` changes the static storage capacity (the canonical sorted layout
makes this a slice/pad).  `coarsen` merges f x f logical blocks into one
larger block — the bridge between the reference's small CPU leaves
(16/32, BASELINE.json:7-8) and 128 tiles (SURVEY.md section 8.5
"aggregate logical leaves into 128 tiles").
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)


def plan_coarsen(a: BlockMatrix, factor: int) -> int:
    """Host-side exact coarse block count — the tight `cap` for `coarsen`.

    Capacity discipline matters beyond memory: every symbolic-phase pass
    (sorts, searchsorteds, scatters) scales with *capacity*, not nnz, so
    carrying the fine-grid cap through `coarsen` multiplies small-problem
    SpGEMM overhead (on the B1 banded config a 2284-block cap against a
    94-block tight one)."""
    ids = np.asarray(a.ids)
    ids = ids[ids != int(SENTINEL)]
    if ids.size == 0:
        return 1
    brow, bcol = ids // a.nb_cols, ids % a.nb_cols
    nbc2 = -(-a.nb_cols // factor)
    return int(np.unique((brow // factor) * nbc2 + (bcol // factor)).size)


@partial(jax.jit, static_argnames=("cap",))
def repack(a: BlockMatrix, cap: int) -> BlockMatrix:
    """Return `a` with storage capacity `cap`.

    Because storage is canonically sorted with padding at the end, growing
    pads and shrinking slices.  Shrinking below nnz drops trailing
    (highest-id) blocks — check `a.nnz <= cap` if that matters.
    """
    if cap == a.cap:
        return a
    if cap > a.cap:
        pad = cap - a.cap
        ids = jnp.concatenate([a.ids, jnp.full((pad,), SENTINEL, jnp.int32)])
        data = jnp.concatenate(
            [a.data, jnp.zeros((pad,) + a.data.shape[1:], a.dtype)]
        )
        nnz = a.nnz
    else:
        ids = a.ids[:cap]
        data = a.data[:cap]
        nnz = jnp.minimum(a.nnz, cap)
    return BlockMatrix(
        ids=ids, data=data, nnz=nnz,
        n_rows=a.n_rows, n_cols=a.n_cols, block_size=a.block_size,
    )


@partial(jax.jit, static_argnames=("factor", "cap", "track_leaves"))
def coarsen(
    a: BlockMatrix,
    factor: int,
    cap: int | None = None,
    track_leaves: bool = False,
):
    """Merge factor x factor neighborhoods of blocks into single blocks of
    size block_size*factor.  Zero-fills absent children.  `cap` defaults to
    the input capacity (coarsening never increases block count).

    With `track_leaves=True` returns (matrix, occ) where
    ``occ: bool[cap, factor, factor]`` marks which logical sub-blocks of
    each coarse tile are actually present — the per-tile occupancy mask
    that keeps leaf-granularity sparsity accounting honest after
    aggregating small reference leaves (16/32) into 128 tiles
    (SURVEY.md section 8.5; VERDICT r1 item 2).  Feed it to
    ``spgemm(..., a_leaf_occ=..., b_leaf_occ=...)`` to get the exact
    logical-leaf multiply count alongside the tile-pair count."""
    f = factor
    b = a.block_size
    cap2 = cap if cap is not None else a.cap
    nbc2 = -(-a.nb_cols // f)
    brow = a.ids // a.nb_cols
    bcol = a.ids % a.nb_cols
    new_id = jnp.where(
        a.valid_mask(), (brow // f) * nbc2 + (bcol // f), SENTINEL
    ).astype(jnp.int32)
    order = jnp.argsort(new_id)
    nid_s = new_id[order]
    first = jnp.concatenate([jnp.ones((1,), bool), nid_s[1:] != nid_s[:-1]])
    slot = jnp.cumsum(first) - 1
    slot = jnp.where(nid_s != SENTINEL, slot, cap2)
    rf = (brow % f)[order]
    cf = (bcol % f)[order]
    # Scatter each small block into its (rf, cf) position inside the big one.
    grid = (
        jnp.zeros((cap2, f, f, b, b), a.dtype)
        .at[slot, rf, cf]
        .add(a.data[order], mode="drop")
    )
    data = grid.transpose(0, 1, 3, 2, 4).reshape(cap2, f * b, f * b)
    ids = jnp.full((cap2,), SENTINEL, jnp.int32).at[slot].set(nid_s, mode="drop")
    nnz = jnp.sum(first & (nid_s != SENTINEL)).astype(jnp.int32)
    m = BlockMatrix(
        ids=ids, data=data, nnz=nnz,
        n_rows=a.n_rows, n_cols=a.n_cols, block_size=b * f,
    )
    if not track_leaves:
        return m
    # Invalid inputs route to the trash slot cap2 and are dropped.
    occ = (
        jnp.zeros((cap2, f, f), bool).at[slot, rf, cf].set(True, mode="drop")
    )
    return m, occ
