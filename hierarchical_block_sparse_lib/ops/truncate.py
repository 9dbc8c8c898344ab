"""Norm-based block truncation — the error-control primitive for
purification / matrix-polynomial loops (SURVEY.md C10, BASELINE.json:9).

The reference prunes subtrees whose Frobenius norm <= tau and deletes
emptied interior nodes.  Here: fused per-block norm reduction -> mask ->
in-place compaction (one sort).  Capacity is unchanged; the freed slots
become SENTINEL/zero padding, so a truncate-then-multiply loop runs at a
fixed memory footprint with zero reallocation.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib.core import morton
from hierarchical_block_sparse_lib.ops.norms import block_frob_squared


@partial(jax.jit, static_argnames=("subtree_level", "cap"))
def truncate(
    a: BlockMatrix,
    tau: float | jax.Array,
    subtree_level: int | None = None,
    cap: int | None = None,
):
    """Drop blocks with frob norm <= tau; compact storage.

    With `subtree_level` set, drops whole quadtree subtrees at that level
    whose aggregate norm is <= tau (the reference's hierarchical pruning
    semantics, SURVEY.md section 4.3); default is leaf-block truncation.

    With `cap` set, the compaction scatters directly into `cap`-sized
    storage (fusing the truncate-then-`repack` chain into ONE pass over
    the block tensor — the purification step's iterate shrinks from the
    union-support `out_cap` to the iterate `cap` every step, and writing
    the out_cap-sized intermediate was pure waste) and the return value
    becomes ``(matrix, kept)`` where `kept` is the pre-clamp survivor
    count: ``kept > cap`` means trailing (highest-id) survivors were
    dropped — the caller's repack-overflow signal.  Default (`cap=None`)
    keeps the input capacity and returns just the matrix.
    """
    # Threshold at the norm accumulation dtype (f64 under x64 mode).
    tdt = jnp.promote_types(a.dtype, jnp.float32)
    tau2 = jnp.square(jnp.asarray(tau, tdt))
    if subtree_level is None:
        keep = block_frob_squared(a) > tau2
    else:
        norms2 = block_frob_squared(a)
        nb = max(a.nb_rows, a.nb_cols)
        depth = max(int(nb - 1).bit_length(), subtree_level)
        code = morton.encode(a.ids // a.nb_cols, a.ids % a.nb_cols)
        keys = morton.subtree_key(code, depth, subtree_level)
        keys = jnp.where(a.valid_mask(), keys, 4**subtree_level)
        agg = (
            jnp.zeros((4**subtree_level + 1,), norms2.dtype)
            .at[keys]
            .add(norms2, mode="drop")
        )
        keep = agg[keys] > tau2
    keep = keep & a.valid_mask()
    # Sort-free stable compaction: ids are invariantly sorted, so the
    # surviving blocks' output slots are just cumsum(keep)-1.  The block
    # tensor moves by ONE GATHER: invert the slot map with a tiny int32
    # scatter, then `take` the data, so no block is scattered.  Out-of-
    # range `src` (padding slots, and survivors past `cap` when
    # kept > cap) fill with SENTINEL/zero — the invariant padding.
    ocap = a.cap if cap is None else cap
    icap = a.cap
    slot = jnp.where(keep, jnp.cumsum(keep) - 1, ocap).astype(jnp.int32)
    src = (
        jnp.full((ocap,), icap, jnp.int32)
        .at[slot]
        .set(jnp.arange(icap, dtype=jnp.int32), mode="drop")
    )
    out_ids = jnp.take(a.ids, src, mode="fill", fill_value=SENTINEL)
    out_data = jnp.take(a.data, src, axis=0, mode="fill", fill_value=0)
    kept = jnp.sum(keep).astype(jnp.int32)
    m = dataclasses.replace(
        a,
        ids=out_ids,
        data=out_data,
        nnz=jnp.minimum(kept, ocap),
    )
    return m if cap is None else (m, kept)
