"""Norms, trace, counts, hierarchical (subtree) norms.

Reference parity (SURVEY.md C9): ``get_frob_squared``, ``get_trace``,
``get_nnz`` — post-order tree walks in the reference (SURVEY.md section
4.4), single fused reductions here.  Per-subtree norms use Morton-prefix
segment sums (the pointer-free quadtree).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from hierarchical_block_sparse_lib.core.block_matrix import BlockMatrix
from hierarchical_block_sparse_lib.core import morton


@jax.jit
def block_frob_squared(a: BlockMatrix) -> jax.Array:
    """Per-stored-block squared Frobenius norm, f32 accumulation.
    Padding blocks are all-zero by invariant -> contribute 0.  XLA
    fuses the square and the reduction into one pass over the blocks.
    """
    # Accumulate at >= f32; f64 inputs (x64 mode) stay f64 end-to-end.
    acc = jnp.promote_types(a.dtype, jnp.float32)
    return jnp.sum(jnp.square(a.data.astype(acc)), axis=(1, 2))


@jax.jit
def frob_squared(a: BlockMatrix) -> jax.Array:
    return jnp.sum(block_frob_squared(a))


def frob_norm(a: BlockMatrix) -> jax.Array:
    return jnp.sqrt(frob_squared(a))


@jax.jit
def trace(a: BlockMatrix) -> jax.Array:
    """Sum of diagonal elements: only diagonal blocks contribute."""
    is_diag = (a.ids // a.nb_cols) == (a.ids % a.nb_cols)
    block_traces = jnp.trace(a.data, axis1=-2, axis2=-1)
    return jnp.sum(jnp.where(a.valid_mask() & is_diag, block_traces, 0))


def nnz_blocks(a: BlockMatrix) -> jax.Array:
    """Stored (non-zero) leaf block count — reference `get_nnz` analogue."""
    return a.nnz


@partial(jax.jit, static_argnames=("level",))
def subtree_frob_squared(a: BlockMatrix, level: int):
    """Squared frob norm of every quadtree node at `level`.

    Returns (keys[cap], norms2[4**level]): `keys` is the level-`level`
    quadtree-node key of each stored block; `norms2[k]` the squared norm
    of node k.  Level 0 = root (== frob_squared).  This is the reference's
    per-subtree norm facility (SURVEY.md C9) as one segment-sum.
    """
    nb = max(a.nb_rows, a.nb_cols)
    depth = max(int(nb - 1).bit_length(), level)
    brow = a.ids // a.nb_cols
    bcol = a.ids % a.nb_cols
    code = morton.encode(brow, bcol)
    keys = morton.subtree_key(code, depth, level)
    keys = jnp.where(a.valid_mask(), keys, 4**level)  # trash segment
    norms2 = block_frob_squared(a)
    out = (
        jnp.zeros((4**level,), norms2.dtype).at[keys].add(norms2, mode="drop")
    )
    return keys, out


@jax.jit
def gershgorin_bound(a: BlockMatrix) -> jax.Array:
    """Upper bound on the spectral radius: max_i sum_j |A_ij| (Gershgorin).

    The scaling prerequisite for the Chebyshev recurrence and
    Newton-Schulz iterations (models/chebyshev.py, inverse_factor.py):
    spectrum(A / bound) is contained in [-1, 1]."""
    acc = jnp.promote_types(a.dtype, jnp.float32)
    row_abs = jnp.sum(jnp.abs(a.data.astype(acc)), axis=2)  # [cap,b]
    brow = jnp.where(a.valid_mask(), a.ids // a.nb_cols, a.nb_rows)
    per_row = (
        jnp.zeros((a.nb_rows + 1, a.block_size), acc)
        .at[brow]
        .add(row_abs, mode="drop")
    )[: a.nb_rows]
    return jnp.max(per_row)
