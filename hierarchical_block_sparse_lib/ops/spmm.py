"""Block-sparse x dense products (SpMM / SpMV).

Adjunct ops over the same flat representation: Y = alpha * A @ X for a
dense X (matrix or vector).  Each stored leaf block contributes one
GEMM against X's corresponding row panel; contributions accumulate
by block row with a segment scatter-add — the dense-operand analogue of
the SpGEMM numeric phase, and the building block for Chebyshev /
Lanczos-style iterations on top of the purification stack.

XLA path only: the gather of X row panels is contiguous slicing, which
XLA already fuses well; a Pallas variant would buy little here.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from hierarchical_block_sparse_lib.core.block_matrix import BlockMatrix
from hierarchical_block_sparse_lib.ops.spgemm import named_dot



@partial(jax.jit, static_argnames=("precision",))
def spmm(
    a: BlockMatrix,
    x: jax.Array,  # [n_cols, m] dense right-hand side
    alpha: float | jax.Array = 1.0,
    precision: str = "highest",
) -> jax.Array:
    """Y = alpha * A @ X (dense [n_rows, m] result)."""
    if x.shape[0] != a.n_cols:
        raise ValueError(f"shape mismatch: A is {a.n_rows}x{a.n_cols}, "
                         f"X has {x.shape[0]} rows")
    b = a.block_size
    nbr, nbc = a.nb_rows, a.nb_cols
    m = x.shape[1]
    xp = jnp.zeros((nbc * b, m), x.dtype).at[: x.shape[0]].set(x)
    xb = xp.reshape(nbc, b, m)

    brow = jnp.where(a.valid_mask(), a.ids // nbc, nbr)  # trash row nbr
    bcol = jnp.where(a.valid_mask(), a.ids % nbc, 0)
    panels = xb[bcol]  # [cap, b, m]
    prods = named_dot(
        a.data,
        panels,
        (((2,), (1,)), ((0,), (0,))),
        precision,
        jnp.promote_types(a.dtype, jnp.float32),
    )
    acc = (
        jnp.zeros((nbr + 1, b, m), prods.dtype)
        .at[brow]
        .add(prods, mode="drop")
    )[:nbr]
    y = acc.reshape(nbr * b, m)[: a.n_rows]
    return (y * jnp.asarray(alpha, y.dtype)).astype(a.dtype)


def spmv(
    a: BlockMatrix,
    x: jax.Array,  # [n_cols] dense vector
    alpha: float | jax.Array = 1.0,
    precision: str = "highest",
) -> jax.Array:
    """y = alpha * A @ x for a dense vector x."""
    return spmm(a, x[:, None], alpha=alpha, precision=precision)[:, 0]
