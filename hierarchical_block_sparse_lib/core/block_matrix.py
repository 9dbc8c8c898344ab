"""The flat block-sparse matrix representation.

Reference parity: this is the flat-array replacement for the reference's
``HierarchicalBlockSparseMatrix<Treal>`` container + quadtree node storage
(SURVEY.md C1/C2; BASELINE.json:5 "quadtree node/leaf storage -> flat
block-index arrays in HBM").

Design (SURVEY.md section 8.1):

- ``ids``:   ``int32[cap]``  row-major block id ``brow * nb_cols + bcol``
             of each stored (non-zero) leaf block.  **Invariantly sorted
             ascending and unique.**  Padding entries hold ``SENTINEL``
             (int32 max) so they sort to the end.
- ``data``:  ``dtype[cap, b, b]`` dense leaf blocks.  **Padding entries
             are all-zero**, so whole-array reductions (frob, trace) are
             correct without masking.
- ``nnz``:   ``int32[]`` scalar — number of valid entries (dynamic count
             under a static capacity: the XLA-friendly sparsity idiom).

The implicit quadtree: a node at level ``l`` of the reference's quadtree
is exactly the set of stored blocks whose Morton code shares a ``2*l``-bit
prefix (see ``core.morton``).  Subtree operations (per-subtree norms,
hierarchical truncation) are prefix segment-reductions over this array —
no pointers, no recursion.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Padding id: sorts after every valid block id.  Valid ids must satisfy
# nb_rows * nb_cols < SENTINEL (checked in `make_meta`).
SENTINEL = np.int32(np.iinfo(np.int32).max)


def _static(**kw):
    return field(metadata=dict(static=True), **kw)


@dataclass(frozen=True)
class Params:
    """Construction parameters (reference: the ``Params{blocksize}`` struct,
    SURVEY.md section 6.6).  Minimal on purpose."""

    block_size: int = 128
    dtype: jnp.dtype = jnp.float32


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlockMatrix:
    """A block-sparse matrix as a flat, sorted list of dense leaf blocks."""

    ids: jax.Array  # int32[cap], sorted, SENTINEL-padded
    data: jax.Array  # dtype[cap, b, b], zero-padded
    nnz: jax.Array  # int32[] scalar
    n_rows: int = _static(default=0)
    n_cols: int = _static(default=0)
    block_size: int = _static(default=128)

    # ---- static geometry -------------------------------------------------
    @property
    def cap(self) -> int:
        return self.ids.shape[0]

    @property
    def nb_rows(self) -> int:
        return -(-self.n_rows // self.block_size)

    @property
    def nb_cols(self) -> int:
        return -(-self.n_cols // self.block_size)

    @property
    def dtype(self):
        return self.data.dtype

    # ---- id <-> (block_row, block_col) ------------------------------------
    def block_rows(self) -> jax.Array:
        """Block-row of each slot; padding slots give a large value."""
        return jnp.where(self.valid_mask(), self.ids // self.nb_cols, SENTINEL)

    def block_cols(self) -> jax.Array:
        return jnp.where(self.valid_mask(), self.ids % self.nb_cols, SENTINEL)

    def valid_mask(self) -> jax.Array:
        return self.ids != SENTINEL

    def make_id(self, brow, bcol):
        return brow * self.nb_cols + bcol

    # ---- convenience -------------------------------------------------------
    def with_data(self, data: jax.Array) -> "BlockMatrix":
        return dataclasses.replace(self, data=data)

    def density(self) -> jax.Array:
        """Fraction of blocks stored (dynamic)."""
        return self.nnz.astype(jnp.float32) / (self.nb_rows * self.nb_cols)

    def __repr__(self):  # pragma: no cover - debug aid
        return (
            f"BlockMatrix({self.n_rows}x{self.n_cols}, b={self.block_size}, "
            f"cap={self.cap}, dtype={self.data.dtype})"
        )


def check_geometry(n_rows: int, n_cols: int, block_size: int) -> None:
    nbr = -(-n_rows // block_size)
    nbc = -(-n_cols // block_size)
    if nbr * nbc >= int(SENTINEL):
        raise ValueError(
            f"block grid {nbr}x{nbc} overflows int32 id space; "
            f"use a larger block_size"
        )


@partial(jax.jit, static_argnames=("cap",))
def compact_sorted(ids: jax.Array, data: jax.Array, cap: int):
    """Sort (ids, data) rows by id, merge duplicate ids by summation, and
    pad to `cap` with SENTINEL/zeros.

    The workhorse behind assembly, add and transpose: every structural
    operation reduces to "produce (id, block) pairs, then canonicalize".
    Returns (ids[cap], data[cap, b, b], nnz).
    """
    m = ids.shape[0]
    order = jnp.argsort(ids)
    ids_s = ids[order]
    valid = ids_s != SENTINEL
    first = jnp.concatenate(
        [jnp.ones((1,), bool), ids_s[1:] != ids_s[:-1]]
    )
    # Slot per input row; duplicate ids share a slot (segment-sum merge).
    # int32 explicitly: under x64 cumsum(bool) widens to int64 and the
    # int32 scatters below would warn (future error) on the value cast.
    slot = (jnp.cumsum(first) - 1).astype(jnp.int32)
    # Invalid rows: route to the trash slot `cap` (dropped by scatter).
    slot = jnp.where(valid, slot, cap)
    out_ids = jnp.full((cap,), SENTINEL, jnp.int32).at[slot].set(
        ids_s, mode="drop"
    )
    # Scatter data straight from input order: slot_in[r] is row r's output
    # slot.  Only int32 arrays ever move through the sort/permutation —
    # the O(m * b^2) data tensor is touched exactly once (the scatter-add)
    # instead of gather-by-order + scatter (2.4x less data traffic).
    slot_in = jnp.zeros((m,), jnp.int32).at[order].set(slot)
    out_data = (
        jnp.zeros((cap,) + data.shape[1:], data.dtype)
        .at[slot_in]
        .add(data, mode="drop")
    )
    nnz = jnp.sum(first & valid).astype(jnp.int32)
    return out_ids, out_data, nnz
