"""Add / scale / transpose.

Reference parity (SURVEY.md C6/C7/C8): ``add(A,B,C)`` by structural union,
``rescale(alpha)``, ``get_transpose()``.  The structural-union tree walk
(SURVEY.md section 4.4) becomes a merge of two sorted id lists; transpose
becomes id remapping + a batched axis swap.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    compact_sorted,
)


def add_with_info(
    a: BlockMatrix,
    b: BlockMatrix,
    alpha: float | jax.Array = 1.0,
    beta: float | jax.Array = 1.0,
    cap: int | None = None,
):
    """C = alpha*A + beta*B by structural union (SURVEY.md C6).

    Returns (C, overflow): `overflow` is True iff the union exceeded
    `cap` and trailing (highest-id) blocks were dropped.
    """
    if (a.n_rows, a.n_cols) != (b.n_rows, b.n_cols):
        raise ValueError("shape mismatch")
    if a.block_size != b.block_size:
        raise ValueError("block_size mismatch")
    cap = cap if cap is not None else a.cap + b.cap
    ids = jnp.concatenate([a.ids, b.ids])
    alpha = jnp.asarray(alpha, a.dtype)
    beta = jnp.asarray(beta, b.dtype)
    data = jnp.concatenate([a.data * alpha, b.data * beta])
    out_ids, out_data, nnz = compact_sorted(ids, data, cap)
    overflow = nnz > cap
    c = BlockMatrix(
        ids=out_ids, data=out_data, nnz=jnp.minimum(nnz, cap),
        n_rows=a.n_rows, n_cols=a.n_cols, block_size=a.block_size,
    )
    return c, overflow


def add(
    a: BlockMatrix,
    b: BlockMatrix,
    alpha: float | jax.Array = 1.0,
    beta: float | jax.Array = 1.0,
    cap: int | None = None,
) -> BlockMatrix:
    """C = alpha*A + beta*B by structural union (SURVEY.md C6).

    Output capacity defaults to cap(A)+cap(B) (never overflows); with a
    bounded `cap`, use `add_with_info` to detect dropped blocks.
    """
    return add_with_info(a, b, alpha=alpha, beta=beta, cap=cap)[0]


def union_merge(c_id: jax.Array, acc_ids: jax.Array, out_cap: int):
    """Union structure of two SENTINEL-padded sorted id arrays: returns
    (out_ids, seg, pos_acc, n_unique) where seg/pos_acc map each input
    row to its union slot (SENTINEL rows -> the dropped slot `out_cap`).

    ONE argsort: each input element's union slot comes back through the
    inverse permutation (an int32 scatter) — no extra searchsorted
    passes (each a full sort).  Shared by spgemm's
    beta-accumulate bookkeeping and `make_add_plan`."""
    both = jnp.concatenate([c_id, acc_ids])
    order = jnp.argsort(both)
    uni = both[order]
    firstu = jnp.concatenate(
        [jnp.ones((1,), bool), uni[1:] != uni[:-1]]
    )
    validu = uni != SENTINEL
    slotu = jnp.where(
        validu, jnp.cumsum(firstu & validu) - 1, out_cap
    ).astype(jnp.int32)
    out_ids = (
        jnp.full((out_cap,), SENTINEL, jnp.int32)
        .at[slotu]
        .set(uni, mode="drop")
    )
    n_unique = jnp.sum(firstu & validu).astype(jnp.int32)
    # Inverse permutation: original element order[i] sits at sorted
    # position i, so its union slot is slotu[i].
    slot_orig = (
        jnp.zeros((both.shape[0],), jnp.int32).at[order].set(slotu)
    )
    seg = slot_orig[: c_id.shape[0]]
    pos_acc = slot_orig[c_id.shape[0]:]
    return out_ids, seg, pos_acc, n_unique


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AddPlan:
    """Precomputed union structure for `add_planned`: valid while both
    operands keep exactly the id arrays it was built from (data may
    change freely — the fixed-structure iteration regime).  The add then
    costs ONE scatter-add of the block data plus two id compares (the
    staleness check): no sort, no structural pass."""

    out_ids: jax.Array  # int32[cap] union ids, sorted, SENTINEL padded
    slot_in: jax.Array  # int32[capA+capB] input row -> union slot
    nnz: jax.Array  # int32[] union size (pre-clamp: > cap means dropped)
    a_ids: jax.Array  # int32[capA] the operand ids the plan was built for
    b_ids: jax.Array  # int32[capB]


def make_add_plan(
    a_ids: jax.Array, b_ids: jax.Array, cap: int
) -> AddPlan:
    """Union-structure plan for ``add_planned`` (one argsort, device)."""
    out_ids, seg, pos_acc, nnz = union_merge(a_ids, b_ids, cap)
    return AddPlan(
        out_ids=out_ids,
        slot_in=jnp.concatenate([seg, pos_acc]),
        nnz=nnz,
        a_ids=a_ids,
        b_ids=b_ids,
    )


def add_planned(
    a: BlockMatrix,
    b: BlockMatrix,
    plan: AddPlan,
    alpha: float | jax.Array = 1.0,
    beta: float | jax.Array = 1.0,
):
    """C = alpha*A + beta*B at a precomputed union structure
    (`make_add_plan` on these operands' exact ids).  Returns
    (C, overflow): overflow is True when the union exceeded the plan's
    capacity OR when either operand's ids diverged from the planned
    structure (a stale plan scatters into wrong slots — the mismatch is
    folded in here so it is never silent)."""
    cap = plan.out_ids.shape[0]
    if plan.slot_in.shape[0] != a.cap + b.cap:
        raise ValueError(
            f"plan built for capA+capB={plan.slot_in.shape[0]}, "
            f"got {a.cap}+{b.cap}"
        )
    mismatch = jnp.zeros((), bool)
    for got, want in ((a.ids, plan.a_ids), (b.ids, plan.b_ids)):
        if got.shape != want.shape:  # capacity change counts as drift
            mismatch = mismatch | jnp.ones((), bool)
        else:
            mismatch = mismatch | jnp.any(got != want)
    data = jnp.concatenate(
        [
            a.data * jnp.asarray(alpha, a.dtype),
            b.data * jnp.asarray(beta, b.dtype),
        ]
    )
    out_data = (
        jnp.zeros((cap,) + a.data.shape[1:], a.dtype)
        .at[plan.slot_in]
        .add(data, mode="drop")
    )
    c = BlockMatrix(
        ids=plan.out_ids,
        data=out_data,
        nnz=jnp.minimum(plan.nnz, cap),
        n_rows=a.n_rows,
        n_cols=a.n_cols,
        block_size=a.block_size,
    )
    return c, (plan.nnz > cap) | mismatch


def scale(a: BlockMatrix, alpha) -> BlockMatrix:
    """A <- alpha * A (reference ``rescale``, SURVEY.md C7).  Structure is
    preserved (even for alpha == 0, matching explicit-zero semantics)."""
    return a.with_data(a.data * jnp.asarray(alpha, a.dtype))


def filter_blocks(a: BlockMatrix, keep: jax.Array) -> BlockMatrix:
    """Drop stored blocks where `keep` (bool[cap]) is False; capacity is
    unchanged, survivors stay sorted at the front (structural analogue of
    truncation — same compaction, caller-supplied predicate)."""
    keep = keep & a.valid_mask()
    # Sort-free stable compaction (ids invariantly sorted); the block
    # tensor moves by one GATHER, no block scatter (see truncate).
    slot = jnp.where(keep, jnp.cumsum(keep) - 1, a.cap).astype(jnp.int32)
    src = (
        jnp.full((a.cap,), a.cap, jnp.int32)
        .at[slot]
        .set(jnp.arange(a.cap, dtype=jnp.int32), mode="drop")
    )
    ids = jnp.take(a.ids, src, mode="fill", fill_value=SENTINEL)
    data = jnp.take(a.data, src, axis=0, mode="fill", fill_value=0)
    return BlockMatrix(
        ids=ids, data=data, nnz=jnp.sum(keep).astype(jnp.int32),
        n_rows=a.n_rows, n_cols=a.n_cols, block_size=a.block_size,
    )


@partial(jax.jit, static_argnames=("strict",))
def triu(a: BlockMatrix, strict: bool = False) -> BlockMatrix:
    """Keep blocks with block_row <= block_col (< if `strict`)."""
    brow = a.ids // a.nb_cols
    bcol = a.ids % a.nb_cols
    return filter_blocks(a, (brow < bcol) if strict else (brow <= bcol))


@partial(jax.jit, static_argnames=("strict",))
def tril(a: BlockMatrix, strict: bool = False) -> BlockMatrix:
    """Keep blocks with block_row >= block_col (> if `strict`)."""
    brow = a.ids // a.nb_cols
    bcol = a.ids % a.nb_cols
    return filter_blocks(a, (brow > bcol) if strict else (brow >= bcol))


@partial(jax.jit, static_argnames=("cap",))
def symmetrize_upper(a: BlockMatrix, cap: int):
    """(S, overflow): S = upper(A) mirrored to the lower triangle
    (S_ij = A_ij for i <= j, S_ji = A_ij^T), at capacity `cap`.

    One fused concat+sort+scatter pass — replaces the
    triu -> transpose -> add chain (3 sorts + 2 data passes) that made
    symmetric purification bookkeeping-bound at small orders."""
    brow = a.ids // a.nb_cols
    bcol = a.ids % a.nb_cols
    valid = a.valid_mask()
    up = valid & (brow <= bcol)
    strict = valid & (brow < bcol)
    diag = valid & (brow == bcol)
    ids_up = jnp.where(up, a.ids, SENTINEL)
    ids_lo = jnp.where(strict, bcol * a.nb_rows + brow, SENTINEL)
    data_up = jnp.where(up[:, None, None], a.data, 0)
    # Diagonal blocks: average with their own transpose so S is exactly
    # symmetric elementwise, not just blockwise.  (A B*B^T diagonal
    # block from the GEMM is symmetric only to rounding — the (a,b) and
    # (b,a) entries sum identical products in different orders.)
    data_up = jnp.where(
        diag[:, None, None],
        0.5 * (data_up + jnp.swapaxes(data_up, -1, -2)),
        data_up,
    )
    data_lo = jnp.where(
        strict[:, None, None], jnp.swapaxes(a.data, -1, -2), 0
    )
    ids = jnp.concatenate([ids_up, ids_lo]).astype(jnp.int32)
    data = jnp.concatenate([data_up, data_lo])
    out_ids, out_data, nnz = compact_sorted(ids, data, cap)
    s = BlockMatrix(
        ids=out_ids, data=out_data, nnz=jnp.minimum(nnz, cap),
        n_rows=a.n_rows, n_cols=a.n_cols, block_size=a.block_size,
    )
    return s, nnz > cap


def transpose(a: BlockMatrix) -> BlockMatrix:
    """B = A^T (SURVEY.md C8): remap ids (brow,bcol)->(bcol,brow), re-sort,
    and swap the trailing axes of every leaf block in one batched op."""
    brow = a.ids // a.nb_cols
    bcol = a.ids % a.nb_cols
    new_ids = jnp.where(
        a.valid_mask(), bcol * a.nb_rows + brow, SENTINEL
    ).astype(jnp.int32)
    order = jnp.argsort(new_ids)
    return BlockMatrix(
        ids=new_ids[order],
        data=jnp.swapaxes(a.data[order], -1, -2),
        nnz=a.nnz,
        n_rows=a.n_cols,
        n_cols=a.n_rows,
        block_size=a.block_size,
    )
