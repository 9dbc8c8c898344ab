"""Occupancy-aware leaf-strip packing SpGEMM.

The reference's leaves are small (16/32, BASELINE.json:7-8).  Aggregating
them into 128 tiles (`ops.repack.coarsen`) preserves correctness but
pays for every zero leaf inside a tile: on the B1 banded config the
tile-pair FLOPs are 7.0x the honest leaf-pair FLOPs (counted from the
plans).  This
module is the "aggregate logical leaves into 128 tiles WITHOUT destroying
sparsity wins" path (SURVEY.md section 8.5; VERDICT r2 item 1):

1. Partition block-rows of the FINE matrix into strips of ``f`` leaf rows
   (f*b_fine = 128, one 128 tile tall).
2. Per strip, **pack the occupied leaf columns** (union over the strip's
   rows) into a dense ``[128, La*b_fine]`` panel — zero leaves between
   band diagonals are never materialized, only the panel-padding to the
   per-strip maximum La survives.
3. Gather the matching B leaf rows/cols into a dense
   ``[La*b_fine, Lc*b_fine]`` panel the same way.
4. ONE batched dense GEMM over all strips computes every C leaf in
   the strip — no segment accumulation at all (the dense panel product
   IS the sum over k).
5. Scatter panel leaves back to the exact fine-grained C structure
   (computed at plan time, identical to the pair-enumeration structure).

FLOP accounting on B1 (banded 4096^2, bw 64, leaf 16): strips S=32,
La=16, Lc=24 -> 2*128*256*384*32 = 805 MFLOP vs 167 MFLOP honest leaf
pairs (4.8x) vs 1166 MFLOP for 128-tile pairs (7.0x) — and the panels
run at *dense batched GEMM* rates instead of sparse-kernel rates.

Like every planned primitive here, the plan self-validates: the operand
id structure is recorded at plan time and compared on use
(``info.plan_mismatch``), so a stale plan is loud, never silent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib.ops.spgemm import (
    named_dot,
    MultiplyInfo,
)


def _static(**kw):
    return field(metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class LeafpackPlan:
    """Host-built strip-packing plan (see module docstring).

    Index tables route missing leaves to the zero slot (index == cap of
    the respective operand; the device op appends one zero block), and
    absent C panel leaves to the trash slot ``out_cap``.
    """

    a_gidx: jax.Array  # int32[S, f, La]  -> A block index or capA (zero)
    b_gidx: jax.Array  # int32[S, La, Lc] -> B block index or capB (zero)
    c_slot: jax.Array  # int32[S, f, Lc]  -> C output slot or out_cap
    c_ids: jax.Array  # int32[out_cap], sorted, SENTINEL padded
    # Operand structure the plan was built for (self-validation).
    a_ids: jax.Array  # int32[capA]
    b_ids: jax.Array  # int32[capB]
    n_out: jax.Array  # int32[] distinct C blocks
    strips: int = _static(default=0)  # S
    strip_leaves: int = _static(default=8)  # f
    la: int = _static(default=0)  # packed A/k columns per strip
    lc: int = _static(default=0)  # packed C columns per strip
    out_cap: int = _static(default=0)
    n_leaf_pairs: int = _static(default=0)  # honest leaf-GEMM count
    panel_flops: int = _static(default=0)  # padded panel FLOPs actually run
    block_size: int = _static(default=16)  # fine leaf size b_fine

    @property
    def inflation(self) -> float:
        """Panel FLOPs / honest leaf-pair FLOPs (1.0 = no padding)."""
        return self.panel_flops / max(
            1, self.n_leaf_pairs * 2 * self.block_size**3
        )


def plan_leafpack(
    a: BlockMatrix,
    b: BlockMatrix,
    strip_rows: int = 128,
    max_cols: int | None = None,
) -> LeafpackPlan | None:
    """Host-side exact plan for `leafpack_spgemm` (C = A @ B at fine leaf
    granularity).

    `strip_rows`: strip height in matrix rows (>= one 128 tile, 128).
    `max_cols`: applicability guard — if any strip needs more than this
    many packed leaf columns (La or Lc), return None (the structure is
    not strip-local enough; use `spgemm` on coarsened tiles instead).
    Defaults to 4096 // block_size (panels up to [128, 4096]).
    """
    bf = a.block_size
    if a.block_size != b.block_size or a.n_cols != b.n_rows:
        raise ValueError("operand geometry mismatch")
    f = max(1, strip_rows // bf)
    align = max(1, 128 // bf)  # pad packed widths to lane multiples
    if max_cols is None:
        max_cols = max(align, 4096 // bf)

    a_ids = np.asarray(a.ids, np.int64)
    b_ids = np.asarray(b.ids, np.int64)
    cap_a, cap_b = a.cap, b.cap
    av = a_ids != int(SENTINEL)
    bv = b_ids != int(SENTINEL)
    a_row = np.where(av, a_ids // a.nb_cols, 0)
    a_col = np.where(av, a_ids % a.nb_cols, 0)
    b_row = np.where(bv, b_ids // b.nb_cols, 0)
    b_col = np.where(bv, b_ids % b.nb_cols, 0)
    nbr, nbc_b = a.nb_rows, b.nb_cols
    S = -(-nbr // f)

    # CSR-ish grouping of B by block-row (ids sorted => rows contiguous).
    b_valid_idx = np.nonzero(bv)[0]
    b_rows_v = b_row[b_valid_idx]
    b_cols_v = b_col[b_valid_idx]
    b_row_start = np.searchsorted(b_rows_v, np.arange(b.nb_rows + 1))

    a_valid_idx = np.nonzero(av)[0]
    a_rows_v = a_row[a_valid_idx]
    a_cols_v = a_col[a_valid_idx]
    # A ids sorted row-major => strips are contiguous index ranges.
    strip_start = np.searchsorted(a_rows_v, np.arange(0, (S + 1) * f, f))

    ka_list, cc_list = [], []
    n_leaf_pairs = 0
    for s in range(S):
        sl = slice(strip_start[s], strip_start[s + 1])
        ka = np.unique(a_cols_v[sl])
        # C columns of the strip: union of B-row supports over ka.
        segs = [
            b_cols_v[b_row_start[k] : b_row_start[k + 1]] for k in ka
        ]
        cc = (
            np.unique(np.concatenate(segs)) if segs else np.empty(0, np.int64)
        )
        ka_list.append(ka)
        cc_list.append(cc)
        if ka.size:
            cnt_a = np.bincount(
                np.searchsorted(ka, a_cols_v[sl]), minlength=ka.size
            )
            cnt_b = b_row_start[ka + 1] - b_row_start[ka]
            n_leaf_pairs += int(np.dot(cnt_a, cnt_b))
    La = max((k.size for k in ka_list), default=0)
    Lc = max((c.size for c in cc_list), default=0)
    La = -(-max(La, 1) // align) * align
    Lc = -(-max(Lc, 1) // align) * align
    if La > max_cols or Lc > max_cols:
        return None

    a_gidx = np.full((S, f, La), cap_a, np.int32)
    b_gidx = np.full((S, La, Lc), cap_b, np.int32)
    c_present = np.zeros((S, f, Lc), bool)
    for s in range(S):
        ka, cc = ka_list[s], cc_list[s]
        if ka.size == 0:
            continue
        sl = slice(strip_start[s], strip_start[s + 1])
        r = (a_rows_v[sl] - s * f).astype(np.int64)
        t = np.searchsorted(ka, a_cols_v[sl])
        a_gidx[s, r, t] = a_valid_idx[sl]
        for ti, k in enumerate(ka):
            seg = slice(b_row_start[k], b_row_start[k + 1])
            u = np.searchsorted(cc, b_cols_v[seg])
            b_gidx[s, ti, u] = b_valid_idx[seg]
            # Rows of the strip holding leaf (row, k) produce C leaves at
            # every column of B's row k.
            rows_with_k = r[t == ti]
            if rows_with_k.size and u.size:
                c_present[s, rows_with_k[:, None], u[None, :]] = True

    # Exact C structure, canonically sorted.
    ss, rr, uu = np.nonzero(c_present)
    cc_arr = np.zeros((S, Lc), np.int64)
    for s in range(S):
        cc_arr[s, : cc_list[s].size] = cc_list[s]
    cids = (ss * f + rr) * nbc_b + cc_arr[ss, uu]
    order = np.argsort(cids)
    n_out = cids.size
    out_cap = max(1, n_out)
    c_slot = np.full((S, f, Lc), out_cap, np.int32)
    c_slot[ss[order], rr[order], uu[order]] = np.arange(n_out, dtype=np.int32)
    c_ids = np.full((out_cap,), int(SENTINEL), np.int32)
    c_ids[:n_out] = cids[order]

    panel_flops = S * 2 * (f * bf) * (La * bf) * (Lc * bf)
    return LeafpackPlan(
        a_gidx=jnp.asarray(a_gidx),
        b_gidx=jnp.asarray(b_gidx),
        c_slot=jnp.asarray(c_slot),
        c_ids=jnp.asarray(c_ids),
        a_ids=jnp.asarray(a.ids),
        b_ids=jnp.asarray(b.ids),
        n_out=jnp.asarray(n_out, jnp.int32),
        strips=S,
        strip_leaves=f,
        la=La,
        lc=Lc,
        out_cap=out_cap,
        n_leaf_pairs=n_leaf_pairs,
        panel_flops=panel_flops,
        block_size=bf,
    )


@partial(jax.jit, static_argnames=("precision",))
def leafpack_spgemm(
    a: BlockMatrix,
    b: BlockMatrix,
    plan: LeafpackPlan,
    alpha: float | jax.Array = 1.0,
    precision: str = "highest",
):
    """C = alpha * A @ B via strip-packed dense panels (see module doc).

    Returns (C, MultiplyInfo); C has the exact fine-leaf structure the
    pair enumeration would produce.  `n_block_pairs`/`n_leaf_multiplies`
    report the honest leaf-GEMM count (the reference's
    no_of_block_multiplies at ITS leaf size, SURVEY.md C12).
    """
    bf = a.block_size
    S, f, La, Lc = plan.strips, plan.strip_leaves, plan.la, plan.lc
    # Stale-plan self-check (repo convention: never silent).
    mism = jnp.zeros((), bool)
    for got, want in ((a.ids, plan.a_ids), (b.ids, plan.b_ids)):
        if got.shape != want.shape:
            mism = mism | jnp.ones((), bool)
        else:
            mism = mism | jnp.any(got != want)

    zero = jnp.zeros((1, bf, bf), a.dtype)
    az = jnp.concatenate([a.data, zero])
    bz = jnp.concatenate([b.data.astype(a.dtype), zero])
    pa = az[plan.a_gidx]  # [S, f, La, bf, bf]  (s, r, t, i, l)
    pb = bz[plan.b_gidx]  # [S, La, Lc, bf, bf] (s, t, u, l, j)
    # Panel product: C[s,r,i,u,j] = sum_{t,l} A[s,r,t,i,l] * B[s,t,u,l,j]
    # — the joint (t, l) contraction IS the [128, La*bf] @ [La*bf, Lc*bf]
    # dense panel matmul; XLA collapses it onto one GEMM.
    acc_dtype = jnp.promote_types(a.dtype, jnp.float32)
    pc = named_dot(
        pa,
        pb,
        (((2, 4), (1, 3)), ((0,), (0,))),
        precision,
        acc_dtype,
    )  # [S, f, bf, Lc, bf]
    pc = pc * jnp.asarray(alpha, acc_dtype)
    pc = pc.transpose(0, 1, 3, 2, 4).reshape(S * f * Lc, bf, bf)
    out_data = (
        jnp.zeros((plan.out_cap, bf, bf), acc_dtype)
        .at[plan.c_slot.reshape(-1)]
        .set(pc, mode="drop")
        .astype(a.dtype)
    )
    c = BlockMatrix(
        ids=plan.c_ids,
        data=out_data,
        nnz=plan.n_out,
        n_rows=a.n_rows,
        n_cols=b.n_cols,
        block_size=bf,
    )
    n_leaf = jnp.asarray(plan.n_leaf_pairs, jnp.int32)
    info = MultiplyInfo(
        n_block_pairs=n_leaf,
        n_out_blocks=plan.n_out,
        pair_overflow=jnp.zeros((), bool),
        out_overflow=jnp.zeros((), bool),
        row_overflow=jnp.zeros((), bool),
        plan_mismatch=mism,
        n_leaf_multiplies=n_leaf,
    )
    return c, info
