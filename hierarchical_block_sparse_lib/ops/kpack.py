"""Packed-contraction SpGEMM for fine reference leaves (16/32) on the
128-wide GEMM tiles — the occupancy-exploiting path for RANDOM structures.

The reference's B2 config is 5% block density at leaf 32
(BASELINE.json:8).  Coarsening those leaves into 128 tiles
(`ops.repack.coarsen`) preserves correctness but is catastrophic for
uniform-random structure: a 128-tile holds 4x4 = 16 leaf-32 slots at
~0.8 expected occupancy, so tile-pair FLOPs inflate ~100x over the
honest leaf pairs (counted in bench.py's B2 leaf-32 stage).  The
strip packing of `ops.leafpack` doesn't help either — with random
columns, a strip's C-column union approaches the full width.

This module packs the CONTRACTION axis per coarse output tile instead
(VERDICT r3 item 1; SURVEY.md section 8.5 "aggregate logical leaves
into 128 tiles without destroying sparsity wins"):

1. Coarse output tile (I, J) covers f x f fine leaves (f = 128 /
   b_fine).  Its exact contribution is  C_IJ = sum_k A[I, k] @ B[k, J]
   over FINE contraction indices k with  A[I, k] != 0  AND
   B[k, J] != 0  — A[I, k] is a [128, b_fine] column of f fine leaves,
   B[k, J] a [b_fine, 128] row.
2. The k's that fail either test are never materialized: the panels
   `[128, Lk*b_fine] @ [Lk*b_fine, 128]` contain ONLY useful k slices
   (at 5% random, ~17 of 512 — a 29x FLOP cut vs enumerating coarse
   tile pairs).  Remaining padding: absent fine leaves *within* a
   useful k slice (~73% of A/B panel slots at B2's density — they
   contribute exact zeros) and the per-group Lk rounding.
3. ONE batched dense GEMM per tile group computes every output
   tile exactly — no segment accumulation (the panel product IS the
   k sum), full 128x128 output tiles (unlike per-pair leaf-32
   GEMMs, which use 1/16th of a 128x128 output tile).

Tiles are sorted by their packed width |K| and split into `n_groups`
groups, each padded to the group max (static shapes, bounded padding).

Like every planned primitive here, the plan self-validates against the
operand id structure on use (`info.plan_mismatch` — loud, never
silent).  Counters report HONEST fine-leaf multiplies (the reference's
`no_of_block_multiplies` at ITS leaf size, SURVEY.md C12).

Use kpack when a 128-tile OUTPUT is wanted anyway (e.g. feeding a
coarse-granularity chain) or at densities where per-slice occupancy is
high; otherwise plain `spgemm` at the native leaf size is the direct
path (its speed on the H100 is in PERF.md).
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
class KpackPlan:
    """Host-built per-output-tile contraction-packing plan.

    `a_src[g][t, l]` / `b_src[g][t, l]` index the device-side packed
    A-column / B-row arrays (index NA/NB = the all-zero pad slot);
    `c_slot[g][t]` is the output slot of group g's tile t.  Absent fine
    leaves inside a useful k slice are zero in the packed arrays, so
    the dense panel product is exact.
    """

    # Per group (tuples of arrays; group count/widths are static).
    a_src: tuple  # tuple[int32[Tg, Lk_g]]
    b_src: tuple  # tuple[int32[Tg, Lk_g]]
    c_slot: tuple  # tuple[int32[Tg]]
    # Scatter tables building the packed operand arrays from fine data.
    a_scat_col: jax.Array  # int32[capA] -> A fine-column slot (NA = pad)
    a_scat_off: jax.Array  # int32[capA] -> fine row within the tile row
    b_scat_row: jax.Array  # int32[capB] -> B fine-row slot (NB = pad)
    b_scat_off: jax.Array  # int32[capB] -> fine col within the tile col
    c_ids: jax.Array  # int32[n_tiles] coarse tile ids, sorted
    # Operand structure the plan was built for (self-validation).
    a_ids: jax.Array  # int32[capA]
    b_ids: jax.Array  # int32[capB]
    n_a_cols: int = _static(default=0)  # NA
    n_b_rows: int = _static(default=0)  # NB
    n_tiles: int = _static(default=0)
    tile: int = _static(default=128)  # coarse tile size f * b_fine
    leaves: int = _static(default=4)  # f
    block_size: int = _static(default=32)  # fine leaf size b_fine
    n_leaf_pairs: int = _static(default=0)  # honest leaf-GEMM count
    panel_flops: int = _static(default=0)  # padded panel FLOPs run

    @property
    def inflation(self) -> float:
        """Panel FLOPs / honest leaf-pair FLOPs (1.0 = no padding)."""
        return self.panel_flops / max(
            1, self.n_leaf_pairs * 2 * self.block_size**3
        )


def plan_kpack(
    a: BlockMatrix,
    b: BlockMatrix,
    tile: int = 128,
    n_groups: int = 32,
) -> KpackPlan | None:
    """Host-side exact plan for `kpack_spgemm` (C = A @ B with fine
    leaves packed along the contraction per coarse output tile).

    Returns None when the fine leaves don't subdivide `tile` (use
    `spgemm` directly at 128-tile granularity instead).  `n_groups` bounds
    the per-group Lk padding (tiles sorted by packed width, groups of
    equal tile count); it also bounds peak gather workspace to
    ~(n_tiles / n_groups) * tile * Lk_max * 8 bytes; more groups mean
    less Lk padding.
    """
    bf = a.block_size
    if a.block_size != b.block_size or a.n_cols != b.n_rows:
        raise ValueError("operand geometry mismatch")
    if tile % bf != 0 or tile == bf:
        return None
    f = tile // bf

    a_ids = np.asarray(a.ids, np.int64)
    b_ids = np.asarray(b.ids, np.int64)
    av = a_ids != int(SENTINEL)
    bv = b_ids != int(SENTINEL)
    nbk = a.nb_cols  # fine contraction width
    nbI = -(-a.nb_rows // f)
    nbJ = -(-b.nb_cols // f)
    ar = np.where(av, a_ids // nbk, 0)
    ac = np.where(av, a_ids % nbk, 0)
    br = np.where(bv, b_ids // b.nb_cols, 0)
    bc = np.where(bv, b_ids % b.nb_cols, 0)

    # Occupied A fine-columns (I, k) and B fine-rows (k, J), sorted.
    a_keys = (
        np.unique(((ar // f) * nbk + ac)[av]) if av.any()
        else np.empty(0, np.int64)
    )
    b_keys = (
        np.unique((br * nbJ + bc // f)[bv]) if bv.any()
        else np.empty(0, np.int64)
    )
    NA, NB = a_keys.size, b_keys.size

    # Membership bitmaps for the per-tile k intersection.
    abm = np.zeros((nbI, nbk), bool)
    abm[a_keys // nbk, a_keys % nbk] = True
    bbm = np.zeros((nbk, nbJ), bool)
    bbm[b_keys // nbJ, b_keys % nbJ] = True

    # Enumerate (tile, k) entries, J-major within each I so tile ids
    # come out globally sorted.
    tile_keys, tile_cnt, ent_a, ent_b = [], [], [], []
    for I in range(nbI):
        ka = np.nonzero(abm[I])[0]
        if ka.size == 0:
            continue
        sub = bbm[ka]  # [len(ka), nbJ]
        JJ, tt = np.nonzero(sub.T)  # J-major
        if JJ.size == 0:
            continue
        ks = ka[tt]
        # Per-J segments (JJ ascending).
        uJ, counts = np.unique(JJ, return_counts=True)
        tile_keys.append(I * nbJ + uJ)
        tile_cnt.append(counts)
        ent_a.append(np.searchsorted(a_keys, I * nbk + ks))
        ent_b.append(np.searchsorted(b_keys, ks * nbJ + JJ))
    if not tile_keys:
        return None
    tile_keys = np.concatenate(tile_keys)
    tile_cnt = np.concatenate(tile_cnt).astype(np.int64)
    ent_a = np.concatenate(ent_a).astype(np.int32)
    ent_b = np.concatenate(ent_b).astype(np.int32)
    n_tiles = tile_keys.size
    ent_off = np.concatenate([[0], np.cumsum(tile_cnt)])
    n_leaf_pairs = _count_fine_pairs(a_ids[av], b_ids[bv], nbk, b.nb_cols)

    # Group tiles by packed width; pad Lk to lane multiples of f
    # (Lk * bf a multiple of tile) within each group.
    align = f
    order = np.argsort(tile_cnt, kind="stable")
    groups = np.array_split(order, min(n_groups, n_tiles))
    a_src, b_src, c_slot = [], [], []
    panel_flops = 0
    for g in groups:
        if g.size == 0:
            continue
        lk = int(tile_cnt[g].max())
        lk = -(-max(lk, 1) // align) * align
        sa = np.full((g.size, lk), NA, np.int32)
        sb = np.full((g.size, lk), NB, np.int32)
        for t, ti in enumerate(g):
            s = slice(ent_off[ti], ent_off[ti + 1])
            w = ent_off[ti + 1] - ent_off[ti]
            sa[t, :w] = ent_a[s]
            sb[t, :w] = ent_b[s]
        a_src.append(jnp.asarray(sa))
        b_src.append(jnp.asarray(sb))
        # tile_keys is globally sorted; slot = position in tile_keys.
        c_slot.append(jnp.asarray(g.astype(np.int32)))
        panel_flops += g.size * 2 * tile * (lk * bf) * tile

    # Scatter tables: every valid fine leaf lands in its (I,k) column /
    # (k,J) row slot; padding leaves (all-zero by invariant) are routed
    # to the pad slot and ADDED, which leaves it zero.
    a_scat_col = np.where(
        av, np.searchsorted(a_keys, (ar // f) * nbk + ac), NA
    ).astype(np.int32)
    a_scat_off = np.where(av, ar % f, 0).astype(np.int32)
    b_scat_row = np.where(
        bv, np.searchsorted(b_keys, br * nbJ + bc // f), NB
    ).astype(np.int32)
    b_scat_off = np.where(bv, bc % f, 0).astype(np.int32)

    return KpackPlan(
        a_src=tuple(a_src),
        b_src=tuple(b_src),
        c_slot=tuple(c_slot),
        a_scat_col=jnp.asarray(a_scat_col),
        a_scat_off=jnp.asarray(a_scat_off),
        b_scat_row=jnp.asarray(b_scat_row),
        b_scat_off=jnp.asarray(b_scat_off),
        c_ids=jnp.asarray(tile_keys.astype(np.int32)),
        a_ids=jnp.asarray(a.ids),
        b_ids=jnp.asarray(b.ids),
        n_a_cols=NA,
        n_b_rows=NB,
        n_tiles=n_tiles,
        tile=tile,
        leaves=f,
        block_size=bf,
        n_leaf_pairs=int(n_leaf_pairs),
        panel_flops=int(panel_flops),
    )


def _count_fine_pairs(a_ids_v, b_ids_v, a_nbc, b_nbc):
    """Exact fine-granularity pair count (the honest counter)."""
    from hierarchical_block_sparse_lib.runtime import native

    try:
        n, _ = native.plan_spgemm(
            np.asarray(a_ids_v, np.int32), np.asarray(b_ids_v, np.int32),
            a_nbc, a_nbc, b_nbc,
        )
        return n
    except Exception:
        ac = a_ids_v % a_nbc
        br = b_ids_v // b_nbc
        cnt_b = np.bincount(br, minlength=a_nbc)
        return int(cnt_b[ac].sum())


@partial(jax.jit, static_argnames=("precision", "layout"))
def kpack_spgemm(
    a: BlockMatrix,
    b: BlockMatrix,
    plan: KpackPlan,
    alpha: float | jax.Array = 1.0,
    precision: str = "highest",
    layout: str = "plain",
):
    """C = alpha * A @ B via per-tile packed contraction (module doc).

    Returns (C, MultiplyInfo); C is at COARSE granularity (block_size =
    plan.tile) with exactly the tiles some FINE pair touches — i.e. the
    fine product's support rounded up to tiles.  (The coarsened pair
    enumeration emits a SUPERSET: coarse pairs whose fine supports are
    k-disjoint produce exact-zero tiles there; kpack never enumerates
    them — the fine-granularity zero-child short-circuit, SURVEY.md
    section 4.2.)  Downstream chain ops (add/scale/truncate) operate on
    the coarse tiles directly.  `n_block_pairs`/`n_leaf_multiplies` report the honest
    fine-leaf GEMM count (the reference's counter at ITS leaf size).

    `layout` picks the panel-assembly formulation (same math, same
    result):

    - "plain": gather [Tg, Lk, tile, bf] A panels, transpose+reshape to
      [Tg, tile, Lk*bf] before the dot — the transpose runs over the
      GATHERED bytes (each fine column is re-gathered for every tile
      that uses it: ~#occupied B (k,·) per column, ~24x at B2's 5%).
    - "t": store the packed A columns pre-transposed ([bf, tile] per
      slot) so the per-panel transpose happens ONCE on the NA-slot
      store; the dot consumes the gathered panels as a transposed LHS
      (contracting dim first), which XLA handles as a layout.
    - "mc": no reshapes at all — multi-dimensional contraction
      directly on the gathered [Tg, Lk, tile, bf] x [Tg, Lk, bf, tile]
      panels; XLA picks the layouts.
    """
    if layout not in ("plain", "t", "mc"):
        # A typo must not silently measure the default variant
        # (ADVICE r4): the branches below would otherwise fall through
        # to "plain".
        raise ValueError(
            f"layout must be one of 'plain'/'t'/'mc', got {layout!r}"
        )
    bf = plan.block_size
    f = plan.leaves
    tile = plan.tile
    # Stale-plan self-check (repo convention: never silent).
    mism = jnp.zeros((), bool)
    for got, want in ((a.ids, plan.a_ids), (b.ids, plan.b_ids)):
        if got.shape != want.shape:
            mism = mism | jnp.ones((), bool)
        else:
            mism = mism | jnp.any(got != want)

    NA, NB = plan.n_a_cols, plan.n_b_rows
    acc_dtype = jnp.promote_types(a.dtype, jnp.float32)
    store_dtype = a.dtype
    # Packed operands: one [tile, bf] column per occupied A (I, k), one
    # [bf, tile] row per occupied B (k, J); absent fine leaves stay 0.
    # `.add` (not `.set`): distinct valid leaves hit distinct slots, and
    # padding leaves (all-zero) routed to the pad slot add nothing.
    if layout == "t":
        # [slot, u(row leaf), c, r] -> [slot, c, u, r] = [bf, tile]
        # transposed columns: one pass over the NA*tile*bf store
        # instead of over every gathered panel.
        a_cols = (
            jnp.zeros((NA + 1, f, bf, bf), store_dtype)
            .at[plan.a_scat_col, plan.a_scat_off]
            .add(
                a.data.astype(store_dtype).transpose(0, 2, 1),
                mode="drop",
            )
            .transpose(0, 2, 1, 3)
            .reshape(NA + 1, bf, f * bf)
        )
    else:
        a_cols = (
            jnp.zeros((NA + 1, f, bf, bf), store_dtype)
            .at[plan.a_scat_col, plan.a_scat_off]
            .add(a.data.astype(store_dtype), mode="drop")
            .reshape(NA + 1, f * bf, bf)
        )
    b_rows = (
        jnp.zeros((NB + 1, f, bf, bf), store_dtype)
        .at[plan.b_scat_row, plan.b_scat_off]
        .add(b.data.astype(store_dtype), mode="drop")
        # [slot, u(col leaf), r, c] -> [slot, r, u, c] = [bf, tile] rows.
        .transpose(0, 2, 1, 3)
        .reshape(NB + 1, bf, f * bf)
    )

    out = jnp.zeros((plan.n_tiles, tile, tile), acc_dtype)
    for sa, sb, slot in zip(plan.a_src, plan.b_src, plan.c_slot):
        lk = sa.shape[1]
        if layout == "t":
            # a_cols[slot] = [bf, tile] (transposed): contraction dim
            # (l, c) lands first after the merge — transposed LHS.
            pa = a_cols[sa].reshape(sa.shape[0], lk * bf, tile)
            pb = b_rows[sb].reshape(sb.shape[0], lk * bf, tile)
            dn = (((1,), (1,)), ((0,), (0,)))
        elif layout == "mc":
            pa = a_cols[sa]  # [Tg, Lk, tile, bf]
            pb = b_rows[sb]  # [Tg, Lk, bf, tile]
            dn = (((1, 3), (1, 2)), ((0,), (0,)))
        else:
            pa = a_cols[sa]  # [Tg, Lk, tile, bf]
            pa = pa.transpose(0, 2, 1, 3).reshape(
                sa.shape[0], tile, lk * bf
            )
            pb = b_rows[sb].reshape(sb.shape[0], lk * bf, tile)
            dn = (((2,), (1,)), ((0,), (0,)))
        cg = named_dot(
            pa,
            pb,
            dn,
            precision,
            acc_dtype,
        )
        out = out.at[slot].set(cg)
    out = (out * jnp.asarray(alpha, acc_dtype)).astype(a.dtype)

    c = BlockMatrix(
        ids=plan.c_ids,
        data=out,
        nnz=jnp.asarray(plan.n_tiles, jnp.int32),
        n_rows=a.n_rows,
        n_cols=b.n_cols,
        block_size=tile,
    )
    n_leaf = jnp.asarray(plan.n_leaf_pairs, jnp.int32)
    info = MultiplyInfo(
        n_block_pairs=n_leaf,
        n_out_blocks=jnp.asarray(plan.n_tiles, jnp.int32),
        pair_overflow=jnp.zeros((), bool),
        out_overflow=jnp.zeros((), bool),
        row_overflow=jnp.zeros((), bool),
        plan_mismatch=mism,
        n_leaf_multiplies=n_leaf,
    )
    return c, info
