"""Hierarchical block-sparse matrix-matrix multiply (SpGEMM).

Reference parity (SURVEY.md C5, section 4.2): the reference recurses over
the quadtree (8 child multiplies per node, zero-child short-circuit) and
runs BLAS GEMM at surviving leaf pairs.  Here the entire recursion is
replaced by (BASELINE.json:5):

1. **symbolic phase** — vectorized block-pair matching over the two
   sorted id arrays: for each stored A block (i,k), binary-search B's
   row-k range; enumerate all (a_idx, b_idx) pairs with a prefix-sum +
   searchsorted expansion (no per-pair host loop);
2. **numeric phase** — every pair's leaf GEMM accumulated into its
   distinct output block (`numeric_phase`): on a GPU the
   output-stationary segment-GEMM kernel (`kernels.segment_gemm`),
   elsewhere a batched `dot_general` over gathered pairs followed by a
   segment-sum.

The zero-child short-circuit of the reference is inherited exactly: only
stored-x-stored block pairs are ever enumerated, so the block-multiply
count matches the reference's `no_of_block_multiplies` counter
(SURVEY.md C12) and is reported in `MultiplyInfo`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib.kernels import (
    segment_gemm as segment_gemm_mod,
)
from hierarchical_block_sparse_lib.ops import basic


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MultiplyInfo:
    """Exact operation counters (the reference's instrumentation,
    SURVEY.md C12) — these ARE the benchmark metric (nnz-block GEMMs)."""

    n_block_pairs: jax.Array  # int32[] — leaf GEMMs performed
    n_out_blocks: jax.Array  # int32[] — distinct output blocks
    pair_overflow: jax.Array  # bool[] — pair_cap too small (results dropped)
    out_overflow: jax.Array  # bool[] — out_cap too small (results dropped)
    # Deprecated: per-row capacity overflow of a retired kernel.  Always
    # False; kept so that callers that fold it into their flags still run.
    row_overflow: jax.Array
    # True when a `plan=` was supplied but some operand's id structure
    # diverged from what the plan was built for — the numeric phase then
    # gathered stale pairs and the result is WRONG.  Always False when no
    # plan is used.  Every planned primitive self-validates (never
    # silent).
    plan_mismatch: jax.Array
    # Exact logical-leaf multiply count (reference leaf granularity, e.g.
    # 16/32) when per-tile occupancy masks are supplied via
    # a_leaf_occ/b_leaf_occ (see ops.repack.coarsen(track_leaves=True));
    # -1 when not tracked.  This is the counter comparable to the
    # reference's `no_of_block_multiplies` at ITS leaf size; n_block_pairs
    # counts 128-tile pairs (SURVEY.md section 8.5).
    n_leaf_multiplies: jax.Array


@partial(
    jax.jit, static_argnames=("pair_cap", "filter_by_norm", "syrk_upper")
)
def spgemm_symbolic(
    a: BlockMatrix,
    b: BlockMatrix,
    pair_cap: int,
    tau: float | jax.Array = 0.0,
    filter_by_norm: bool = False,
    syrk_upper: bool = False,
):
    """Enumerate contributing block pairs, sorted by output block id.

    Returns (a_idx, b_idx, c_id, total, raw_total): int32[pair_cap]
    arrays; entries past `total` have c_id == SENTINEL.  Sorted by c_id
    so the numeric phase can accumulate segments sequentially.  `total`
    is the number of surviving pairs, `raw_total` the unfiltered pair
    count (enumeration overflows iff raw_total > pair_cap).

    With `filter_by_norm=True`, pairs whose a-priori product norm bound
    ``||A_ik||_F * ||B_kj||_F <= tau`` are dropped before the numeric
    phase — the reference lineage's SpAMM-style error-controlled
    approximate multiply (SURVEY.md section 1: "sparse approximate
    multiplication with error control" for purification); the total
    dropped Frobenius mass is bounded by the sum of skipped bounds.
    Because the sort moves survivors to the front, the caller can slice
    the pair lists to a tight `gemm_cap` < pair_cap and spend GEMM time
    on surviving pairs only (the symbolic workspace is cheap int32;
    the numeric batch is the b^3 cost).
    """
    a_valid = a.valid_mask()
    a_row = a.ids // a.nb_cols
    a_col = jnp.where(a_valid, a.ids % a.nb_cols, a.nb_cols)  # miss key
    b_row = jnp.where(b.valid_mask(), b.ids // b.nb_cols, b.nb_rows + 1)
    b_col = b.ids % b.nb_cols

    # Row-k range of B for each A block's column k (B ids are row-major
    # sorted, so each block-row of B is a contiguous run).
    # One row-start table (one sort over capB + nb_rows) serves both
    # range ends as gathers, instead of two searchsorteds over
    # capB + capA each.
    b_row_start = jnp.searchsorted(
        b_row,
        jnp.arange(b.nb_rows + 1, dtype=jnp.int32),
        side="left",
        method="sort",
    ).astype(jnp.int32)
    # Padding rows carry the miss key nb_rows: lo == hi == end-of-valid.
    lo = b_row_start[jnp.minimum(a_col, b.nb_rows)]
    hi = b_row_start[jnp.minimum(a_col + 1, b.nb_rows)]
    cnt = jnp.where(a_valid, hi - lo, 0)
    offs = jnp.cumsum(cnt)
    total = offs[-1]

    # Expand: pair p belongs to A entry e = first index with offs[e] > p.
    p = jnp.arange(pair_cap, dtype=jnp.int32)
    e = jnp.searchsorted(
        offs, p, side="right", method="sort"
    ).astype(jnp.int32)
    e_c = jnp.minimum(e, a.cap - 1)
    base = jnp.where(e_c > 0, offs[e_c - 1], 0)
    t = p - base
    valid_p = p < total
    a_idx = e_c
    b_idx = jnp.minimum(lo[e_c] + t, b.cap - 1)
    if filter_by_norm:
        from hierarchical_block_sparse_lib.ops.norms import (
            block_frob_squared,
        )

        # Compare squared quantities to avoid per-block sqrt.
        an2 = block_frob_squared(a)
        bn2 = block_frob_squared(b)
        tau2 = jnp.square(jnp.asarray(tau, jnp.float32))
        valid_p = valid_p & (an2[a_idx] * bn2[b_idx] > tau2)
    if syrk_upper:
        # Symmetric-product enumeration (C = A @ A^T with b = A^T):
        # keep only upper-triangle outputs i <= j; the caller mirrors
        # C_ji = C_ij^T afterwards, halving the leaf-GEMM count
        # (SURVEY.md section 9.2 rank-k surface).
        valid_p = valid_p & (a_row[e_c] <= b_col[b_idx])
    c_id = jnp.where(
        valid_p, a_row[e_c] * b.nb_cols + b_col[b_idx], SENTINEL
    ).astype(jnp.int32)
    raw_total = total.astype(jnp.int32)
    if filter_by_norm or syrk_upper:
        total = jnp.sum(valid_p).astype(jnp.int32)

    order = jnp.argsort(c_id)
    return (
        a_idx[order],
        b_idx[order],
        c_id[order],
        total.astype(jnp.int32),
        raw_total,
    )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SymbolicPlan:
    """Device-resident symbolic plan (the output of `spgemm_symbolic`),
    reusable across `spgemm` calls while BOTH operands keep exactly the
    same id structure (fixed-sparsity iteration: stencil applications,
    repeated C = A@B with frozen supports).  Skips the symbolic phase —
    sorts, row-range matching, pair expansion — entirely; only the
    numeric phase runs.  Build with `make_plan`.

    When built with ``accum_ids=``/``out_cap=``, the union-merge of the
    beta-accumulate path (its own sort + two searchsorteds per call) is
    precomputed too: `out_ids`/`seg`/`pos_acc`/`n_unique` are the union
    structure of the product support with the accumulator support, and
    ``spgemm(..., plan=..., accum=...)`` then runs ONLY the numeric
    phase + scatters — the whole structural cost of a fixed-support
    C = alpha*AB + beta*D collapses to zero."""

    a_idx: jax.Array  # int32[pair_cap]
    b_idx: jax.Array  # int32[pair_cap]
    c_id: jax.Array  # int32[pair_cap], sorted, SENTINEL padded
    total: jax.Array  # int32[] surviving pairs
    raw_total: jax.Array  # int32[] unfiltered enumeration size
    # Operand id structure the plan was built for — compared on use and
    # reported via MultiplyInfo.plan_mismatch (a stale plan gathers
    # wrong pairs; the check keeps that loud, two int compares).
    a_ids: jax.Array | None = None  # int32[capA]
    b_ids: jax.Array | None = None  # int32[capB]
    # Optional precomputed accumulate-union structure (else None).
    out_ids: jax.Array | None = None  # int32[out_cap] union ids
    seg: jax.Array | None = None  # int32[pair_cap] pair -> union slot
    pos_acc: jax.Array | None = None  # int32[acc_cap] accum -> union slot
    n_unique: jax.Array | None = None  # int32[] distinct union blocks
    acc_ids: jax.Array | None = None  # int32[acc_cap] planned accum ids
    # Optional symmetric-mirror structure (make_plan(sym_mirror=True)):
    # for a SYMMETRIC product structure, mirror_src[j] is the union slot
    # holding the transpose of slot j's block (own index for
    # upper/diagonal slots); total_syrk counts the upper-triangle pairs
    # (the GEMMs the syrk_upper kernel actually runs).  mirror_ok is
    # False when the union id set was not symmetric (stale/asymmetric
    # plan — folded into plan_mismatch, never silent).
    mirror_src: jax.Array | None = None  # int32[out_cap]
    total_syrk: jax.Array | None = None  # int32[]
    mirror_ok: jax.Array | None = None  # bool[]


def make_plan(
    a: BlockMatrix,
    b: BlockMatrix,
    pair_cap: int,
    tau: float | jax.Array = 0.0,
    filter_by_norm: bool = False,
    syrk_upper: bool = False,
    accum_ids: jax.Array | None = None,
    out_cap: int | None = None,
    sym_mirror: bool = False,
) -> SymbolicPlan:
    """Run the symbolic phase once and package it for reuse via
    ``spgemm(..., plan=...)``.  Valid while both operands' id arrays are
    unchanged (data may change freely); with `filter_by_norm` the norm
    filter is frozen at planning time.  Staleness is self-checked at use
    (MultiplyInfo.plan_mismatch).

    With `accum_ids` (the accumulator's sorted id array) and `out_cap`,
    the beta-accumulate union structure is precomputed as well — the
    matching ``spgemm(..., plan=..., accum=...)`` call must use the same
    `out_cap` and an accumulator with exactly these ids.

    With `sym_mirror=True` (requires accum_ids/out_cap; operands and
    union structurally SYMMETRIC), the plan additionally carries the
    mirror map for the planned-symmetric multiply: the caller runs
    ``spgemm(..., plan=..., syrk_upper=True)`` — generic union slots,
    upper-triangle GEMMs only — then overwrites the
    strictly-lower slots with transposed upper blocks via `mirror_src`
    (one gather, zero structural ops; see models.purification.sp2_step
    symmetric+plan).  NOTE this differs from `syrk_upper=True` here,
    which would build UPPER-ONLY pair lists and output structure."""
    sym = spgemm_symbolic(
        a, b, pair_cap, tau=tau, filter_by_norm=filter_by_norm,
        syrk_upper=syrk_upper,
    )
    # The plan records the POST-transpose-flag operand structure the
    # symbolic phase saw; spgemm compares after its own transpose step.
    rec = dict(a_ids=a.ids, b_ids=b.ids)
    if accum_ids is None:
        if sym_mirror:
            raise ValueError("sym_mirror requires accum_ids/out_cap")
        return SymbolicPlan(*sym, **rec)
    if out_cap is None:
        raise ValueError("make_plan(accum_ids=...) requires out_cap")
    out_ids, seg, pos_acc, n_unique = basic.union_merge(
        sym[2], accum_ids, out_cap
    )
    mirror = {}
    if sym_mirror:
        if a.n_rows != a.n_cols:
            raise ValueError("sym_mirror needs a square matrix")
        nb = a.nb_rows
        c_id = sym[2]
        cv = c_id != SENTINEL
        crow = jnp.where(cv, c_id // nb, 0)
        ccol = jnp.where(cv, c_id % nb, 0)
        total_syrk = jnp.sum(cv & (crow <= ccol)).astype(jnp.int32)
        ov = out_ids != SENTINEL
        orow = jnp.where(ov, out_ids // nb, 0)
        ocol = jnp.where(ov, out_ids % nb, 0)
        mid = jnp.where(ov, ocol * nb + orow, SENTINEL).astype(jnp.int32)
        src = jnp.searchsorted(
            out_ids, mid, side="left", method="sort"
        ).astype(jnp.int32)
        src = jnp.clip(src, 0, out_ids.shape[0] - 1)
        lower = ov & (orow > ocol)
        # Asymmetric union (no transpose partner stored) is a plan bug
        # or structural asymmetry: loud via mirror_ok.
        mirror_ok = jnp.all(
            jnp.where(lower, out_ids[src] == mid, True)
        )
        mirror = dict(
            mirror_src=jnp.where(lower, src, jnp.arange(
                out_ids.shape[0], dtype=jnp.int32
            )),
            total_syrk=total_syrk,
            mirror_ok=mirror_ok,
        )
    return SymbolicPlan(
        *sym, **rec, out_ids=out_ids, seg=seg, pos_acc=pos_acc,
        n_unique=n_unique, acc_ids=accum_ids, **mirror,
    )


def alpha_is_one_static(alpha) -> bool:
    return isinstance(alpha, (int, float)) and float(alpha) == 1.0


BACKENDS = ("auto", "segment", "xla")


def resolve_backend(block_size, dtype) -> str:
    """The numeric path `spgemm(backend="auto")` takes, as a host-side
    decision callers can log: the segment-GEMM kernel on a GPU for the
    storage it supports (`kernels.segment_gemm.supported`), else the
    gather + `dot_general` path (float64, other block sizes, and any
    device without Triton)."""
    if jax.default_backend() == "gpu" and segment_gemm_mod.supported(
        block_size, dtype
    ):
        return "segment"
    return "xla"


def named_dot(lhs, rhs, dimension_numbers, precision, preferred_element_type):
    """`lax.dot_general` with the dot algorithm a precision name selects
    (`kernels.segment_gemm.dot_algorithm`).  Storage without a named
    algorithm (float64) runs at HIGHEST."""
    kw = dict(
        dimension_numbers=dimension_numbers,
        preferred_element_type=preferred_element_type,
    )
    if lhs.dtype not in (jnp.float32, jnp.bfloat16) or lhs.dtype != rhs.dtype:
        return jax.lax.dot_general(
            lhs, rhs, precision=jax.lax.Precision.HIGHEST, **kw
        )
    alg = segment_gemm_mod.dot_algorithm(precision, lhs.dtype)

    def dot(alg):
        return lambda: jax.lax.dot_general(lhs, rhs, precision=alg, **kw)

    cpu_alg = segment_gemm_mod.cpu_algorithm(alg)
    if cpu_alg == alg:
        return dot(alg)()
    return jax.lax.platform_dependent(cpu=dot(cpu_alg), default=dot(alg))


# Bound the materialized gather of the XLA path: 2 * chunk * b^2 * 4B
# (e.g. 1 GB at b=128, chunk=8192 per operand gather + product).
_XLA_PAIR_CHUNK = 8192


def _xla_numeric_accumulate(
    a_data, b_data, a_idx, b_idx, seg, out_shape, acc_dtype, precision
):
    """Chunked gather-GEMM-scatter: memory-bounded for any pair count."""
    pairs = a_idx.shape[0]
    out = jnp.zeros(out_shape, acc_dtype)

    def step(out, ai, bi, sg):
        prod = named_dot(
            a_data[ai], b_data[bi], (((2,), (1,)), ((0,), (0,))),
            precision, acc_dtype,
        )
        return out.at[sg].add(prod, mode="drop")

    if pairs <= _XLA_PAIR_CHUNK:
        return step(out, a_idx, b_idx, seg)
    n_chunks = -(-pairs // _XLA_PAIR_CHUNK)
    pad = n_chunks * _XLA_PAIR_CHUNK - pairs
    if pad:
        a_idx = jnp.concatenate([a_idx, jnp.zeros((pad,), jnp.int32)])
        b_idx = jnp.concatenate([b_idx, jnp.zeros((pad,), jnp.int32)])
        seg = jnp.concatenate(
            [seg, jnp.full((pad,), out_shape[0], jnp.int32)]
        )
    ck = _XLA_PAIR_CHUNK
    slices = (
        a_idx.reshape(n_chunks, ck),
        b_idx.reshape(n_chunks, ck),
        seg.reshape(n_chunks, ck),
    )
    out, _ = jax.lax.scan(
        lambda out, sl: (step(out, *sl), None), out, slices
    )
    return out


def numeric_phase(
    a_data, b_data, a_idx, b_idx, seg, out_cap, backend, precision,
    alpha=1.0, beta=1.0, acc_data=None, acc_src=None,
):
    """The numeric phase shared by every SpGEMM entry point.

    Pair p (sorted so that `seg` is nondecreasing; ``seg >= out_cap``
    drops it) multiplies ``a_data[a_idx[p]] @ b_data[b_idx[p]]`` into
    slot seg[p].  Returns [out_cap, b, b] in a_data's dtype:
    ``alpha * products + beta * acc_data[acc_src]`` (acc_src < 0: no
    accumulator block).  `backend` is "segment" or "xla" (resolved)."""
    bs = a_data.shape[-1]
    acc_dtype = jnp.promote_types(a_data.dtype, jnp.float32)
    if backend == "segment":
        return segment_gemm_mod.segment_gemm(
            a_data, b_data, a_idx, b_idx,
            segment_gemm_mod.slot_starts(seg, out_cap),
            precision=precision, alpha=alpha, beta=beta,
            acc_data=acc_data, acc_src=acc_src,
            interpret=segment_gemm_mod.INTERPRET,
        )
    if backend != "xla":
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    out = _xla_numeric_accumulate(
        a_data, b_data, a_idx, b_idx, seg, (out_cap, bs, bs), acc_dtype,
        precision,
    )
    if not alpha_is_one_static(alpha):
        out = out * jnp.asarray(alpha, acc_dtype)
    if acc_data is not None:
        # A gather-add, not a scatter-add: each slot takes at most one
        # accumulator block, so the add fuses with the alpha scale.
        acc_blocks = jnp.take(
            acc_data, jnp.where(acc_src < 0, acc_data.shape[0], acc_src),
            axis=0, mode="fill", fill_value=0,
        )
        out = out + jnp.asarray(beta, acc_dtype) * acc_blocks.astype(
            acc_dtype
        )
    return out.astype(a_data.dtype)


@partial(
    jax.jit,
    static_argnames=(
        "pair_cap",
        "out_cap",
        "backend",
        "transpose_a",
        "transpose_b",
        "precision",
        "filter_by_norm",
        "gemm_cap",
        "row_caps",
        "syrk_upper",
        "accum_aligned",
    ),
)
def spgemm(
    a: BlockMatrix,
    b: BlockMatrix,
    pair_cap: int,
    out_cap: int,
    alpha: float | jax.Array = 1.0,
    transpose_a: bool = False,
    transpose_b: bool = False,
    backend: str = "auto",
    precision: str = "highest",
    tau: float | jax.Array = 0.0,
    filter_by_norm: bool = False,
    gemm_cap: int | None = None,
    row_caps: tuple[int, int] | None = None,
    syrk_upper: bool = False,
    a_leaf_occ: jax.Array | None = None,
    b_leaf_occ: jax.Array | None = None,
    accum: BlockMatrix | None = None,
    beta: float | jax.Array = 1.0,
    plan: SymbolicPlan | None = None,
    accum_aligned: bool = False,
):
    """C = alpha * op(A) @ op(B) [+ beta * accum]; returns (C, MultiplyInfo).

    `plan` (from `make_plan`) skips the symbolic phase for
    fixed-structure iteration; it must have been built for these
    operands' exact id structure and this `pair_cap`/`tau` configuration
    (data may differ).

    `accum` fuses the BLAS-gemm-style beta-accumulate (the reference's
    ``multiply`` writes INTO C, SURVEY.md C5): C's structure becomes the
    union of the product support and accum's support, and beta*accum is
    added in the same pass — one structural op instead of the
    spgemm-then-add chain.  `alpha`/`beta` may be traced scalars.

    `accum_aligned=True` makes the output structure accum's own (the
    product support must be a subset; checked into
    MultiplyInfo.plan_mismatch) — the frozen routed regime
    (route.freeze_route_plan) — so no union merge runs at all.

    `pair_cap` bounds the number of enumerated block pairs and `out_cap`
    the distinct output blocks (static shapes — the XLA sparsity idiom).
    Overflow is reported in MultiplyInfo, never silent.  Use
    `plan_spgemm` (host) or `pair_bound` to size them.

    backend: 'segment' (the output-stationary segment-GEMM kernel,
    `kernels.segment_gemm`; GPU), 'xla' (gather + dot_general +
    segment scatter; any device and dtype), or 'auto'
    (`resolve_backend`).

    row_caps: deprecated and ignored (per-row capacities of a retired
    kernel); kept so that existing callers keep working.

    precision: dot algorithm for f32 data (`kernels.segment_gemm.
    F32_ALGORITHMS`) — 'highest' (default; IEEE f32 products),
    'high' (3-pass bf16 split, ~1e-5 rel) or 'default' (one TF32 pass,
    ~1e-3 rel).  bf16 data always multiplies bf16 x bf16 -> f32; f64
    data at full f64 precision.

    Error-controlled (SpAMM-style) multiply: with `filter_by_norm=True`,
    block pairs with ||A_ik||_F * ||B_kj||_F <= tau are skipped.  Pass
    `gemm_cap` (sized by `plan_spamm`) to shrink the batched-GEMM shape
    to the surviving pairs — the symbolic workspace stays `pair_cap`
    (cheap int32), the numeric batch shrinks to `gemm_cap` (the b^3
    cost).
    """
    del row_caps
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if transpose_a:
        a = basic.transpose(a)
    if transpose_b:
        b = basic.transpose(b)
    if a.n_cols != b.n_rows or a.block_size != b.block_size:
        raise ValueError(
            f"inner dims/block mismatch: {a.n_cols}x{a.block_size} vs "
            f"{b.n_rows}x{b.block_size}"
        )
    plan_mismatch = jnp.zeros((), bool)
    if plan is None:
        a_idx, b_idx, c_id, total, raw_total = spgemm_symbolic(
            a, b, pair_cap, tau=tau, filter_by_norm=filter_by_norm,
            syrk_upper=syrk_upper,
        )
    else:
        if plan.a_idx.shape[0] != pair_cap:
            raise ValueError(
                f"plan built for pair_cap={plan.a_idx.shape[0]}, "
                f"got {pair_cap}"
            )
        a_idx, b_idx, c_id = plan.a_idx, plan.b_idx, plan.c_id
        total, raw_total = plan.total, plan.raw_total
        # Self-check: a stale plan gathers wrong pairs — compare the
        # operands' id structure against what the plan was built for
        # (capacity changes count as drift; static shape check).
        if plan.a_ids is not None:
            for got, want in ((a.ids, plan.a_ids), (b.ids, plan.b_ids)):
                plan_mismatch = plan_mismatch | _ids_differ(got, want)
    gemm_cap = pair_cap if gemm_cap is None else min(gemm_cap, pair_cap)
    if gemm_cap < pair_cap:
        # Survivors sort before SENTINEL padding: slicing keeps them all
        # as long as total <= gemm_cap (overflow reported below).
        a_idx = a_idx[:gemm_cap]
        b_idx = b_idx[:gemm_cap]
        c_id = c_id[:gemm_cap]

    if a_leaf_occ is not None:
        n_leaf = _leaf_multiplies(a_leaf_occ, b_leaf_occ, a_idx, b_idx, c_id)
    else:
        n_leaf = jnp.full((), -1, jnp.int32)

    valid_p = c_id != SENTINEL
    acc_src = None
    if accum is None:
        if accum_aligned:
            raise ValueError("accum_aligned requires accum")
        out_ids, seg, n_unique = product_structure(c_id, out_cap)
    else:
        if (accum.n_rows, accum.n_cols) != (a.n_rows, b.n_cols):
            raise ValueError("accum shape mismatch")
        if accum.block_size != a.block_size:
            raise ValueError("accum block_size mismatch")
        # The inverse-map gather below keeps one accumulator block per
        # slot, so duplicate accum ids (which a scatter-add would have
        # summed) break the contract: report them loudly.  Sorted ids
        # put duplicates adjacent, so one vector compare.
        plan_mismatch = plan_mismatch | jnp.any(
            (accum.ids[1:] == accum.ids[:-1]) & accum.valid_mask()[1:]
        )
        if accum_aligned:
            if accum.cap != out_cap:
                raise ValueError(
                    f"accum_aligned needs accum.cap == out_cap "
                    f"({accum.cap} != {out_cap})"
                )
            out_ids = accum.ids
            n_unique = accum.nnz
            acc_src = jnp.arange(out_cap, dtype=jnp.int32)
            if plan is not None and plan.acc_ids is not None:
                # A plan built with accum_ids= for this alignment: its
                # union must BE the accumulator's structure (product
                # support inside it), and accum must carry those ids.
                seg = plan.seg[:gemm_cap]
                plan_mismatch = (
                    plan_mismatch
                    | _ids_differ(plan.out_ids, plan.acc_ids)
                    | _ids_differ(accum.ids, plan.acc_ids)
                )
            else:
                # Planless: locate each pair's slot (a full sort per
                # call — keep it out of hot loops) and check that every
                # product block has one.
                pos = jnp.searchsorted(
                    accum.ids, c_id, side="left", method="sort"
                ).astype(jnp.int32)
                pos_c = jnp.clip(pos, 0, out_cap - 1)
                hit = accum.ids[pos_c] == c_id
                plan_mismatch = plan_mismatch | jnp.any(valid_p & ~hit)
                seg = jnp.where(valid_p & hit, pos_c, out_cap)
        else:
            if plan is not None and plan.out_ids is not None:
                # Precomputed union structure (make_plan(accum_ids=...)):
                # valid only for an accumulator with the planned ids —
                # also self-checked into plan_mismatch.
                if plan.out_ids.shape[0] != out_cap:
                    raise ValueError(
                        f"plan union built for out_cap="
                        f"{plan.out_ids.shape[0]}, got {out_cap}"
                    )
                out_ids = plan.out_ids
                # Keep the slot map aligned with the (possibly gemm_cap-
                # sliced) pair arrays.
                seg = plan.seg[:gemm_cap]
                pos_acc, n_unique = plan.pos_acc, plan.n_unique
                plan_mismatch = plan_mismatch | _ids_differ(
                    accum.ids, plan.acc_ids
                )
            else:
                # Output structure = union(product support, accum
                # support): union slots for BOTH inputs come back through
                # one argsort's inverse permutation (basic.union_merge).
                acc_ids = jnp.where(
                    accum.valid_mask(), accum.ids, SENTINEL
                ).astype(jnp.int32)
                out_ids, seg, pos_acc, n_unique = basic.union_merge(
                    c_id, acc_ids, out_cap
                )
            # Invert pos_acc (accum slot -> union slot, unique by the
            # sorted-unique ids invariant; padding -> dropped).
            acc_src = (
                jnp.full((out_cap,), -1, jnp.int32)
                .at[pos_acc]
                .set(jnp.arange(accum.cap, dtype=jnp.int32), mode="drop")
            )
    if backend == "auto":
        backend = resolve_backend(a.block_size, a.dtype)
    out_data = numeric_phase(
        a.data, b.data, a_idx, b_idx, seg, out_cap, backend, precision,
        alpha=alpha, beta=beta,
        acc_data=None if accum is None else accum.data,
        acc_src=acc_src,
    )
    c = BlockMatrix(
        ids=out_ids,
        data=out_data,
        nnz=jnp.minimum(n_unique, out_cap),
        n_rows=a.n_rows,
        n_cols=b.n_cols,
        block_size=a.block_size,
    )
    info = MultiplyInfo(
        n_block_pairs=total,
        n_out_blocks=n_unique,
        pair_overflow=(raw_total > pair_cap) | (total > gemm_cap),
        out_overflow=n_unique > out_cap,
        row_overflow=jnp.zeros((), bool),
        plan_mismatch=plan_mismatch,
        n_leaf_multiplies=n_leaf,
    )
    return c, info


def product_structure(c_id: jax.Array, out_cap: int):
    """Output structure of sorted pair output ids: (out_ids, seg,
    n_unique) — the distinct ids in slots, each pair's slot (`out_cap`
    for SENTINEL pairs, which are dropped) and the distinct count."""
    valid_p = c_id != SENTINEL
    first = jnp.concatenate([jnp.ones((1,), bool), c_id[1:] != c_id[:-1]])
    seg = jnp.where(valid_p, jnp.cumsum(first) - 1, out_cap)
    n_unique = jnp.sum(first & valid_p).astype(jnp.int32)
    out_ids = (
        jnp.full((out_cap,), SENTINEL, jnp.int32)
        .at[seg]
        .set(c_id, mode="drop")
    )
    return out_ids, seg.astype(jnp.int32), n_unique


def _ids_differ(got: jax.Array, want: jax.Array) -> jax.Array:
    """bool[]: two id arrays differ (a shape change counts as drift)."""
    if got.shape != want.shape:
        return jnp.ones((), bool)
    return jnp.any(got != want)


def _leaf_multiplies(a_leaf_occ, b_leaf_occ, a_idx, b_idx, c_id):
    """Logical-leaf multiply count for pairs (A_ik, B_kj): the inner
    leaf index w contributes (leaves in A's leaf-col w) x (leaves in B's
    leaf-row w) products; summed over pairs.  Chunked to bound the
    [pairs, f] gather footprint."""
    ca = jnp.sum(a_leaf_occ, axis=1, dtype=jnp.int32)  # [capA, f]
    rb = jnp.sum(b_leaf_occ, axis=2, dtype=jnp.int32)  # [capB, f]
    pv = c_id != SENTINEL

    def count(ai, bi, m):
        return jnp.sum(jnp.where(m, jnp.sum(ca[ai] * rb[bi], axis=-1), 0))

    pairs_n = a_idx.shape[0]
    ck = _XLA_PAIR_CHUNK
    if pairs_n <= ck:
        return count(a_idx, b_idx, pv).astype(jnp.int32)
    n_chunks = -(-pairs_n // ck)
    pad = n_chunks * ck - pairs_n
    ai_p = jnp.concatenate([a_idx, jnp.zeros((pad,), jnp.int32)])
    bi_p = jnp.concatenate([b_idx, jnp.zeros((pad,), jnp.int32)])
    pv_p = jnp.concatenate([pv, jnp.zeros((pad,), bool)])
    n_leaf, _ = jax.lax.scan(
        lambda tot, sl: (tot + count(*sl), None),
        jnp.zeros((), jnp.int32),
        (
            ai_p.reshape(n_chunks, ck),
            bi_p.reshape(n_chunks, ck),
            pv_p.reshape(n_chunks, ck),
        ),
    )
    return n_leaf


def plan_spgemm_ex(a: BlockMatrix, b: BlockMatrix):
    """Host-side exact plan: (n_pairs, n_out_blocks, max_b_row, max_c_row).

    The row maxima size per-row structures (e.g. `route.plan_route`'s
    stage caps).  C++ fast path in `runtime.native`.
    """
    from hierarchical_block_sparse_lib.runtime import native

    return native.plan_spgemm_ex(
        np.asarray(a.ids), np.asarray(b.ids), a.nb_cols, b.nb_rows, b.nb_cols
    )


def plan_spgemm(a: BlockMatrix, b: BlockMatrix):
    """Host-side exact symbolic plan: returns (n_pairs, n_out_blocks).

    The symbolic phase of SpGEMM run on host (numpy) to size pair_cap /
    out_cap before tracing.  A C++ fast path lives in `runtime.native`.
    """
    from hierarchical_block_sparse_lib.runtime import native

    a_ids = np.asarray(a.ids)
    b_ids = np.asarray(b.ids)
    return native.plan_spgemm(
        a_ids, b_ids, a.nb_cols, b.nb_rows, b.nb_cols
    )


class SyrkPlan:
    """Exact host plan for the symmetric product C = A @ A^T with
    upper-triangle-only (i <= j) enumeration (SURVEY.md section 9.2)."""

    __slots__ = (
        "pairs_raw", "pairs_upper", "out_upper", "out_diag",
        "max_b_row", "max_c_row",
    )

    def __init__(self, pairs_raw, pairs_upper, out_upper, out_diag,
                 max_b_row, max_c_row):
        self.pairs_raw = pairs_raw          # unfiltered enumeration size
        self.pairs_upper = pairs_upper      # leaf GEMMs actually done
        self.out_upper = out_upper          # distinct i<=j output blocks
        self.out_diag = out_diag            # of which diagonal (i==j)
        self.max_b_row = max_b_row          # largest B / C block-row
        self.max_c_row = max_c_row

    @property
    def out_full(self):
        """Distinct output blocks after mirroring."""
        return 2 * self.out_upper - self.out_diag


def plan_syrk(a: BlockMatrix) -> SyrkPlan:
    """Host-side exact plan for `syrk` (C = A @ A^T, upper-only pairs).

    The symbolic workspace still enumerates all `pairs_raw` candidates
    (pair_cap), but only `pairs_upper` survive to the GEMM batch
    (gemm_cap) — about half of the generic matmul(A, A^T) count."""
    ids = np.asarray(a.ids, np.int64)
    ids = ids[ids != int(SENTINEL)]
    nbc, nbr = a.nb_cols, a.nb_rows
    row, col = ids // nbc, ids % nbc
    # A^T in canonical sorted order; its block-rows are A's block-cols.
    at = np.sort(col * nbr + row)
    at_row, at_col = at // nbr, at % nbr
    lo = np.searchsorted(at_row, col, side="left")
    hi = np.searchsorted(at_row, col, side="right")
    cnt = hi - lo
    pairs_raw = int(cnt.sum())
    offs = np.concatenate([[0], np.cumsum(cnt)])
    max_b_row = int(np.bincount(col).max()) if ids.size else 0
    pairs_upper = 0
    out_ids: set = set()
    CHUNK = 1 << 22
    for s in range(0, pairs_raw, CHUNK):
        p = np.arange(s, min(s + CHUNK, pairs_raw))
        e = np.searchsorted(offs, p, side="right") - 1
        t = p - offs[e]
        j = lo[e] + t
        keep = row[e] <= at_col[j]
        pairs_upper += int(keep.sum())
        cid = (row[e] * nbr + at_col[j])[keep]
        out_ids.update(np.unique(cid).tolist())
    if out_ids:
        oid = np.fromiter(out_ids, np.int64)
        out_diag = int(np.sum(oid // nbr == oid % nbr))
        max_c_row = int(np.bincount(oid // nbr).max())
    else:
        out_diag = max_c_row = 0
    return SyrkPlan(
        pairs_raw, pairs_upper, len(out_ids), out_diag, max_b_row, max_c_row
    )


def plan_spamm(a: BlockMatrix, b: BlockMatrix, tau: float):
    """Host-side exact plan for the norm-filtered multiply: returns
    (n_surviving_pairs, n_out_blocks) when pairs with
    ||A_ik||*||B_kj|| <= tau are skipped."""
    from hierarchical_block_sparse_lib.ops.norms import block_frob_squared
    from hierarchical_block_sparse_lib.runtime import native

    a_norms = np.sqrt(np.asarray(block_frob_squared(a)))
    b_norms = np.sqrt(np.asarray(block_frob_squared(b)))
    return native.plan_spamm(
        np.asarray(a.ids), a_norms, np.asarray(b.ids), b_norms,
        a.nb_cols, b.nb_rows, b.nb_cols, tau,
    )


def spamm_error_bound(a: BlockMatrix, b: BlockMatrix, tau: float) -> float:
    """A-priori certificate for the norm-filtered multiply:
    ||A@B - spamm(A,B,tau)||_F <= this bound (sum of skipped pair
    bounds).  Host-side, exact for the given structure."""
    from hierarchical_block_sparse_lib.ops.norms import block_frob_squared
    from hierarchical_block_sparse_lib.runtime import native

    a_norms = np.sqrt(np.asarray(block_frob_squared(a)))
    b_norms = np.sqrt(np.asarray(block_frob_squared(b)))
    return native.spamm_error_bound(
        np.asarray(a.ids), a_norms, np.asarray(b.ids), b_norms,
        a.nb_cols, b.nb_cols, tau,
    )


def spamm(
    a: BlockMatrix,
    b: BlockMatrix,
    tau: float | jax.Array,
    pair_cap: int,
    out_cap: int,
    gemm_cap: int | None = None,
    **kw,
):
    """Error-controlled approximate multiply C ~= A @ B skipping block
    products with ||A_ik||_F * ||B_kj||_F <= tau (the reference lineage's
    SpAMM primitive for purification, SURVEY.md section 1).

    ||C - A@B||_F is bounded by the sum of skipped pair bounds.  Size
    `pair_cap` with `plan_spgemm` (unfiltered enumeration workspace) and
    `gemm_cap`/`out_cap` with `plan_spamm` (surviving GEMM batch).
    """
    return spgemm(
        a, b, pair_cap=pair_cap, out_cap=out_cap, tau=tau,
        filter_by_norm=True, gemm_cap=gemm_cap, **kw,
    )


def pair_bound(a: BlockMatrix, b: BlockMatrix) -> int:
    """Cheap static upper bound on pair count: cap(A) * max-row-nnz(B) is
    unavailable statically, so fall back to cap(A)*cap(B) clamped by the
    dense bound.  Prefer `plan_spgemm` for tight sizing."""
    dense = a.nb_rows * a.nb_cols * b.nb_cols
    return int(min(a.cap * b.cap, dense))
