"""Flat-resident fine-leaf chains (b in {16, 32, 64}).

`FineFlat` keeps each block TRANSPOSED and stored row-major as
`[b*b/128, 128]` rows, and only converts at the chain boundaries
(`fine_pack`/`fine_unpack`).  It is a distinct type (not a BlockMatrix)
so the layout cannot silently leak into payload-sensitive ops
(transpose, to_dense).  The layout once served a device that padded
sub-128 lanes; on the GPU it is only a second view of the canonical
`[cap, b, b]` form, which the multiply reshapes to at entry and exit
(folding it into BlockMatrix is on the ROADMAP).

The elementwise/structural chain ops (add, scale, truncate, frob
norms, filter) are payload-layout agnostic — they reduce or move whole
blocks — so they are thin wrappers over the existing BlockMatrix ops
applied to a flat-payload shim.  The multiply is `spgemm`'s own numeric
phase (`ops.spgemm.numeric_phase`).

Reference parity: this is an internal representation refinement of the
same capability surface (SURVEY.md C1-C12 at the reference's own leaf
sizes); `fine_pack`/`fine_unpack` are the boundary.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib.ops import basic
from hierarchical_block_sparse_lib.ops import truncate as trunc_mod
from hierarchical_block_sparse_lib.ops.spgemm import (
    MultiplyInfo,
    _ids_differ,
    numeric_phase,
    product_structure,
    resolve_backend,
    spgemm_symbolic,
)


def _static(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FineFlat:
    """A fine-leaf block matrix with TRANSPOSED-FLAT payload storage:
    `data[s]` holds `flat(block_s^T)` as [b*b/128, 128] rows;
    ids/nnz semantics identical to BlockMatrix.

    Why transposed: C^T = B^T A^T, so the multiply reads transposed
    payloads and writes a transposed product with no relayout.  All
    chain ops here (add/scale/truncate/norms) are payload-layout
    agnostic, so the convention is invisible except at
    `fine_pack`/`fine_unpack`."""

    ids: jax.Array  # int32[cap], sorted, SENTINEL-padded
    data: jax.Array  # f32[cap, b*b/128, 128], zero-padded
    nnz: jax.Array  # int32[]
    n_rows: int = _static(default=0)
    n_cols: int = _static(default=0)
    block_size: int = _static(default=32)

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
    def fr(self) -> int:
        return (self.block_size * self.block_size) // 128


def fine_pack(a: BlockMatrix) -> FineFlat:
    """Canonical -> transposed-flat (one cheap fused XLA relayout)."""
    b = a.block_size
    if b not in (16, 32, 64):
        raise ValueError(f"fine layout needs b in (16,32,64), got {b}")
    fr = (b * b) // 128
    return FineFlat(
        ids=a.ids,
        data=jnp.swapaxes(a.data.astype(jnp.float32), -1, -2).reshape(
            a.cap, fr, 128
        ),
        nnz=a.nnz,
        n_rows=a.n_rows,
        n_cols=a.n_cols,
        block_size=b,
    )


def fine_unpack(f: FineFlat) -> BlockMatrix:
    """Transposed-flat -> canonical (pays the padded-payload write
    once, at the chain boundary)."""
    b = f.block_size
    return BlockMatrix(
        ids=f.ids,
        data=jnp.swapaxes(f.data.reshape(f.cap, b, b), -1, -2),
        nnz=f.nnz,
        n_rows=f.n_rows,
        n_cols=f.n_cols,
        block_size=b,
    )


def _shim(f: FineFlat) -> BlockMatrix:
    """BlockMatrix view with flat payloads — ONLY for the
    payload-layout-agnostic ops used below (add/scale/truncate/norms
    reduce or move whole blocks; they never index inside a payload)."""
    return BlockMatrix(
        ids=f.ids, data=f.data, nnz=f.nnz,
        n_rows=f.n_rows, n_cols=f.n_cols, block_size=f.block_size,
    )


def _unshim(m: BlockMatrix, b: int) -> FineFlat:
    return FineFlat(
        ids=m.ids, data=m.data, nnz=m.nnz,
        n_rows=m.n_rows, n_cols=m.n_cols, block_size=b,
    )


def fine_add(
    a: FineFlat, b: FineFlat, alpha=1.0, beta=1.0, cap: int | None = None
) -> FineFlat:
    """C = alpha*A + beta*B (structural union, flat payloads)."""
    return _unshim(
        basic.add(_shim(a), _shim(b), alpha=alpha, beta=beta, cap=cap),
        a.block_size,
    )


def fine_scale(a: FineFlat, alpha) -> FineFlat:
    return dataclasses.replace(
        a, data=a.data * jnp.asarray(alpha, a.data.dtype)
    )


def fine_frob_squared(a: FineFlat) -> jax.Array:
    """Sum of squares is payload-layout invariant."""
    return jnp.sum(jnp.square(a.data.astype(jnp.float32)))


def fine_trace(a: FineFlat) -> jax.Array:
    """Matrix trace on transposed-flat payloads: trace(X^T) == trace(X),
    and diagonal element i of a flat [fr,128] payload sits at
    (i // f, b*(i % f) + i) with f = 128/b — a static gather."""
    b = a.block_size
    f = 128 // b
    ii = np.arange(b)
    gs = jnp.asarray((ii // f).astype(np.int32))
    lanes = jnp.asarray((b * (ii % f) + ii).astype(np.int32))
    is_diag = (a.ids // a.nb_cols) == (a.ids % a.nb_cols)
    block_traces = a.data[:, gs, lanes].sum(axis=-1)
    return jnp.sum(
        jnp.where(
            (a.ids != SENTINEL) & is_diag,
            block_traces.astype(jnp.float32),
            0.0,
        )
    )


def fine_sp2_step(
    x: FineFlat,
    tau,
    pair_cap: int,
    out_cap: int,
    target_trace,
    precision: str = "highest",
    cap: int | None = None,
    plan: FinePlan | None = None,
):
    """One SP2 purification step at the reference's FINE leaf
    granularity, entirely on the flat engine:
    X' = trunc((2s-1)*X^2 + (2-2s)*X), s = [trace(X) > target].
    Returns (FineFlat, (trace, MultiplyInfo)).  The flagship workload
    (SURVEY.md section 4.3) at the reference's own 16/32 leaves; b=128
    chains use models.purification."""
    t = fine_trace(x)
    s = (t > jnp.asarray(target_trace, jnp.float32)).astype(jnp.float32)
    x2, info = fine_matmul(
        x, x, pair_cap=pair_cap, out_cap=out_cap,
        precision=precision, plan=plan,
    )
    y = fine_add(x2, x, alpha=2.0 * s - 1.0, beta=2.0 - 2.0 * s,
                 cap=out_cap + x.cap)
    y = fine_truncate(y, tau, cap=cap if cap is not None else x.cap)
    return y, (t, info)


def fine_truncate(
    a: FineFlat, tau, cap: int | None = None
) -> FineFlat:
    """Leaf truncation (block frob norms are layout-invariant).  With
    `cap`, the kept-count that `truncate` returns alongside the matrix
    is dropped here — use the canonical path if you need it."""
    out = trunc_mod.truncate(_shim(a), tau, cap=cap)
    if cap is not None:
        out = out[0]
    return _unshim(out, a.block_size)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FinePlan:
    """Frozen structural plan for `fine_matmul`: the pair lists and the
    output structure, so a fixed-structure fine chain runs only the
    numeric phase.  Valid while both operands keep exactly the recorded
    id structure; staleness self-checked on use."""

    a_idx: jax.Array  # int32[pair_cap] pairs sorted by output block
    b_idx: jax.Array  # int32[pair_cap]
    seg: jax.Array  # int32[pair_cap] pair -> output slot (out_cap: none)
    out_ids: jax.Array  # int32[out_cap] sorted product support
    n_unique: jax.Array  # int32[]
    total: jax.Array  # int32[] pairs
    raw_total: jax.Array  # int32[]
    a_ids: jax.Array
    b_ids: jax.Array


def make_fine_plan(a, b, pair_cap: int, out_cap: int) -> FinePlan:
    """Plan a fixed-structure fine multiply (operands: FineFlat or
    BlockMatrix — only ids/geometry matter)."""
    sa = a if isinstance(a, BlockMatrix) else _shim(a)
    sb = b if isinstance(b, BlockMatrix) else _shim(b)
    a_idx, b_idx, c_id, total, raw_total = spgemm_symbolic(sa, sb, pair_cap)
    out_ids, seg, n_unique = product_structure(c_id, out_cap)
    return FinePlan(
        a_idx=a_idx, b_idx=b_idx, seg=seg, out_ids=out_ids,
        n_unique=n_unique, total=total, raw_total=raw_total,
        a_ids=sa.ids, b_ids=sb.ids,
    )


@partial(
    jax.jit, static_argnames=("pair_cap", "out_cap", "precision", "backend")
)
def fine_matmul(
    a: FineFlat,
    b: FineFlat,
    pair_cap: int,
    out_cap: int,
    alpha: float | jax.Array = 1.0,
    precision: str = "highest",
    plan: FinePlan | None = None,
    backend: str = "auto",
):
    """C = alpha * A @ B on flat payloads; returns (FineFlat,
    MultiplyInfo).  `plan` (make_fine_plan) freezes the whole structural
    cost — symbolic phase and output structure — so the fixed-structure
    fine chain runs numeric-only.  `backend` as in `spgemm`.

    The payloads are transposed blocks and C^T = B^T A^T, so the
    numeric phase takes B's payloads as its left operand and A's as its
    right: no payload is transposed."""
    if a.n_cols != b.n_rows or a.block_size != b.block_size:
        raise ValueError("inner dims/block mismatch")
    plan_mismatch = jnp.zeros((), bool)
    if plan is None:
        a_idx, b_idx, c_id, total, raw_total = spgemm_symbolic(
            _shim(a), _shim(b), pair_cap
        )
        out_ids, seg, n_unique = product_structure(c_id, out_cap)
    else:
        if plan.out_ids.shape[0] != out_cap:
            raise ValueError("plan out_cap mismatch")
        if plan.a_idx.shape[0] != pair_cap:
            raise ValueError("plan pair_cap mismatch")
        a_idx, b_idx, seg, out_ids = (
            plan.a_idx, plan.b_idx, plan.seg, plan.out_ids,
        )
        n_unique, total, raw_total = (
            plan.n_unique, plan.total, plan.raw_total,
        )
        for got, want in ((a.ids, plan.a_ids), (b.ids, plan.b_ids)):
            plan_mismatch = plan_mismatch | _ids_differ(got, want)
    bs = a.block_size
    if backend == "auto":
        backend = resolve_backend(bs, a.data.dtype)
    out = numeric_phase(
        b.data.reshape(b.cap, bs, bs), a.data.reshape(a.cap, bs, bs),
        b_idx, a_idx, seg, out_cap, backend, precision, alpha=alpha,
    )
    c = FineFlat(
        ids=out_ids, data=out.reshape(out_cap, a.fr, 128),
        nnz=jnp.minimum(n_unique, out_cap),
        n_rows=a.n_rows, n_cols=b.n_cols, block_size=bs,
    )
    info = MultiplyInfo(
        n_block_pairs=total,
        n_out_blocks=n_unique,
        pair_overflow=raw_total > pair_cap,
        out_overflow=n_unique > out_cap,
        row_overflow=jnp.zeros((), bool),
        plan_mismatch=plan_mismatch,
        n_leaf_multiplies=total,
    )
    return c, info
