"""2D-mesh distributed SpGEMM: Cannon's algorithm on the device torus.

The 1D ring (`parallel.dist`) rotates whole B row-slabs and keeps A/C
resident; its per-device memory for B panels scales with the full matrix
width.  This module block-partitions BOTH operands over a square 2D mesh
(SURVEY.md section 8.3 "2D block partition of the hierarchy over the
device mesh"), the layout the reference lineage uses for its distributed
runs (CHTML's 2D-cyclic chunks, PAPERS.md arXiv 1501.07800), re-expressed
the JAX way: `shard_map` over a ("r", "c") mesh with `ppermute`
rotations that ride the ICI torus.

Cannon's algorithm: after pre-skewing (A's row i shifted i steps left,
B's column j shifted j steps up), every device (i, j) holds A_{i, i+j}
and B_{i+j, j}; P local multiply-accumulates interleaved with A-left /
B-up rotations produce C_{i,j} = sum_k A_{i,k} B_{k,j} entirely in
place: per-device memory is O(1) shards, every transfer is a
nearest-neighbor ICI hop, and both rotations are issued before the
stage's batched leaf GEMMs so XLA overlaps them with compute
(BASELINE.json:5 "overlapped with leaf GEMM compute").

A distributed matrix here is a BlockMatrix whose arrays carry two
leading mesh dims [Pr, Pc, cap_local, ...] sharded over ("r", "c");
ids stay GLOBAL, so local compute is the unmodified single-chip ops.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib.core import assembly
from hierarchical_block_sparse_lib.ops import basic
from hierarchical_block_sparse_lib.ops.spgemm import spgemm
from hierarchical_block_sparse_lib.ops.truncate import truncate


def make_mesh2d(p: int | None = None) -> Mesh:
    """Square p x p mesh over the first p^2 devices."""
    devs = jax.devices()
    if p is None:
        p = int(np.sqrt(len(devs)))
    if p * p > len(devs):
        raise ValueError(f"need {p * p} devices, have {len(devs)}")
    return Mesh(np.array(devs[: p * p]).reshape(p, p), ("r", "c"))


def distribute2d(m: BlockMatrix, mesh: Mesh) -> BlockMatrix:
    """Partition into (row-slab, col-slab) tiles over the 2D mesh."""
    pr, pc = mesh.shape["r"], mesh.shape["c"]
    ids = np.asarray(m.ids)
    data = np.asarray(m.data)
    valid = ids != SENTINEL
    brow = np.where(valid, ids // m.nb_cols, 0)
    bcol = np.where(valid, ids % m.nb_cols, 0)
    dr = np.minimum(brow * pr // max(m.nb_rows, 1), pr - 1)
    dc = np.minimum(bcol * pc // max(m.nb_cols, 1), pc - 1)
    owner = np.where(valid, dr * pc + dc, -1)
    counts = np.bincount(owner[owner >= 0], minlength=pr * pc)
    cap_local = max(int(counts.max()), 1)
    out_ids = np.full((pr, pc, cap_local), SENTINEL, np.int32)
    out_data = np.zeros((pr, pc, cap_local) + data.shape[1:], data.dtype)
    nnz = np.zeros((pr, pc), np.int32)
    for d in range(pr * pc):
        sel = owner == d
        k = int(sel.sum())
        out_ids[d // pc, d % pc, :k] = ids[sel]
        out_data[d // pc, d % pc, :k] = data[sel]
        nnz[d // pc, d % pc] = k
    sh = NamedSharding(mesh, P("r", "c"))
    return BlockMatrix(
        ids=jax.device_put(out_ids, sh),
        data=jax.device_put(out_data, sh),
        nnz=jax.device_put(nnz, sh),
        n_rows=m.n_rows,
        n_cols=m.n_cols,
        block_size=m.block_size,
    )


def undistribute2d(m: BlockMatrix) -> BlockMatrix:
    from hierarchical_block_sparse_lib.core.block_matrix import (
        compact_sorted,
    )

    ids = jnp.asarray(m.ids).reshape(-1)
    data = jnp.asarray(m.data).reshape((-1,) + m.data.shape[3:])
    out_ids, out_data, nnz = compact_sorted(ids, data, ids.shape[0])
    return BlockMatrix(
        ids=out_ids, data=out_data, nnz=nnz,
        n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size,
    )


def _local(m: BlockMatrix) -> BlockMatrix:
    return dataclasses.replace(
        m, ids=m.ids[0, 0], data=m.data[0, 0], nnz=m.nnz[0, 0]
    )


def _relift(m: BlockMatrix) -> BlockMatrix:
    return dataclasses.replace(
        m, ids=m.ids[None, None], data=m.data[None, None], nnz=m.nnz[None, None]
    )


def _shift(m: BlockMatrix, axis: str, perm) -> BlockMatrix:
    return dataclasses.replace(
        m,
        ids=jax.lax.ppermute(m.ids, axis, perm),
        data=jax.lax.ppermute(m.data, axis, perm),
        nnz=jax.lax.ppermute(m.nnz, axis, perm),
    )


def _rotate_minus1(m: BlockMatrix, axis: str, p: int) -> BlockMatrix:
    """Shift shards one step towards lower index (left/up) on the ring."""
    perm = [(i, (i - 1) % p) for i in range(p)]
    return _shift(m, axis, perm)


def _skew(m: BlockMatrix, shift_axis: str, by_axis: str, p: int) -> BlockMatrix:
    """Cannon pre-skew: along `shift_axis`, rotate shard index down by the
    device's index on `by_axis` (row i of A moves i steps left).

    One static source->dest `ppermute` over the linearized ("r", "c")
    axis pair — the shift amount varies per row/column, which a
    single-axis perm cannot express, but the combined-axis perm can.
    (Replaces p-1 masked whole-shard rotations: each shard now moves
    exactly one hop-distance instead of up to p-1 serial hops.)"""
    perm = []
    for r in range(p):
        for c in range(p):
            src = r * p + c
            if shift_axis == "c":
                dst = r * p + ((c - r) % p)
            else:
                dst = ((r - c) % p) * p + c
            perm.append((src, dst))
    return _shift(m, ("r", "c"), perm)


def dist2d_spgemm(
    a: BlockMatrix,
    b: BlockMatrix,
    mesh: Mesh,
    pair_cap: int,
    out_cap: int,
    stage_out_cap: int | None = None,
    alpha=1.0,
    backend: str = "auto",
    precision: str = "highest",
):
    """C = alpha * A @ B over a square 2D mesh via Cannon's algorithm.

    `pair_cap`/`stage_out_cap` bound each device's per-stage symbolic
    enumeration and stage output; `out_cap` the per-device result tile.
    Returns (C distributed, total_block_pairs, any_overflow).
    """
    pr, pc = mesh.shape["r"], mesh.shape["c"]
    if pr != pc:
        raise ValueError(f"Cannon needs a square mesh, got {pr}x{pc}")
    p = pr
    stage_out_cap = stage_out_cap or out_cap

    def body(a_l, b_l):
        a_cur = _local(a_l)
        b_cur = _local(b_l)
        # Pre-skew: A row i left by i, B column j up by j.
        a_cur = _skew(a_cur, "c", "r", p)
        b_cur = _skew(b_cur, "r", "c", p)

        c = assembly.empty(
            a_cur.n_rows, b_cur.n_cols, a_cur.block_size, out_cap,
            dtype=a_cur.dtype,
        )
        _vary = lambda x: jax.lax.pcast(x, ("r", "c"), to="varying")  # noqa: E731
        c = jax.tree.map(_vary, c)
        pairs = _vary(jnp.zeros((), jnp.int32))
        ovf = _vary(jnp.zeros((), bool))

        def stage(s, carry):
            c, a_cur, b_cur, pairs, ovf = carry
            # Issue both nearest-neighbor rotations FIRST so XLA overlaps
            # the ICI hops with this stage's batched leaf GEMMs.
            a_nxt = _rotate_minus1(a_cur, "c", p)
            b_nxt = _rotate_minus1(b_cur, "r", p)
            c_s, info = spgemm(
                a_cur,
                b_cur,
                pair_cap=pair_cap,
                out_cap=stage_out_cap,
                backend=backend,
                precision=precision,
            )
            c, add_ovf = basic.add_with_info(c, c_s, cap=out_cap)
            pairs = pairs + info.n_block_pairs
            ovf = (
                ovf | info.pair_overflow | info.out_overflow
                | info.row_overflow | add_ovf
            )
            return c, a_nxt, b_nxt, pairs, ovf

        c, _, _, pairs, ovf = jax.lax.fori_loop(
            0, p, stage, (c, a_cur, b_cur, pairs, ovf)
        )
        c = basic.scale(c, jnp.asarray(alpha, c.dtype))
        total = jax.lax.psum(jax.lax.psum(pairs, "r"), "c")
        any_ovf = (
            jax.lax.pmax(jax.lax.pmax(ovf.astype(jnp.int32), "r"), "c") > 0
        )
        return _relift(c), total[None, None], any_ovf[None, None]

    def spec_of(m, n_rows, n_cols):
        return BlockMatrix(
            ids=P("r", "c"), data=P("r", "c"), nnz=P("r", "c"),
            n_rows=n_rows, n_cols=n_cols, block_size=m.block_size,
        )

    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            spec_of(a, a.n_rows, a.n_cols),
            spec_of(b, b.n_rows, b.n_cols),
        ),
        out_specs=(spec_of(a, a.n_rows, b.n_cols), P("r", "c"), P("r", "c")),
        check_vma=False,
    )
    c, pairs, ovf = f(a, b)
    return c, pairs.reshape(-1)[0], ovf.reshape(-1).any()


def dist2d_frob_squared(m: BlockMatrix, mesh: Mesh):
    def body(m_l):
        s = jnp.sum(jnp.square(m_l.data[0, 0].astype(jnp.float32)))
        return jax.lax.psum(jax.lax.psum(s, "r"), "c")[None, None]

    spec = BlockMatrix(
        ids=P("r", "c"), data=P("r", "c"), nnz=P("r", "c"),
        n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size,
    )
    out = jax.shard_map(
        body, mesh=mesh, in_specs=(spec,), out_specs=P("r", "c"),
        check_vma=False,
    )(m)
    return out.reshape(-1)[0]


def dist2d_truncate(m: BlockMatrix, mesh: Mesh, tau):
    """Truncation is fully local under any block partition."""

    def body(m_l):
        return _relift(truncate(_local(m_l), tau))

    spec = BlockMatrix(
        ids=P("r", "c"), data=P("r", "c"), nnz=P("r", "c"),
        n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size,
    )
    return jax.shard_map(
        body, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False
    )(m)
