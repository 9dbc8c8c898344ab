"""Distributed block-sparse matrices over a device mesh.

The replacement for the reference lineage's MPI/Chunks-and-Tasks
distribution (SURVEY.md section 4.5, PAPERS.md arXiv 1501.07800; mandate:
BASELINE.json:5 "collective-based distributed block router").

Scheme: 1-D block-row partition over mesh axis 'p' — device d owns the
block-row slab [d*nbr/P, (d+1)*nbr/P).  A and C are row-sharded (so SpGEMM
accumulation is device-local: C's block row i is produced only from A's
block row i); B circulates around the ring, one shard per stage
(SUMMA-style).  The `ppermute` of the next B shard is issued before the
current stage's batched leaf GEMMs, so XLA's latency-hiding scheduler
overlaps the ICI transfer with compute (BASELINE.json:5 "overlapped
with leaf GEMM compute").  Norm/trace reductions are `psum`.

A distributed matrix is an ordinary `BlockMatrix` whose arrays carry a
leading mesh-axis dimension [P, cap_local, ...], sharded over 'p'; ids
stay in GLOBAL block coordinates, so the local compute is the unmodified
single-chip ops.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib.core import assembly
from hierarchical_block_sparse_lib.kernels import segment_gemm
from hierarchical_block_sparse_lib.ops import basic
from hierarchical_block_sparse_lib.ops.spgemm import spgemm
from hierarchical_block_sparse_lib.ops.truncate import truncate


def make_mesh(n_devices: int | None = None, axis: str = "p") -> Mesh:
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def owner_of_block_row(brow, nbr: int, n_dev: int):
    """Device owning a block row: equal contiguous slabs."""
    return jnp.minimum(brow * n_dev // max(nbr, 1), n_dev - 1)


def distribute(m: BlockMatrix, mesh: Mesh, axis: str = "p") -> BlockMatrix:
    """Partition a host/global BlockMatrix by block-row slab into a
    [P, cap_local, ...] sharded BlockMatrix (host-side shuffle)."""
    n_dev = mesh.shape[axis]
    ids = np.asarray(m.ids)
    data = np.asarray(m.data)
    valid = ids != SENTINEL
    brow = np.where(valid, ids // m.nb_cols, 0)
    owner = np.minimum(brow * n_dev // max(m.nb_rows, 1), n_dev - 1)
    owner = np.where(valid, owner, -1)
    counts = [int((owner == d).sum()) for d in range(n_dev)]
    cap_local = max(max(counts), 1)
    out_ids = np.full((n_dev, cap_local), SENTINEL, np.int32)
    out_data = np.zeros((n_dev, cap_local) + data.shape[1:], data.dtype)
    nnz = np.zeros((n_dev,), np.int32)
    for d in range(n_dev):
        sel = owner == d
        k = counts[d]
        out_ids[d, :k] = ids[sel]
        out_data[d, :k] = data[sel]
        nnz[d] = k
    sh = NamedSharding(mesh, P(axis))
    return BlockMatrix(
        ids=jax.device_put(out_ids, sh),
        data=jax.device_put(out_data, sh),
        nnz=jax.device_put(nnz, sh),
        n_rows=m.n_rows,
        n_cols=m.n_cols,
        block_size=m.block_size,
    )


def undistribute(m: BlockMatrix) -> BlockMatrix:
    """Gather a distributed matrix back to one canonical global matrix."""
    from hierarchical_block_sparse_lib.core.block_matrix import (
        compact_sorted,
    )

    ids = jnp.asarray(m.ids).reshape(-1)
    data = jnp.asarray(m.data).reshape((-1,) + m.data.shape[2:])
    cap = ids.shape[0]
    out_ids, out_data, nnz = compact_sorted(ids, data, cap)
    return BlockMatrix(
        ids=out_ids, data=out_data, nnz=nnz,
        n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size,
    )


def _local(m: BlockMatrix) -> BlockMatrix:
    """Strip the leading mesh dim inside shard_map (shape [1, cap, ...])."""
    return dataclasses.replace(
        m, ids=m.ids[0], data=m.data[0], nnz=m.nnz[0]
    )


def _relift(m: BlockMatrix) -> BlockMatrix:
    return dataclasses.replace(
        m, ids=m.ids[None], data=m.data[None], nnz=m.nnz[None]
    )


def _ppermute_next(m: BlockMatrix, axis: str) -> BlockMatrix:
    """Rotate shards one step around the ring (stage s -> s+1)."""
    n = jax.lax.axis_size(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    return dataclasses.replace(
        m,
        ids=jax.lax.ppermute(m.ids, axis, perm),
        data=jax.lax.ppermute(m.data, axis, perm),
        nnz=jax.lax.ppermute(m.nnz, axis, perm),
    )


def dist_spgemm(
    a: BlockMatrix,
    b: BlockMatrix,
    mesh: Mesh,
    pair_cap: int,
    out_cap: int,
    stage_out_cap: int | None = None,
    alpha=1.0,
    axis: str = "p",
    backend: str = "auto",
    precision: str = "highest",
    row_caps: tuple | None = None,
):
    """Distributed C = alpha * A @ B with ring-rotated B panels.

    `pair_cap`/`stage_out_cap` are per-device per-stage capacities;
    `out_cap` is the per-device capacity of the result; `row_caps` is
    deprecated and ignored.
    Returns (C distributed, total block pairs across all devices).
    """
    n_dev = mesh.shape[axis]
    stage_out_cap = stage_out_cap or out_cap

    def body(a_l, b_l):
        a_loc = _local(a_l)
        b_cur = _local(b_l)
        c = assembly.empty(
            a_loc.n_rows, b_loc_ncols, a_loc.block_size, out_cap,
            dtype=a_loc.dtype,
        )
        # Mark constant-initialized carries as device-varying so the
        # fori_loop carry type matches the per-device stage outputs.
        _vary = lambda x: jax.lax.pcast(x, (axis,), to="varying")
        c = jax.tree.map(_vary, c)
        pairs = _vary(jnp.zeros((), jnp.int32))
        ovf = _vary(jnp.zeros((), bool))

        def stage(_, carry):
            c, b_cur, pairs, ovf = carry
            # Issue the ring transfer FIRST so XLA can overlap it with
            # this stage's batched leaf GEMMs (both read-only on b_cur).
            b_nxt = _ppermute_next(b_cur, axis)
            c_s, info = spgemm(
                a_loc,
                b_cur,
                pair_cap=pair_cap,
                out_cap=stage_out_cap,
                row_caps=row_caps,
                backend=backend,
                precision=precision,
            )
            c, add_ovf = basic.add_with_info(c, c_s, cap=out_cap)
            pairs = pairs + info.n_block_pairs
            ovf = (
                ovf | info.pair_overflow | info.out_overflow
                | info.row_overflow | add_ovf
            )
            return c, b_nxt, pairs, ovf

        c, _, pairs, ovf = jax.lax.fori_loop(
            0, n_dev, stage, (c, b_cur, pairs, ovf)
        )
        c = basic.scale(c, jnp.asarray(alpha, c.dtype))
        total_pairs = jax.lax.psum(pairs, axis)
        any_ovf = jax.lax.pmax(ovf.astype(jnp.int32), axis) > 0
        return _relift(c), total_pairs[None], any_ovf[None]

    b_loc_ncols = b.n_cols
    spec = BlockMatrix(
        ids=P(axis), data=P(axis), nnz=P(axis),
        n_rows=a.n_rows, n_cols=a.n_cols, block_size=a.block_size,
    )
    c_spec = dataclasses.replace(
        spec, n_rows=a.n_rows, n_cols=b.n_cols
    )
    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec, dataclasses.replace(spec, n_rows=b.n_rows, n_cols=b.n_cols)),
        out_specs=(c_spec, P(axis), P(axis)),
        check_vma=segment_gemm.vma_check(),
    )
    c, pairs, ovf = f(a, b)
    return c, pairs.sum() // max(mesh.shape[axis], 1), ovf.any()


def dist_frob_squared(m: BlockMatrix, mesh: Mesh, axis: str = "p"):
    def body(m_l):
        loc = _local(m_l)
        s = jnp.sum(jnp.square(loc.data.astype(jnp.float32)))
        return jax.lax.psum(s, axis)[None]

    spec = BlockMatrix(
        ids=P(axis), data=P(axis), nnz=P(axis),
        n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size,
    )
    out = jax.shard_map(
        body, mesh=mesh, in_specs=(spec,), out_specs=P(axis)
    )(m)
    return out[0]


def dist_truncate(m: BlockMatrix, mesh: Mesh, tau, axis: str = "p"):
    """Truncation is fully local under row partitioning (SURVEY.md 8.3)."""

    def body(m_l):
        return _relift(truncate(_local(m_l), tau))

    spec = BlockMatrix(
        ids=P(axis), data=P(axis), nnz=P(axis),
        n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size,
    )
    return jax.shard_map(
        body, mesh=mesh, in_specs=(spec,), out_specs=spec
    )(m)


def dist_trace(m: BlockMatrix, mesh: Mesh, axis: str = "p"):
    """Global trace: local diagonal-block traces + psum."""
    from hierarchical_block_sparse_lib.ops.norms import trace as _trace

    def body(m_l):
        return jax.lax.psum(_trace(_local(m_l)), axis)[None]

    spec = BlockMatrix(
        ids=P(axis), data=P(axis), nnz=P(axis),
        n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size,
    )
    out = jax.shard_map(
        body, mesh=mesh, in_specs=(spec,), out_specs=P(axis)
    )(m)
    return out[0]


def dist_sp2_step(
    x: BlockMatrix,
    mesh: Mesh,
    tau,
    pair_cap: int,
    out_cap: int,
    stage_out_cap: int | None = None,
    target_trace=0.0,
    axis: str = "p",
    backend: str = "auto",
    precision: str = "highest",
    cap: int | None = None,
    row_caps: tuple | None = None,
):
    """One distributed SP2 purification step (the flagship workload of
    BASELINE.json:9 over the mesh): ring-SUMMA X@X with overlapped
    ppermute transfers, trace-selected polynomial blend, fully-local
    norm truncation, all inside one shard_map program.

    The row partition makes every non-multiply op device-local: C's
    block-row i comes only from X's block-row i (add/truncate/repack
    local), and the trace needs one psum.  Returns
    (X_next distributed, stats dict of scalars).
    """
    from hierarchical_block_sparse_lib.ops.norms import trace as _trace
    from hierarchical_block_sparse_lib.ops.spgemm import spgemm as _spgemm

    n_dev = mesh.shape[axis]
    stage_out_cap = stage_out_cap or out_cap
    # Per-device iterate capacity: the truncated iterate densifies toward
    # the union support before re-sparsifying, so default to out_cap
    # (the step result's own capacity), not the input's local cap.
    x_cap = out_cap if cap is None else cap

    def body(x_l):
        x_loc = _local(x_l)
        t = jax.lax.psum(_trace(x_loc), axis)
        # Ring-SUMMA X @ X: A-role = resident row slab, B-role rotates.
        c = assembly.empty(
            x_loc.n_rows, x_loc.n_cols, x_loc.block_size, out_cap,
            dtype=x_loc.dtype,
        )
        _vary = lambda v: jax.lax.pcast(v, (axis,), to="varying")  # noqa: E731
        c = jax.tree.map(_vary, c)
        pairs = _vary(jnp.zeros((), jnp.int32))
        ovf = _vary(jnp.zeros((), bool))
        b_cur = x_loc

        def stage(_, carry):
            c, b_cur, pairs, ovf = carry
            b_nxt = _ppermute_next(b_cur, axis)
            c_s, info = _spgemm(
                x_loc, b_cur, pair_cap=pair_cap, out_cap=stage_out_cap,
                row_caps=row_caps, backend=backend, precision=precision,
            )
            c, add_ovf = basic.add_with_info(c, c_s, cap=out_cap)
            pairs = pairs + info.n_block_pairs
            ovf = (
                ovf | info.pair_overflow | info.out_overflow
                | info.row_overflow | add_ovf
            )
            return c, b_nxt, pairs, ovf

        x2, _, pairs, ovf = jax.lax.fori_loop(
            0, n_dev, stage, (c, b_cur, pairs, ovf)
        )
        # X_next = (2s-1)*X^2 + (2-2s)*X, s = [trace > target] (the same
        # lax.cond-free blend as the single-chip sp2_step).
        s = (t > jnp.asarray(target_trace, t.dtype)).astype(x_loc.dtype)
        y = basic.add(x2, x_loc, alpha=2.0 * s - 1.0, beta=2.0 - 2.0 * s)
        # Fused truncate+repack: one compaction pass straight into x_cap.
        y, nnz_kept = truncate(y, tau, cap=x_cap)
        # (output spec cap == x_cap regardless of the input's local cap)
        total_pairs = jax.lax.psum(pairs, axis)
        any_ovf = (
            jax.lax.pmax(
                (ovf | (nnz_kept > x_cap)).astype(jnp.int32), axis
            ) > 0
        )
        return _relift(y), t[None], total_pairs[None], any_ovf[None]

    spec = BlockMatrix(
        ids=P(axis), data=P(axis), nnz=P(axis),
        n_rows=x.n_rows, n_cols=x.n_cols, block_size=x.block_size,
    )
    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec,),
        out_specs=(spec, P(axis), P(axis), P(axis)),
        check_vma=segment_gemm.vma_check(),
    )
    y, t, pairs, ovf = f(x)
    return y, dict(
        trace=t[0], n_block_pairs=pairs[0], overflow=ovf.reshape(-1)[0] > 0
    )
