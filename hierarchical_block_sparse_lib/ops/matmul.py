"""Eager convenience multiply: exact host planning + auto dispatch.

`spgemm` is the jit-composable core (static capacities supplied by the
caller); `matmul` is the eager front door that plans capacities exactly
on the host (C++ planner) — the one-liner equivalent of the reference's
``multiply(A, tA, B, tB, C)`` (SURVEY.md C5).
"""

from __future__ import annotations

import jax

from hierarchical_block_sparse_lib.core.block_matrix import BlockMatrix
from hierarchical_block_sparse_lib.ops import basic
from hierarchical_block_sparse_lib.ops.spgemm import (
    plan_spgemm,
    spgemm,
)


def matmul(
    a: BlockMatrix,
    b: BlockMatrix,
    alpha: float | jax.Array = 1.0,
    transpose_a: bool = False,
    transpose_b: bool = False,
    precision: str = "highest",
    backend: str = "auto",
):
    """C = alpha * op(A) @ op(B), exactly sized.  Returns (C, MultiplyInfo).

    Eager (plans on host per structure); inside jit/scan loops use
    `spgemm` with precomputed capacities instead.

    Banded structures: this functional front door does not route through
    the dense-band tier, whose pack/unpack boundary conversions pay only
    when the band form is HELD across calls.  Use `ops.band` directly
    (pack once, `band_mm` per iteration), or the OO
    `api.HierarchicalBlockSparseMatrix.multiply`, which probes the
    structure (`band_probe`) and keeps results band-resident across
    multiplies.
    """
    ae = basic.transpose(a) if transpose_a else a
    be = basic.transpose(b) if transpose_b else b
    pc, oc = plan_spgemm(ae, be)
    return spgemm(
        ae,
        be,
        pair_cap=max(pc, 1),
        out_cap=max(oc, 1),
        alpha=alpha,
        precision=precision,
        backend=backend,
    )


def syrk(
    a: BlockMatrix,
    alpha: float | jax.Array = 1.0,
    transpose: bool = False,
    precision: str = "highest",
    backend: str = "auto",
    full: bool = True,
):
    """Symmetric rank-k product: C = alpha * A @ A^T (or A^T @ A with
    `transpose=True`) — the reference-style symm/rank-k surface
    (SURVEY.md section 9.2), *symmetry-exploiting*: only upper-triangle
    (block_row <= block_col) outputs are computed, roughly
    halving the leaf-GEMM count vs the generic multiply; the lower
    triangle is mirrored afterwards as C_ji = C_ij^T (cheap transpose +
    structural union, no GEMMs).

    With `full=False` only the upper-triangle part is returned.
    `info.n_block_pairs` counts the GEMMs actually performed (upper
    pairs).  Returns (C, MultiplyInfo)."""
    from hierarchical_block_sparse_lib.ops.spgemm import plan_syrk

    ae = basic.transpose(a) if transpose else a
    at = basic.transpose(ae)
    plan = plan_syrk(ae)
    cu, info = spgemm(
        ae,
        at,
        pair_cap=max(plan.pairs_raw, 1),
        gemm_cap=max(plan.pairs_upper, 1),
        out_cap=max(plan.out_upper, 1),
        alpha=alpha,
        precision=precision,
        backend=backend,
        syrk_upper=True,
    )
    if not full:
        return cu, info
    low = basic.transpose(basic.triu(cu, strict=True))
    c, add_ovf = basic.add_with_info(cu, low, cap=max(plan.out_full, 1))
    import dataclasses

    info = dataclasses.replace(info, out_overflow=info.out_overflow | add_ovf)
    return c, info
