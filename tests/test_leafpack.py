"""Leaf-strip packing SpGEMM (ops.leafpack) vs dense oracle and vs the
pair-enumeration path — the occupancy-aware fine-leaf engine
(SURVEY.md section 8.5; VERDICT r2 item 1)."""

import numpy as np
import pytest

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.ops.leafpack import (
    leafpack_spgemm,
    plan_leafpack,
)
from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib.utils import generators as gen


def _oracle_check(A, B, dA, dB, strip_rows=128, alpha=1.0):
    plan = plan_leafpack(A, B, strip_rows=strip_rows)
    assert plan is not None
    C, info = leafpack_spgemm(A, B, plan, alpha=alpha)
    assert not bool(info.plan_mismatch)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), alpha * (dA @ dB), rtol=2e-4, atol=1e-3
    )
    # Honest counter == the fine pair enumeration's count.
    n_pairs, n_out = plan_spgemm(A, B)
    assert plan.n_leaf_pairs == n_pairs
    assert int(info.n_leaf_multiplies) == n_pairs
    assert int(info.n_out_blocks) == n_out
    # Structure parity: identical ids as the enumeration path.
    Cref, _ = hbsm.spgemm(
        A, B, pair_cap=max(n_pairs, 1), out_cap=max(n_out, 1), backend="xla"
    )
    ids_lp = np.asarray(C.ids)[: int(C.nnz)]
    ids_ref = np.asarray(Cref.ids)[: int(Cref.nnz)]
    np.testing.assert_array_equal(ids_lp, ids_ref)
    return plan


def test_banded_leafpack():
    """Scaled-down B1 (same bw/leaf proportions): banded at leaf 16."""
    n, bw, b = 1024, 64, 16
    r, c, v = gen.banded_coo(n, bw, seed=0)
    dA = gen.dense_oracle(r, c, v, n)
    A = hbsm.from_coo(r, c, v, n, block_size=b)
    plan = _oracle_check(A, A, dA, dA)
    # Banded panels must beat tile-padding: inflation well under the
    # counted 7.0x for coarsen-to-128 (from the plans).
    assert plan.inflation < 5.5


def test_banded_alpha_and_strips():
    n, bw, b = 384, 16, 16
    r, c, v = gen.banded_coo(n, bw, seed=1)
    dA = gen.dense_oracle(r, c, v, n)
    A = hbsm.from_coo(r, c, v, n, block_size=b)
    _oracle_check(A, A, dA, dA, strip_rows=64, alpha=-0.5)


def test_random_local_leafpack():
    """Random block-sparse with strip-local support (leaf 32)."""
    n, b = 512, 32
    rng = np.random.default_rng(7)
    nb = n // b
    rows, cols, vals = [], [], []
    for br in range(nb):
        for bc in rng.choice(nb, size=5, replace=False):
            rr = np.repeat(np.arange(b), b) + br * b
            cc = np.tile(np.arange(b), b) + bc * b
            rows.append(rr)
            cols.append(cc)
            vals.append(rng.standard_normal(b * b).astype(np.float32))
    r = np.concatenate(rows).astype(np.int32)
    c = np.concatenate(cols).astype(np.int32)
    v = np.concatenate(vals)
    dA = gen.dense_oracle(r, c, v, n)
    A = hbsm.from_coo(r, c, v, n, block_size=b)
    _oracle_check(A, A, dA, dA)


def test_rectangular_leafpack():
    """Non-square product A[256x384] @ B[384x128] at leaf 16 (wait —
    leaf blocks 16, distinct nb_cols per operand exercises id maps)."""
    b = 16
    rng = np.random.default_rng(3)
    dA = np.zeros((256, 384), np.float32)
    dB = np.zeros((384, 128), np.float32)
    for i in range(0, 256, b):
        for j in range(i, min(i + 3 * b, 384), b):
            dA[i : i + b, j : j + b] = rng.standard_normal((b, b))
    for i in range(0, 384, b):
        for j in range(0, 128, b):
            if rng.random() < 0.4:
                dB[i : i + b, j : j + b] = rng.standard_normal((b, b))
    ra, ca = np.nonzero(dA)
    rb, cb = np.nonzero(dB)
    A = hbsm.from_coo(ra, ca, dA[ra, ca], 256, n_cols=384, block_size=b)
    B = hbsm.from_coo(rb, cb, dB[rb, cb], 384, n_cols=128, block_size=b)
    plan = plan_leafpack(A, B)
    assert plan is not None
    C, info = leafpack_spgemm(A, B, plan)
    assert not bool(info.plan_mismatch)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA @ dB, rtol=2e-4, atol=1e-3
    )


def test_leafpack_guard_and_mismatch():
    n, bw, b = 256, 16, 16
    r, c, v = gen.banded_coo(n, bw, seed=2)
    A = hbsm.from_coo(r, c, v, n, block_size=b)
    # Applicability guard: absurdly tight max_cols -> no plan.
    assert plan_leafpack(A, A, max_cols=1) is None
    plan = plan_leafpack(A, A)
    # Stale plan (different structure) must be loud.
    r2, c2, v2 = gen.banded_coo(n, 32, seed=2)
    A2 = hbsm.from_coo(r2, c2, v2, n, block_size=b)
    A2 = hbsm.repack(A2, A.cap)
    _, info = leafpack_spgemm(A2, A2, plan)
    assert bool(info.plan_mismatch)
