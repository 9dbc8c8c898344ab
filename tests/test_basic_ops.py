"""add / scale / transpose / norms / truncate vs dense oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.utils import generators as gen


def _pair(n=96, b=16, seed=0):
    r1, c1, v1 = gen.banded_coo(n, 4, seed=seed)
    r2, c2, v2 = gen.random_block_sparse_coo(n, b, 0.25, seed=seed + 1)
    A = hbsm.from_coo(r1, c1, v1, n, block_size=b)
    B = hbsm.from_coo(r2, c2, v2, n, block_size=b)
    dA = gen.dense_oracle(r1, c1, v1, n)
    dB = gen.dense_oracle(r2, c2, v2, n)
    return A, B, dA, dB


def test_add():
    A, B, dA, dB = _pair()
    C = hbsm.add(A, B, alpha=2.0, beta=-0.5)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), 2.0 * dA - 0.5 * dB, rtol=1e-5
    )
    # union structure: nnz(C) <= nnz(A)+nnz(B)
    assert int(C.nnz) <= int(A.nnz) + int(B.nnz)


def test_add_bounded_cap():
    A, B, dA, dB = _pair()
    exact = hbsm.add(A, B)
    C = hbsm.add(A, B, cap=int(exact.nnz))
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA + dB, rtol=1e-5
    )


def test_scale():
    A, _, dA, _ = _pair()
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(hbsm.scale(A, -3.5))), -3.5 * dA, rtol=1e-5
    )


def test_transpose():
    A, B, dA, dB = _pair()
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(hbsm.transpose(A))), dA.T, rtol=1e-6
    )
    # transpose of transpose = identity
    AT2 = hbsm.transpose(hbsm.transpose(A))
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(AT2)), dA, rtol=1e-6
    )


def test_transpose_nonsquare():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((32, 64)).astype(np.float32)
    m = hbsm.from_dense(x, block_size=16)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(hbsm.transpose(m))), x.T, rtol=1e-6
    )


def test_norms_and_trace():
    A, _, dA, _ = _pair()
    np.testing.assert_allclose(
        float(hbsm.frob_squared(A)), float((dA**2).sum()), rtol=1e-5
    )
    np.testing.assert_allclose(
        float(hbsm.trace(A)), float(np.trace(dA)), rtol=1e-4, atol=1e-4
    )


def test_subtree_norms_sum_to_total():
    A, _, dA, _ = _pair()
    for level in (0, 1, 2):
        _, norms2 = hbsm.subtree_frob_squared(A, level)
        np.testing.assert_allclose(
            float(np.asarray(norms2).sum()), float((dA**2).sum()), rtol=1e-5
        )


def test_truncate():
    n, b = 64, 8
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, n)).astype(np.float32)
    # make some blocks tiny
    x[:16, :16] *= 1e-6
    x[32:40, 48:56] *= 1e-7
    A = hbsm.from_dense(x, block_size=b)
    tau = 1e-3
    T = hbsm.truncate(A, tau)
    # oracle: per-block frob norms
    nb = n // b
    blocks = x.reshape(nb, b, nb, b).transpose(0, 2, 1, 3)
    norms = np.sqrt((blocks**2).sum((2, 3)))
    expected = np.where((norms > tau)[:, :, None, None], blocks, 0)
    expected = expected.transpose(0, 2, 1, 3).reshape(n, n)
    np.testing.assert_allclose(np.asarray(hbsm.to_dense(T)), expected, rtol=1e-6)
    assert int(T.nnz) == int((norms > tau).sum())
    # error bound: ||A - T||_F <= tau * sqrt(#dropped)
    dropped = int(A.nnz) - int(T.nnz)
    err = np.linalg.norm(x - np.asarray(hbsm.to_dense(T)))
    assert err <= tau * np.sqrt(max(dropped, 1)) + 1e-6


def test_truncate_to_cap():
    """Fused truncate+repack (`cap=`): matches the two-op chain, reports
    the pre-clamp kept count, and drops trailing survivors on overflow."""
    n, b = 64, 8
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, n)).astype(np.float32)
    x[:16, :16] *= 1e-6
    A = hbsm.from_dense(x, block_size=b)
    tau = 1e-3
    ref = hbsm.truncate(A, tau)
    kept_ref = int(ref.nnz)

    # Roomy cap: identical content, exact kept count, invariants hold.
    cap = kept_ref + 3
    T, kept = hbsm.truncate(A, tau, cap=cap)
    assert int(kept) == kept_ref and int(T.nnz) == kept_ref
    assert T.cap == cap
    np.testing.assert_array_equal(
        np.asarray(T.ids), np.asarray(hbsm.repack(ref, cap).ids)
    )
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(T)), np.asarray(hbsm.to_dense(ref))
    )
    # Padding slots all-zero (load-bearing invariant).
    assert np.all(np.asarray(T.data)[kept_ref:] == 0)

    # Tight cap: kept reports the overflow, trailing (highest-id)
    # survivors dropped — same semantics as truncate-then-repack.
    small = kept_ref - 2
    T2, kept2 = hbsm.truncate(A, tau, cap=small)
    assert int(kept2) == kept_ref > small and int(T2.nnz) == small
    np.testing.assert_array_equal(
        np.asarray(T2.ids), np.asarray(ref.ids)[:small]
    )


def test_truncate_subtree():
    n, b = 64, 8
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, n)).astype(np.float32)
    x[:32, :32] *= 1e-8  # entire level-1 quadrant tiny
    A = hbsm.from_dense(x, block_size=b)
    T = hbsm.truncate(A, 1e-3, subtree_level=1)
    d = np.asarray(hbsm.to_dense(T))
    assert np.all(d[:32, :32] == 0)
    np.testing.assert_allclose(d[32:, :], x[32:, :], rtol=1e-6)


def test_repack():
    A, _, dA, _ = _pair()
    big = hbsm.repack(A, A.cap + 10)
    np.testing.assert_allclose(np.asarray(hbsm.to_dense(big)), dA, rtol=1e-6)
    tight = hbsm.repack(big, int(A.nnz))
    np.testing.assert_allclose(np.asarray(hbsm.to_dense(tight)), dA, rtol=1e-6)


def test_coarsen():
    A, _, dA, _ = _pair(n=96, b=8)
    C = hbsm.coarsen(A, 2)
    assert C.block_size == 16
    np.testing.assert_allclose(np.asarray(hbsm.to_dense(C)), dA, rtol=1e-6)
    assert int(C.nnz) <= int(A.nnz)


def test_add_with_info_overflow():
    import hierarchical_block_sparse_lib as hbsm
    import numpy as np

    rng = np.random.default_rng(9)
    d1 = (rng.standard_normal((64, 64)) * (rng.random((64, 64)) < 0.4)).astype(
        np.float32
    )
    d2 = (rng.standard_normal((64, 64)) * (rng.random((64, 64)) < 0.4)).astype(
        np.float32
    )
    A = hbsm.from_dense(d1, block_size=8)
    B = hbsm.from_dense(d2, block_size=8)
    big = int(A.nnz) + int(B.nnz)
    C, ovf = hbsm.add_with_info(A, B, cap=big)
    assert not bool(ovf)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), d1 + d2, rtol=1e-6, atol=1e-6
    )
    _, ovf2 = hbsm.add_with_info(A, B, cap=2)
    assert bool(ovf2)


def test_syrk():
    import hierarchical_block_sparse_lib as hbsm
    import numpy as np

    rng = np.random.default_rng(13)
    d = (rng.standard_normal((96, 96)) * (rng.random((96, 96)) < 0.3)).astype(
        np.float32
    )
    A = hbsm.from_dense(d, block_size=16)
    C, info = hbsm.syrk(A, alpha=0.5)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), 0.5 * d @ d.T, rtol=2e-5, atol=2e-5
    )
    Ct, _ = hbsm.syrk(A, transpose=True)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(Ct)), d.T @ d, rtol=2e-5, atol=2e-5
    )
    assert int(info.n_block_pairs) > 0
    # Symmetry exploitation: upper-only enumeration does (full + diag)/2
    # pairs — strictly fewer than the generic multiply.
    from hierarchical_block_sparse_lib.ops.spgemm import (
        plan_spgemm, plan_syrk,
    )
    from hierarchical_block_sparse_lib.ops import basic

    full_pairs, _ = plan_spgemm(A, basic.transpose(A))
    plan = plan_syrk(A)
    assert int(info.n_block_pairs) == plan.pairs_upper
    assert plan.pairs_upper < full_pairs
    assert plan.pairs_raw == full_pairs
    # Upper-only mode returns just the triangle.
    Cu, _ = hbsm.syrk(A, full=False)
    ref = d @ d.T
    ref_u = np.zeros_like(ref)
    nb = 96 // 16
    for i in range(nb):
        for j in range(i, nb):
            ref_u[i * 16:(i + 1) * 16, j * 16:(j + 1) * 16] = ref[
                i * 16:(i + 1) * 16, j * 16:(j + 1) * 16
            ]
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(Cu)), ref_u, rtol=2e-5, atol=2e-5
    )


def test_syrk_rows_backend():
    """syrk through the segment kernel (upper-triangle pairs only) must
    match the oracle — exercised at b=128 in interpret mode."""
    import jax.numpy as jnp
    import hierarchical_block_sparse_lib as hbsm

    rng = np.random.default_rng(17)
    b, nb = 128, 4
    n = b * nb
    keep = rng.random((nb, nb)) < 0.6
    d = rng.standard_normal((n, n)).astype(np.float32)
    for i in range(nb):
        for j in range(nb):
            if not keep[i, j]:
                d[i * b:(i + 1) * b, j * b:(j + 1) * b] = 0
    A = hbsm.from_dense(d, block_size=b)
    C, info = hbsm.syrk(A, backend="segment")
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), d @ d.T, rtol=2e-4, atol=1e-2
    )
    assert not bool(info.pair_overflow)
    assert not bool(info.out_overflow)


def test_triu_tril_filter():
    import hierarchical_block_sparse_lib as hbsm

    rng = np.random.default_rng(23)
    d = rng.standard_normal((64, 64)).astype(np.float32)
    A = hbsm.from_dense(d, block_size=16)
    up = np.triu(np.ones((4, 4))).repeat(16, 0).repeat(16, 1)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(hbsm.triu(A))), d * up
    )
    lo_strict = np.tril(np.ones((4, 4)), -1).repeat(16, 0).repeat(16, 1)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(hbsm.tril(A, strict=True))), d * lo_strict
    )


def test_symmetrize_upper():
    """S = upper(A) mirrored down: S_ij = A_ij (i<=j), S_ji = A_ij^T —
    the fused pass behind symmetric (syrk) purification."""
    from hierarchical_block_sparse_lib.ops.basic import symmetrize_upper

    import hierarchical_block_sparse_lib as hbsm

    rng = np.random.default_rng(29)
    d = rng.standard_normal((64, 64)).astype(np.float32)
    d[np.abs(d) < 0.8] = 0.0  # some all-zero blocks
    # Mirroring is at BLOCK granularity: diagonal blocks are kept
    # verbatim (not element-symmetrized), so make them symmetric the
    # way a symmetric iterate would be.
    for i in range(0, 64, 16):
        blk = d[i : i + 16, i : i + 16]
        d[i : i + 16, i : i + 16] = (blk + blk.T) / 2
    A = hbsm.from_dense(d, block_size=16)
    S, ovf = symmetrize_upper(A, A.cap + 16)
    up = np.triu(np.ones((4, 4))).repeat(16, 0).repeat(16, 1)
    want = d * up
    strict = np.triu(np.ones((4, 4)), 1).repeat(16, 0).repeat(16, 1)
    want = want + (d * strict).T
    got = np.asarray(hbsm.to_dense(S))
    np.testing.assert_allclose(got, want)
    np.testing.assert_array_equal(got, got.T)
    assert not bool(ovf)
    # Overflow reported when cap is too small for the mirrored union.
    _, ovf2 = symmetrize_upper(A, 1)
    assert bool(ovf2)


def test_gershgorin_bound():
    import hierarchical_block_sparse_lib as hbsm
    import numpy as np

    rng = np.random.default_rng(17)
    d = (rng.standard_normal((96, 96)) * (rng.random((96, 96)) < 0.3)).astype(
        np.float32
    )
    d = (d + d.T) / 2
    A = hbsm.from_dense(d, block_size=16)
    g = float(hbsm.gershgorin_bound(A))
    want = np.abs(d).sum(axis=1).max()
    np.testing.assert_allclose(g, want, rtol=1e-5)
    assert g >= np.abs(np.linalg.eigvalsh(d)).max() - 1e-4
