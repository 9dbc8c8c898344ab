"""Error-controlled (norm-filtered) multiply: correctness and error bound."""

import numpy as np
import pytest

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm, plan_spamm


def _random_sparse(n, b, density, seed, scale_spread=True):
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((n, n)) * (rng.random((n, n)) < density)).astype(
        np.float32
    )
    if scale_spread:
        # Give blocks wildly different norms so filtering has bite.
        nb = n // b
        s = rng.uniform(-4, 1, (nb, nb))
        d = d * np.kron(10.0**s, np.ones((b, b))).astype(np.float32)
    return d


@pytest.mark.parametrize("tau", [1e-3, 1e-1])
def test_spamm_error_bounded(tau):
    n, b = 256, 16
    da = _random_sparse(n, b, 0.3, 0)
    db = _random_sparse(n, b, 0.3, 1)
    A = hbsm.from_dense(da, block_size=b)
    B = hbsm.from_dense(db, block_size=b)
    pc, oc = plan_spgemm(A, B)
    pc_f, oc_f = plan_spamm(A, B, tau)
    assert pc_f <= pc and oc_f <= oc

    C, info = hbsm.spamm(
        A, B, tau, pair_cap=pc, out_cap=max(oc_f, 1), gemm_cap=max(pc_f, 1)
    )
    assert not bool(info.pair_overflow)
    assert not bool(info.out_overflow)
    assert int(info.n_block_pairs) == pc_f

    got = np.asarray(hbsm.to_dense(C))
    exact = da @ db
    err = np.linalg.norm(got - exact, "fro")
    # Error bound: sum over skipped pairs of ||A_ik|| * ||B_kj||.
    # Recompute the bound explicitly on host.
    from hierarchical_block_sparse_lib.ops.norms import block_frob_squared

    an = np.sqrt(np.asarray(block_frob_squared(A)))
    bn = np.sqrt(np.asarray(block_frob_squared(B)))
    ar = np.asarray(A.block_rows())
    ac = np.asarray(A.block_cols())
    br = np.asarray(B.block_rows())
    bc = np.asarray(B.block_cols())
    bound = 0.0
    for i in range(len(ar)):
        if ar[i] >= A.nb_rows:
            continue
        for j in range(len(br)):
            if br[j] >= B.nb_rows or br[j] != ac[i]:
                continue
            p = an[i] * bn[j]
            if p <= tau:
                bound += p
    assert err <= bound * (1 + 1e-4) + 1e-6
    assert err > 0 or pc_f == pc  # something was actually skipped (or not)


def test_spamm_tau_zero_is_exact():
    n, b = 128, 16
    da = _random_sparse(n, b, 0.2, 3, scale_spread=False)
    A = hbsm.from_dense(da, block_size=b)
    pc, oc = plan_spgemm(A, A)
    C, info = hbsm.spamm(A, A, 0.0, pair_cap=pc, out_cap=oc)
    exact = da @ da
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), exact, rtol=2e-5, atol=2e-5
    )
    assert int(info.n_block_pairs) == pc


def test_spamm_rows_backend_matches_xla():
    """Filtered pairs through the segment kernel (interpret) == the
    filtered XLA path."""
    from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm

    n, b, tau = 192, 16, 5e-2
    da = _random_sparse(n, b, 0.3, 10)
    db = _random_sparse(n, b, 0.3, 11)
    A = hbsm.from_dense(da, block_size=b)
    B = hbsm.from_dense(db, block_size=b)
    pc, oc = plan_spgemm(A, B)
    C_r, info_r = hbsm.spgemm(
        A, B, pair_cap=pc, out_cap=oc, tau=tau, filter_by_norm=True,
        backend="segment",
    )
    C_x, info_x = hbsm.spgemm(
        A, B, pair_cap=pc, out_cap=oc, tau=tau, filter_by_norm=True,
        backend="xla",
    )
    assert int(info_r.n_block_pairs) == int(info_x.n_block_pairs) < pc
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C_r)),
        np.asarray(hbsm.to_dense(C_x)),
        rtol=1e-5,
        atol=1e-5,
    )


def test_spamm_overflow_reported_when_gemm_cap_too_small():
    n, b = 128, 16
    da = _random_sparse(n, b, 0.3, 4, scale_spread=False)
    A = hbsm.from_dense(da, block_size=b)
    pc, oc = plan_spgemm(A, A)
    assert pc > 2
    _, info = hbsm.spamm(A, A, 0.0, pair_cap=pc, out_cap=oc, gemm_cap=2)
    assert bool(info.pair_overflow)


def test_spamm_error_bound_certificate():
    """The a-priori bound certifies the actual SpAMM error."""
    from hierarchical_block_sparse_lib.ops.spgemm import (
        plan_spgemm, spamm_error_bound,
    )

    n, b, tau = 192, 16, 5e-2
    da = _random_sparse(n, b, 0.3, 20)
    db = _random_sparse(n, b, 0.3, 21)
    A = hbsm.from_dense(da, block_size=b)
    B = hbsm.from_dense(db, block_size=b)
    pc, oc = plan_spgemm(A, B)
    bound = spamm_error_bound(A, B, tau)
    C, info = hbsm.spamm(A, B, tau, pair_cap=pc, out_cap=max(oc, 1))
    err = np.linalg.norm(
        np.asarray(hbsm.to_dense(C)).astype(np.float64)
        - da.astype(np.float64) @ db.astype(np.float64),
        "fro",
    )
    assert err <= bound * (1 + 1e-4) + 1e-6
    assert bound > 0  # something was skipped at this tau
    assert int(info.n_block_pairs) < pc
