"""Randomized cross-product stress: shapes x densities x blocks x ops,
always against dense oracles.  Catches corner cases the targeted tests
miss (ragged grids, empty operands, extreme densities)."""

import numpy as np
import pytest

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm_ex


def _rand(n, m, dens, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, m)) * (rng.random((n, m)) < dens)
    ).astype(np.float32)


CASES = [
    # (n, k, m, b, densA, densB)
    (64, 64, 64, 8, 0.05, 0.9),     # sparse x near-dense
    (120, 72, 96, 8, 0.3, 0.3),     # ragged rectangular
    (128, 128, 128, 32, 1.0, 1.0),  # fully dense blocks
    (96, 96, 96, 48, 0.4, 0.4),     # block bigger than fits evenly? 96/48=2
    (40, 24, 56, 8, 0.5, 0.02),     # tiny, nearly-empty B
    (64, 64, 64, 64, 1.0, 0.5),     # single-block rows
]


@pytest.mark.parametrize("case", CASES)
def test_spgemm_stress(case):
    n, k, m, b, da_, db_ = case
    dA = _rand(n, k, da_, hash(case) % 1000)
    dB = _rand(k, m, db_, hash(case) % 1000 + 1)
    A = hbsm.from_dense(dA, block_size=b)
    B = hbsm.from_dense(dB, block_size=b)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, B)
    C, info = hbsm.spgemm(
        A, B, pair_cap=max(pc, 1), out_cap=max(oc, 1),
        row_caps=(mbr, mcr),
    )
    assert not bool(info.pair_overflow) and not bool(info.out_overflow)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA @ dB, rtol=3e-4, atol=1e-3
    )
    assert int(info.n_block_pairs) == pc
    # chain: transpose, add, scale, truncate, frob on the result
    Ct = hbsm.transpose(C)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(Ct)), (dA @ dB).T, rtol=3e-4, atol=1e-3
    )
    S = hbsm.add(C, C, alpha=0.5, beta=0.5)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(S)), dA @ dB, rtol=3e-4, atol=1e-3
    )
    f2 = float(hbsm.frob_squared(C))
    np.testing.assert_allclose(
        f2, ((dA @ dB).astype(np.float64) ** 2).sum(), rtol=1e-3
    )


@pytest.mark.parametrize("f", [2, 4])
def test_coarsen_ragged_roundtrip(f):
    """Coarsen on grids not divisible by the factor, vs dense."""
    n, m, b = 72, 104, 8  # 9 x 13 blocks -> ragged under f=2,4
    dA = _rand(n, m, 0.4, 5)
    A = hbsm.from_dense(dA, block_size=b)
    Ac = hbsm.coarsen(A, f)
    assert Ac.block_size == b * f
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(Ac)), dA, rtol=1e-6, atol=1e-6
    )


def test_spgemm_empty_times_dense():
    dB = _rand(64, 64, 0.8, 6)
    A = hbsm.empty(64, 64, 8, cap=3)
    B = hbsm.from_dense(dB, block_size=8)
    C, info = hbsm.spgemm(A, B, pair_cap=4, out_cap=4)
    assert int(info.n_block_pairs) == 0
    assert not np.asarray(hbsm.to_dense(C)).any()


def test_matmul_rect_chain():
    dA = _rand(48, 80, 0.5, 7)
    dB = _rand(80, 32, 0.5, 8)
    A = hbsm.from_dense(dA, block_size=16)
    B = hbsm.from_dense(dB, block_size=16)
    C, _ = hbsm.matmul(A, B)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA @ dB, rtol=3e-4, atol=1e-3
    )
    # A^T @ C : [80,48] @ [48,32]
    D, _ = hbsm.matmul(A, C, transpose_a=True)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(D)), dA.T @ (dA @ dB), rtol=3e-4, atol=1e-3
    )
