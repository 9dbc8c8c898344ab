"""Dense-band tier (ops.band) vs dense oracle and vs the BlockMatrix
path (VERDICT r2 item 1: the honest fine-leaf B1 engine)."""

import numpy as np
import pytest

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.ops import band as bd
from hierarchical_block_sparse_lib.utils import generators as gen


def _banded_dense(n, w, seed=0):
    r, c, v = gen.banded_coo(n, w, seed=seed)
    return gen.dense_oracle(r, c, v, n), (r, c, v)


@pytest.mark.parametrize("n,w", [(512, 64), (384, 48), (300, 32)])
def test_band_roundtrip(n, w):
    dA, _ = _banded_dense(n, w)
    A = bd.band_from_dense(np.asarray(dA), w)
    np.testing.assert_allclose(np.asarray(bd.band_to_dense(A)), dA, atol=0)


def test_band_from_blocks_matches_dense():
    n, w = 512, 64
    dA, (r, c, v) = _banded_dense(n, w)
    Ablk = hbsm.from_coo(r, c, v, n, block_size=16)
    A1 = bd.band_from_blocks(Ablk, w)
    A2 = bd.band_from_dense(np.asarray(dA), w)
    np.testing.assert_allclose(
        np.asarray(A1.panels), np.asarray(A2.panels), atol=0
    )


@pytest.mark.parametrize("n,w", [(512, 64), (384, 48)])
def test_band_mm_oracle(n, w):
    dA, _ = _banded_dense(n, w)
    dB, _ = _banded_dense(n, w, seed=1)
    A = bd.band_from_dense(np.asarray(dA), w)
    B = bd.band_from_dense(np.asarray(dB), w)
    C = bd.band_mm(A, B)
    assert C.w == 2 * w
    np.testing.assert_allclose(
        np.asarray(bd.band_to_dense(C)), dA @ dB, rtol=2e-4, atol=1e-3
    )


def test_band_mm_chain_and_alpha():
    """Feeding C back in exercises the wpad-multiple-of-128 path."""
    n, w = 512, 64
    dA, _ = _banded_dense(n, w)
    A = bd.band_from_dense(np.asarray(dA), w)
    C = bd.band_mm(A, A, alpha=0.5)
    D = bd.band_mm(C, C)
    np.testing.assert_allclose(
        np.asarray(bd.band_to_dense(D)),
        0.25 * np.linalg.matrix_power(dA.astype(np.float64), 4),
        rtol=2e-4,
        atol=1e-2,
    )


def test_band_mm_out_w_clamp():
    """out_w discards fill-in beyond the clamp (structural truncation)."""
    n, w = 512, 64
    dA, _ = _banded_dense(n, w)
    A = bd.band_from_dense(np.asarray(dA), w)
    C = bd.band_mm(A, A, out_w=64)
    assert C.w == 64
    i, j = np.indices((n, n))
    ref = np.where(np.abs(i - j) <= 64, dA @ dA, 0.0)
    np.testing.assert_allclose(
        np.asarray(bd.band_to_dense(C)), ref, rtol=2e-4, atol=1e-3
    )


def test_band_elementwise_ops():
    n, w = 384, 48
    dA, _ = _banded_dense(n, w)
    dB, _ = _banded_dense(n, 32, seed=3)
    A = bd.band_from_dense(np.asarray(dA), w)
    B = bd.band_from_dense(np.asarray(dB), 32)
    S = bd.band_add(A, B, alpha=2.0, beta=-1.0)
    np.testing.assert_allclose(
        np.asarray(bd.band_to_dense(S)), 2 * dA - dB, rtol=1e-6, atol=1e-5
    )
    S2 = bd.band_add(B, A)  # smaller-wpad first operand branch
    np.testing.assert_allclose(
        np.asarray(bd.band_to_dense(S2)), dA + dB, rtol=1e-6, atol=1e-5
    )
    np.testing.assert_allclose(
        float(bd.band_frob_squared(A)), float((dA**2).sum()), rtol=1e-5
    )
    np.testing.assert_allclose(
        float(bd.band_trace(A)), float(np.trace(dA)), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(bd.band_to_dense(bd.band_scale(A, -0.5))),
        -0.5 * dA,
        rtol=1e-6,
        atol=1e-6,
    )


def test_band_transpose():
    n, w = 512, 64
    dA, _ = _banded_dense(n, w)
    A = bd.band_from_dense(np.asarray(dA), w)
    At = bd.band_transpose(A)
    np.testing.assert_allclose(
        np.asarray(bd.band_to_dense(At)), dA.T, atol=0
    )


def test_band_to_blocks():
    n, w = 512, 64
    dA, _ = _banded_dense(n, w)
    A = bd.band_from_dense(np.asarray(dA), w)
    for bb in (16, 128):
        M = bd.band_to_blocks(A, block_size=bb)
        np.testing.assert_allclose(
            np.asarray(hbsm.to_dense(M)), dA, atol=0
        )


def test_band_mm_matches_block_path():
    """Same product through the band tier and the spgemm path."""
    n, w = 512, 64
    dA, (r, c, v) = _banded_dense(n, w)
    Ablk = hbsm.from_coo(r, c, v, n, block_size=128)
    from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm

    pc, oc = plan_spgemm(Ablk, Ablk)
    Cblk, _ = hbsm.spgemm(Ablk, Ablk, pair_cap=pc, out_cap=oc)
    A = bd.band_from_dense(np.asarray(dA), w)
    C = bd.band_mm(A, A)
    np.testing.assert_allclose(
        np.asarray(bd.band_to_dense(C)),
        np.asarray(hbsm.to_dense(Cblk)),
        rtol=2e-5,
        atol=2e-4,
    )


def test_band_probe_and_api_residency():
    """VERDICT r4 item 7: the band probe routes banded structures and
    declines others; the OO multiply keeps band residency and matches
    the block path numerically."""
    import numpy as np
    import hierarchical_block_sparse_lib as hbsm
    from hierarchical_block_sparse_lib.api import (
        HierarchicalBlockSparseMatrix,
    )
    from hierarchical_block_sparse_lib.core.block_matrix import Params
    from hierarchical_block_sparse_lib.utils import generators as gen

    n, bw = 512, 48
    r, c, v = gen.banded_coo(n, bw, seed=0)
    A = hbsm.from_coo(r, c, v, n, block_size=16)
    w = hbsm.band_probe(A)
    assert w is not None and w >= bw

    # Random 10% structure: declined.
    rng = np.random.default_rng(0)
    nb = n // 16
    ids = np.sort(rng.choice(nb * nb, nb * nb // 10, replace=False))
    rr = (ids // nb) * 16
    cc = (ids % nb) * 16
    R = hbsm.from_coo(rr, cc, np.ones_like(rr, np.float32), n,
                      block_size=16)
    assert hbsm.band_probe(R) is None

    # OO surface: banded multiply stays band-resident.
    a = HierarchicalBlockSparseMatrix(Params(16))
    a.resize(n)
    a.assign_from_vectors(r, c, v)
    prod = HierarchicalBlockSparseMatrix.multiply(a, False, a, False)
    assert prod._band is not None and prod._m is None
    dA = gen.dense_oracle(r, c, v, n).astype(np.float64)
    np.testing.assert_allclose(
        prod.to_dense().astype(np.float64), dA @ dA, rtol=1e-4,
        atol=1e-4,
    )
    assert prod.no_of_block_multiplies > 0
    # Band-side reductions without materialization.
    prod2 = HierarchicalBlockSparseMatrix.multiply(a, False, a, False)
    got = prod2.get_frob_squared()
    assert prod2._m is None  # frob ran band-side
    ref = float(((dA @ dA) ** 2).sum())
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    prod2.rescale(2.0)
    assert prod2._m is None
    np.testing.assert_allclose(
        prod2.to_dense().astype(np.float64), 2.0 * (dA @ dA), rtol=1e-4,
        atol=1e-4,
    )
    # Chained multiply: operands already band-resident, result too.
    sq = HierarchicalBlockSparseMatrix.multiply(prod, False, prod, False)
    assert sq._band is not None and sq._m is None
    np.testing.assert_allclose(
        sq.to_dense().astype(np.float64), (dA @ dA) @ (dA @ dA),
        rtol=1e-4, atol=1e-2,
    )
