"""Distributed SpGEMM / norms / truncation over a virtual 8-device mesh
(SURVEY.md section 5: multi-host logic tested with fake-device meshes)."""

import numpy as np
import jax
import pytest

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.parallel import dist
from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib.utils import generators as gen


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return dist.make_mesh(8)


def _matrix(n=512, b=32, bw=40, seed=0):
    r, c, v = gen.banded_coo(n, bw, seed=seed)
    dA = gen.dense_oracle(r, c, v, n)
    A = hbsm.from_coo(r, c, v, n, block_size=b)
    return A, dA


def test_distribute_roundtrip(mesh):
    A, dA = _matrix()
    Ad = dist.distribute(A, mesh)
    back = dist.undistribute(Ad)
    np.testing.assert_allclose(np.asarray(hbsm.to_dense(back)), dA, rtol=1e-6)
    assert int(back.nnz) == int(A.nnz)


def test_dist_spgemm_banded(mesh):
    A, dA = _matrix()
    n_pairs, n_out = plan_spgemm(A, A)
    Ad = dist.distribute(A, mesh)
    # per-device per-stage caps: generous
    Cd, pairs, ovf = dist.dist_spgemm(
        Ad, Ad, mesh, pair_cap=n_pairs, out_cap=n_out, stage_out_cap=n_out
    )
    assert not bool(ovf)
    assert int(pairs) == n_pairs
    C = dist.undistribute(Cd)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA @ dA, rtol=2e-4, atol=1e-3
    )


def test_dist_spgemm_random(mesh):
    n, b = 512, 32
    r1, c1, v1 = gen.random_block_sparse_coo(n, b, 0.15, seed=1)
    r2, c2, v2 = gen.random_block_sparse_coo(n, b, 0.15, seed=2)
    dA = gen.dense_oracle(r1, c1, v1, n)
    dB = gen.dense_oracle(r2, c2, v2, n)
    A = hbsm.from_coo(r1, c1, v1, n, block_size=b)
    B = hbsm.from_coo(r2, c2, v2, n, block_size=b)
    n_pairs, n_out = plan_spgemm(A, B)
    Ad = dist.distribute(A, mesh)
    Bd = dist.distribute(B, mesh)
    Cd, pairs, ovf = dist.dist_spgemm(
        Ad, Bd, mesh, pair_cap=max(n_pairs, 1), out_cap=max(n_out, 1),
        alpha=0.5,
    )
    assert not bool(ovf)
    assert int(pairs) == n_pairs
    C = dist.undistribute(Cd)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), 0.5 * dA @ dB, rtol=2e-4, atol=1e-3
    )


def test_dist_sp2_step_matches_single_device(mesh):
    """Distributed purification step == single-device sp2_step."""
    from hierarchical_block_sparse_lib.models.purification import sp2_step
    from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm

    n, b = 512, 32
    A, dA = _matrix(n=n, b=b, bw=48, seed=9)
    X = hbsm.scale(A, 1.0 / float(np.sqrt(float(hbsm.frob_squared(A)))))
    X = hbsm.add(X, hbsm.eye(n, b), beta=0.5, cap=X.cap + n // b)
    pc, oc = plan_spgemm(X, X)

    y_ref, stats_ref = sp2_step(
        X, tau=1e-7, pair_cap=2 * pc, out_cap=2 * oc, target_trace=n / 2,
        cap=2 * oc,
    )

    Xd = dist.distribute(hbsm.repack(X, 2 * oc), mesh)
    yd, stats = dist_mod_sp2(Xd, mesh, pc, oc, n)
    assert not bool(stats["overflow"])
    np.testing.assert_allclose(
        float(stats["trace"]), float(stats_ref.trace), rtol=1e-5
    )
    assert int(stats["n_block_pairs"]) == int(stats_ref.n_block_pairs)
    y = dist.undistribute(yd)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(y)),
        np.asarray(hbsm.to_dense(y_ref)),
        rtol=2e-5,
        atol=1e-5,
    )
    # trace helper too
    np.testing.assert_allclose(
        float(dist.dist_trace(Xd, mesh)), float(hbsm.trace(X)), rtol=1e-5
    )


def test_dist_purification_matches_single_device_loop(mesh):
    """20 distributed SP2 steps == 20 single-device steps — the flagship
    workload end-to-end on the mesh (distribution exactness; SP2's own
    convergence is covered in tests/test_models.py)."""
    from hierarchical_block_sparse_lib.models.purification import (
        purify_scan,
    )

    n, b, nocc = 256, 16, 64
    rng = np.random.default_rng(21)
    d = np.zeros((n, n), np.float32)
    for k in range(0, 5):
        v = rng.standard_normal(n - k).astype(np.float32) * 0.2
        d += np.diag(v, k) + (np.diag(v, -k) if k else 0)
    d = (d + d.T) / 2
    w = np.linalg.eigvalsh(d.astype(np.float64))
    lo, hi = w[0], w[-1]
    x0 = ((hi * np.eye(n) - d) / (hi - lo)).astype(np.float32)
    X = hbsm.from_dense(x0, block_size=b)
    nb = n // b
    dense_blocks = nb * nb

    ref, _ = purify_scan(
        X, 20, tau=1e-8, pair_cap=nb**3, out_cap=dense_blocks,
        target_trace=nocc,
    )

    Xd = dist.distribute(hbsm.repack(X, dense_blocks), mesh)
    for _ in range(20):
        Xd, stats = dist.dist_sp2_step(
            Xd, mesh, tau=1e-8, pair_cap=nb**3, out_cap=dense_blocks,
            target_trace=nocc,
        )
        assert not bool(stats["overflow"])
    got = np.asarray(hbsm.to_dense(dist.undistribute(Xd)))
    want = np.asarray(hbsm.to_dense(ref))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def dist_mod_sp2(Xd, mesh, pc, oc, n):
    return dist.dist_sp2_step(
        Xd, mesh, tau=1e-7, pair_cap=2 * pc, out_cap=2 * oc,
        stage_out_cap=2 * oc, target_trace=n / 2,
    )


@pytest.fixture(scope="module")
def mesh2d():
    from hierarchical_block_sparse_lib.parallel import dist2d

    assert len(jax.devices()) >= 4
    return dist2d.make_mesh2d(2)


def test_dist2d_roundtrip(mesh2d):
    from hierarchical_block_sparse_lib.parallel import dist2d

    A, dA = _matrix(seed=5)
    Ad = dist2d.distribute2d(A, mesh2d)
    back = dist2d.undistribute2d(Ad)
    np.testing.assert_allclose(np.asarray(hbsm.to_dense(back)), dA, rtol=1e-6)
    assert int(back.nnz) == int(A.nnz)


def test_dist2d_cannon_spgemm(mesh2d):
    from hierarchical_block_sparse_lib.parallel import dist2d

    n, b = 512, 32
    r1, c1, v1 = gen.random_block_sparse_coo(n, b, 0.15, seed=6)
    r2, c2, v2 = gen.random_block_sparse_coo(n, b, 0.15, seed=7)
    dA = gen.dense_oracle(r1, c1, v1, n)
    dB = gen.dense_oracle(r2, c2, v2, n)
    A = hbsm.from_coo(r1, c1, v1, n, block_size=b)
    B = hbsm.from_coo(r2, c2, v2, n, block_size=b)
    n_pairs, n_out = plan_spgemm(A, B)
    Ad = dist2d.distribute2d(A, mesh2d)
    Bd = dist2d.distribute2d(B, mesh2d)
    Cd, pairs, ovf = dist2d.dist2d_spgemm(
        Ad, Bd, mesh2d, pair_cap=max(n_pairs, 1), out_cap=max(n_out, 1),
        alpha=0.5,
    )
    assert not bool(ovf)
    assert int(pairs) == n_pairs
    C = dist2d.undistribute2d(Cd)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), 0.5 * dA @ dB, rtol=2e-4, atol=1e-3
    )
    # norms + truncation on the 2D layout
    f2 = dist2d.dist2d_frob_squared(Ad, mesh2d)
    np.testing.assert_allclose(float(f2), float((dA**2).sum()), rtol=1e-5)
    Td = dist2d.dist2d_truncate(Ad, mesh2d, 1e9)
    assert int(dist2d.undistribute2d(Td).nnz) == 0


def test_dist_frob_and_truncate(mesh):
    A, dA = _matrix(seed=3)
    Ad = dist.distribute(A, mesh)
    f2 = dist.dist_frob_squared(Ad, mesh)
    np.testing.assert_allclose(float(f2), float((dA**2).sum()), rtol=1e-5)
    Td = dist.dist_truncate(Ad, mesh, 1e9)
    T = dist.undistribute(Td)
    assert int(T.nnz) == 0
