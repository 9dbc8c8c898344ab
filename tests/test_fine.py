"""Fine leaves (b < 128, the configured 16/32 granularity) through the
segment kernel and the flat-resident chain (ops/fine.py) vs dense
oracles.  The kernel runs in interpret mode on the CPU conftest."""

import numpy as np
import pytest

import jax.numpy as jnp

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.kernels.segment_gemm import supported
from hierarchical_block_sparse_lib.ops.spgemm import (
    plan_spgemm,
    spgemm,
)


def random_fine(n_rows, n_cols, bf, density, seed=0):
    rng = np.random.default_rng(seed)
    nbr, nbc = n_rows // bf, n_cols // bf
    n_blocks = max(1, int(round(density * nbr * nbc)))
    chosen = np.sort(
        rng.choice(nbr * nbc, n_blocks, replace=False)
    ).astype(np.int32)
    data = rng.standard_normal((n_blocks, bf, bf)).astype(np.float32)
    m = hbsm.BlockMatrix(
        ids=jnp.asarray(chosen),
        data=jnp.asarray(data),
        nnz=jnp.asarray(n_blocks, jnp.int32),
        n_rows=n_rows,
        n_cols=n_cols,
        block_size=bf,
    )
    return m, np.asarray(hbsm.to_dense(m))


@pytest.mark.parametrize("bf", [16, 32, 64])
def test_fine_backend_vs_oracle(bf):
    A, dA = random_fine(8 * bf, 8 * bf, bf, 0.3, seed=1)
    B, dB = random_fine(8 * bf, 8 * bf, bf, 0.3, seed=2)
    pc, oc = plan_spgemm(A, B)
    C, info = spgemm(
        A, B, pair_cap=pc, out_cap=oc, backend="segment",
    )
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA @ dB, rtol=1e-5, atol=1e-5
    )
    # Padding invariant: tail slots all-zero, ids sorted unique.
    ids = np.asarray(C.ids)[: int(C.nnz)]
    assert (np.diff(ids) > 0).all()
    assert np.all(np.asarray(C.data)[int(C.nnz):] == 0)


def test_fine_rectangular_and_alpha():
    bf = 32
    A, dA = random_fine(8 * bf, 12 * bf, bf, 0.25, seed=3)
    B, dB = random_fine(12 * bf, 6 * bf, bf, 0.25, seed=4)
    pc, oc = plan_spgemm(A, B)
    C, _ = spgemm(
        A, B, pair_cap=pc, out_cap=oc, backend="segment", alpha=-0.5,
    )
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), -0.5 * (dA @ dB), rtol=1e-5,
        atol=1e-5,
    )


def test_fine_accum_and_plan():
    bf = 32
    A, dA = random_fine(8 * bf, 8 * bf, bf, 0.3, seed=5)
    D, dD = random_fine(8 * bf, 8 * bf, bf, 0.2, seed=6)
    pc, oc0 = plan_spgemm(A, A)
    from hierarchical_block_sparse_lib.runtime import native

    out_cap = oc0 + int(D.nnz)
    plan = hbsm.make_plan(A, A, pc, accum_ids=D.ids, out_cap=out_cap)
    C, info = spgemm(
        A, A, pair_cap=pc, out_cap=out_cap,
        backend="segment", accum=D, beta=2.0, plan=plan,
    )
    assert not bool(info.plan_mismatch)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA @ dA + 2.0 * dD, rtol=1e-5,
        atol=1e-5,
    )


def test_fine_empty_rows_and_cols():
    """Rows of A with no blocks and B rows that never match."""
    bf = 32
    n = 8 * bf
    dA = np.zeros((n, n), np.float32)
    dA[0:bf, 0:bf] = np.random.default_rng(7).standard_normal((bf, bf))
    dA[5 * bf:6 * bf, 2 * bf:3 * bf] = 1.0
    r, c = np.nonzero(dA)
    A = hbsm.from_coo(r, c, dA[r, c], n, block_size=bf)
    pc, oc = plan_spgemm(A, A)
    C, _ = spgemm(
        A, A, pair_cap=max(pc, 1), out_cap=max(oc, 1),
        backend="segment",
    )
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA @ dA, rtol=1e-5, atol=1e-5
    )


def test_fine_matches_xla_backend_bitwise_structure():
    bf = 32
    A, dA = random_fine(16 * bf, 16 * bf, bf, 0.12, seed=8)
    pc, oc = plan_spgemm(A, A)
    Cf, _ = spgemm(A, A, pair_cap=pc, out_cap=oc, backend="segment")
    Cx, _ = spgemm(A, A, pair_cap=pc, out_cap=oc, backend="xla")
    np.testing.assert_array_equal(np.asarray(Cf.ids), np.asarray(Cx.ids))
    np.testing.assert_allclose(
        np.asarray(Cf.data), np.asarray(Cx.data), rtol=1e-5, atol=1e-6
    )
    # The flat-resident multiply takes the same numeric path, with the
    # operands' roles swapped (C^T = B^T A^T): identical blocks.
    Af = hbsm.fine_pack(A)
    for backend in ("segment", "xla"):
        Cff, _ = hbsm.fine_matmul(
            Af, Af, pair_cap=pc, out_cap=oc, backend=backend
        )
        np.testing.assert_allclose(
            np.asarray(hbsm.fine_unpack(Cff).data), np.asarray(Cx.data),
            rtol=1e-5, atol=1e-6,
        )


def test_fine_flat_chain_vs_oracle():
    """Flat-resident chain (ops.fine): pack -> matmul -> add -> scale
    -> truncate -> unpack vs the dense oracle."""
    bf = 32
    A, dA = random_fine(8 * bf, 8 * bf, bf, 0.3, seed=11)
    D, dD = random_fine(8 * bf, 8 * bf, bf, 0.25, seed=12)
    pc, oc = plan_spgemm(A, A)
    Af = hbsm.fine_pack(A)
    Df = hbsm.fine_pack(D)
    Cf, info = hbsm.fine_matmul(
        Af, Af, pair_cap=pc, out_cap=oc, alpha=2.0
    )
    assert not bool(info.pair_overflow)
    Ef = hbsm.fine_add(Cf, Df, beta=-1.0)
    Ef = hbsm.fine_scale(Ef, 0.5)
    dE = 0.5 * (2.0 * (dA @ dA) - dD)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(hbsm.fine_unpack(Ef))), dE,
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        float(hbsm.fine_frob_squared(Ef)), float((dE * dE).sum()),
        rtol=1e-5,
    )
    # Truncation on flat payloads: matches canonical truncate.
    Tf = hbsm.fine_truncate(Ef, 0.5, cap=Ef.cap)
    Tc, _ = hbsm.truncate(hbsm.fine_unpack(Ef), 0.5, cap=Ef.cap)
    np.testing.assert_array_equal(
        np.asarray(Tf.ids), np.asarray(Tc.ids)
    )
    np.testing.assert_allclose(
        np.asarray(hbsm.fine_unpack(Tf).data), np.asarray(Tc.data),
        rtol=1e-6, atol=1e-7,
    )


def test_fine_flat_planned_matches_unplanned():
    bf = 32
    A, dA = random_fine(8 * bf, 8 * bf, bf, 0.3, seed=13)
    pc, oc = plan_spgemm(A, A)
    plan = hbsm.make_fine_plan(A, A, pc, oc)
    Af = hbsm.fine_pack(A)
    C0, _ = hbsm.fine_matmul(
        Af, Af, pair_cap=pc, out_cap=oc
    )
    C1, info = hbsm.fine_matmul(
        Af, Af, pair_cap=pc, out_cap=oc, plan=plan
    )
    assert not bool(info.plan_mismatch)
    np.testing.assert_array_equal(np.asarray(C0.ids), np.asarray(C1.ids))
    np.testing.assert_array_equal(
        np.asarray(C0.data), np.asarray(C1.data)
    )
    # Stale plan (different structure, same capacity) must be loud.
    A2, _ = random_fine(8 * bf, 8 * bf, bf, 0.3, seed=14)
    if A2.cap == A.cap:
        Af2 = hbsm.fine_pack(A2)
        _, info2 = hbsm.fine_matmul(
            Af2, Af2, pair_cap=pc, out_cap=oc, plan=plan,
        )
        assert bool(info2.plan_mismatch)


def test_fine_precision_default_bf16_storage():
    """bf16 storage at precision='default' (one bf16 pass, f32 sums):
    result within bf16 tolerance of the oracle."""
    bf = 32
    A, dA = random_fine(8 * bf, 8 * bf, bf, 0.3, seed=15)
    A16 = hbsm.BlockMatrix(
        ids=A.ids, data=A.data.astype(jnp.bfloat16), nnz=A.nnz,
        n_rows=A.n_rows, n_cols=A.n_cols, block_size=bf,
    )
    pc, oc = plan_spgemm(A, A)
    Cd, _ = spgemm(
        A16, A16, pair_cap=pc, out_cap=oc,
        backend="segment", precision="default",
    )
    ref = dA @ dA
    rel = np.abs(
        np.asarray(hbsm.to_dense(Cd)).astype(np.float64) - ref
    ).max() / max(1e-9, np.abs(ref).max())
    assert rel < 2e-2, rel


def test_fine_supported_gates():
    assert supported(16, jnp.float32)
    assert supported(32, jnp.float32)
    assert supported(64, jnp.bfloat16)
    assert supported(128, jnp.float32)
    assert not supported(8, jnp.float32)  # below Triton's smallest dot
    assert not supported(48, jnp.float32)  # not a power of two
    assert not supported(32, jnp.float64)  # f64: the XLA path
    assert not supported(32, jnp.float16)


def test_fine_transpose_flags():
    """Transpose flags route through basic.transpose before the fine
    backend; the result must match the dense op^T oracle."""
    bf = 32
    A, dA = random_fine(8 * bf, 8 * bf, bf, 0.25, seed=9)
    B, dB = random_fine(8 * bf, 8 * bf, bf, 0.25, seed=10)
    from hierarchical_block_sparse_lib.ops import basic

    At = basic.transpose(A)
    pc, oc = plan_spgemm(At, B)
    C, _ = spgemm(
        A, B, pair_cap=pc, out_cap=oc, backend="segment", transpose_a=True,
    )
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA.T @ dB, rtol=1e-5, atol=1e-5
    )


def test_fine_trace_and_sp2_step():
    """Purification at the reference's fine granularity: fine_trace
    matches the dense trace; fine_sp2_step matches the canonical
    sp2_step (same support, values to f32 tolerance)."""
    from hierarchical_block_sparse_lib.models.purification import (
        sp2_step,
    )

    bf = 32
    n = 8 * bf
    nocc0 = n // 4
    rng = np.random.default_rng(21)
    dH = rng.standard_normal((n, n)).astype(np.float64)
    dH = (dH + dH.T) / 2
    _, V = np.linalg.eigh(dH)
    # Gapped spectrum in [0,1]: nocc occupied near 1, rest near 0 —
    # SP2 converges fast (a near-degenerate spectrum at the chemical
    # potential converges arbitrarily slowly).
    w = np.concatenate(
        [np.linspace(0.95, 0.7, nocc0), np.linspace(0.3, 0.05, n - nocc0)]
    )
    dX = (V * w) @ V.T
    dX = dX.astype(np.float32)
    X = hbsm.from_dense(jnp.asarray(dX), block_size=bf)
    Xf = hbsm.fine_pack(X)
    np.testing.assert_allclose(
        float(hbsm.fine_trace(Xf)), float(np.trace(dX)), rtol=1e-5
    )
    pc, oc = plan_spgemm(X, X)
    nocc = nocc0
    tau = 1e-7
    Yf, (t, info) = hbsm.fine_sp2_step(
        Xf, tau, pair_cap=pc, out_cap=oc, target_trace=nocc, cap=oc,
    )
    assert not bool(info.pair_overflow)
    Yc, _ = sp2_step(
        X, tau, pair_cap=pc, out_cap=oc, target_trace=nocc, cap=oc,
        backend="xla",
    )
    np.testing.assert_array_equal(
        np.asarray(hbsm.fine_unpack(Yf).ids), np.asarray(Yc.ids)
    )
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(hbsm.fine_unpack(Yf))),
        np.asarray(hbsm.to_dense(Yc)),
        rtol=2e-4, atol=1e-5,
    )
    # A few steps converge toward an idempotent projector.
    Zf = Xf
    for _ in range(25):
        Zf, _ = hbsm.fine_sp2_step(
            Zf, tau, pair_cap=pc, out_cap=oc, target_trace=nocc, cap=oc,
        )
    dZ = np.asarray(hbsm.to_dense(hbsm.fine_unpack(Zf))).astype(np.float64)
    assert np.abs(dZ @ dZ - dZ).max() < 1e-2
    assert abs(np.trace(dZ) - nocc) < 0.5
