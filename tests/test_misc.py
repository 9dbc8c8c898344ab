"""Counters/instrumentation and non-f32 dtype paths."""

import numpy as np
import jax.numpy as jnp

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib.utils.profiling import Counters


def test_counters_accumulate():
    n, b = 128, 16
    rng = np.random.default_rng(0)
    d = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3)).astype(
        np.float32
    )
    A = hbsm.from_dense(d, block_size=b)
    pc, oc = plan_spgemm(A, A)
    cnt = Counters()
    with cnt.timed():
        C, info = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc)
        np.asarray(C.data)  # materialize so wall time is attributed
    cnt.record(info)
    assert cnt.n_block_multiplies == pc
    assert cnt.n_out_blocks == oc
    assert cnt.n_multiplies == 1
    assert cnt.overflows == 0
    assert cnt.wall_s > 0
    assert cnt.pairs_per_second() > 0
    assert cnt.effective_gflops(b) > 0
    # overflow is counted
    _, info2 = hbsm.spgemm(A, A, pair_cap=2, out_cap=oc)
    cnt.record(info2)
    assert cnt.overflows == 1


def test_bf16_spgemm():
    n, b = 128, 16
    rng = np.random.default_rng(1)
    d = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3)).astype(
        np.float32
    )
    A32 = hbsm.from_dense(d, block_size=b)
    A16 = hbsm.BlockMatrix(
        ids=A32.ids,
        data=A32.data.astype(jnp.bfloat16),
        nnz=A32.nnz,
        n_rows=n,
        n_cols=n,
        block_size=b,
    )
    pc, oc = plan_spgemm(A16, A16)
    C, info = hbsm.spgemm(A16, A16, pair_cap=pc, out_cap=oc, precision="default")
    assert C.dtype == jnp.bfloat16
    got = np.asarray(hbsm.to_dense(C)).astype(np.float64)
    want = d.astype(np.float64) @ d.astype(np.float64)
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() / scale < 0.05  # bf16 storage tolerance
    # norms/truncate on bf16 storage
    f2 = float(hbsm.frob_squared(A16))
    np.testing.assert_allclose(f2, (d.astype(np.float64) ** 2).sum(), rtol=0.02)
    T = hbsm.truncate(A16, 1e9)
    assert int(T.nnz) == 0


def test_spmm_spmv():
    n, m, b = 144, 48, 16
    rng = np.random.default_rng(2)
    d = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.25)).astype(
        np.float32
    )
    A = hbsm.from_dense(d, block_size=b)
    X = rng.standard_normal((n, m)).astype(np.float32)
    Y = np.asarray(hbsm.spmm(A, jnp.asarray(X), alpha=0.5))
    np.testing.assert_allclose(Y, 0.5 * d @ X, rtol=2e-5, atol=2e-5)
    v = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(hbsm.spmv(A, jnp.asarray(v)))
    np.testing.assert_allclose(y, d @ v, rtol=2e-5, atol=2e-5)
    # non-multiple-of-block row count on the RHS side of the padding
    d2 = d[:, : n - 8]
    A2 = hbsm.from_dense(d2, block_size=b)
    X2 = rng.standard_normal((n - 8, m)).astype(np.float32)
    Y2 = np.asarray(hbsm.spmm(A2, jnp.asarray(X2)))
    np.testing.assert_allclose(Y2, d2 @ X2, rtol=2e-5, atol=2e-5)
