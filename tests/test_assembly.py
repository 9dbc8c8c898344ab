"""Round-trip and extraction tests vs dense oracle (SURVEY.md section 5)."""

import numpy as np
import jax.numpy as jnp
import pytest

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.utils import generators as gen


@pytest.mark.parametrize("n,bw,b", [(64, 5, 8), (128, 16, 16), (100, 7, 16)])
def test_from_coo_roundtrip_banded(n, bw, b):
    rows, cols, vals = gen.banded_coo(n, bw, seed=1)
    dense = gen.dense_oracle(rows, cols, vals, n)
    m = hbsm.from_coo(rows, cols, vals, n, block_size=b)
    assert int(m.nnz) > 0
    np.testing.assert_allclose(np.asarray(hbsm.to_dense(m)), dense, rtol=1e-6)


def test_from_coo_duplicates_sum():
    rows = np.array([0, 0, 3], np.int32)
    cols = np.array([1, 1, 2], np.int32)
    vals = np.array([1.0, 2.0, 5.0], np.float32)
    m = hbsm.from_coo(rows, cols, vals, 8, block_size=4)
    d = np.asarray(hbsm.to_dense(m))
    assert d[0, 1] == 3.0 and d[3, 2] == 5.0


def test_from_dense_roundtrip_nonsquare():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((48, 80)).astype(np.float32)
    x[10:30, :] = 0
    m = hbsm.from_dense(x, block_size=16)
    np.testing.assert_allclose(np.asarray(hbsm.to_dense(m)), x, rtol=1e-6)


def test_from_dense_threshold_drops_blocks():
    x = np.zeros((32, 32), np.float32)
    x[0, 0] = 1e-8  # tiny block
    x[16, 16] = 5.0
    m = hbsm.from_dense(x, block_size=16, threshold=1e-4, cap=4)
    assert int(m.nnz) == 1


def test_get_values():
    rows, cols, vals = gen.banded_coo(64, 3, seed=2)
    dense = gen.dense_oracle(rows, cols, vals, 64)
    m = hbsm.from_coo(rows, cols, vals, 64, block_size=8)
    qr = np.array([0, 5, 63, 10, 0], np.int32)
    qc = np.array([0, 5, 63, 60, 63], np.int32)  # last two: absent blocks
    got = np.asarray(hbsm.get_values(m, qr, qc))
    np.testing.assert_allclose(got, dense[qr, qc], rtol=1e-6)


def test_to_coo_matches_dense():
    rows, cols, vals = gen.random_block_sparse_coo(64, 8, 0.3, seed=3)
    dense = gen.dense_oracle(rows, cols, vals, 64)
    m = hbsm.from_coo(rows, cols, vals, 64, block_size=8)
    r, c, v, mask = hbsm.to_coo(m)
    r, c, v = np.asarray(r)[mask], np.asarray(c)[mask], np.asarray(v)[mask]
    back = gen.dense_oracle(r, c, v, 64)
    np.testing.assert_allclose(back, dense, rtol=1e-6)


@pytest.mark.parametrize("chunk", [1, 3, 2048])
def test_to_coo_chunks_matches_to_coo(chunk):
    """Streamed export == monolithic export for any chunk size (incl.
    chunk=1 forcing the clamped-window path near the end)."""
    rows, cols, vals = gen.random_block_sparse_coo(100, 8, 0.3, seed=4)
    dense = gen.dense_oracle(rows, cols, vals, 100)
    m = hbsm.from_coo(rows, cols, vals, 100, block_size=8)
    parts = list(hbsm.to_coo_chunks(m, chunk_blocks=chunk))
    assert parts
    r = np.concatenate([p[0] for p in parts])
    c = np.concatenate([p[1] for p in parts])
    v = np.concatenate([p[2] for p in parts])
    back = gen.dense_oracle(r, c, v, 100)
    np.testing.assert_allclose(back, dense, rtol=1e-6)
    # no duplicate emission from window clamping
    assert len(np.unique(r.astype(np.int64) * 128 + c)) == len(r)


def test_to_coo_chunks_drop_zeros():
    x = np.zeros((16, 16), np.float32)
    x[0, 0] = 2.0  # block (0,0) stored, 63 explicit zeros inside it
    m = hbsm.from_dense(x, block_size=8)
    parts = list(hbsm.to_coo_chunks(m, drop_zeros=True))
    r = np.concatenate([p[0] for p in parts])
    v = np.concatenate([p[2] for p in parts])
    assert len(r) == 1 and v[0] == 2.0


def test_eye():
    m = hbsm.eye(100, block_size=16)
    np.testing.assert_allclose(np.asarray(hbsm.to_dense(m)), np.eye(100, dtype=np.float32))


def test_empty():
    m = hbsm.empty(64, 64, 16, cap=4)
    assert int(m.nnz) == 0
    assert np.all(np.asarray(hbsm.to_dense(m)) == 0)
