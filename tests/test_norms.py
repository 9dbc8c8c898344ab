"""Per-block Frobenius norms and leaf truncation (plain jnp reductions,
which XLA fuses into one pass) vs numpy, over padded capacities and
odd block counts."""

import jax.numpy as jnp
import numpy as np
import pytest

import hierarchical_block_sparse_lib as hbsm


def _padded(cap, b, nnz, seed):
    """A BlockMatrix with `nnz` random blocks and cap - nnz padding."""
    rng = np.random.default_rng(seed)
    nb = max(cap, 4)
    ids = np.full(cap, np.iinfo(np.int32).max, np.int32)
    ids[:nnz] = np.sort(rng.choice(nb * nb, nnz, replace=False))
    data = np.zeros((cap, b, b), np.float32)
    data[:nnz] = rng.standard_normal((nnz, b, b)) * rng.uniform(
        0.1, 3.0, (nnz, 1, 1)
    )
    m = hbsm.BlockMatrix(
        ids=jnp.asarray(ids), data=jnp.asarray(data),
        nnz=jnp.asarray(nnz, jnp.int32),
        n_rows=nb * b, n_cols=nb * b, block_size=b,
    )
    return m, data


@pytest.mark.parametrize("cap,b", [(7, 8), (32, 16), (33, 8), (1, 8)])
def test_block_frob_squared(cap, b):
    m, data = _padded(cap, b, max(1, cap - 2), seed=cap + b)
    got = np.asarray(hbsm.block_frob_squared(m))
    want = (data.astype(np.float64) ** 2).sum(axis=(1, 2))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.all(got[int(m.nnz):] == 0)


@pytest.mark.parametrize("tau", [0.0, 3.0, 1e9])
def test_truncate_keep(tau):
    m, data = _padded(33, 8, 30, seed=3)
    n2 = (data.astype(np.float64) ** 2).sum(axis=(1, 2))
    keep = n2[:30] > tau * tau
    t, kept = hbsm.truncate(m, tau, cap=m.cap)
    assert int(kept) == int(keep.sum()) == int(t.nnz)
    np.testing.assert_array_equal(
        np.asarray(t.ids)[: int(kept)], np.asarray(m.ids)[:30][keep]
    )
    np.testing.assert_array_equal(
        np.asarray(t.data)[: int(kept)], data[:30][keep]
    )
    assert np.all(np.asarray(t.data)[int(kept):] == 0)
