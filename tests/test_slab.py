"""Column-slab SpGEMM (ops.slab) vs the unsliced product and the dense
oracle — the near-dense tier for B4 at its configured 32768^2 size
(BASELINE.json:10; VERDICT r1 item 4), tested at CI scale."""

import numpy as np
import pytest

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm


def _near_dense(n, b, density, seed):
    rng = np.random.default_rng(seed)
    nb = n // b
    d = rng.standard_normal((n, n)).astype(np.float32)
    mask = rng.random((nb, nb)) < density
    for i in range(nb):
        for j in range(nb):
            if not mask[i, j]:
                d[i * b:(i + 1) * b, j * b:(j + 1) * b] = 0
    return d


@pytest.mark.parametrize("n_slabs", [2, 3, 4])
def test_colslab_matches_oracle(n_slabs):
    n, b = 256, 16
    dA = _near_dense(n, b, 0.5, seed=1)
    dB = _near_dense(n, b, 0.5, seed=2)
    A = hbsm.from_dense(dA, block_size=b)
    B = hbsm.from_dense(dB, block_size=b)
    C, info = hbsm.spgemm_colslab(A, B, n_slabs=n_slabs, alpha=0.5)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), 0.5 * dA @ dB, rtol=2e-4, atol=1e-2
    )
    assert not bool(info.pair_overflow)
    assert not bool(info.out_overflow)
    # Counter parity: slab pair counts sum to the unsliced plan exactly.
    pc, oc = plan_spgemm(A, B)
    assert int(info.n_block_pairs) == pc
    assert int(info.n_out_blocks) == oc
    assert int(C.nnz) == oc


def test_colslab_under_jit_with_plan():
    """With a precomputed plan the whole slab pipeline traces as one jit
    program (the bench path; plan reuse at fixed structure)."""
    import dataclasses
    import jax
    from hierarchical_block_sparse_lib.ops.slab import (
        plan_colslab, spgemm_colslab,
    )

    n, b = 256, 16
    dA = _near_dense(n, b, 0.6, seed=4)
    A = hbsm.from_dense(dA, block_size=b)
    plan = plan_colslab(A, A, 3)

    @jax.jit
    def f(data):
        m = dataclasses.replace(A, data=data)
        C, info = spgemm_colslab(m, m, plan=plan)
        return C.data, info.n_block_pairs

    out, pairs = f(A.data)
    C_ref, _ = hbsm.spgemm_colslab(A, A, n_slabs=3)
    np.testing.assert_allclose(np.asarray(out), np.asarray(C_ref.data))
    pc, _ = plan_spgemm(A, A)
    assert int(pairs) == pc


def test_colslab_sparse_and_empty_slabs():
    """Banded input where some slabs carry nothing."""
    from hierarchical_block_sparse_lib.utils import generators as gen

    n, b = 256, 16
    r, c, v = gen.banded_coo(n, 12, seed=3)
    dA = gen.dense_oracle(r, c, v, n)
    A = hbsm.from_dense(dA, block_size=b)
    C, info = hbsm.spgemm_colslab(A, A, n_slabs=8)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA @ dA, rtol=2e-4, atol=1e-2
    )
    pc, _ = plan_spgemm(A, A)
    assert int(info.n_block_pairs) == pc
