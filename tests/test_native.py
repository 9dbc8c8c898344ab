"""C++ host symbolic engine vs numpy fallback vs device symbolic phase."""

import numpy as np
import pytest

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.core.block_matrix import SENTINEL
from hierarchical_block_sparse_lib.runtime import native


def _random_ids(nb_rows, nb_cols, n, cap, seed):
    rng = np.random.default_rng(seed)
    ids = np.sort(
        rng.choice(nb_rows * nb_cols, size=n, replace=False)
    ).astype(np.int32)
    return np.concatenate([ids, np.full(cap - n, SENTINEL, np.int32)])


def test_native_available():
    assert native.have_native(), "csrc/libhbsm_host.so failed to build/load"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_spgemm_matches_numpy(seed):
    nb = 24
    a_ids = _random_ids(nb, nb, 60, 64, seed)
    b_ids = _random_ids(nb, nb, 80, 96, seed + 10)
    got = native.plan_spgemm(a_ids, b_ids, nb, nb, nb)
    want = native.plan_spgemm_numpy(a_ids, b_ids, nb, nb, nb)
    assert got == want


def test_plan_spgemm_rectangular():
    # A: 6x4 blocks, B: 4x8 blocks
    a_ids = _random_ids(6, 4, 10, 12, 3)
    b_ids = _random_ids(4, 8, 16, 20, 4)
    got = native.plan_spgemm(a_ids, b_ids, 4, 4, 8)
    want = native.plan_spgemm_numpy(a_ids, b_ids, 4, 4, 8)
    assert got == want


def test_plan_spgemm_empty():
    empty = np.full(4, SENTINEL, np.int32)
    assert native.plan_spgemm(empty, empty, 4, 4, 4) == (0, 0)


def test_plan_add_union():
    a_ids = _random_ids(16, 16, 30, 40, 5)
    b_ids = _random_ids(16, 16, 50, 64, 6)
    got = native.plan_add(a_ids, b_ids)
    a = a_ids[a_ids != SENTINEL]
    b = b_ids[b_ids != SENTINEL]
    assert got == np.union1d(a, b).size


def test_count_coo_blocks():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 256, 500).astype(np.int32)
    cols = rng.integers(0, 256, 500).astype(np.int32)
    got = native.count_coo_blocks(rows, cols, 16, 16)
    bid = (rows // 16).astype(np.int64) * 16 + cols // 16
    assert got == np.unique(bid).size


@pytest.mark.parametrize("tau", [0.0, 0.5, 2.0, 1e9])
def test_plan_spamm_matches_numpy(tau):
    rng = np.random.default_rng(8)
    nb = 20
    a_ids = _random_ids(nb, nb, 50, 64, 8)
    b_ids = _random_ids(nb, nb, 70, 80, 9)
    a_norms = np.where(
        a_ids != SENTINEL, rng.uniform(0.1, 3.0, a_ids.size), 0
    ).astype(np.float32)
    b_norms = np.where(
        b_ids != SENTINEL, rng.uniform(0.1, 3.0, b_ids.size), 0
    ).astype(np.float32)
    got = native.plan_spamm(a_ids, a_norms, b_ids, b_norms, nb, nb, nb, tau)
    want = native.plan_spamm_numpy(
        a_ids, a_norms, b_ids, b_norms, nb, nb, tau
    )
    assert got == want
    if tau == 0.0:
        assert got == native.plan_spgemm(a_ids, b_ids, nb, nb, nb)
    if tau == 1e9:
        assert got == (0, 0)


def test_symbolic_spgemm_matches_device():
    from hierarchical_block_sparse_lib.ops.spgemm import spgemm_symbolic

    rng = np.random.default_rng(11)
    n, b = 128, 16
    da = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.05)).astype(
        np.float32
    )
    db = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.05)).astype(
        np.float32
    )
    A = hbsm.from_dense(da, block_size=b)
    B = hbsm.from_dense(db, block_size=b)
    n_pairs, _ = native.plan_spgemm(A.ids, B.ids, A.nb_cols, B.nb_rows, B.nb_cols)
    ai_h, bi_h, cid_h, tot_h = native.symbolic_spgemm(
        np.asarray(A.ids), np.asarray(B.ids), A.nb_cols, B.nb_cols, n_pairs
    )
    ai_d, bi_d, cid_d, tot_d, raw_d = spgemm_symbolic(A, B, n_pairs)
    assert int(raw_d) == n_pairs
    assert tot_h == int(tot_d) == n_pairs
    # Same multiset of (a_idx, b_idx, c_id) triples.
    h = sorted(zip(cid_h.tolist(), ai_h.tolist(), bi_h.tolist()))
    d = sorted(
        zip(
            np.asarray(cid_d).tolist(),
            np.asarray(ai_d).tolist(),
            np.asarray(bi_d).tolist(),
        )
    )
    assert h == d
