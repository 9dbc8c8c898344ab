"""Packed-contraction SpGEMM (ops.kpack) vs dense oracle and vs the
coarsened pair-enumeration path — the occupancy-exploiting fine-leaf
engine for RANDOM structures (SURVEY.md section 8.5; VERDICT r3
item 1: B2's honest leaf-32 regime)."""

import numpy as np
import pytest

import jax.numpy as jnp

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.ops.kpack import (
    kpack_spgemm,
    plan_kpack,
)
from hierarchical_block_sparse_lib.ops.repack import coarsen, plan_coarsen
from hierarchical_block_sparse_lib.ops.spgemm import (
    plan_spgemm,
    plan_spgemm_ex,
)


def random_fine(n, bf, density, seed=0):
    """Uniform-random block-sparse at fine leaf granularity (the B2
    shape, BASELINE.json:8, scaled down)."""
    rng = np.random.default_rng(seed)
    nb = n // bf
    n_blocks = max(1, int(round(density * nb * nb)))
    chosen = np.sort(rng.choice(nb * nb, n_blocks, replace=False)).astype(
        np.int32
    )
    data = rng.standard_normal((n_blocks, bf, bf)).astype(np.float32)
    m = hbsm.BlockMatrix(
        ids=jnp.asarray(chosen),
        data=jnp.asarray(data),
        nnz=jnp.asarray(n_blocks, jnp.int32),
        n_rows=n,
        n_cols=n,
        block_size=bf,
    )
    return m, np.asarray(hbsm.to_dense(m))


def _oracle_check(A, B, dA, dB, tile, alpha=1.0, n_groups=4):
    plan = plan_kpack(A, B, tile=tile, n_groups=n_groups)
    assert plan is not None
    C, info = kpack_spgemm(A, B, plan, alpha=alpha)
    assert not bool(info.plan_mismatch)
    assert C.block_size == tile
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), alpha * (dA @ dB), rtol=2e-4,
        atol=1e-3,
    )
    # Honest counter == the fine pair enumeration's count.
    n_pairs, _ = plan_spgemm(A, B)
    assert plan.n_leaf_pairs == n_pairs
    assert int(info.n_leaf_multiplies) == n_pairs
    assert int(info.n_block_pairs) == n_pairs
    # Output tiles are sorted unique (BlockMatrix invariant).
    ids = np.asarray(C.ids)
    assert (np.diff(ids) > 0).all()
    return plan, C


def test_random_kpack_vs_oracle():
    """Scaled-down B2: uniform random 8% at leaf 16, tiles of 4x4."""
    A, dA = random_fine(512, 16, 0.08, seed=2)
    plan, C = _oracle_check(A, A, dA, dA, tile=64)
    # The whole point: packed-panel FLOPs must be far below the
    # coarse-tile pair enumeration's FLOPs on random structure.
    f = 64 // 16
    Ac = coarsen(A, f, cap=plan_coarsen(A, f))
    pc, _, _, _ = plan_spgemm_ex(Ac, Ac)
    coarse_flops = 2 * 64**3 * pc
    assert plan.panel_flops < 0.55 * coarse_flops, (
        plan.panel_flops, coarse_flops,
    )
    # Structure parity with the FINE product's support, coarsened to
    # tiles.  (The coarsened pair enumeration's support is a SUPERSET:
    # a coarse pair can exist with no fine k matching, producing an
    # exact-zero tile; kpack's support is the tighter fine-exact one.)
    Cf, _ = hbsm.matmul(A, A, backend="xla")
    fids = np.asarray(Cf.ids)[: int(Cf.nnz)].astype(np.int64)
    nbJ = -(-A.nb_cols // f)
    ref = np.unique((fids // A.nb_cols // f) * nbJ + (fids % A.nb_cols) // f)
    np.testing.assert_array_equal(
        np.asarray(C.ids)[: int(C.nnz)], ref.astype(np.int32)
    )


def test_kpack_alpha_and_groups():
    A, dA = random_fine(256, 16, 0.1, seed=5)
    _oracle_check(A, A, dA, dA, tile=64, alpha=-0.5, n_groups=1)
    _oracle_check(A, A, dA, dA, tile=64, alpha=2.0, n_groups=7)


def test_kpack_rectangular():
    bf, tile = 16, 32
    rng = np.random.default_rng(3)
    dA = np.zeros((128, 192), np.float32)
    dB = np.zeros((192, 96), np.float32)
    for i in range(0, 128, bf):
        for j in range(0, 192, bf):
            if rng.random() < 0.3:
                dA[i:i + bf, j:j + bf] = rng.standard_normal((bf, bf))
    for i in range(0, 192, bf):
        for j in range(0, 96, bf):
            if rng.random() < 0.3:
                dB[i:i + bf, j:j + bf] = rng.standard_normal((bf, bf))
    ra, ca = np.nonzero(dA)
    rb, cb = np.nonzero(dB)
    A = hbsm.from_coo(ra, ca, dA[ra, ca], 128, n_cols=192, block_size=bf)
    B = hbsm.from_coo(rb, cb, dB[rb, cb], 192, n_cols=96, block_size=bf)
    plan = plan_kpack(A, B, tile=tile, n_groups=3)
    assert plan is not None
    C, info = kpack_spgemm(A, B, plan)
    assert not bool(info.plan_mismatch)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA @ dB, rtol=2e-4, atol=1e-3
    )


def test_kpack_counter_matches_occupancy_path():
    """kpack's honest counter == the coarsen(track_leaves) occupancy
    counter == the host fine plan (the bench's cross-check triangle)."""
    A, dA = random_fine(512, 16, 0.06, seed=9)
    f = 4
    Ac, occ = coarsen(A, f, cap=plan_coarsen(A, f), track_leaves=True)
    pc, oc, mbr, mcr = plan_spgemm_ex(Ac, Ac)
    _, info = hbsm.spgemm(
        Ac, Ac, pair_cap=pc, out_cap=oc, a_leaf_occ=occ, b_leaf_occ=occ,
        backend="xla",
    )
    n_fine, _ = plan_spgemm(A, A)
    assert int(info.n_leaf_multiplies) == n_fine
    plan = plan_kpack(A, A, tile=f * 16)
    assert plan.n_leaf_pairs == n_fine


def test_kpack_guard_and_mismatch():
    A, _ = random_fine(256, 16, 0.1, seed=11)
    # tile == leaf (no aggregation) -> no plan.
    assert plan_kpack(A, A, tile=16) is None
    plan = plan_kpack(A, A, tile=64)
    # Stale plan (different structure, same capacity) must be loud.
    A2, _ = random_fine(256, 16, 0.1, seed=12)
    if np.asarray(A2.ids).shape == np.asarray(A.ids).shape:
        _, info = kpack_spgemm(A2, A2, plan)
        assert bool(info.plan_mismatch)


def test_kpack_layout_variants_equivalent():
    """The three panel-assembly layouts are the same math (ADVICE r4:
    the 't'/'mc' variants previously had no CPU equivalence coverage);
    an unknown layout string must raise, not silently run 'plain'."""
    A, dA = random_fine(256, 16, 0.1, seed=7)
    plan = plan_kpack(A, A, tile=64, n_groups=3)
    ref = None
    for layout in ("plain", "t", "mc"):
        C, info = kpack_spgemm(A, A, plan, layout=layout)
        assert not bool(info.plan_mismatch)
        got = np.asarray(C.data)
        if ref is None:
            ref = got
            np.testing.assert_allclose(
                np.asarray(hbsm.to_dense(C)), dA @ dA, rtol=2e-4, atol=1e-3
            )
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="layout"):
        kpack_spgemm(A, A, plan, layout="plian")


def test_kpack_empty_tiles_absent():
    """A matrix whose product support misses some coarse tiles: kpack
    must emit exactly the touched tiles, no more."""
    bf, tile = 16, 64
    n = 256
    dA = np.zeros((n, n), np.float32)
    # Two isolated fine blocks far apart.
    dA[0:bf, 0:bf] = 1.0
    dA[192:192 + bf, 192:192 + bf] = 2.0
    ra, ca = np.nonzero(dA)
    A = hbsm.from_coo(ra, ca, dA[ra, ca], n, block_size=bf)
    plan = plan_kpack(A, A, tile=tile)
    assert plan is not None
    assert plan.n_tiles == 2
    C, _ = kpack_spgemm(A, A, plan)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA @ dA, rtol=1e-5, atol=1e-5
    )
