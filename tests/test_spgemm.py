"""SpGEMM vs dense oracle — configs modeled on BASELINE.json:7-10
(scaled down for CI) plus transpose flags and counter checks."""

import numpy as np
import pytest

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib.utils import generators as gen


def _mul_oracle(A, B, dA, dB, **kw):
    n_pairs, n_out = plan_spgemm(A, B)
    C, info = hbsm.spgemm(
        A, B, pair_cap=max(n_pairs, 1), out_cap=max(n_out, 1), **kw
    )
    assert not bool(info.pair_overflow)
    assert not bool(info.out_overflow)
    assert int(info.n_block_pairs) == n_pairs
    assert int(info.n_out_blocks) == n_out
    return C, info


def test_banded_spgemm():
    """Scaled-down B1 (BASELINE.json:7): banded, C = A*B vs dense."""
    n, bw, b = 256, 8, 16
    r, c, v = gen.banded_coo(n, bw, seed=0)
    dA = gen.dense_oracle(r, c, v, n)
    A = hbsm.from_coo(r, c, v, n, block_size=b)
    C, info = _mul_oracle(A, A, dA, dA)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA @ dA, rtol=2e-4, atol=1e-3
    )
    assert int(C.nnz) == int(info.n_out_blocks)


def test_random_block_sparse_chain():
    """Scaled-down B2 (BASELINE.json:8): SpGEMM + add + scale chain."""
    n, b = 256, 16
    r1, c1, v1 = gen.random_block_sparse_coo(n, b, 0.1, seed=1)
    r2, c2, v2 = gen.random_block_sparse_coo(n, b, 0.1, seed=2)
    dA = gen.dense_oracle(r1, c1, v1, n)
    dB = gen.dense_oracle(r2, c2, v2, n)
    A = hbsm.from_coo(r1, c1, v1, n, block_size=b)
    B = hbsm.from_coo(r2, c2, v2, n, block_size=b)
    C, _ = _mul_oracle(A, B, dA, dB, alpha=0.5)
    D = hbsm.add(C, A, beta=2.0)
    D = hbsm.scale(D, -1.0)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(D)),
        -(0.5 * dA @ dB + 2.0 * dA),
        rtol=2e-4,
        atol=1e-3,
    )


@pytest.mark.parametrize("ta,tb", [(True, False), (False, True), (True, True)])
def test_transpose_flags(ta, tb):
    n, b = 128, 16
    r1, c1, v1 = gen.banded_coo(n, 5, seed=3)
    r2, c2, v2 = gen.random_block_sparse_coo(n, b, 0.2, seed=4)
    dA = gen.dense_oracle(r1, c1, v1, n)
    dB = gen.dense_oracle(r2, c2, v2, n)
    A = hbsm.from_coo(r1, c1, v1, n, block_size=b)
    B = hbsm.from_coo(r2, c2, v2, n, block_size=b)
    opA = dA.T if ta else dA
    opB = dB.T if tb else dB
    n_pairs = 64 * 64 * 2  # generous cap
    C, info = hbsm.spgemm(
        A, B, pair_cap=n_pairs, out_cap=64, transpose_a=ta, transpose_b=tb
    )
    assert not bool(info.pair_overflow) and not bool(info.out_overflow)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), opA @ opB, rtol=2e-4, atol=1e-3
    )


def test_zero_shortcircuit_counts():
    """Block-diagonal x block-diagonal: exactly one pair per block
    (the reference's zero-child short-circuit, SURVEY.md section 4.2)."""
    n, b = 128, 16
    nb = n // b
    x = np.zeros((n, n), np.float32)
    for i in range(nb):
        x[i * b : (i + 1) * b, i * b : (i + 1) * b] = np.random.default_rng(
            i
        ).standard_normal((b, b))
    A = hbsm.from_dense(x, block_size=b)
    C, info = _mul_oracle(A, A, x, x)
    assert int(info.n_block_pairs) == nb
    assert int(info.n_out_blocks) == nb
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), x @ x, rtol=2e-4, atol=1e-3
    )


def test_overflow_reported():
    n, b = 128, 16
    r, c, v = gen.banded_coo(n, 8, seed=5)
    A = hbsm.from_coo(r, c, v, n, block_size=b)
    _, info = hbsm.spgemm(A, A, pair_cap=2, out_cap=2)
    assert bool(info.pair_overflow)


def test_row_caps_overflow_reported():
    """row_caps is deprecated and ignored: an undersized value changes
    nothing and row_overflow is never set.  B has a block-row wider than
    any per-row cap (the case a per-row kernel once had to flag)."""
    import jax.numpy as jnp

    b, nb = 128, 16
    n = b * nb
    rng = np.random.default_rng(11)

    def mk(ids):
        ids = np.sort(np.asarray(ids, np.int32))
        return hbsm.BlockMatrix(
            ids=jnp.asarray(ids),
            data=jnp.asarray(
                rng.standard_normal((len(ids), b, b)).astype(np.float32)
            ),
            nnz=jnp.asarray(len(ids), jnp.int32),
            n_rows=n, n_cols=n, block_size=b,
        )

    A = mk([0, 1])  # blocks (0,0), (0,1)
    B = mk(list(range(nb)))  # block-row 0 fully dense: 16 blocks
    dA = np.asarray(hbsm.to_dense(A))
    dB = np.asarray(hbsm.to_dense(B))
    for caps in ((8, 16), (16, 16)):
        C, info = hbsm.spgemm(
            A, B, pair_cap=16, out_cap=16, backend="segment", row_caps=caps
        )
        assert not bool(info.row_overflow)
        np.testing.assert_allclose(
            np.asarray(hbsm.to_dense(C)), dA @ dB, rtol=2e-4, atol=1e-2
        )


def test_leaf_granularity_accounting():
    """Occupancy-tracked coarsening reports the EXACT logical-leaf
    multiply count — it must equal the pair count of the same multiply
    planned at the original (fine) block granularity (the host oracle;
    SURVEY.md section 8.5, VERDICT r1 item 2)."""
    n, bw, b_fine, f = 512, 24, 16, 8  # coarsen 16 -> 128 tiles
    r, c, v = gen.banded_coo(n, bw, seed=8)
    A16 = hbsm.from_coo(r, c, v, n, block_size=b_fine)
    fine_pairs, _ = plan_spgemm(A16, A16)

    A128, occ = hbsm.coarsen(A16, f, track_leaves=True)
    assert occ.shape == (A128.cap, f, f)
    assert int(occ.sum()) == int(A16.nnz)
    pc, oc = plan_spgemm(A128, A128)
    C, info = hbsm.spgemm(
        A128, A128, pair_cap=pc, out_cap=oc,
        a_leaf_occ=occ, b_leaf_occ=occ,
    )
    assert int(info.n_leaf_multiplies) == fine_pairs
    # The tile-level count inflated by padding: strictly more leaf-slots
    # than real leaf multiplies.
    assert fine_pairs < int(info.n_block_pairs) * f**3
    # Untracked multiplies report -1 (not a bogus zero).
    _, info2 = hbsm.spgemm(A128, A128, pair_cap=pc, out_cap=oc)
    assert int(info2.n_leaf_multiplies) == -1
    # Numerics unchanged by the accounting.
    dA = gen.dense_oracle(r, c, v, n)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C))[:n, :n], dA @ dA, rtol=2e-4, atol=1e-2
    )


def test_empty_operand():
    A = hbsm.empty(64, 64, 16, cap=4)
    B = hbsm.eye(64, 16)
    C, info = hbsm.spgemm(A, B, pair_cap=8, out_cap=8)
    assert int(info.n_block_pairs) == 0
    assert int(C.nnz) == 0
    assert np.all(np.asarray(hbsm.to_dense(C)) == 0)


def test_identity_multiply():
    n, b = 96, 16
    r, c, v = gen.random_block_sparse_coo(n, b, 0.3, seed=6)
    dA = gen.dense_oracle(r, c, v, n)
    A = hbsm.from_coo(r, c, v, n, block_size=b)
    I = hbsm.eye(n, b)
    C, _ = _mul_oracle(A, I, dA, None)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), dA, rtol=1e-5, atol=1e-5
    )


def test_nonsquare_spgemm():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    y = rng.standard_normal((96, 32)).astype(np.float32)
    x[:, 48:] = 0
    A = hbsm.from_dense(x, block_size=16)
    B = hbsm.from_dense(y, block_size=16)
    C, _ = _mul_oracle(A, B, x, y)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), x @ y, rtol=2e-4, atol=1e-3
    )


@pytest.mark.parametrize("backend", ["xla", "segment"])
def test_fused_accumulate(backend):
    """C = alpha*A@B + beta*D (fused BLAS-style accumulate, reference
    multiply-into-C semantics SURVEY.md C5) vs dense oracle, including
    D blocks outside the product support."""
    n, b = 256, 16
    r1, c1, v1 = gen.random_block_sparse_coo(n, b, 0.15, seed=11)
    r2, c2, v2 = gen.random_block_sparse_coo(n, b, 0.15, seed=12)
    r3, c3, v3 = gen.random_block_sparse_coo(n, b, 0.25, seed=13)
    dA = gen.dense_oracle(r1, c1, v1, n)
    dB = gen.dense_oracle(r2, c2, v2, n)
    dD = gen.dense_oracle(r3, c3, v3, n)
    A = hbsm.from_coo(r1, c1, v1, n, block_size=b)
    B = hbsm.from_coo(r2, c2, v2, n, block_size=b)
    D = hbsm.from_coo(r3, c3, v3, n, block_size=b)
    n_pairs, n_out = plan_spgemm(A, B)
    out_cap = n_out + int(D.nnz)  # union upper bound
    C, info = hbsm.spgemm(
        A, B, pair_cap=max(n_pairs, 1), out_cap=out_cap,
        alpha=0.5, beta=-2.0, accum=D, backend=backend,
    )
    assert not bool(info.pair_overflow)
    assert not bool(info.out_overflow)
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), 0.5 * (dA @ dB) - 2.0 * dD,
        rtol=2e-4, atol=1e-3,
    )
    # union structure: every D block id must appear in C
    cids = set(np.asarray(C.ids)[: int(C.nnz)].tolist())
    dids = set(np.asarray(D.ids)[: int(D.nnz)].tolist())
    assert dids <= cids


def test_fused_accumulate_traced_scalars():
    """alpha/beta as traced arrays (the SP2 branchless blend)."""
    import jax.numpy as jnp

    n, b = 128, 16
    r1, c1, v1 = gen.banded_coo(n, 5, seed=3)
    dA = gen.dense_oracle(r1, c1, v1, n)
    A = hbsm.from_coo(r1, c1, v1, n, block_size=b)
    n_pairs, n_out = plan_spgemm(A, A)
    C, info = hbsm.spgemm(
        A, A, pair_cap=n_pairs, out_cap=n_out + int(A.nnz),
        alpha=jnp.float32(-1.0), beta=jnp.float32(2.0), accum=A,
    )
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), -(dA @ dA) + 2.0 * dA,
        rtol=2e-4, atol=1e-3,
    )


def test_symbolic_plan_reuse():
    """make_plan + spgemm(plan=...): numeric phase only, exact same
    result as the planless call across changed data (fixed structure)."""
    n, b = 256, 16
    r1, c1, v1 = gen.random_block_sparse_coo(n, b, 0.2, seed=21)
    r2, c2, v2 = gen.random_block_sparse_coo(n, b, 0.2, seed=22)
    A = hbsm.from_coo(r1, c1, v1, n, block_size=b)
    B = hbsm.from_coo(r2, c2, v2, n, block_size=b)
    n_pairs, n_out = plan_spgemm(A, B)
    plan = hbsm.make_plan(A, B, pair_cap=n_pairs)
    for scale_ in (1.0, -3.0):
        A2 = hbsm.scale(A, scale_)  # same ids, different data
        C_ref, i_ref = hbsm.spgemm(A2, B, pair_cap=n_pairs, out_cap=n_out)
        C_pl, i_pl = hbsm.spgemm(
            A2, B, pair_cap=n_pairs, out_cap=n_out, plan=plan
        )
        assert np.array_equal(np.asarray(C_ref.ids), np.asarray(C_pl.ids))
        np.testing.assert_array_equal(
            np.asarray(C_ref.data), np.asarray(C_pl.data)
        )
        assert int(i_pl.n_block_pairs) == int(i_ref.n_block_pairs)
    with pytest.raises(ValueError):
        hbsm.spgemm(A, B, pair_cap=n_pairs + 1, out_cap=n_out, plan=plan)


def test_planned_union_with_gemm_cap():
    """spgemm(plan=<with union>, accum=, gemm_cap=<pair_cap) must slice
    the planned slot map alongside the pair arrays (regression: shape
    crash) and match the unplanned SpAMM-accumulate result."""
    n, b = 256, 32
    rng = np.random.default_rng(0)
    d = np.zeros((n, n), np.float32)
    nb = n // b
    for i in range(nb):
        for j in range(nb):
            if abs(i - j) <= 2:
                scale = 0.001 if abs(i - j) == 2 else 1.0
                d[i*b:(i+1)*b, j*b:(j+1)*b] = (
                    rng.standard_normal((b, b)) * scale
                )
    A = hbsm.from_dense(d, block_size=b)
    pc, oc = plan_spgemm(A, A)
    tau = 0.5
    gc, _ = hbsm.plan_spamm(A, A, tau)
    assert gc < pc  # the filter must actually shrink the GEMM batch
    plan = hbsm.make_plan(
        A, A, pc, tau=tau, filter_by_norm=True, accum_ids=A.ids,
        out_cap=oc,
    )
    C, info = hbsm.spgemm(
        A, A, pair_cap=pc, out_cap=oc, tau=tau, filter_by_norm=True,
        gemm_cap=gc, plan=plan, accum=A, beta=0.5,
    )
    assert not bool(info.plan_mismatch)
    C2, _ = hbsm.spgemm(
        A, A, pair_cap=pc, out_cap=oc, tau=tau, filter_by_norm=True,
        gemm_cap=gc, accum=A, beta=0.5,
    )
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), np.asarray(hbsm.to_dense(C2))
    )
    # Stale plan (different ids, same caps) -> plan_mismatch.
    d2 = d.copy()
    d2[:b, 3*b:4*b] = 0.7
    d2[:b, b:2*b] = 0.0
    A2 = hbsm.from_dense(d2, block_size=b)
    if A2.cap == A.cap:
        _, i2 = hbsm.spgemm(
            A2, A2, pair_cap=pc, out_cap=oc, tau=tau,
            filter_by_norm=True, gemm_cap=gc, plan=plan, accum=A2,
            beta=0.5,
        )
        assert bool(i2.plan_mismatch)


def test_accum_aligned_matches_generic():
    """ALIGNED beta-accumulate (output structure = the accumulator's):
    the segment kernel adds the accumulator block in its epilogue; the
    result must equal the generic union accumulate, and a product block
    outside the accumulator support must be loud."""
    import dataclasses

    import jax.numpy as jnp

    import hierarchical_block_sparse_lib as hbsm
    from hierarchical_block_sparse_lib.ops.spgemm import spgemm

    rng = np.random.default_rng(5)
    n, b = 8 * 128, 128
    nb = n // b
    nblk = nb * nb // 3
    ids = np.sort(rng.choice(nb * nb, nblk, replace=False)).astype(np.int32)
    A = hbsm.BlockMatrix(
        ids=jnp.asarray(ids),
        data=jnp.asarray(
            rng.standard_normal((nblk, b, b)).astype(np.float32)
        ),
        nnz=jnp.asarray(nblk, jnp.int32),
        n_rows=n, n_cols=n, block_size=b,
    )
    pc, oc = plan_spgemm(A, A)
    C0, _ = spgemm(A, A, pair_cap=pc, out_cap=oc, backend="xla")
    # Accumulator with EXACTLY the product support (the aligned regime).
    D = dataclasses.replace(
        C0,
        data=jnp.where(
            C0.valid_mask()[:, None, None],
            jnp.asarray(
                rng.standard_normal((oc, b, b)).astype(np.float32)
            ),
            0.0,
        ),
    )
    generic, gi = spgemm(
        A, A, pair_cap=pc, out_cap=oc,
        backend="segment", accum=D, beta=1.0,
    )
    aligned, ai = spgemm(
        A, A, pair_cap=pc, out_cap=oc,
        backend="segment", accum=D, beta=1.0, accum_aligned=True,
    )
    assert not bool(ai.plan_mismatch)
    np.testing.assert_array_equal(
        np.asarray(generic.ids), np.asarray(aligned.ids)
    )
    np.testing.assert_allclose(
        np.asarray(generic.data), np.asarray(aligned.data),
        rtol=2e-4, atol=1e-5,
    )
    # A smaller accumulator support (missing product blocks) must flag.
    k = int(C0.nnz)
    bad_ids = np.asarray(C0.ids).copy()
    bad_ids[k - 1] = bad_ids[k - 2]  # duplicate => invalid target
    Dbad = dataclasses.replace(D, ids=jnp.asarray(bad_ids))
    _, bi = spgemm(
        A, A, pair_cap=pc, out_cap=oc,
        backend="segment", accum=Dbad, beta=1.0, accum_aligned=True,
    )
    assert bool(bi.plan_mismatch)
