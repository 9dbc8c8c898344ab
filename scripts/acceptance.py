"""Full-size acceptance checks on the GPU (the BASELINE.json:5
criterion: match the reference's numerics on its test matrices).

Run: python scripts/acceptance.py      (~2-4 min warm, longer cold)

Unlike tests/ (CPU, reduced sizes, interpret-mode kernels), this drives
the compiled GPU kernels at the reference's stated configs and compares
against f64 dense oracles.  Results recorded in BASELINE.md.
"""

import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp


import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib.utils.cache import enable_compile_cache
from hierarchical_block_sparse_lib.utils import generators as gen

TOL = 1e-5  # f32-faithful vs f64 oracle


def check(name, rel, tol=TOL):
    status = "OK" if rel < tol else "FAIL"
    print(f"{name}: max_rel={rel:.2e} [{status}]")
    assert rel < tol, name
    return rel


def b1_banded():
    """B1 (BASELINE.json:7): banded 4096^2, bw 64, leaf 16 -> 128 tiles."""
    n, bw = 4096, 64
    r, c, v = gen.banded_coo(n, bw, seed=0)
    A = hbsm.coarsen(hbsm.from_coo(r, c, v, n, block_size=16), 8)
    pc, oc = plan_spgemm(A, A)
    C, info = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc)
    assert not bool(info.pair_overflow) and not bool(info.out_overflow)
    dA = gen.dense_oracle(r, c, v, n).astype(np.float64)
    exact = dA @ dA
    rel = np.abs(np.asarray(hbsm.to_dense(C)).astype(np.float64) - exact).max()
    check("B1 banded 4096^2 bw64 C=A*A", rel / np.abs(exact).max())


def b2_chain():
    """B2 (BASELINE.json:8) op chain at 8192^2, 5% blocks:
    D = 2*(0.5*A@B + 0.25*A)."""
    rng = np.random.default_rng(11)
    n, b, dens = 8192, 128, 0.05
    nb = n // b
    nblk = int(dens * nb * nb)

    def mk(seed):
        r = np.random.default_rng(seed)
        ids = np.sort(r.choice(nb * nb, nblk, replace=False)).astype(np.int32)
        data = r.standard_normal((nblk, b, b)).astype(np.float32) * 0.1
        return hbsm.BlockMatrix(
            ids=jnp.asarray(ids), data=jnp.asarray(data),
            nnz=jnp.asarray(nblk, jnp.int32),
            n_rows=n, n_cols=n, block_size=b,
        )

    A, B = mk(11), mk(12)
    pc, oc = plan_spgemm(A, B)
    C, info = hbsm.spgemm(
        A, B, pair_cap=pc, out_cap=oc, alpha=0.5
    )
    assert not bool(info.pair_overflow) and not bool(info.out_overflow)
    D = hbsm.scale(hbsm.add(C, A, beta=0.25), 2.0)
    dA = np.asarray(hbsm.to_dense(A)).astype(np.float64)
    dB = np.asarray(hbsm.to_dense(B)).astype(np.float64)
    exact = 2.0 * (0.5 * (dA @ dB) + 0.25 * dA)
    rel = np.abs(np.asarray(hbsm.to_dense(D)).astype(np.float64) - exact).max()
    check("B2 chain 8192^2 5% spgemm+add+scale", rel / np.abs(exact).max())


def b3_purification():
    """B3 (BASELINE.json:9): purification converges to the spectral
    projector with bounded error at tau=1e-7."""
    from hierarchical_block_sparse_lib.models.purification import purify_scan

    n, b, nocc = 1024, 128, 256
    rng = np.random.default_rng(0)
    r, c, v = gen.banded_coo(n, 40, seed=3)
    H = hbsm.from_coo(r, c, v, n, block_size=b)
    dH = np.asarray(hbsm.to_dense(H)).astype(np.float64)
    dH = (dH + dH.T) / 2
    H = hbsm.from_dense(jnp.asarray(dH.astype(np.float32)), block_size=b)
    w = np.linalg.eigvalsh(dH)
    lo, hi = w[0], w[-1]
    X = hbsm.add(
        hbsm.eye(n, b, cap=H.cap + n // b), H,
        alpha=hi / (hi - lo), beta=-1.0 / (hi - lo),
    )
    nb = n // b
    pc, oc = plan_spgemm(X, X)
    Xf, stats = purify_scan(
        X, 40, tau=1e-7, pair_cap=nb**3, out_cap=nb * nb,
        target_trace=nocc,
    )
    assert not bool(np.asarray(stats.pair_overflow).any())
    got = np.asarray(hbsm.to_dense(Xf)).astype(np.float64)
    ww, vv = np.linalg.eigh(dH)
    proj = vv[:, :nocc] @ vv[:, :nocc].T
    rel = np.linalg.norm(got - proj) / np.linalg.norm(proj)
    check("B3 purification 1024^2 -> spectral projector (fro)", rel, 1e-4)


def b4_near_dense():
    """B4 (BASELINE.json:10) numerics at the warm-up scale (8192^2, 50%
    block density) through BOTH the direct path and the column-slab
    tier that runs the configured 32768^2 (VERDICT r2 item 6: B4 had no
    acceptance numerics check).  The f64 oracle at 32768^2 needs ~26 GB
    of host RAM, so the slab TIER is validated here at the same density
    on the same code path."""
    from hierarchical_block_sparse_lib.ops.slab import (
        plan_colslab,
        spgemm_colslab,
    )

    n, b, dens = 8192, 128, 0.5
    nb = n // b
    nblk = int(dens * nb * nb)
    r = np.random.default_rng(42)
    ids = np.sort(r.choice(nb * nb, nblk, replace=False)).astype(np.int32)
    data = r.standard_normal((nblk, b, b)).astype(np.float32) * 0.1
    A = hbsm.BlockMatrix(
        ids=jnp.asarray(ids), data=jnp.asarray(data),
        nnz=jnp.asarray(nblk, jnp.int32),
        n_rows=n, n_cols=n, block_size=b,
    )
    dA = np.asarray(hbsm.to_dense(A)).astype(np.float64)
    exact = dA @ dA
    scale = np.abs(exact).max()

    pc, oc = plan_spgemm(A, A)
    C, info = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc)
    assert not bool(info.pair_overflow) and not bool(info.out_overflow)
    rel = np.abs(
        np.asarray(hbsm.to_dense(C)).astype(np.float64) - exact
    ).max()
    check("B4 near-dense 8192^2 50% (direct)", rel / scale)

    plan = plan_colslab(A, A, 4)
    Cs, info_s = spgemm_colslab(A, A, plan=plan)
    assert not bool(np.asarray(info_s.pair_overflow).any())
    rel_s = np.abs(
        np.asarray(hbsm.to_dense(Cs)).astype(np.float64) - exact
    ).max()
    check("B4 column-slab tier (4 slabs)", rel_s / scale)


def b2_leaf32_headline():
    """The HEADLINE path (VERDICT r4 item 5): the configured B2 —
    random 16384^2, 5% block density at LEAF 32 — through BOTH the
    direct canonical spgemm (auto dispatch) and the
    flat-resident FinePlan path, vs an f64 dense oracle computed on
    host (~2 GB dA + ~2 GB exact; the host dgemm takes a minute or
    two — this is the one acceptance stage that is slow by design)."""
    n, bf, dens = 16384, 32, 0.05
    nb = n // bf
    nblk = int(round(dens * nb * nb))
    r = np.random.default_rng(2)
    ids = np.sort(r.choice(nb * nb, nblk, replace=False)).astype(np.int32)
    data = r.standard_normal((nblk, bf, bf)).astype(np.float32) * 0.1
    A = hbsm.BlockMatrix(
        ids=jnp.asarray(ids), data=jnp.asarray(data),
        nnz=jnp.asarray(nblk, jnp.int32),
        n_rows=n, n_cols=n, block_size=bf,
    )
    dA = np.asarray(hbsm.to_dense(A)).astype(np.float64)
    exact = dA @ dA
    scale = np.abs(exact).max()

    pc, oc = plan_spgemm(A, A)
    C, info = hbsm.spgemm(
        A, A, pair_cap=pc, out_cap=oc
    )
    assert not bool(info.pair_overflow) and not bool(info.out_overflow)
    rel = np.abs(
        np.asarray(hbsm.to_dense(C)).astype(np.float64) - exact
    ).max()
    check("B2 CONFIGURED 16384^2 leaf-32 direct",
          rel / scale)

    fplan = hbsm.make_fine_plan(A, A, pc, oc)
    Af = hbsm.fine_pack(A)
    Cf, inf2 = hbsm.fine_matmul(
        Af, Af, pair_cap=pc, out_cap=oc, plan=fplan
    )
    assert not bool(inf2.plan_mismatch)
    rel_f = np.abs(
        np.asarray(hbsm.to_dense(hbsm.fine_unpack(Cf))).astype(np.float64)
        - exact
    ).max()
    check("B2 CONFIGURED 16384^2 leaf-32 fine-flat (headline)",
          rel_f / scale)


def b1_leaf16_direct():
    """B1 at its NATIVE leaf 16 (no coarsening
    — the reference's own granularity; VERDICT r4 item 5)."""
    n, bw = 4096, 64
    r, c, v = gen.banded_coo(n, bw, seed=0)
    A = hbsm.from_coo(r, c, v, n, block_size=16)
    pc, oc = plan_spgemm(A, A)
    from hierarchical_block_sparse_lib.ops.spgemm import (
        resolve_backend,
    )

    backend = resolve_backend(16, A.dtype)
    C, info = hbsm.spgemm(
        A, A, pair_cap=pc, out_cap=oc
    )
    assert not bool(info.pair_overflow) and not bool(info.out_overflow)
    dA = gen.dense_oracle(r, c, v, n).astype(np.float64)
    exact = dA @ dA
    rel = np.abs(np.asarray(hbsm.to_dense(C)).astype(np.float64) - exact).max()
    check(
        f"B1 banded 4096^2 NATIVE leaf-16 (backend={backend})",
        rel / np.abs(exact).max(),
    )


def precision_modes():
    n, bw = 1024, 48
    r, c, v = gen.banded_coo(n, bw, seed=0)
    A = hbsm.coarsen(hbsm.from_coo(r, c, v, n, block_size=16), 8)
    dA = gen.dense_oracle(r, c, v, n).astype(np.float64)
    exact = dA @ dA
    pc, oc = plan_spgemm(A, A)
    for prec, tol in (("highest", 1e-5), ("default", 2e-2)):
        C, _ = hbsm.spgemm(
            A, A, pair_cap=pc, out_cap=oc,
            precision=prec,
        )
        rel = np.abs(
            np.asarray(hbsm.to_dense(C)).astype(np.float64) - exact
        ).max() / np.abs(exact).max()
        check(f"precision={prec}", rel, tol)


if __name__ == "__main__":
    enable_compile_cache()
    print(f"backend: {jax.default_backend()} {jax.devices()}")
    b1_banded()
    b1_leaf16_direct()
    b2_chain()
    b2_leaf32_headline()
    b3_purification()
    b4_near_dense()
    precision_modes()
    print("ALL ACCEPTANCE CHECKS PASSED")
