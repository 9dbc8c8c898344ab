"""Density-matrix purification demo: the reference's flagship workload
(BASELINE.json:9) end-to-end on the framework.

Builds a banded model "Hamiltonian", maps its spectrum into [0, 1],
runs SP2 purification with norm-based block truncation at a fixed
memory footprint, and verifies the result is the spectral projector.

    python examples/purification_demo.py [n] [nocc]
"""

import sys

import numpy as np

sys.path.insert(0, ".")

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib.models.purification import purify_scan
from hierarchical_block_sparse_lib.utils.profiling import Counters


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    nocc = int(sys.argv[2]) if len(sys.argv) > 2 else n // 4
    b = 128 if n % 128 == 0 else 16

    # Banded symmetric H
    rng = np.random.default_rng(0)
    rows, cols, vals = [], [], []
    for k in range(0, 9):
        v = rng.standard_normal(n - k).astype(np.float32) * 0.3
        i = np.arange(n - k)
        rows += [i, i + k] if k else [i]
        cols += [i + k, i] if k else [i]
        vals += [v, v] if k else [v]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)

    H = hbsm.from_coo(rows, cols, vals, n, block_size=b)
    dH = np.asarray(hbsm.to_dense(H)).astype(np.float64)
    w = np.linalg.eigvalsh(dH)
    lo, hi = w[0], w[-1]

    # X0 = (hi*I - H) / (hi - lo): spectrum in (0,1), occupied states high
    X = hbsm.add(
        hbsm.eye(n, b, cap=H.cap + n // b),
        H,
        alpha=hi / (hi - lo),
        beta=-1.0 / (hi - lo),
    )

    pc, oc = plan_spgemm(X, X)
    nb = -(-n // b)
    # The iterate densifies mid-purification before truncation
    # re-sparsifies it: budget for the dense bound when it is small,
    # else a generous multiple of the initial plan.
    pair_cap = min(nb**3, max(16 * pc, 1))
    out_cap = min(nb * nb, max(16 * oc, 1))

    cnt = Counters()
    with cnt.timed():
        Xf, stats = purify_scan(
            X, 40, tau=1e-7, pair_cap=pair_cap, out_cap=out_cap,
            target_trace=nocc,
        )
        np.asarray(Xf.data)  # materialize
    for s_i in range(40):
        assert not bool(np.asarray(stats.pair_overflow)[s_i]), s_i
    cnt.record(stats)

    got = np.asarray(hbsm.to_dense(Xf)).astype(np.float64)
    idem = np.linalg.norm(got @ got - got, "fro")
    print(f"n={n} nocc={nocc} block={b}")
    print(f"steps=40  trace={np.trace(got):.3f}  ||X^2-X||_F={idem:.2e}")
    print(
        f"block multiplies={cnt.n_block_multiplies:,}  "
        f"wall={cnt.wall_s:.2f}s (includes compilation; see bench.py "
        "for honest steady-state timing)"
    )
    proj = None
    if n <= 4096:
        ww, vv = np.linalg.eigh(dH)
        proj = vv[:, :nocc] @ vv[:, :nocc].T
        err = np.linalg.norm(got - proj, "fro") / max(
            np.linalg.norm(proj, "fro"), 1e-30
        )
        print(f"vs dense spectral projector: rel err {err:.2e}")


if __name__ == "__main__":
    main()
