"""B5 full-size NUMERIC execution on the virtual 8-device mesh
(VERDICT r3 item 4).

`scripts/b5_route_evidence.py` records plan-structure evidence at b=8;
this script runs the FULL configured B5 problem — 131072^2 = 1024x1024
blocks at the production b=128, banded+random mix (BASELINE.json:11) —
numerically end-to-end across 8 virtual CPU devices:

1. distributed routed SpGEMM (`dist_spgemm_routed`) with a FROZEN route
   plan (numeric-only stages), verified blockwise against the
   single-process `spgemm` on the identical structure (the per-device
   oracle — a dense 131072^2 oracle is 68 GB and impossible, the
   block-exact comparison is the stronger check anyway);
2. one distributed routed SP2 purification step
   (`dist_sp2_step_routed`, frozen) on a purifiable symmetric iterate,
   verified against the single-process `models.sp2_step`;
3. per-stage routed-traffic and pair-balance recording at the REAL
   byte scale (b=128; ~0.35 GB of stored blocks).

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
          python scripts/b5_route_full.py
Appends/refreshes the "Full-size numeric run" section of docs/B5_ROUTE.md.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
)

import numpy as np  # noqa: E402

from hierarchical_block_sparse_lib.utils.generators import b5_mix  # noqa: E402

NB = 1024
B = 128
MARK = "## Full-size numeric run (b=128)"


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import hierarchical_block_sparse_lib as hbsm
    from hierarchical_block_sparse_lib.models.purification import sp2_step
    from hierarchical_block_sparse_lib.ops.spgemm import (
        plan_spgemm,
    )
    from hierarchical_block_sparse_lib.parallel import dist, route

    P = 8
    A = b5_mix(NB, B)
    gb = int(A.nnz) * B * B * 4 / 1e9
    print(
        f"B5 full: {NB}x{NB} blocks at b={B}, nnz={int(A.nnz)} "
        f"({gb:.2f} GB stored)",
        file=sys.stderr,
    )

    mesh = dist.make_mesh(P)
    Ad = dist.distribute(A, mesh)
    plan = route.plan_route(Ad, Ad, P)
    print(plan.summary(), file=sys.stderr)
    t0 = time.time()
    frozen = route.freeze_route_plan(Ad, Ad, plan)
    t_freeze = time.time() - t0

    # --- 1. routed SpGEMM (frozen) vs the single-process product.
    pc, oc = plan_spgemm(A, A)
    t0 = time.time()
    C_ref, _ = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc, backend="xla")
    jax.block_until_ready(C_ref.data)
    t_ref = time.time() - t0
    t0 = time.time()
    Cd, stats = route.dist_spgemm_routed(Ad, Ad, mesh, frozen, backend="xla")
    jax.block_until_ready(Cd.data)
    t_routed = time.time() - t0
    assert not bool(stats["overflow"]) and not bool(stats["plan_mismatch"])
    C_got = dist.undistribute(Cd)
    nref, ngot = int(C_ref.nnz), int(C_got.nnz)
    assert nref == ngot, (nref, ngot)
    np.testing.assert_array_equal(
        np.asarray(C_ref.ids)[:nref], np.asarray(C_got.ids)[:ngot]
    )
    err = float(
        np.abs(
            np.asarray(C_got.data[:ngot]) - np.asarray(C_ref.data[:nref])
        ).max()
    )
    rel = err / max(float(np.abs(np.asarray(C_ref.data)).max()), 1e-30)
    assert rel < 1e-5, rel
    dev_pairs = np.asarray(stats["per_device_pairs"], np.int64)
    balance = dev_pairs.min() / max(dev_pairs.max(), 1)
    print(
        f"routed spgemm (frozen): {int(stats['n_block_pairs']):,} pairs, "
        f"out={ngot:,} blocks, max rel {rel:.2e}, balance {balance:.1%}, "
        f"wall {t_routed:.1f}s (single-process {t_ref:.1f}s, "
        f"freeze {t_freeze:.1f}s)",
        file=sys.stderr,
    )

    # --- 2. one routed SP2 step (frozen) vs the single-process step.
    # Purifiable symmetric iterate on the same structure.
    As = hbsm.add(A, hbsm.transpose(A), alpha=0.5, beta=0.5)
    As = hbsm.scale(
        As, 1.0 / float(np.sqrt(float(hbsm.frob_squared(As))))
    )
    X = hbsm.add(
        As, hbsm.eye(NB * B, B), beta=0.5, cap=As.cap + NB
    )
    tau, nocc = 1e-7, NB * B // 2
    pc2, oc2 = plan_spgemm(X, X)
    t0 = time.time()
    # cap must cover the UNION support (X densifies before it
    # re-sparsifies; at tau=1e-7 one step drops almost nothing) — the
    # default cap=x.cap would overflow here, which stats report loudly.
    Y_ref, st_ref = sp2_step(
        X, tau, pair_cap=pc2, out_cap=oc2, target_trace=nocc,
        backend="xla", cap=oc2,
    )
    jax.block_until_ready(Y_ref.data)
    assert not (
        bool(st_ref.pair_overflow)
        | bool(st_ref.out_overflow)
        | bool(st_ref.repack_overflow)
    ), "oracle sp2_step overflowed"
    t_sp2_ref = time.time() - t0

    Xd = dist.distribute(X, mesh)
    xplan = route.plan_route(Xd, Xd, P)
    xfrozen = route.freeze_route_plan(Xd, Xd, xplan)
    t0 = time.time()
    Yd, sst = route.dist_sp2_step_routed(
        Xd, mesh, xfrozen, tau, target_trace=nocc, backend="xla",
        expect_ids=np.asarray(Xd.ids),
    )
    jax.block_until_ready(Yd.data)
    t_sp2 = time.time() - t0
    assert not bool(sst["overflow"]) and not bool(sst["plan_mismatch"])
    Y_got = dist.undistribute(Yd)
    nyr, nyg = int(Y_ref.nnz), int(Y_got.nnz)
    assert nyr == nyg, (nyr, nyg)
    np.testing.assert_array_equal(
        np.asarray(Y_ref.ids)[:nyr], np.asarray(Y_got.ids)[:nyg]
    )
    err_y = float(
        np.abs(
            np.asarray(Y_got.data[:nyg]) - np.asarray(Y_ref.data[:nyr])
        ).max()
    )
    rel_y = err_y / max(float(np.abs(np.asarray(Y_ref.data)).max()), 1e-30)
    assert rel_y < 1e-5, rel_y
    print(
        f"routed SP2 step (frozen): {int(sst['n_block_pairs']):,} pairs, "
        f"kept {nyg:,} blocks, trace={float(sst['trace']):.1f}, "
        f"max rel {rel_y:.2e}, wall {t_sp2:.1f}s "
        f"(single-process {t_sp2_ref:.1f}s)",
        file=sys.stderr,
    )

    mb = B * B * 4 / 1e6
    lines = [
        MARK,
        "",
        "The full configured problem — 131072^2 = 1024x1024 blocks at the",
        "production **b=128** (0.35 GB stored), banded+random mix — executed",
        "NUMERICALLY end-to-end across the 8 virtual devices (VERDICT r3",
        "item 4).  Produced by `scripts/b5_route_full.py`.",
        "",
        f"- routed SpGEMM, **frozen** plan (numeric-only stages): "
        f"{int(stats['n_block_pairs']):,} pair GEMMs, {ngot:,} output "
        f"blocks; blockwise-identical support and max rel error "
        f"**{rel:.2e}** vs the single-process product",
        f"- per-device pairs {dev_pairs.tolist()} -> balance "
        f"**{balance:.1%}**",
        f"- per-stage routed blocks {list(plan.per_stage_blocks)} "
        f"({plan.blocks_routed:,} ICI blocks = "
        f"{plan.blocks_routed * mb:,.0f} MB vs ring "
        f"{plan.blocks_ring:,} = {plan.blocks_ring * mb:,.0f} MB, "
        f"{plan.blocks_routed / plan.blocks_ring:.1%})",
        f"- one routed SP2 purification step (frozen, self-checked "
        f"expect_ids): {int(sst['n_block_pairs']):,} pairs, "
        f"{nyg:,} kept blocks, max rel **{rel_y:.2e}** vs the "
        f"single-process `sp2_step`; overflow/plan_mismatch clean",
    ]
    out = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs",
        "B5_ROUTE.md",
    )
    with open(out) as f:
        doc = f.read()
    if MARK in doc:
        doc = doc[: doc.index(MARK)]
    with open(out, "w") as f:
        f.write(doc.rstrip() + "\n\n" + "\n".join(lines) + "\n")
    print(f"updated {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
