"""B5 routed-exchange evidence at the configured block grid (BASELINE.json:11).

B5 is the multi-host benchmark: 131072^2, banded+random mix, distributed
SpGEMM with overlapped collectives.  This script produces the
device-independent half of the BASELINE.json:5 scaling contract on a
virtual 8-device CPU mesh (VERDICT r1 items 1/3); `chip_smoke.py
--devices 4` runs B5 numerically on four GPUs:

- exact routed-traffic accounting at the FULL B5 block grid
  (1024 x 1024 blocks = 131072^2 at the 128-tile granularity): blocks
  shipped by the sparsity-aware router (`parallel/route.py`) vs the
  dense ring's (P-1) * nnz(B), per kept stage,
- per-device pair-count balance (the load-balance half of the >=80%
  nnz-block/s scaling target),
- a correctness anchor: the routed distributed product matches the
  single-device `spgemm` on the identical structure.

Routing traffic/pairs depend only on the ID STRUCTURE and P, not on the
block byte size, so the run uses b=8 blocks on the full 1024^2 block
grid (execution is 256x lighter on the CPU mesh); byte figures are
reported at the production b=128 scale.

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
          python scripts/b5_route_evidence.py
Writes docs/B5_ROUTE.md.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
)

import numpy as np  # noqa: E402

from hierarchical_block_sparse_lib.utils.generators import b5_mix  # noqa: E402

NB = 1024  # block grid of the configured 131072^2 at b=128
B_PROD = 128  # production block size (byte-scale reporting)
B_RUN = 8  # run block size (structure-identical, 256x lighter)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import hierarchical_block_sparse_lib as hbsm
    from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm
    from hierarchical_block_sparse_lib.parallel import dist, route

    P = 8
    A = b5_mix(NB, B_RUN)
    print(f"B5 mix: {NB}x{NB} blocks, nnz={int(A.nnz)}", file=sys.stderr)

    mesh = dist.make_mesh(P)
    Ad = dist.distribute(A, mesh)
    plan = route.plan_route(Ad, Ad, P)
    print(plan.summary(), file=sys.stderr)

    # Correctness anchor vs the single-device product.
    pc, oc = plan_spgemm(A, A)
    C_ref, _ = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc, backend="xla")
    Cd, stats = route.dist_spgemm_routed(Ad, Ad, mesh, plan, backend="xla")
    C_got = dist.undistribute(Cd)
    ref_ids = np.asarray(C_ref.ids)[: int(C_ref.nnz)]
    got_ids = np.asarray(C_got.ids)[: int(C_got.nnz)]
    assert np.array_equal(ref_ids, got_ids), "routed support differs"
    err = float(
        np.abs(
            np.asarray(C_got.data[: int(C_got.nnz)])
            - np.asarray(C_ref.data[: int(C_ref.nnz)])
        ).max()
    )
    scale = float(np.abs(np.asarray(C_ref.data)).max())
    rel = err / max(scale, 1e-30)
    assert rel < 1e-5, rel
    assert not bool(stats["overflow"])
    print(f"routed == single-device: max rel {rel:.2e}", file=sys.stderr)

    dev_pairs = np.asarray(stats["per_device_pairs"], np.int64)
    balance = dev_pairs.min() / max(dev_pairs.max(), 1)
    ring = plan.blocks_ring
    routed = plan.blocks_routed
    mb = B_PROD * B_PROD * 4 / 1e6

    # Device-count sweep: how the routed plan's structure scales with P
    # (host planning only — the balance and per-device-traffic trends
    # are the virtual-mesh-measurable part of the >=80% scaling target).
    sweep = []
    for p_s in (2, 4, 8):
        mesh_s = dist.make_mesh(p_s)
        ad_s = dist.distribute(A, mesh_s)
        pl_s = route.plan_route(ad_s, ad_s, p_s)
        pp = np.asarray(pl_s.per_device_pairs, np.int64)
        sweep.append(
            (p_s, pp.min() / max(pp.max(), 1),
             pl_s.blocks_routed / max(p_s - 1, 1),
             pl_s.blocks_routed / pl_s.blocks_ring,
             len(pl_s.stages))
        )

    lines = [
        "# B5 routed-exchange evidence (virtual 8-device mesh)",
        "",
        "B5 (BASELINE.json:11) is 131072^2, banded+random mix, distributed",
        "SpGEMM with overlapped collectives on N>=2 hosts.  Multi-chip",
        "hardware is absent here (see BASELINE.md), so this records the",
        "measurable half of the BASELINE.json:5 contract on the virtual",
        "8-device CPU mesh: exact routed traffic vs the dense ring, and",
        "per-device pair balance.  Routing traffic and pair counts depend",
        "only on the id structure and P, so the run uses the FULL",
        f"{NB}x{NB} block grid with b={B_RUN} blocks; byte figures below",
        f"are at the production b={B_PROD} scale.  Produced by",
        "`scripts/b5_route_evidence.py`; re-run it to regenerate.",
        "",
        f"- structure: {NB}x{NB} blocks, nnz = {int(A.nnz)}",
        "  (tridiagonal block band + 0.2% random sprinkle)",
        f"- product pairs: {plan.total_pairs:,} over {P} devices",
        f"- per-device pairs: {dev_pairs.tolist()}",
        f"- pair balance (min/max): **{balance:.1%}**"
        "  (the load-balance half of the >=80% scaling target)",
        f"- stages kept: {len(plan.stages)}/{P}"
        f" (offsets {list(plan.stages)}); zero-traffic stages dropped",
        f"- per-stage routed blocks: {list(plan.per_stage_blocks)}",
        f"- ICI traffic routed: **{routed:,} blocks**"
        f" ({routed * mb:,.0f} MB at b={B_PROD})",
        f"- dense-ring traffic: {ring:,} blocks ({ring * mb:,.0f} MB)",
        f"- routed / ring = **{routed / ring:.1%}**",
        "",
        "Device-count sweep (routed plan structure vs P; per-device",
        "routed traffic ~flat with P is what lets nnz-block/s scale):",
        "",
        "| P | pair balance | routed blocks / (P-1) | routed/ring | stages kept |",
        "|---|---|---|---|---|",
        *[
            f"| {p_s} | {bal:.1%} | {per_hop:,.0f} | {frac:.1%} | {ns}/{p_s} |"
            for p_s, bal, per_hop, frac, ns in sweep
        ],
        "",
        "Correctness anchor: the routed distributed product reproduces",
        "the single-device `spgemm` support exactly, max rel error",
        f"{rel:.2e}; no capacity overflow at the plan's per-stage caps.",
        "",
        "The banded share routes only to ring-adjacent devices, so most",
        "ring offsets carry zero banded traffic and survive only for the",
        "random sprinkle; the router ships the exact per-destination",
        "panels (`RoutePlan.send_idx`) instead of whole shards.  On real",
        "ICI the same plan's `ppermute`s are issued one stage ahead of",
        "each stage's leaf GEMMs (see `parallel/route.py::_routed_stages`",
        "and docs/OVERLAP.md for the overlap evidence methodology).",
    ]
    out = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs",
        "B5_ROUTE.md",
    )
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out}", file=sys.stderr)
    print("\n".join(lines))


if __name__ == "__main__":
    main()
