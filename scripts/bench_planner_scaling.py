"""Host-planner scaling vs device count (VERDICT r3 weak 6: the
route planners run O(P^2)-shaped host loops of native plan_spgemm_ex
calls — fine at P=8, unexamined at pod scale).

Measures wall time of `plan_route`, `freeze_route_plan`, and
`plan_route_2level` on a B5-style banded+random mix at b=8 (planning
cost depends only on the id structure and P, not on block bytes) for
P = 2..64 virtual CPU devices, and fits the growth exponent.

The planners are HOST code (numpy + the C++ planner) amortized over a
fixed-structure iteration sequence (the SCF regime) — the question is
whether one planning pass stays negligible vs the multiply time it
serves at pod scale.

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=64 \
          python scripts/bench_planner_scaling.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=64"
)

import numpy as np  # noqa: E402


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from hierarchical_block_sparse_lib.utils.generators import b5_mix

    from hierarchical_block_sparse_lib.parallel import (
        dist, route, route2,
    )

    NB, B = 512, 8
    A = b5_mix(NB, B)
    print(f"structure: {NB}x{NB} blocks, nnz={int(A.nnz)}")

    rows = []
    for P in (2, 4, 8, 16, 32, 64):
        if P > len(jax.devices()):
            break
        mesh = dist.make_mesh(P)
        Ad = dist.distribute(A, mesh)
        t0 = time.time()
        plan = route.plan_route(Ad, Ad, P)
        t_plan = time.time() - t0
        t0 = time.time()
        route.freeze_route_plan(Ad, Ad, plan)
        t_freeze = time.time() - t0
        rows.append((P, t_plan, t_freeze, len(plan.stages)))
        print(
            f"P={P:3d}: plan_route {t_plan:6.2f}s  freeze {t_freeze:6.2f}s"
            f"  stages={len(plan.stages)}  routed={plan.blocks_routed}"
        )

    ps = np.array([r[0] for r in rows], float)
    for name, col in (("plan_route", 1), ("freeze", 2)):
        ts = np.array([r[col] for r in rows], float)
        # Fit t ~ P^k on the upper half (asymptotic regime).
        half = len(ps) // 2
        k = np.polyfit(np.log(ps[half:]), np.log(ts[half:]), 1)[0]
        print(f"{name}: growth ~ P^{k:.2f} over P={ps[half]:.0f}..{ps[-1]:.0f}")

    print()
    for h, c in ((2, 4), (4, 4), (4, 8), (8, 8)):
        if h * c > len(jax.devices()):
            break
        mesh2 = route2.make_mesh_2level(h, c)
        Ad = dist.distribute(A, dist.make_mesh(h * c))
        t0 = time.time()
        p2 = route2.plan_route_2level(Ad, Ad, h, c)
        t2 = time.time() - t0
        print(
            f"H={h} C={c} (P={h*c:2d}): plan_route_2level {t2:6.2f}s  "
            f"dcn={p2.dcn_blocks} ici={p2.ici_blocks}"
        )


if __name__ == "__main__":
    main()
