"""Two-level (host x chip) routing evidence on the B5 mix (VERDICT r4
item 8): per-level DCN/ICI traffic of `parallel.route2` at realistic
structure, across mesh factorizations up to 8 hosts x 8 chips = 64
virtual devices, vs the flat router and the dense ring.

Traffic depends only on the id structure and the mesh factorization,
so this is host planning on the FULL B5 block grid (1024^2 blocks =
131072^2 at b=128); a numeric anchor executes the 4x2 factorization
end-to-end on the virtual mesh.  Appends the table to docs/B5_ROUTE.md.

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=64 \
          python scripts/b5_route2_evidence.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=64"
)

import numpy as np  # noqa: E402

from hierarchical_block_sparse_lib.utils.generators import b5_mix  # noqa: E402

B_PROD = 128


def mb(blocks: int) -> int:
    return round(blocks * B_PROD * B_PROD * 4 / 1e6)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh

    import hierarchical_block_sparse_lib as hbsm
    from hierarchical_block_sparse_lib.parallel import (
        dist, route, route2,
    )

    devs = jax.devices()
    NB, B_RUN = 1024, 8  # full B5 block grid; tiny blocks (id-only math)
    A = b5_mix(NB, B_RUN)
    dA = np.asarray(hbsm.to_dense(A))
    print(f"structure: {A.nb_rows}x{A.nb_cols} blocks, nnz={int(A.nnz)}")

    rows = []
    for hh, cc in ((2, 4), (4, 2), (4, 4), (8, 8)):
        P_ = hh * cc
        if P_ > len(devs):
            print(f"skip {hh}x{cc}: only {len(devs)} devices")
            continue
        mesh = Mesh(np.asarray(devs[:P_]), ("p",))
        Ad = dist.distribute(A, mesh)
        p2 = route2.plan_route_2level(Ad, Ad, hh, cc)
        pf = route.plan_route(Ad, Ad, P_)
        rows.append(
            dict(
                hh=hh, cc=cc, P=P_,
                dcn=p2.dcn_blocks, dcn_flat=p2.dcn_blocks_flat,
                ici=p2.ici_blocks, flat_routed=pf.blocks_routed,
                ring=pf.blocks_ring,
            )
        )
        print(
            f"H={hh} C={cc} (P={P_}): DCN {p2.dcn_blocks} "
            f"(flat inter-host {p2.dcn_blocks_flat}), "
            f"ICI {p2.ici_blocks}, flat-routed {pf.blocks_routed}, "
            f"ring {pf.blocks_ring}"
        )

    # Numeric anchor at 4x2 (cheap on the virtual mesh).
    hh, cc = 4, 2
    mesh_hc = route2.make_mesh_2level(hh, cc)
    mesh = Mesh(np.asarray(devs[: hh * cc]), ("p",))
    Ad = dist.distribute(A, mesh)
    p2 = route2.plan_route_2level(Ad, Ad, hh, cc)
    C2, st = route2.dist_spgemm_2level(Ad, Ad, mesh_hc, p2, backend="xla")
    got = np.asarray(hbsm.to_dense(dist.undistribute(C2)))
    ref = dA @ dA
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert not bool(st["overflow"]) and err < 1e-5, err
    print(f"numeric anchor 4x2: max rel {err:.2e}, overflow clean")

    lines = [
        "",
        "## Two-level (host x chip) traffic at the B5 mix "
        "(VERDICT r4 item 8)",
        "",
        "Per-level traffic of `parallel/route2` vs the flat router and",
        "the dense ring, on the full 1024^2-block B5 structure (byte",
        "figures at b=128).  DCN = once-per-destination-HOST union",
        "shares; ICI = intra-host rebroadcast.  The invariant",
        "DCN <= flat-inter-host holds at every factorization.",
        "Produced by `scripts/b5_route2_evidence.py`.",
        "",
        "| H x C | P | DCN blocks (MB) | flat inter-host | ICI blocks |"
        " flat-routed | ring |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['hh']}x{r['cc']} | {r['P']} | {r['dcn']:,}"
            f" ({mb(r['dcn'])}) | {r['dcn_flat']:,} | {r['ici']:,} |"
            f" {r['flat_routed']:,} | {r['ring']:,} |"
        )
    lines.append("")
    lines.append(
        f"Numeric anchor: `dist_spgemm_2level` at 4x2 matches the "
        f"dense oracle to max rel {err:.2e}; overflow/self-checks "
        f"clean."
    )
    lines.append("")

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", "B5_ROUTE.md",
    )
    text = open(path).read()
    marker = "## Two-level (host x chip) traffic at the B5 mix"
    if marker in text:
        text = text[: text.index(marker)].rstrip() + "\n"
    text += "\n".join(lines)
    open(path, "w").write(text)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
