"""Distributed execution over device meshes.

- `dist`: 1D block-row partition, ring-SUMMA SpGEMM (B shards rotate via
  ppermute, overlapped with leaf GEMMs); the simplest scalable layout.
- `dist2d`: square 2D mesh, Cannon's algorithm (both operands resident,
  nearest-neighbor rotations on the ICI torus) — the 2D block partition
  of SURVEY.md section 8.3.
- `route`: sparsity-aware block router (BASELINE.json:5) — host-planned
  exact per-stage panel exchange shipping only the blocks each
  destination's products touch, with routed SpGEMM and routed SP2
  purification (`dist_sp2_step_routed` / `dist_purify_routed`).
- `route2`: two-level host x chip routing (SURVEY.md section 6.8
  ICI/DCN hierarchy) — union shares cross the "host" axis (DCN) once
  per destination host, then rebroadcast intra-host over the "chip"
  axis (ICI all_gather); per-level traffic evidence in `Route2Plan`.
"""

from hierarchical_block_sparse_lib.parallel import (
    dist,
    dist2d,
    route,
    route2,
)

__all__ = ["dist", "dist2d", "route", "route2"]
