"""Two-level (host x chip) sparsity-aware block routing.

SURVEY.md section 6.8 mandates the ICI/DCN hierarchy: "ICI within a
host/slice, DCN across hosts" (BASELINE.json:5's multi-host target;
VERDICT r2 item 3).  The flat router (`parallel.route`) treats the mesh
as one axis, so a B panel needed by k chips of a remote host crosses
the slow DCN k times.  This module factors the mesh as
``Mesh(devices.reshape(H, C), ("host", "chip"))`` and routes in two
levels:

- **DCN level**: for host-stage ht, each source chip s packs ONE share
  per destination host — the subset of its B blocks needed by ANY chip
  of host (host(s) - ht) mod H — and a single `ppermute` over the
  "host" axis ships it.  Every block crosses DCN at most once per
  destination host (union semantics), instead of once per requesting
  chip.
- **ICI level**: an `all_gather` over the "chip" axis replicates the
  H-local shares intra-host, where links are ~10x faster.

The local compute structure is IDENTICAL to the flat router's (one
exact-capacity SpGEMM per (host-stage, source chip) against that chip's
share, fused into the union accumulator), so all the per-stage
exactness — pair/out caps from the host planner, software-pipelined
exchange one host-stage ahead of the GEMM batches — carries over
unchanged.  Shares arrive SORTED with SENTINEL
padding last because chips own ascending block-row ranges and each
share preserves its source's id order.

Traffic accounting (block copies): `dcn_blocks` (two-level) vs
`dcn_blocks_flat` (what the flat plan ships across host boundaries) vs
`blocks_ring` (the dense ring).  dcn_blocks <= dcn_blocks_flat always —
equality only when no remote panel is shared between sibling chips.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib.core import assembly
from hierarchical_block_sparse_lib.ops import basic
from hierarchical_block_sparse_lib.ops.spgemm import spgemm
from hierarchical_block_sparse_lib.runtime import native


@dataclass(frozen=True)
class Route2Plan:
    """Host-side exact two-level routing plan (reusable while both
    operands keep their id structure, like `route.RoutePlan`)."""

    n_hosts: int
    n_chips: int
    # Host-ring offsets actually carrying traffic, ascending (0 = the
    # intra-host stage: no DCN, ICI all_gather only).
    stages: tuple
    # Per kept stage: int32[P, share_cap_t] local B indices each source
    # chip sends toward host (host(src) - ht) mod H; -1 padding last.
    send_idx: tuple
    # Per kept stage, per source-chip slot cc in [0, C): exact
    # max-over-destinations (pair, out) caps and (max_b_row, max_c_row)
    # for the local multiply against that share — (ht, cc) multiplies
    # with zero pairs everywhere are dropped (None entry).
    stage_caps: tuple  # tuple[tuple[None | (pc, oc, mbr, mcr), ...], ...]
    out_cap: int
    # Max blocks in any row of the final per-device union (c-side row
    # cap for the fused per-share accumulate; see route.RoutePlan).
    union_c_row_max: int
    total_pairs: int
    per_device_pairs: tuple
    # Traffic evidence (block copies of b*b elements).
    dcn_blocks: int  # two-level: every share crosses DCN once
    dcn_blocks_flat: int  # the flat plan's inter-host block copies
    ici_blocks: int  # copies received over intra-host all_gathers
    blocks_ring: int  # dense ring baseline: (P-1) * nnz(B)
    per_stage_blocks: tuple

    def summary(self) -> str:
        return (
            f"route2 plan: {self.n_hosts}x{self.n_chips} stages="
            f"{list(self.stages)}, DCN {self.dcn_blocks} blocks vs flat "
            f"{self.dcn_blocks_flat} "
            f"({self.dcn_blocks / max(1, self.dcn_blocks_flat):.1%}), "
            f"ICI {self.ici_blocks}, ring {self.blocks_ring}"
        )


def plan_route_2level(
    a: BlockMatrix, b: BlockMatrix, n_hosts: int, n_chips: int
) -> Route2Plan:
    """Build the exact two-level plan from DISTRIBUTED ids
    ([P, cap_local] with P = n_hosts * n_chips, host-major device
    order — the layout of `dist.distribute` over the flattened mesh)."""
    H, C = n_hosts, n_chips
    P_ = H * C
    a_ids = np.asarray(a.ids)
    b_ids = np.asarray(b.ids)
    assert a_ids.ndim == 2 and a_ids.shape[0] == P_, a_ids.shape
    a_nbc = a.nb_cols
    b_nbc = b.nb_cols
    sent = int(SENTINEL)

    # Membership bitmaps (see route.plan_route: O(nnz) lookups instead
    # of per-pair np.isin; the P^2 C++ planner calls dominate).
    need_mask = np.zeros((P_, b.nb_rows), bool)
    for d in range(P_):
        ids = a_ids[d][a_ids[d] != sent]
        need_mask[d, np.unique(ids % a_nbc)] = True
    need_mask_host = np.stack(
        [need_mask[h * C:(h + 1) * C].any(axis=0) for h in range(H)]
    )
    b_rows_local = [
        (b_ids[s][b_ids[s] != sent] // b_nbc) for s in range(P_)
    ]

    # Flat-plan DCN baseline: block copies crossing a host boundary in
    # the flat router (each dst chip gets its own copy).
    dcn_flat = 0
    for t in range(P_):
        for s in range(P_):
            d = (s - t) % P_
            if d // C != s // C:
                dcn_flat += int(need_mask[d, b_rows_local[s]].sum())

    # Two-level shares: raw[ht][s] = local indices s sends toward host
    # (host(s) - ht) mod H.
    raw = [[None] * P_ for _ in range(H)]
    stage_sizes = np.zeros(H, np.int64)
    for ht in range(H):
        for s in range(P_):
            hd = (s // C - ht) % H
            sel = need_mask_host[hd, b_rows_local[s]]
            idx = np.nonzero(sel)[0].astype(np.int32)
            raw[ht][s] = idx
            stage_sizes[ht] += idx.size

    stages = [ht for ht in range(H) if stage_sizes[ht] > 0]

    send_idx = []
    stage_caps = []
    per_stage_blocks = []
    per_dev_pairs = np.zeros(P_, np.int64)
    dcn_blocks = 0
    ici_blocks = 0
    for ht in stages:
        cap_t = max(max(raw[ht][s].size for s in range(P_)), 1)
        sidx = np.full((P_, cap_t), -1, np.int32)
        for s in range(P_):
            idx = raw[ht][s]
            sidx[s, : idx.size] = idx
            if ht != 0:
                dcn_blocks += int(idx.size)
            # all_gather hands each of the other C-1 siblings a copy.
            ici_blocks += (C - 1) * int(idx.size)
        send_idx.append(sidx)
        per_stage_blocks.append(int(stage_sizes[ht]))
        # Exact caps per (ht, source-chip slot): dst chip d multiplies
        # against the share packed by chip cc of host (host(d)+ht)%H.
        caps_t = []
        for cc in range(C):
            pc_t = oc_t = br_t = cr_t = 0
            any_pairs = False
            for d in range(P_):
                hs = (d // C + ht) % H
                s = hs * C + cc
                idx = raw[ht][s]
                sub_ids = (
                    b_ids[s][idx] if idx.size else np.empty(0, np.int32)
                )
                np_pairs, np_out, mbr, mcr = native.plan_spgemm_ex(
                    a_ids[d], sub_ids, a_nbc, b.nb_rows, b_nbc
                )
                pc_t = max(pc_t, np_pairs)
                oc_t = max(oc_t, np_out)
                br_t = max(br_t, mbr)
                cr_t = max(cr_t, mcr)
                per_dev_pairs[d] += np_pairs
                any_pairs = any_pairs or np_pairs > 0
            caps_t.append(
                (max(pc_t, 1), max(oc_t, 1), max(br_t, 1), max(cr_t, 1))
                if any_pairs
                else None
            )
        stage_caps.append(tuple(caps_t))

    # Exact output capacity: union of everything each device receives.
    out_cap = 1
    union_cr = 1
    for d in range(P_):
        recv_ids = []
        for ht in stages:
            hs = (d // C + ht) % H
            for cc in range(C):
                s = hs * C + cc
                idx = raw[ht][s]
                if idx.size:
                    recv_ids.append(b_ids[s][idx])
        allb = (
            np.sort(np.concatenate(recv_ids))
            if recv_ids
            else np.empty(0, np.int32)
        )
        _, n_out, _, u_cr = native.plan_spgemm_ex(
            a_ids[d], allb, a_nbc, b.nb_rows, b_nbc
        )
        out_cap = max(out_cap, n_out)
        union_cr = max(union_cr, u_cr)

    nnz_b = int((b_ids != sent).sum())
    return Route2Plan(
        n_hosts=H,
        n_chips=C,
        stages=tuple(stages),
        send_idx=tuple(send_idx),
        stage_caps=tuple(stage_caps),
        out_cap=int(out_cap),
        union_c_row_max=int(union_cr),
        total_pairs=int(per_dev_pairs.sum()),
        per_device_pairs=tuple(int(x) for x in per_dev_pairs),
        dcn_blocks=int(dcn_blocks),
        dcn_blocks_flat=int(dcn_flat),
        ici_blocks=int(ici_blocks),
        blocks_ring=int((P_ - 1) * nnz_b),
        per_stage_blocks=tuple(per_stage_blocks),
    )


def make_mesh_2level(n_hosts: int, n_chips: int) -> Mesh:
    """("host", "chip") mesh over the first n_hosts*n_chips devices,
    host-major (chip = fastest-varying = the ICI-adjacent axis on real
    slices)."""
    devs = np.asarray(jax.devices()[: n_hosts * n_chips]).reshape(
        n_hosts, n_chips
    )
    return Mesh(devs, ("host", "chip"))


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def bucket_plan_2level(plan: Route2Plan) -> Route2Plan:
    """Round every static capacity up to a power of two (share widths,
    per-(stage, chip) caps, union out_cap) so consecutive purification
    steps whose envelope matches land on the SAME compiled program —
    the two-level analogue of `route.bucket_plan`."""
    send_idx = []
    for s in plan.send_idx:
        w = _next_pow2(s.shape[1])
        padded = np.full((s.shape[0], w), -1, np.int32)
        padded[:, : s.shape[1]] = s
        send_idx.append(padded)
    stage_caps = tuple(
        tuple(
            None if c is None else tuple(_next_pow2(v) for v in c)
            for c in per_cc
        )
        for per_cc in plan.stage_caps
    )
    return dataclasses.replace(
        plan,
        send_idx=tuple(send_idx),
        stage_caps=stage_caps,
        out_cap=_next_pow2(plan.out_cap),
        union_c_row_max=_next_pow2(plan.union_c_row_max),
    )


@dataclass(frozen=True)
class FrozenRoute2Plan:
    """Per-(host-stage, source-chip, device) frozen symbolic plans for
    the two-level routed SpGEMM: every share multiply runs NUMERIC-ONLY
    (no symbolic sorts, no union merges inside the shard_map) — the
    same tier `route.FrozenRoutePlan` gives the flat router (VERDICT r3
    items 2-3).  Built by `freeze_route2_plan`; staleness self-checked
    per share via MultiplyInfo.plan_mismatch."""

    route: Route2Plan
    # Per kept stage: tuple over source-chip slots; None where the
    # stage_caps entry is None (zero pairs everywhere), else a
    # SymbolicPlan whose array leaves carry leading [H, C] device axes.
    stage_plans: tuple


def freeze_route2_plan(
    a: BlockMatrix, b: BlockMatrix, plan: Route2Plan
) -> FrozenRoute2Plan:
    """Freeze the per-share symbolic structure of a two-level routed
    SpGEMM.  For each kept host-stage ht, source-chip slot cc, and
    device d, runs the REAL `make_plan` against d's local A and the
    exact share d consumes, threading the running per-device union as
    the accumulator structure — so the frozen chain reproduces
    `_stages_2level`'s fused accumulates bit-exactly (same (ht, cc)
    order)."""
    from hierarchical_block_sparse_lib.ops.spgemm import make_plan

    H, C_ = plan.n_hosts, plan.n_chips
    P_ = H * C_
    a_ids = np.asarray(a.ids)
    b_ids = np.asarray(b.ids)
    out_cap = plan.out_cap
    sent = int(SENTINEL)
    bs = b.data.shape[-1]
    dummy = jnp.zeros((1, bs, bs), b.dtype)

    def _mat(ids_np, like):
        ids_j = jnp.asarray(ids_np)
        return BlockMatrix(
            ids=ids_j,
            data=jnp.broadcast_to(
                dummy, (ids_np.shape[0],) + dummy.shape[1:]
            ),
            nnz=jnp.asarray(int((ids_np != sent).sum()), jnp.int32),
            n_rows=like.n_rows,
            n_cols=like.n_cols,
            block_size=like.block_size,
        )

    u_ids = [
        jnp.full((out_cap,), SENTINEL, jnp.int32) for _ in range(P_)
    ]
    stage_plans = []
    for k, ht in enumerate(plan.stages):
        per_cc = []
        for cc in range(C_):
            caps = plan.stage_caps[k][cc]
            if caps is None:
                per_cc.append(None)
                continue
            pc = caps[0]
            per_dev = []
            for d in range(P_):
                hs = (d // C_ + ht) % H
                s = hs * C_ + cc
                idx = plan.send_idx[k][s]
                pan = np.where(
                    idx >= 0, b_ids[s][np.maximum(idx, 0)], sent
                ).astype(np.int32)
                pl = make_plan(
                    _mat(a_ids[d], a),
                    _mat(pan, b),
                    pc,
                    accum_ids=u_ids[d],
                    out_cap=out_cap,
                )
                u_ids[d] = pl.out_ids
                per_dev.append(pl)
            per_cc.append(
                jax.tree.map(
                    lambda *v: jnp.stack(v).reshape(
                        H, C_, *v[0].shape
                    ),
                    *per_dev,
                )
            )
        stage_plans.append(tuple(per_cc))
    return FrozenRoute2Plan(route=plan, stage_plans=tuple(stage_plans))


def _stages_2level(
    a_loc: BlockMatrix,
    b_loc: BlockMatrix,
    send_l,
    plan: Route2Plan,
    out_cap: int,
    backend: str,
    precision: str,
    host_axis: str,
    chip_axis: str,
    stage_plans=None,
):
    """Shared inner loop (inside shard_map): software-pipelined two-level
    exchange (DCN ppermute + ICI all_gather one host-stage ahead of the
    GEMM batches) + per-share local SpGEMM fused into the union
    accumulator.  Returns per-device (C, pairs, overflow, plan
    mismatch).  `stage_plans` (from a FrozenRoute2Plan, local shards
    with leading [1, 1] axes) makes every share multiply numeric-only."""
    H, C_ = plan.n_hosts, plan.n_chips
    stages = list(plan.stages)
    n_stages = len(stages)
    both = (host_axis, chip_axis)

    def exchange(si, k):
        """Pack my share for host-stage k; DCN ppermute over the host
        axis (ht > 0), then ICI all_gather over the chip axis.  Returns
        ([C, cap] ids, [C, cap, b, b] data): every sibling share of the
        source host, sorted within each share."""
        idx = si[0, 0]
        valid = idx >= 0
        safe = jnp.maximum(idx, 0)
        ids_s = jnp.where(valid, b_loc.ids[safe], SENTINEL).astype(
            jnp.int32
        )
        data_s = jnp.where(valid[:, None, None], b_loc.data[safe], 0)
        ht = stages[k]
        if ht != 0:
            perm = [(hs, (hs - ht) % H) for hs in range(H)]
            ids_s = jax.lax.ppermute(ids_s, host_axis, perm)
            data_s = jax.lax.ppermute(data_s, host_axis, perm)
        return (
            jax.lax.all_gather(ids_s, chip_axis),
            jax.lax.all_gather(data_s, chip_axis),
        )

    c = assembly.empty(
        a_loc.n_rows, b_loc.n_cols, a_loc.block_size, out_cap,
        dtype=a_loc.dtype,
    )
    _vary = lambda v: jax.lax.pcast(v, both, to="varying")  # noqa: E731
    c = jax.tree.map(_vary, c)
    pairs = _vary(jnp.zeros((), jnp.int32))
    ovf = _vary(jnp.zeros((), bool))
    mism = _vary(jnp.zeros((), bool))

    # Software pipeline: issue exchange k+1 (DCN + ICI) before the
    # C_ local multiplies of stage k, so the slow hop hides behind
    # a whole host-stage of GEMM batches.
    recv = exchange(send_l[0], 0)
    for k in range(n_stages):
        nxt = (
            exchange(send_l[k + 1], k + 1) if k + 1 < n_stages else None
        )
        ids_g, data_g = recv
        for cc in range(C_):
            caps = plan.stage_caps[k][cc]
            if caps is None:
                continue  # zero pairs for every destination
            first_mul = k == 0 and all(
                plan.stage_caps[0][c0] is None for c0 in range(cc)
            )
            pc, oc, mbr, mcr = caps
            share = BlockMatrix(
                ids=ids_g[cc],
                data=data_g[cc],
                nnz=jnp.sum(ids_g[cc] != SENTINEL).astype(jnp.int32),
                n_rows=b_loc.n_rows,
                n_cols=b_loc.n_cols,
                block_size=b_loc.block_size,
            )
            pl = None
            if stage_plans is not None and stage_plans[k][cc] is not None:
                pl = jax.tree.map(
                    lambda v: v[0, 0], stage_plans[k][cc]
                )
            # Fused accumulate at the union capacity (round 3; see
            # route._routed_stages): one pass per share instead of
            # multiply + sort-based union add.  The FIRST executed
            # share multiply skips the accumulate — its accumulator is
            # the empty C, and XLA does not elide the beta*0 gather-add.
            c, info = spgemm(
                a_loc,
                share,
                pair_cap=pc,
                out_cap=out_cap,
                row_caps=(mbr, plan.union_c_row_max),
                backend=backend,
                precision=precision,
                accum=None if first_mul else c,
                beta=1.0,
                plan=pl,
            )
            pairs = pairs + info.n_block_pairs
            ovf = (
                ovf | info.pair_overflow | info.out_overflow
                | info.row_overflow
            )
            mism = mism | info.plan_mismatch
        recv = nxt
    return c, pairs, ovf, mism


def _mk_spec(m, host_axis, chip_axis):
    sp = P(host_axis, chip_axis)
    return BlockMatrix(
        ids=sp, data=sp, nnz=sp,
        n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size,
    )


def _to2(m, H, C_):
    """Reshape a flat [P, ...] distribution to [H, C, ...]."""
    return dataclasses.replace(
        m,
        ids=m.ids.reshape(H, C_, *m.ids.shape[1:]),
        data=m.data.reshape(H, C_, *m.data.shape[1:]),
        nnz=m.nnz.reshape(H, C_),
    )


def _from2(m, H, C_):
    return dataclasses.replace(
        m,
        ids=m.ids.reshape(H * C_, *m.ids.shape[2:]),
        data=m.data.reshape(H * C_, *m.data.shape[2:]),
        nnz=m.nnz.reshape(H * C_),
    )


def _flatten_frozen(frozen: FrozenRoute2Plan | None):
    """(flat tuple of stacked plans, {(stage, chip) -> flat index})."""
    flat, pos = [], {}
    if frozen is not None:
        for k, per_cc in enumerate(frozen.stage_plans):
            for cc, sp in enumerate(per_cc):
                if sp is not None:
                    pos[(k, cc)] = len(flat)
                    flat.append(sp)
    return tuple(flat), pos


def _rebuild_plans(plans_flat, pos, n_stages, C_):
    return [
        [
            plans_flat[pos[(k, cc)]] if (k, cc) in pos else None
            for cc in range(C_)
        ]
        for k in range(n_stages)
    ]


def dist_spgemm_2level(
    a: BlockMatrix,
    b: BlockMatrix,
    mesh: Mesh,
    plan: Route2Plan,
    alpha=1.0,
    host_axis: str = "host",
    chip_axis: str = "chip",
    backend: str = "auto",
    precision: str = "highest",
    out_cap: int | None = None,
):
    """Distributed C = alpha * A @ B over the two-level exchange.

    Inputs distributed as [P, cap_local] over the FLATTENED
    (host, chip) mesh (host-major, matching `dist.distribute` on the
    flat device list).  `plan` may be a `FrozenRoute2Plan` to run every
    share multiply numeric-only.  Returns (C distributed, stats dict)
    with the per-level traffic evidence.
    """
    frozen = None
    if isinstance(plan, FrozenRoute2Plan):
        frozen = plan
        plan = frozen.route
    H, C_ = plan.n_hosts, plan.n_chips
    assert mesh.shape[host_axis] == H and mesh.shape[chip_axis] == C_
    out_cap = plan.out_cap if out_cap is None else out_cap
    n_stages = len(plan.stages)
    sp2 = P(host_axis, chip_axis)
    send_dev = [
        jax.device_put(
            np.asarray(s).reshape(H, C_, -1),
            jax.sharding.NamedSharding(mesh, sp2),
        )
        for s in plan.send_idx
    ]
    plans_flat, plan_pos = _flatten_frozen(frozen)

    def body(a_l, b_l, *rest):
        send_l = rest[:n_stages]
        stage_plans = (
            _rebuild_plans(rest[n_stages:], plan_pos, n_stages, C_)
            if frozen is not None
            else None
        )
        a_loc = dataclasses.replace(
            a_l, ids=a_l.ids[0, 0], data=a_l.data[0, 0], nnz=a_l.nnz[0, 0]
        )
        b_loc = dataclasses.replace(
            b_l, ids=b_l.ids[0, 0], data=b_l.data[0, 0], nnz=b_l.nnz[0, 0]
        )
        c, pairs, ovf, mism = _stages_2level(
            a_loc, b_loc, send_l, plan, out_cap, backend, precision,
            host_axis, chip_axis, stage_plans=stage_plans,
        )
        c = basic.scale(c, jnp.asarray(alpha, c.dtype))
        total = jax.lax.psum(jax.lax.psum(pairs, host_axis), chip_axis)
        _pmax = lambda v: (  # noqa: E731
            jax.lax.pmax(
                jax.lax.pmax(v.astype(jnp.int32), host_axis), chip_axis
            )
            > 0
        )
        expand = lambda x: x[None, None]  # noqa: E731
        return (
            jax.tree.map(expand, c),
            expand(pairs),
            expand(total),
            expand(_pmax(ovf)),
            expand(_pmax(mism)),
        )

    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            _mk_spec(a, host_axis, chip_axis),
            _mk_spec(b, host_axis, chip_axis),
        )
        + (sp2,) * n_stages
        + tuple(jax.tree.map(lambda _: sp2, sp) for sp in plans_flat),
        out_specs=(
            dataclasses.replace(
                _mk_spec(a, host_axis, chip_axis),
                n_rows=a.n_rows, n_cols=b.n_cols,
            ),
            sp2, sp2, sp2, sp2,
        ),
        check_vma=False,
    )
    c2, dev_pairs, total, ovf, mism = f(
        _to2(a, H, C_), _to2(b, H, C_), *send_dev, *plans_flat
    )
    c = _from2(c2, H, C_)
    stats = dict(
        n_block_pairs=total.ravel()[0],
        per_device_pairs=dev_pairs.ravel(),
        overflow=ovf.any(),
        plan_mismatch=mism.any(),
        dcn_blocks=plan.dcn_blocks,
        dcn_blocks_flat=plan.dcn_blocks_flat,
        ici_blocks=plan.ici_blocks,
        blocks_ring=plan.blocks_ring,
        n_stages=n_stages,
    )
    return c, stats


def dist_sp2_step_2level(
    x: BlockMatrix,
    mesh: Mesh,
    plan: Route2Plan,
    tau,
    target_trace=0.0,
    cap: int | None = None,
    host_axis: str = "host",
    chip_axis: str = "chip",
    backend: str = "auto",
    precision: str = "highest",
    expect_ids: np.ndarray | None = None,
):
    """One distributed SP2 purification step over the TWO-LEVEL exchange
    (the flagship workload, BASELINE.json:9, on the ICI/DCN hierarchy of
    SURVEY.md section 6.8; VERDICT r3 item 3): X@X ships union shares
    once per destination host over DCN and rebroadcasts intra-host over
    ICI, then the lax.cond-free polynomial blend, fully-local
    truncation, and repack.

    `plan` may be a `FrozenRoute2Plan` (from `freeze_route2_plan(x, x,
    plan)`) for numeric-only stages.  `expect_ids` ([P, cap_local])
    self-checks the iterate structure the plan was built for (stats
    `plan_mismatch` — loud, never silent).  Returns (X_next distributed
    flat [P, ...], stats dict with per-level traffic)."""
    from hierarchical_block_sparse_lib.ops.norms import trace as _trace
    from hierarchical_block_sparse_lib.ops.truncate import truncate

    frozen = None
    if isinstance(plan, FrozenRoute2Plan):
        frozen = plan
        plan = frozen.route
    H, C_ = plan.n_hosts, plan.n_chips
    assert mesh.shape[host_axis] == H and mesh.shape[chip_axis] == C_
    out_cap = plan.out_cap
    x_cap = out_cap if cap is None else cap
    n_stages = len(plan.stages)
    sp2 = P(host_axis, chip_axis)
    send_dev = [
        jax.device_put(
            np.asarray(s).reshape(H, C_, -1),
            jax.sharding.NamedSharding(mesh, sp2),
        )
        for s in plan.send_idx
    ]
    plans_flat, plan_pos = _flatten_frozen(frozen)
    check_plan = expect_ids is not None
    if check_plan:
        if tuple(expect_ids.shape) != tuple(np.asarray(x.ids).shape):
            raise ValueError(
                f"plan built for iterate ids {expect_ids.shape}, "
                f"got {np.asarray(x.ids).shape}"
            )
        exp_dev = jax.device_put(
            np.asarray(expect_ids, np.int32).reshape(
                H, C_, *expect_ids.shape[1:]
            ),
            jax.sharding.NamedSharding(mesh, sp2),
        )

    def body(x_l, *rest):
        send_l = rest[:n_stages]
        rest = rest[n_stages:]
        if frozen is not None:
            stage_plans = _rebuild_plans(
                rest[: len(plans_flat)], plan_pos, n_stages, C_
            )
            rest = rest[len(plans_flat):]
        else:
            stage_plans = None
        exp_l = rest[0] if check_plan else None
        x_loc = dataclasses.replace(
            x_l, ids=x_l.ids[0, 0], data=x_l.data[0, 0], nnz=x_l.nnz[0, 0]
        )
        mism = (
            jnp.any(x_loc.ids != exp_l[0, 0])
            if check_plan
            else jnp.zeros((), bool)
        )
        t = jax.lax.psum(
            jax.lax.psum(_trace(x_loc), host_axis), chip_axis
        )
        x2, pairs, ovf, smism = _stages_2level(
            x_loc, x_loc, send_l, plan, out_cap, backend, precision,
            host_axis, chip_axis, stage_plans=stage_plans,
        )
        mism = mism | smism
        # X_next = (2s-1)*X^2 + (2-2s)*X, s = [trace > target] — the
        # same blend as dist.dist_sp2_step / models.sp2_step.
        s = (t > jnp.asarray(target_trace, t.dtype)).astype(x_loc.dtype)
        y = basic.add(x2, x_loc, alpha=2.0 * s - 1.0, beta=2.0 - 2.0 * s)
        y, nnz_kept = truncate(y, tau, cap=x_cap)
        total = jax.lax.psum(jax.lax.psum(pairs, host_axis), chip_axis)
        _pmax = lambda v: (  # noqa: E731
            jax.lax.pmax(
                jax.lax.pmax(v.astype(jnp.int32), host_axis), chip_axis
            )
            > 0
        )
        expand = lambda v: v[None, None]  # noqa: E731
        return (
            jax.tree.map(expand, y),
            expand(t),
            expand(pairs),
            expand(total),
            expand(_pmax(ovf | (nnz_kept > x_cap))),
            expand(_pmax(mism)),
        )

    spec = _mk_spec(x, host_axis, chip_axis)
    extra = (exp_dev,) if check_plan else ()
    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec,)
        + (sp2,) * n_stages
        + tuple(jax.tree.map(lambda _: sp2, sp) for sp in plans_flat)
        + (sp2,) * len(extra),
        out_specs=(spec,) + (sp2,) * 5,
        check_vma=False,
    )
    y2, t, dev_pairs, total, ovf, mism = f(
        _to2(x, H, C_), *send_dev, *plans_flat, *extra
    )
    y = _from2(y2, H, C_)
    stats = dict(
        trace=t.ravel()[0],
        n_block_pairs=total.ravel()[0],
        per_device_pairs=dev_pairs.ravel(),
        overflow=ovf.any(),
        plan_mismatch=mism.any(),
        dcn_blocks=plan.dcn_blocks,
        dcn_blocks_flat=plan.dcn_blocks_flat,
        ici_blocks=plan.ici_blocks,
        blocks_ring=plan.blocks_ring,
        n_stages=n_stages,
    )
    return y, stats


@dataclass(frozen=True)
class Routed2PurifyPlans:
    """Frozen per-step two-level plans for a fixed-structure-sequence
    purification (the SCF regime on the host x chip hierarchy): one
    profiling pass captures every step's route + capacity envelope +
    frozen symbolic structure; subsequent runs do ZERO host planning and
    ZERO on-device symbolic work."""

    step_plans: tuple  # tuple[Route2Plan | FrozenRoute2Plan]
    x_ids: tuple  # tuple[np.ndarray [P, cap_local_i]]
    x_caps: tuple  # tuple[int]

    @property
    def n_steps(self) -> int:
        return len(self.step_plans)


def plan_purify_2level(
    x: BlockMatrix,
    mesh: Mesh,
    n_steps: int,
    tau,
    target_trace=0.0,
    cap: int | None = None,
    host_axis: str = "host",
    chip_axis: str = "chip",
    backend: str = "auto",
    precision: str = "highest",
    bucket: bool = True,
    freeze: bool = True,
) -> Routed2PurifyPlans:
    """Profiling pass: run the two-level routed purification once
    (replanning per step), recording each step's (bucketed, frozen)
    plan and the iterate structure it was built for — the two-level
    analogue of `route.plan_purify_routed` (VERDICT r3 item 3)."""
    H = mesh.shape[host_axis]
    C_ = mesh.shape[chip_axis]
    step_plans, x_ids, x_caps = [], [], []
    for _ in range(n_steps):
        plan = plan_route_2level(x, x, H, C_)
        if bucket:
            plan = bucket_plan_2level(plan)
        if freeze:
            plan = freeze_route2_plan(x, x, plan)
        step_plans.append(plan)
        x_ids.append(np.asarray(x.ids))
        x, _ = dist_sp2_step_2level(
            x, mesh, plan, tau, target_trace=target_trace, cap=cap,
            host_axis=host_axis, chip_axis=chip_axis, backend=backend,
            precision=precision,
        )
        x_caps.append(int(x.ids.shape[1]))
    return Routed2PurifyPlans(
        step_plans=tuple(step_plans),
        x_ids=tuple(x_ids),
        x_caps=tuple(x_caps),
    )


def dist_purify_2level(
    x: BlockMatrix,
    mesh: Mesh,
    n_steps: int,
    tau,
    target_trace=0.0,
    cap: int | None = None,
    host_axis: str = "host",
    chip_axis: str = "chip",
    backend: str = "auto",
    precision: str = "highest",
    bucket: bool = True,
    plans: Routed2PurifyPlans | None = None,
):
    """`n_steps` distributed SP2 iterations on the two-level exchange,
    replanning per step — or, with `plans` from `plan_purify_2level`,
    zero host planning + numeric-only stages with the per-step
    on-device id self-check.  Returns (X_final distributed, list of
    per-step stats dicts with per-level traffic evidence)."""
    H = mesh.shape[host_axis]
    C_ = mesh.shape[chip_axis]
    stats = []
    if plans is not None:
        if plans.n_steps < n_steps:
            raise ValueError(
                f"plans cover {plans.n_steps} steps, need {n_steps}"
            )
        for i in range(n_steps):
            x, st = dist_sp2_step_2level(
                x, mesh, plans.step_plans[i], tau,
                target_trace=target_trace, cap=plans.x_caps[i],
                host_axis=host_axis, chip_axis=chip_axis,
                backend=backend, precision=precision,
                expect_ids=plans.x_ids[i],
            )
            stats.append(st)
        return x, stats
    for _ in range(n_steps):
        plan = plan_route_2level(x, x, H, C_)
        if bucket:
            plan = bucket_plan_2level(plan)
        x, st = dist_sp2_step_2level(
            x, mesh, plan, tau, target_trace=target_trace, cap=cap,
            host_axis=host_axis, chip_axis=chip_axis, backend=backend,
            precision=precision,
        )
        stats.append(st)
    return x, stats
