"""Sparsity-aware distributed block routing (parallel.route) on the
virtual 8-device mesh: correctness vs the dense oracle and the
single-device product, plus the traffic/balance evidence mandated by
BASELINE.json:5 (VERDICT r1 item 1)."""

import numpy as np
import pytest

import jax

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.parallel import dist, route
from hierarchical_block_sparse_lib.utils import generators as gen


def _b5_style_matrix(n, b, seed=0, extra_random=24):
    """Banded + sprinkled-random mix at block granularity — the B5
    structure (BASELINE.json:11) scaled to CI size."""
    rng = np.random.default_rng(seed)
    r, c, v = gen.banded_coo(n, 2 * b, seed=seed)
    d = gen.dense_oracle(r, c, v, n)
    nb = n // b
    for _ in range(extra_random):
        i, j = rng.integers(0, nb, 2)
        d[i * b:(i + 1) * b, j * b:(j + 1) * b] = rng.standard_normal(
            (b, b)
        ).astype(np.float32) * 0.1
    return d, hbsm.from_dense(d, block_size=b)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return dist.make_mesh(8)


def test_routed_spgemm_matches_oracle(mesh8):
    n, b = 1024, 16
    d, A = _b5_style_matrix(n, b, seed=3)
    Ad = dist.distribute(A, mesh8)
    plan = route.plan_route(Ad, Ad, 8)
    C, stats = route.dist_spgemm_routed(
        Ad, Ad, mesh8, plan, backend="xla"
    )
    got = np.asarray(hbsm.to_dense(dist.undistribute(C)))
    ref = d @ d
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=5e-3)
    assert not bool(stats["overflow"])
    # Counter parity with the single-device planner.
    from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm

    n_pairs, _ = plan_spgemm(A, A)
    assert int(stats["n_block_pairs"]) == n_pairs
    assert plan.total_pairs == n_pairs
    # Balance evidence: per-device pair counts sum to the total.
    assert int(np.asarray(stats["per_device_pairs"]).sum()) == n_pairs


def test_routed_traffic_much_less_than_ring(mesh8):
    """Banded structure: routed traffic must be a small fraction of the
    dense ring's (P-1)*nnz(B), and far ring stages must be dropped."""
    n, b = 1024, 16
    r, c, v = gen.banded_coo(n, 2 * b, seed=5)
    A = hbsm.from_coo(r, c, v, n, block_size=b)
    Ad = dist.distribute(A, dist.make_mesh(8))
    plan = route.plan_route(Ad, Ad, 8)
    # A band of ~3 block-rows over 8 slabs of 8 block-rows: only
    # neighbouring slabs exchange anything.
    assert len(plan.stages) < 8, plan.stages
    assert plan.blocks_routed < 0.5 * plan.blocks_ring, plan.summary()
    # Per-stage caps are tight per stage (not the global worst case).
    assert len(set(plan.stage_pair_caps)) >= 1
    assert max(plan.per_device_pairs) > 0


def test_routed_equals_dense_ring(mesh8):
    """Routed and whole-shard-ring products agree exactly in structure
    and to fp tolerance in values."""
    n, b = 512, 16
    d, A = _b5_style_matrix(n, b, seed=7, extra_random=12)
    Ad = dist.distribute(A, mesh8)
    plan = route.plan_route(Ad, Ad, 8)
    C_r, _ = route.dist_spgemm_routed(Ad, Ad, mesh8, plan, backend="xla")
    from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm

    pc, oc = plan_spgemm(A, A)
    C_ring, _, ovf = dist.dist_spgemm(
        Ad, Ad, mesh8, pair_cap=pc, out_cap=oc, stage_out_cap=oc,
        backend="xla",
    )
    assert not bool(ovf)
    g1 = np.asarray(hbsm.to_dense(dist.undistribute(C_r)))
    g2 = np.asarray(hbsm.to_dense(dist.undistribute(C_ring)))
    np.testing.assert_allclose(g1, g2, rtol=1e-5, atol=1e-5)


def test_plan_reuse_fixed_structure(mesh8):
    """Same structure, new values: the plan is reusable (purification
    regime) — results stay correct without replanning."""
    n, b = 512, 16
    d, A = _b5_style_matrix(n, b, seed=9, extra_random=8)
    Ad = dist.distribute(A, mesh8)
    plan = route.plan_route(Ad, Ad, 8)
    # Perturb values only (structure fixed).
    import dataclasses

    Ad2 = dataclasses.replace(Ad, data=Ad.data * 1.5)
    C, stats = route.dist_spgemm_routed(Ad2, Ad2, mesh8, plan, backend="xla")
    got = np.asarray(hbsm.to_dense(dist.undistribute(C)))
    np.testing.assert_allclose(
        got, (1.5 * d) @ (1.5 * d), rtol=2e-4, atol=5e-3
    )
    assert not bool(stats["overflow"])


def test_routed_purification_matches_single_device(mesh8):
    """dist_purify_routed (per-step replanned routed exchange) must
    reproduce the single-device purify trajectory exactly-ish, report
    traffic evidence per step, and never overflow."""
    from hierarchical_block_sparse_lib.models.purification import (
        profile_purify, purify_scan,
    )

    n, b = 512, 16
    nocc = n // 4
    d, A = _b5_style_matrix(n, b, seed=11)
    # Symmetrize + spectrum into [0,1]-ish: a purifiable iterate.
    ds = (d + d.T).astype(np.float32) / 2
    ds = ds / max(1.0, 2 * np.abs(ds).sum(1).max())
    x0 = (np.eye(n, dtype=np.float32) * 0.55 - ds)
    X = hbsm.from_dense(x0, block_size=b)
    n_steps, tau = 4, 1e-7

    prof = profile_purify(X, n_steps, tau=tau, target_trace=nocc)
    Xs, _ = purify_scan(X, n_steps, tau=tau, target_trace=nocc,
                        **prof.kwargs())
    ref = np.asarray(hbsm.to_dense(Xs))

    Xd = dist.distribute(X, mesh8)
    Yd, stats = route.dist_purify_routed(
        Xd, mesh8, n_steps, tau, target_trace=nocc, backend="xla",
    )
    got = np.asarray(hbsm.to_dense(dist.undistribute(Yd)))
    assert len(stats) == n_steps
    for st in stats:
        assert not bool(st["overflow"])
        assert st["blocks_routed"] <= st["blocks_ring"]
        assert st["n_stages"] + st["n_stages_skipped"] == 8
    # Banded-ish structure: the router must beat the dense ring's
    # traffic by a wide margin on at least the early sparse steps.
    assert stats[0]["blocks_routed"] < 0.6 * stats[0]["blocks_ring"]
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(got - ref).max() / scale < 1e-4


def test_routed_stage_row_caps_rows_backend(mesh8):
    """The plan still carries exact per-stage (max_b_row, max_c_row)
    (deprecated, steering nothing), and the routed stages produce the
    same result through the segment kernel."""
    n, b = 512, 16
    d, A = _b5_style_matrix(n, b, seed=13, extra_random=8)
    Ad = dist.distribute(A, mesh8)
    plan = route.plan_route(Ad, Ad, 8)
    assert len(plan.stage_row_caps) == len(plan.stages)
    assert all(br >= 1 and cr >= 1 for br, cr in plan.stage_row_caps)
    C, stats = route.dist_spgemm_routed(
        Ad, Ad, mesh8, plan, backend="segment"
    )
    assert not bool(stats["overflow"])
    got = np.asarray(hbsm.to_dense(dist.undistribute(C)))
    np.testing.assert_allclose(got, d @ d, rtol=2e-4, atol=5e-3)
    # Bucketing rounds row caps too (compile-reuse discipline).
    bp = route.bucket_plan(plan)
    for (br, cr), (bbr, bcr) in zip(plan.stage_row_caps,
                                    bp.stage_row_caps):
        assert bbr >= br and bcr >= cr
        assert bbr & (bbr - 1) == 0 and bcr & (bcr - 1) == 0


def test_planned_routed_purification(mesh8, monkeypatch):
    """plan_purify_routed freezes per-step route plans; the planned run
    does ZERO host replans, matches the unplanned run bit-exactly, and
    a stale plan is loud (VERDICT r2 item 5)."""
    n, b = 512, 16
    nocc = n // 4
    d, A = _b5_style_matrix(n, b, seed=11)
    ds = (d + d.T).astype(np.float32) / 2
    ds = ds / max(1.0, 2 * np.abs(ds).sum(1).max())
    x0 = (np.eye(n, dtype=np.float32) * 0.55 - ds)
    X = hbsm.from_dense(x0, block_size=b)
    n_steps, tau = 2, 1e-7
    Xd = dist.distribute(X, dist.make_mesh(8))

    plans = route.plan_purify_routed(
        Xd, mesh8, n_steps, tau, target_trace=nocc, backend="xla"
    )
    Yu, _ = route.dist_purify_routed(
        Xd, mesh8, n_steps, tau, target_trace=nocc, backend="xla"
    )

    # Planned run: forbid host replanning entirely.
    def _no_replan(*a, **k):  # pragma: no cover - should never run
        raise AssertionError("plan_route called during planned run")

    monkeypatch.setattr(route, "plan_route", _no_replan)
    Yp, stats = route.dist_purify_routed(
        Xd, mesh8, n_steps, tau, target_trace=nocc, backend="xla",
        plans=plans,
    )
    monkeypatch.undo()
    for st in stats:
        assert not bool(st["plan_mismatch"])
        assert not bool(st["overflow"])
    np.testing.assert_array_equal(
        np.asarray(Yp.data), np.asarray(Yu.data)
    )
    np.testing.assert_array_equal(np.asarray(Yp.ids), np.asarray(Yu.ids))

    # Stale plan (different structure, same shapes): loud.
    d2, A2 = _b5_style_matrix(n, b, seed=29, extra_random=40)
    ds2 = (d2 + d2.T).astype(np.float32) / 2
    ds2 = ds2 / max(1.0, 2 * np.abs(ds2).sum(1).max())
    X2 = hbsm.from_dense(
        np.eye(n, dtype=np.float32) * 0.55 - ds2, block_size=b
    )
    X2d = dist.distribute(X2, mesh8)
    if np.asarray(X2d.ids).shape == np.asarray(Xd.ids).shape:
        _, st = route.dist_sp2_step_routed(
            X2d, mesh8, plans.step_plans[0], tau, target_trace=nocc,
            cap=plans.x_caps[0], backend="xla",
            expect_ids=plans.x_ids[0],
        )
        assert bool(st["plan_mismatch"])
    else:
        import pytest as _pytest

        with _pytest.raises(ValueError):
            route.dist_sp2_step_routed(
                X2d, mesh8, plans.step_plans[0], tau, target_trace=nocc,
                cap=plans.x_caps[0], backend="xla",
                expect_ids=plans.x_ids[0],
            )


def test_frozen_route_plan_numeric_only(mesh8):
    """freeze_route_plan: the frozen routed SpGEMM matches the unfrozen
    run bit-exactly, and a stale freeze (different structure, same
    shapes) is loud through the plan_mismatch flag."""
    n, b = 512, 16
    d, A = _b5_style_matrix(n, b, seed=17, extra_random=10)
    Ad = dist.distribute(A, mesh8)
    plan = route.plan_route(Ad, Ad, 8)
    frozen = route.freeze_route_plan(Ad, Ad, plan)
    C0, s0 = route.dist_spgemm_routed(Ad, Ad, mesh8, plan, backend="xla")
    C1, s1 = route.dist_spgemm_routed(
        Ad, Ad, mesh8, frozen, backend="xla"
    )
    assert not bool(s1["overflow"])
    assert int(s1["n_block_pairs"]) == int(s0["n_block_pairs"])
    np.testing.assert_array_equal(np.asarray(C1.ids), np.asarray(C0.ids))
    np.testing.assert_array_equal(
        np.asarray(C1.data), np.asarray(C0.data)
    )

    # Stale: same capacities, different structure -> loud via the
    # dedicated plan_mismatch stat (never silent).
    d2, A2 = _b5_style_matrix(n, b, seed=23, extra_random=10)
    A2d = dist.distribute(A2, mesh8)
    if np.asarray(A2d.ids).shape == np.asarray(Ad.ids).shape and not (
        np.asarray(A2d.ids) == np.asarray(Ad.ids)
    ).all():
        plan2 = route.plan_route(A2d, A2d, 8)
        same_caps = (
            plan2.stages == plan.stages
            and plan2.stage_pair_caps == plan.stage_pair_caps
            and plan2.out_cap == plan.out_cap
            and all(
                p2.shape == p1.shape
                for p2, p1 in zip(plan2.send_idx, plan.send_idx)
            )
        )
        if same_caps:
            _, s_bad = route.dist_spgemm_routed(
                A2d, A2d, mesh8,
                route.FrozenRoutePlan(
                    route=plan2, stage_plans=frozen.stage_plans
                ),
                backend="xla",
            )
            assert bool(s_bad["plan_mismatch"])


def test_frozen_routed_sp2_step(mesh8):
    """dist_sp2_step_routed with a FrozenRoutePlan (numeric-only stages,
    VERDICT r3 item 2) matches the unfrozen routed step bit-exactly."""
    n, b = 512, 16
    nocc = n // 4
    d, A = _b5_style_matrix(n, b, seed=11)
    ds = (d + d.T).astype(np.float32) / 2
    ds = ds / max(1.0, 2 * np.abs(ds).sum(1).max())
    X = hbsm.from_dense(
        np.eye(n, dtype=np.float32) * 0.55 - ds, block_size=b
    )
    Xd = dist.distribute(X, mesh8)
    plan = route.plan_route(Xd, Xd, 8)
    frozen = route.freeze_route_plan(Xd, Xd, plan)
    tau = 1e-7
    Y0, s0 = route.dist_sp2_step_routed(
        Xd, mesh8, plan, tau, target_trace=nocc, backend="xla"
    )
    Y1, s1 = route.dist_sp2_step_routed(
        Xd, mesh8, frozen, tau, target_trace=nocc, backend="xla",
        expect_ids=np.asarray(Xd.ids),
    )
    assert not bool(s1["overflow"]) and not bool(s1["plan_mismatch"])
    assert int(s1["n_block_pairs"]) == int(s0["n_block_pairs"])
    np.testing.assert_array_equal(np.asarray(Y1.ids), np.asarray(Y0.ids))
    np.testing.assert_array_equal(np.asarray(Y1.data), np.asarray(Y0.data))


def test_frozen_aligned_route_plan(mesh8):
    """The ALIGNED frozen regime (VERDICT r4 item 4): every stage's
    out_ids is the final union and the accumulate happens in the numeric
    phase's epilogue; the result must match the unfrozen routed run (same
    support; values to f32 accumulation-order tolerance)."""
    n, b = 512, 16
    d, A = _b5_style_matrix(n, b, seed=17, extra_random=10)
    Ad = dist.distribute(A, mesh8)
    plan = route.plan_route(Ad, Ad, 8)
    assert len(plan.stages) >= 2
    frozen = route.freeze_route_plan(Ad, Ad, plan, aligned=True)
    assert frozen.aligned
    C0, s0 = route.dist_spgemm_routed(Ad, Ad, mesh8, plan, backend="xla")
    C1, s1 = route.dist_spgemm_routed(Ad, Ad, mesh8, frozen)
    assert not bool(s1["overflow"])
    assert not bool(s1["plan_mismatch"])
    assert int(s1["n_block_pairs"]) == int(s0["n_block_pairs"])
    # Aligned C carries the final-union structure on every device; the
    # unfrozen C carries per-device product unions — same VALID ids.
    ids0 = np.asarray(C0.ids)
    ids1 = np.asarray(C1.ids)
    dat0 = np.asarray(C0.data)
    dat1 = np.asarray(C1.data)
    SENT = np.iinfo(np.int32).max
    for dev in range(ids0.shape[0]):
        v0 = ids0[dev] != SENT
        v1 = ids1[dev] != SENT
        np.testing.assert_array_equal(ids0[dev][v0], ids1[dev][v1])
        np.testing.assert_allclose(
            dat0[dev][v0], dat1[dev][v1], rtol=2e-4, atol=1e-5
        )


def test_frozen_aligned_sp2_step(mesh8):
    """dist_sp2_step_routed on an ALIGNED frozen plan (the path real
    multi-stage purification auto-takes): matches the unfrozen
    routed step to accumulation-order tolerance, same support."""
    n, b = 512, 16
    nocc = n // 4
    d, A = _b5_style_matrix(n, b, seed=11)
    ds = (d + d.T).astype(np.float32) / 2
    ds = ds / max(1.0, 2 * np.abs(ds).sum(1).max())
    X = hbsm.from_dense(
        np.eye(n, dtype=np.float32) * 0.55 - ds, block_size=b
    )
    Xd = dist.distribute(X, mesh8)
    plan = route.plan_route(Xd, Xd, 8)
    assert len(plan.stages) >= 2
    frozen = route.freeze_route_plan(Xd, Xd, plan, aligned=True)
    assert frozen.aligned
    tau = 1e-7
    Y0, s0 = route.dist_sp2_step_routed(
        Xd, mesh8, plan, tau, target_trace=nocc, backend="xla"
    )
    Y1, s1 = route.dist_sp2_step_routed(
        Xd, mesh8, frozen, tau, target_trace=nocc,
        expect_ids=np.asarray(Xd.ids),
    )
    assert not bool(s1["overflow"]) and not bool(s1["plan_mismatch"])
    assert int(s1["n_block_pairs"]) == int(s0["n_block_pairs"])
    # Truncation compacts both to the kept support: ids must agree
    # exactly; data to f32 accumulation-order tolerance.
    np.testing.assert_array_equal(np.asarray(Y1.ids), np.asarray(Y0.ids))
    np.testing.assert_allclose(
        np.asarray(Y1.data), np.asarray(Y0.data), rtol=2e-4, atol=1e-6
    )
