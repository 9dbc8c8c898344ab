"""Two-level (host x chip) block routing (parallel.route2) on the
virtual 8-device mesh factored 2x4 and 4x2: correctness vs the dense
oracle, DCN-vs-flat traffic invariants, and counter parity
(SURVEY.md section 6.8 ICI/DCN mandate; VERDICT r2 item 3)."""

import numpy as np
import pytest

import jax

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.parallel import dist, route, route2

from tests.test_route import _b5_style_matrix


@pytest.fixture(scope="module", params=[(2, 4), (4, 2)])
def mesh_hc(request):
    h, c = request.param
    assert len(jax.devices()) >= h * c
    return route2.make_mesh_2level(h, c), h, c


def test_2level_spgemm_matches_oracle(mesh_hc):
    mesh, h, c = mesh_hc
    n, b = 1024, 16
    d, A = _b5_style_matrix(n, b, seed=3)
    Ad = dist.distribute(A, dist.make_mesh(h * c))
    plan = route2.plan_route_2level(Ad, Ad, h, c)
    C, stats = route2.dist_spgemm_2level(
        Ad, Ad, mesh, plan, backend="xla"
    )
    got = np.asarray(hbsm.to_dense(dist.undistribute(C)))
    np.testing.assert_allclose(got, d @ d, rtol=2e-4, atol=5e-3)
    assert not bool(stats["overflow"])
    # Counter parity with the single-device planner.
    from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm

    n_pairs, _ = plan_spgemm(A, A)
    assert int(stats["n_block_pairs"]) == n_pairs
    assert plan.total_pairs == n_pairs
    assert int(np.asarray(stats["per_device_pairs"]).sum()) == n_pairs


def test_2level_dcn_never_exceeds_flat(mesh_hc):
    """The union-share transport must ship every block across DCN at
    most once per destination host: dcn_blocks <= the flat plan's
    inter-host copies, strictly less when sibling chips share remote
    panels (the banded B5 mix guarantees sharing)."""
    mesh, h, c = mesh_hc
    n, b = 1024, 16
    d, _ = _b5_style_matrix(n, b, seed=7, extra_random=16)
    # Dense block column 0: every chip needs B block-row 0, so host 0
    # chip 0's row-0 panel is shared by ALL sibling chips remotely.
    d[:, :b] = 0.01
    A = hbsm.from_dense(d, block_size=b)
    Ad = dist.distribute(A, dist.make_mesh(h * c))
    plan = route2.plan_route_2level(Ad, Ad, h, c)
    assert plan.dcn_blocks <= plan.dcn_blocks_flat
    if c > 1:
        assert plan.dcn_blocks < plan.dcn_blocks_flat
    # The flat plan agrees about what crosses hosts.
    fplan = route.plan_route(Ad, Ad, h * c)
    assert plan.dcn_blocks_flat <= fplan.blocks_routed
    # Result capacity must match the flat plan's (same receive sets).
    assert plan.out_cap == fplan.out_cap


def test_2level_alpha_and_out_cap(mesh_hc):
    mesh, h, c = mesh_hc
    n, b = 512, 16
    d, A = _b5_style_matrix(n, b, seed=11)
    Ad = dist.distribute(A, dist.make_mesh(h * c))
    plan = route2.plan_route_2level(Ad, Ad, h, c)
    C, stats = route2.dist_spgemm_2level(
        Ad, Ad, mesh, plan, alpha=-0.5, backend="xla"
    )
    got = np.asarray(hbsm.to_dense(dist.undistribute(C)))
    np.testing.assert_allclose(got, -0.5 * (d @ d), rtol=2e-4, atol=5e-3)
    assert not bool(stats["overflow"])


def _purify_input(n, b, seed=11):
    d, _ = _b5_style_matrix(n, b, seed=seed)
    ds = (d + d.T).astype(np.float32) / 2
    ds = ds / max(1.0, 2 * np.abs(ds).sum(1).max())
    return hbsm.from_dense(
        np.eye(n, dtype=np.float32) * 0.55 - ds, block_size=b
    )


def test_2level_sp2_step_matches_flat(mesh_hc):
    """dist_sp2_step_2level (flagship workload on the ICI/DCN hierarchy,
    VERDICT r3 item 3) must match the flat routed SP2 step bit-exactly
    in structure and to fp tolerance in values, with the DCN <= flat
    invariant in its stats."""
    mesh, h, c = mesh_hc
    n, b = 512, 16
    nocc = n // 4
    X = _purify_input(n, b)
    Xd = dist.distribute(X, dist.make_mesh(h * c))
    tau = 1e-7
    plan2 = route2.plan_route_2level(Xd, Xd, h, c)
    Y2, st2 = route2.dist_sp2_step_2level(
        Xd, mesh, plan2, tau, target_trace=nocc, backend="xla"
    )
    fplan = route.plan_route(Xd, Xd, h * c)
    Yf, stf = route.dist_sp2_step_routed(
        Xd, dist.make_mesh(h * c), fplan, tau, target_trace=nocc,
        backend="xla",
    )
    assert not bool(st2["overflow"])
    assert st2["dcn_blocks"] <= st2["dcn_blocks_flat"]
    assert int(st2["n_block_pairs"]) == int(stf["n_block_pairs"])
    assert abs(float(st2["trace"]) - float(stf["trace"])) < 1e-3
    # Same out_cap (test_2level_dcn_never_exceeds_flat) => comparable
    # arrays; values to fp tolerance (accumulation order differs: the
    # two-level share order is (host-stage, chip), not ring offset).
    np.testing.assert_array_equal(np.asarray(Y2.ids), np.asarray(Yf.ids))
    np.testing.assert_allclose(
        np.asarray(Y2.data), np.asarray(Yf.data), rtol=2e-4, atol=5e-4
    )


def test_2level_frozen_sp2_and_planned_purify(monkeypatch):
    """freeze_route2_plan: the frozen two-level SP2 step matches the
    unfrozen one bit-exactly; plan_purify_2level + dist_purify_2level
    run with ZERO host replanning and loud staleness.

    One mesh factorization only (2x4): this end-to-end test is the
    suite's most expensive (~3 min of XLA:CPU compiles) and the h x c
    split logic is already covered on BOTH factorizations by the
    cheaper test_2level_sp2_step_matches_flat / _spgemm_matches_oracle
    above (VERDICT r3 item 7 — suite runtime)."""
    h, c = 2, 4
    mesh = route2.make_mesh_2level(h, c)
    n, b = 512, 16
    nocc = n // 4
    X = _purify_input(n, b)
    Xd = dist.distribute(X, dist.make_mesh(h * c))
    tau, n_steps = 1e-7, 2

    plan2 = route2.plan_route_2level(Xd, Xd, h, c)
    frozen = route2.freeze_route2_plan(Xd, Xd, plan2)
    Y0, s0 = route2.dist_sp2_step_2level(
        Xd, mesh, plan2, tau, target_trace=nocc, backend="xla"
    )
    Y1, s1 = route2.dist_sp2_step_2level(
        Xd, mesh, frozen, tau, target_trace=nocc, backend="xla",
        expect_ids=np.asarray(Xd.ids),
    )
    assert not bool(s1["overflow"]) and not bool(s1["plan_mismatch"])
    assert int(s1["n_block_pairs"]) == int(s0["n_block_pairs"])
    np.testing.assert_array_equal(np.asarray(Y1.ids), np.asarray(Y0.ids))
    np.testing.assert_array_equal(np.asarray(Y1.data), np.asarray(Y0.data))

    plans = route2.plan_purify_2level(
        Xd, mesh, n_steps, tau, target_trace=nocc, backend="xla"
    )
    Yu, _ = route2.dist_purify_2level(
        Xd, mesh, n_steps, tau, target_trace=nocc, backend="xla"
    )

    def _no_replan(*a, **k):  # pragma: no cover - should never run
        raise AssertionError("plan_route_2level called during planned run")

    monkeypatch.setattr(route2, "plan_route_2level", _no_replan)
    Yp, stats = route2.dist_purify_2level(
        Xd, mesh, n_steps, tau, target_trace=nocc, backend="xla",
        plans=plans,
    )
    monkeypatch.undo()
    for st in stats:
        assert not bool(st["plan_mismatch"])
        assert not bool(st["overflow"])
        assert st["dcn_blocks"] <= st["dcn_blocks_flat"]
    np.testing.assert_array_equal(np.asarray(Yp.ids), np.asarray(Yu.ids))
    np.testing.assert_array_equal(np.asarray(Yp.data), np.asarray(Yu.data))
