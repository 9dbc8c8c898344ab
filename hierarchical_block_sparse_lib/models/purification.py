"""Density-matrix-purification-style iteration: the flagship workload.

Reference parity: the truncation pipeline of BASELINE.json:9 ("repeated
C = A*A with norm-based block dropping — matrix-polynomial /
purification-style iteration"; SURVEY.md section 4.3).  This is the
reason norm-based truncation is a first-class primitive: each step
squares the matrix (SpGEMM), applies a polynomial update (add/scale),
truncates near-zero blocks to restore sparsity, and tracks exact
block-multiply counters.

Static-shape structure: the whole step is one jitted function at fixed
capacities (truncation keeps nnz bounded, so a static footprint works),
suitable for `lax.scan`/host loops and for `shard_map` distribution.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib.ops import basic, repack as repack_mod
from hierarchical_block_sparse_lib.ops.norms import trace, frob_squared
from hierarchical_block_sparse_lib.ops.spgemm import (
    MultiplyInfo,
    SymbolicPlan,
    make_plan,
    spgemm,
)
from hierarchical_block_sparse_lib.ops.truncate import truncate


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PurificationStats:
    trace: jax.Array
    nnz_blocks: jax.Array
    n_block_pairs: jax.Array
    pair_overflow: jax.Array
    out_overflow: jax.Array
    # True if the truncated iterate still exceeded the step's capacity and
    # trailing blocks were dropped (raise `cap` or loosen tau).
    repack_overflow: jax.Array
    # Distinct blocks in the pre-truncation step result (the union of the
    # X@X product support with X's own support): the step's exact
    # `out_cap` requirement — what `profile_purify` harvests.
    nnz_union: jax.Array
    # True if a precomputed per-step plan (`plan_purify`) was used but the
    # iterate's id structure diverged from the planned trajectory — the
    # step's output is then WRONG (stale plan); always False unplanned.
    plan_mismatch: jax.Array


@partial(
    jax.jit,
    static_argnames=(
        "pair_cap", "out_cap", "backend", "cap", "row_caps", "symmetric",
    ),
)
def sp2_step(
    x: BlockMatrix,
    tau: float | jax.Array,
    pair_cap: int,
    out_cap: int,
    target_trace: float | jax.Array = 0.0,
    backend: str = "auto",
    cap: int | None = None,
    row_caps: tuple | None = None,
    symmetric: bool = False,
    plan: SymbolicPlan | None = None,
):
    """One SP2 (trace-correcting purification) step with truncation.

    x2 = X @ X;  X <- x2            if trace(X) > target
                 X <- 2X - x2       otherwise
    then drop blocks with frob norm <= tau and repack to `cap`
    (default: cap(x); the iterate densifies before it re-sparsifies, so
    size `cap` for the union support — overflow is reported in stats).

    With `symmetric=True` (the physical case: X is a polynomial of a
    symmetric Hamiltonian) the square is computed as the symmetric
    product X @ X^T with upper-triangle-only enumeration and mirroring
    (`syrk` semantics): ~half the leaf GEMMs per step — the reference
    lineage's symmetric-matrix optimization.  It pays only when the
    per-step GEMM time dominates two extra cap-sized compaction passes
    (near-dense iterates, not the ~750-pair B3 steps).  The iterate is
    re-symmetrized in structure after truncation (upper mirrored), so
    exact block-level symmetry is an invariant, not an assumption.
    `n_block_pairs` then counts the GEMMs actually performed.

    Returns (X_next, PurificationStats).  The polynomial branch is a
    `lax.cond`-free linear blend (both branches share the same sparsity
    union), keeping the step a single static-shape program.
    """
    cap = x.cap if cap is None else cap
    t = trace(x)
    take_square = t > jnp.asarray(target_trace, t.dtype)
    # X_next = s*x2 + (1-s)*(2x - x2) = (2s-1)*x2 + (2-2s)*x  with s in
    # {0,1} — computed by spgemm's FUSED beta-accumulate (C = alpha*X@X
    # + beta*X): one structural pass instead of multiply-then-add (the
    # separate union-add was the single most expensive op of the step).
    s = take_square.astype(x.dtype)
    alpha, beta = 2.0 * s - 1.0, 2.0 - 2.0 * s
    if symmetric and plan is not None:
        # Planned-symmetric path (VERDICT r2 item 6): the GENERIC union
        # plan (make_plan(sym_mirror=True)) + syrk_upper=True computes
        # only the upper-triangle GEMMs (zero-filled
        # lower product slots + beta*X there), then the precomputed
        # mirror map overwrites every strictly-lower slot with its
        # transposed upper partner — half the GEMMs at ZERO per-step
        # structural work, unlike the unplanned symmetric path below
        # (triu compaction + symbolic + symmetrize sort per step).
        if plan.mirror_src is None:
            raise ValueError(
                "sp2_step(symmetric=True, plan=...) needs a plan built "
                "with make_plan(..., sym_mirror=True)"
            )
        y, info = spgemm(
            x, x, pair_cap=pair_cap, out_cap=out_cap, backend=backend,
            row_caps=row_caps, accum=x, alpha=alpha, beta=beta,
            plan=plan, syrk_upper=True,
        )
        nb = y.nb_cols
        yv = y.valid_mask()
        lower = yv & (y.ids // nb > y.ids % nb)
        diag = yv & (y.ids // nb == y.ids % nb)
        mirrored = jnp.swapaxes(y.data[plan.mirror_src], -1, -2)
        data = jnp.where(lower[:, None, None], mirrored, y.data)
        # Diagonal blocks of an upper-only syrk are symmetric only to
        # rounding: average with the transpose for exact elementwise
        # symmetry (same contract as basic.symmetrize_upper).
        data = jnp.where(
            diag[:, None, None],
            0.5 * (data + jnp.swapaxes(data, -1, -2)),
            data,
        )
        y = dataclasses.replace(y, data=data)
        y, nnz_kept = truncate(y, tau, cap=cap)
        info = dataclasses.replace(
            info,
            n_block_pairs=plan.total_syrk,
            plan_mismatch=info.plan_mismatch | ~plan.mirror_ok,
        )
    elif symmetric:
        # X symmetric => X^T == X: feed X itself as the transposed
        # operand (no transpose pass), enumerate upper pairs only,
        # accumulate beta*upper(X), and mirror once after truncation.
        # Truncating the upper triangle and mirroring IS symmetric
        # truncation: ||Y_ij|| == ||Y_ji|| for a symmetric iterate.
        yu, info = spgemm(
            x, x, pair_cap=pair_cap, out_cap=out_cap, backend=backend,
            row_caps=row_caps, syrk_upper=True,
            accum=basic.triu(x), alpha=alpha, beta=beta,
        )
        yu = truncate(yu, tau)
        # Exact structural symmetry invariant: the lower triangle is
        # rebuilt from the upper, so the next upper-only step is exact.
        y, sym_ovf = basic.symmetrize_upper(yu, cap)
        info = dataclasses.replace(
            info, out_overflow=info.out_overflow | sym_ovf
        )
        nnz_kept = jnp.where(sym_ovf, jnp.int32(cap + 1), y.nnz)
    else:
        y, info = spgemm(
            x, x, pair_cap=pair_cap, out_cap=out_cap, backend=backend,
            row_caps=row_caps, accum=x, alpha=alpha, beta=beta, plan=plan,
        )
        # Fused truncate+repack: one compaction pass straight from the
        # union-support out_cap into the iterate cap (kept > cap is the
        # repack-overflow signal the separate repack used to leave to
        # nnz bookkeeping).
        y, nnz_kept = truncate(y, tau, cap=cap)
    stats = PurificationStats(
        trace=t,
        nnz_blocks=y.nnz,
        n_block_pairs=info.n_block_pairs,
        pair_overflow=info.pair_overflow,
        out_overflow=info.out_overflow | info.row_overflow,
        repack_overflow=nnz_kept > cap,
        nnz_union=info.n_out_blocks,
        # spgemm self-checks the supplied plan against the operands'
        # (and accumulator's) actual id structure — a stale plan is
        # reported here even for direct sp2_step(plan=) callers.
        plan_mismatch=info.plan_mismatch,
    )
    return y, stats


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PurifyPlans:
    """Per-step symbolic+union plans for a FIXED purification trajectory
    (every `SymbolicPlan` field stacked over a leading [n_steps] axis)
    plus the expected per-step input ids.  Built by `plan_purify`; feed
    to ``purify_scan(..., plans=...)`` — the scan then runs ZERO
    structural work per step (no symbolic sorts, no union merge), only
    the numeric GEMM phase, scatters, trace, and truncation.

    Valid while the trajectory's id structure is unchanged (data drift
    that does not change which blocks survive truncation is fine — the
    SCF regime).  A divergence is caught per step by comparing the
    iterate's ids against `expected_ids` and reported in
    `PurificationStats.plan_mismatch` — never silent."""

    plans: SymbolicPlan  # stacked: each field [n_steps, ...]
    expected_ids: jax.Array  # int32[n_steps, cap]

    @property
    def n_steps(self) -> int:
        return self.expected_ids.shape[0]


def plan_purify(
    x: BlockMatrix,
    n_steps: int,
    tau: float,
    prof: CapacityProfile,
    target_trace: float | jax.Array = 0.0,
    backend: str = "auto",
    symmetric: bool = False,
) -> PurifyPlans:
    """Walk the SP2 trajectory once eagerly at `prof`'s capacities
    (bit-identical to the scan: same caps, same program) and capture
    each step's symbolic+union plan.  One-time setup cost — the SCF /
    fixed-structure regime amortizes it over many `purify_scan` runs.

    Reference parity: the reference's recursion re-discovers the product
    structure every multiply; here the structure of the whole iteration
    is precomputed host/device-side and the iteration itself is pure
    numeric work (SURVEY.md section 8.2 "hot loop = the batched GEMM")."""
    from hierarchical_block_sparse_lib.ops import repack as repack_mod

    cap = prof.cap
    xi = repack_mod.repack(x, cap)
    plans, exp = [], []
    for k in range(n_steps):
        exp.append(xi.ids)
        plans.append(
            make_plan(
                xi, xi, prof.pair_cap, accum_ids=xi.ids,
                out_cap=prof.out_cap, sym_mirror=symmetric,
            )
        )
        xi, s = sp2_step(
            xi,
            tau,
            pair_cap=prof.pair_cap,
            out_cap=prof.out_cap,
            target_trace=target_trace,
            backend=backend,
            cap=cap,
            row_caps=prof.row_caps,
            plan=plans[-1],
            symmetric=symmetric,
        )
        if bool(s.pair_overflow | s.out_overflow | s.repack_overflow):
            raise RuntimeError(
                f"plan_purify: overflow at step {k} — the capacity "
                "profile does not cover this input (rebuild with "
                "profile_purify)"
            )
    stacked = jax.tree.map(lambda *v: jnp.stack(v), *plans)
    return PurifyPlans(plans=stacked, expected_ids=jnp.stack(exp))


@partial(
    jax.jit,
    static_argnames=(
        "n_steps", "pair_cap", "out_cap", "backend", "cap", "row_caps",
        "symmetric", "unroll",
    ),
)
def purify_scan(
    x: BlockMatrix,
    n_steps: int,
    tau: float | jax.Array,
    pair_cap: int,
    out_cap: int,
    target_trace: float | jax.Array = 0.0,
    backend: str = "auto",
    cap: int | None = None,
    row_caps: tuple | None = None,
    symmetric: bool = False,
    plans: PurifyPlans | None = None,
    unroll: int = 1,
):
    """`n_steps` SP2 iterations as ONE compiled program (`lax.scan`) —
    the whole purification pipeline stays on-device with zero host
    round-trips.  Returns (X_final, PurificationStats stacked [n_steps]).

    With `plans` (from `plan_purify`, same capacities), each step reuses
    its precomputed symbolic+union structure: the per-step cost drops to
    the numeric phase only.  Structure divergence from the planned
    trajectory is reported in `stats.plan_mismatch` per step.

    `unroll` is passed to `lax.scan`."""
    import dataclasses

    from hierarchical_block_sparse_lib.ops import repack as repack_mod

    cap = out_cap if cap is None else cap
    # The initial repack can itself drop input blocks (support(X) is not
    # necessarily a subset of the X@X output support) — fold that into the
    # first step's repack_overflow so it is never silent (ADVICE.md r1).
    init_ovf = x.nnz > cap
    x = repack_mod.repack(x, cap)
    if plans is not None and plans.expected_ids.shape != (n_steps, cap):
        raise ValueError(
            f"plans built for (n_steps, cap)="
            f"{plans.expected_ids.shape}, got ({n_steps}, {cap})"
        )

    def step(x, xs):
        # Staleness is self-checked inside spgemm (the plan records the
        # operand/accumulator ids it was built for) and lands in
        # stats.plan_mismatch via sp2_step — no separate compare needed.
        y, s = sp2_step(
            x,
            tau,
            pair_cap=pair_cap,
            out_cap=out_cap,
            target_trace=target_trace,
            backend=backend,
            cap=cap,
            row_caps=row_caps,
            symmetric=symmetric,
            plan=None if xs is None else xs,
        )
        return y, s

    xs = None if plans is None else plans.plans
    xf, stats = jax.lax.scan(step, x, xs, length=n_steps, unroll=unroll)
    stats = dataclasses.replace(
        stats,
        repack_overflow=stats.repack_overflow.at[0].set(
            stats.repack_overflow[0] | init_ovf
        ),
    )
    return xf, stats


def purify(
    x: BlockMatrix,
    n_steps: int,
    tau: float,
    pair_cap: int,
    out_cap: int,
    target_trace: float = 0.0,
    backend: str = "auto",
    cap: int | None = None,
    symmetric: bool = False,
):
    """Run `n_steps` SP2 iterations (host loop; each step jitted).

    `cap` is the iterate's storage capacity (default out_cap: the iterate
    densifies toward the union support before truncation re-sparsifies
    it).  Returns (X_final, list[PurificationStats]).
    """
    import dataclasses

    cap = out_cap if cap is None else cap
    init_ovf = x.nnz > cap  # initial repack may drop blocks; see purify_scan
    x = repack_mod.repack(x, cap)
    stats = []
    for _ in range(n_steps):
        x, s = sp2_step(
            x,
            tau,
            pair_cap=pair_cap,
            out_cap=out_cap,
            target_trace=target_trace,
            backend=backend,
            cap=cap,
            symmetric=symmetric,
        )
        stats.append(s)
    if stats:
        stats[0] = dataclasses.replace(
            stats[0], repack_overflow=stats[0].repack_overflow | init_ovf
        )
    return x, stats


class PurifyEngine:
    """SCF-regime purification runner: profile + plan ONCE, reuse the
    planned scan (zero per-step structural work) across cycles, and
    automatically re-profile/re-plan when the iterate's structure drifts
    off the planned trajectory or any capacity overflows.

    The intended production loop (reference lineage: one purification
    per SCF cycle, Hamiltonian support drifting slowly):

        eng = PurifyEngine(n_steps=30, tau=1e-6, target_trace=n_occ)
        for cycle in range(...):
            D, stats = eng.run(F)   # F: this cycle's effective Hamiltonian

    `run` costs one host roundtrip per cycle (the drift/overflow check);
    replans are counted in `eng.n_replans`.  `margin` loosens the
    profiled capacities so small support growth does not force a
    replan-per-cycle.
    """

    def __init__(
        self,
        n_steps: int,
        tau: float,
        target_trace: float = 0.0,
        backend: str = "auto",
        margin: float = 1.25,
        symmetric: bool = False,
    ):
        # symmetric=True uses the PLANNED-symmetric tier (half the
        # GEMMs via syrk_upper + precomputed mirror; sp2_step
        # symmetric+plan).  The capacity profile stays the GENERIC one:
        # the planned path runs on the generic union/pair envelope.
        self.n_steps = n_steps
        self.tau = tau
        self.target_trace = target_trace
        self.backend = backend
        self.margin = margin
        self.symmetric = symmetric
        self.prof: CapacityProfile | None = None
        self.plans: PurifyPlans | None = None
        self.n_replans = 0

    def _replan(self, x: BlockMatrix) -> None:
        self.prof = profile_purify(
            x,
            self.n_steps,
            self.tau,
            target_trace=self.target_trace,
            backend=self.backend,
            margin=self.margin,
        )
        # Pow2-bucket the envelope so nearby structures land on the same
        # compiled scan (margin already loosened the caps).
        self.prof = CapacityProfile(
            pair_cap=_next_pow2(self.prof.pair_cap),
            out_cap=_next_pow2(self.prof.out_cap),
            cap=_next_pow2(self.prof.cap),
            row_caps=tuple(_next_pow2(r) for r in self.prof.row_caps),
            per_step_pairs=self.prof.per_step_pairs,
            per_step_out=self.prof.per_step_out,
            per_step_kept=self.prof.per_step_kept,
        )
        self.plans = plan_purify(
            x,
            self.n_steps,
            self.tau,
            self.prof,
            target_trace=self.target_trace,
            backend=self.backend,
            symmetric=self.symmetric,
        )
        self.n_replans += 1

    @staticmethod
    def _bad(stats: PurificationStats) -> bool:
        import numpy as np

        return bool(
            np.asarray(
                stats.plan_mismatch
                | stats.pair_overflow
                | stats.out_overflow
                | stats.repack_overflow
            ).any()
        )

    def _stale(self, x: BlockMatrix) -> bool:
        """Cheap pre-check (VERDICT r2 weak 6): compare the iterate's id
        structure against the planned trajectory's step-0 input BEFORE
        running, so an initially-drifted structure replans immediately
        instead of burning a whole planned purification to find out.
        Mid-trajectory drift is still caught by the per-step
        plan_mismatch self-check inside the scan."""
        import numpy as np

        if int(x.nnz) > self.prof.cap:
            return True
        got = np.asarray(jax.device_get(x.ids))
        exp = np.asarray(jax.device_get(self.plans.expected_ids[0]))
        got = got[got != SENTINEL]
        exp = exp[exp != SENTINEL]
        return got.shape != exp.shape or bool(np.any(got != exp))

    def run(self, x: BlockMatrix):
        """One purification at the cached plan; replans and reruns when
        the structure drifted.  Returns (X_final, stacked stats)."""
        if self.plans is None or self._stale(x):
            self._replan(x)
        kw = dict(
            target_trace=self.target_trace,
            backend=self.backend,
            plans=self.plans,
            symmetric=self.symmetric,
            **self.prof.kwargs(),
        )
        xf, stats = purify_scan(x, self.n_steps, self.tau, **kw)
        if self._bad(stats):
            self._replan(x)
            kw["plans"] = self.plans
            kw.update(self.prof.kwargs())
            xf, stats = purify_scan(x, self.n_steps, self.tau, **kw)
            if self._bad(stats):  # genuinely infeasible caps -> loud
                raise RuntimeError(
                    "PurifyEngine: overflow/mismatch persists after a "
                    "fresh replan — inspect stats/profile"
                )
        return xf, stats


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclass(frozen=True)
class CapacityProfile:
    """Exact capacity requirements of an SP2 purification run, measured by
    `profile_purify`.  Feed to `purify_scan(x, n, tau, **prof.kwargs())`.

    Structural-op cost scales with CAPACITY, not nnz (sorts,
    searchsorteds, compaction passes are all cap-sized), so replacing
    k*initial-plan guess caps with these tight maxima cuts the
    purification bookkeeping proportionally.  The per-step tuples are the
    evidence trail (and show the densify-then-resparsify hump that makes
    a single-step plan insufficient).
    """

    pair_cap: int
    out_cap: int
    cap: int
    row_caps: tuple  # (max B blocks per row, max C blocks per row)
    per_step_pairs: tuple
    per_step_out: tuple
    per_step_kept: tuple

    def kwargs(self) -> dict:
        """Keyword arguments for `purify_scan` / `sp2_step` / `purify`."""
        return dict(
            pair_cap=self.pair_cap,
            out_cap=self.out_cap,
            cap=self.cap,
            row_caps=self.row_caps,
        )


def profile_purify(
    x: BlockMatrix,
    n_steps: int,
    tau: float,
    target_trace: float = 0.0,
    backend: str = "auto",
    symmetric: bool = False,
    margin: float = 1.0,
) -> CapacityProfile:
    """Dry-run `n_steps` SP2 iterations eagerly, host-planning the EXACT
    per-step capacity requirements, and return the tight maxima.

    The profiled trajectory is bit-identical to the final run:
    capacities only affect whether blocks get dropped, and the profiler's
    caps are exact host plans (pair/row) plus guaranteed upper bounds
    (out = product outputs + nnz, which bounds the beta-accumulate
    union), so no overflow can occur.  Run caps are pow2-bucketed so the
    eager profiling steps share compilations (the same bucket tuple
    compiles once; distinct steps usually land in the same bucket).

    `margin > 1` loosens the returned caps for reuse on nearby
    structures — the SCF regime, where each cycle's Hamiltonian support
    drifts slightly but the capacity envelope is stable.

    Reference parity: the reference (C++/dynamic allocation) sizes
    storage implicitly per step; static-shape XLA needs it explicit, and
    this profiler is the static-shape answer (SURVEY.md section 8.5
    "capacity buckets + masks everywhere; recompile discipline").
    """
    import numpy as np

    from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm_ex

    xi = x
    mbr_m = mcr_m = 1
    pairs_l, out_l, kept_l = [], [], []
    for k in range(n_steps):
        pc, oc, mbr, mcr = plan_spgemm_ex(xi, xi)
        pc, oc = max(pc, 1), max(oc, 1)
        mbr, mcr = max(mbr, 1), max(mcr, 1)
        run_pc = _next_pow2(pc)
        run_oc = _next_pow2(oc + int(xi.nnz))
        run_rc = (_next_pow2(mbr), _next_pow2(mcr))
        xi, s = sp2_step(
            xi,
            tau,
            pair_cap=run_pc,
            out_cap=run_oc,
            target_trace=target_trace,
            backend=backend,
            cap=run_oc,
            row_caps=run_rc,
            symmetric=symmetric,
        )
        if bool(s.pair_overflow | s.out_overflow | s.repack_overflow):
            raise RuntimeError(
                f"profile_purify: overflow at step {k} despite exact "
                f"host plan (pair_cap={run_pc}, out_cap={run_oc}) — "
                "planner/op disagreement, please report"
            )
        pairs_l.append(pc)
        out_l.append(int(s.nnz_union))
        kept_l.append(int(s.nnz_blocks))
        mbr_m, mcr_m = max(mbr_m, mbr), max(mcr_m, mcr)
    grow = lambda v: int(np.ceil(v * margin))  # noqa: E731
    return CapacityProfile(
        pair_cap=grow(max(pairs_l)),
        out_cap=grow(max(out_l)),
        # The iterate capacity must also hold the INPUT (purify_scan's
        # initial repack), not just every truncated iterate.
        cap=grow(max([int(x.nnz)] + kept_l)),
        row_caps=(grow(mbr_m), grow(mcr_m)),
        per_step_pairs=tuple(pairs_l),
        per_step_out=tuple(out_l),
        per_step_kept=tuple(kept_l),
    )
