"""Inverse-factor / inverse-square-root iterations over block-sparse
matrices.

The reference's research lineage pairs density-matrix purification with
*inverse factorization* of the overlap matrix S (computing Z ~= S^{-1/2}
so the generalized eigenproblem becomes standard; Artemov's localized
inverse-factor refinement — SURVEY.md sections 1 and 9.2).  The
formulation here is the Newton-Schulz iteration expressed entirely in the
framework's primitives (spgemm / add / scale / truncate), with
norm-based truncation keeping the iterates sparse:

    Y_0 = S,  Z_0 = I / theta      (theta ~ ||S||, ensures convergence)
    T_k     = (3 I - Z_k Y_k Z_k) / 2          (computed via 2 SpGEMMs)
    Z_{k+1} = Z_k T_k ;  converges quadratically to S^{-1/2} (times a
    scalar fold), as long as ||I - Z_0^2 S|| < 1.

All steps are jittable at fixed capacities; overflow is reported.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from hierarchical_block_sparse_lib.core.block_matrix import BlockMatrix
from hierarchical_block_sparse_lib.core.assembly import eye
from hierarchical_block_sparse_lib.ops import basic
from dataclasses import dataclass

from hierarchical_block_sparse_lib.ops.spgemm import make_plan, spgemm
from hierarchical_block_sparse_lib.ops.truncate import truncate


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NSPlans:
    """Per-step structural plans for a fixed Newton-Schulz trajectory
    (`plan_inv_sqrt`): the three multiplies' symbolic(+union) plans,
    every field stacked over a leading [n_steps] axis.  Feed to
    ``inv_sqrt_newton_schulz(..., plans=...)``.  Each plan records the
    operand ids it was built for and spgemm self-checks them on use, so
    drift off the planned trajectory (including of the constant S) is
    folded into the returned overflow flag."""

    p_zy: object  # SymbolicPlan, stacked
    p_t: object  # SymbolicPlan with union fields, stacked
    p_z2: object  # SymbolicPlan, stacked


def plan_inv_sqrt(
    s: BlockMatrix,
    theta: float,
    n_steps: int,
    tau: float,
    pair_cap: int,
    out_cap: int,
    backend: str = "auto",
    row_caps: tuple | None = None,
) -> NSPlans:
    """Walk the Newton-Schulz iteration once eagerly (bit-identical ops
    at the same caps) and capture every step's structural plans."""
    n, b = s.n_rows, s.block_size
    ident_cap = -(-n // b)
    ident = eye(n, b, dtype=s.dtype, cap=ident_cap)
    z = basic.scale(
        eye(n, b, dtype=s.dtype, cap=out_cap),
        1.0 / jnp.sqrt(jnp.asarray(theta, jnp.float32)).astype(s.dtype),
    )
    p_zy, p_t, p_z2 = [], [], []
    for _ in range(n_steps):
        pz = make_plan(z, s, pair_cap)
        zy, _ = spgemm(
            z, s, pair_cap=pair_cap, out_cap=out_cap, backend=backend,
            row_caps=row_caps, plan=pz,
        )
        pt = make_plan(
            zy, z, pair_cap, accum_ids=ident.ids, out_cap=out_cap
        )
        t, _ = spgemm(
            zy, z, pair_cap=pair_cap, out_cap=out_cap, backend=backend,
            row_caps=row_caps, alpha=-0.5, accum=ident, beta=1.5, plan=pt,
        )
        p2 = make_plan(z, t, pair_cap)
        z2, _ = spgemm(
            z, t, pair_cap=pair_cap, out_cap=out_cap, backend=backend,
            row_caps=row_caps, plan=p2,
        )
        z = truncate(z2, tau)
        p_zy.append(pz)
        p_t.append(pt)
        p_z2.append(p2)
    stack = lambda ps: jax.tree.map(lambda *v: jnp.stack(v), *ps)  # noqa: E731
    return NSPlans(p_zy=stack(p_zy), p_t=stack(p_t), p_z2=stack(p_z2))


@partial(
    jax.jit,
    static_argnames=("n_steps", "pair_cap", "out_cap", "backend", "row_caps"),
)
def inv_sqrt_newton_schulz(
    s: BlockMatrix,
    theta: float | jax.Array,
    n_steps: int,
    tau: float | jax.Array,
    pair_cap: int,
    out_cap: int,
    backend: str = "auto",
    row_caps: tuple | None = None,
    plans: NSPlans | None = None,
):
    """Z ~= S^{-1/2} by Newton-Schulz with per-step truncation.

    `theta` must satisfy theta > ||S||_2 / sqrt(3) for convergence of
    Z_0 = I/sqrt(theta) (any upper bound on ||S||_2 works; e.g. a
    Frobenius norm).  Returns (Z, total_block_pairs, overflow).

    `plans` (from `plan_inv_sqrt` at the same caps) freezes every step's
    symbolic/union structure — the scan then runs only numeric work and
    truncation; drift off the planned trajectory is folded into the
    overflow flag.
    """
    n = s.n_rows
    b = s.block_size
    ident_cap = -(-n // b)
    z = basic.scale(
        eye(n, b, dtype=s.dtype, cap=out_cap),
        1.0 / jnp.sqrt(jnp.asarray(theta, jnp.float32)).astype(s.dtype),
    )
    total = jnp.zeros((), jnp.int32)
    ovf = jnp.zeros((), bool)

    def step(carry, xs):
        z, total, ovf = carry
        pz, pt, p2 = xs if xs is not None else (None,) * 3
        zy, i1 = spgemm(
            z, s, pair_cap=pair_cap, out_cap=out_cap, backend=backend,
            row_caps=row_caps, plan=pz,
        )
        # T = 1.5 I - 0.5 ZYZ in ONE structural pass via the fused
        # beta-accumulate (union support at out_cap; a union overflow —
        # the identity pushing the support past out_cap — is reported
        # via i2.out_overflow, ADVICE.md r1 medium).
        t, i2 = spgemm(
            zy, z, pair_cap=pair_cap, out_cap=out_cap, backend=backend,
            row_caps=row_caps, alpha=-0.5,
            accum=eye(n, b, dtype=s.dtype, cap=ident_cap), beta=1.5,
            plan=pt,
        )
        z2, i3 = spgemm(
            z, t, pair_cap=pair_cap, out_cap=out_cap, backend=backend,
            row_caps=row_caps, plan=p2,
        )
        z2 = truncate(z2, tau)
        total = total + i1.n_block_pairs + i2.n_block_pairs + i3.n_block_pairs
        for i in (i1, i2, i3):
            # plan_mismatch: spgemm self-checks each plan against the
            # actual operand/accumulator ids (covers z, the constant S,
            # and the intermediates) — stale plans are never silent.
            ovf = (
                ovf | i.pair_overflow | i.out_overflow | i.row_overflow
                | i.plan_mismatch
            )
        return (z2, total, ovf), None

    xs = None if plans is None else (plans.p_zy, plans.p_t, plans.p_z2)
    (z, total, ovf), _ = jax.lax.scan(
        step, (z, total, ovf), xs, length=n_steps
    )
    return z, total, ovf
