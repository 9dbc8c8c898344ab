"""Matrix polynomials over the block-sparse format.

The general matrix-polynomial workload behind BASELINE.json:9: evaluate
p(A) = sum_k c_k A^k with per-power norm truncation (Horner form), and a
Chebyshev recurrence variant.  Every power is a hierarchical SpGEMM; the
truncation threshold gives the reference's error-controlled sparse
approximate multiplication semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import jax
import jax.numpy as jnp

from hierarchical_block_sparse_lib.core.block_matrix import BlockMatrix
from hierarchical_block_sparse_lib.core.assembly import eye
from hierarchical_block_sparse_lib.ops import basic
from hierarchical_block_sparse_lib.ops.spgemm import make_plan, spgemm
from hierarchical_block_sparse_lib.ops.truncate import truncate


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class HornerPlans:
    """Per-step structural plans for a fixed Horner trajectory
    (`plan_polynomial`).  Unlike the Chebyshev iterates, Horner's
    supports depend on the COEFFICIENTS (truncation sees c_k*I folded
    into the accumulator), so plans are per-(A, coeffs, tau) — the reuse
    regime is repeated evaluation under data drift with frozen
    structure.  Each plan records the operand ids it was built for and
    spgemm self-checks them on use (drift of A or the accumulator folds
    into the returned overflow flag)."""

    mul_plans: tuple  # tuple[SymbolicPlan with union fields]


def plan_polynomial(
    a: BlockMatrix,
    coeffs: Sequence[float],
    tau: float,
    pair_cap: int,
    out_cap: int,
    backend: str = "auto",
) -> HornerPlans:
    """Walk the Horner evaluation once and capture every step's
    symbolic+union plan for ``polynomial(..., plans=...)``."""
    _, _, _, plans = _horner(
        a, coeffs, tau, pair_cap, out_cap, backend, plans=None,
        capture=True,
    )
    return plans


def polynomial(
    a: BlockMatrix,
    coeffs: Sequence[float],
    tau: float,
    pair_cap: int,
    out_cap: int,
    backend: str = "auto",
    plans: HornerPlans | None = None,
):
    """Horner evaluation p(A) = c0 I + c1 A + ... + cn A^n with truncation
    after every multiply.  Returns (P, total_block_pairs, overflow):
    `overflow` is True if any multiply exceeded pair_cap/out_cap (result
    then incomplete — raise the caps).

    `plans` (from `plan_polynomial` at the same coeffs/caps/tau) freezes
    every step's structure; drift is folded into the overflow flag."""
    p, total, ovf, _ = _horner(
        a, coeffs, tau, pair_cap, out_cap, backend, plans=plans,
        capture=False,
    )
    return p, total, ovf


def _horner(
    a: BlockMatrix,
    coeffs: Sequence[float],
    tau: float,
    pair_cap: int,
    out_cap: int,
    backend: str,
    plans: HornerPlans | None,
    capture: bool,
):
    n = a.n_rows
    ident = eye(n, a.block_size, dtype=a.dtype, cap=a.nb_rows)
    acc = basic.scale(ident, coeffs[-1])
    total_pairs = jnp.zeros((), jnp.int32)
    overflow = jnp.zeros((), bool)
    mul_plans = []
    for k, c in enumerate(reversed(coeffs[:-1])):
        if capture:
            mul_plans.append(
                make_plan(
                    acc, a, pair_cap, accum_ids=ident.ids, out_cap=out_cap
                )
            )
        mp = mul_plans[-1] if capture else (
            plans.mul_plans[k] if plans is not None else None
        )
        # Horner step acc <- acc@A + c*I in ONE structural pass via the
        # fused beta-accumulate; a union overflow (support past out_cap,
        # previously a silent repack drop) is reported via out_overflow.
        # With a plan, spgemm self-checks acc/A/ident against the
        # planned structure (info.plan_mismatch).
        acc, info = spgemm(
            acc, a, pair_cap=pair_cap, out_cap=out_cap, backend=backend,
            accum=ident, beta=c, plan=mp,
        )
        total_pairs = total_pairs + info.n_block_pairs
        overflow = (
            overflow | info.pair_overflow | info.out_overflow
            | info.row_overflow | info.plan_mismatch
        )
        acc = truncate(acc, tau)
    hp = HornerPlans(mul_plans=tuple(mul_plans)) if capture else None
    return acc, total_pairs, overflow, hp
