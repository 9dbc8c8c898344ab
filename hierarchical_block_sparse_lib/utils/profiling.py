"""Operation counters and profiling helpers.

The reference's observability is exact operation counters — leaf
block-multiplies, stored blocks, resizes (SURVEY.md C12/section 6.1) —
which double as its benchmark metric ("nnz-block GEMMs/s").  This
framework computes the same counters exactly from the symbolic phase
(`MultiplyInfo`) at zero device cost; this module aggregates them across
an operation sequence and adds `jax.profiler` wrappers for device
traces.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Counters:
    """Accumulates the reference's counters over a sequence of ops.

    Feed each op's `MultiplyInfo` / `PurificationStats` via `record`;
    all fields are exact (mirroring the reference's out-params, not
    sampled estimates).
    """

    n_block_multiplies: int = 0  # reference: no_of_block_multiplies
    n_multiplies: int = 0  # SpGEMM invocations
    n_out_blocks: int = 0  # distinct output blocks produced
    overflows: int = 0  # any capacity overflow observed
    wall_s: float = 0.0  # host wall time inside `timed` sections
    _t0: float | None = field(default=None, repr=False)

    def record(self, info) -> None:
        """Accumulate a MultiplyInfo or PurificationStats (or any object
        with n_block_pairs / overflow fields; arrays are materialized)."""
        import numpy as np

        pairs = getattr(info, "n_block_pairs", None)
        if pairs is not None:
            arr = np.asarray(pairs)
            self.n_block_multiplies += int(arr.sum())
            self.n_multiplies += max(int(arr.size), 1)
        outs = getattr(info, "n_out_blocks", None)
        if outs is not None:
            self.n_out_blocks += int(np.asarray(outs).sum())
        for f in (
            "pair_overflow", "out_overflow", "row_overflow",
            "repack_overflow", "plan_mismatch",
        ):
            v = getattr(info, f, None)
            if v is not None and bool(np.asarray(v).any()):
                self.overflows += 1

    @contextlib.contextmanager
    def timed(self):
        """Accumulate host wall time; note the caller must block on
        results (e.g. materialize to host) for device work to be
        attributed — see bench.py's timing methodology notes."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.wall_s += time.perf_counter() - t0

    def pairs_per_second(self) -> float:
        return self.n_block_multiplies / self.wall_s if self.wall_s else 0.0

    def effective_gflops(self, block_size: int) -> float:
        """2*b^3 FLOPs per recorded block multiply (BASELINE.json:2)."""
        return (
            2 * block_size**3 * self.n_block_multiplies / self.wall_s / 1e9
            if self.wall_s
            else 0.0
        )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace for kernel-level inspection (TensorBoard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
