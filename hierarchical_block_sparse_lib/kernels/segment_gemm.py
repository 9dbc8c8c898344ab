"""Output-stationary segment GEMM: the numeric phase of SpGEMM on the GPU.

The symbolic phase (`ops.spgemm.spgemm_symbolic`) lists the contributing
block pairs sorted by output block, so the pairs of output slot ``c`` are
the contiguous range ``[starts[c], starts[c + 1])``.  Each program of
this kernel owns one `[rows, cols]` tile of one output slot (`TILES`),
walks the slot's pair range, loads the A block ``a_idx[p]`` and the B block
``b_idx[p]`` straight from the block tensors, accumulates ``pl.dot`` in
float32 registers, applies the epilogue

    out[c] = alpha * sum_p A[a_idx[p]] @ B[b_idx[p]] + beta * acc[acc_src[c]]

and stores the block once.  Nothing is gathered into device memory,
there is no scatter and there are no atomics, so the result is
deterministic for a fixed plan.  Unused slots have an empty range and
``acc_src == -1``, so they come out zero without a separate pass.

Route: Pallas through Triton (``backend="triton"``).  The kernel runs
only where it was compiled for the GPU; `interpret=True` (set by the
test suite, never by the library) runs it in the Pallas interpreter.

Gate (`supported`): float32 or bfloat16 storage and a power-of-two block
size of at least 16, Triton's smallest dot.  Everything else, float64
included, takes the gather + `dot_general` path in `ops.spgemm`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

_ALG = lax.DotAlgorithmPreset

# Dot algorithm per precision name for float32 storage.  The names keep
# their documented accuracy on a GPU, where a plain DEFAULT or HIGH
# float32 product runs in TF32: "highest" is an IEEE float32 product,
# "high" the three-pass bfloat16 split (~1e-5 relative), "default" one
# TF32 pass.  bfloat16 storage has one algorithm: bf16 inputs, f32 sums.
F32_ALGORITHMS = {
    "highest": _ALG.F32_F32_F32,
    "high": _ALG.BF16_BF16_F32_X3,
    "default": _ALG.TF32_TF32_F32,
}

# XLA's CPU backend (and the Pallas interpreter, which runs on it) has no
# TF32 product; there the TF32 tier computes in plain float32.
_CPU_ALGORITHM = {_ALG.TF32_TF32_F32: _ALG.F32_F32_F32}

# Test-suite switch: run the kernel in the Pallas interpreter.  The
# library never sets it; `tests/conftest.py` does, because the CPU has
# no Triton.  The interpreter does not type-check under shard_map's
# varying-axes check, so distributed code turns that check off while
# this is set (`vma_check()`).
INTERPRET = False


def vma_check() -> bool:
    """`check_vma` for shard_maps whose body may run this kernel."""
    return not INTERPRET


def dot_algorithm(precision: str, dtype) -> lax.DotAlgorithmPreset:
    """The dot algorithm a precision name selects for `dtype` storage."""
    if precision not in F32_ALGORITHMS:
        raise ValueError(
            f"precision must be one of {sorted(F32_ALGORITHMS)}, "
            f"got {precision!r}"
        )
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float32:
        return F32_ALGORITHMS[precision]
    if dtype == jnp.bfloat16:
        return _ALG.BF16_BF16_F32
    raise ValueError(f"no dot algorithm for {dtype} storage")


def cpu_algorithm(alg: lax.DotAlgorithmPreset) -> lax.DotAlgorithmPreset:
    """`alg` as XLA's CPU backend can run it (TF32 becomes float32)."""
    return _CPU_ALGORITHM.get(alg, alg)


def supported(block_size: int, dtype) -> bool:
    """Whether the kernel handles this storage (see module docstring)."""
    b = int(block_size)
    return (
        jnp.dtype(dtype) in (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16))
        and b >= 16
        and b & (b - 1) == 0
    )


def slot_starts(seg: jax.Array, out_cap: int) -> jax.Array:
    """int32[out_cap + 1] pair-range starts from a nondecreasing pair ->
    slot map (`seg >= out_cap` marks dropped pairs, which sort last)."""
    cnt = (
        jnp.zeros((out_cap + 1,), jnp.int32)
        .at[jnp.minimum(seg, out_cap)]
        .add(1)
    )
    return jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt[:out_cap])]
    ).astype(jnp.int32)


# Per block size: (rows, cols, k_chunk, num_warps, num_stages).  A
# program owns a [rows, cols] tile of one output block and walks the
# contraction in k_chunk slices.  Chosen on an H100 at the configured
# B1/B2 shapes (PERF.md): at b=128 a whole-block [64,128]x[128,128] step
# spills and ran 15x slower than these 32-deep slices.
TILES = {
    16: (16, 16, 16, 1, 3),
    32: (32, 32, 32, 2, 1),
    64: (64, 64, 64, 4, 3),
    128: (32, 128, 32, 4, 3),
}


def _kernel(
    starts_ref, a_idx_ref, b_idx_ref, acc_src_ref, scal_ref,
    a_ref, b_ref, acc_ref, o_ref, *, rows, cols, kc, alg,
):
    c = pl.program_id(0)
    r0 = pl.multiple_of(pl.program_id(1) * rows, rows)
    c0 = pl.multiple_of(pl.program_id(2) * cols, cols)
    k = a_ref.shape[-1]

    lo = starts_ref[c]

    def body(i, acc):
        ai, bi = a_idx_ref[lo + i], b_idx_ref[lo + i]
        for k0 in range(0, k, kc):
            x = a_ref[ai, pl.ds(r0, rows), pl.ds(k0, kc)]
            y = b_ref[bi, pl.ds(k0, kc), pl.ds(c0, cols)]
            acc = acc + pl.dot(x, y, precision=alg)
        return acc

    # The loop counts from a literal 0 (the pair range's length as the
    # bound), so its index carries no varying-axes type under shard_map.
    acc = lax.fori_loop(
        0, starts_ref[c + 1] - lo, body, jnp.zeros((rows, cols), jnp.float32)
    )
    s = acc_src_ref[c]
    blk = acc_ref[
        jnp.maximum(s, 0), pl.ds(r0, rows), pl.ds(c0, cols)
    ].astype(jnp.float32)
    beta = jnp.where(s >= 0, scal_ref[1], 0.0)
    o_ref[c, pl.ds(r0, rows), pl.ds(c0, cols)] = (
        scal_ref[0] * acc + beta * blk
    ).astype(o_ref.dtype)


def segment_gemm(
    a_data: jax.Array,
    b_data: jax.Array,
    a_idx: jax.Array,
    b_idx: jax.Array,
    starts: jax.Array,
    *,
    precision: str = "highest",
    alpha=1.0,
    beta=0.0,
    acc_data: jax.Array | None = None,
    acc_src: jax.Array | None = None,
    interpret: bool = False,
) -> jax.Array:
    """Output-stationary gather-GEMM-accumulate.

    a_data [capA, b, b], b_data [capB, b, b]; pair p multiplies
    ``a_data[a_idx[p]] @ b_data[b_idx[p]]`` into the slot whose range
    ``[starts[c], starts[c+1])`` holds p.  Returns [out_cap, b, b] in
    a_data's dtype, out_cap = len(starts) - 1.  With `acc_data`, slot c
    adds ``beta * acc_data[acc_src[c]]`` (none where acc_src[c] < 0).
    """
    bs = a_data.shape[-1]
    if not supported(bs, a_data.dtype) or b_data.dtype != a_data.dtype:
        raise ValueError(
            f"segment_gemm: unsupported storage {a_data.dtype}/"
            f"{b_data.dtype} at block size {bs}"
        )
    out_cap = starts.shape[0] - 1
    alg = dot_algorithm(precision, a_data.dtype)
    if interpret:
        alg = cpu_algorithm(alg)
    if acc_data is None:
        acc_data = jnp.zeros((1, bs, bs), a_data.dtype)
        acc_src = jnp.full((out_cap,), -1, jnp.int32)
    scal = jnp.stack(
        [jnp.asarray(alpha, jnp.float32), jnp.asarray(beta, jnp.float32)]
    )
    # Dropped pairs may index past the block tensors' padding: clamp so
    # that even an out-of-range id reads a real (padding) block.
    a_idx = jnp.clip(a_idx, 0, a_data.shape[0] - 1).astype(jnp.int32)
    b_idx = jnp.clip(b_idx, 0, b_data.shape[0] - 1).astype(jnp.int32)
    rows, cols, kc, num_warps, num_stages = TILES.get(bs, TILES[128])
    return pl.pallas_call(
        functools.partial(_kernel, rows=rows, cols=cols, kc=kc, alg=alg),
        out_shape=jax.ShapeDtypeStruct(
            (out_cap, bs, bs), a_data.dtype,
            vma=frozenset().union(*(
                jax.typeof(x).vma for x in (a_data, b_data, acc_data)
            )),
        ),
        grid=(out_cap, bs // rows, bs // cols),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="segment_gemm",
    )(
        starts, a_idx, b_idx, acc_src.astype(jnp.int32), scal,
        a_data, b_data, acc_data,
    )
