"""Dense-band tier: strip-panel storage for banded matrices.

The quadtree/BlockMatrix path treats a band as a set of leaf blocks and
pays tile padding for every partially-filled 128 tile (7.0x honest-FLOP
inflation on B1; SURVEY.md section 8.5).  A band is
*translation invariant*, and this tier exploits that the static-shape way
(VERDICT r2 item 1):

- **Storage**: row strips of 128, each stored as a dense panel
  ``panels[s] = A[128s : 128s+128, 128s-wpad : 128s+128+wpad]`` —
  the only zeros kept are the fixed parallelogram corners (~2x for B1
  vs 7x tile padding).
- **Multiply**: C strip s needs B rows ``128s-wa .. 128s+128+wa`` — a
  stack of three-ish *statically shifted* slices of B's own panels.
  Because the shifts are the same for every s, the window build is pure
  pad/slice/concat (no gather at all) and XLA fuses it into ONE batched
  dense GEMM.
- **Output**: lands directly in panel form with halfwidth wa+wb; feeding
  C back into another multiply needs no repacking (the SP2/polynomial
  iteration regime).

This is a *tier*, not a replacement: `band_from_blocks`/`band_to_blocks`
convert at the boundary, and the honest leaf-granularity multiply count
still comes from the fine BlockMatrix plan (the reference's
no_of_block_multiplies, SURVEY.md C12).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib.ops.spgemm import named_dot

STRIP = 128  # strip height (one 128 tile)


def _static(**kw):
    return field(metadata=dict(static=True), **kw)


def _wpad(w: int) -> int:
    """Stored half-window: w rounded up to 64 so panel width 128+2*wpad
    is a lane multiple (128)."""
    return -(-max(w, 1) // 64) * 64


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BandMatrix:
    """A banded n x n matrix (|i-j| <= w) as dense row-strip panels.

    ``panels[s, i, j] = A[128s + i, 128s - wpad + j]`` (zero outside the
    matrix / outside the band).  ``w`` is the true halfwidth; ``wpad``
    the stored (64-aligned) half-window.
    """

    panels: jax.Array  # dtype[S, 128, 128 + 2*wpad]
    n: int = _static(default=0)
    w: int = _static(default=0)

    @property
    def strips(self) -> int:
        return self.panels.shape[0]

    @property
    def wpad(self) -> int:
        return (self.panels.shape[2] - STRIP) // 2

    @property
    def width(self) -> int:
        return self.panels.shape[2]

    @property
    def dtype(self):
        return self.panels.dtype

    def col0(self, s: int) -> int:
        """Global column of panel s's first stored column."""
        return STRIP * s - self.wpad

    def __repr__(self):  # pragma: no cover - debug aid
        return (
            f"BandMatrix(n={self.n}, w={self.w}, wpad={self.wpad}, "
            f"S={self.strips}, dtype={self.dtype})"
        )


def band_from_blocks(a: BlockMatrix, w: int) -> BandMatrix:
    """Extract the band |i-j| <= w of a BlockMatrix into panel form.

    Boundary conversion (host-planned block gather; not for the hot
    loop).  Blocks straddling the stored window are clipped — entries
    outside |i-j| <= wpad must be zero (true for any matrix whose
    support is within the band)."""
    if a.n_rows != a.n_cols:
        raise ValueError("band tier is square-only")
    n, bb = a.n_rows, a.block_size
    if STRIP % bb and bb % STRIP:
        raise ValueError(f"block_size {bb} must divide or be divided by 128")
    wp = _wpad(w)
    W = STRIP + 2 * wp
    S = -(-n // STRIP)
    if STRIP % bb == 0:
        # No block straddles a strip: ONE vectorized jitted scatter
        # (the host-loop path below issues ~200 grouped scatter
        # dispatches at B1's 21k blocks; this is ~one op).
        return _band_from_blocks_v(a, n, bb, w, wp, W, S)
    ids = np.asarray(a.ids, np.int64)
    valid = ids != int(SENTINEL)
    brow = ids // a.nb_cols
    bcol = ids % a.nb_cols
    # Scatter each block into every strip window it intersects.  With
    # bb <= 128 a block's rows live in exactly one strip; with bb > 128
    # it spans bb/128 strips.
    idx_np = np.asarray(ids)
    pieces = []
    for k in np.nonzero(valid)[0]:
        r0, c0 = int(brow[k]) * bb, int(bcol[k]) * bb
        for s in range(r0 // STRIP, -(-(r0 + bb) // STRIP)):
            if s >= S:
                continue
            pieces.append((int(k), s, r0, c0))
    panels = jnp.zeros((S, STRIP, W), a.dtype)
    # Group by (row-offset, col-offset) so each group is one vectorized
    # dynamic_update via scatter-add with static local offsets.
    by_off: dict = {}
    for k, s, r0, c0 in pieces:
        ro = r0 - s * STRIP
        co = c0 - (STRIP * s - wp)
        by_off.setdefault((ro, co), []).append((k, s))
    for (ro, co), grp in sorted(by_off.items()):
        ks = jnp.asarray([k for k, _ in grp], jnp.int32)
        ss = jnp.asarray([s for _, s in grp], jnp.int32)
        blk = a.data[ks]  # [g, bb, bb]
        # Clip the block to the stored window (out-of-window entries are
        # zero by the band precondition; asserted in tests).
        r_lo, r_hi = max(0, -ro), min(bb, STRIP - ro)
        c_lo, c_hi = max(0, -co), min(bb, W - co)
        if r_lo >= r_hi or c_lo >= c_hi:
            continue
        sub = blk[:, r_lo:r_hi, c_lo:c_hi]
        panels = panels.at[
            ss, ro + r_lo : ro + r_hi, co + c_lo : co + c_hi
        ].add(sub)
    return BandMatrix(panels=panels, n=n, w=w)


@partial(jax.jit, static_argnames=("n", "bb", "w", "wp", "W", "S"))
def _band_from_blocks_v(a, n, bb, w, wp, W, S):
    """Vectorized band pack for bb | 128: every block lives in exactly
    one strip; out-of-window and SENTINEL-slot writes drop via the
    scatter's OOB mode (entries outside |i-j| <= wp are zero by the
    band precondition)."""
    nbc = a.nb_cols
    valid = a.valid_mask()
    brow = jnp.where(valid, a.ids // nbc, jnp.int32(S * STRIP))
    bcol = a.ids % jnp.int32(nbc)
    r0 = brow * bb
    ss = r0 // STRIP
    co = bcol * bb - (ss * STRIP - wp)  # may be out of [0, W): dropped
    rows = (r0[:, None] + jnp.arange(bb, dtype=jnp.int32)[None, :])
    cols = (co[:, None] + jnp.arange(bb, dtype=jnp.int32)[None, :])
    flat = (
        jnp.zeros((S * STRIP, W), a.dtype)
        .at[rows[:, :, None], cols[:, None, :]]
        .add(a.data, mode="drop")
    )
    return BandMatrix(panels=flat.reshape(S, STRIP, W), n=n, w=w)


def band_probe(a: BlockMatrix, min_fill: float = 0.5) -> int | None:
    """Host-side structure probe (VERDICT r4 item 7): if `a` is a
    dense-enough band, return the element bandwidth `w` to pack it
    with (`band_from_blocks(a, w)`); else None.

    Gates: square; block_size divides 128 (strip-aligned packing); the
    band support fill is >= `min_fill` (the tier computes dense strips
    — low fill wastes GEMM work); the padded window stays well below
    the matrix order (else the "band" is just dense).  Cost: one pass
    over the id array on host."""
    if a.n_rows != a.n_cols or STRIP % a.block_size != 0:
        return None
    ids = np.asarray(a.ids, np.int64)
    ids = ids[ids != int(SENTINEL)]
    if ids.size == 0:
        return None
    br, bc = ids // a.nb_cols, ids % a.nb_cols
    wb = int(np.abs(br - bc).max())
    bb = a.block_size
    w = wb * bb + bb - 1
    if 2 * _wpad(w) + STRIP >= a.n_rows:
        return None  # window ~ the whole matrix: not a band
    nb = a.nb_rows
    band_blocks = nb * (2 * wb + 1) - wb * (wb + 1)
    if ids.size < min_fill * band_blocks:
        return None
    return w


def band_pair_count(nb: int, wb: int) -> int:
    """Structural block-pair count of a full band of block-halfwidth
    `wb` on an nb x nb block grid — the work the band tier performs
    (it computes dense strips over the band support); reported as the
    block-multiply counter for band-routed multiplies."""
    k = np.arange(nb)
    cnt = np.minimum(nb - 1, k + wb) - np.maximum(0, k - wb) + 1
    return int((cnt * cnt).sum())


def band_from_dense(d: jax.Array, w: int) -> BandMatrix:
    """Extract the band of a dense [n, n] array (test/oracle helper)."""
    n = d.shape[0]
    wp = _wpad(w)
    W = STRIP + 2 * wp
    S = -(-n // STRIP)
    pad = jnp.zeros((S * STRIP, n), d.dtype).at[:n].set(d)
    pad = jnp.pad(pad, ((0, 0), (wp, W)))  # left wp, right slack
    rows = pad.reshape(S, STRIP, -1)
    cols0 = np.arange(S) * STRIP  # + wp - wp
    win = jnp.stack(
        [jax.lax.dynamic_slice(rows[s], (0, int(c0)), (STRIP, W))
         for s, c0 in enumerate(cols0)]
    )
    # Zero outside the true band (keeps the all-zero-outside-w invariant).
    i = jnp.arange(STRIP)[:, None]
    j = jnp.arange(W)[None, :]
    mask = jnp.abs((j - wp) - i) <= w
    return BandMatrix(panels=win * mask[None], n=n, w=w)


def band_to_dense(a: BandMatrix) -> jax.Array:
    """Densify (test/oracle helper)."""
    S, W, wp = a.strips, a.width, a.wpad
    out = jnp.zeros((S * STRIP, S * STRIP + W), a.dtype)
    for s in range(S):
        out = jax.lax.dynamic_update_slice(
            out, a.panels[s], (s * STRIP, s * STRIP)
        )
    # Stored col j of strip s is global col 128s - wp + j: shift left wp.
    return out[: a.n, wp : wp + a.n]


def band_to_blocks(
    a: BandMatrix, block_size: int = 128, cap: int | None = None
) -> BlockMatrix:
    """Convert to the canonical BlockMatrix (boundary conversion).

    Emits every block intersecting |i-j| <= w (structural band support,
    matching what assembly of the band's COO would produce); use
    `ops.truncate` afterwards to drop numerically-zero blocks."""
    n, bb, w = a.n, block_size, a.w
    if STRIP % bb:
        raise ValueError("block_size must divide 128")
    wp = a.wpad
    nb = -(-n // bb)
    ids_l = []
    for br in range(nb):
        lo = max(0, br * bb - w) // bb
        hi = min(n - 1, br * bb + bb - 1 + w) // bb
        ids_l.extend(br * nb + bc for bc in range(lo, hi + 1))
    ids_np = np.asarray(ids_l, np.int64)
    n_out = ids_np.size
    cap = n_out if cap is None else cap
    # Gather each block's panel window: block (br, bc) lives in strip
    # s = br*bb // 128 at local rows br*bb - 128s, cols bc*bb - col0(s).
    brs, bcs = ids_np // nb, ids_np % nb
    ss = (brs * bb) // STRIP
    ro = brs * bb - ss * STRIP
    co = bcs * bb - (ss * STRIP - wp)
    # Vectorized window gather via per-element take: build index grids.
    ii = ro[:, None, None] + np.arange(bb)[None, :, None]  # [n_out, bb, 1]
    jj = co[:, None, None] + np.arange(bb)[None, None, :]  # [n_out, 1, bb]
    ok = (jj >= 0) & (jj < a.width)
    jj_c = np.clip(jj, 0, a.width - 1)
    data = a.panels[
        jnp.asarray(ss)[:, None, None],
        jnp.asarray(ii),
        jnp.asarray(jj_c),
    ] * jnp.asarray(ok, a.dtype)
    ids = jnp.full((cap,), SENTINEL, jnp.int32)
    dat = jnp.zeros((cap, bb, bb), a.dtype)
    ids = ids.at[:n_out].set(jnp.asarray(ids_np, jnp.int32))
    dat = dat.at[:n_out].set(data)
    return BlockMatrix(
        ids=ids, data=dat, nnz=jnp.asarray(n_out, jnp.int32),
        n_rows=n, n_cols=n, block_size=bb,
    )


def _shifted(panels: jax.Array, delta: int) -> jax.Array:
    """panels[s + delta] with zero panels past the ends."""
    S = panels.shape[0]
    if delta == 0:
        return panels
    z = jnp.zeros((abs(delta),) + panels.shape[1:], panels.dtype)
    if delta > 0:
        return jnp.concatenate([panels[delta:], z])
    return jnp.concatenate([z, panels[:delta]])


@partial(jax.jit, static_argnames=("precision", "out_w"))
def band_mm(
    a: BandMatrix,
    b: BandMatrix,
    alpha: float | jax.Array = 1.0,
    precision: str = "highest",
    out_w: int | None = None,
):
    """C = alpha * A @ B for banded A, B: ONE batched dense GEMM.

    C's halfwidth is w_a + w_b (classic band fill-in), clamped to
    `out_w` if given (entries beyond out_w are *discarded* — the band
    analogue of subtree truncation with a structural threshold).

    The B window for C strip s stacks statically-shifted slices of B's
    panels (translation invariance: the same shifts for every strip), so
    the whole symbolic phase is compile-time Python and the runtime is
    one fused pad/concat + batched GEMM."""
    if a.n != b.n:
        raise ValueError("dimension mismatch")
    wa, wb = a.wpad, b.wpad
    wc_true = a.w + b.w
    if out_w is not None:
        wc_true = min(wc_true, out_w)
    wc = min(_wpad(wc_true), wa + wb)
    Wc = STRIP + 2 * wc
    Wa = STRIP + 2 * wa
    S = a.strips

    # Window rows: global [128s - wa, 128s + 128 + wa).  Source panel
    # s+delta holds rows [128(s+delta), 128(s+delta)+128), i.e. window-
    # local rows [128*delta + wa, ...+128) — clip to [0, Wa).
    d_lo = -(-wa // STRIP)  # ceil
    pieces = []
    for delta in range(-d_lo, d_lo + 1):
        r0 = delta * STRIP + wa  # window-local first row of this panel
        src_lo = max(0, -r0)
        src_hi = min(STRIP, Wa - r0)
        if src_lo >= src_hi:
            continue
        # Window cols start at global 128s - wc; panel s+delta's cols
        # start at global 128(s+delta) - wb -> local offset:
        c0 = delta * STRIP + wc - wb
        csrc_lo = max(0, -c0)
        csrc_hi = min(b.width, Wc - c0)
        if csrc_lo >= csrc_hi:
            continue
        piece = _shifted(b.panels, delta)[:, src_lo:src_hi, csrc_lo:csrc_hi]
        piece = jnp.pad(
            piece,
            (
                (0, 0),
                (0, 0),
                (c0 + csrc_lo, Wc - (c0 + csrc_hi)),
            ),
        )
        # Rows of the window this piece does NOT cover are zero rows of
        # the band — but they multiply A-window columns that are also
        # zero there only if truly out of range; pad rows explicitly.
        piece = jnp.pad(
            piece, ((0, 0), (r0 + src_lo, Wa - (r0 + src_hi)), (0, 0))
        )
        pieces.append(piece)
    win = pieces[0]
    for p in pieces[1:]:
        win = win + p

    # A operand: panel cols j map to window rows j (both are global col
    # 128s - wa + j) — A panels are ALREADY the lhs, no movement.
    acc = jnp.promote_types(a.dtype, jnp.float32)
    out = named_dot(
        a.panels,
        win,
        (((2,), (1,)), ((0,), (0,))),
        precision,
        acc,
    )
    if not (isinstance(alpha, (int, float)) and float(alpha) == 1.0):
        out = out * jnp.asarray(alpha, acc)
    out = out.astype(a.dtype)
    if wc_true < a.w + b.w:
        # out_w clamped below the natural fill-in: discard beyond-clamp
        # entries explicitly (they are genuinely nonzero products).
        # Without clamping no mask is needed: operands honor the
        # zero-outside-band/bounds invariant, so every out-of-band or
        # out-of-matrix output entry is a sum of exact zeros already.
        i = jnp.arange(STRIP)[:, None]
        j = jnp.arange(Wc)[None, :]
        band_ok = jnp.abs((j - wc) - i) <= wc_true
        out = jnp.where(band_ok[None], out, 0)
    return BandMatrix(panels=out, n=a.n, w=wc_true)


@jax.jit
def band_add(
    a: BandMatrix,
    b: BandMatrix,
    alpha: float | jax.Array = 1.0,
    beta: float | jax.Array = 1.0,
) -> BandMatrix:
    """alpha*A + beta*B (result halfwidth max(wa, wb))."""
    if a.n != b.n:
        raise ValueError("dimension mismatch")
    if a.wpad < b.wpad:
        a, b = b, a
        alpha, beta = beta, alpha
    d = a.wpad - b.wpad
    pb = jnp.pad(b.panels, ((0, 0), (0, 0), (d, d)))
    acc = jnp.promote_types(a.dtype, jnp.float32)
    out = (
        a.panels.astype(acc) * jnp.asarray(alpha, acc)
        + pb.astype(acc) * jnp.asarray(beta, acc)
    ).astype(a.dtype)
    return BandMatrix(panels=out, n=a.n, w=max(a.w, b.w))


@jax.jit
def band_scale(a: BandMatrix, alpha) -> BandMatrix:
    return BandMatrix(
        panels=a.panels * jnp.asarray(alpha, a.dtype), n=a.n, w=a.w
    )


@jax.jit
def band_frob_squared(a: BandMatrix) -> jax.Array:
    """Panels partition the matrix rows, so no double counting."""
    x = a.panels.astype(jnp.float32)
    return jnp.sum(x * x)


@jax.jit
def band_trace(a: BandMatrix) -> jax.Array:
    # Diagonal of strip s sits at panel cols wpad + i.
    diag = a.panels[:, jnp.arange(STRIP), a.wpad + jnp.arange(STRIP)]
    return jnp.sum(diag.astype(jnp.float32))


@jax.jit
def band_transpose(a: BandMatrix) -> BandMatrix:
    """A^T: entry (i, j) -> (j, i).  Panel-local: target strip s stores
    (128s+i, 128s-wp+j) = source (128s-wp+j, 128s+i), which lives in
    source strips s-1..s+1 — the same static-shift stack as band_mm."""
    S, wp, W = a.strips, a.wpad, a.width
    d_lo = -(-wp // STRIP)
    out = jnp.zeros_like(a.panels)
    for delta in range(-d_lo, d_lo + 1):
        # Source strip s+delta rows r in [0,128): global row g = 128(s+
        # delta)+r becomes target col j = g - (128s - wp) = 128*delta +
        # wp + r; target row i = source global col - 128s = (128(s+delta)
        # - wp + c) - 128s = 128*delta - wp + c.
        src = _shifted(a.panels, delta)  # [S, r, c]
        j0 = delta * STRIP + wp
        i0 = delta * STRIP - wp
        r_lo, r_hi = max(0, -j0), min(STRIP, W - j0)
        c_lo, c_hi = max(0, -i0), min(W, STRIP - i0)
        if r_lo >= r_hi or c_lo >= c_hi:
            continue
        piece = src[:, r_lo:r_hi, c_lo:c_hi].transpose(0, 2, 1)
        out = out.at[
            :, i0 + c_lo : i0 + c_hi, j0 + r_lo : j0 + r_hi
        ].add(piece)
    return BandMatrix(panels=out, n=a.n, w=a.w)
