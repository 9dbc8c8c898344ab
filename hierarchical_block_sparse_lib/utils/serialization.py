"""Checkpoint / save-load for block-sparse matrices.

The reference has no serializer beyond value export (`get_all_values` ->
caller-side COO dump; SURVEY.md section 6.4).  Here save/load is a
first-class adjunct of the same surface: the canonical flat
representation (sorted ids + dense leaf blocks + nnz) round-trips through
one compressed npz, and a COO export path matches the reference's
semantics exactly.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from hierarchical_block_sparse_lib.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)

_FORMAT_VERSION = 1


def save(path: str, m: BlockMatrix, compress: bool = True) -> None:
    """Write a BlockMatrix to `path` (.npz).  Stores only the valid
    prefix (nnz blocks), so files are sized by content, not capacity."""
    nnz = int(m.nnz)
    payload = dict(
        format_version=_FORMAT_VERSION,
        ids=np.asarray(m.ids)[:nnz],
        data=np.asarray(m.data)[:nnz],
        n_rows=m.n_rows,
        n_cols=m.n_cols,
        block_size=m.block_size,
    )
    writer = np.savez_compressed if compress else np.savez
    writer(path, **payload)


def load(path: str, cap: int | None = None, dtype=None) -> BlockMatrix:
    """Load a BlockMatrix saved by `save`.  `cap` (>= stored nnz) sets the
    storage capacity; defaults to the stored block count."""
    with np.load(path) as z:
        if int(z["format_version"]) != _FORMAT_VERSION:
            raise ValueError(f"unknown format version {z['format_version']}")
        ids = z["ids"]
        data = z["data"]
        n_rows = int(z["n_rows"])
        n_cols = int(z["n_cols"])
        block_size = int(z["block_size"])
    nnz = ids.shape[0]
    cap = max(cap if cap is not None else nnz, 1)
    if cap < nnz:
        raise ValueError(f"cap={cap} < stored blocks {nnz}")
    if dtype is not None:
        data = data.astype(dtype)
    full_ids = np.full((cap,), SENTINEL, np.int32)
    full_ids[:nnz] = ids
    full_data = np.zeros((cap,) + data.shape[1:], data.dtype)
    full_data[:nnz] = data
    return BlockMatrix(
        ids=jnp.asarray(full_ids),
        data=jnp.asarray(full_data),
        nnz=jnp.asarray(nnz, jnp.int32),
        n_rows=n_rows,
        n_cols=n_cols,
        block_size=block_size,
    )
