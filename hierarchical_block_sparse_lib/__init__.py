"""Hierarchical block-sparse linear algebra in JAX.

A brand-new framework with the capabilities of the C++ reference library
``toxaart/hierarchical_block_sparse_lib`` (quadtree block-sparse matrices
with dense leaf blocks; see SURVEY.md), re-designed for accelerators:

- The quadtree becomes *index math over flat arrays*: each matrix is a
  sorted array of block ids plus a ``[cap, b, b]`` dense leaf-block tensor
  in HBM (SURVEY.md section 8.1). A node of the implicit quadtree is a bit
  prefix of the Morton code of a block id — hierarchy queries are
  bit-shifts, not pointer walks.
- Recursive SpGEMM becomes vectorized block-pair matching followed by
  leaf GEMMs accumulated per output block (SURVEY.md section 8.2), on a
  GPU by an output-stationary Pallas (Triton) segment-GEMM kernel.
- Norm-based truncation becomes a fused per-block reduction + masked
  compaction.
- Distribution block-partitions the hierarchy over a ``jax.sharding.Mesh``
  and exchanges block panels with collectives overlapped against leaf-GEMM
  compute (SURVEY.md section 8.3).

Reference capability contract (BASELINE.json:5): leaf dense GEMM,
recursive SpGEMM, add, scale, transpose, norms, and truncation of
near-zero blocks.  The reference mount was empty at survey time
(SURVEY.md section 0), so parity citations point at BASELINE.json and
SURVEY.md rather than reference file:line.
"""

from hierarchical_block_sparse_lib.core.block_matrix import (
    BlockMatrix,
    Params,
    SENTINEL,
)
from hierarchical_block_sparse_lib.core.assembly import (
    from_coo,
    from_dense,
    to_dense,
    to_coo,
    to_coo_chunks,
    get_values,
    empty,
    eye,
)
from hierarchical_block_sparse_lib.ops.basic import (
    AddPlan,
    add,
    add_planned,
    add_with_info,
    make_add_plan,
    scale,
    transpose,
    filter_blocks,
    triu,
    tril,
)
from hierarchical_block_sparse_lib.ops.norms import (
    frob_squared,
    frob_norm,
    block_frob_squared,
    trace,
    nnz_blocks,
    subtree_frob_squared,
    gershgorin_bound,
)
from hierarchical_block_sparse_lib.ops.truncate import truncate
from hierarchical_block_sparse_lib.ops.spgemm import (
    spgemm,
    spgemm_symbolic,
    spamm,
    plan_spamm,
    plan_syrk,
    make_plan,
    SymbolicPlan,
    MultiplyInfo,
)
from hierarchical_block_sparse_lib.ops.repack import repack, coarsen, plan_coarsen
from hierarchical_block_sparse_lib.ops.band import (
    BandMatrix,
    band_add,
    band_from_blocks,
    band_from_dense,
    band_frob_squared,
    band_mm,
    band_scale,
    band_to_blocks,
    band_to_dense,
    band_probe,
    band_trace,
    band_transpose,
)
from hierarchical_block_sparse_lib.ops.kpack import (
    KpackPlan,
    kpack_spgemm,
    plan_kpack,
)
from hierarchical_block_sparse_lib.ops.leafpack import (
    LeafpackPlan,
    leafpack_spgemm,
    plan_leafpack,
)
from hierarchical_block_sparse_lib.ops.fine import (
    FineFlat,
    FinePlan,
    fine_add,
    fine_frob_squared,
    fine_matmul,
    fine_pack,
    fine_scale,
    fine_sp2_step,
    fine_trace,
    fine_truncate,
    fine_unpack,
    make_fine_plan,
)
from hierarchical_block_sparse_lib.ops.matmul import matmul, syrk
from hierarchical_block_sparse_lib.ops.slab import spgemm_colslab
from hierarchical_block_sparse_lib.ops.spmm import spmm, spmv
from hierarchical_block_sparse_lib.utils.serialization import save, load

__all__ = [
    "BlockMatrix",
    "Params",
    "SENTINEL",
    "from_coo",
    "from_dense",
    "to_dense",
    "to_coo",
    "to_coo_chunks",
    "get_values",
    "empty",
    "eye",
    "add",
    "AddPlan",
    "add_planned",
    "add_with_info",
    "make_add_plan",
    "scale",
    "transpose",
    "frob_squared",
    "frob_norm",
    "block_frob_squared",
    "trace",
    "nnz_blocks",
    "subtree_frob_squared",
    "gershgorin_bound",
    "truncate",
    "spgemm",
    "spgemm_symbolic",
    "spamm",
    "plan_coarsen",
    "make_plan",
    "SymbolicPlan",
    "plan_spamm",
    "MultiplyInfo",
    "repack",
    "coarsen",
    "BandMatrix",
    "band_add",
    "band_from_blocks",
    "band_from_dense",
    "band_frob_squared",
    "band_mm",
    "band_scale",
    "band_to_blocks",
    "band_to_dense",
    "band_probe",
    "band_trace",
    "band_transpose",
    "LeafpackPlan",
    "leafpack_spgemm",
    "plan_leafpack",
    "KpackPlan",
    "kpack_spgemm",
    "plan_kpack",
    "FineFlat",
    "FinePlan",
    "make_fine_plan",
    "fine_pack",
    "fine_unpack",
    "fine_matmul",
    "fine_add",
    "fine_scale",
    "fine_truncate",
    "fine_trace",
    "fine_sp2_step",
    "fine_frob_squared",
    "matmul",
    "syrk",
    "plan_syrk",
    "spgemm_colslab",
    "filter_blocks",
    "triu",
    "tril",
    "spmm",
    "spmv",
    "save",
    "load",
    "HierarchicalBlockSparseMatrix",
]


def __getattr__(name):
    # api imports the package; lazy-load to avoid the import cycle.
    if name == "HierarchicalBlockSparseMatrix":
        from hierarchical_block_sparse_lib.api import (
            HierarchicalBlockSparseMatrix,
        )

        return HierarchicalBlockSparseMatrix
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__version__ = "0.1.0"
