"""Segment-GEMM kernel (Pallas, Triton route) vs the XLA path and dense
oracles.  The kernel runs in the Pallas interpreter here (the conftest
sets `segment_gemm.INTERPRET`); its Triton lowering for CUDA is checked
by exporting without a device, and the compiled kernel by the
GPU-marked test and `chip_smoke.py` on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

import hierarchical_block_sparse_lib as hbsm
from hierarchical_block_sparse_lib.kernels import segment_gemm as sg
from hierarchical_block_sparse_lib.ops import spgemm as spgemm_mod
from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm


def random_bsm(n_rows, n_cols, b, density, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    nbr, nbc = n_rows // b, n_cols // b
    n_blocks = max(1, int(round(density * nbr * nbc)))
    ids = np.sort(rng.choice(nbr * nbc, n_blocks, replace=False))
    m = hbsm.BlockMatrix(
        ids=jnp.asarray(ids.astype(np.int32)),
        data=jnp.asarray(
            rng.standard_normal((n_blocks, b, b)).astype(np.float32)
        ).astype(dtype),
        nnz=jnp.asarray(n_blocks, jnp.int32),
        n_rows=n_rows, n_cols=n_cols, block_size=b,
    )
    return m, np.asarray(hbsm.to_dense(m)).astype(np.float64)


def dense(m):
    return np.asarray(hbsm.to_dense(m)).astype(np.float64)


@pytest.mark.parametrize("b", [16, 32, 64, 128])
def test_segment_matches_xla(b):
    A, dA = random_bsm(4 * b, 4 * b, b, 0.4, seed=b)
    B, dB = random_bsm(4 * b, 4 * b, b, 0.4, seed=b + 1)
    pc, oc = plan_spgemm(A, B)
    Cs, info = hbsm.spgemm(
        A, B, pair_cap=pc, out_cap=oc, alpha=0.5, backend="segment"
    )
    Cx, _ = hbsm.spgemm(A, B, pair_cap=pc, out_cap=oc, alpha=0.5,
                        backend="xla")
    np.testing.assert_array_equal(np.asarray(Cs.ids), np.asarray(Cx.ids))
    np.testing.assert_allclose(
        np.asarray(Cs.data), np.asarray(Cx.data), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(dense(Cs), 0.5 * dA @ dB, rtol=1e-4,
                               atol=1e-4)
    assert int(info.n_block_pairs) == pc
    # Padding slots are all-zero (the BlockMatrix invariant).
    assert np.all(np.asarray(Cs.data)[int(Cs.nnz):] == 0)


@pytest.mark.parametrize("ta,tb", [(True, False), (False, True), (True, True)])
def test_segment_transpose_flags(ta, tb):
    b = 16
    A, dA = random_bsm(6 * b, 5 * b, b, 0.35, seed=3)
    B, dB = random_bsm(7 * b, 6 * b, b, 0.35, seed=4)
    if not ta:
        A, dA = random_bsm(5 * b, 6 * b, b, 0.35, seed=3)
    if tb:
        B, dB = random_bsm(7 * b, 6 * b, b, 0.35, seed=4)
    else:
        B, dB = random_bsm(6 * b, 7 * b, b, 0.35, seed=4)
    opA = dA.T if ta else dA
    opB = dB.T if tb else dB
    Ae = hbsm.transpose(A) if ta else A
    Be = hbsm.transpose(B) if tb else B
    pc, oc = plan_spgemm(Ae, Be)
    C, _ = hbsm.spgemm(A, B, pair_cap=pc, out_cap=oc, transpose_a=ta,
                       transpose_b=tb, backend="segment")
    np.testing.assert_allclose(dense(C), opA @ opB, rtol=1e-4, atol=1e-4)


def test_segment_padding_pairs():
    """pair_cap > pairs and out_cap > outputs: the dropped pairs and the
    unused slots must not pollute the result."""
    b = 16
    A, dA = random_bsm(5 * b, 5 * b, b, 0.3, seed=5)
    pc, oc = plan_spgemm(A, A)
    C, info = hbsm.spgemm(A, A, pair_cap=2 * pc + 7, out_cap=oc + 3,
                          backend="segment")
    np.testing.assert_allclose(dense(C), dA @ dA, rtol=1e-4, atol=1e-4)
    assert np.all(np.asarray(C.data)[int(C.nnz):] == 0)
    assert not bool(info.pair_overflow) and not bool(info.out_overflow)


def test_segment_empty():
    A = hbsm.empty(64, 64, 16, cap=4)
    C, info = hbsm.spgemm(A, A, pair_cap=4, out_cap=4, backend="segment")
    assert int(info.n_block_pairs) == 0
    assert np.all(np.asarray(C.data) == 0)


@pytest.mark.parametrize("traced", [False, True])
def test_segment_union_accumulate(traced):
    """C = alpha*A@B + beta*D with D blocks outside the product support
    (the epilogue's union accumulate)."""
    b = 32
    A, dA = random_bsm(5 * b, 5 * b, b, 0.3, seed=11)
    B, dB = random_bsm(5 * b, 5 * b, b, 0.3, seed=12)
    D, dD = random_bsm(5 * b, 5 * b, b, 0.4, seed=13)
    pc, oc = plan_spgemm(A, B)
    alpha, beta = (jnp.float32(0.5), jnp.float32(-2.0)) if traced else (
        0.5, -2.0)
    C, info = hbsm.spgemm(A, B, pair_cap=pc, out_cap=oc + int(D.nnz),
                          alpha=alpha, beta=beta, accum=D, backend="segment")
    assert not bool(info.out_overflow)
    np.testing.assert_allclose(dense(C), 0.5 * dA @ dB - 2.0 * dD,
                               rtol=1e-4, atol=1e-4)


def _aligned_case(b=16, seed=21):
    A, dA = random_bsm(5 * b, 5 * b, b, 0.35, seed=seed)
    pc, oc = plan_spgemm(A, A)
    C0, _ = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc, backend="xla")
    rng = np.random.default_rng(seed + 1)
    D = dataclasses.replace(
        C0,
        data=jnp.where(
            C0.valid_mask()[:, None, None],
            jnp.asarray(rng.standard_normal(C0.data.shape), jnp.float32),
            0.0,
        ),
    )
    return A, dA, D, pc, oc


@pytest.mark.parametrize("backend", ["segment", "xla"])
def test_accum_aligned_planned(backend):
    """Planned aligned accumulate: output structure = accum's; matches
    the dense oracle and reports no mismatch."""
    A, dA, D, pc, oc = _aligned_case()
    plan = hbsm.make_plan(A, A, pc, accum_ids=D.ids, out_cap=oc)
    C, info = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc, accum=D, beta=0.5,
                          alpha=2.0, accum_aligned=True, plan=plan,
                          backend=backend)
    assert not bool(info.plan_mismatch)
    np.testing.assert_array_equal(np.asarray(C.ids), np.asarray(D.ids))
    np.testing.assert_allclose(dense(C), 2.0 * dA @ dA + 0.5 * dense(D),
                               rtol=1e-4, atol=1e-4)


def test_accum_aligned_plan_checks_union():
    """A plan whose union is larger than the accumulator (product blocks
    outside accum's support) is not an aligned plan: plan.out_ids !=
    plan.acc_ids must surface as plan_mismatch."""
    A, dA, D, pc, oc = _aligned_case()
    k = int(D.nnz)
    ids = np.asarray(D.ids).copy()
    ids[k - 1] = int(np.iinfo(np.int32).max)  # drop one product block
    data = np.asarray(D.data).copy()
    data[k - 1] = 0
    Dsmall = dataclasses.replace(
        D, ids=jnp.asarray(ids), data=jnp.asarray(data),
        nnz=jnp.asarray(k - 1, jnp.int32),
    )
    plan = hbsm.make_plan(A, A, pc, accum_ids=Dsmall.ids, out_cap=oc)
    assert not np.array_equal(np.asarray(plan.out_ids), ids)
    _, info = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc, accum=Dsmall,
                          accum_aligned=True, plan=plan, backend="segment")
    assert bool(info.plan_mismatch)
    # The same accumulator without a plan is caught by the membership
    # check.
    _, info2 = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc, accum=Dsmall,
                           accum_aligned=True, backend="segment")
    assert bool(info2.plan_mismatch)


@pytest.mark.parametrize("b", [16, 32])
def test_segment_bf16_storage(b):
    A, dA = random_bsm(4 * b, 4 * b, b, 0.4, seed=31, dtype=jnp.bfloat16)
    pc, oc = plan_spgemm(A, A)
    Cs, _ = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc, backend="segment")
    Cx, _ = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc, backend="xla")
    assert Cs.dtype == jnp.bfloat16
    ref = dA @ dA
    scale = np.abs(ref).max()
    assert np.abs(dense(Cs) - ref).max() / scale < 1e-2
    assert np.abs(dense(Cs) - dense(Cx)).max() / scale < 1e-2


EXPECTED_ALG = {
    "highest": lax.DotAlgorithmPreset.F32_F32_F32,
    "high": lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    "default": lax.DotAlgorithmPreset.TF32_TF32_F32,
}


def _algorithms_in(jaxpr):
    """dot_general precisions in a jaxpr, recursing into sub-jaxprs
    (pallas_call kernels, scans, conds)."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _algorithms_in(inner)
    return found


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_precision_algorithms(precision):
    """Each precision name selects its DotAlgorithmPreset on both paths:
    the kernel's dot (as compiled for the GPU, interpret=False) and the
    XLA path's dot_general as lowered for CUDA."""
    want = EXPECTED_ALG[precision]
    assert sg.dot_algorithm(precision, jnp.float32) == want
    assert (sg.dot_algorithm(precision, jnp.bfloat16)
            == lax.DotAlgorithmPreset.BF16_BF16_F32)
    b = 16
    A, _ = random_bsm(3 * b, 3 * b, b, 0.5, seed=41)
    pc, oc = plan_spgemm(A, A)
    a_idx, b_idx, c_id, _, _ = hbsm.spgemm_symbolic(A, A, pc)
    _, seg, _ = spgemm_mod.product_structure(c_id, oc)
    starts = sg.slot_starts(seg, oc)
    kern = jax.make_jaxpr(
        lambda ad: sg.segment_gemm(ad, ad, a_idx, b_idx, starts,
                                   precision=precision)
    )(A.data)
    assert set(_algorithms_in(kern.jaxpr)) == {want}
    # XLA path lowered for CUDA: the dot carries the algorithm.
    f = jax.jit(lambda ad: spgemm_mod.numeric_phase(
        ad, ad, a_idx, b_idx, seg, oc, "xla", precision))
    exp = jax.export.export(f, platforms=["cuda"])(A.data)
    dots = [ln for ln in exp.mlir_module().splitlines()
            if "stablehlo.dot_general" in ln]
    assert dots
    if precision == "highest":
        assert all("lhs_precision_type = f32" in ln for ln in dots)
    elif precision == "high":
        assert all("num_primitive_operations = 3" in ln for ln in dots)
    else:
        assert all("lhs_precision_type = tf32" in ln for ln in dots)


@pytest.mark.parametrize("precision,tol", [("high", 1e-4), ("default", 1e-2)])
def test_segment_precision_tiers(precision, tol):
    """Lower tiers stay within their accuracy against the f64 oracle
    (on the CPU the TF32 tier computes in float32)."""
    b = 32
    A, dA = random_bsm(4 * b, 4 * b, b, 0.5, seed=51)
    pc, oc = plan_spgemm(A, A)
    C, _ = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc, backend="segment",
                       precision=precision)
    ref = dA @ dA
    rel = np.linalg.norm(dense(C) - ref) / np.linalg.norm(ref)
    assert rel < tol, rel


def test_syrk_segment_pair_count():
    """syrk computes upper-triangle pairs only, through the kernel."""
    b = 16
    A, dA = random_bsm(6 * b, 6 * b, b, 0.4, seed=61)
    plan = hbsm.plan_syrk(A)
    C, info = hbsm.syrk(A, backend="segment")
    assert int(info.n_block_pairs) == plan.pairs_upper < plan.pairs_raw
    np.testing.assert_allclose(dense(C), dA @ dA.T, rtol=1e-4, atol=1e-4)


def test_spamm_segment_pair_count():
    """Norm-filtered pairs reach the kernel already filtered: the kernel
    result equals the filtered XLA result and the pair count equals
    the host plan's."""
    b = 16
    rng = np.random.default_rng(71)
    A, _ = random_bsm(6 * b, 6 * b, b, 0.5, seed=71)
    scales = jnp.asarray(10.0 ** rng.uniform(-3, 0, A.cap), jnp.float32)
    A = dataclasses.replace(A, data=A.data * scales[:, None, None])
    tau = 1.0
    pc, oc = plan_spgemm(A, A)
    gc, _ = hbsm.plan_spamm(A, A, tau)
    assert 0 < gc < pc
    Cs, info = hbsm.spamm(A, A, tau, pair_cap=pc, out_cap=oc, gemm_cap=gc,
                          backend="segment")
    Cx, _ = hbsm.spamm(A, A, tau, pair_cap=pc, out_cap=oc, gemm_cap=gc,
                       backend="xla")
    assert int(info.n_block_pairs) == gc
    np.testing.assert_allclose(dense(Cs), dense(Cx), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "b,dtype,on_gpu,want",
    [
        (8, jnp.float32, True, "xla"),      # below Triton's smallest dot
        (48, jnp.float32, True, "xla"),     # not a power of two
        (32, jnp.float64, True, "xla"),     # f64 stays on the XLA path
        (16, jnp.float32, True, "segment"),
        (128, jnp.bfloat16, True, "segment"),
        (128, jnp.float32, False, "xla"),   # no GPU: no Triton
    ],
)
def test_dispatch(b, dtype, on_gpu, want, monkeypatch):
    monkeypatch.setattr(
        jax, "default_backend", lambda: "gpu" if on_gpu else "cpu"
    )
    assert spgemm_mod.resolve_backend(b, dtype) == want


def test_segment_deterministic():
    """Two runs of a fixed plan give bitwise-equal output (no atomics)."""
    b = 32
    A, _ = random_bsm(6 * b, 6 * b, b, 0.5, seed=81)
    pc, oc = plan_spgemm(A, A)
    plan = hbsm.make_plan(A, A, pc)
    runs = [
        np.asarray(hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc, plan=plan,
                               backend="segment")[0].data)
        for _ in range(2)
    ]
    np.testing.assert_array_equal(runs[0], runs[1])


def test_slot_starts():
    seg = jnp.asarray([0, 0, 2, 2, 2, 3, 5, 5], jnp.int32)  # 5 = dropped
    np.testing.assert_array_equal(
        np.asarray(sg.slot_starts(seg, 5)), [0, 2, 2, 5, 6, 6]
    )


@pytest.mark.parametrize("b,dtype", [(16, jnp.float32), (32, jnp.bfloat16),
                                     (128, jnp.float32)])
def test_segment_lowers_for_cuda(b, dtype):
    """The kernel lowers to a Triton call for CUDA (no device needed):
    what the GPU compiler then does is for the card to show."""
    A, _ = random_bsm(3 * b, 3 * b, b, 0.5, seed=91, dtype=dtype)
    pc, oc = plan_spgemm(A, A)
    a_idx, b_idx, c_id, _, _ = hbsm.spgemm_symbolic(A, A, pc)
    _, seg, _ = spgemm_mod.product_structure(c_id, oc)
    starts = sg.slot_starts(seg, oc)
    f = jax.jit(lambda ad: sg.segment_gemm(ad, ad, a_idx, b_idx, starts,
                                           alpha=2.0))
    exp = jax.export.export(
        f, platforms=["cuda"],
        disabled_checks=[
            jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(A.data)
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    assert 'name = "segment_gemm"' in text


@pytest.mark.gpu
def test_segment_compiled_on_gpu(gpu):
    """The compiled kernel on the card matches the XLA path."""
    for b in (16, 32, 128):
        A, dA = random_bsm(8 * b, 8 * b, b, 0.3, seed=b)
        pc, oc = plan_spgemm(A, A)
        Cs, _ = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc, backend="segment")
        np.testing.assert_allclose(dense(Cs), dA @ dA, rtol=1e-4, atol=1e-4)


def test_segment_lowers_for_cuda_under_shard_map(monkeypatch):
    """The distributed ring and routed multiplies lower for CUDA with the
    segment kernel inside shard_map and the varying-axes check on (the
    kernel's out_shape carries vma, and its pair loop counts from a
    literal 0)."""
    from hierarchical_block_sparse_lib.parallel import dist, route
    from hierarchical_block_sparse_lib.utils import generators as gen

    monkeypatch.setattr(sg, "INTERPRET", False)
    assert sg.vma_check()
    A = gen.b5_mix(32, 16, seed=2)
    mesh = dist.make_mesh(4)
    pc, oc = plan_spgemm(A, A)
    Ad = dist.distribute(A, mesh)
    frozen = route.freeze_route_plan(Ad, Ad, route.plan_route(Ad, Ad, 4))
    try:
        for f in (
            lambda m: dist.dist_spgemm(m, m, mesh, pair_cap=pc, out_cap=oc,
                                       backend="segment")[0].data,
            lambda m: route.dist_spgemm_routed(m, m, mesh, frozen,
                                               backend="segment")[0].data,
        ):
            text = jax.jit(f).trace(Ad).lower(
                lowering_platforms=("cuda",)).as_text()
            assert "__gpu$xla.gpu.triton" in text
    finally:
        # Traces made with the compiled kernel must not serve later
        # interpreted runs.
        jax.clear_caches()
