"""Smoke test of the library's main path on an NVIDIA GPU.

    python chip_smoke.py              # one GPU: phases 1-7 below
    python chip_smoke.py --devices 4  # four GPUs: the B5 distributed phase only
    python chip_smoke.py --time       # also time the segment kernel vs XLA

Drives the public API (`import hierarchical_block_sparse_lib as hbsm`) at
the BASELINE.json configurations, built from `--seed`, and checks every
product against a plain reference that does not use the code under test:
`to_dense` of the operands multiplied in float64 on the card.  Each phase
prints one line (outcome, wall seconds, the card's name and power limit);
any failure makes the exit status non-zero and suppresses the result
line.  Without a GPU it stops before doing anything.  The last line of a
passing run is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases (one GPU):
  1. device         jax.devices() are GPUs (no CPU fallback)
  2. host planner   csrc/libhbsm_host.so built from the sources, or the
                    numpy fallback (reported)
  3. B2 leaf 32     random 16384^2, 5% blocks: spgemm (auto) at every
                    precision tier, the add + scale chain, the fine-flat
                    path (fine_pack -> make_fine_plan -> fine_matmul)
  4. B2 tile 128    16384^2, 5%, b=128: hbsm.matmul and planned spgemm
  5. B1             banded 4096^2, bandwidth 64, leaf 16: direct spgemm
  6. B3             5 SP2 steps at 4096, b=128 (purify_scan unplanned and
                    with plan_purify plans) vs a dense float64 SP2
  7. entry          __graft_entry__.entry() jitted on the card
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

# Relative Frobenius error bounds against the float64 reference, per
# precision tier, as measured on an H100 at the configured sizes (with a
# margin; see PERF.md).  The max-relative error is printed beside them.
BOUNDS = {"highest": 1e-6, "high": 1e-5, "default": 1e-3}

# Configured orders (BASELINE.json:7-11).
B1_N, B2_N, B3_N, B5_NB = 4096, 16384, 4096, 1024


def gpu_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


class Phases:
    """Runs named phases; records each outcome, never swallows one."""

    def __init__(self, card: str):
        self.card = card
        self.failed: list[str] = []

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            result = fn(*args)
            status = "OK"
        except Exception:  # noqa: BLE001 - reported and counted below
            traceback.print_exc()
            self.failed.append(name)
            result, status = None, "FAILED"
        dt = time.perf_counter() - t0
        print(f"PHASE {name}: {status} wall={dt:.3f}s | {self.card}",
              flush=True)
        return result


def say(msg):
    print(f"  {msg}", flush=True)


def require(cond, what):
    """A check that holds under `python -O` too."""
    if not cond:
        raise AssertionError(what)


def f64_errors(got, ref):
    """(relative Frobenius, max relative) of float64 device arrays."""
    import jax.numpy as jnp

    diff = got - ref
    rel_f = float(jnp.linalg.norm(diff) / jnp.linalg.norm(ref))
    rel_max = float(jnp.max(jnp.abs(diff)) / jnp.max(jnp.abs(ref)))
    return rel_f, rel_max


def check(label, got_dense, ref64, bound):
    """Compare a float32 dense result with the float64 reference."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        rel_f, rel_max = f64_errors(got_dense.astype(jnp.float64), ref64)
    ok = rel_f <= bound
    say(f"{label}: rel_fro={rel_f:.3e} max_rel={rel_max:.3e} "
        f"bound(rel_fro)={bound:.0e} {'ok' if ok else 'EXCEEDED'}")
    if not ok:
        raise AssertionError(f"{label}: rel_fro {rel_f:.3e} > {bound:.0e}")
    return rel_f


def dense_product64(*dense32):
    """Left-to-right product of float32 dense operands in float64 on the
    card (the reference)."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        out = dense32[0].astype(jnp.float64)
        for m in dense32[1:]:
            out = jnp.matmul(out, m.astype(jnp.float64),
                             precision=jax.lax.Precision.HIGHEST)
        return jax.block_until_ready(out)


def median_time(f, reps=7):
    """Median wall seconds of f() to completion, after one warm call."""
    import jax

    jax.block_until_ready(f())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def compare_backends(label, run, timing, precision="highest"):
    """Run `run(backend)` (-> BlockMatrix) on the segment kernel and on
    the XLA path at one precision; check they agree and, with --time,
    report both median times (segment, xla, segment, xla order)."""
    import jax.numpy as jnp
    import numpy as np
    from hierarchical_block_sparse_lib.ops.spgemm import resolve_backend

    seg = run("segment")
    xla = run("xla")
    if not np.array_equal(np.asarray(seg.ids), np.asarray(xla.ids)):
        raise AssertionError(f"{label}: segment/xla structures differ")
    scale = float(jnp.max(jnp.abs(xla.data.astype(jnp.float32))))
    diff = float(jnp.max(jnp.abs(
        seg.data.astype(jnp.float32) - xla.data.astype(jnp.float32))))
    say(f"{label}: segment vs xla ({precision}) max_rel={diff / scale:.3e}")
    if diff / scale > 1e-4:
        raise AssertionError(f"{label}: segment vs xla {diff / scale:.3e}")
    if timing:
        times = {"segment": [], "xla": []}
        for be in ("segment", "xla", "segment", "xla"):
            times[be].append(median_time(lambda: run(be).data))
        say(f"{label}: TIME segment={[f'{t * 1e3:.3f}' for t in times['segment']]} ms "
            f"xla={[f'{t * 1e3:.3f}' for t in times['xla']]} ms "
            f"(auto picks {resolve_backend(seg.block_size, seg.dtype)})")


# ---------------------------------------------------------------- phases


def phase_device(n_devices):
    import jax

    devs = jax.devices()
    kinds = {d.platform for d in devs}
    if kinds != {"gpu"}:
        raise RuntimeError(f"expected GPU devices, got {devs}")
    if len(devs) < n_devices:
        raise RuntimeError(f"need {n_devices} GPUs, have {len(devs)}")
    say(f"devices: {len(devs)} x {devs[0].device_kind}, jax {jax.__version__}")


def phase_planner():
    from hierarchical_block_sparse_lib.runtime import native

    say("host planner: " + (
        "native csrc/libhbsm_host.so" if native.have_native()
        else "numpy fallback (native build or load failed; see log)"))


def phase_b2_leaf32(seed, timing):
    import jax
    import hierarchical_block_sparse_lib as hbsm
    from hierarchical_block_sparse_lib.ops.spgemm import (
        plan_spgemm,
        resolve_backend,
    )
    from hierarchical_block_sparse_lib.utils import generators as gen

    n, b = B2_N, 32
    A = gen.random_block_matrix(n, b, 0.05, seed=seed)
    B = gen.random_block_matrix(n, b, 0.05, seed=seed + 1)
    pc, oc = plan_spgemm(A, B)
    say(f"B2 leaf32: blocks A={int(A.nnz)} B={int(B.nnz)} pairs={pc} "
        f"out={oc}, auto backend={resolve_backend(b, A.dtype)}")
    dA, dB = hbsm.to_dense(A), hbsm.to_dense(B)
    ref = dense_product64(dA, dB)
    for precision, bound in BOUNDS.items():
        C, info = hbsm.spgemm(A, B, pair_cap=pc, out_cap=oc,
                              precision=precision)
        require(not bool(info.pair_overflow | info.out_overflow), "overflow")
        check(f"B2 leaf32 spgemm {precision}", hbsm.to_dense(C), ref, bound)
    C, _ = hbsm.spgemm(A, B, pair_cap=pc, out_cap=oc)
    # The B2 chain: E = -(C + 2 A).
    E = hbsm.scale(hbsm.add(C, A, beta=2.0), -1.0)
    with jax.enable_x64(True):
        ref_e = jax.block_until_ready(-(ref + 2.0 * dA.astype("float64")))
    check("B2 leaf32 chain spgemm+add+scale", hbsm.to_dense(E), ref_e,
          BOUNDS["highest"])
    del ref_e
    # Fine-flat path.
    Af, Bf = hbsm.fine_pack(A), hbsm.fine_pack(B)
    fplan = hbsm.make_fine_plan(A, B, pc, oc)
    Cf, info = hbsm.fine_matmul(Af, Bf, pair_cap=pc, out_cap=oc, plan=fplan)
    require(not bool(info.plan_mismatch | info.pair_overflow),
            "fine plan mismatch or overflow")
    check("B2 leaf32 fine_matmul (planned)",
          hbsm.to_dense(hbsm.fine_unpack(Cf)), ref, BOUNDS["highest"])
    plan = hbsm.make_plan(A, B, pc)
    compare_backends(
        "B2 leaf32 planned spgemm",
        lambda be: hbsm.spgemm(A, B, pair_cap=pc, out_cap=oc, plan=plan,
                               backend=be)[0],
        timing,
    )
    if timing:
        for be in ("segment", "xla"):
            t = median_time(lambda: hbsm.fine_matmul(
                Af, Bf, pair_cap=pc, out_cap=oc, plan=fplan,
                backend=be)[0].data)
            say(f"B2 leaf32 fine_matmul: TIME {be}={t * 1e3:.3f} ms")


def phase_b2_tile128(seed, timing):
    import hierarchical_block_sparse_lib as hbsm
    from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm
    from hierarchical_block_sparse_lib.utils import generators as gen

    n, b = B2_N, 128
    A = gen.random_block_matrix(n, b, 0.05, seed=seed)
    B = gen.random_block_matrix(n, b, 0.05, seed=seed + 1)
    ref = dense_product64(hbsm.to_dense(A), hbsm.to_dense(B))
    C, info = hbsm.matmul(A, B)
    require(not bool(info.pair_overflow | info.out_overflow), "overflow")
    say(f"B2 tile128: pairs={int(info.n_block_pairs)} "
        f"out={int(info.n_out_blocks)}")
    check("B2 tile128 hbsm.matmul", hbsm.to_dense(C), ref, BOUNDS["highest"])
    pc, oc = plan_spgemm(A, B)
    plan = hbsm.make_plan(A, B, pc)
    C2, info2 = hbsm.spgemm(A, B, pair_cap=pc, out_cap=oc, plan=plan)
    require(not bool(info2.plan_mismatch), "plan_mismatch")
    check("B2 tile128 spgemm (make_plan)", hbsm.to_dense(C2), ref,
          BOUNDS["highest"])
    compare_backends(
        "B2 tile128 planned spgemm",
        lambda be: hbsm.spgemm(A, B, pair_cap=pc, out_cap=oc, plan=plan,
                               backend=be)[0],
        timing,
    )


def phase_b1(seed, timing):
    import hierarchical_block_sparse_lib as hbsm
    from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm
    from hierarchical_block_sparse_lib.utils import generators as gen

    A = gen.banded_block_matrix(B1_N, 64, 16, seed=seed)
    pc, oc = plan_spgemm(A, A)
    dA = hbsm.to_dense(A)
    ref = dense_product64(dA, dA)
    C, info = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc)
    require(not bool(info.pair_overflow | info.out_overflow), "overflow")
    say(f"B1: pairs={pc} out={oc}")
    check("B1 banded leaf16 spgemm", hbsm.to_dense(C), ref,
          BOUNDS["highest"])
    plan = hbsm.make_plan(A, A, pc)
    compare_backends(
        "B1 planned spgemm",
        lambda be: hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc, plan=plan,
                               backend=be)[0],
        timing,
    )


def _b3_input(seed):
    """The bench's B3 set-up: banded 4096^2 (bandwidth 256) at b=128,
    symmetrized, Frobenius-normalized, plus I/2."""
    import numpy as np
    import hierarchical_block_sparse_lib as hbsm
    from hierarchical_block_sparse_lib.utils import generators as gen

    n, b = B3_N, 128
    A = gen.banded_block_matrix(n, 256, b, seed=seed)
    A = hbsm.add(A, hbsm.transpose(A), alpha=0.5, beta=0.5)
    A = hbsm.scale(A, 1.0 / float(np.sqrt(float(hbsm.frob_squared(A)))))
    return hbsm.add(A, hbsm.eye(n, b), beta=0.5, cap=A.cap + n // b)


def sp2_reference(x0_dense, n_steps, target, tau, nb):
    """Dense float64 SP2 from the same X0 and an a-priori bound on the
    library's Frobenius distance from it.

    Truncation drops at most one block per slot with norm <= tau, so
    step k adds at most d = tau * nb (nb^2 blocks, Frobenius sum) plus
    float32 rounding (1e-6 of the iterate's norm, above the measured
    'highest' error), and an earlier error e grows by at most
    L_k = 2 * max(||X_k||_2, ||I - X_k||_2), the Lipschitz constant of
    both SP2 branches at X_k:  e_{k+1} <= L_k e_k + d_{k+1}.
    Returns (final iterate, per-step branch flags, error bound)."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        x = x0_dense.astype(jnp.float64)
        squares, bound = [], 0.0
        for _ in range(n_steps):
            w = jnp.linalg.eigvalsh(x)
            lip = 2.0 * float(jnp.maximum(jnp.max(jnp.abs(w)),
                                          jnp.max(jnp.abs(1.0 - w))))
            take_square = bool(jnp.trace(x) > target)
            x2 = jnp.matmul(x, x, precision=jax.lax.Precision.HIGHEST)
            x = x2 if take_square else 2.0 * x - x2
            squares.append(take_square)
            bound = lip * bound + tau * nb + 1e-6 * float(
                jnp.linalg.norm(x))
            del x2, w
        return jax.block_until_ready(x), squares, bound


def phase_b3(seed, timing):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import hierarchical_block_sparse_lib as hbsm
    from hierarchical_block_sparse_lib.models.purification import (
        plan_purify,
        profile_purify,
        purify_scan,
    )

    n, steps, tau = B3_N, 5, 1e-6
    x0 = _b3_input(seed)
    target = n / 2
    prof = profile_purify(x0, steps, tau=tau, target_trace=target)
    ref, squares, bound = sp2_reference(
        hbsm.to_dense(x0), steps, target, tau, n // 128)
    xu, su = purify_scan(x0, steps, tau=tau, target_trace=target,
                         **prof.kwargs())
    plans = plan_purify(x0, steps, tau, prof, target_trace=target)
    xp, sp = purify_scan(x0, steps, tau=tau, target_trace=target,
                         plans=plans, **prof.kwargs())
    for st in (su, sp):
        for flag in ("pair_overflow", "out_overflow", "repack_overflow"):
            require(not bool(np.asarray(getattr(st, flag)).any()), flag)
    require(not bool(np.asarray(sp.plan_mismatch).any()), "plan_mismatch")
    say(f"B3: planned plan_mismatch=False, pairs/step="
        f"{np.asarray(su.n_block_pairs).tolist()}")
    lib_squares = (np.asarray(su.trace) > target).tolist()
    if lib_squares != squares:
        raise AssertionError(
            f"SP2 branches differ: library {lib_squares} vs ref {squares}")
    with jax.enable_x64(True):
        ref_norm = float(jnp.linalg.norm(ref))
    rel_bound = bound / ref_norm
    for label, x in (("unplanned", xu), ("planned", xp)):
        check(f"B3 purify_scan {label} ({steps} SP2 steps, tau={tau:g})",
              hbsm.to_dense(x), ref, rel_bound)
    if not np.array_equal(np.asarray(xu.data), np.asarray(xp.data)):
        raise AssertionError("planned and unplanned purify_scan differ")
    if timing:
        for be in ("segment", "xla"):
            t = median_time(lambda: purify_scan(
                x0, steps, tau=tau, target_trace=target, plans=plans,
                backend=be, **prof.kwargs())[0].data, reps=5)
            say(f"B3 planned purify_scan: TIME {be}={t * 1e3:.3f} ms")


def phase_entry():
    import jax
    import jax.numpy as jnp

    import __graft_entry__

    fn, args = __graft_entry__.entry()
    y, stats = jax.block_until_ready(jax.jit(fn)(*args))
    require(bool(jnp.all(jnp.isfinite(y.data))), "non-finite output")
    require(not bool(stats.pair_overflow | stats.out_overflow), "overflow")
    say(f"entry(): {int(y.nnz)} blocks, trace={float(stats.trace):.3f}")


def phase_b5(seed):
    """B5 at its configured order over 4 GPUs: ring dist_spgemm, frozen
    routed dist_spgemm_routed and one dist_sp2_step_routed, each compared
    blockwise with the single-card spgemm / sp2_step on GPU 0."""
    import jax
    import numpy as np
    import hierarchical_block_sparse_lib as hbsm
    from hierarchical_block_sparse_lib.models.purification import sp2_step
    from hierarchical_block_sparse_lib.ops.spgemm import plan_spgemm
    from hierarchical_block_sparse_lib.parallel import dist, route
    from hierarchical_block_sparse_lib.utils import generators as gen

    nb, b, P = B5_NB, 128, 4
    A = gen.b5_mix(nb, b, seed=seed)
    say(f"B5: {nb}x{nb} blocks at b={b}, nnz={int(A.nnz)} "
        f"({int(A.nnz) * b * b * 4 / 1e9:.2f} GB)")
    mesh = dist.make_mesh(P)
    pc, oc = plan_spgemm(A, A)
    C_ref, _ = hbsm.spgemm(A, A, pair_cap=pc, out_cap=oc)

    def blockwise(label, got, want):
        g, w = dist.undistribute(got), want
        ng, nw = int(g.nnz), int(w.nnz)
        ids_g, ids_w = np.asarray(g.ids)[:ng], np.asarray(w.ids)[:nw]
        if ng != nw or not np.array_equal(ids_g, ids_w):
            raise AssertionError(f"{label}: structures differ ({ng}/{nw})")
        dg = np.asarray(g.data[:ng]).astype(np.float64)
        dw = np.asarray(w.data[:nw]).astype(np.float64)
        rel = np.abs(dg - dw).max() / max(np.abs(dw).max(), 1e-30)
        say(f"{label}: {ng} blocks, blockwise max_rel={rel:.3e} "
            f"bound=1e-5")
        if rel > 1e-5:
            raise AssertionError(f"{label}: {rel:.3e}")

    Ad = dist.distribute(A, mesh)
    t0 = time.perf_counter()
    Cd, pairs, ovf = dist.dist_spgemm(Ad, Ad, mesh, pair_cap=pc,
                                      out_cap=oc, stage_out_cap=oc)
    jax.block_until_ready(Cd.data)
    require(int(pairs) == pc and not bool(ovf), "ring pairs/overflow")
    blockwise(f"ring dist_spgemm ({time.perf_counter() - t0:.1f}s)",
              Cd, C_ref)
    plan = route.plan_route(Ad, Ad, P)
    frozen = route.freeze_route_plan(Ad, Ad, plan)
    t0 = time.perf_counter()
    Cr, st = route.dist_spgemm_routed(Ad, Ad, mesh, frozen)
    jax.block_until_ready(Cr.data)
    require(not bool(st["overflow"]) and not bool(st["plan_mismatch"]),
            "routed overflow or plan_mismatch")
    blockwise(f"frozen dist_spgemm_routed, aligned={frozen.aligned} "
              f"({time.perf_counter() - t0:.1f}s)", Cr, C_ref)
    # One routed SP2 step on a purifiable symmetric iterate.
    As = hbsm.add(A, hbsm.transpose(A), alpha=0.5, beta=0.5)
    As = hbsm.scale(As, 1.0 / float(np.sqrt(float(hbsm.frob_squared(As)))))
    X = hbsm.add(As, hbsm.eye(nb * b, b), beta=0.5, cap=As.cap + nb)
    tau, nocc = 1e-7, nb * b // 2
    pc2, oc2 = plan_spgemm(X, X)
    Y_ref, st_ref = sp2_step(X, tau, pair_cap=pc2, out_cap=oc2,
                             target_trace=nocc, cap=oc2)
    require(not bool(st_ref.pair_overflow | st_ref.out_overflow
                     | st_ref.repack_overflow), "reference sp2_step overflow")
    Xd = dist.distribute(X, mesh)
    xplan = route.plan_route(Xd, Xd, P)
    t0 = time.perf_counter()
    Yd, sst = route.dist_sp2_step_routed(Xd, mesh, xplan, tau,
                                         target_trace=nocc)
    jax.block_until_ready(Yd.data)
    require(not bool(sst["overflow"]), "routed SP2 overflow")
    blockwise(f"dist_sp2_step_routed ({time.perf_counter() - t0:.1f}s)",
              Yd, Y_ref)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--time", action="store_true",
                    help="also time the segment kernel against XLA")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform}); "
              "nothing run", file=sys.stderr)
        return 1
    import hierarchical_block_sparse_lib  # noqa: F401 - fails outside the repo
    from hierarchical_block_sparse_lib.utils.cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    card = gpu_info()
    phases = Phases(card)
    phases.run("device", phase_device, args.devices)
    if args.devices == 4:
        phases.run("B5 on 4 GPUs", phase_b5, args.seed)
    else:
        phases.run("host planner", phase_planner)
        phases.run("B2 leaf32", phase_b2_leaf32, args.seed, args.time)
        phases.run("B2 tile128", phase_b2_tile128, args.seed, args.time)
        phases.run("B1", phase_b1, args.seed, args.time)
        phases.run("B3", phase_b3, args.seed, args.time)
        phases.run("entry", phase_entry)
    if phases.failed:
        print(f"chip_smoke: FAILED phases: {phases.failed}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
