"""Test config: CPU backend with 8 virtual devices (SURVEY.md section 5 —
multi-device without a cluster).  Env must be set before jax initializes
a backend."""

import os

# Tests run on the CPU even where an accelerator is present: they must
# be fast and hermetic.  HBSM_TEST_DEVICE=gpu leaves the device alone,
# for the GPU-marked tests on the card:
#   HBSM_TEST_DEVICE=gpu python -m pytest -m gpu tests/test_segment_gemm.py
ON_GPU = os.environ.get("HBSM_TEST_DEVICE") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from hierarchical_block_sparse_lib.kernels import segment_gemm  # noqa: E402
from hierarchical_block_sparse_lib.utils.cache import cache_dir  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    # The CPU has no Triton: an explicit backend="segment" runs the
    # kernel in the Pallas interpreter.  Auto dispatch on the CPU takes
    # the XLA path.
    segment_gemm.INTERPRET = True

# Persistent XLA:CPU compile cache: the suite's cost is dominated by
# compiles of hundreds of distinct shard_map / Pallas-interpret programs,
# not by execution.  $JAX_COMPILATION_CACHE_DIR when set, else
# `.jax_cache_cpu` in the checkout; HBSM_TEST_CACHE="" disables it.
_cache_dir = os.environ.get("HBSM_TEST_CACHE", cache_dir(".jax_cache_cpu"))
if _cache_dir:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


# The full suite deterministically segfaulted inside XLA:CPU once ~160
# compiled programs accumulated across modules (round 3: crash at the
# same test index on two runs; any subset of modules passes).  Dropping
# the executable caches between modules keeps the live-program count
# bounded; cross-module compile reuse is minimal anyway (each module
# compiles its own shapes).
#
# Root-cause status (round 4, 2026-08-20): the crash is DETERMINISTIC
# at the same test index (~76% of the suite) in BOTH compile paths —
# with the persistent cache it faults inside
# compilation_cache.get_executable_and_time (AOT deserialization),
# without it inside compiler.backend_compile_and_load (plain compile)
# — so the trigger is REGISTERING the ~Nth executable while ~150
# heavyweight (Pallas-interpret / shard_map) executables are live, not
# any particular program or load path.  400 plain jit executables held
# live do NOT crash (scripts/repro_xla_cpu_segfault.py), so the
# per-executable footprint of the heavy programs matters.  Set
# HBSM_NO_CACHE_DROP=1 to re-test on JAX upgrades.  Dropping caches is SAFE (not
# just convenient): it only discards compiled executables between
# modules, forcing recompiles — never results; each module compiles
# its own capacity-bucket shapes, so cross-module reuse (and thus the
# cost of dropping) is minimal, and with the persistent cache above
# the recompiles are disk loads.
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (HBSM_TEST_DEVICE=gpu); skipped elsewhere",
    )


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: HBSM_TEST_DEVICE=gpu python -m pytest "
            "-m gpu tests/test_segment_gemm.py on the card "
            "(python chip_smoke.py covers it too)"
        )


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    if not os.environ.get("HBSM_NO_CACHE_DROP"):
        jax.clear_caches()
