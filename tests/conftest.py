"""Test configuration: CPU backend with a virtual 8-device mesh and x64 on.

Multi-device sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count); numeric oracles run in f64 to
certify the algorithms, and separate f32 tests bound the single-precision
error. Tests marked ``gpu`` (tests/test_gpu_hardware.py) run the
``chip_smoke.py`` phases on an NVIDIA GPU and skip, from a fixture, where
there is none:

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu_hardware.py -n 0

``JAX_PLATFORMS`` picks the backend (default: cpu); x64 is enabled only on
the CPU backend.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Keep stage scans rolled in CI: tracing the fully-unrolled solver graphs is
# pure uncacheable Python time and dominated suite wall clock (numerics are
# identical; the unroll only changes fusion, ops/riccati.py).
os.environ.setdefault("CHEETA_STAGE_UNROLL", "1")

import pytest  # noqa: E402


def _compute_cpu_key() -> str:
    """Host-CPU-feature hash keying the XLA:CPU persistent cache dir (AOT
    executables are machine-specific; loading a foreign entry SIGILLs)."""
    import hashlib
    try:
        with open("/proc/cpuinfo") as f:
            _flags = next((ln for ln in f if ln.startswith("flags")), "")
        return hashlib.sha1(_flags.encode()).hexdigest()[:10]
    except OSError:
        return "generic"


# Module-level so tests that spawn subprocesses (test_launch.py) can point
# them at the same cache dir.
_cpu_key = _compute_cpu_key()


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (golden-GRF NLP oracles, multihost "
             "subprocess, long closed-loop) — the once-per-round full tier")


def pytest_configure(config):
    import jax

    from cheeta_mpc.utils.compile_cache import enable_compile_cache
    platform = os.environ.get("JAX_PLATFORMS") or "cpu"
    jax.config.update("jax_platforms", platform)
    if platform == "cpu":
        jax.config.update("jax_enable_x64", True)
    # Persistent compilation cache: XLA compiles dominate test time on the
    # small CI machine; cache them across runs. The cache dir is keyed by
    # the host CPU's feature set: XLA:CPU AOT executables are
    # machine-specific, and loading an entry produced on a different host
    # SIGILLs/segfaults mid-suite.
    # Only cache genuinely slow compiles: every persistent-cache write calls
    # XLA's executable.serialize(), which has (rarely, non-deterministically)
    # segfaulted mid-suite under the full test load; a 1 s threshold keeps
    # the wins (the multi-second solver compiles) while cutting the number
    # of serialize calls ~10x.
    enable_compile_cache(f"cpu_{_cpu_key}", min_compile_time_secs=1.0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound in-process XLA/jit state: with the full ~160-test suite in one
    process, accumulated compiler state has (reproducibly, only in the full
    run — any half passes) segfaulted XLA:CPU mid-compile around the ~90th
    test. Clearing the in-memory caches between modules keeps the process
    small; compiled artifacts reload from the persistent disk cache."""
    yield
    import jax
    jax.clear_caches()


def pytest_collection_modifyitems(config, items):
    """Default run excludes the ``slow`` tier; ``--runslow`` restores it."""
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow tier: run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
