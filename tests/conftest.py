import os

# Tests run on the CPU backend with a virtual 8-device mesh so sharding logic
# is exercised without TPU hardware. Must be set before importing jax.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
# persistent compilation cache: repeat test runs skip XLA compiles
_cache_dir = os.path.join(os.path.dirname(__file__), "..", ".jax_cache")
jax.config.update("jax_compilation_cache_dir", os.path.abspath(_cache_dir))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption("--run-slow", action="store_true", default=False)
    parser.addoption("--run-heavy", action="store_true", default=False)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long golden runs (--run-slow)")
    config.addinivalue_line(
        "markers",
        "heavy: multi-minute compile/e2e tests (--run-heavy; "
        "make test-heavy). The default tier is the <5-min smoke suite.")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")


def pytest_collection_modifyitems(config, items):
    run_slow = config.getoption("--run-slow")
    run_heavy = config.getoption("--run-heavy") or run_slow
    skip_slow = pytest.mark.skip(reason="slow; use --run-slow")
    skip_heavy = pytest.mark.skip(reason="heavy; use --run-heavy")
    for item in items:
        if "slow" in item.keywords and not run_slow:
            item.add_marker(skip_slow)
        elif "heavy" in item.keywords and not run_heavy:
            item.add_marker(skip_heavy)
