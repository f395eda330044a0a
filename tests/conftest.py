"""Test harness config: JAX on the CPU with 8 virtual devices, set BEFORE
jax imports, so pjit/shard_map multi-device paths are exercised without
accelerators (SURVEY.md §4.3).

Tests marked `gpu` need the card; they take the `gpu_device` fixture, which
skips them when JAX's default backend is not a GPU. Run them on a machine
with one: `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q`."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

from jiao_liao_asr.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

# Persistent XLA compile cache: the suite is compile-bound (hundreds of
# small jit compiles), and the cache makes warm reruns skip nearly all of
# it. Safe across tests — the cache key hashes the computation, platform
# and device layout.
enable_compile_cache(min_compile_secs=0.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Default runs skip @pytest.mark.heavy (the multi-minute XLA:CPU mesh
    compiles and subprocess multihost runs) so the edit-test loop stays
    fast. They are NOT optional: run `JL_HEAVY=1 pytest tests/ -q` (or
    `-m heavy`) before committing parallel/train changes."""
    if os.environ.get("JL_HEAVY"):
        return
    if config.getoption("-m") and "heavy" in config.getoption("-m"):
        return
    skip = pytest.mark.skip(
        reason="heavy (compile-minutes): set JL_HEAVY=1 or -m heavy to run"
    )
    for item in items:
        if "heavy" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu_device():
    """The GPU a `gpu`-marked test runs on; skips the test without one."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda pytest tests/ -m gpu")
    return jax.devices()[0]


def pytest_configure(config):
    """Build the C++ host libs BEFORE collection so test_flac/test_bpe/...
    run against real native code on a fresh checkout (their module-level
    skipifs see the built libs; no silent skips). Fails LOUDLY if the
    toolchain is present but the build breaks; only a missing compiler
    leaves the libs absent (and those tests skipped)."""
    import shutil
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        return  # no toolchain: native tests fall back to their own skips
    # serialize across pytest-xdist workers: every worker runs this hook,
    # and concurrent `make` invocations race on the .so outputs
    import fcntl

    native_dir = os.path.join(root, "native")
    with open(os.path.join(native_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        r = subprocess.run(
            ["make", "-C", native_dir], capture_output=True, text=True
        )
    if r.returncode != 0:
        raise pytest.UsageError(
            f"native build failed (rc={r.returncode}):\n{r.stdout}\n{r.stderr}"
        )


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)


@pytest.fixture(scope="session")
def tiny_wav(rng):
    """1.3 s of deterministic band-limited noise + tone at 16 kHz."""
    t = np.arange(int(16000 * 1.3)) / 16000.0
    wav = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.randn(len(t))
    return wav.astype(np.float32)
