"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh: sharding/collective tests exercise
the same pjit/shard_map code paths as the multi-device dry run
(`__graft_entry__.dryrun_multichip`).  Tests marked `gpu` need a card;
they run the card's work in a child process (`chip_smoke.py`), and skip
where there is none.

The platform is pinned with `jax.config.update`, which works any time
before the first backend use (JAX_PLATFORMS in os.environ would be read too
late if jax is already imported); XLA_FLAGS is read at backend init, so the
host-device-count flag still takes effect from here.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Full-precision matmuls on every backend: the engine's numerics (DLT solves,
# normal equations) assume f32 accumulation, and tests verify against that.
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_card():
    """Skips unless an NVIDIA card is present (asked of nvidia-smi, so this
    process never opens the card)."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("needs an NVIDIA GPU: no nvidia-smi on this machine")
    probe = subprocess.run([smi, "-L"], capture_output=True, text=True)
    if probe.returncode != 0 or "GPU" not in probe.stdout:
        pytest.skip("needs an NVIDIA GPU: nvidia-smi lists none")
    return probe.stdout.strip()


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu():
    assert jax.default_backend() == "cpu", (
        "tests must run on the virtual CPU mesh, got " + jax.default_backend()
    )
    assert jax.device_count() == 8
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Drop compiled-executable caches between modules: a full-suite run
    accumulates hundreds of jitted programs and the CPU backend has been
    seen to segfault deep into the run (r3, during tracing in module ~25);
    bounding cache growth keeps the suite runnable in one process."""
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# Fast tier: `pytest -m "not slow"`; the full suite takes ~20-25 min on the
# virtual CPU mesh.  Slow tests carry @pytest.mark.slow AT THE TEST SITE
# (whole modules use a module-level `pytestmark`) so new tests must opt in
# explicitly and stale entries can't hide — measured with
# `pytest --durations=50`, anything >= ~5 s belongs in the slow tier.
# ---------------------------------------------------------------------------
