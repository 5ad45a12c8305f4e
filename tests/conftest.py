"""Test configuration.

By default everything runs on a virtual 8-device CPU mesh, so the
multi-device sharding paths are exercised without accelerators (same code
path as several cards; see SURVEY.md §4 item 5) and Pallas kernels run in
the interpreter. Tests marked ``gpu`` need a card: run them on a machine
with one as

    RAYTRACE2_TEST_PLATFORM=gpu python -m pytest -m gpu tests/

Whether a card exists is decided inside the ``gpu`` fixture, never while a
module is imported.
"""

import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLATFORM = os.environ.get("RAYTRACE2_TEST_PLATFORM", "cpu")

flags = os.environ.get("XLA_FLAGS", "")
if PLATFORM == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402
import jax  # noqa: E402

if PLATFORM == "cpu":
    # pytest's own startup may import jax (via a plugin) before this file
    # runs, so the env var alone can be read too late: pin the platform
    # through the config API as well (allowed before first backend use).
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", (
        f"tests must run on the virtual CPU mesh, got {jax.default_backend()}"
    )
    # Device-count check only when WE set the flag — a pre-existing
    # xla_force_host_platform_device_count is deliberately respected
    # (sharding tests adapt to jax.device_count()).
    if "xla_force_host_platform_device_count" not in flags:
        assert len(jax.devices()) == 8, (
            f"expected the 8-device virtual mesh, got x{len(jax.devices())}"
        )

# Persistent compilation cache: the suite's cost is dominated by jit
# compiles. JAX_COMPILATION_CACHE_DIR wins when set; otherwise a fixed
# directory of the checkout, apart from the program's own .jax_cache/.
jax.config.update(
    "jax_compilation_cache_dir",
    os.environ.get("JAX_COMPILATION_CACHE_DIR")
    or os.path.join(REPO, f".jax_cache_{PLATFORM}"),
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

DATA_DIR = os.path.join(REPO, "data")


@pytest.fixture(scope="session")
def data_dir():
    return DATA_DIR


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    cards = [d for d in jax.devices() if d.platform == "gpu"]
    if not cards:
        pytest.skip("needs a GPU (RAYTRACE2_TEST_PLATFORM=gpu on a machine "
                    "with one)")
    return cards[0]
