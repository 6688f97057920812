"""Test configuration: virtual 8-device CPU mesh + float64 parity mode.

All tests run on CPU (JAX_PLATFORMS=cpu) with 8 virtual devices so multi-device
sharding is exercised without accelerator hardware, and with x64 enabled so
the device path can be compared against the float64 NumPy golden oracle at
the 1e-5 parity bar (it lands far below it).  CPU processes keep no
persistent compilation cache (utils/compile_cache.py).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from sonar_3d_reconstruction_tpu.config import MapperConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_compiler_state():
    """Reset jit/compiler caches between test modules.

    One long pytest process accumulates hundreds of compiled XLA:CPU
    executables; past ~140 tests, serializing the next persistent-cache
    entry segfaulted inside XLA (observed repeatedly at the same suite
    position, never in standalone/module runs).  Clearing per module
    bounds that in-process state."""
    yield
    jax.clear_caches()


@pytest.fixture
def small_cfg() -> MapperConfig:
    """Small-geometry config keeping the golden oracle fast in tests."""
    return MapperConfig(
        image_width=64,
        image_height=100,
        max_range=5.0,
        min_range=0.5,
        voxel_resolution=0.1,
        intensity_threshold=30,
    )


def synthetic_ping(
    range_bins: int, bearing_bins: int, seed: int = 0, density: float = 0.02
) -> np.ndarray:
    """Synthetic polar sonar image: sparse bright blobs over low noise, in the
    spirit of the reference self-test image (3d_mapper.py:667-669) but
    randomized for coverage."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 20, size=(range_bins, bearing_bins), dtype=np.int64)
    n_blobs = max(1, int(density * range_bins * bearing_bins / 50))
    for _ in range(n_blobs):
        r0 = int(rng.integers(0, max(1, range_bins - 10)))
        b0 = int(rng.integers(0, max(1, bearing_bins - 8)))
        img[r0 : r0 + int(rng.integers(2, 10)), b0 : b0 + int(rng.integers(2, 8))] = (
            int(rng.integers(80, 220))
        )
    return img.astype(np.uint8)


def circular_trajectory(n: int, radius: float = 1.0):
    """Positions + yaw-only quaternions along a circle (BASELINE config 3)."""
    ts = np.linspace(0, 2 * np.pi, n, endpoint=False)
    positions = np.stack(
        [radius * np.cos(ts), radius * np.sin(ts), np.zeros(n)], axis=-1
    )
    yaw = ts + np.pi / 2
    quats = np.stack(
        [np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], axis=-1
    )
    return positions, quats
