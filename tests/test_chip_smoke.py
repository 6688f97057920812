"""chip_smoke.py: it refuses a host without a GPU or without the repository,
its map comparison catches a single wrong voxel, and every phase runs end
to end at a tiny size on the CPU backend (the card itself is reached only by
running the script on a GPU machine)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_result(out):
    return not any('"ok": true' in ln for ln in out.stdout.splitlines())


def test_refuses_cpu_only_host():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert _no_result(out), out.stdout
    assert "not a GPU" in out.stderr


def test_refuses_to_run_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")], env=env,
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert _no_result(out), out.stdout
    assert "phase 'import' failed" in out.stderr


def _map(n=50, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.choice(200_000, size=n, replace=False)
    keys = np.stack([keys // 10_000 - 10, (keys // 100) % 100 - 50,
                     keys % 100], axis=-1)
    return keys.astype(np.int32), rng.normal(size=n).astype(np.float32)


def _value_off(keys, lo):
    lo = lo.copy()
    lo[17] += 2e-5
    return keys, lo


def _key_moved(keys, lo):
    keys = keys.copy()
    keys[3, 2] = 10_000
    return keys, lo


def _key_dropped(keys, lo):
    return keys[1:], lo[1:]


def _key_repeated(keys, lo):
    return np.concatenate([keys, keys[:1]]), np.concatenate([lo, lo[:1]])


def _nan_value(keys, lo):
    lo = lo.copy()
    lo[5] = np.nan
    return keys, lo


@pytest.mark.parametrize("corrupt", [
    _value_off, _key_moved, _key_dropped, _key_repeated, _nan_value,
])
def test_compare_maps_flags_one_voxel(corrupt):
    keys, lo = _map()
    ok, summary = chip_smoke.compare_maps((keys, lo), (keys, lo), atol=1e-5)
    assert ok and summary["max_abs_diff"] == 0.0
    # order must not matter
    perm = np.random.default_rng(1).permutation(len(lo))
    ok, _ = chip_smoke.compare_maps((keys, lo), (keys[perm], lo[perm]),
                                    atol=0.0)
    assert ok
    ok, summary = chip_smoke.compare_maps((keys, lo), corrupt(keys, lo),
                                          atol=1e-5)
    assert not ok, summary


def test_compare_maps_probability_space():
    keys, lo = _map()
    lo2 = lo.copy()
    lo2[0] += 1e-4  # moves the probability by at most 2.5e-5
    ok_lo, _ = chip_smoke.compare_maps((keys, lo), (keys, lo2), atol=1e-5)
    ok_p, s = chip_smoke.compare_maps((keys, lo), (keys, lo2), atol=1e-4,
                                      space="probability")
    assert not ok_lo and ok_p and s["space"] == "probability"


def test_golden_parity_phase_on_cpu():
    cfg = chip_smoke.parity_config()
    chip_smoke.golden_parity(cfg, *chip_smoke.small_survey(cfg, 3, seed=5))


def _tiny_cfg():
    from sonar_3d_reconstruction_tpu.config import MapperConfig

    return MapperConfig(image_width=48, image_height=80, max_range=5.0,
                        voxel_resolution=0.1)


def test_full_width_library_phase_on_cpu(capsys):
    """The phase's control flow at a tiny size: the CPU backend stands in
    for the card and is compared with itself."""
    cfg = _tiny_cfg()
    images, positions, quats = chip_smoke.small_survey(cfg, 6, seed=3)
    timings = chip_smoke.full_width_library(
        cfg, images, positions, quats, n_hash=3, window=4, card="cpu",
    )
    for mode in ("bfv", "scalar"):
        assert timings[mode]["ms_per_ping"] > 0
        assert timings[mode]["memory_analysis"] is not None
    assert "equal the CPU backend's" in capsys.readouterr().out


def test_cli_phase_on_cpu(tmp_path):
    chip_smoke.cli_user_path(
        str(tmp_path), n_pings=6, range_bins=60, bearing_bins=40, seed=2,
        params=["voxel_resolution=0.1", "max_range=5.0"],
    )


def test_four_card_phase_on_virtual_cpu_mesh():
    cfg = _tiny_cfg()
    images, positions, quats = chip_smoke.small_survey(cfg, 8, seed=4)
    chip_smoke.four_card_phase(cfg, images, positions, quats,
                               jax.devices()[:4], window=4)

