"""Brick window apply structures (grid/brick.apply_brick_records_compact
``dense_mode``): ``bfv`` — the library and benchmark default — is
bit-identical to ``scalar``, agrees with the golden oracle, keeps the overflow
contract, and matches a NumPy reconstruction of the window apply on
seeded random record patterns.  Unknown modes are refused."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.config import MapperConfig
from sonar_3d_reconstruction_tpu.golden import GoldenMapper
from sonar_3d_reconstruction_tpu.grid.brick import (
    DENSE_MODES,
    apply_brick_records_compact,
    init_brick_grid,
    touched_voxels_brick,
)
from sonar_3d_reconstruction_tpu.ops.backproject import build_fan_tables
from sonar_3d_reconstruction_tpu.ops.dedup import CompactRecords
from sonar_3d_reconstruction_tpu.ops.logodds import finalize_voxel_updates
from sonar_3d_reconstruction_tpu.ops.packing import (
    EMPTY32,
    compute_window_boxes,
    pack_box_keys,
)
from sonar_3d_reconstruction_tpu.ops.records import FrameAux
from sonar_3d_reconstruction_tpu.pipeline import (
    batched_sonar_to_world,
    scan_pings_brick,
)

from test_brick_grid import brick_state_to_dict
from test_shard_brick import make_seq

STAT_KEYS = (
    "num_occupied", "num_free", "num_candidates", "overflowed",
    "batch_overflow", "batch_n_unique", "batch_n_bricks", "batch_n_lanes",
)


def _run(cfg, images, positions, quats, dense_mode, dtype, window=4,
         brick_budget=2048):
    tables = build_fan_tables(cfg, cfg.image_height, cfg.image_width)
    T = batched_sonar_to_world(positions, quats, cfg)
    w = min(window, len(images))
    boxes = compute_window_boxes(
        T[:, :3, 3], cfg.max_range, cfg.voxel_resolution, w, 2,
        frame_bits=max(1, (w - 1).bit_length()),
    )
    assert boxes is not None  # dense_mode acts on the compact path only
    return scan_pings_brick(
        init_brick_grid(1 << 13, dtype), jnp.asarray(images),
        jnp.asarray(T, dtype), tables=tables, cfg=cfg, dtype=dtype,
        window=window, brick_budget=brick_budget, boxes=boxes,
        dense_mode=dense_mode,
    )


def _assert_bfv_matches_scalar(cfg, images, positions, quats, dtype,
                               window=4, brick_budget=2048):
    ref_st, ref_stats = _run(cfg, images, positions, quats, "scalar", dtype,
                             window, brick_budget)
    got_st, got_stats = _run(cfg, images, positions, quats, "bfv", dtype,
                             window, brick_budget)
    assert not np.asarray(ref_stats["overflowed"]).any()
    a, b = brick_state_to_dict(got_st), brick_state_to_dict(ref_st)
    assert a.keys() == b.keys(), (len(a), len(b))
    diff = [k for k in a if a[k] != b[k]]
    assert not diff, (len(diff), diff[:3])
    for k in STAT_KEYS:
        np.testing.assert_array_equal(
            np.asarray(got_stats[k]), np.asarray(ref_stats[k]), err_msg=k
        )
    return a, got_stats


def test_bfv_matches_scalar_and_golden_f64(small_cfg):
    """Bit-exact in float64, including a half-empty tail window (6 pings at
    window 4: empty bricks and masked frames), and equal to the golden
    oracle to the last bits (it sums emissions one by one; the device
    multiplies exact integer counts by the per-type log-odds)."""
    images, positions, quats = make_seq(small_cfg, 6, seed=51)
    got, stats = _assert_bfv_matches_scalar(
        small_cfg, images, positions, quats, jnp.float64
    )
    g = GoldenMapper(small_cfg)
    for i, (img, p, q) in enumerate(zip(images, positions, quats)):
        gs = g.process_ping(img, p, q)
        assert int(stats["num_occupied"][i]) == gs["num_occupied"]
        assert int(stats["num_free"][i]) == gs["num_free"]
    assert got.keys() == g.map.log_odds.keys()
    for k, v in g.map.log_odds.items():
        assert abs(got[k] - v) <= 1e-12, (k, got[k], v)


def test_bfv_matches_scalar_f32(small_cfg):
    """Bit-exact in float32 (the deployment dtype)."""
    images, positions, quats = make_seq(small_cfg, 4, seed=52)
    _assert_bfv_matches_scalar(small_cfg, images, positions, quats,
                               jnp.float32)


def test_bfv_brick_budget_off_power_of_two(small_cfg):
    """A brick budget that is no power of two, at window 2."""
    images, positions, quats = make_seq(small_cfg, 2, seed=53)
    _assert_bfv_matches_scalar(small_cfg, images, positions, quats,
                               jnp.float64, window=2, brick_budget=1000)


def test_bfv_overflow_contract_matches_scalar(small_cfg):
    """A deliberately tiny brick budget rejects the window all-or-nothing
    with the same growable batch_overflow cause in both modes
    (grid/brick.py module docstring)."""
    images, positions, quats = make_seq(small_cfg, 4, seed=54)
    ref_st, ref_stats = _run(small_cfg, images, positions, quats, "scalar",
                             jnp.float64, brick_budget=8)
    got_st, got_stats = _run(small_cfg, images, positions, quats, "bfv",
                             jnp.float64, brick_budget=8)
    assert np.asarray(ref_stats["overflowed"]).any()
    for k in ("overflowed", "batch_overflow"):
        np.testing.assert_array_equal(
            np.asarray(got_stats[k]), np.asarray(ref_stats[k]), err_msg=k
        )
    assert bool(got_st.poisoned) and bool(ref_st.poisoned)
    assert brick_state_to_dict(got_st) == brick_state_to_dict(ref_st)


# ---------------------------------------------------------------------------
# Seeded fuzz of the window apply against a NumPy reconstruction
# ---------------------------------------------------------------------------

_BOX_MIN = np.array([-8, 4, 12], np.int32)  # brick-aligned (4x4x4 bricks)
_BOX_BITS = (2, 2, 2)  # 4 bricks per axis: 16^3 candidate voxels

_apply = jax.jit(
    apply_brick_records_compact,
    static_argnames=("cfg", "box_bits", "brick_budget", "dense_mode"),
)


def _random_window(rng, B, U):
    """B frames of <= U unique voxel records each, EMPTY lanes scattered
    among them; counts up to 0xFFFF in one frame (the packing limit)."""
    keys = np.full((B, U), EMPTY32, np.uint32)
    pays = np.zeros((B, U), np.uint32)
    vox = []
    for f in range(B):
        n = int(rng.integers(0, U + 1))
        cells = rng.choice(16 ** 3, size=n, replace=False)
        rel = np.stack([cells // 256, (cells // 16) % 16, cells % 16], -1)
        cnt = rng.integers(1, 0xFFFF if f == 0 else 40, size=n)
        occ = np.minimum(rng.integers(0, 60, size=n), cnt)
        lanes = np.sort(rng.choice(U, size=n, replace=False))
        k, _ = pack_box_keys(jnp.asarray(rel + _BOX_MIN, jnp.int32),
                             jnp.asarray(_BOX_MIN), _BOX_BITS, 2)
        keys[f, lanes] = np.asarray(k)
        pays[f, lanes] = (cnt.astype(np.uint32) << 16) | occ.astype(np.uint32)
        vox.append({tuple(int(v) for v in r + _BOX_MIN): (int(c), int(o))
                    for r, c, o in zip(rel, cnt, occ)})
    return keys, pays, vox


def _records(keys, pays, dtype):
    valid = keys != EMPTY32
    B = keys.shape[0]
    rec = CompactRecords(
        key=jnp.asarray(keys), payload=jnp.asarray(pays),
        valid=jnp.asarray(valid),
        n_unique=jnp.asarray(valid.sum(axis=1), jnp.int32),
        pack_fail=jnp.zeros((B,), bool),
    )
    aux = FrameAux(
        cmin=jnp.zeros((B, 3), dtype), cmax=jnp.zeros((B, 3), dtype),
        range_fail=jnp.zeros((B,), bool),
        n_valid=jnp.asarray(valid.sum(axis=1), jnp.int32),
    )
    return rec, aux


def _numpy_window(cfg, current, vox, dtype):
    """Reference: frames applied one at a time to per-voxel log-odds."""
    touched = sorted(set(current) | {k for fr in vox for k in fr})
    v = jnp.asarray([current.get(k, 0.0) for k in touched], dtype)
    occL = np.asarray(cfg.log_odds_occupied, dtype)
    freL = np.asarray(cfg.log_odds_free, dtype)
    for fr in vox:
        cnt = np.asarray([fr.get(k, (0, 0))[0] for k in touched], dtype)
        occ = np.asarray([fr.get(k, (0, 0))[1] for k in touched], dtype)
        v = finalize_voxel_updates(
            v, jnp.asarray(occ * occL + (cnt - occ) * freL),
            jnp.asarray(cnt), jnp.asarray(occ > 0), cfg,
        )
    return dict(zip(touched, np.asarray(v).tolist()))


@pytest.mark.parametrize("dense_mode", DENSE_MODES)
@pytest.mark.parametrize("seed", [11, 12])
def test_window_apply_fuzz_vs_numpy(dense_mode, seed):
    cfg = MapperConfig()
    dtype = jnp.float64
    rng = np.random.default_rng(seed)
    B, U = 4, 96
    state = init_brick_grid(1 << 10, dtype)
    want = {}
    for _ in range(2):  # the second window updates a non-empty map
        keys, pays, vox = _random_window(rng, B, U)
        rec, aux = _records(keys, pays, dtype)
        state, stats = _apply(
            state, rec, aux, cfg=cfg, box_min=jnp.asarray(_BOX_MIN),
            box_bits=_BOX_BITS, brick_budget=64, dense_mode=dense_mode,
        )
        assert not np.asarray(stats["overflowed"]).any()
        np.testing.assert_array_equal(
            np.asarray(stats["num_occupied"]),
            [sum(o > 0 for _, o in fr.values()) for fr in vox],
        )
        np.testing.assert_array_equal(
            np.asarray(stats["num_free"]),
            [sum(o == 0 for _, o in fr.values()) for fr in vox],
        )
        want = _numpy_window(cfg, want, vox, dtype)
    k, lo = touched_voxels_brick(state)
    got = {tuple(int(x) for x in kk): float(v) for kk, v in zip(k, lo)}
    assert got.keys() == want.keys()
    diff = [kk for kk in got if got[kk] != want[kk]]
    assert not diff, (len(diff), diff[:3])


# ---------------------------------------------------------------------------
# Mode names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "mode", ["pallas", "pallas-tb16", "pallas-tb16-raw", "BFV", "bfv ", ""]
)
def test_unknown_dense_mode_raises(mode, small_cfg):
    tables = build_fan_tables(small_cfg, small_cfg.image_height,
                              small_cfg.image_width)
    images = jnp.zeros((2, small_cfg.image_height, small_cfg.image_width),
                       jnp.uint8)
    with pytest.raises(ValueError, match="dense_mode"):
        scan_pings_brick(
            init_brick_grid(1 << 8), images, jnp.zeros((2, 4, 4)),
            tables=tables, cfg=small_cfg, dense_mode=mode,
        )


def test_bench_default_mode_and_plan():
    """The benchmark's default dense mode is a known one, and the
    committed plan names no mode that no longer exists."""
    import bench

    assert bench.DEFAULT_DENSE_MODE in DENSE_MODES
    with open(bench.PLAN_PATH) as f:
        text = f.read()
    assert "pallas" not in text
    assert json.loads(text)
