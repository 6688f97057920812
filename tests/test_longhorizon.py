"""Long-horizon full-size float32 parity (SURVEY hard
part 1; BASELINE acceptance bar).

Round 1 proved the 1e-5 probability bar only over 8 pings of 100x64
geometry; the open question was float32 drift across HUNDREDS of
accumulated full-size (500x512) pings.  Two effects can break parity and
must be separated:

1. ACCUMULATION drift — float32 arithmetic in the adaptive/clamped log-odds
   chain diverging from float64 over many updates.  This is what the 1e-5
   bar is about, and what a float64-accumulator fallback would fix.
2. GEOMETRY boundary flips — float32 backprojection placing a candidate
   within ~1 ulp of a voxel boundary so that ``floor`` lands it in the
   neighbor voxel.  That moves a WHOLE update between two voxels (a
   discrete event, probability jump >> 1e-5 on those voxels) and no
   accumulator precision can remove it; it is the float32-geometry
   analogue of the reference's own sensitivity to the last bit of its
   float64 trig.

The acceptance test therefore pins the key assignment (both paths
accumulate the same per-frame records, exactly as a float64-accumulator
deployment would) and asserts the 1e-5 bar on every touched voxel after
200 full-size pings.  A companion test quantifies the geometry-flip rate
of the pure-float32 path and asserts it stays rare.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bench import make_inputs
from sonar_3d_reconstruction_tpu.config import MapperConfig
from sonar_3d_reconstruction_tpu.grid.hash import init_hash_grid
from sonar_3d_reconstruction_tpu.ops.backproject import build_fan_tables
from sonar_3d_reconstruction_tpu.pipeline import (
    batched_sonar_to_world,
    map_ping_sequence,
    scan_pings_hash,
)

N_PINGS = 200


def _voxel_probs(state) -> dict:
    """state -> {voxel key tuple: occupancy probability (float64)}."""
    hi = np.asarray(state.key_hi)
    occ = hi != np.uint32(0xFFFFFFFF)
    keys = np.asarray(state.keys)[occ]
    lo = np.asarray(state.log_odds, np.float64)[occ]
    probs = 1.0 / (1.0 + np.exp(-lo))
    return {tuple(k): p for k, p in zip(keys, probs)}


@pytest.mark.slow
def test_f32_accumulation_parity_200_fullsize_pings():
    """float32 log-odds accumulation stays within the 1e-5 probability bar
    of float64 over 200 full-size pings.

    The per-frame unique records (voxel key, candidate count, occupied
    count) are integer-valued and dtype-independent; the batched apply
    casts them into the STATE's dtype.  Feeding the identical float32
    records into a float32 table and a float64 table therefore isolates
    exactly the arithmetic of the adaptive/clamped update chain — the
    float64-accumulator deployment SURVEY hard part 1 anticipates."""
    from sonar_3d_reconstruction_tpu.grid.hash import (
        default_batch_budget,
        default_unique_budget,
    )
    from sonar_3d_reconstruction_tpu.pipeline import (
        _apply_batched,
        _records_window,
    )

    cfg = MapperConfig()  # full 500x512, 5 cm voxels
    window = 8
    images, positions, quats = make_inputs(cfg, N_PINGS, seed=1)
    tables = build_fan_tables(cfg, cfg.image_height, cfg.image_width)
    T32 = jnp.asarray(
        batched_sonar_to_world(positions, quats, cfg), jnp.float32
    )
    images_dev = jnp.asarray(images)
    ub = default_unique_budget(tables.candidates_per_ping(cfg.occupied_window))
    bb = default_batch_budget(window, ub)

    st32 = init_hash_grid(1 << 22, jnp.float32)
    st64 = init_hash_grid(1 << 22, jnp.float64)
    start, stop = jnp.int32(0), jnp.int32(N_PINGS)
    for w in range(0, N_PINGS, window):
        recs, auxs = _records_window(
            images_dev, T32, jnp.int32(w), start, stop,
            tables=tables, cfg=cfg, dtype=jnp.float32,
            unique_budget=ub, window=window,
        )
        st32, s32 = _apply_batched(st32, recs, auxs, cfg=cfg, batch_budget=bb)
        st64, s64 = _apply_batched(st64, recs, auxs, cfg=cfg, batch_budget=bb)
        assert not bool(np.asarray(s32["overflowed"]).any())
        assert not bool(np.asarray(s64["overflowed"]).any())

    p32 = _voxel_probs(st32)
    p64 = _voxel_probs(st64)
    # identical records -> identical voxel sets, by construction
    assert set(p32) == set(p64)
    assert len(p32) > 500_000  # a real long-horizon map, not a toy

    diffs = np.array([abs(p32[k] - p64[k]) for k in p32])
    # drift accumulates sub-linearly (each voxel sees <= 200 clamped
    # updates); the BASELINE bar is 1e-5 absolute on probabilities
    assert diffs.max() <= 1e-5, (
        f"float32 accumulation drift {diffs.max():.2e} over {N_PINGS} "
        f"full-size pings exceeds the 1e-5 acceptance bar "
        f"(p99={np.percentile(diffs, 99):.2e})"
    )


@pytest.mark.slow
def test_f32_geometry_flip_rate_is_rare():
    """Pure-float32 geometry vs float64 geometry: candidates landing within
    ~1 ulp of a voxel boundary flip to the neighbor voxel (effect 2 above).
    These are discrete, data-dependent events no accumulator can remove —
    assert they stay rare and everything else meets the bar, documenting
    the expected behavior of full-float32 deployments."""
    cfg = MapperConfig()
    images, positions, quats = make_inputs(cfg, 64, seed=2)
    images_dev = jnp.asarray(images)
    tables = build_fan_tables(cfg, cfg.image_height, cfg.image_width)
    T = batched_sonar_to_world(positions, quats, cfg)

    st32 = init_hash_grid(1 << 22, jnp.float32)
    st32, _ = scan_pings_hash(
        st32, images_dev, jnp.asarray(T, jnp.float32),
        tables=tables, cfg=cfg, dtype=jnp.float32, window=8,
    )
    st64 = init_hash_grid(1 << 22, jnp.float64)
    st64, _ = scan_pings_hash(
        st64, images_dev, jnp.asarray(T, jnp.float64),
        tables=tables, cfg=cfg, dtype=jnp.float64, window=8,
    )
    p32 = _voxel_probs(st32)
    p64 = _voxel_probs(st64)
    common = set(p32) & set(p64)
    sym_diff = (len(p32) - len(common)) + (len(p64) - len(common))

    diffs = np.array([abs(p32[k] - p64[k]) for k in common])
    n_over = int((diffs > 1e-5).sum())
    # flipped candidates show up as set differences or as pairs of voxels
    # whose update mix changed; both must be a tiny fraction of the map
    assert sym_diff / max(1, len(common)) < 2e-3, sym_diff
    assert n_over / max(1, len(common)) < 2e-3, n_over
    # and the bulk of the map still meets the bar outright
    assert np.percentile(diffs, 99.5) <= 1e-5
