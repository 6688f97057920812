"""Multi-host DCN decomposition: per-segment records + ordered apply must be
bit-identical to one-shot sequence mapping."""

import numpy as np
import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.grid.hash import init_hash_grid
from sonar_3d_reconstruction_tpu.parallel.multihost import (
    apply_record_segments,
    records_for_segment,
)
from sonar_3d_reconstruction_tpu.pipeline import map_ping_sequence

from conftest import circular_trajectory, synthetic_ping
from test_pipeline import hash_state_to_dict


def test_segmented_records_match_one_shot(small_cfg):
    cfg = small_cfg
    n = 9
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=500 + i)
         for i in range(n)]
    )
    positions, quats = circular_trajectory(n, radius=0.7)

    one_shot, _ = map_ping_sequence(
        images, positions, quats, cfg, initial_capacity=1 << 16,
        dtype=jnp.float64,
    )

    # "three hosts" compute records for disjoint ordered segments
    cuts = [(0, 4), (4, 6), (6, 9)]
    segments = [
        records_for_segment(
            images[a:b], positions[a:b], quats[a:b], cfg, dtype=jnp.float64,
        )
        for a, b in cuts
    ]
    # an empty segment (uneven multi-host split) must be a clean no-op
    segments.insert(
        1,
        records_for_segment(
            images[:0], positions[:0], quats[:0], cfg, dtype=jnp.float64,
        ),
    )
    state = init_hash_grid(1 << 16, jnp.float64)
    state, stats = apply_record_segments(state, segments, cfg, window=3)
    assert len(stats) == n
    assert not any(bool(s["overflowed"]) for s in stats)

    a = hash_state_to_dict(state)
    b = hash_state_to_dict(one_shot)
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) < 1e-12


def _inputs(cfg, n, seed):
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=seed + i)
         for i in range(n)]
    )
    positions, quats = circular_trajectory(n, radius=0.7)
    return images, positions, quats


def test_multihost_wrapper_matches_one_shot(small_cfg):
    """map_ping_sequence_multihost on a happy path: 3-host
    split at non-window boundaries, bit-identical to single-host."""
    from sonar_3d_reconstruction_tpu.parallel.multihost import (
        map_ping_sequence_multihost,
    )

    cfg = small_cfg
    images, positions, quats = _inputs(cfg, 7, seed=520)
    one_shot, _ = map_ping_sequence(
        images, positions, quats, cfg, initial_capacity=1 << 16,
        dtype=jnp.float64,
    )
    st, stats = map_ping_sequence_multihost(
        images, positions, quats, cfg, n_hosts=3, window=3,
        dtype=jnp.float64, initial_capacity=1 << 16,
    )
    assert len(stats) == 7 and all(s is not None for s in stats)
    assert not any(bool(s["overflowed"]) for s in stats)
    a, b = hash_state_to_dict(st), hash_state_to_dict(one_shot)
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) < 1e-12


def test_multihost_capacity_growth_replay(small_cfg):
    """Forced CAPACITY overflow through apply_record_segments: the wrapper
    rehashes 2x and replays from the first failed frame to the exact map."""
    from sonar_3d_reconstruction_tpu.parallel.multihost import (
        map_ping_sequence_multihost,
    )

    cfg = small_cfg
    images, positions, quats = _inputs(cfg, 6, seed=530)
    big, _ = map_ping_sequence_multihost(
        images, positions, quats, cfg, n_hosts=2, window=3,
        dtype=jnp.float64, initial_capacity=1 << 16,
    )
    tiny, stats = map_ping_sequence_multihost(
        images, positions, quats, cfg, n_hosts=2, window=3,
        dtype=jnp.float64, initial_capacity=1 << 7,
    )
    assert tiny.key_hi.shape[0] > (1 << 7)  # growth actually happened
    a, b = hash_state_to_dict(tiny), hash_state_to_dict(big)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k]


def test_multihost_unique_budget_growth_replay(small_cfg):
    """Forced per-frame UNIQUE-budget overflow: the wrapper doubles the
    budget, recomputes every segment's records (what real hosts would do),
    and replays to the exact map with the cause attributed."""
    from sonar_3d_reconstruction_tpu.parallel.multihost import (
        map_ping_sequence_multihost,
        records_for_segment,
    )

    cfg = small_cfg
    images, positions, quats = _inputs(cfg, 5, seed=540)
    # prove the tiny budget actually overflows at the records level
    recs, _ = records_for_segment(
        images[:1], positions[:1], quats[:1], cfg, unique_budget=8,
        dtype=jnp.float64,
    )
    assert int(recs.n_unique[0]) > 8
    big, _ = map_ping_sequence_multihost(
        images, positions, quats, cfg, n_hosts=2, window=3,
        dtype=jnp.float64, initial_capacity=1 << 16,
    )
    grown, stats = map_ping_sequence_multihost(
        images, positions, quats, cfg, n_hosts=2, window=3,
        dtype=jnp.float64, initial_capacity=1 << 16, unique_budget=8,
    )
    assert all(s is not None for s in stats)
    a, b = hash_state_to_dict(grown), hash_state_to_dict(big)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k]


def test_multihost_batch_budget_growth_replay(small_cfg):
    """Forced BATCH-budget overflow in the fold: doubles only the apply
    budget (records reused) and replays to the exact map."""
    from sonar_3d_reconstruction_tpu.parallel.multihost import (
        map_ping_sequence_multihost,
    )

    cfg = small_cfg
    images, positions, quats = _inputs(cfg, 5, seed=550)
    big, _ = map_ping_sequence_multihost(
        images, positions, quats, cfg, n_hosts=2, window=3,
        dtype=jnp.float64, initial_capacity=1 << 16,
    )
    grown, stats = map_ping_sequence_multihost(
        images, positions, quats, cfg, n_hosts=2, window=3,
        dtype=jnp.float64, initial_capacity=1 << 16, batch_budget=16,
    )
    assert all(s is not None for s in stats)
    a, b = hash_state_to_dict(grown), hash_state_to_dict(big)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k]


def test_multihost_brick_backend_matches_one_shot(small_cfg):
    """backend='brick': record segments carry brick-major keys and fold
    into a BrickGridState, bit-identical to the single-host brick engine;
    a tiny initial capacity exercises the brick rehash branch."""
    from sonar_3d_reconstruction_tpu.parallel.multihost import (
        map_ping_sequence_multihost,
    )
    from test_brick_grid import brick_state_to_dict

    cfg = small_cfg
    images, positions, quats = _inputs(cfg, 7, seed=530)
    one_shot, _ = map_ping_sequence(
        images, positions, quats, cfg, backend="brick", dtype=jnp.float64,
        window=3,
    )
    b = brick_state_to_dict(one_shot)

    st, stats = map_ping_sequence_multihost(
        images, positions, quats, cfg, n_hosts=3, window=3,
        dtype=jnp.float64, backend="brick", initial_capacity=1 << 17,
    )
    assert len(stats) == 7 and all(s is not None for s in stats)
    a = brick_state_to_dict(st)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k

    # brick capacity growth: 1<<9 -> 32 bricks forces the rehash branch
    tiny, _ = map_ping_sequence_multihost(
        images, positions, quats, cfg, n_hosts=2, window=3,
        dtype=jnp.float64, backend="brick", initial_capacity=1 << 9,
    )
    c = brick_state_to_dict(tiny)
    assert c.keys() == b.keys()
    for k in c:
        assert c[k] == b[k]


def test_multihost_state_backend_mismatch_raises(small_cfg):
    """Same fail-fast contract as pipeline.map_ping_sequence: a resumed
    brick state under the default backend="hash" would pack hash-major
    record keys but apply them as brick codes — must raise, not corrupt."""
    import pytest

    from sonar_3d_reconstruction_tpu.grid.brick import init_brick_grid
    from sonar_3d_reconstruction_tpu.parallel.multihost import (
        map_ping_sequence_multihost,
    )

    img = synthetic_ping(small_cfg.image_height, small_cfg.image_width)
    positions, quats = circular_trajectory(1)
    with pytest.raises(ValueError, match="does not match backend"):
        map_ping_sequence_multihost(
            img[None], positions, quats, small_cfg,
            state=init_brick_grid(256, jnp.float32),
        )
