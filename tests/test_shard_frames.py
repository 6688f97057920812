"""Frame-parallel sharded brick engine (parallel/shard_frames.py) on the
8-virtual-device CPU mesh: bit-parity with the single-chip brick engine,
exchange-budget sizing/overflow growth, and partial-window coverage."""

import numpy as np
import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.parallel.shard import make_mesh
from sonar_3d_reconstruction_tpu.parallel.shard_frames import (
    default_xchg_budget,
    map_ping_sequence_sharded_frames,
)
from sonar_3d_reconstruction_tpu.pipeline import map_ping_sequence

from test_brick_grid import brick_state_to_dict
from test_shard_brick import make_seq, sharded_brick_to_dict


def test_sharded_frames_matches_single_chip(small_cfg):
    """window == mesh size (one frame per source shard): the exchanged
    records reproduce the single-chip brick map bit-for-bit in float64 —
    voxels, log-odds, bounds, and per-ping stats."""
    from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
        sharded_brick_bounds,
    )

    cfg = small_cfg
    images, positions, quats = make_seq(cfg, 16, seed=940)
    mesh = make_mesh()

    sh, sstats = map_ping_sequence_sharded_frames(
        images, positions, quats, cfg, mesh=mesh, dtype=jnp.float64,
        window=8, local_capacity=1 << 10,
    )
    single, dstats = map_ping_sequence(
        images, positions, quats, cfg, backend="brick", dtype=jnp.float64,
        window=8,
    )
    a = sharded_brick_to_dict(sh)
    b = brick_state_to_dict(single)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k
    smin, smax = sharded_brick_bounds(sh)
    np.testing.assert_array_equal(smin, np.asarray(single.min_bounds))
    np.testing.assert_array_equal(smax, np.asarray(single.max_bounds))
    for k in ("num_occupied", "num_free", "num_candidates"):
        np.testing.assert_array_equal(
            np.asarray(sstats[k]), np.asarray(dstats[k]), err_msg=k
        )
    assert int(np.asarray(sh.used).sum()) == len(a)


def test_sharded_frames_partial_window_and_idle_shards(small_cfg):
    """window < mesh size leaves source shards frameless, and a trailing
    partial window leaves frames inactive — both must be exact."""
    cfg = small_cfg
    images, positions, quats = make_seq(cfg, 7, seed=950)  # 7 = 4 + 3
    mesh = make_mesh()

    sh, _ = map_ping_sequence_sharded_frames(
        images, positions, quats, cfg, mesh=mesh, dtype=jnp.float64,
        window=4, local_capacity=1 << 10,
    )
    single, _ = map_ping_sequence(
        images, positions, quats, cfg, backend="brick", dtype=jnp.float64,
        window=4,
    )
    a = sharded_brick_to_dict(sh)
    b = brick_state_to_dict(single)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k


def test_sharded_frames_xchg_budget_growth(small_cfg):
    """A deliberately tiny exchange block budget must overflow, grow, and
    replay to the exact single-chip map; the reported xchg_n_max then
    sizes a snug budget that runs without growth."""
    cfg = small_cfg
    images, positions, quats = make_seq(cfg, 8, seed=960)
    mesh = make_mesh()

    ref, _ = map_ping_sequence(
        images, positions, quats, cfg, backend="brick", dtype=jnp.float64,
        window=4,
    )
    b = brick_state_to_dict(ref)

    sh, stats = map_ping_sequence_sharded_frames(
        images, positions, quats, cfg, mesh=mesh, dtype=jnp.float64,
        window=4, local_capacity=1 << 10, xchg_budget=8,
    )
    a = sharded_brick_to_dict(sh)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k

    # snug budget from the measured requirement: no growth, same map
    need = int(np.asarray(stats["xchg_n_max"]).max())
    assert need > 8  # the tiny budget really was the binding constraint
    sh2, stats2 = map_ping_sequence_sharded_frames(
        images, positions, quats, cfg, mesh=mesh, dtype=jnp.float64,
        window=4, local_capacity=1 << 10, xchg_budget=need,
    )
    assert not np.asarray(stats2["xchg_overflow"]).any()
    c = sharded_brick_to_dict(sh2)
    assert c.keys() == b.keys()
    for k in c:
        assert c[k] == b[k], k


def test_sharded_frames_wide_and_row_modes_match(small_cfg):
    """The wide two-word fallback (use_boxes=False) and the compact
    row-structured dense mode both reproduce the default compact engine
    bit-for-bit."""
    cfg = small_cfg
    images, positions, quats = make_seq(cfg, 8, seed=975)
    mesh = make_mesh()

    base, bstats = map_ping_sequence_sharded_frames(
        images, positions, quats, cfg, mesh=mesh, dtype=jnp.float64,
        window=4, local_capacity=1 << 10,
    )
    want = sharded_brick_to_dict(base)

    wide, _ = map_ping_sequence_sharded_frames(
        images, positions, quats, cfg, mesh=mesh, dtype=jnp.float64,
        window=4, local_capacity=1 << 10, use_boxes=False,
    )
    got = sharded_brick_to_dict(wide)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == want[k], ("wide", k)

    for mode in ("row", "bfv"):
        alt, _ = map_ping_sequence_sharded_frames(
            images, positions, quats, cfg, mesh=mesh, dtype=jnp.float64,
            window=4, local_capacity=1 << 10, dense_mode=mode,
        )
        got = sharded_brick_to_dict(alt)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == want[k], (mode, k)

    # a deliberately tiny row-mode vox budget must GROW (its truncated
    # brick list once misreported as fatal range_fail) to the exact map
    tiny, _ = map_ping_sequence_sharded_frames(
        images, positions, quats, cfg, mesh=mesh, dtype=jnp.float64,
        window=4, local_capacity=1 << 10, dense_mode="row", vox_budget=128,
    )
    got = sharded_brick_to_dict(tiny)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == want[k], ("tiny-vox", k)


def test_sharded_frames_auto_wide_fallback_on_huge_extents(small_cfg):
    """A survey whose per-window extent cannot fit the u32 box budget
    must AUTOMATICALLY fall back to the wide two-word engine (boxes
    None) and still match the single-chip map bit-for-bit."""
    cfg = small_cfg
    images, positions, quats = make_seq(cfg, 4, seed=980)
    # scatter the window's poses over ~200 m: per-axis box bits blow the
    # 31-bit budget, but every key stays in the GLOBAL packable range
    positions = positions + np.array(
        [[0.0, 0.0, 0.0], [70.0, 0.0, 0.0], [0.0, 70.0, 0.0],
         [0.0, 0.0, 70.0]]
    )
    mesh = make_mesh()

    eff = {}
    sh, _ = map_ping_sequence_sharded_frames(
        images, positions, quats, cfg, mesh=mesh, dtype=jnp.float64,
        window=4, local_capacity=1 << 10, effective=eff,
    )
    assert eff["box_min_bits"] is None  # the compact gate refused

    single, _ = map_ping_sequence(
        images, positions, quats, cfg, backend="brick", dtype=jnp.float64,
        window=4,
    )
    a = sharded_brick_to_dict(sh)
    b = brick_state_to_dict(single)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k


def test_default_xchg_budget_scales_inversely_with_shards():
    assert default_xchg_budget(96000, 8) >= 2 * 96000 // 8
    assert default_xchg_budget(96000, 8) < 96000
    assert default_xchg_budget(512, 8) == 1024  # floor
