"""Multi-chip sharded map on the 8-virtual-device CPU mesh vs single-chip."""

import numpy as np
import jax
import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.grid.hash import EMPTY
from sonar_3d_reconstruction_tpu.ops.backproject import build_fan_tables
from sonar_3d_reconstruction_tpu.parallel.shard import (
    gather_sharded_state,
    init_sharded_hash_grid,
    make_mesh,
    make_scan_pings_sharded,
    owner_shard,
    scan_pings_sharded,
)
from sonar_3d_reconstruction_tpu.pipeline import (
    batched_sonar_to_world,
    map_ping_sequence,
)

from conftest import circular_trajectory, synthetic_ping


def sharded_to_dict(state):
    keys, lo = gather_sharded_state(state)
    mask = keys[:, 0] != EMPTY
    return {tuple(k): v for k, v in zip(keys[mask], lo[mask])}


def single_to_dict(state):
    keys = np.asarray(state.keys)
    lo = np.asarray(state.log_odds)
    mask = keys[:, 0] != EMPTY
    return {tuple(k): v for k, v in zip(keys[mask], lo[mask])}


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_owner_shard_partition():
    from sonar_3d_reconstruction_tpu.ops.packing import pack_keys

    keys = jnp.asarray(
        np.random.default_rng(0).integers(-100, 100, size=(1000, 3)), jnp.int32
    )
    hi, lo, _ = pack_keys(keys)
    owners = np.asarray(owner_shard(hi, lo, 8))
    assert owners.min() >= 0 and owners.max() < 8
    # roughly uniform: no shard owns more than half
    counts = np.bincount(owners, minlength=8)
    assert counts.max() < 500


def test_sharded_scan_matches_single_chip(small_cfg):
    cfg = small_cfg
    n = 5
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=60 + i)
         for i in range(n)]
    )
    positions, quats = circular_trajectory(n, radius=0.8)
    T = batched_sonar_to_world(positions, quats, cfg)

    mesh = make_mesh()
    tables = build_fan_tables(cfg, cfg.image_height, cfg.image_width)
    st = init_sharded_hash_grid(mesh, local_capacity=1 << 13, dtype=jnp.float64)
    st, stats = scan_pings_sharded(
        st, jnp.asarray(images), jnp.asarray(T, jnp.float64), mesh, tables, cfg,
        dtype=jnp.float64,
    )
    assert not np.asarray(stats["overflowed"]).any()

    single, _ = map_ping_sequence(
        images, positions, quats, cfg, initial_capacity=1 << 14,
        dtype=jnp.float64,
    )
    a, b = sharded_to_dict(st), single_to_dict(single)
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) < 1e-9

    # bounds parity: sharded state must reproduce the single-chip
    # updated-voxel-center bounds (reference 3d_mapper.py:112-115)
    from sonar_3d_reconstruction_tpu.parallel.shard import sharded_bounds

    mn, mx = sharded_bounds(st)
    np.testing.assert_allclose(mn, np.asarray(single.min_bounds), atol=1e-12)
    np.testing.assert_allclose(mx, np.asarray(single.max_bounds), atol=1e-12)
    # and every shard carries the identical (replicated) bounds
    assert (np.asarray(st.min_bounds) == mn).all()
    assert (np.asarray(st.max_bounds) == mx).all()


def test_sharded_overflow_rejects_frame_atomically(small_cfg):
    """With a tiny per-shard capacity the frame must be rejected on EVERY
    shard (poisoned everywhere), leaving the map state untouched."""
    cfg = small_cfg
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=70)]
    )
    positions = np.zeros((1, 3))
    quats = np.array([[0.0, 0.0, 0.0, 1.0]])
    T = batched_sonar_to_world(positions, quats, cfg)

    mesh = make_mesh()
    tables = build_fan_tables(cfg, cfg.image_height, cfg.image_width)
    st = init_sharded_hash_grid(mesh, local_capacity=1 << 7, dtype=jnp.float64)
    st, stats = scan_pings_sharded(
        st, jnp.asarray(images), jnp.asarray(T, jnp.float64), mesh, tables, cfg,
        dtype=jnp.float64,
    )
    assert np.asarray(stats["overflowed"]).all()
    assert np.asarray(st.poisoned).all()
    assert (np.asarray(st.keys) == EMPTY).all()


def test_sharded_replay_start_skips_frames(small_cfg):
    """start=k makes frames < k no-ops (growth-replay contract)."""
    cfg = small_cfg
    n = 4
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=80 + i)
         for i in range(n)]
    )
    positions, quats = circular_trajectory(n)
    T = batched_sonar_to_world(positions, quats, cfg)

    mesh = make_mesh()
    tables = build_fan_tables(cfg, cfg.image_height, cfg.image_width)
    scan = make_scan_pings_sharded(mesh, tables, cfg, dtype=jnp.float64)

    st0 = init_sharded_hash_grid(mesh, local_capacity=1 << 13, dtype=jnp.float64)
    st_skip, _ = scan(
        st0, jnp.asarray(images), jnp.asarray(T, jnp.float64), jnp.int32(2)
    )
    st_tail, _ = scan(
        st0, jnp.asarray(images[2:]), jnp.asarray(T[2:], jnp.float64),
        jnp.int32(0),
    )
    a, b = sharded_to_dict(st_skip), sharded_to_dict(st_tail)
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) < 1e-12


def test_sharded_window_engine_matches_single_chip(small_cfg):
    """The sharded batched-apply window engine must match the single-chip
    window engine (and therefore window=1) bit-for-bit in float64,
    including bounds."""
    from sonar_3d_reconstruction_tpu.parallel.shard import (
        map_ping_sequence_sharded,
        sharded_bounds,
    )

    cfg = small_cfg
    n = 7  # deliberately not a multiple of the window (tail masking)
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=200 + i)
         for i in range(n)]
    )
    positions, quats = circular_trajectory(n, radius=0.8)

    mesh = make_mesh()
    st, stats = map_ping_sequence_sharded(
        images, positions, quats, cfg, mesh=mesh,
        local_capacity=1 << 13, dtype=jnp.float64, window=3,
    )
    assert not np.asarray(stats["overflowed"]).any()

    single, sstats = map_ping_sequence(
        images, positions, quats, cfg, initial_capacity=1 << 14,
        dtype=jnp.float64, window=3,
    )
    a, b = sharded_to_dict(st), single_to_dict(single)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], (k, a[k], b[k])  # bit-for-bit in float64
    mn, mx = sharded_bounds(st)
    np.testing.assert_array_equal(mn, np.asarray(single.min_bounds))
    np.testing.assert_array_equal(mx, np.asarray(single.max_bounds))
    for key in ("num_occupied", "num_free", "num_candidates"):
        np.testing.assert_array_equal(stats[key], sstats[key])


def test_sharded_window_grow_and_replay(small_cfg):
    """map_ping_sequence_sharded with a tiny local capacity must grow and
    replay to the same map as a large-capacity run (window engine)."""
    from sonar_3d_reconstruction_tpu.parallel.shard import (
        map_ping_sequence_sharded,
    )

    cfg = small_cfg
    n = 4
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=230 + i)
         for i in range(n)]
    )
    positions, quats = circular_trajectory(n)

    mesh = make_mesh()
    small, _ = map_ping_sequence_sharded(
        images, positions, quats, cfg, mesh=mesh,
        local_capacity=1 << 7, dtype=jnp.float64, window=2,
    )
    big, stats = map_ping_sequence_sharded(
        images, positions, quats, cfg, mesh=mesh,
        local_capacity=1 << 13, dtype=jnp.float64, window=2,
    )
    assert not np.asarray(stats["overflowed"]).any()
    a, b = sharded_to_dict(small), sharded_to_dict(big)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k]


def test_sharded_rehash_grow_and_replay(small_cfg):
    """Sharded growth: after a bucket/capacity overflow, rehash_sharded must
    preserve contents, clear poison, and allow exact replay."""
    from sonar_3d_reconstruction_tpu.parallel.shard import rehash_sharded

    cfg = small_cfg
    n = 3
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=90 + i)
         for i in range(n)]
    )
    positions, quats = circular_trajectory(n)
    T = batched_sonar_to_world(positions, quats, cfg)

    mesh = make_mesh()
    tables = build_fan_tables(cfg, cfg.image_height, cfg.image_width)
    scan = make_scan_pings_sharded(mesh, tables, cfg, dtype=jnp.float64)

    # small local capacity: first frames apply, a later one overflows
    st = init_sharded_hash_grid(mesh, local_capacity=1 << 7, dtype=jnp.float64)
    start = 0
    for _ in range(12):
        new_st, stats = scan(
            st, jnp.asarray(images), jnp.asarray(T, jnp.float64),
            jnp.int32(start),
        )
        over = np.asarray(stats["overflowed"])
        if not over.any():
            st = new_st
            break
        start = int(np.argmax(over))
        st = rehash_sharded(
            new_st, mesh, new_st.key_hi.shape[1] * 2
        )
    else:
        raise AssertionError("sharded growth did not converge")

    big = init_sharded_hash_grid(mesh, local_capacity=1 << 13, dtype=jnp.float64)
    big, stats = scan(
        big, jnp.asarray(images), jnp.asarray(T, jnp.float64), jnp.int32(0)
    )
    assert not np.asarray(stats["overflowed"]).any()
    a, b = sharded_to_dict(st), sharded_to_dict(big)
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) < 1e-12


def test_sharded_window_engine_snug_budgets(small_cfg):
    """Sharded window engine with snug lane/insert budgets (grid/hash.py
    budget gating) must be bit-identical to the unbudgeted sharded run;
    per-shard needs psum to global batch_n_need for host sizing."""
    from sonar_3d_reconstruction_tpu.parallel.shard import (
        init_sharded_hash_grid,
        make_window_scan_sharded,
    )

    cfg = small_cfg
    n = 6
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=300 + i)
         for i in range(n)]
    )
    positions, quats = circular_trajectory(n, radius=0.8)
    T = batched_sonar_to_world(positions, quats, cfg)

    mesh = make_mesh()
    tables = build_fan_tables(cfg, cfg.image_height, cfg.image_width)

    def run(lane_budget, insert_budget):
        scan = make_window_scan_sharded(
            mesh, tables, cfg, dtype=jnp.float64, window=3,
            lane_budget=lane_budget, insert_budget=insert_budget,
        )
        st = init_sharded_hash_grid(
            mesh, local_capacity=1 << 13, dtype=jnp.float64
        )
        return scan(st, jnp.asarray(images), jnp.asarray(T, jnp.float64))

    st0, stats0 = run(None, None)
    assert not np.asarray(stats0["overflowed"]).any()
    # global (psum'd) per-window requirements measured by the run itself;
    # per-SHARD budgets must cover the worst shard, bounded by the global
    need = int(np.asarray(stats0["batch_n_need"]).max())
    lanes = int(
        (np.asarray(stats0["num_occupied"])
         + np.asarray(stats0["num_free"])).reshape(-1, 3).sum(axis=1).max()
    )
    st1, stats1 = run(lanes + 8, need + 8)
    assert not np.asarray(stats1["overflowed"]).any()
    a, b = sharded_to_dict(st1), sharded_to_dict(st0)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k]

    # an undersized insert budget must reject the window on EVERY shard
    # (atomic all-or-nothing across the mesh)
    st2, stats2 = run(None, 0)
    assert np.asarray(stats2["overflowed"]).all()
    assert np.asarray(stats2["insert_overflow"]).any()
    assert np.asarray(st2.poisoned).all()
    assert (np.asarray(st2.keys) == EMPTY).all()


def test_sharded_cold_warm_insert_schedule(small_cfg):
    """The sharded window engine accepts the per-window
    [cold, warm] insert-budget schedule the single-chip engine uses (two
    compiled variants), sized from the reported PER-SHARD maxima
    (batch_n_need_max), and bit-matches both the unbudgeted sharded run and
    the single-chip snug cold+warm engine."""
    from sonar_3d_reconstruction_tpu.grid.hash import init_hash_grid
    from sonar_3d_reconstruction_tpu.parallel.shard import (
        init_sharded_hash_grid,
        map_ping_sequence_sharded,
    )
    from sonar_3d_reconstruction_tpu.pipeline import scan_pings_hash

    cfg = small_cfg
    n = 6
    window = 3
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=330 + i)
         for i in range(n)]
    )
    positions, quats = circular_trajectory(n, radius=0.8)
    T = batched_sonar_to_world(positions, quats, cfg)
    mesh = make_mesh()

    # measuring run: reports per-shard maxima for snug sizing
    st0, stats0 = map_ping_sequence_sharded(
        images, positions, quats, cfg, mesh=mesh,
        local_capacity=1 << 13, dtype=jnp.float64, window=window,
    )
    assert not np.asarray(stats0["overflowed"]).any()
    need_max = np.asarray(stats0["batch_n_need_max"]).reshape(-1, window)
    need_sum = np.asarray(stats0["batch_n_need"]).reshape(-1, window)
    # per-shard max <= global (psum'd) requirement
    assert (need_max <= need_sum).all()
    # size each schedule slot from its own windows' measured per-shard need
    # (on this small circular survey later windows can insert MORE than the
    # first — the schedule is positional, not ordered)
    cold = int(need_max[0, 0]) + 8
    warm = int(need_max[1:, 0].max()) + 8

    st1, stats1 = map_ping_sequence_sharded(
        images, positions, quats, cfg, mesh=mesh,
        local_capacity=1 << 13, dtype=jnp.float64, window=window,
        insert_budget=[cold, warm],
    )
    assert not np.asarray(stats1["overflowed"]).any()
    a, b = sharded_to_dict(st1), sharded_to_dict(st0)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k]

    # single-chip engine with ITS measured cold+warm schedule agrees too
    tables = build_fan_tables(cfg, cfg.image_height, cfg.image_width)
    _, sstats = map_ping_sequence(
        images, positions, quats, cfg, initial_capacity=1 << 14,
        dtype=jnp.float64, window=window,
    )
    sneed = np.asarray(sstats["batch_n_need"]).reshape(-1, window)
    single = init_hash_grid(1 << 14, jnp.float64)
    single, s2 = scan_pings_hash(
        single, jnp.asarray(images), jnp.asarray(T, jnp.float64),
        tables=tables, cfg=cfg, dtype=jnp.float64, window=window,
        insert_budget=[int(sneed[0, 0]) + 8, int(sneed[1:, 0].max()) + 8],
    )
    assert not np.asarray(s2["overflowed"]).any()
    c = single_to_dict(single)
    assert a.keys() == c.keys()
    for k in a:
        assert a[k] == c[k]

    # an undersized WARM budget: the host wrapper attributes the failure to
    # the insert budget, doubles the schedule, replays from the first failed
    # window, and still converges to the identical map
    st3, _ = map_ping_sequence_sharded(
        images, positions, quats, cfg, mesh=mesh,
        local_capacity=1 << 13, dtype=jnp.float64, window=window,
        insert_budget=[cold, 1],
    )
    d = sharded_to_dict(st3)
    assert d.keys() == a.keys()
    for k in a:
        assert a[k] == d[k]


def test_sharded_hash_checkpoint_roundtrip(tmp_path, small_cfg):
    """save_map on a ShardedHashState (per-shard device compaction,
    O(touched) host transfer) must produce the identical snapshot content
    as saving the equivalent single-chip map."""
    from sonar_3d_reconstruction_tpu.io.checkpoint import load_map, save_map

    cfg = small_cfg
    n = 3
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=75 + i)
         for i in range(n)]
    )
    positions, quats = circular_trajectory(n, radius=0.8)
    T = batched_sonar_to_world(positions, quats, cfg)

    mesh = make_mesh()
    tables = build_fan_tables(cfg, cfg.image_height, cfg.image_width)
    st = init_sharded_hash_grid(mesh, local_capacity=1 << 13,
                                dtype=jnp.float64)
    st, stats = scan_pings_sharded(
        st, jnp.asarray(images), jnp.asarray(T, jnp.float64), mesh, tables,
        cfg, dtype=jnp.float64,
    )
    assert not np.asarray(stats["overflowed"]).any()
    single, _ = map_ping_sequence(
        images, positions, quats, cfg, initial_capacity=1 << 14,
        dtype=jnp.float64,
    )

    spath, hpath = str(tmp_path / "s.npz"), str(tmp_path / "h.npz")
    save_map(spath, st, cfg)
    save_map(hpath, single, cfg)
    rs, _ = load_map(spath)
    rh, _ = load_map(hpath)
    # dtype inferred from the snapshot (float64 map stays float64)
    assert rs.log_odds.dtype == jnp.float64
    a, b = single_to_dict(rs), single_to_dict(rh)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k]
