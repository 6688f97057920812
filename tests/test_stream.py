"""Streaming runtime: bag -> sync -> chunked mapping, vs direct pipeline."""

import numpy as np
import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.config import StreamConfig
from sonar_3d_reconstruction_tpu.grid.hash import EMPTY
from sonar_3d_reconstruction_tpu.io.bag import write_synthetic_bag
from sonar_3d_reconstruction_tpu.io.pointcloud import parse_pointcloud2
from sonar_3d_reconstruction_tpu.pipeline import map_ping_sequence
from sonar_3d_reconstruction_tpu.stream import StreamingMapper

from conftest import circular_trajectory, synthetic_ping


def to_dict(state):
    keys = np.asarray(state.keys)
    lo = np.asarray(state.log_odds)
    mask = keys[:, 0] != EMPTY
    return {tuple(k): v for k, v in zip(keys[mask], lo[mask])}


def make_bag(tmp_path, cfg, n, seed=0, **kw):
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=seed + i)
         for i in range(n)]
    )
    positions, quats = circular_trajectory(n, radius=0.8)
    path = str(tmp_path / "test.db3")
    write_synthetic_bag(path, images, positions, quats, **kw)
    return path, images, positions, quats


def test_bag_replay_matches_direct_pipeline(tmp_path, small_cfg):
    cfg = small_cfg
    path, images, positions, quats = make_bag(tmp_path, cfg, 7, seed=100)
    sm = StreamingMapper(
        cfg, chunk_size=3, initial_capacity=1 << 13, dtype=jnp.float64
    )
    stats = sm.run_bag(path)
    assert stats.pairs == 7
    assert stats.frames_mapped == 7
    assert stats.chunks == 3  # 3 + 3 + 1 (padded)
    assert stats.decode_errors == 0

    direct, _ = map_ping_sequence(
        images, positions, quats, cfg, initial_capacity=1 << 13,
        dtype=jnp.float64,
    )
    a, b = to_dict(sm.state), to_dict(direct)
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) < 1e-12


def test_stream_fan_cap_and_latency(tmp_path, small_cfg):
    """Per-chunk host-gated fan cap: streaming adopts a capped candidate
    lattice, grows it monotonically when a deeper return
    arrives (one recompile, counted), and still maps bit-identically to the
    offline auto-capped pipeline.  Per-frame arrival->committed latencies
    are recorded with p50/p95 in the summary."""
    cfg = small_cfg
    n = 6
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=400 + i)
         for i in range(n)]
    )
    # first chunk sees shallow returns only; a deeper (but still below the
    # max_range worst case) return arrives in the second chunk
    shallow = images.copy()
    shallow[:3, 40:, :] = 0          # chunk 1: hits only in the top 40 bins
    shallow[3:, 60:, :] = 0          # chunk 2: deeper, yet < worst case
    positions, quats = circular_trajectory(n, radius=0.8)
    path = str(tmp_path / "fan.db3")
    write_synthetic_bag(path, shallow, positions, quats)

    sm = StreamingMapper(
        cfg, chunk_size=3, initial_capacity=1 << 13, dtype=jnp.float64
    )
    stats = sm.run_bag(path)
    from sonar_3d_reconstruction_tpu.ops.backproject import (
        build_fan_tables, required_fan_cap,
    )

    uncapped = build_fan_tables(cfg, cfg.image_height, cfg.image_width)
    need_all = required_fan_cap(shallow, cfg, cfg.image_height)
    # adopted cap equals the full survey's requirement and beats worst case
    assert sm._fan_cap == need_all < uncapped.nvo_max
    assert sm._tables.nvo_cap == need_all
    # the deeper second-chunk return forced exactly one grow/recompile
    need_first = required_fan_cap(shallow[:3], cfg, cfg.image_height)
    assert need_first < need_all
    assert stats.fan_cap_recompiles == 1

    direct, _ = map_ping_sequence(
        shallow, positions, quats, cfg, initial_capacity=1 << 13,
        dtype=jnp.float64,  # fan_cap="auto" default
    )
    a, b = to_dict(sm.state), to_dict(direct)
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) < 1e-12

    # latency metrics: one per mapped frame, positive, summarized
    assert len(stats.latencies) == n
    assert all(v > 0 for v in stats.latencies)
    s = stats.summary()
    assert 0 < s["latency_p50_s"] <= s["latency_p95_s"] <= s["latency_max_s"]
    assert "latencies" not in s

    # a forced-worst-case mapper still works (fan_cap=None disables the gate)
    sm2 = StreamingMapper(
        cfg, chunk_size=6, initial_capacity=1 << 13, dtype=jnp.float64,
        fan_cap=None,
    )
    sm2.run_bag(path)
    assert sm2._tables.nvo_cap == uncapped.nvo_max
    c = to_dict(sm2.state)
    assert c.keys() == b.keys()


def test_stream_brick_backend(tmp_path, small_cfg):
    """StreamingMapper(backend='brick') maps a bag bit-identically to the
    brick offline pipeline, grows under capacity pressure, and publishes
    the same occupied cloud as the hash stream."""
    from sonar_3d_reconstruction_tpu.grid.brick import init_brick_grid
    from sonar_3d_reconstruction_tpu.io.pointcloud import parse_pointcloud2
    from test_brick_grid import brick_state_to_dict

    cfg = small_cfg
    path, images, positions, quats = make_bag(tmp_path, cfg, 5, seed=600)
    sm = StreamingMapper(
        cfg, chunk_size=3, window=3, initial_capacity=1 << 11,
        dtype=jnp.float64, backend="brick",
    )
    stats = sm.run_bag(path)
    assert stats.frames_mapped == 5
    direct, _ = map_ping_sequence(
        images, positions, quats, cfg, backend="brick",
        dtype=jnp.float64, window=3,
    )
    a, b = brick_state_to_dict(sm.state), brick_state_to_dict(direct)
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) < 1e-12

    # publish path: same cloud as the hash streaming mapper on the same bag
    smh = StreamingMapper(
        cfg, chunk_size=3, window=3, initial_capacity=1 << 13,
        dtype=jnp.float64,
    )
    smh.run_bag(path)
    pb, _ = parse_pointcloud2(sm.pointcloud_msg())
    ph, _ = parse_pointcloud2(smh.pointcloud_msg())
    assert {tuple(np.round(p, 6)) for p in pb} == {
        tuple(np.round(p, 6)) for p in ph
    }

    # growth under a tiny brick capacity converges to the same map
    smt = StreamingMapper(
        cfg, chunk_size=5, window=3, initial_capacity=1 << 8,  # 16 bricks
        dtype=jnp.float64, backend="brick",
    )
    smt.run_bag(path)
    assert smt.stats.grows > 0
    c = brick_state_to_dict(smt.state)
    assert c.keys() == b.keys()
    for k in c:
        assert c[k] == b[k]


def test_stream_brick_sharded_backend(tmp_path, small_cfg):
    """StreamingMapper(backend='brick-sharded') on the 8-device CPU mesh:
    bit-identical map to the single-chip brick stream (same host-gated
    capped tables, padded final chunk masked via stop), growth under a
    tiny sharded capacity, and the same published cloud."""
    from sonar_3d_reconstruction_tpu.io.pointcloud import parse_pointcloud2
    from sonar_3d_reconstruction_tpu.parallel.shard_brick import (
        gather_sharded_brick_state,
    )
    from test_brick_grid import brick_state_to_dict

    cfg = small_cfg
    path, images, positions, quats = make_bag(tmp_path, cfg, 5, seed=610)
    sm = StreamingMapper(
        cfg, chunk_size=3, window=3, initial_capacity=1 << 16,
        dtype=jnp.float64, backend="brick-sharded",
    )
    stats = sm.run_bag(path)
    assert stats.frames_mapped == 5
    # capacity is ample, so the only "adoption" is the first chunk's
    # compact box bits — which must NOT count as a budget grow
    assert stats.grows == 0
    assert sm._box_bits is not None

    ref = StreamingMapper(
        cfg, chunk_size=3, window=3, initial_capacity=1 << 11,
        dtype=jnp.float64, backend="brick",
    )
    ref.run_bag(path)
    keys, lo = gather_sharded_brick_state(sm.state)
    a = {tuple(k): float(v) for k, v in zip(keys, lo)}
    b = brick_state_to_dict(ref.state)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k

    ps, _ = parse_pointcloud2(sm.pointcloud_msg())
    pr, _ = parse_pointcloud2(ref.pointcloud_msg())
    assert {tuple(np.round(p, 6)) for p in ps} == {
        tuple(np.round(p, 6)) for p in pr
    }

    # growth under a tiny per-shard capacity converges to the same map
    smt = StreamingMapper(
        cfg, chunk_size=5, window=3, initial_capacity=1 << 8,
        dtype=jnp.float64, backend="brick-sharded",
    )
    smt.run_bag(path)
    assert smt.stats.grows > 0
    keys2, lo2 = gather_sharded_brick_state(smt.state)
    c = {tuple(k): float(v) for k, v in zip(keys2, lo2)}
    assert c.keys() == b.keys()
    for k in c:
        assert c[k] == b[k]


def test_stream_growth(tmp_path, small_cfg):
    cfg = small_cfg
    path, images, positions, quats = make_bag(tmp_path, cfg, 5, seed=200)
    sm = StreamingMapper(
        cfg, chunk_size=5, initial_capacity=1 << 7, dtype=jnp.float64
    )
    sm.run_bag(path)
    assert sm.stats.grows >= 1
    direct, _ = map_ping_sequence(
        images, positions, quats, cfg, initial_capacity=1 << 13,
        dtype=jnp.float64,
    )
    a, b = to_dict(sm.state), to_dict(direct)
    assert a.keys() == b.keys()


def test_stream_with_jittered_odometry(tmp_path, small_cfg):
    """Odometry offset within the ±0.1 s slop must still pair every ping."""
    cfg = small_cfg
    path, *_ = make_bag(tmp_path, cfg, 6, seed=300, odom_jitter=0.08)
    sm = StreamingMapper(cfg, chunk_size=4, initial_capacity=1 << 13)
    stats = sm.run_bag(path)
    assert stats.pairs == 6
    assert stats.avg_stamp_skew <= 0.08 + 1e-9 if hasattr(stats, "avg_stamp_skew") else True
    assert stats.summary()["avg_stamp_skew"] <= 0.08 + 1e-9


def test_stream_publish_callback(tmp_path, small_cfg):
    cfg = small_cfg
    path, *_ = make_bag(tmp_path, cfg, 6, seed=400, rate_hz=2.0)
    published = []
    sm = StreamingMapper(
        cfg,
        StreamConfig(publish_rate_hz=1.0),
        chunk_size=2,
        initial_capacity=1 << 13,
        publish=published.append,
    )
    sm.run_bag(path)
    assert published, "publish callback never fired"
    pts, probs = parse_pointcloud2(published[-1])
    assert pts.shape[1] == 3
    assert ((probs > 0) & (probs <= 1)).all()
    # occupied threshold honored: all published probabilities above min_probability
    assert (probs > cfg.min_probability).all()


def test_stream_window_engine_matches_per_ping(tmp_path, small_cfg):
    """Streaming with the windowed batched-apply engine (default) must be
    bit-identical to window=1 per-ping streaming, including under growth
    pressure (tiny initial capacity)."""
    cfg = small_cfg
    path, images, positions, quats = make_bag(tmp_path, cfg, 7, seed=140)
    runs = {}
    for window in (1, 3):
        sm = StreamingMapper(
            cfg, chunk_size=3, window=window, initial_capacity=1 << 7,
            dtype=jnp.float64,
        )
        st = sm.run_bag(path)
        assert st.frames_mapped == 7
        runs[window] = (to_dict(sm.state), st.grows)
    a, b = runs[1][0], runs[3][0]
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k]
    assert runs[3][1] > 0  # growth actually exercised under window > 1


def test_stream_unique_budget_growth(tmp_path, small_cfg):
    """Unique-budget overflow mid-stream: the regrow branch must double
    from the budget actually in effect (not the global default) and
    converge to the exact map (review r2: this branch was untested)."""
    cfg = small_cfg
    path, images, positions, quats = make_bag(tmp_path, cfg, 5, seed=150)
    sm = StreamingMapper(
        cfg, chunk_size=5, window=2, initial_capacity=1 << 13,
        dtype=jnp.float64,
    )
    sm._unique_budget = 64  # far below the frames' unique counts
    st = sm.run_bag(path)
    assert st.frames_mapped == 5
    assert st.grows >= 1
    assert sm._unique_budget > 64  # doubled from the effective value
    assert sm._unique_budget <= 1 << 14  # snug growth, no 2^18 jump
    direct, _ = map_ping_sequence(
        images, positions, quats, cfg, initial_capacity=1 << 13,
        dtype=jnp.float64,
    )
    a, b = to_dict(sm.state), to_dict(direct)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k]


def test_stream_free_cap_and_box_bits(tmp_path, small_cfg):
    """The free-lattice depth gate adopts per-chunk (grow-only: a deeper
    first hit costs one counted recompile), the brick stream's compact
    box-key bits stay sticky across chunks, and the result is bit-identical
    to the offline auto-capped pipeline."""
    from test_brick_grid import brick_state_to_dict

    cfg = small_cfg
    R, B = cfg.image_height, cfg.image_width
    rng = np.random.default_rng(8)
    # every column returns; later pings return DEEPER (free cap must grow)
    n = 6
    images = np.zeros((n, R, B), np.uint8)
    for i in range(n):
        r0 = 20 + 8 * i
        images[i, r0 : r0 + 6, :] = rng.integers(
            90, 200, size=(6, B)
        ).astype(np.uint8)
    positions, quats = circular_trajectory(n, radius=0.8)
    path = str(tmp_path / "deep.db3")
    write_synthetic_bag(path, images, positions, quats)

    sm = StreamingMapper(
        cfg, chunk_size=2, window=2, initial_capacity=1 << 11,
        dtype=jnp.float64, backend="brick",
    )
    stats = sm.run_bag(path)
    assert stats.frames_mapped == n
    assert sm._free_cap == 20 + 8 * (n - 1)  # deepest FIRST hit
    assert stats.free_cap_recompiles >= 1  # deeper hits arrived mid-stream
    assert sm._box_bits is not None  # compact engine engaged
    assert stats.box_bits_recompiles == 0  # same geometry: bits stayed put

    direct, _ = map_ping_sequence(
        images, positions, quats, cfg, backend="brick",
        dtype=jnp.float64, window=2,
    )
    a, b = brick_state_to_dict(sm.state), brick_state_to_dict(direct)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k


def _pair(sm, cfg, img, pos, t):
    from sonar_3d_reconstruction_tpu.io.bag import ImageMsg, OdometryMsg

    h, w = img.shape
    sm.on_ping(ImageMsg(t, "sonar_link", h, w, "mono8", False, w,
                        img.tobytes()))
    sm.on_pose(OdometryMsg(t, "camera_init", "body", pos,
                           [0.0, 0.0, 0.0, 1.0]))


def test_stream_recovers_after_failed_chunk(small_cfg):
    """A chunk whose flush raises (range_fail: pose outside the packable
    key range) must clear its buffers so the NEXT pair flushes a normal
    chunk instead of crashing on a negative pad."""
    import pytest

    cfg = small_cfg
    img = synthetic_ping(cfg.image_height, cfg.image_width, seed=11)
    sm = StreamingMapper(
        cfg, chunk_size=1, window=1, initial_capacity=1 << 12,
        dtype=jnp.float64,
    )
    _pair(sm, cfg, img, [0.0, 0.0, 0.0], 1000.0)
    with pytest.raises(ValueError, match="packable"):
        _pair(sm, cfg, img, [1.0e7, 0.0, 0.0], 1001.0)
    # recovered: the failed chunk's frames are dropped, later pairs map
    _pair(sm, cfg, img, [0.1, 0.0, 0.0], 1002.0)
    stats = sm.finish()
    assert stats.frames_mapped == 2
    assert int(np.asarray(sm.state.used)) > 0


def test_stream_publish_rate_zero_disables_timer(small_cfg):
    cfg = small_cfg
    img = synthetic_ping(cfg.image_height, cfg.image_width, seed=12)
    published = []
    sm = StreamingMapper(
        cfg, StreamConfig(publish_rate_hz=0.0), chunk_size=1,
        initial_capacity=1 << 12, publish=published.append,
    )
    _pair(sm, cfg, img, [0.0, 0.0, 0.0], 1000.0)
    sm.finish()
    assert published == []


def test_pointcloud_msg_nanosec_carry(small_cfg):
    """Rounding 0.9999999996s of fraction must carry into sec, never emit
    nanosec == 1e9 (invalid ROS builtin_interfaces/Time)."""
    cfg = small_cfg
    sm = StreamingMapper(cfg, chunk_size=1, initial_capacity=1 << 10)
    msg = sm.pointcloud_msg(stamp=123.9999999996)
    assert msg["header"]["stamp"] == {"sec": 124, "nanosec": 0}


def test_stream_incremental_publish_byte_identical(tmp_path, small_cfg):
    """Incremental publish (default for the brick backend: host view +
    pose-derived dirty-region pulls, grid/brick.py incremental section)
    produces BYTE-identical PointCloud2 messages to the full O(capacity)
    extraction at every tick, including under growth pressure and on a
    final post-stream tick."""
    cfg = small_cfg
    path, *_ = make_bag(tmp_path, cfg, 8, seed=777, rate_hz=2.0)

    def run(inc):
        published = []
        sm = StreamingMapper(
            cfg, StreamConfig(publish_rate_hz=2.0), chunk_size=2, window=2,
            initial_capacity=1 << 8, dtype=jnp.float64, backend="brick",
            publish=published.append, incremental_publish=inc,
        )
        sm.run_bag(path)
        published.append(sm.pointcloud_msg(stamp=999.0))
        return published, sm

    a, sma = run(True)
    b, smb = run(False)
    assert sma.incremental_publish and not smb.incremental_publish
    assert sma.stats.grows > 0  # tiny capacity: growth exercised
    assert len(a) == len(b) >= 3
    for i, (ma, mb) in enumerate(zip(a, b)):
        assert ma == mb, f"publish {i} differs"
    # ticks after the seed pulled only dirty regions, not the full table
    assert sma._host_view is not None and len(sma._host_view) > 0
