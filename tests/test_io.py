"""I/O stack: image decode, PointCloud2 bytes, time sync, bag roundtrip,
map checkpointing."""

import struct

import numpy as np
import pytest

from sonar_3d_reconstruction_tpu.io.bag import (
    BagReader,
    ImageMsg,
    OdometryMsg,
    decode_image_msg,
    decode_odometry_msg,
    encode_image_msg,
    encode_odometry_msg,
    write_synthetic_bag,
)
from sonar_3d_reconstruction_tpu.io.image import UnsupportedEncoding, decode_image
from sonar_3d_reconstruction_tpu.io.pointcloud import (
    classified_markers,
    parse_pointcloud2,
    serialize_pointcloud2,
)
from sonar_3d_reconstruction_tpu.io.timesync import ApproximateTimeSync, pair_streams

from conftest import synthetic_ping


# ---------------------------------------------------------------------------
# image decode (reference node:302-316)
# ---------------------------------------------------------------------------

def test_decode_mono8():
    img = synthetic_ping(20, 16, seed=1)
    out = decode_image(img.tobytes(), 20, 16, "mono8")
    np.testing.assert_array_equal(out, img)


def test_decode_mono16_scales_to_uint8():
    img16 = (synthetic_ping(10, 8, seed=2).astype(np.uint16)) * 256 + 7
    out = decode_image(img16.astype("<u2").tobytes(), 10, 8, "mono16")
    np.testing.assert_array_equal(out, (img16 / 256).astype(np.uint8))


def test_decode_row_padding():
    img = synthetic_ping(6, 5, seed=3)
    padded = np.zeros((6, 8), np.uint8)
    padded[:, :5] = img
    out = decode_image(padded.tobytes(), 6, 5, "mono8", step=8)
    np.testing.assert_array_equal(out, img)


def test_decode_rejects_unknown_encoding():
    with pytest.raises(UnsupportedEncoding):
        decode_image(b"\x00" * 12, 2, 2, "rgb8")


# ---------------------------------------------------------------------------
# PointCloud2 bytes (reference node:406-443 layout)
# ---------------------------------------------------------------------------

def test_pointcloud2_byte_layout_matches_struct_pack():
    pts = np.array([[1.0, -2.0, 3.5], [0.25, 0.5, -0.125]])
    probs = np.array([0.7, 0.9])
    msg = serialize_pointcloud2(pts, probs)
    # the reference packs each point with struct.pack('ffff', ...) (node:437-442)
    expect = b"".join(
        struct.pack("<ffff", *p, i) for p, i in zip(pts, probs)
    )
    assert msg["data"] == expect
    assert msg["point_step"] == 16
    assert msg["width"] == 2 and msg["height"] == 1
    assert [f["name"] for f in msg["fields"]] == ["x", "y", "z", "intensity"]
    rp, ri = parse_pointcloud2(msg)
    np.testing.assert_allclose(rp, pts, rtol=1e-6)
    np.testing.assert_allclose(ri, probs, rtol=1e-6)


def test_pointcloud2_empty():
    msg = serialize_pointcloud2(np.empty((0, 3)), np.empty(0))
    assert msg["width"] == 0 and msg["data"] == b""


def test_classified_markers_styles():
    classified = {
        "occupied": (np.array([[1.0, 2.0, 3.0]]), np.array([0.9])),
        "free": (np.empty((0, 3)), np.empty(0)),
        "unknown": (np.array([[0.0, 0.0, 0.0]]), np.array([0.5])),
    }
    markers = classified_markers(classified, 0.15)
    assert len(markers) == 3
    occ = markers[0]
    assert occ["color"] == {"r": 1.0, "g": 0.0, "b": 0.0, "a": 0.8}
    assert occ["scale"]["x"] == 0.15
    assert occ["type"] == 6  # CUBE_LIST
    assert markers[1]["points"].shape == (0, 3)


# ---------------------------------------------------------------------------
# approximate time sync (reference node:191-212 semantics)
# ---------------------------------------------------------------------------

def test_timesync_pairs_within_slop():
    pairs = []
    s = ApproximateTimeSync(lambda a, b: pairs.append((a, b)), slop=0.1)
    for i in range(5):
        s.add_ping(f"ping{i}", i * 1.0)
        s.add_pose(f"pose{i}", i * 1.0 + 0.03)
    s.flush()
    assert pairs == [(f"ping{i}", f"pose{i}") for i in range(5)]


def test_timesync_drops_beyond_slop():
    pairs = []
    s = ApproximateTimeSync(lambda a, b: pairs.append((a, b)), slop=0.1)
    s.add_ping("p0", 0.0)
    s.add_pose("q_far", 0.5)   # 0.5s away: never pairable
    s.add_ping("p1", 0.52)
    s.add_pose("q1", 0.55)
    s.flush()
    assert ("p0", "q_far") not in pairs
    assert ("p1", "q1") in pairs or ("p1", "q_far") in pairs


def test_timesync_queue_bound():
    pairs = []
    s = ApproximateTimeSync(lambda a, b: pairs.append((a, b)), queue_size=3, slop=0.01)
    for i in range(10):
        s.add_ping(i, float(i))  # no poses at all
    assert len(s.queues[0]) <= 3
    assert s.dropped >= 7


def test_pair_streams_offline():
    ping_t = np.array([0.0, 1.0, 2.0, 3.0])
    pose_t = np.array([0.02, 1.5, 2.95, 3.04])
    pairs = pair_streams(ping_t, pose_t, slop=0.1)
    assert (0, 0) in pairs
    # faithful ATS: ping 3.0 fires on arrival with the already-queued pose
    # at 2.95 (delta 0.05) — the closer pose at 3.04 has not arrived yet
    assert (3, 2) in pairs
    got_pings = [i for i, _ in pairs]
    assert 1 not in got_pings  # nothing within 0.1 of t=1.0


# -- adversarial ATS boundary cases (message_filters parity) ---------------

def test_timesync_exact_slop_never_fires():
    """Spread exactly == slop survives the candidate scan but fails the
    strict < slop spread check (message_filters behavior)."""
    pairs = []
    s = ApproximateTimeSync(lambda a, b: pairs.append((a, b)), slop=0.5)
    s.add_ping("p", 1.0)
    s.add_pose("q", 1.5)   # |delta| == slop exactly (both representable)
    assert pairs == []
    s.add_pose("q2", 1.25)  # strictly inside -> fires with the queued ping
    assert pairs == [("p", "q2")]


def test_timesync_out_of_order_arrivals():
    """A late-arriving earlier-stamped pose still pairs with a queued ping
    (no head dropping — messages only leave by pairing or eviction)."""
    pairs = []
    s = ApproximateTimeSync(lambda a, b: pairs.append((a, b)), slop=0.1)
    s.add_ping("p0", 10.0)
    s.add_pose("q_future", 10.5)   # out of slop; stays queued
    s.add_pose("q_late", 9.95)     # arrives late, stamped before p0
    assert pairs == [("p0", "q_late")]
    # the far pose is still queued and can pair with a matching ping later
    s.add_ping("p1", 10.48)
    assert pairs[-1] == ("p1", "q_future")


def test_timesync_eviction_removes_smallest_stamp():
    """queue_size eviction removes the MINIMUM stamp, not the oldest
    arrival (message_filters deletes min(queue))."""
    pairs = []
    s = ApproximateTimeSync(
        lambda a, b: pairs.append((a, b)), queue_size=2, slop=0.05
    )
    s.add_ping("p_mid", 5.0)
    s.add_ping("p_old", 1.0)   # arrives later but stamped earliest
    s.add_ping("p_new", 9.0)   # exceeds queue_size -> evicts stamp 1.0
    assert sorted(s.queues[0]) == [5.0, 9.0]
    s.add_pose("q", 1.0)       # would only match the evicted ping
    assert pairs == []


def test_timesync_equal_stamp_overwrites():
    """A message with an identical stamp replaces the queued one (the
    upstream queue is a stamp-keyed dict)."""
    pairs = []
    s = ApproximateTimeSync(lambda a, b: pairs.append((a, b)), slop=0.1)
    s.add_ping("first", 2.0)
    s.add_ping("second", 2.0)
    s.add_pose("q", 2.01)
    assert pairs == [("second", "q")]


def test_timesync_nearest_candidate_wins():
    """On arrival the minimum-|delta| queued partner is chosen, not the
    oldest one."""
    pairs = []
    s = ApproximateTimeSync(lambda a, b: pairs.append((a, b)), slop=0.1)
    s.add_pose("q_far", 3.00)
    s.add_pose("q_near", 3.06)
    s.add_ping("p", 3.08)
    assert pairs == [("p", "q_near")]
    # q_far remains queued
    assert 3.00 in s.queues[1]


# ---------------------------------------------------------------------------
# CDR + rosbag2 roundtrip
# ---------------------------------------------------------------------------

def test_image_msg_cdr_roundtrip():
    img = synthetic_ping(30, 24, seed=4)
    m = ImageMsg(
        stamp=1700000000.125,
        frame_id="sonar_link",
        height=30,
        width=24,
        encoding="mono8",
        is_bigendian=False,
        step=24,
        data=img.tobytes(),
    )
    out = decode_image_msg(encode_image_msg(m))
    assert out.height == 30 and out.width == 24
    assert out.encoding == "mono8"
    assert out.frame_id == "sonar_link"
    assert abs(out.stamp - m.stamp) < 1e-6
    np.testing.assert_array_equal(
        np.frombuffer(out.data, np.uint8).reshape(30, 24), img
    )


def test_odometry_msg_cdr_roundtrip():
    m = OdometryMsg(
        stamp=1700000001.5,
        frame_id="camera_init",
        child_frame_id="body",
        position=np.array([1.5, -2.25, 0.75]),
        orientation=np.array([0.0, 0.0, 0.7071, 0.7071]),
    )
    out = decode_odometry_msg(encode_odometry_msg(m))
    assert out.child_frame_id == "body"
    np.testing.assert_allclose(out.position, m.position)
    np.testing.assert_allclose(out.orientation, m.orientation)
    assert abs(out.stamp - m.stamp) < 1e-6


def test_synthetic_bag_roundtrip(tmp_path):
    n = 6
    images = np.stack([synthetic_ping(40, 32, seed=10 + i) for i in range(n)])
    positions = np.cumsum(np.full((n, 3), 0.1), axis=0)
    quats = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    path = str(tmp_path / "synthetic.db3")
    write_synthetic_bag(path, images, positions, quats)

    with BagReader(path) as bag:
        names = bag.topic_names()
        assert "/sensor/sonar/oculus/m750d/image" in names
        assert "/fast_lio/odometry" in names
        imgs, odoms = [], []
        for topic, ts, msg in bag.messages():
            (imgs if isinstance(msg, ImageMsg) else odoms).append(msg)
    assert len(imgs) == n and len(odoms) == n
    np.testing.assert_array_equal(
        np.frombuffer(imgs[2].data, np.uint8).reshape(40, 32), images[2]
    )
    np.testing.assert_allclose(odoms[3].position, positions[3])


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_map_checkpoint_roundtrip(tmp_path, small_cfg):
    import jax.numpy as jnp

    from sonar_3d_reconstruction_tpu.grid.hash import EMPTY
    from sonar_3d_reconstruction_tpu.io.checkpoint import load_map, save_map
    from sonar_3d_reconstruction_tpu.models import SonarMapper

    m = SonarMapper(small_cfg, initial_capacity=1 << 12, dtype=jnp.float64)
    img = synthetic_ping(small_cfg.image_height, small_cfg.image_width, seed=42)
    m.process_sonar_image(img, [0, 0, 0], [0, 0, 0, 1])

    path = str(tmp_path / "map.npz")
    save_map(path, m.state, m.cfg)
    state, cfg = load_map(path, dtype=jnp.float64)
    assert cfg.voxel_resolution == small_cfg.voxel_resolution

    def to_dict(st):
        keys = np.asarray(st.keys)
        lo = np.asarray(st.log_odds)
        mask = keys[:, 0] != EMPTY
        return {tuple(k): v for k, v in zip(keys[mask], lo[mask])}

    a, b = to_dict(m.state), to_dict(state)
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) < 1e-12


# ---------------------------------------------------------------------------
# debug visualization (reference show_opencv_visualization, node:249-292)
# ---------------------------------------------------------------------------

def test_threshold_overlay(small_cfg):
    from sonar_3d_reconstruction_tpu.io.debugviz import threshold_overlay

    img = np.zeros((10, 6), np.uint8)
    img[4, 2] = 200  # single bright return in column 2
    rgb = threshold_overlay(img, small_cfg)
    assert rgb.shape == (10, 6, 3)
    assert tuple(rgb[4, 2]) == (0, 255, 0)  # first hit marked green
    assert (rgb[:, 0] == 0).all()  # empty column untouched


def test_load_bag_sequence(tmp_path):
    """Offline loader (native when available, python fallback) pairs and
    decodes the whole bag into dense arrays."""
    from sonar_3d_reconstruction_tpu.io.bag import load_bag_sequence

    n = 5
    images = np.stack([synthetic_ping(30, 20, seed=20 + i) for i in range(n)])
    positions = np.cumsum(np.full((n, 3), 0.2), axis=0)
    quats = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    path = str(tmp_path / "seq.db3")
    write_synthetic_bag(path, images, positions, quats, odom_jitter=0.05)

    for use_native in (True, False):
        imgs, pos, qs, stamps = load_bag_sequence(path, use_native=use_native)
        assert len(imgs) == n
        np.testing.assert_array_equal(imgs, images)
        np.testing.assert_allclose(pos, positions)
        np.testing.assert_allclose(qs, quats)
        assert (np.diff(stamps) > 0).all()


# ---------------------------------------------------------------------------
# mcap container
# ---------------------------------------------------------------------------

def test_mcap_roundtrip(tmp_path):
    from sonar_3d_reconstruction_tpu.io.bag import IMAGE_TYPE, ODOMETRY_TYPE
    from sonar_3d_reconstruction_tpu.io.mcap import McapReader, McapWriter, open_bag

    n = 4
    images = np.stack([synthetic_ping(20, 16, seed=30 + i) for i in range(n)])
    path = str(tmp_path / "rec.mcap")
    with McapWriter(path) as w:
        w.add_topic("/sensor/sonar/oculus/m750d/image", IMAGE_TYPE)
        w.add_topic("/fast_lio/odometry", ODOMETRY_TYPE)
        for i in range(n):
            t = 500.0 + i
            w.write(
                "/sensor/sonar/oculus/m750d/image", t,
                ImageMsg(t, "sonar_link", 20, 16, "mono8", False, 16,
                         images[i].tobytes()),
            )
            w.write(
                "/fast_lio/odometry", t,
                OdometryMsg(t, "camera_init", "body",
                            np.array([i * 0.1, 0.0, 0.0]),
                            np.array([0.0, 0.0, 0.0, 1.0])),
            )

    with McapReader(path) as r:
        names = r.topic_names()
        assert names["/fast_lio/odometry"] == ODOMETRY_TYPE
        imgs, odoms = [], []
        for topic, ts, msg in r.messages():
            (imgs if isinstance(msg, ImageMsg) else odoms).append(msg)
    assert len(imgs) == n and len(odoms) == n
    np.testing.assert_array_equal(
        np.frombuffer(imgs[1].data, np.uint8).reshape(20, 16), images[1]
    )
    # open_bag sniffs the container
    assert isinstance(open_bag(path), McapReader)


@pytest.mark.parametrize("compression", ["zstd", "lz4"])
def test_mcap_compressed_chunk_roundtrip(tmp_path, compression):
    """Compressed-chunk mcap files (rosbag2's default is zstd) roundtrip
    through the native codecs."""
    from sonar_3d_reconstruction_tpu.io import native
    from sonar_3d_reconstruction_tpu.io.bag import IMAGE_TYPE, ODOMETRY_TYPE
    from sonar_3d_reconstruction_tpu.io.mcap import McapReader, McapWriter

    if not (native.available() and native.codec_available(compression)):
        pytest.skip(f"native {compression} codec unavailable")

    n = 5
    images = np.stack([synthetic_ping(20, 16, seed=60 + i) for i in range(n)])
    path = str(tmp_path / f"rec_{compression}.mcap")
    # small chunk_size so the file exercises multiple chunk records
    with McapWriter(path, chunk_compression=compression, chunk_size=512) as w:
        w.add_topic("/sensor/sonar/oculus/m750d/image", IMAGE_TYPE)
        w.add_topic("/fast_lio/odometry", ODOMETRY_TYPE)
        for i in range(n):
            t = 900.0 + i
            w.write(
                "/sensor/sonar/oculus/m750d/image", t,
                ImageMsg(t, "sonar_link", 20, 16, "mono8", False, 16,
                         images[i].tobytes()),
            )
            w.write(
                "/fast_lio/odometry", t,
                OdometryMsg(t, "camera_init", "body",
                            np.array([i * 0.1, 0.0, 0.0]),
                            np.array([0.0, 0.0, 0.0, 1.0])),
            )
    # structurally: all messages live inside chunk records, none at top level
    from sonar_3d_reconstruction_tpu.io.mcap import (
        MAGIC, OP_CHUNK, OP_MESSAGE, _records,
    )

    raw = open(path, "rb").read()
    top_ops = [op for op, _ in _records(memoryview(raw)[len(MAGIC):])]
    assert top_ops.count(OP_CHUNK) >= 2  # chunk_size=512 forces several
    assert OP_MESSAGE not in top_ops

    # spec-complete indexing (rosbag2_storage_mcap layout): every chunk is
    # followed by per-channel MessageIndex records, and each ChunkIndex in
    # the summary references them by absolute file offset with the right
    # total length
    import struct as _s

    from sonar_3d_reconstruction_tpu.io.mcap import (
        OP_CHUNK_INDEX, OP_MESSAGE_INDEX,
    )

    assert top_ops.count(OP_MESSAGE_INDEX) == 2 * top_ops.count(OP_CHUNK)
    mi_at = {}  # file offset -> channel_id
    pos = len(MAGIC)
    for op, payload in _records(memoryview(raw)[len(MAGIC):]):
        if op == OP_MESSAGE_INDEX:
            (cid,) = _s.unpack_from("<H", payload, 0)
            mi_at[pos] = cid
        pos += 9 + len(payload)
    n_chunk_indexes = 0
    for op, payload in _records(memoryview(raw)[len(MAGIC):]):
        if op != OP_CHUNK_INDEX:
            continue
        n_chunk_indexes += 1
        (mi_map_len,) = _s.unpack_from("<I", payload, 32)
        entries = payload[36 : 36 + mi_map_len]
        (mi_length,) = _s.unpack_from("<Q", payload, 36 + mi_map_len)
        total = 0
        for e in range(0, mi_map_len, 10):
            cid, off = _s.unpack_from("<HQ", entries, e)
            assert mi_at.get(off) == cid, (off, cid, mi_at)
            (rec_len,) = _s.unpack_from("<Q", raw, off + 1)
            total += 9 + rec_len
        assert total == mi_length
    assert n_chunk_indexes == top_ops.count(OP_CHUNK)

    with McapReader(path) as r:
        assert r.topic_names()["/fast_lio/odometry"] == ODOMETRY_TYPE
        imgs, odoms = [], []
        for topic, ts, msg in r.messages():
            (imgs if isinstance(msg, ImageMsg) else odoms).append(msg)
    assert len(imgs) == n and len(odoms) == n
    for i in range(n):
        np.testing.assert_array_equal(
            np.frombuffer(imgs[i].data, np.uint8).reshape(20, 16), images[i]
        )
    np.testing.assert_allclose(odoms[3].position, [0.3, 0.0, 0.0])


def test_mcap_corrupt_compressed_chunk_rejected(tmp_path):
    """A zstd chunk whose body is garbage must raise, not silently drop."""
    from sonar_3d_reconstruction_tpu.io import native
    from sonar_3d_reconstruction_tpu.io.bag import IMAGE_TYPE
    from sonar_3d_reconstruction_tpu.io.mcap import McapReader, McapWriter

    if not (native.available() and native.codec_available("zstd")):
        pytest.skip("native zstd codec unavailable")

    path = str(tmp_path / "corrupt.mcap")
    with McapWriter(path, chunk_compression="zstd") as w:
        w.add_topic("/sensor/sonar/oculus/m750d/image", IMAGE_TYPE)
        img = synthetic_ping(20, 16, seed=77)
        w.write(
            "/sensor/sonar/oculus/m750d/image", 1000.0,
            ImageMsg(1000.0, "s", 20, 16, "mono8", False, 16, img.tobytes()),
        )
    raw = bytearray(open(path, "rb").read())
    # flip bytes in the zstd frame body (skip the 4-byte zstd magic after the
    # chunk header fields + "zstd" string + u64 length)
    zmagic = raw.find(b"\x28\xb5\x2f\xfd")
    assert zmagic > 0
    for k in range(zmagic + 8, min(zmagic + 24, len(raw))):
        raw[k] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises((ValueError, NotImplementedError)):
        with McapReader(path) as r:
            list(r.messages())


def _find_top_level_chunk(raw: bytes):
    """(absolute_offset, payload_length) of the first top-level Chunk."""
    from sonar_3d_reconstruction_tpu.io.mcap import MAGIC, OP_CHUNK
    import struct as _struct

    pos = len(MAGIC)
    while pos + 9 <= len(raw):
        op = raw[pos]
        (length,) = _struct.unpack_from("<Q", raw, pos + 1)
        if op == OP_CHUNK:
            return pos, length
        pos += 9 + length
    raise AssertionError("no chunk record found")


def test_mcap_store_chunk_corruption_rejected(tmp_path):
    """An UNCOMPRESSED chunk whose records bytes were flipped must fail the
    chunk CRC (previously only compressed chunks could detect corruption)."""
    from sonar_3d_reconstruction_tpu.io.bag import IMAGE_TYPE
    from sonar_3d_reconstruction_tpu.io.mcap import McapReader, McapWriter

    img = synthetic_ping(20, 16, seed=78)
    path = str(tmp_path / "store.mcap")
    with McapWriter(path, chunk_compression="store") as w:
        w.add_topic("/sensor/sonar/oculus/m750d/image", IMAGE_TYPE)
        w.write(
            "/sensor/sonar/oculus/m750d/image", 1000.0,
            ImageMsg(1000.0, "s", 20, 16, "mono8", False, 16, img.tobytes()),
        )
    # clean roundtrip first
    with McapReader(path) as r:
        msgs = list(r.messages())
    assert len(msgs) == 1
    np.testing.assert_array_equal(
        np.frombuffer(msgs[0][2].data, np.uint8).reshape(20, 16), img
    )
    raw = bytearray(open(path, "rb").read())
    off, length = _find_top_level_chunk(bytes(raw))
    raw[off + 9 + length - 10] ^= 0xFF  # flip a byte of the image payload
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC32"):
        with McapReader(path) as r:
            list(r.messages())


def test_mcap_compressed_chunk_bad_crc_rejected(tmp_path):
    """A chunk that decompresses fine but whose header CRC disagrees with
    the decompressed records must raise (a wrong-but-decompressible body)."""
    from sonar_3d_reconstruction_tpu.io import native
    from sonar_3d_reconstruction_tpu.io.bag import IMAGE_TYPE
    from sonar_3d_reconstruction_tpu.io.mcap import McapReader, McapWriter

    if not (native.available() and native.codec_available("zstd")):
        pytest.skip("native zstd codec unavailable")
    path = str(tmp_path / "badcrc.mcap")
    with McapWriter(path, chunk_compression="zstd") as w:
        w.add_topic("/sensor/sonar/oculus/m750d/image", IMAGE_TYPE)
        img = synthetic_ping(20, 16, seed=79)
        w.write(
            "/sensor/sonar/oculus/m750d/image", 1000.0,
            ImageMsg(1000.0, "s", 20, 16, "mono8", False, 16, img.tobytes()),
        )
    raw = bytearray(open(path, "rb").read())
    off, _ = _find_top_level_chunk(bytes(raw))
    # uncompressed_crc is at payload offset 24 (after 3 u64 time/size fields)
    crc_off = off + 9 + 24
    raw[crc_off] ^= 0x5A
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC32"):
        with McapReader(path) as r:
            list(r.messages())


def test_mcap_writer_summary_section(tmp_path):
    """The writer ends files with a spec-shaped Summary section: repeated
    Schema/Channel, ChunkIndex per chunk, Statistics, SummaryOffset groups,
    and a Footer whose summary_start/summary_crc verify."""
    import struct
    import zlib

    from sonar_3d_reconstruction_tpu.io.bag import IMAGE_TYPE, ODOMETRY_TYPE
    from sonar_3d_reconstruction_tpu.io.mcap import (
        MAGIC, OP_CHUNK, OP_CHUNK_INDEX, OP_FOOTER, OP_STATISTICS,
        OP_SUMMARY_OFFSET, McapReader, McapWriter, _records,
    )

    n = 4
    path = str(tmp_path / "summary.mcap")
    with McapWriter(path, chunk_compression="store", chunk_size=256) as w:
        w.add_topic("/sensor/sonar/oculus/m750d/image", IMAGE_TYPE)
        w.add_topic("/fast_lio/odometry", ODOMETRY_TYPE)
        for i in range(n):
            t = 10.0 + i
            img = synthetic_ping(20, 16, seed=80 + i)
            w.write(
                "/sensor/sonar/oculus/m750d/image", t,
                ImageMsg(t, "s", 20, 16, "mono8", False, 16, img.tobytes()),
            )
            w.write(
                "/fast_lio/odometry", t,
                OdometryMsg(t, "camera_init", "body",
                            np.array([i * 0.1, 0.0, 0.0]),
                            np.array([0.0, 0.0, 0.0, 1.0])),
            )
    raw = open(path, "rb").read()
    assert raw.endswith(MAGIC)
    # footer = last record before the closing magic
    foot_off = len(raw) - len(MAGIC) - (9 + 20)
    assert raw[foot_off] == OP_FOOTER
    summary_start, summary_offset_start, crc = struct.unpack_from(
        "<QQI", raw, foot_off + 9
    )
    assert 0 < summary_start < summary_offset_start < foot_off + 1
    # summary_crc covers [summary_start .. footer summary_offset_start field]
    assert crc == zlib.crc32(raw[summary_start: foot_off + 9 + 16])

    ops = [
        (op, payload)
        for op, payload in _records(memoryview(raw)[len(MAGIC):])
    ]
    opcodes = [op for op, _ in ops]
    n_chunks = opcodes.count(OP_CHUNK)
    assert n_chunks >= 2
    assert opcodes.count(OP_CHUNK_INDEX) == n_chunks
    assert opcodes.count(OP_STATISTICS) == 1
    assert opcodes.count(OP_SUMMARY_OFFSET) >= 3
    stats_payload = next(p for op, p in ops if op == OP_STATISTICS)
    (msg_count,) = struct.unpack_from("<Q", stats_payload, 0)
    assert msg_count == 2 * n
    # every ChunkIndex chunk_start_offset points at a real Chunk record
    for op, p in ops:
        if op == OP_CHUNK_INDEX:
            (chunk_start,) = struct.unpack_from("<Q", p, 16)
            assert raw[chunk_start] == OP_CHUNK
    # and the reader still replays every message
    with McapReader(path) as r:
        assert len(list(r.messages())) == 2 * n


def test_mcap_rosbag2_style_fixture(tmp_path):
    """Hand-crafted (writer-independent) file laid out the way rosbag2's
    mcap writer emits recordings — messages inside a CRC'd chunk followed by
    MessageIndex records, then a Summary section with ChunkIndex/Statistics/
    SummaryOffset — must replay through McapReader (mcap spec v0.x layout)."""
    import struct
    import zlib

    from sonar_3d_reconstruction_tpu.io.bag import (
        IMAGE_TYPE, encode_image_msg,
    )
    from sonar_3d_reconstruction_tpu.io.mcap import (
        MAGIC, OP_CHANNEL, OP_CHUNK, OP_CHUNK_INDEX, OP_DATA_END, OP_FOOTER,
        OP_HEADER, OP_MESSAGE, OP_MESSAGE_INDEX, OP_SCHEMA, OP_STATISTICS,
        OP_SUMMARY_OFFSET, McapReader,
    )

    def s(x: str) -> bytes:
        b = x.encode()
        return struct.pack("<I", len(b)) + b

    def rec(op: int, payload: bytes) -> bytes:
        return struct.pack("<BQ", op, len(payload)) + payload

    img = synthetic_ping(20, 16, seed=90)
    blob = encode_image_msg(
        ImageMsg(5.0, "sonar_link", 20, 16, "mono8", False, 16, img.tobytes())
    )
    schema = struct.pack("<H", 1) + s(IMAGE_TYPE) + s("ros2msg") + struct.pack("<I", 0)
    channel = (
        struct.pack("<HH", 1, 1) + s("/sonar/img") + s("cdr")
        + struct.pack("<I", 0)
    )
    t_ns = 5_000_000_000
    message = struct.pack("<HIQQ", 1, 0, t_ns, t_ns) + blob
    chunk_records = rec(OP_SCHEMA, schema) + rec(OP_CHANNEL, channel) + rec(
        OP_MESSAGE, message
    )
    chunk_payload = (
        struct.pack("<QQQI", t_ns, t_ns, len(chunk_records),
                    zlib.crc32(chunk_records))
        + s("") + struct.pack("<Q", len(chunk_records)) + chunk_records
    )

    out = bytearray()
    out += MAGIC
    out += rec(OP_HEADER, s("ros2") + s("rosbag2"))
    chunk_off = len(out)
    out += rec(OP_CHUNK, chunk_payload)
    # rosbag2 writes a MessageIndex per channel after each chunk
    mi = struct.pack("<H", 1) + struct.pack("<I", 16) + struct.pack(
        "<QQ", t_ns, 27  # offset of the message record inside the chunk
    )
    out += rec(OP_MESSAGE_INDEX, mi)
    out += rec(OP_DATA_END, struct.pack("<I", 0))
    summary_start = len(out)
    out += rec(OP_SCHEMA, schema)
    out += rec(OP_CHANNEL, channel)
    ci = (
        struct.pack("<QQQQ", t_ns, t_ns, chunk_off, 9 + len(chunk_payload))
        + struct.pack("<I", 10) + struct.pack("<HQ", 1, summary_start)
        + struct.pack("<Q", 9 + len(mi))
        + s("") + struct.pack("<QQ", len(chunk_records), len(chunk_records))
    )
    out += rec(OP_CHUNK_INDEX, ci)
    stats = (
        struct.pack("<QHIIII", 1, 1, 1, 0, 0, 1)
        + struct.pack("<QQ", t_ns, t_ns)
        + struct.pack("<I", 10) + struct.pack("<HQ", 1, 1)
    )
    out += rec(OP_STATISTICS, stats)
    summary_offset_start = len(out)
    out += rec(OP_SUMMARY_OFFSET, struct.pack("<BQQ", OP_SCHEMA, summary_start, 9 + len(schema)))
    footer_prefix = struct.pack("<BQ", OP_FOOTER, 20) + struct.pack(
        "<QQ", summary_start, summary_offset_start
    )
    crc = zlib.crc32(bytes(out[summary_start:]) + footer_prefix)
    out += footer_prefix + struct.pack("<I", crc)
    out += MAGIC

    path = str(tmp_path / "rosbag2_style.mcap")
    open(path, "wb").write(bytes(out))
    with McapReader(path) as r:
        assert r.topic_names() == {"/sonar/img": IMAGE_TYPE}
        msgs = list(r.messages())
    assert len(msgs) == 1
    topic, ts, m = msgs[0]
    assert topic == "/sonar/img" and ts == pytest.approx(5.0)
    np.testing.assert_array_equal(
        np.frombuffer(m.data, np.uint8).reshape(20, 16), img
    )


def test_mcap_stream_and_offline_paths(tmp_path, small_cfg):
    """An mcap recording maps identically through the streaming stack and
    the offline loader."""
    import jax.numpy as jnp

    from sonar_3d_reconstruction_tpu.io.bag import (
        IMAGE_TYPE, ODOMETRY_TYPE, load_bag_sequence,
    )
    from sonar_3d_reconstruction_tpu.io.mcap import McapWriter
    from sonar_3d_reconstruction_tpu.stream import StreamingMapper

    cfg = small_cfg
    n = 4
    images = np.stack(
        [synthetic_ping(cfg.image_height, cfg.image_width, seed=40 + i)
         for i in range(n)]
    )
    positions = np.cumsum(np.full((n, 3), 0.1), axis=0)
    quats = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    path = str(tmp_path / "rec.mcap")
    with McapWriter(path) as w:
        w.add_topic("/sensor/sonar/oculus/m750d/image", IMAGE_TYPE)
        w.add_topic("/fast_lio/odometry", ODOMETRY_TYPE)
        for i in range(n):
            t = 700.0 + i
            w.write(
                "/sensor/sonar/oculus/m750d/image", t,
                ImageMsg(t, "s", cfg.image_height, cfg.image_width, "mono8",
                         False, cfg.image_width, images[i].tobytes()),
            )
            w.write(
                "/fast_lio/odometry", t,
                OdometryMsg(t, "camera_init", "body", positions[i], quats[i]),
            )

    sm = StreamingMapper(cfg, chunk_size=4, initial_capacity=1 << 13,
                         dtype=jnp.float64)
    stats = sm.run_bag(path)
    assert stats.pairs == n

    imgs, pos, qs, stamps = load_bag_sequence(path)
    np.testing.assert_array_equal(imgs, images)
    np.testing.assert_allclose(pos, positions)


def test_pair_streams_unsorted_inputs():
    """Both pairing backends must handle unsorted stamp streams (mcap file
    order) identically to the sorted case."""
    rng = np.random.default_rng(5)
    ping_t = rng.uniform(0, 50, 60)      # deliberately unsorted
    pose_t = rng.uniform(0, 50, 55)
    a = pair_streams(ping_t, pose_t, slop=0.3)
    # equivalent to pairing the sorted streams then mapping indices back
    ps, qs = np.argsort(ping_t), np.argsort(pose_t)
    b_sorted = pair_streams(ping_t[ps], pose_t[qs], slop=0.3)
    b = sorted((int(ps[i]), int(qs[j])) for i, j in b_sorted)
    assert sorted(a) == b


def test_mcap_messages_time_ordered(tmp_path):
    """McapReader.messages must yield log-time order even when the file's
    record order is interleaved per channel (chunked rosbag2 recordings
    group messages out of log-time order; the streaming synchronizer's
    10-deep queues silently evict on disordered arrival)."""
    from sonar_3d_reconstruction_tpu.io.bag import (
        IMAGE_TYPE, ODOMETRY_TYPE, ImageMsg, OdometryMsg,
    )
    from sonar_3d_reconstruction_tpu.io.mcap import McapReader, McapWriter

    path = str(tmp_path / "ooo.mcap")
    img = np.zeros((4, 4), np.uint8)
    with McapWriter(path) as w:
        w.add_topic("/img", IMAGE_TYPE)
        w.add_topic("/odo", ODOMETRY_TYPE)
        # all images first, then all odometry: file order != log-time order
        for t in (3.0, 1.0, 2.0):
            w.write("/img", t, ImageMsg(t, "f", 4, 4, "mono8", False, 4,
                                        img.tobytes()))
        for t in (2.5, 0.5):
            w.write("/odo", t, OdometryMsg(t, "map", "base", [0, 0, 0],
                                           [0, 0, 0, 1]))
    with McapReader(path) as r:
        stamps = [ts for _, ts, _ in r.messages(["/img", "/odo"])]
    assert stamps == sorted(stamps) == [0.5, 1.0, 2.0, 2.5, 3.0]


def test_writers_close_idempotent(tmp_path):
    from sonar_3d_reconstruction_tpu.io.bag import BagWriter, IMAGE_TYPE
    from sonar_3d_reconstruction_tpu.io.mcap import McapWriter

    p1 = str(tmp_path / "a.db3")
    with BagWriter(p1) as w:
        tid = w.add_topic("/a", IMAGE_TYPE)
        assert w.add_topic("/a", IMAGE_TYPE) == tid  # idempotent re-add
        w.close()  # explicit close inside the with-block must not crash
    p2 = str(tmp_path / "a.mcap")
    with McapWriter(p2) as w:
        cid = w.add_topic("/a", IMAGE_TYPE)
        assert w.add_topic("/a", IMAGE_TYPE) == cid
        w.close()
