"""External-interop bag fixtures: read bytes this repo's writers never emit.

The committed binaries (``tests/fixtures/external_survey.{db3,mcap}``) were
produced by ``tests/fixtures/make_external_fixtures.py`` — an INDEPENDENT
clean-room implementation of the rosbag2-Humble sqlite3 layout and the mcap
spec that shares no code with ``io/bag.py`` / ``io/mcap.py`` and exercises
layouts the in-repo writers cannot produce: the full Humble schema
(``schema``/``metadata`` tables, ``offered_qos_profiles``), BIG-ENDIAN XCDR1
odometry blobs, mono16 big-endian pixel data with padded rows, a zstd chunk
whose schemas/channels live INSIDE the chunk, MessageIndex / Metadata /
Attachment records that must be skipped, and a summary without Statistics.

Closes the "our reader only reads our writer" gap (the real KIRO recordings are not in the
reference snapshot and this image has no ROS2 + zero egress, so a genuinely
foreign file cannot be produced here; fixture independence is the strongest
available substitute — see the generator's docstring).

Reference interop surface: bag replay drives the reference via ``ros2 bag
play`` (launch/3d_mapping.launch.py:167-178); message consumption semantics
per scripts/3d_mapper_node.py:294-333.
"""

import os

import numpy as np
import pytest

from tests.fixtures.make_external_fixtures import (
    HEIGHT,
    IMAGE_TOPIC,
    N_MSGS,
    ODOM_TOPIC,
    WIDTH,
    expected_image_u16,
    expected_pose,
    stamp_of,
)

from sonar_3d_reconstruction_tpu.io.bag import (
    BagReader,
    ImageMsg,
    OdometryMsg,
    decode_image_msg,
    decode_odometry_msg,
)
from sonar_3d_reconstruction_tpu.io.image import decode_image
from sonar_3d_reconstruction_tpu.io.mcap import McapReader, open_bag

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
DB3 = os.path.join(FIXTURES, "external_survey.db3")
MCAP = os.path.join(FIXTURES, "external_survey.mcap")


def expected_image_u8(i: int) -> np.ndarray:
    # reference mono16 handling: (img / 256).astype(uint8) (node:308-310)
    return (expected_image_u16(i) / 256).astype(np.uint8)


def _check_stream(msgs):
    """msgs: list of (topic, stamp, decoded) from either reader."""
    images = [m for m in msgs if m[0] == IMAGE_TOPIC]
    odoms = [m for m in msgs if m[0] == ODOM_TOPIC]
    assert len(images) == N_MSGS and len(odoms) == N_MSGS
    for i, (_, log_t, msg) in enumerate(images):
        assert isinstance(msg, ImageMsg)
        assert msg.encoding == "mono16" and msg.is_bigendian
        assert msg.height == HEIGHT and msg.width == WIDTH
        assert msg.step > WIDTH * 2, "fixture rows are padded"
        img = decode_image(msg.data, msg.height, msg.width, msg.encoding,
                           msg.step, msg.is_bigendian)
        np.testing.assert_array_equal(img, expected_image_u8(i))
        assert abs(msg.stamp - stamp_of(i)) < 1e-6
    for i, (_, log_t, msg) in enumerate(odoms):
        assert isinstance(msg, OdometryMsg)
        assert msg.frame_id == "camera_init" and msg.child_frame_id == "body"
        pos, quat = expected_pose(i)
        # float64 values travel bit-exactly through CDR (either endianness)
        np.testing.assert_array_equal(msg.position, pos)
        np.testing.assert_array_equal(msg.orientation, quat)
        np.testing.assert_array_equal(
            msg.pose_covariance, np.arange(36) * 0.01
        )


def test_db3_external_layout_reads():
    with BagReader(DB3) as r:
        names = r.topic_names()
        assert names[IMAGE_TOPIC].endswith("Image")
        assert names[ODOM_TOPIC].endswith("Odometry")
        _check_stream(list(r.messages()))


def test_mcap_external_layout_reads():
    with McapReader(MCAP) as r:
        names = r.topic_names()
        assert names[IMAGE_TOPIC].endswith("Image")
        assert names[ODOM_TOPIC].endswith("Odometry")
        _check_stream(list(r.messages()))


def test_open_bag_sniffs_both():
    assert isinstance(open_bag(DB3), BagReader)
    assert isinstance(open_bag(MCAP), McapReader)


def test_big_endian_cdr_odometry_blob():
    """The odometry blobs are representation 0x0000 (CDR_BE) — a layout the
    in-repo writer never produces."""
    with BagReader(DB3) as r:
        blob = next(
            raw for topic, _typ, _ts, raw in r.raw_messages([ODOM_TOPIC])
        )
    assert blob[0] == 0x00 and blob[1] == 0x00, "fixture must be CDR_BE"
    msg = decode_odometry_msg(blob)
    pos, quat = expected_pose(0)
    np.testing.assert_array_equal(msg.position, pos)
    np.testing.assert_array_equal(msg.orientation, quat)


def test_native_decoders_on_external_blobs():
    """The C++ batch decoders parse the foreign blobs (incl. BE odometry and
    BE mono16 pixels) identically to the Python decoders."""
    from sonar_3d_reconstruction_tpu.io import native

    if not native.available():
        pytest.skip("native library unavailable")
    with BagReader(DB3) as r:
        img_blobs = [raw for _t, _y, _s, raw in r.raw_messages([IMAGE_TOPIC])]
        odo_blobs = [raw for _t, _y, _s, raw in r.raw_messages([ODOM_TOPIC])]

    stamps, positions, quats = native.odometry_decode_batch(odo_blobs)
    for i in range(N_MSGS):
        pos, quat = expected_pose(i)
        np.testing.assert_array_equal(positions[i], pos)
        np.testing.assert_array_equal(quats[i], quat)
        py = decode_odometry_msg(odo_blobs[i])
        assert abs(stamps[i] - py.stamp) < 1e-9

    stamps_i, images = native.image_decode_batch(img_blobs, HEIGHT, WIDTH)
    for i in range(N_MSGS):
        np.testing.assert_array_equal(images[i], expected_image_u8(i))
        py = decode_image_msg(img_blobs[i])
        assert abs(stamps_i[i] - py.stamp) < 1e-9


def test_mcap_chunk_is_foreign_shaped():
    """Sanity-pin the fixture's foreignness: schemas/channels inside the
    chunk, MessageIndex + Metadata + Attachment records present, and (when
    codecs are available at generation time) a compressed chunk."""
    import struct

    with open(MCAP, "rb") as f:
        data = f.read()
    ops = []
    pos = 8
    while pos + 9 <= len(data):
        op = data[pos]
        (length,) = struct.unpack_from("<Q", data, pos + 1)
        ops.append(op)
        if op == 0x02:
            break
        pos += 9 + length
    assert 0x07 in ops, "MessageIndex records present"
    assert 0x0C in ops and 0x09 in ops, "Metadata + Attachment present"
    assert 0x05 not in ops, "messages only inside the chunk"
    assert 0x0B not in ops, "no Statistics record — readers must not rely"


def test_bagwriter_emits_humble_layout(tmp_path):
    """Reverse interop: OUR writer emits the full rosbag2-Humble storage
    layout (schema/metadata tables, QoS column, timestamp index, metadata
    YAML with per-topic counts) so `ros2 bag info/play` can consume bags
    this framework records — not only the other way around."""
    import sqlite3

    from sonar_3d_reconstruction_tpu.io.bag import BagWriter

    path = str(tmp_path / "ours.db3")
    with BagWriter(path) as w:
        w.add_topic(IMAGE_TOPIC, "sensor_msgs/msg/Image")
        w.add_topic(ODOM_TOPIC, "nav_msgs/msg/Odometry")
        for i in range(3):
            t = 100.0 + i
            w.write(ODOM_TOPIC, t, OdometryMsg(
                t, "camera_init", "body", np.zeros(3),
                np.array([0, 0, 0, 1.0])))
    conn = sqlite3.connect(path)
    tables = {r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type='table'")}
    assert {"schema", "metadata", "topics", "messages"} <= tables
    assert conn.execute("SELECT ros_distro FROM schema").fetchone()[0] \
        == "humble"
    idx = {r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type='index' "
        "AND name='timestamp_idx'")}
    assert idx == {"timestamp_idx"}
    qos = conn.execute(
        "SELECT offered_qos_profiles FROM topics LIMIT 1").fetchone()[0]
    assert "reliability: 2" in qos
    meta = conn.execute("SELECT metadata FROM metadata").fetchone()[0]
    assert "rosbag2_bagfile_information" in meta
    assert "message_count: 3" in meta
    assert f"name: {ODOM_TOPIC}" in meta
    conn.close()
    # and our own reader still round-trips it
    with BagReader(path) as r:
        msgs = list(r.messages())
    assert len(msgs) == 3


def test_external_fixture_drives_full_pipeline():
    """Foreign bytes -> time pairing -> mapper: the complete replay path the
    reference exercises with `ros2 bag play` (launch:167-178)."""
    import jax.numpy as jnp

    from sonar_3d_reconstruction_tpu.config import MapperConfig
    from sonar_3d_reconstruction_tpu.io.timesync import pair_streams
    from sonar_3d_reconstruction_tpu.pipeline import map_ping_sequence

    pings, poses = [], []
    with open_bag(DB3) as r:
        for topic, ts, msg in r.messages():
            (pings if topic == IMAGE_TOPIC else poses).append((ts, msg))
    pairs = pair_streams(
        np.array([t for t, _ in pings]), np.array([t for t, _ in poses]),
        slop=0.1,
    )
    assert len(pairs) == N_MSGS

    cfg = MapperConfig(
        image_height=HEIGHT, image_width=WIDTH, max_range=4.0,
        min_range=0.5, voxel_resolution=0.2, intensity_threshold=40,
    )
    images = np.stack([
        decode_image(m.data, m.height, m.width, m.encoding, m.step,
                     m.is_bigendian)
        for m in (pings[i][1] for i, _ in pairs)
    ])
    positions = np.stack([poses[j][1].position for _, j in pairs])
    quats = np.stack([poses[j][1].orientation for _, j in pairs])
    state, stats = map_ping_sequence(
        images, positions, quats, cfg, dtype=jnp.float64, window=2,
    )
    assert int(np.asarray(stats["num_candidates"]).sum()) > 0
    assert int(state.used) > 0
