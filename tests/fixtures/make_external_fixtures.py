"""Generate the checked-in EXTERNAL-interop bag fixtures.

These fixtures exist to close the "our reader only reads our writer" loop:
the real KIRO water-tank recordings are not
in the snapshot and this image has no ROS2 and zero egress, so a genuinely
rosbag2-written file cannot be produced here.  Instead this generator is a
CLEAN-ROOM, INDEPENDENT implementation of the container layouts, written
from the public specs (rosbag2 sqlite3 storage schema as created by ROS2
Humble; the mcap format spec at mcap.dev) — it shares NO code with
``io/bag.py`` / ``io/mcap.py`` and deliberately produces byte layouts the
repo's own writers never emit:

.db3 (rosbag2 Humble storage layout, vs BagWriter's minimal tables):
  * ``schema`` + ``metadata`` tables with a rosbag2-style YAML blob;
  * ``topics`` with ``serialization_format`` and ``offered_qos_profiles``
    columns carrying a QoS YAML list;
  * a ``timestamp_idx`` index; explicit topic ids starting at 3;
  * odometry messages encoded as BIG-ENDIAN XCDR1 (representation 0x0000)
    — the repo's writer is LE-only;
  * image messages carrying mono16 BIG-ENDIAN pixel data
    (``is_bigendian=1``) with row padding (step > width*2).

.mcap (spec-complete layout, vs McapWriter's output):
  * Header profile "ros2" with a foreign library string;
  * Schema records with real ``ros2msg`` definition text (nonzero length);
  * Channel records with a non-empty metadata map;
  * messages inside a zstd chunk (store fallback if no codec), with
    nonzero sequence numbers and publish_time != log_time;
  * MessageIndex records after the chunk, and Metadata/Attachment records
    (ops 0x0C/0x09) the reader must skip;
  * no Statistics / SummaryOffset records (summary has only
    Schema/Channel/Footer) — readers must not rely on them.

Message content is deterministic (formulas below) so the test asserts
exact decoded values.  Run from the repo root:
    python tests/fixtures/make_external_fixtures.py
"""

import os
import sqlite3
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

IMAGE_TOPIC = "/sensor/sonar/oculus/m750d/image"
ODOM_TOPIC = "/fast_lio/odometry"
IMAGE_TYPE = "sensor_msgs/msg/Image"
ODOM_TYPE = "nav_msgs/msg/Odometry"

N_MSGS = 6
HEIGHT, WIDTH = 16, 8
STEP = WIDTH * 2 + 6  # padded rows: step > width*itemsize


def expected_image_u16(i: int) -> np.ndarray:
    r = np.arange(HEIGHT)[:, None]
    b = np.arange(WIDTH)[None, :]
    return ((r * 17 + b * 53 + i * 29) % 65536).astype(np.uint16)


def expected_pose(i: int):
    pos = np.array([0.1 * i, -0.05 * i, 1.0 + 0.01 * i])
    yaw = 0.3 * i
    quat = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
    return pos, quat


def stamp_of(i: int) -> float:
    return 1700000000.0 + 0.5 * i


# ---------------------------------------------------------------------------
# Independent CDR encoders (NOT io/bag.py): one per endianness.
# ---------------------------------------------------------------------------


class Cdr:
    def __init__(self, big: bool):
        self.big = big
        # encapsulation: 0x0000 = CDR_BE, 0x0001 = CDR_LE; options 0
        self.out = bytearray(b"\x00\x00\x00\x00" if big else b"\x00\x01\x00\x00")

    def _pad(self, align: int) -> None:
        rem = (len(self.out) - 4) % align
        if rem:
            self.out += b"\x00" * (align - rem)

    def prim(self, fmt: str, v) -> None:
        size = struct.calcsize(fmt)
        self._pad(size)
        self.out += struct.pack((">" if self.big else "<") + fmt, v)

    def string(self, s: str) -> None:
        b = s.encode() + b"\x00"
        self.prim("I", len(b))
        self.out += b

    def raw(self, b: bytes) -> None:
        self.out += b

    def f64s(self, vals) -> None:
        for v in np.asarray(vals, np.float64).ravel():
            self.prim("d", float(v))

    def header(self, stamp: float, frame_id: str) -> None:
        sec = int(stamp)
        self.prim("i", sec)
        self.prim("I", int(round((stamp - sec) * 1e9)))
        self.string(frame_id)


def image_blob(i: int) -> bytes:
    """sensor_msgs/msg/Image, LE CDR, mono16 BIG-ENDIAN pixels, padded rows."""
    img = expected_image_u16(i)
    rows = []
    for r in range(HEIGHT):
        row = img[r].astype(">u2").tobytes()
        rows.append(row + b"\xAA" * (STEP - len(row)))  # visible pad bytes
    c = Cdr(big=False)
    c.header(stamp_of(i), "sonar_link")
    c.prim("I", HEIGHT)
    c.prim("I", WIDTH)
    c.string("mono16")
    c.prim("B", 1)  # is_bigendian
    c.prim("I", STEP)
    data = b"".join(rows)
    c.prim("I", len(data))
    c.raw(data)
    return bytes(c.out)


def odometry_blob(i: int) -> bytes:
    """nav_msgs/msg/Odometry, BIG-ENDIAN CDR, full pose+twist covariances."""
    pos, quat = expected_pose(i)
    c = Cdr(big=True)
    c.header(stamp_of(i), "camera_init")
    c.string("body")
    c.f64s(pos)
    c.f64s(quat)
    c.f64s(np.arange(36) * 0.01)     # pose covariance (decoder exposes it)
    c.f64s(np.full(6, 0.25))         # twist (decoder must skip)
    c.f64s(np.zeros(36))             # twist covariance
    return bytes(c.out)


# ---------------------------------------------------------------------------
# rosbag2 Humble sqlite3 layout
# ---------------------------------------------------------------------------

QOS_YAML = (
    "- history: 3\n  depth: 0\n  reliability: 2\n  durability: 2\n"
    "  deadline:\n    sec: 9223372036\n    nsec: 854775807\n"
    "  lifespan:\n    sec: 9223372036\n    nsec: 854775807\n"
    "  liveliness: 1\n  liveliness_lease_duration:\n    sec: 9223372036\n"
    "    nsec: 854775807\n  avoid_ros_namespace_conventions: false"
)


def make_db3(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)
    conn = sqlite3.connect(path)
    cur = conn.cursor()
    cur.execute(
        "CREATE TABLE schema(schema_version INTEGER PRIMARY KEY, "
        "ros_distro TEXT NOT NULL)"
    )
    cur.execute("INSERT INTO schema VALUES (3, 'humble')")
    cur.execute(
        "CREATE TABLE metadata(id INTEGER PRIMARY KEY, "
        "metadata_version INTEGER NOT NULL, metadata TEXT NOT NULL)"
    )
    cur.execute(
        "INSERT INTO metadata VALUES (1, 5, ?)",
        ("rosbag2_bagfile_information:\n  version: 5\n"
         "  storage_identifier: sqlite3\n  duration:\n    nanoseconds: "
         f"{int((N_MSGS - 1) * 0.5e9)}\n",),
    )
    cur.execute(
        "CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT NOT NULL, "
        "type TEXT NOT NULL, serialization_format TEXT NOT NULL, "
        "offered_qos_profiles TEXT NOT NULL)"
    )
    # rosbag2 numbers topics across the whole recording session; starting
    # at 3 mimics a bag whose earlier topics (/tf_static etc.) were dropped
    cur.execute("INSERT INTO topics VALUES (3, ?, ?, 'cdr', ?)",
                (IMAGE_TOPIC, IMAGE_TYPE, QOS_YAML))
    cur.execute("INSERT INTO topics VALUES (4, ?, ?, 'cdr', ?)",
                (ODOM_TOPIC, ODOM_TYPE, QOS_YAML))
    cur.execute(
        "CREATE TABLE messages(id INTEGER PRIMARY KEY, "
        "topic_id INTEGER NOT NULL, timestamp INTEGER NOT NULL, "
        "data BLOB NOT NULL)"
    )
    cur.execute("CREATE INDEX timestamp_idx ON messages (timestamp ASC)")
    mid = 1
    for i in range(N_MSGS):
        t_ns = int(round(stamp_of(i) * 1e9))
        # odometry logged slightly BEFORE its paired image, as live DDS does
        cur.execute("INSERT INTO messages VALUES (?, 4, ?, ?)",
                    (mid, t_ns - 2_000_000, odometry_blob(i)))
        mid += 1
        cur.execute("INSERT INTO messages VALUES (?, 3, ?, ?)",
                    (mid, t_ns, image_blob(i)))
        mid += 1
    conn.commit()
    conn.close()


# ---------------------------------------------------------------------------
# mcap layout (from the spec; shares nothing with io/mcap.py)
# ---------------------------------------------------------------------------

MAGIC = b"\x89MCAP0\r\n"


def rec(op: int, payload: bytes) -> bytes:
    return struct.pack("<BQ", op, len(payload)) + payload


def mstr(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def kv_map(d: dict) -> bytes:
    body = b"".join(mstr(k) + mstr(v) for k, v in d.items())
    return struct.pack("<I", len(body)) + body


IMAGE_MSGDEF = (
    "std_msgs/Header header\nuint32 height\nuint32 width\n"
    "string encoding\nuint8 is_bigendian\nuint32 step\nuint8[] data\n"
)
ODOM_MSGDEF = (
    "std_msgs/Header header\nstring child_frame_id\n"
    "geometry_msgs/PoseWithCovariance pose\n"
    "geometry_msgs/TwistWithCovariance twist\n"
)


def make_mcap(path: str) -> None:
    from sonar_3d_reconstruction_tpu.io import native

    compression = ""
    for name in ("zstd", "lz4"):
        if native.available() and native.codec_available(name):
            compression = name
            break

    out = bytearray()
    out += MAGIC
    out += rec(0x01, mstr("ros2") + mstr("libmcap 1.3.0; rosbag2_storage_mcap"))
    schema_recs = [
        rec(0x03, struct.pack("<H", 7) + mstr(IMAGE_TYPE) + mstr("ros2msg")
            + struct.pack("<I", len(IMAGE_MSGDEF)) + IMAGE_MSGDEF.encode()),
        rec(0x03, struct.pack("<H", 8) + mstr(ODOM_TYPE) + mstr("ros2msg")
            + struct.pack("<I", len(ODOM_MSGDEF)) + ODOM_MSGDEF.encode()),
    ]
    channel_recs = [
        rec(0x04, struct.pack("<HH", 11, 7) + mstr(IMAGE_TOPIC) + mstr("cdr")
            + kv_map({"offered_qos_profiles": QOS_YAML})),
        rec(0x04, struct.pack("<HH", 12, 8) + mstr(ODOM_TOPIC) + mstr("cdr")
            + kv_map({"offered_qos_profiles": QOS_YAML})),
    ]

    # chunk records: schemas+channels+messages all INSIDE the chunk, the way
    # rosbag2_storage_mcap writes them
    inner = bytearray()
    for r in schema_recs + channel_recs:
        inner += r
    msg_offsets = {11: [], 12: []}
    for i in range(N_MSGS):
        t_ns = int(round(stamp_of(i) * 1e9))
        for cid, blob, t in (
            (12, odometry_blob(i), t_ns - 2_000_000),
            (11, image_blob(i), t_ns),
        ):
            msg_offsets[cid].append((t, len(inner)))
            inner += rec(0x05, struct.pack("<HIQQ", cid, 100 + i, t,
                                           t + 1_000_000) + blob)
    records = bytes(inner)
    if compression:
        body = native.compress(compression, records)
    else:
        body = records
    t0 = int(round(stamp_of(0) * 1e9)) - 2_000_000
    t1 = int(round(stamp_of(N_MSGS - 1) * 1e9))
    chunk_payload = (
        struct.pack("<QQQI", t0, t1, len(records), zlib.crc32(records))
        + mstr(compression) + struct.pack("<Q", len(body)) + body
    )
    out += rec(0x06, chunk_payload)
    # MessageIndex per channel (reader must skip these)
    for cid, offs in msg_offsets.items():
        body_idx = b"".join(struct.pack("<QQ", t, o) for t, o in offs)
        out += rec(0x07, struct.pack("<H", cid)
                   + struct.pack("<I", len(body_idx)) + body_idx)
    # Metadata + Attachment records (readers must skip unknown/unused ops)
    out += rec(0x0C, mstr("rosbag2") + kv_map({"note": "external fixture"}))
    out += rec(0x09, struct.pack("<QQ", t0, t0) + mstr("calib.bin")
               + mstr("application/octet-stream")
               + struct.pack("<Q", 4) + b"\x01\x02\x03\x04"
               + struct.pack("<I", 0))
    out += rec(0x0F, struct.pack("<I", 0))  # DataEnd
    # Minimal summary: schemas+channels only, footer WITHOUT summary crc
    summary_start = len(out)
    for r in schema_recs + channel_recs:
        out += r
    out += rec(0x02, struct.pack("<QQI", summary_start, 0, 0))
    out += MAGIC
    with open(path, "wb") as f:
        f.write(out)


if __name__ == "__main__":
    db3 = os.path.join(HERE, "external_survey.db3")
    mcap = os.path.join(HERE, "external_survey.mcap")
    make_db3(db3)
    make_mcap(mcap)
    print("wrote", db3, os.path.getsize(db3), "bytes")
    print("wrote", mcap, os.path.getsize(mcap), "bytes")
