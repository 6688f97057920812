"""Minimal mcap container support (read/write) for bag replay.

rosbag2 records either sqlite3 (io/bag.py) or mcap; this reads the subset
the mapper needs — CDR-encoded ``sensor_msgs/msg/Image`` and
``nav_msgs/msg/Odometry`` messages — from the public mcap format
(magic + [opcode u8][length u64][payload] records; strings are u32-length
prefixed; Message payload = channel_id u16, sequence u32, log_time u64,
publish_time u64, data).

Uncompressed files/chunks and lz4/zstd-compressed chunks are all supported:
compressed chunks decode through the native library (io/native.py →
native/sonar3d_io.cpp, which dlopens the system libzstd/liblz4 — rosbag2's
mcap writer defaults to zstd chunks, so this is the real-field-data path),
with the optional python ``zstandard``/``lz4`` modules as a fallback when
present.  The writer emits uncompressed chunkless files by default and can
emit compressed-chunk files (``chunk_compression=``) for fixtures/recording.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from sonar_3d_reconstruction_tpu.io.bag import (
    IMAGE_TYPE,
    ODOMETRY_TYPE,
    ImageMsg,
    OdometryMsg,
    decode_image_msg,
    decode_odometry_msg,
    encode_image_msg,
    encode_odometry_msg,
)

MAGIC = b"\x89MCAP0\r\n"

OP_HEADER = 0x01
OP_FOOTER = 0x02
OP_SCHEMA = 0x03
OP_CHANNEL = 0x04
OP_MESSAGE = 0x05
OP_CHUNK = 0x06
OP_MESSAGE_INDEX = 0x07
OP_CHUNK_INDEX = 0x08
OP_STATISTICS = 0x0B
OP_SUMMARY_OFFSET = 0x0E
OP_DATA_END = 0x0F


def _read_str(buf: memoryview, pos: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, pos)
    s = bytes(buf[pos + 4 : pos + 4 + n]).decode("utf-8")
    return s, pos + 4 + n


def _records(buf: memoryview) -> Iterator[Tuple[int, memoryview]]:
    pos = 0
    end = len(buf)
    while pos + 9 <= end:
        op = buf[pos]
        (length,) = struct.unpack_from("<Q", buf, pos + 1)
        if pos + 9 + length > end:
            # a silently clamped record would present a truncated bag as a
            # successfully (but partially) mapped one
            raise ValueError(
                f"truncated mcap record: op=0x{op:02x} at byte {pos} claims "
                f"{length} payload bytes but only {end - pos - 9} remain"
            )
        payload = buf[pos + 9 : pos + 9 + length]
        yield op, payload
        if op == OP_FOOTER:
            return
        pos += 9 + length


def _decode_chunk(payload: memoryview) -> memoryview:
    """Chunk record payload -> records bytes, decompressing if needed.

    Decompression prefers the native library (system libzstd/liblz4 via
    dlopen, no Python deps); the optional ``zstandard``/``lz4`` modules are
    fallbacks.  The decoded length is validated against the chunk header's
    uncompressed_size either way, and a nonzero ``uncompressed_crc`` is
    verified over the (decompressed) records bytes — the spec's 0 value
    means "not computed" and is the only case that skips the check, so a
    silently corrupted chunk (compressed or not) cannot present as a
    successfully mapped bag segment.
    """

    def _check_crc(records_bytes) -> None:
        if crc != 0 and zlib.crc32(records_bytes) != crc:
            raise ValueError(
                f"corrupt mcap chunk: uncompressed records CRC32 "
                f"0x{zlib.crc32(records_bytes):08x} != header 0x{crc:08x}"
            )

    (uncompressed_size,) = struct.unpack_from("<Q", payload, 16)
    pos = 8 + 8 + 8  # message start/end times, uncompressed_size
    (crc,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    compression, pos = _read_str(payload, pos)
    (rec_len,) = struct.unpack_from("<Q", payload, pos)
    pos += 8
    records = payload[pos : pos + rec_len]
    if len(records) != rec_len:
        # memoryview slicing clamps silently; presenting a truncated chunk
        # as complete is exactly what _records' guard exists to prevent
        raise ValueError(
            f"corrupt mcap chunk: records field claims {rec_len} bytes, "
            f"chunk payload holds {len(records)}"
        )
    if compression == "":
        _check_crc(records)
        return records
    if compression not in ("lz4", "zstd"):
        raise NotImplementedError(f"mcap chunk compression {compression!r}")

    from sonar_3d_reconstruction_tpu.io import native

    if native.available() and native.codec_available(compression):
        inner = native.decompress(compression, bytes(records), uncompressed_size)
        _check_crc(inner)
        return memoryview(inner)
    if compression == "lz4":
        try:
            import lz4.frame  # type: ignore
        except ImportError as e:
            raise NotImplementedError(
                "lz4-compressed mcap chunk; neither the native liblz4 codec "
                "nor the python lz4 module is available"
            ) from e
        inner = lz4.frame.decompress(bytes(records))
    else:
        try:
            import zstandard  # type: ignore
        except ImportError as e:
            raise NotImplementedError(
                "zstd-compressed mcap chunk; neither the native libzstd "
                "codec nor the python zstandard module is available"
            ) from e
        inner = zstandard.ZstdDecompressor().decompress(bytes(records))
    if len(inner) != uncompressed_size:
        raise ValueError(
            f"corrupt {compression} mcap chunk: header claims "
            f"{uncompressed_size} uncompressed bytes, got {len(inner)}"
        )
    _check_crc(inner)
    return memoryview(inner)


class McapReader:
    """Reads Image / Odometry messages from an mcap file."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        assert data[: len(MAGIC)] == MAGIC, f"{path} is not an mcap file"
        self._buf = memoryview(data)[len(MAGIC):]
        self._schemas: Dict[int, str] = {}          # schema_id -> type name
        self._channels: Dict[int, Tuple[str, int]] = {}  # chan -> (topic, schema)

    def _handle_meta(self, op: int, payload: memoryview) -> None:
        if op == OP_SCHEMA:
            (sid,) = struct.unpack_from("<H", payload, 0)
            name, _ = _read_str(payload, 2)
            self._schemas[sid] = name
        elif op == OP_CHANNEL:
            (cid, sid) = struct.unpack_from("<HH", payload, 0)
            topic, _ = _read_str(payload, 4)
            self._channels[cid] = (topic, sid)

    def _iter_messages(
        self, buf: memoryview
    ) -> Iterator[Tuple[int, float, bytes]]:
        """Yields (channel_id, log_time_sec, cdr_blob) handling chunks."""
        for op, payload in _records(buf):
            if op in (OP_SCHEMA, OP_CHANNEL):
                self._handle_meta(op, payload)
            elif op == OP_MESSAGE:
                (cid,) = struct.unpack_from("<H", payload, 0)
                (log_time,) = struct.unpack_from("<Q", payload, 6)
                yield cid, log_time * 1e-9, bytes(payload[22:])
            elif op == OP_CHUNK:
                yield from self._iter_messages(_decode_chunk(payload))
            elif op == OP_DATA_END:
                return

    def topic_names(self) -> Dict[str, str]:
        # metadata records may appear at top level or inside chunks; walk
        # both without decoding message payloads
        def walk(buf: memoryview) -> None:
            for op, payload in _records(buf):
                if op in (OP_SCHEMA, OP_CHANNEL):
                    self._handle_meta(op, payload)
                elif op == OP_CHUNK:
                    walk(_decode_chunk(payload))

        walk(self._buf)
        return {
            topic: self._schemas.get(sid, "?")
            for topic, sid in self._channels.values()
        }

    def raw_messages(
        self, topic_names: Optional[List[str]] = None
    ) -> Iterator[Tuple[str, str, float, bytes]]:
        """Yield (topic, type, log_time_sec, cdr_blob) in file order."""
        for cid, ts, blob in self._iter_messages(self._buf):
            chan = self._channels.get(cid)
            if chan is None:
                continue
            topic, sid = chan
            if topic_names is not None and topic not in topic_names:
                continue
            yield topic, self._schemas.get(sid, "?"), ts, blob

    def messages(
        self, topic_names: Optional[List[str]] = None
    ) -> Iterator[Tuple[str, float, object]]:
        """Yield (topic, log_time_sec, decoded_msg) in LOG-TIME order,
        decoding Image/Odometry only.

        File order is NOT enough: chunked recordings may group messages
        per channel / out of log-time order, and the streaming
        synchronizer downstream (queue depth 10) silently evicts on
        disordered arrival — the same hazard io/bag.load_bag_sequence
        documents and sorts around.  The whole file is already resident
        (``__init__`` reads it), so the sort adds index cost only; use
        ``raw_messages`` for file order."""
        entries = sorted(self.raw_messages(topic_names), key=lambda e: e[2])
        for topic, typ, ts, blob in entries:
            if typ == IMAGE_TYPE:
                yield topic, ts, decode_image_msg(blob)
            elif typ == ODOMETRY_TYPE:
                yield topic, ts, decode_odometry_msg(blob)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class McapWriter:
    """Writes an mcap file (fixtures / interop / recording).

    Default: chunkless uncompressed.  With ``chunk_compression`` in
    {"zstd", "lz4"} all message records are buffered into compressed chunk
    records (flushed every ``chunk_size`` bytes and at close) using the
    native codecs — this is how rosbag2's default recordings look, and the
    fixture used to test the compressed reader path.  ``"store"`` buffers
    into UNCOMPRESSED chunk records (compression string "").

    Chunk headers carry a real CRC32 of the uncompressed records (validated
    by the reader); each chunk is followed by per-channel MessageIndex
    records (referenced by offset from the chunk's ChunkIndex, the
    rosbag2_storage_mcap layout); and ``close`` emits a spec-shaped Summary
    section the way rosbag2 recordings end: repeated Schema/Channel
    records, a ChunkIndex per chunk, Statistics, SummaryOffset groups, and
    a Footer with ``summary_start`` + ``summary_crc`` filled in.
    """

    def __init__(
        self,
        path: str,
        chunk_compression: str = "",
        chunk_size: int = 1 << 22,
    ):
        if chunk_compression not in ("", "store", "zstd", "lz4"):
            raise ValueError(f"unsupported compression {chunk_compression!r}")
        self._compression = chunk_compression
        self._chunk_size = chunk_size
        self._chunk_buf: List[bytes] = []
        self._chunk_bytes = 0
        self._chunk_t0: Optional[int] = None
        self._chunk_t1 = 0
        self._chunk_msg_offsets: Dict[int, List[Tuple[int, int]]] = {}
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._write(OP_HEADER, self._str("ros2") + self._str("sonar3d"))
        self._schema_ids: Dict[str, int] = {}
        self._channel_ids: Dict[str, int] = {}
        # summary-section bookkeeping
        self._schema_records: List[bytes] = []
        self._channel_records: List[bytes] = []
        self._chunk_indexes: List[bytes] = []
        self._msg_count = 0
        self._msg_counts: Dict[int, int] = {}  # channel -> count
        self._msg_t0: Optional[int] = None
        self._msg_t1 = 0
        self._closed = False

    @staticmethod
    def _str(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<I", len(b)) + b

    def _write(self, op: int, payload: bytes) -> None:
        self._f.write(struct.pack("<BQ", op, len(payload)) + payload)

    def _write_message(self, payload: bytes, t_ns: int, cid: int) -> None:
        if not self._compression:
            self._write(OP_MESSAGE, payload)
            return
        # per-channel (log_time, offset-into-uncompressed-records) for the
        # chunk's MessageIndex records (mcap spec op 0x07)
        self._chunk_msg_offsets.setdefault(cid, []).append(
            (t_ns, self._chunk_bytes)
        )
        self._chunk_buf.append(
            struct.pack("<BQ", OP_MESSAGE, len(payload)) + payload
        )
        self._chunk_bytes += 9 + len(payload)
        if self._chunk_t0 is None:
            self._chunk_t0 = t_ns
        self._chunk_t0 = min(self._chunk_t0, t_ns)
        self._chunk_t1 = max(self._chunk_t1, t_ns)
        if self._chunk_bytes >= self._chunk_size:
            self._flush_chunk()

    def _flush_chunk(self) -> None:
        if not self._chunk_buf:
            return
        records = b"".join(self._chunk_buf)
        if self._compression == "store":
            compression, compressed = "", records
        else:
            from sonar_3d_reconstruction_tpu.io import native

            compression = self._compression
            compressed = native.compress(compression, records)
        chunk_start = self._f.tell()
        payload = (
            struct.pack("<QQQI", self._chunk_t0 or 0, self._chunk_t1,
                        len(records), zlib.crc32(records))
            + self._str(compression)
            + struct.pack("<Q", len(compressed))
            + compressed
        )
        self._write(OP_CHUNK, payload)
        # MessageIndex records per channel, directly after the chunk (the
        # rosbag2_storage_mcap layout); ChunkIndex references each by file
        # offset and carries the total index length
        mi_start = self._f.tell()
        mi_offsets: List[bytes] = []
        for cid in sorted(self._chunk_msg_offsets):
            mi_offsets.append(
                struct.pack("<HQ", cid, self._f.tell())
            )
            entries = b"".join(
                struct.pack("<QQ", t, off)
                for t, off in self._chunk_msg_offsets[cid]
            )
            self._write(
                OP_MESSAGE_INDEX,
                struct.pack("<H", cid)
                + struct.pack("<I", len(entries)) + entries,
            )
        mi_length = self._f.tell() - mi_start
        mi_map = b"".join(mi_offsets)
        self._chunk_indexes.append(
            struct.pack("<QQQQ", self._chunk_t0 or 0, self._chunk_t1,
                        chunk_start, 9 + len(payload))
            + struct.pack("<I", len(mi_map)) + mi_map
            + struct.pack("<Q", mi_length)
            + self._str(compression)
            + struct.pack("<QQ", len(compressed), len(records))
        )
        self._chunk_buf = []
        self._chunk_bytes = 0
        self._chunk_t0 = None
        self._chunk_t1 = 0
        self._chunk_msg_offsets = {}

    def add_topic(self, name: str, typ: str) -> int:
        if name in self._channel_ids:
            # idempotent: re-adding must NOT mint a new id — len()+1
            # arithmetic would otherwise hand the NEXT topic a live
            # channel id, silently attributing its messages elsewhere
            return self._channel_ids[name]
        if typ not in self._schema_ids:
            sid = len(self._schema_ids) + 1
            self._schema_ids[typ] = sid
            payload = (
                struct.pack("<H", sid) + self._str(typ) + self._str("ros2msg")
                + struct.pack("<I", 0)
            )
            self._write(OP_SCHEMA, payload)
            self._schema_records.append(payload)
        cid = len(self._channel_ids) + 1
        self._channel_ids[name] = cid
        payload = (
            struct.pack("<HH", cid, self._schema_ids[typ])
            + self._str(name) + self._str("cdr") + struct.pack("<I", 0)
        )
        self._write(OP_CHANNEL, payload)
        self._channel_records.append(payload)
        return cid

    def write(self, topic: str, stamp_sec: float, msg) -> None:
        blob = (
            encode_image_msg(msg)
            if isinstance(msg, ImageMsg)
            else encode_odometry_msg(msg)
        )
        t_ns = int(round(stamp_sec * 1e9))
        cid = self._channel_ids[topic]
        self._msg_count += 1
        self._msg_counts[cid] = self._msg_counts.get(cid, 0) + 1
        self._msg_t0 = t_ns if self._msg_t0 is None else min(self._msg_t0, t_ns)
        self._msg_t1 = max(self._msg_t1, t_ns)
        self._write_message(
            struct.pack("<HIQQ", cid, 0, t_ns, t_ns) + blob,
            t_ns,
            cid,
        )

    def close(self) -> None:
        if self._closed:  # idempotent: with-block + explicit close
            return
        self._closed = True
        self._flush_chunk()
        self._write(OP_DATA_END, struct.pack("<I", 0))

        # ---- Summary section (spec layout, as rosbag2 recordings end):
        # repeated Schema + Channel records, ChunkIndex per chunk,
        # Statistics, then SummaryOffset groups and a Footer whose
        # summary_start/summary_offset_start/summary_crc are real.
        summary_start = self._f.tell()

        def group(op: int, payloads: List[bytes]) -> bytes:
            return b"".join(
                struct.pack("<BQ", op, len(p)) + p for p in payloads
            )

        counts = b"".join(
            struct.pack("<HQ", cid, n)
            for cid, n in sorted(self._msg_counts.items())
        )
        statistics = (
            struct.pack(
                "<QHIIII", self._msg_count, len(self._schema_records),
                len(self._channel_records), 0, 0, len(self._chunk_indexes),
            )
            + struct.pack("<QQ", self._msg_t0 or 0, self._msg_t1)
            + struct.pack("<I", len(counts)) + counts
        )
        groups = [
            (OP_SCHEMA, group(OP_SCHEMA, self._schema_records)),
            (OP_CHANNEL, group(OP_CHANNEL, self._channel_records)),
            (OP_CHUNK_INDEX, group(OP_CHUNK_INDEX, self._chunk_indexes)),
            (OP_STATISTICS, group(OP_STATISTICS, [statistics])),
        ]
        offsets = []
        pos = summary_start
        summary = b""
        for op, g in groups:
            if g:
                offsets.append(struct.pack("<BQQ", op, pos, len(g)))
                summary += g
                pos += len(g)
        summary_offset_start = pos
        summary += group(OP_SUMMARY_OFFSET, offsets)

        # footer summary_crc covers [summary_start .. footer's
        # summary_offset_start field inclusive] (mcap spec, Footer record)
        footer_prefix = struct.pack("<BQ", OP_FOOTER, 20) + struct.pack(
            "<QQ", summary_start, summary_offset_start
        )
        crc = zlib.crc32(summary + footer_prefix)
        self._f.write(summary + footer_prefix + struct.pack("<I", crc))
        self._f.write(MAGIC)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_bag(path: str):
    """BagReader for .db3/sqlite or McapReader for .mcap (sniffed by magic)."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
    if head == MAGIC:
        return McapReader(path)
    from sonar_3d_reconstruction_tpu.io.bag import BagReader

    return BagReader(path)
