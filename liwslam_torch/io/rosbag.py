"""Minimal pure-Python ROS1 bag (v2.0) reader/writer — no ROS stack.

OpenLORIS-Scene distributes its sequences as ROS1 bags (reference
readme.md:33-39 plays them back through roslaunch); this module reads the
three topics the reference subscribes to (``lvio_2d_node.cpp:10-19``):
``sensor_msgs/LaserScan``, ``sensor_msgs/Imu``, ``nav_msgs/Odometry`` —
directly from the bag container, so converting real sequences needs no ROS
installation (the round-1 blocker).

Implements the documented bag v2.0 container: length-prefixed records with
``name=value`` headers; 0x03 bag header, 0x05 chunk (none / bz2 / lz4
compression — lz4 frames decoded by a pure-Python fallback when the lz4
package is absent, as in this image), 0x07 connection, 0x02 message data.
Index records (0x04) and chunk-info records (0x06) are skipped on read
(the reader streams in file order; liwslam_torch.io.openloris.load_bag sorts
each sensor stream by stamp, which reproduces rosbag-play's
index-ordered playback).  Message bodies are standard little-endian ROS
serialization.

The writer round-trips the reader in tests and lets the simulator emit
real .bag fixtures; with ``indexed=True`` it reproduces the byte features
of rosbag-C++ output (multiple chunks, bz2/lz4 compression, per-chunk
0x04 index records, trailing connection + 0x06 chunk-info section, bag
header pointing at it) so the reader is exercised against realistic bags
without ROS in the image.

The port's own copy of ``liwslam/io/rosbag.py`` (numpy and the standard
library only).
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass, field

import numpy as np


# --------------------------------------------------------------------------
# pure-Python LZ4 (frame + block) — rosbag's third compression.  The lz4
# package is not in this image; frames produced by roslz4 decode here.


def _xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (the checksum LZ4 frame headers carry)."""
    P1, P2, P3, P4, P5 = (
        2654435761, 2246822519, 3266489917, 668265263, 374761393,
    )
    M = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M

    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + P1 + P2) & M
        v2 = (seed + P2) & M
        v3 = seed & M
        v4 = (seed - P1) & M
        while i + 16 <= n:
            a, b, c, d = struct.unpack_from("<4I", data, i)
            v1 = (rotl((v1 + a * P2) & M, 13) * P1) & M
            v2 = (rotl((v2 + b * P2) & M, 13) * P1) & M
            v3 = (rotl((v3 + c * P2) & M, 13) * P1) & M
            v4 = (rotl((v4 + d * P2) & M, 13) * P1) & M
            i += 16
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i + 4 <= n:
        (k,) = struct.unpack_from("<I", data, i)
        h = (rotl((h + k * P3) & M, 17) * P4) & M
        i += 4
    while i < n:
        h = (rotl((h + data[i] * P5) & M, 11) * P1) & M
        i += 1
    h ^= h >> 15
    h = (h * P2) & M
    h ^= h >> 13
    h = (h * P3) & M
    h ^= h >> 16
    return h


def _lz4_block_decompress(src: bytes, out: bytearray):
    """Decode one LZ4 block, appending to ``out`` (which may already hold
    earlier blocks — supports block-dependent frames for free)."""
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break  # last sequence has no match part
        (offset,) = struct.unpack_from("<H", src, i)
        i += 2
        if offset == 0:
            raise ValueError("corrupt lz4 block (zero offset)")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - offset
        if start < 0:
            raise ValueError("corrupt lz4 block (offset past start)")
        if offset >= mlen:
            # non-overlapping match: one slice copy (the common case —
            # byte-at-a-time here made multi-hundred-MB bags take minutes)
            out += out[start : start + mlen]
        else:
            # overlapping match replicates the period; build it by doubling
            # (bytes, not bytearray: += on a bytearray slice of `out` can
            # hit BufferError under live memoryview exports)
            chunk = bytes(out[start:])
            while len(chunk) < mlen:
                chunk = chunk + chunk
            out += chunk[:mlen]


def lz4_frame_decompress(data: bytes) -> bytes:
    """Minimal LZ4 frame decoder (magic, FLG/BD, blocks, end mark)."""
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != 0x184D2204:
        raise ValueError("not an lz4 frame")
    flg = data[4]
    if (flg >> 6) != 0b01:
        raise ValueError("unsupported lz4 frame version")
    has_bchk = bool(flg & 0x10)
    has_csize = bool(flg & 0x08)
    has_dict = bool(flg & 0x01)
    off = 6  # magic(4) + FLG + BD
    if has_csize:
        off += 8
    if has_dict:
        off += 4
    off += 1  # header checksum byte (not verified on read)
    out = bytearray()
    while True:
        (bsz,) = struct.unpack_from("<I", data, off)
        off += 4
        if bsz == 0:
            break  # EndMark
        uncompressed = bool(bsz & 0x80000000)
        bsz &= 0x7FFFFFFF
        block = data[off : off + bsz]
        off += bsz
        if has_bchk:
            off += 4
        if uncompressed:
            out += block
        else:
            _lz4_block_decompress(block, out)
    return bytes(out)


def lz4_frame_compress(data: bytes) -> bytes:
    """Valid LZ4 frame using uncompressed blocks (the format's escape
    hatch) — byte-exact dataflow without implementing a compressor; any
    standard lz4 reader (and :func:`lz4_frame_decompress`) accepts it."""
    flg = 0x60  # version 01, block-independent, no checksums
    bd = 0x70  # 4 MB max block size
    desc = bytes([flg, bd])
    hc = (_xxh32(desc) >> 8) & 0xFF
    out = bytearray(struct.pack("<I", 0x184D2204) + desc + bytes([hc]))
    step = 4 * 1024 * 1024 - 1
    for i in range(0, len(data), step):
        blk = data[i : i + step]
        out += struct.pack("<I", len(blk) | 0x80000000) + blk
    out += struct.pack("<I", 0)
    return bytes(out)

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


# --------------------------------------------------------------------------
# record plumbing


def _pack_header(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _parse_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    while off < len(buf):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        item = buf[off : off + n]
        off += n
        k, _, v = item.partition(b"=")
        fields[k.decode()] = v
    return fields


def _read_record(f):
    head = f.read(4)
    if len(head) < 4:
        return None, None
    (hlen,) = struct.unpack("<I", head)
    header = _parse_header(f.read(hlen))
    (dlen,) = struct.unpack("<I", f.read(4))
    data = f.read(dlen)
    return header, data


def _write_record(f, header: dict, data: bytes):
    h = _pack_header(header)
    f.write(struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data)


def _time(v: bytes) -> float:
    s, ns = struct.unpack("<II", v)
    return s + ns * 1e-9


def _time_bytes(t: float) -> bytes:
    s = int(t)
    return struct.pack("<II", s, int(round((t - s) * 1e9)))


# --------------------------------------------------------------------------
# message (de)serialization — only what the reference subscribes to


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.off = 0

    def take(self, fmt):
        vals = struct.unpack_from("<" + fmt, self.buf, self.off)
        self.off += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def string(self):
        n = self.take("I")
        s = self.buf[self.off : self.off + n].decode(errors="replace")
        self.off += n
        return s

    def f32_array(self):
        n = self.take("I")
        a = np.frombuffer(self.buf, "<f4", count=n, offset=self.off)
        self.off += 4 * n
        return a

    def header(self):
        self.take("I")  # seq
        t = self.take("II")
        frame = self.string()
        return t[0] + t[1] * 1e-9, frame


def parse_laser_scan(data: bytes):
    r = _Reader(data)
    stamp, _ = r.header()
    angle_min = r.take("f")
    r.take("f")  # angle_max
    angle_inc = r.take("f")
    time_inc = r.take("f")
    scan_time = r.take("f")
    range_min = r.take("f")
    range_max = r.take("f")
    ranges = r.f32_array()
    return dict(
        stamp=stamp,
        angle_min=float(angle_min),
        angle_increment=float(angle_inc),
        time_increment=float(time_inc),
        scan_time=float(scan_time),
        range_min=float(range_min),
        range_max=float(range_max),
        ranges=ranges,
    )


def parse_imu(data: bytes):
    r = _Reader(data)
    stamp, _ = r.header()
    r.take("4d")  # orientation
    r.take("9d")
    gyro = np.asarray(r.take("3d"))
    r.take("9d")
    acc = np.asarray(r.take("3d"))
    return dict(stamp=stamp, acc=acc, gyro=gyro)


def parse_odometry(data: bytes):
    r = _Reader(data)
    stamp, _ = r.header()
    r.string()  # child_frame_id
    px, py, pz = r.take("3d")
    qx, qy, qz, qw = r.take("4d")
    return dict(
        stamp=stamp,
        p=np.asarray([px, py, pz]),
        q_xyzw=np.asarray([qx, qy, qz, qw]),
    )


def _ser_header(stamp: float, frame: str) -> bytes:
    s = int(stamp)
    fb = frame.encode()
    return struct.pack("<III", 0, s, int(round((stamp - s) * 1e9))) + struct.pack(
        "<I", len(fb)
    ) + fb


def serialize_laser_scan(stamp, ranges, angle_min, angle_increment,
                         time_increment=0.0, frame="laser"):
    ranges = np.asarray(ranges, np.float32)
    n = len(ranges)
    return (
        _ser_header(stamp, frame)
        + struct.pack(
            "<7f",
            angle_min,
            angle_min + angle_increment * n,
            angle_increment,
            time_increment,
            time_increment * n,
            0.1,
            100.0,
        )
        + struct.pack("<I", n)
        + ranges.astype("<f4").tobytes()
        + struct.pack("<I", 0)  # intensities
    )


def serialize_imu(stamp, acc, gyro, frame="imu"):
    z9 = struct.pack("<9d", *([0.0] * 9))
    return (
        _ser_header(stamp, frame)
        + struct.pack("<4d", 0.0, 0.0, 0.0, 1.0)
        + z9
        + struct.pack("<3d", *np.asarray(gyro, np.float64))
        + z9
        + struct.pack("<3d", *np.asarray(acc, np.float64))
        + z9
    )


def serialize_odometry(stamp, p, q_xyzw, frame="odom", child="base_link"):
    cb = child.encode()
    z36 = struct.pack("<36d", *([0.0] * 36))
    return (
        _ser_header(stamp, frame)
        + struct.pack("<I", len(cb))
        + cb
        + struct.pack("<3d", *np.asarray(p, np.float64))
        + struct.pack("<4d", *np.asarray(q_xyzw, np.float64))
        + z36
        + struct.pack("<6d", *([0.0] * 6))
        + z36
    )


def parse_image(data: bytes):
    """sensor_msgs/Image -> grayscale f32 [0,1] (mono8/rgb8/bgr8; the
    reference converts to mono8 via cv_bridge, sensor.h:126-146)."""
    r = _Reader(data)
    stamp, _ = r.header()
    h = r.take("I")
    w = r.take("I")
    enc = r.string()
    r.take("B")  # is_bigendian
    step = r.take("I")
    n = r.take("I")
    raw = np.frombuffer(r.buf, np.uint8, count=n, offset=r.off)
    if enc in ("mono8", "8UC1"):
        img = raw.reshape(h, step)[:, :w].astype(np.float32) / 255.0
    elif enc in ("rgb8", "bgr8"):
        px = raw.reshape(h, step)[:, : 3 * w].reshape(h, w, 3).astype(np.float32)
        rgb = px[..., ::-1] if enc == "bgr8" else px
        img = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]) / 255.0
    else:
        raise ValueError(f"unsupported image encoding {enc!r}")
    return dict(stamp=stamp, image=img)


def serialize_image(stamp, img, frame="camera"):
    """Grayscale [0,1] f32 -> mono8 sensor_msgs/Image."""
    a = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    h, w = a.shape
    enc = b"mono8"
    return (
        _ser_header(stamp, frame)
        + struct.pack("<II", h, w)
        + struct.pack("<I", len(enc))
        + enc
        + struct.pack("<BI", 0, w)
        + struct.pack("<I", h * w)
        + a.tobytes()
    )


MSG_TYPES = {
    "sensor_msgs/LaserScan": parse_laser_scan,
    "sensor_msgs/Imu": parse_imu,
    "nav_msgs/Odometry": parse_odometry,
    "sensor_msgs/Image": parse_image,
}


# --------------------------------------------------------------------------
# bag reading


def read_messages(path, topics=None):
    """Yield (topic, msg_type, parsed_dict) for supported message types.

    Handles none- and bz2-compressed chunks; lz4 if the lz4 package is
    importable (gated — not in this image).  Unknown types are skipped.
    """
    conns: dict = {}

    def handle_one(header, data):
        op = header.get("op", b"\x00")[0]
        if op == OP_CONNECTION:
            cid = struct.unpack("<I", header["conn"])[0]
            ch = _parse_header(data)
            conns[cid] = (
                header.get("topic", b"").decode(),
                ch.get("type", b"").decode(),
            )
        elif op == OP_MSG:
            cid = struct.unpack("<I", header["conn"])[0]
            topic, mtype = conns.get(cid, ("", ""))
            if topics is not None and topic not in topics:
                return None
            parser = MSG_TYPES.get(mtype)
            if parser is None:
                return None
            return topic, mtype, parser(data)
        return None

    def handle_records(buf):
        off = 0
        while off < len(buf):
            (hlen,) = struct.unpack_from("<I", buf, off)
            off += 4
            header = _parse_header(buf[off : off + hlen])
            off += hlen
            (dlen,) = struct.unpack_from("<I", buf, off)
            off += 4
            data = buf[off : off + dlen]
            off += dlen
            out = handle_one(header, data)
            if out is not None:
                yield out

    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a ROS1 v2.0 bag")
        while True:
            header, data = _read_record(f)
            if header is None:
                break
            op = header.get("op", b"\x00")[0]
            if op == OP_CHUNK:
                comp = header.get("compression", b"none").decode()
                if comp == "bz2":
                    data = bz2.decompress(data)
                elif comp == "lz4":
                    try:
                        import lz4.frame  # faster when available

                        data = lz4.frame.decompress(data)
                    except ImportError:
                        data = lz4_frame_decompress(data)
                yield from handle_records(data)
            else:
                # unchunked bags: connection/message records at top level
                out = handle_one(header, data)
                if out is not None:
                    yield out


class BagWriter:
    """Writes a v2.0 bag readable by rosbag and :func:`read_messages`.

    Default mode matches round-2 behavior: one uncompressed chunk, no
    index.  ``indexed=True`` reproduces rosbag-C++ output byte features:
    multiple chunks (flushed at ``chunk_threshold`` bytes), per-chunk
    compression (``compression`` = "none" | "bz2" | "lz4"), 0x04 index
    records after each chunk, a trailing section of connection records +
    0x06 chunk-info records, and a bag header whose index_pos /
    conn_count / chunk_count point at it.

    ``new_connection`` registers an extra connection id for a topic (real
    bags carry one connection per publisher — several per topic) and
    accepts connection-header extras like ``latching``/``callerid``."""

    def __init__(self, path, *, compression="none", indexed=False,
                 chunk_threshold=768 * 1024):
        self.f = open(path, "wb")
        self.f.write(MAGIC)
        self.compression = compression
        self.indexed = indexed
        self.chunk_threshold = chunk_threshold
        # bag header record (padded to 4096 like rosbag); rewritten with
        # real counts at close when indexed
        self._write_bag_header(0, 0, 0)
        self._conns: dict = {}  # key -> cid
        self._conn_headers: list = []  # cid -> (rec_h bytes, data bytes)
        self._chunk = b""
        self._chunk_msgs: list = []  # (cid, stamp, offset_in_chunk)
        self._chunk_infos: list = []  # dicts for 0x06 records

    def _write_bag_header(self, index_pos, conn_count, chunk_count):
        h = _pack_header(
            {
                "op": bytes([OP_BAG_HEADER]),
                "index_pos": struct.pack("<Q", index_pos),
                "conn_count": struct.pack("<I", conn_count),
                "chunk_count": struct.pack("<I", chunk_count),
            }
        )
        pad = 4096 - len(h) - 8
        self.f.write(struct.pack("<I", len(h)) + h)
        self.f.write(struct.pack("<I", pad) + b" " * pad)

    def new_connection(self, topic, mtype, key=None, **extras):
        """Register a connection (key defaults to (topic, mtype)); extras
        (e.g. latching=b"1", callerid=b"/node") go into the connection
        header like real publishers write them."""
        key = key if key is not None else (topic, mtype)
        if key in self._conns:
            return self._conns[key]
        cid = len(self._conns)
        self._conns[key] = cid
        ch_fields = {
            "topic": topic.encode(),
            "type": mtype.encode(),
            "md5sum": b"*",
            "message_definition": b"",
        }
        for k, v in extras.items():
            ch_fields[k] = v if isinstance(v, bytes) else str(v).encode()
        ch = _pack_header(ch_fields)
        rec_h = _pack_header(
            {
                "op": bytes([OP_CONNECTION]),
                "conn": struct.pack("<I", cid),
                "topic": topic.encode(),
            }
        )
        self._conn_headers.append((rec_h, ch))
        self._chunk += (
            struct.pack("<I", len(rec_h)) + rec_h + struct.pack("<I", len(ch)) + ch
        )
        return cid

    def write(self, topic, mtype, stamp, data: bytes, conn_key=None):
        cid = (
            self._conns[conn_key]
            if conn_key is not None and conn_key in self._conns
            else self.new_connection(topic, mtype, key=conn_key)
        )
        rec_h = _pack_header(
            {
                "op": bytes([OP_MSG]),
                "conn": struct.pack("<I", cid),
                "time": _time_bytes(stamp),
            }
        )
        self._chunk_msgs.append((cid, stamp, len(self._chunk)))
        self._chunk += (
            struct.pack("<I", len(rec_h))
            + rec_h
            + struct.pack("<I", len(data))
            + data
        )
        if self.indexed and len(self._chunk) >= self.chunk_threshold:
            self.flush_chunk()

    def flush_chunk(self):
        """Write the pending chunk (+ index records when indexed)."""
        if not self._chunk:
            return
        raw = self._chunk
        comp = self.compression
        if comp == "bz2":
            data = bz2.compress(raw)
        elif comp == "lz4":
            data = lz4_frame_compress(raw)
        else:
            comp, data = "none", raw
        chunk_pos = self.f.tell()
        ch_h = _pack_header(
            {
                "op": bytes([OP_CHUNK]),
                "compression": comp.encode(),
                "size": struct.pack("<I", len(raw)),
            }
        )
        self.f.write(struct.pack("<I", len(ch_h)) + ch_h)
        self.f.write(struct.pack("<I", len(data)) + data)

        by_conn: dict = {}
        for cid, stamp, off in self._chunk_msgs:
            by_conn.setdefault(cid, []).append((stamp, off))
        if self.indexed:
            for cid, entries in sorted(by_conn.items()):
                idx_h = _pack_header(
                    {
                        "op": bytes([OP_INDEX]),
                        "ver": struct.pack("<I", 1),
                        "conn": struct.pack("<I", cid),
                        "count": struct.pack("<I", len(entries)),
                    }
                )
                body = b"".join(
                    _time_bytes(t) + struct.pack("<I", off) for t, off in entries
                )
                self.f.write(struct.pack("<I", len(idx_h)) + idx_h)
                self.f.write(struct.pack("<I", len(body)) + body)
        stamps = [t for _, t, _ in self._chunk_msgs] or [0.0]
        self._chunk_infos.append(
            dict(
                pos=chunk_pos,
                start=min(stamps),
                end=max(stamps),
                counts={c: len(e) for c, e in by_conn.items()},
            )
        )
        self._chunk = b""
        self._chunk_msgs = []

    def close(self):
        self.flush_chunk()
        if self.indexed:
            index_pos = self.f.tell()
            # trailing section: connection records then chunk-info records
            for rec_h, ch in self._conn_headers:
                self.f.write(struct.pack("<I", len(rec_h)) + rec_h)
                self.f.write(struct.pack("<I", len(ch)) + ch)
            for info in self._chunk_infos:
                ci_h = _pack_header(
                    {
                        "op": bytes([OP_CHUNK_INFO]),
                        "ver": struct.pack("<I", 1),
                        "chunk_pos": struct.pack("<Q", info["pos"]),
                        "start_time": _time_bytes(info["start"]),
                        "end_time": _time_bytes(info["end"]),
                        "count": struct.pack("<I", len(info["counts"])),
                    }
                )
                body = b"".join(
                    struct.pack("<II", c, n) for c, n in sorted(info["counts"].items())
                )
                self.f.write(struct.pack("<I", len(ci_h)) + ci_h)
                self.f.write(struct.pack("<I", len(body)) + body)
            self.f.seek(len(MAGIC))
            self._write_bag_header(
                index_pos, len(self._conn_headers), len(self._chunk_infos)
            )
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
