"""Minimal pure-Python ROS2 bag (sqlite3 + CDR) reader/writer.

JAX replacement for the reference's `okvis_ros2` `RosbagReader`
(okvis_ros2/src/RosbagReader.cpp): streams sensor messages out of a
rosbag2 directory (metadata.yaml + *.db3) without any ROS2 installation,
decoding the CDR-serialized sensor_msgs the OKVIS2-X node consumes
(Imu, Image, PointCloud2, NavSatFix).

CDR (XCDR1 little-endian as used by rosbag2's `cdr` serialization format):
4-byte encapsulation header {0x00,0x01,opts}, then fields with natural
alignment relative to the payload start; strings are u32 length including
the trailing NUL.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import sqlite3
import struct
from typing import Dict, Iterator, List, Optional

import numpy as np

from okvis2x_tpu.io import rosbag1 as _r1

# re-use the message dataclasses / field tables from the ROS1 module
ImuMsg = _r1.ImuMsg
ImageMsg = _r1.ImageMsg
PointCloud2Msg = _r1.PointCloud2Msg
PointField = _r1.PointField
NavSatFixMsg = _r1.NavSatFixMsg
to_mono8 = _r1.to_mono8
_ENC = _r1._ENC


class _CdrCursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        if len(buf) < 4 or buf[1] not in (0x01, 0x03):
            raise ValueError("not little-endian CDR")
        self.buf = buf
        self.off = 4  # skip encapsulation header

    def _align(self, n):
        rel = self.off - 4
        pad = (-rel) % n
        self.off += pad

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def i8(self):
        (v,) = struct.unpack_from("<b", self.buf, self.off)
        self.off += 1
        return v

    def u16(self):
        self._align(2)
        (v,) = struct.unpack_from("<H", self.buf, self.off)
        self.off += 2
        return v

    def u32(self):
        self._align(4)
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def i32(self):
        self._align(4)
        (v,) = struct.unpack_from("<i", self.buf, self.off)
        self.off += 4
        return v

    def f64(self):
        self._align(8)
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def f64s(self, n):
        self._align(8)
        v = struct.unpack_from(f"<{n}d", self.buf, self.off)
        self.off += 8 * n
        return np.asarray(v)

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off:self.off + n - 1] if n else b""
        self.off += n
        return s.decode(errors="replace")

    def raw(self, n) -> bytes:
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b


def _cdr_header(c: _CdrCursor) -> int:
    """std_msgs/msg/Header (no seq in ROS2) -> stamp_ns."""
    sec = c.i32()
    nanosec = c.u32()
    c.string()  # frame_id
    return sec * 1_000_000_000 + nanosec


def decode_imu(raw: bytes) -> ImuMsg:
    c = _CdrCursor(raw)
    t_ns = _cdr_header(c)
    c.f64s(4)
    c.f64s(9)
    gyr = c.f64s(3)
    c.f64s(9)
    acc = c.f64s(3)
    c.f64s(9)
    return ImuMsg(t_ns=t_ns, gyr=gyr, acc=acc)


def decode_image(raw: bytes) -> ImageMsg:
    c = _CdrCursor(raw)
    t_ns = _cdr_header(c)
    height, width = c.u32(), c.u32()
    encoding = c.string()
    c.u8()
    step = c.u32()
    n = c.u32()
    data = c.raw(n)
    dtype, channels = _ENC.get(encoding, (np.uint8, 1))
    row = np.frombuffer(data, dtype=np.uint8).reshape(height, step)
    itemsize = np.dtype(dtype).itemsize
    img = row[:, : width * channels * itemsize].copy().view(dtype)
    img = (
        img.reshape(height, width, channels)
        if channels > 1
        else img.reshape(height, width)
    )
    return ImageMsg(
        t_ns=t_ns, height=height, width=width, encoding=encoding, data=img
    )


def decode_pointcloud2(raw: bytes) -> PointCloud2Msg:
    c = _CdrCursor(raw)
    t_ns = _cdr_header(c)
    height, width = c.u32(), c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        name = c.string()
        offset, datatype, count = c.u32(), c.u8(), c.u32()
        fields.append(PointField(name, offset, datatype, count))
    c.u8()  # is_bigendian
    point_step = c.u32()
    c.u32()  # row_step
    n = c.u32()
    data = c.raw(n)
    return PointCloud2Msg(
        t_ns=t_ns, height=height, width=width, fields=fields,
        point_step=point_step, data=data,
    )


def decode_navsatfix(raw: bytes) -> NavSatFixMsg:
    c = _CdrCursor(raw)
    t_ns = _cdr_header(c)
    status = c.i8()
    c.u16()
    lat, lon, alt = c.f64(), c.f64(), c.f64()
    cov = c.f64s(9)
    c.u8()
    return NavSatFixMsg(
        t_ns=t_ns, status=status, latitude=lat, longitude=lon, altitude=alt,
        position_covariance=cov,
    )


DECODERS = {
    "sensor_msgs/msg/Imu": decode_imu,
    "sensor_msgs/msg/Image": decode_image,
    "sensor_msgs/msg/PointCloud2": decode_pointcloud2,
    "sensor_msgs/msg/NavSatFix": decode_navsatfix,
}


@dataclasses.dataclass
class Bag2Message:
    topic: str
    msgtype: str
    t_ns: int  # receive timestamp from the messages table
    raw: bytes


class Rosbag2Reader:
    """Read a rosbag2 directory (or a bare .db3 file) in timestamp order."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            dbs = sorted(glob.glob(os.path.join(path, "*.db3")))
            if not dbs:
                raise FileNotFoundError(f"no .db3 files under {path}")
            self.db_paths = dbs
        else:
            self.db_paths = [path]

    def topics(self) -> Dict[str, str]:
        out = {}
        for db in self.db_paths:
            con = sqlite3.connect(db)
            for name, typ in con.execute("SELECT name, type FROM topics"):
                out[name] = typ
            con.close()
        return out

    def messages(
        self, topics: Optional[List[str]] = None
    ) -> Iterator[Bag2Message]:
        want = set(topics) if topics is not None else None
        for db in self.db_paths:
            con = sqlite3.connect(db)
            tmap = {
                tid: (name, typ)
                for tid, name, typ in con.execute(
                    "SELECT id, name, type FROM topics"
                )
            }
            cur = con.execute(
                "SELECT topic_id, timestamp, data FROM messages "
                "ORDER BY timestamp"
            )
            for tid, ts, blob in cur:
                name, typ = tmap[tid]
                if want is not None and name not in want:
                    continue
                yield Bag2Message(topic=name, msgtype=typ, t_ns=ts, raw=blob)
            con.close()


# --------------------------------------------------------------- serializers


class _CdrWriter:
    def __init__(self):
        self.parts = bytearray(b"\x00\x01\x00\x00")

    def _align(self, n):
        rel = len(self.parts) - 4
        self.parts += b"\x00" * ((-rel) % n)

    def u8(self, v):
        self.parts += struct.pack("<B", v)

    def i8(self, v):
        self.parts += struct.pack("<b", v)

    def u16(self, v):
        self._align(2)
        self.parts += struct.pack("<H", v)

    def u32(self, v):
        self._align(4)
        self.parts += struct.pack("<I", v)

    def i32(self, v):
        self._align(4)
        self.parts += struct.pack("<i", v)

    def f64(self, v):
        self._align(8)
        self.parts += struct.pack("<d", v)

    def f64s(self, vals):
        self._align(8)
        for v in np.asarray(vals, np.float64).ravel():
            self.parts += struct.pack("<d", v)

    def string(self, s: str):
        b = s.encode() + b"\x00"
        self.u32(len(b))
        self.parts += b

    def raw(self, b: bytes):
        self.parts += b

    def header(self, t_ns: int, frame_id: str = ""):
        secs, nsecs = divmod(int(t_ns), 1_000_000_000)
        self.i32(secs)
        self.u32(nsecs)
        self.string(frame_id)

    def bytes(self) -> bytes:
        return bytes(self.parts)


def encode_imu(t_ns: int, gyr, acc, frame_id: str = "imu") -> bytes:
    w = _CdrWriter()
    w.header(t_ns, frame_id)
    w.f64s([0, 0, 0, 1])
    w.f64s([0.0] * 9)
    w.f64s(gyr)
    w.f64s([0.0] * 9)
    w.f64s(acc)
    w.f64s([0.0] * 9)
    return w.bytes()


def encode_image(
    t_ns: int, img: np.ndarray, encoding: str = "mono8", frame_id: str = "cam"
) -> bytes:
    img = np.ascontiguousarray(img)
    h, wd = img.shape[:2]
    w = _CdrWriter()
    w.header(t_ns, frame_id)
    w.u32(h)
    w.u32(wd)
    w.string(encoding)
    w.u8(0)
    w.u32(img.strides[0])
    body = img.tobytes()
    w.u32(len(body))
    w.raw(body)
    return w.bytes()


def encode_pointcloud2(
    t_ns: int,
    fields: List[PointField],
    point_step: int,
    data: bytes,
    n_points: int,
    frame_id: str = "lidar",
) -> bytes:
    w = _CdrWriter()
    w.header(t_ns, frame_id)
    w.u32(1)
    w.u32(n_points)
    w.u32(len(fields))
    for f in fields:
        w.string(f.name)
        w.u32(f.offset)
        w.u8(f.datatype)
        w.u32(f.count)
    w.u8(0)
    w.u32(point_step)
    w.u32(point_step * n_points)
    w.u32(len(data))
    w.raw(data)
    w.u8(1)
    return w.bytes()


class Rosbag2Writer:
    """Create a rosbag2-compatible directory: one .db3 + metadata.yaml."""

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        base = os.path.basename(os.path.normpath(path))
        self.dir = path
        self.db_path = os.path.join(path, base + "_0.db3")
        self.con = sqlite3.connect(self.db_path)
        self.con.executescript(
            """
            CREATE TABLE topics(
              id INTEGER PRIMARY KEY, name TEXT NOT NULL, type TEXT NOT NULL,
              serialization_format TEXT NOT NULL,
              offered_qos_profiles TEXT NOT NULL);
            CREATE TABLE messages(
              id INTEGER PRIMARY KEY, topic_id INTEGER NOT NULL,
              timestamp INTEGER NOT NULL, data BLOB NOT NULL);
            """
        )
        self._topics: Dict[str, int] = {}
        self._count = 0

    def _topic(self, name: str, msgtype: str) -> int:
        if name in self._topics:
            return self._topics[name]
        tid = len(self._topics) + 1
        self.con.execute(
            "INSERT INTO topics VALUES (?,?,?,?,?)",
            (tid, name, msgtype, "cdr", ""),
        )
        self._topics[name] = tid
        return tid

    def write(self, topic: str, msgtype: str, t_ns: int, raw: bytes):
        tid = self._topic(topic, msgtype)
        self._count += 1
        self.con.execute(
            "INSERT INTO messages VALUES (?,?,?,?)",
            (self._count, tid, int(t_ns), raw),
        )

    def close(self):
        self.con.commit()
        self.con.close()
        with open(os.path.join(self.dir, "metadata.yaml"), "w") as f:
            f.write(
                "rosbag2_bagfile_information:\n"
                "  version: 4\n"
                "  storage_identifier: sqlite3\n"
                f"  relative_file_paths: [{os.path.basename(self.db_path)}]\n"
                f"  message_count: {self._count}\n"
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
