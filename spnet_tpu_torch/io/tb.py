"""Minimal TensorBoard event-file emitter (no TensorFlow dependency).

The port's copy of `spnet_tpu/io/tb.py` (pure Python), byte for byte the
same writer.  Capability twin of the reference's optional TensorBoard
logging (`spnet/callbacks.py:88-90,239-248`: per-epoch scalar
curves via the Keras TB callback plus rendered val-overlay image
summaries behind `use_tb`).  Rather than importing TF into the training
process, this writes the TFRecord/Event wire format directly: each
record is

    uint64 length | uint32 masked_crc32c(length) | payload
                  | uint32 masked_crc32c(payload)

with the payload a hand-encoded `tensorboard.Event` protobuf carrying
either a scalar `Summary.Value` (simple_value) or an image value
(PNG-encoded `Summary.Image`).  TensorBoard reads these natively.
"""

from __future__ import annotations

import io
import os
import socket
import struct
import time


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — required by the TFRecord framing.  Table-driven,
# pure Python; only a handful of records are written per epoch.
# ---------------------------------------------------------------------------
def _make_crc32c_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire helpers (just what Event/Summary need)
# ---------------------------------------------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _pb_str(field: int, v: str) -> bytes:
    return _pb_bytes(field, v.encode())


def _event(step: int | None = None, summary: bytes | None = None,
           file_version: str | None = None) -> bytes:
    # Event: 1 wall_time, 2 step, 3 file_version, 5 summary
    out = _pb_double(1, time.time())
    if step is not None:
        out += _pb_int64(2, step)
    if file_version is not None:
        out += _pb_str(3, file_version)
    if summary is not None:
        out += _pb_bytes(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    # Summary.Value: 1 tag, 2 simple_value
    return _pb_bytes(1, _pb_str(1, tag) + _pb_float(2, float(value)))


def _image_value(tag: str, png: bytes, height: int, width: int,
                 channels: int) -> bytes:
    # Summary.Image: 1 height, 2 width, 3 colorspace, 4 encoded bytes
    img = (_pb_int64(1, height) + _pb_int64(2, width)
           + _pb_int64(3, channels) + _pb_bytes(4, png))
    # Summary.Value: 1 tag, 4 image
    return _pb_bytes(1, _pb_str(1, tag) + _pb_bytes(4, img))


class TBWriter:
    """Append-only TensorBoard event writer for one log directory."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or "localhost"
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}"
        )
        self._f = open(self.path, "ab")
        self._write(_event(file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        length = struct.pack("<Q", len(payload))
        self._f.write(length)
        self._f.write(struct.pack("<I", _masked_crc(length)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(step=step, summary=_scalar_value(tag, value)))

    def add_image(self, tag: str, image, step: int) -> None:
        """image: (H, W) or (H, W, C) uint8 array, or pre-encoded PNG
        bytes (then pass a (H, W, C) shape via numpy first)."""
        import numpy as np
        from PIL import Image

        arr = np.asarray(image)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        h, w, c = arr.shape
        pil = Image.fromarray(arr[..., 0] if c == 1 else arr,
                              mode="L" if c == 1 else "RGB")
        buf = io.BytesIO()
        pil.save(buf, format="PNG")
        self._write(_event(
            step=step, summary=_image_value(tag, buf.getvalue(), h, w, c)
        ))

    def close(self) -> None:
        self._f.close()


# ---------------------------------------------------------------------------
# Reader (for tests; parses only what the writer emits)
# ---------------------------------------------------------------------------
def read_events(path: str):
    """Yield (step, tag, kind, value) tuples from an event file; kind is
    'scalar' (value float) or 'image' (value PNG bytes).  Verifies the
    record CRCs."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        lcrc = struct.unpack_from("<I", data, pos + 8)[0]
        assert lcrc == _masked_crc(data[pos : pos + 8]), "length CRC"
        payload = data[pos + 12 : pos + 12 + length]
        pcrc = struct.unpack_from("<I", data, pos + 12 + length)[0]
        assert pcrc == _masked_crc(payload), "payload CRC"
        pos += 12 + length + 4
        yield from _parse_event(payload)


def _read_varint(buf, pos):
    shift, val = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _fields(buf):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            val = buf[pos : pos + n]
            pos += n
        else:  # pragma: no cover
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


def _parse_event(payload):
    step, summary = 0, None
    for field, _w, val in _fields(payload):
        if field == 2:
            step = val
        elif field == 5:
            summary = val
    if summary is None:
        return
    for field, _w, val in _fields(summary):
        if field != 1:
            continue
        tag, scalar, image = "", None, None
        for f2, _w2, v2 in _fields(val):
            if f2 == 1:
                tag = v2.decode()
            elif f2 == 2:
                scalar = struct.unpack("<f", v2)[0]
            elif f2 == 4:
                for f3, _w3, v3 in _fields(v2):
                    if f3 == 4:
                        image = v3
        if scalar is not None:
            yield step, tag, "scalar", scalar
        elif image is not None:
            yield step, tag, "image", image
