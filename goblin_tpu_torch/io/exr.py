"""Minimal OpenEXR scanline writer, numpy only (port of the writer in
goblin_tpu/io/exr.py).

RGB FLOAT or HALF channels, ZIP or no compression. Channels are stored in
alphabetical order (B, G, R) per the EXR spec.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_VERSION = 2
_NO_COMPRESSION = 0
_ZIP_COMPRESSION = 3  # 16 scanlines per block
_PT_HALF = 1
_PT_FLOAT = 2


def _attr(name: bytes, type_: bytes, data: bytes) -> bytes:
    return name + b"\x00" + type_ + b"\x00" + struct.pack("<i", len(data)) + data


def _channel_list(names, pixel_type: int) -> bytes:
    out = b""
    for n in sorted(names):
        out += n.encode() + b"\x00"
        out += struct.pack("<iiii", pixel_type, 0, 1, 1)  # type, pLinear, xs, ys
    return out + b"\x00"


def _predictor_encode(data: bytes) -> bytes:
    """EXR zip pre-filter: split even/odd bytes into halves, then delta
    encode (OpenEXR ImfZip compress order)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    tmp = np.concatenate([arr[0::2], arr[1::2]]).astype(np.int16)
    out = np.empty_like(tmp)
    out[0] = tmp[0]
    out[1:] = tmp[1:] - tmp[:-1] + (128 + 256)
    return (out % 256).astype(np.uint8).tobytes()


def write_exr(path: str, image: np.ndarray, half: bool = False,
              compress: bool = True) -> None:
    """Write an (H, W, >=3) float image as a scanline EXR (B, G, R)."""
    img = np.asarray(image, dtype=np.float32)
    if img.ndim != 3 or img.shape[2] < 3:
        raise ValueError("image must be (H, W, >=3)")
    h, w = img.shape[:2]
    pixel_type = _PT_HALF if half else _PT_FLOAT
    comp = _ZIP_COMPRESSION if compress else _NO_COMPRESSION
    lines_per_block = 16 if compress else 1

    header = b""
    header += _attr(b"channels", b"chlist",
                    _channel_list(["R", "G", "B"], pixel_type))
    header += _attr(b"compression", b"compression", struct.pack("<B", comp))
    header += _attr(b"dataWindow", b"box2i",
                    struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr(b"displayWindow", b"box2i",
                    struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr(b"lineOrder", b"lineOrder", b"\x00")  # increasing Y
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f",
                    struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    dt = np.float16 if half else np.float32
    blocks = []
    for y0 in range(0, h, lines_per_block):
        ny = min(lines_per_block, h - y0)
        # per scanline: B row, G row, R row (alphabetical channels)
        raw = b"".join(
            img[y, :, c].astype(dt).tobytes()
            for y in range(y0, y0 + ny) for c in (2, 1, 0)
        )
        enc = raw
        if compress:
            enc = zlib.compress(_predictor_encode(raw))
            if len(enc) >= len(raw):
                enc = raw
        blocks.append((y0, enc))

    offset_table_pos = 8 + len(header)
    pos = offset_table_pos + 8 * len(blocks)
    offsets = []
    for _, enc in blocks:
        offsets.append(pos)
        pos += 4 + 4 + len(enc)

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, _VERSION))
        f.write(header)
        for off in offsets:
            f.write(struct.pack("<Q", off))
        for y0, enc in blocks:
            f.write(struct.pack("<ii", y0, len(enc)))
            f.write(enc)
