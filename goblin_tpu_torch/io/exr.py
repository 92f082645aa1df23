"""Minimal OpenEXR scanline reader and writer, numpy only (port of
goblin_tpu/io/exr.py).

Write: RGB FLOAT or HALF channels, ZIP or no compression. Read: FLOAT or
HALF channels, no compression, ZIPS or ZIP. Channels are stored in
alphabetical order (B, G, R) per the EXR spec.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_VERSION = 2
_NO_COMPRESSION = 0
_ZIPS_COMPRESSION = 2  # 1 scanline per block
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


def _predictor_decode(data: bytes) -> bytes:
    """Undo _predictor_encode: integrate the deltas, then interleave the
    two halves back into alternating bytes."""
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    steps = np.concatenate([arr[:1], arr[1:] - 128])
    tmp = (np.cumsum(steps) % 256).astype(np.uint8)
    half = (len(tmp) + 1) // 2
    out = np.empty(len(tmp), dtype=np.uint8)
    out[0::2] = tmp[:half]
    out[1::2] = tmp[half:]
    return out.tobytes()


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


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR -> (H, W, 3) float32 (R, G, B); a channel the
    file lacks stays 0. The blocks are walked in file order and the offset
    table is skipped unread, so files whose table is off (goblin_tpu's
    writer puts its offsets 4 bytes late) read the same."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    pos = 8
    channels = []  # (name, pixel type), in file order
    comp = _NO_COMPRESSION
    dw = None
    while buf[pos] != 0:
        name_end = buf.index(b"\x00", pos)
        name = buf[pos:name_end].decode()
        pos = buf.index(b"\x00", name_end + 1) + 1  # past the type name
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        data = buf[pos:pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while data[cpos] != 0:
                cend = data.index(b"\x00", cpos)
                (ptype,) = struct.unpack_from("<i", data, cend + 1)
                channels.append((data[cpos:cend].decode(), ptype))
                cpos = cend + 1 + 16
        elif name == "compression":
            comp = data[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", data)
    pos += 1
    if dw is None:
        raise ValueError("missing dataWindow")
    if comp not in (_NO_COMPRESSION, _ZIPS_COMPRESSION, _ZIP_COMPRESSION):
        raise ValueError(f"unsupported compression id {comp}")
    w = dw[2] - dw[0] + 1
    h = dw[3] - dw[1] + 1
    lines_per_block = 16 if comp == _ZIP_COMPRESSION else 1
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    pos += 8 * n_blocks  # the offset table

    channels.sort()
    dtypes = {name: np.float16 if ptype == _PT_HALF else np.float32
              for name, ptype in channels}
    line_bytes = sum(w * np.dtype(dt).itemsize for dt in dtypes.values())
    out = np.zeros((h, w, 3), dtype=np.float32)
    target = {"R": 0, "G": 1, "B": 2}
    for _ in range(n_blocks):
        y0, size = struct.unpack_from("<ii", buf, pos)
        pos += 8
        raw = buf[pos:pos + size]
        pos += size
        y0 -= dw[1]
        ny = min(lines_per_block, h - y0)
        # a block that did not shrink is stored raw
        if comp != _NO_COMPRESSION and size != ny * line_bytes:
            raw = _predictor_decode(zlib.decompress(raw))
        rpos = 0
        for y in range(y0, y0 + ny):
            for name, _ in channels:
                nbytes = w * np.dtype(dtypes[name]).itemsize
                if name in target:
                    out[y, :, target[name]] = np.frombuffer(
                        raw[rpos:rpos + nbytes], dtype=dtypes[name])
                rpos += nbytes
    return out


def write_ppm(path: str, image: np.ndarray, gamma: float = 2.2) -> None:
    """An 8-bit binary PPM (P6) of the image clipped to [0, 1] and
    gamma-encoded (reference src/GoblinImageIO.cpp, the PPM path)."""
    img = np.clip(np.asarray(image, dtype=np.float32), 0.0, 1.0)
    img = np.power(img, 1.0 / gamma)
    data = (img[:, :, :3] * 255.0 + 0.5).astype(np.uint8)
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(data.tobytes())
