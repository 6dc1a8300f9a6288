"""PNG input/output on numpy and the stdlib ``zlib``.

The reference reaches libpng through a C FFI (png_image.zig:6-9). Here a
small codec covers what the repo's images use: 8-bit RGB and RGBA, not
interlaced, filter types 0-4 (PNG spec, ISO/IEC 15948 §9). Anything else
raises ``ValueError``. What matters for parity is the buffer convention,
reproduced exactly:

- rows are stored bottom-up in memory: the reader flips vertically
  (png_image.zig:86) and the writer flips back (png_image.zig:136),
- quantization is ``trunc(clamp(255.999 * c, 0, 255))``
  (png_image.zig:138-140),
- only the RGB channels are kept; alpha is dropped (png_image.zig:44-59).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> bytes per pixel at bit depth 8
_CHANNELS = {2: 3, 6: 4}


def _chunks(data: bytes):
    """Yield ``(type, payload)`` per chunk, checking each CRC."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        if len(payload) != n:
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, payload
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG has no IEND chunk")


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo one scanline's filter (PNG spec §9.2). ``row``/``prior`` are
    uint8; returns the reconstructed uint8 row."""
    if ftype == 0:
        return row
    if ftype == 1:  # Sub: running sum per channel, mod 256
        px = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) % 256).astype(np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return (row.astype(np.int64) + prior).astype(np.uint8)
    if ftype not in (3, 4):
        raise ValueError(f"unknown PNG filter type {ftype}")
    # Average and Paeth depend on the reconstructed left neighbour: a
    # sequential scan, on plain ints (faster than numpy per element).
    raw = row.tolist()
    up = prior.tolist()
    out = [0] * len(raw)
    for i, x in enumerate(raw):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            out[i] = (x + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (x + pred) & 0xFF
    return np.asarray(out, np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``(H, W, C)`` uint8, top row first, C = 3 or 4."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    header = None
    idat = []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, compression, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {ctype} "
            "(only 8-bit RGB and RGBA)")
    if compression != 0 or filt != 0:
        raise ValueError("unsupported PNG compression or filter method")
    if interlace != 0:
        raise ValueError("interlaced PNGs are not supported")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, bpp)
        out[y] = prior
    return out.reshape(h, w, bpp)


def encode_png(pixels: np.ndarray) -> bytes:
    """``(H, W, 3)`` uint8, top row first -> 8-bit RGB PNG bytes (every
    scanline unfiltered)."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w, c = pixels.shape
    if c != 3:
        raise ValueError("encode_png writes RGB images only")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), pixels.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """Read a PNG into ``(H, W, 3)`` f32 in [0, 1], row 0 = image bottom."""
    with open(path, "rb") as f:
        pixels = decode_png(f.read())
    arr = pixels[..., :3].astype(np.float32) / 255.0
    return arr[::-1].copy()


def quantize(image: np.ndarray) -> np.ndarray:
    """Float image -> uint8 with the reference's clamp (png_image.zig:138)."""
    return np.clip(255.999 * image, 0.0, 255.0).astype(np.uint8)


def write_png(path, image: np.ndarray) -> None:
    """Write ``(H, W, 3)`` f32 (row 0 = bottom) as an 8-bit RGB PNG."""
    data = encode_png(quantize(np.asarray(image))[::-1])
    with open(path, "wb") as f:
        f.write(data)
