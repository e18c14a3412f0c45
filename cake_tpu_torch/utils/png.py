"""PNG encoding with the standard library (`zlib`, `struct`): the card's
machine has no Pillow. An 8-bit RGB image, one IDAT chunk, filter type 0
on every row; any PNG reader decodes it to the same pixels.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """rgb: uint8 [H, W, 3] -> the bytes of a PNG file."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 [H, W, 3], not "
                         f"{rgb.dtype} {list(rgb.shape)}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)],
                          axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit RGB PNG with filter type 0 on every row (what
    encode_png writes), uint8 [H, W, 3]; raises ValueError on anything
    else, a bad CRC or a truncated stream."""
    try:
        return _decode(data)
    except (struct.error, zlib.error) as e:
        raise ValueError(f"PNG truncated or corrupt: {e}") from e


def _decode(data: bytes) -> np.ndarray:
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if len(body) != n or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if (depth, color) != (8, 2) or body[10:] != b"\0\0\0":
                raise ValueError("not an 8-bit RGB PNG")
            size = (w, h)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"IEND":
            break
        pos += 12 + n
    if size is None:
        raise ValueError("PNG without IHDR")
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    if rows.size != h * (w * 3 + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, not "
                         f"{h} rows of {w * 3 + 1}")
    rows = rows.reshape(h, w * 3 + 1)
    if rows[:, 0].any():
        raise ValueError("PNG row filters other than 0 are not decoded")
    return rows[:, 1:].reshape(h, w, 3).copy()


class RgbImage:
    """An 8-bit RGB image, the port's counterpart of the PIL Image the
    reference returns: `.size` (width, height), `.save(fp_or_path)` as
    PNG, `png_bytes()` and numpy conversion."""

    def __init__(self, pixels: np.ndarray):
        self.pixels = pixels

    @property
    def size(self) -> tuple[int, int]:
        return self.pixels.shape[1], self.pixels.shape[0]

    def png_bytes(self) -> bytes:
        return encode_png(self.pixels)

    def save(self, fp, format: str = "PNG") -> None:
        if format.upper() != "PNG":
            raise ValueError(f"RgbImage saves PNG only, not {format}")
        data = self.png_bytes()
        if hasattr(fp, "write"):
            fp.write(data)
        else:
            with open(fp, "wb") as f:
                f.write(data)

    def __array__(self, dtype=None, copy=None):
        return self.pixels if dtype is None else self.pixels.astype(dtype)
