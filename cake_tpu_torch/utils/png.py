"""PNG encode and decode with the standard library (`zlib`, `struct`) and
numpy, and Pillow's bicubic resize: the card's machine has no Pillow.
The encoder writes an 8-bit RGB image, one IDAT chunk, filter type 0 on
every row; any PNG reader decodes it to the same pixels. The decoder
reads the 8-bit PNGs clients send (img2img's init images) as Pillow's
`convert("RGB")` does; `resize_bicubic` is Pillow's default resize.
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


# color type -> channels: grey, RGB, palette, grey + alpha, RGBA
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Pillow's DecompressionBombError threshold (2 x Image.MAX_IMAGE_PIXELS)
MAX_PIXELS = 2 * 89478485
# what the decoder leaves out, and the ROADMAP item that would bring it
NOT_DECODED = ("ROADMAP module 14b, its remainder: init images other than "
               "8-bit non-interlaced PNG")


def png_header(data: bytes) -> tuple[int, int, int]:
    """(width, height, color type) of a PNG that decode_png takes, from its
    signature and IHDR (the first chunk) alone: no pixel is inflated.
    Raises ValueError for what decode_png would refuse by its header."""
    if data[:8] != SIGNATURE:
        kind = ("JPEG" if data[:3] == b"\xff\xd8\xff" else
                "WebP" if data[:4] == b"RIFF" and data[8:12] == b"WEBP"
                else "not a PNG")
        raise ValueError(f"{kind}: only PNG is decoded ({NOT_DECODED})")
    try:
        n, kind, *header = struct.unpack(">I4sIIBBBBB", data[8:29])
        crc = struct.unpack(">I", data[29:33])[0]
    except struct.error as e:
        raise ValueError(f"PNG truncated or corrupt: {e}") from e
    if kind != b"IHDR" or n != 13:
        raise ValueError("PNG whose first chunk is not IHDR")
    if zlib.crc32(data[12:29]) & 0xFFFFFFFF != crc:
        raise ValueError("PNG chunk b'IHDR': truncated or bad CRC")
    w, h, depth, color, compression, filt, interlace = header
    if color not in CHANNELS:
        raise ValueError(f"PNG color type {color}")
    if depth != 8:
        raise ValueError(f"{depth}-bit PNG ({NOT_DECODED})")
    if interlace:
        raise ValueError(f"interlaced PNG ({NOT_DECODED})")
    if compression or filt:
        raise ValueError(f"PNG compression {compression} / filter method "
                         f"{filt}")
    if not w or not h or w * h > MAX_PIXELS:
        raise ValueError(f"PNG of {w} x {h} (at most {MAX_PIXELS} pixels)")
    return w, h, color


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit PNG as Pillow's `convert("RGB")` gives them,
    uint8 [H, W, 3]: grey replicated, a palette looked up, alpha dropped
    with no compositing (tRNS, gamma and other ancillary chunks are not
    read). Color types 0, 2, 3, 4 and 6 at 8 bits, not interlaced, row
    filters 0-4. Raises ValueError on anything else (16-bit, fewer bits,
    interlaced, not a PNG at all), a bad CRC or a truncated stream."""
    try:
        return _decode(data)
    except (struct.error, zlib.error) as e:
        raise ValueError(f"PNG truncated or corrupt: {e}") from e


def _decode(data: bytes) -> np.ndarray:
    w, h, color = png_header(data)
    pos, idat, palette = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if len(body) != n or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        if kind == b"PLTE":
            if n % 3 or not n:
                raise ValueError(f"PNG palette of {n} bytes")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    bpp = CHANNELS[color]
    # inflate no more than the header's size and one byte: a stream that
    # inflates past it is refused without being held
    rows = np.frombuffer(zlib.decompressobj().decompress(
        b"".join(idat), h * (w * bpp + 1) + 1), np.uint8)
    if rows.size != h * (w * bpp + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, not "
                         f"{h} rows of {w * bpp + 1}")
    rows = rows.reshape(h, w * bpp + 1)
    pix = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0])
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        if int(pix.max()) >= len(palette):
            raise ValueError(f"PNG palette index {int(pix.max())} past its "
                             f"{len(palette)} entries")
        return palette[pix[..., 0]]
    if color in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def _unfilter(filtered: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Undo the rows' filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth).
    A pixel depends on its left, upper and upper-left neighbours only, so
    the pixels of one anti-diagonal are reconstructed together: h + w - 1
    vector steps instead of a loop over every byte."""
    h, w, bpp = filtered.shape
    if int(kinds.max()) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())}")
    if not kinds.any():
        return filtered.copy()
    out = np.zeros((h + 1, w + 1, bpp), np.int16)  # a zero row and column
    f16 = filtered.astype(np.int16)
    kind = kinds.astype(np.int16)
    for t in range(h + w - 1):
        y = np.arange(max(0, t - w + 1), min(h, t + 1))
        x = t - y
        a = out[y + 1, x]                           # left
        b = out[y, x + 1]                           # up
        c = out[y, x]                               # up-left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        k = kind[y][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (f16[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


# -- Pillow's bicubic resize --------------------------------------------------

PRECISION_BITS = 32 - 8 - 2     # Pillow's fixed point for 8-bit images


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (a = -0.5, support 2)."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """(xmin [out], k [out, ksize] int64): Pillow's precompute_coeffs and
    normalize_coeffs_8bpc for a whole-image box: the filter's support
    scaled by the reduction, each row of weights normalized in double,
    then rounded half away from zero to PRECISION_BITS fixed point."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = np.where(live, _bicubic((taps[None, :] + xmin[:, None]
                                 - center[:, None] + 0.5)
                                * (1.0 / filterscale)), 0.0)
    total = np.zeros((out_size, 1))
    for j in range(ksize):              # Pillow's order of the sum
        total[:, 0] += w[:, j]
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    one = float(1 << PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, k.astype(np.int64)


def _resample(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along `axis` (1: horizontal, 0: vertical) with 8-bit
    rounding: acc starts at 1 << (PRECISION_BITS - 1), the result is
    acc >> PRECISION_BITS clamped to 0..255."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)     # weight 0 past the end
        kj = k[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
        acc += src[idx] * kj
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(pixels: np.ndarray, width: int, height: int
                   ) -> np.ndarray:
    """uint8 [H, W, C] -> [height, width, C], equal to Pillow's
    `Image.resize((width, height))` (its default BICUBIC filter, with
    support scaled when reducing) byte for byte: a horizontal pass, then
    a vertical one, each rounded to 8 bits as Pillow rounds them; an axis
    whose size does not change is not resampled."""
    out = np.asarray(pixels, np.uint8)
    if out.shape[1] != width:
        out = _resample(out, width, 1)
    if out.shape[0] != height:
        out = _resample(out, height, 0)
    return np.ascontiguousarray(out)


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
