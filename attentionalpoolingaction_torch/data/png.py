"""A small PNG decoder and encoder on the host, from ``zlib`` and numpy:
serving's second image format beside JPEG, and the format of the
attention overlays (``utils/visualize.py``) and of the image summaries of
the event files (``utils/metrics_writer.py``).

The JAX package decodes request bytes with ``cv2.imdecode(IMREAD_COLOR)``
(``data/preprocessing_np.py``), which takes PNG as well as JPEG; the card's
machine has no OpenCV and no PIL.  :func:`decode` reproduces OpenCV's
``IMREAD_COLOR`` of a PNG, as RGB: grayscale becomes three equal
channels, an alpha channel is dropped, a palette is expanded (``tRNS``
ignored), and 16-bit samples keep their high byte (libpng's
``png_set_strip_16``).  It takes non-interlaced streams of bit depth 8 or
16 in colour types 0 (gray), 2 (RGB), 3 (palette, depth 8), 4 (gray +
alpha) and 6 (RGBA); anything else raises ``ValueError("unsupported PNG
(...)")``, as does a bad signature, chunk CRC or zlib stream.  Gamma and
colour-profile chunks are ignored, as OpenCV ignores them.

The scanline filters (none, sub, up, average, Paeth) are undone with
numpy: rows of filters none, sub and up one at a time, and the rest along
the anti-diagonals of the pixel grid, whose pixels depend only on the
two diagonals before them (left, above, above-left).

:func:`encode` writes a uint8 RGB image as an 8-bit PNG with filter
"none" on every row, which OpenCV's and this module's decoders read
back bit for bit; the JAX package writes its PNGs with ``cv2.imwrite``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["SIGNATURE", "decode", "encode", "is_png"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def is_png(data: bytes) -> bool:
    return bytes(data[:8]) == SIGNATURE


def _unsupported(what: str) -> ValueError:
    return ValueError(f"unsupported PNG ({what})")


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG stream has no IEND chunk")


def _unfilter(raw: np.ndarray, height: int, row_bytes: int,
              bpp: int) -> np.ndarray:
    """The reconstructed (height, row_bytes) bytes of filtered scanlines
    ``raw`` (each row a filter-type byte then ``row_bytes``), with
    ``bpp`` bytes a pixel (at least 1)."""
    rows = raw.reshape(height, row_bytes + 1)
    types = rows[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(types.max())}")
    filt = rows[:, 1:]
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    sequential = types >= 3                 # average, Paeth
    for r in range(height):
        t = types[r]
        if t == 0:
            out[r] = filt[r]
        elif t == 1:
            out[r] = np.cumsum(filt[r].reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif t == 2:
            out[r] = filt[r] + prev
        else:
            break
        prev = out[r]
    else:
        return out
    if not sequential.any():
        return out
    # the rest along anti-diagonals of the (height, width) pixel grid: a
    # pixel reads its left, upper and upper-left neighbours, all on the
    # two diagonals before its own; zero outside the image
    width = row_bytes // bpp
    grid = np.zeros((height + 1, width + 1, bpp), np.int32)
    grid[1:, 1:] = out.reshape(height, width, bpp)
    f = filt.reshape(height, width, bpp).astype(np.int32)
    start = r
    for d in range(start, height + width - 1):
        ys = np.arange(max(start, d - width + 1), min(height, d + 1))
        if ys.size == 0:
            continue
        xs = d - ys
        a = grid[ys + 1, xs]                  # left
        b = grid[ys, xs + 1]                  # above
        c = grid[ys, xs]                      # above-left
        t = types[ys][:, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        grid[ys + 1, xs + 1] = (f[ys, xs] + pred) & 0xFF
    return grid[1:, 1:].reshape(height, row_bytes).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """RGB uint8 (H, W, 3) of a PNG stream, as ``cv2.imdecode(data,
    IMREAD_COLOR)`` then ``BGR2RGB`` give it (see the module's text)."""
    data = bytes(data)
    if not is_png(data):
        raise ValueError("not a PNG stream (bad signature)")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG stream has no IHDR chunk")
    width, height, depth, ctype, comp, filt_method, interlace = header
    if ctype not in _CHANNELS:
        raise _unsupported(f"colour type {ctype}")
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise _unsupported(f"bit depth {depth} with colour type {ctype}")
    if interlace:
        raise _unsupported("interlaced")
    if comp or filt_method:
        raise _unsupported(f"compression {comp}, filter method "
                           f"{filt_method}")
    if not width or not height:
        raise ValueError("PNG image is empty")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    row_bytes = width * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from None
    if len(raw) < height * (row_bytes + 1):
        raise ValueError("PNG image data is truncated")
    raw = np.frombuffer(raw, np.uint8)[:height * (row_bytes + 1)]
    pixels = _unfilter(raw, height, row_bytes, bpp)
    if depth == 16:                         # the high byte of each sample
        pixels = pixels[:, 0::2]
    pixels = pixels.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        index = pixels[:, :, 0]
        if index.max() >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[index]
    if channels <= 2:                        # gray (+ alpha)
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(image: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of a uint8 (H, W, 3) RGB image: bit depth 8, colour type
    2, no interlace, filter "none", zlib ``level``."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode takes uint8 (H, W, 3), got {image.dtype} "
                         f"{image.shape}")
    h, w = image.shape[:2]
    rows = np.ascontiguousarray(image).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))
