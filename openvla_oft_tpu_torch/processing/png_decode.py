"""PNG decoding as PIL's `Image.open(...).convert("RGB")` gives it, with numpy
and the standard library's zlib.

The stream: the signature, then chunks, each CRC-checked (a mismatch
raises); IHDR, PLTE, tRNS, IDAT (concatenated, then inflated) and IEND are
read, every other chunk skipped. The image: the five scanline filters
(None, Sub, Up, Average, Paeth over the pixel's bytes, at least 1), Adam7
interlacing (seven passes, each its own filtered sub-image), bit depths 1,
2, 4, 8 and 16 (samples below 8 bits packed MSB first, each row padded to
a byte) and colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha)
and 6 (RGBA).

The RGB result is PIL's (PngImagePlugin's modes, then Convert.c):
  grey         1 bit: 0 or 255 (mode "1"); 2 and 4 bits scaled by 85 and
               17 ("L;2", "L;4"); 16 bits as "I;16", whose conversion to
               RGB clips at 255 (a sample of 308 gives 255); replicated
  RGB          16 bits keep the high byte ("RGB;16B")
  palette      looked up in PLTE; an index past its end gives black
  alpha        dropped, not composited (types 4 and 6, 16 bits the high
               byte; tRNS is read and ignored, as `convert("RGB")` does)
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first row, first column, row step, column step) of each pass.
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))


def _fail(what: str) -> ValueError:
    return ValueError(f"PNG decode failed: {what}")


def _chunks(data: bytes):
    """(type, body) of every chunk up to IEND, each CRC-checked."""
    if data[:8] != SIGNATURE:
        raise _fail("not a PNG stream (no signature)")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise _fail("premature end of PNG data (no IEND)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise _fail(f"premature end of PNG data in a {kind.decode(errors='replace')} chunk")
        body = data[pos + 8:end]
        crc = struct.unpack(">I", data[end:end + 4])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise _fail(f"bad CRC in a {kind.decode(errors='replace')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end + 4


def _unfilter(raw: memoryview, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters: rows of 1 + stride bytes -> uint8
    (rows, stride)."""
    out = np.zeros((rows, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(rows):
        start = y * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw[start + 1:start + 1 + stride], np.uint8).astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prior) & 0xFF
        elif ftype == 1 and stride % bpp == 0:
            # Sub: a running sum along each of the pixel's bytes
            cur = (line.reshape(-1, bpp).cumsum(0, dtype=np.int64) & 0xFF).reshape(-1)
        elif ftype in (1, 3, 4):
            # Average and Paeth run along the row: byte x needs x - bpp.
            cur = line.copy()
            lst = cur.tolist()
            up = prior.tolist()
            for x in range(stride):
                a = lst[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 1:
                    p = a
                elif ftype == 3:
                    p = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                lst[x] = (lst[x] + p) & 0xFF
            cur = np.array(lst, np.int32)
        else:
            raise _fail(f"unknown scanline filter {ftype}")
        out[y] = cur
        prior = cur
    return out


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows -> samples (rows, width, channels): uint8 below 16
    bits (unpacked MSB first), uint16 at 16 bits (big-endian)."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, :2 * width * channels].reshape(h, width * channels, 2).astype(
            np.uint16).dot(np.array([256, 1], np.uint16)).reshape(h, width, channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    vals = bits.dot(1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return vals[:, :width].reshape(h, width, 1)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, 3), `Image.open(...).convert("RGB")`'s
    pixels."""
    data = bytes(data)
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise _fail("bad IHDR length")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not body:
                raise _fail("bad PLTE length")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise _fail("no IHDR chunk")
    width, height, depth, ctype, compression, filt, interlace = header
    if width == 0 or height == 0 or width * height > 1 << 28:
        raise _fail(f"image size {width} x {height} out of range")
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise _fail(f"bit depth {depth} with colour type {ctype}")
    if compression != 0 or filt != 0 or interlace not in (0, 1):
        raise _fail("unknown compression, filter or interlace method")
    if ctype == 3 and palette is None:
        raise _fail("a palette image with no PLTE chunk")
    if not idat:
        raise _fail("no IDAT chunk")
    try:
        raw = memoryview(zlib.decompress(b"".join(idat)))
    except zlib.error as e:
        raise _fail(f"corrupt image data ({e})") from None
    channels = _CHANNELS[ctype]
    bpp = max(1, channels * depth // 8)
    samples = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue
        stride = -(-w * channels * depth // 8)
        size = h * (stride + 1)
        if pos + size > len(raw):
            raise _fail("image data too short")
        rows = _unfilter(raw[pos:pos + size], h, stride, bpp)
        samples[y0::dy, x0::dx] = _samples(rows, w, depth, channels)
        pos += size
    return _to_rgb(samples, depth, ctype, palette)


def _to_rgb(s: np.ndarray, depth: int, ctype: int, palette) -> np.ndarray:
    """PIL's mode for the samples, then its conversion to RGB."""
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:min(len(palette), 256)] = palette[:256]
        return lut[s[..., 0]]
    if depth == 16:
        s = np.minimum(s, 255) if ctype == 0 else s >> 8
        s = s.astype(np.uint8)
    elif ctype == 0 and depth < 8:
        s = s * np.uint8({1: 255, 2: 85, 4: 17}[depth])
    if ctype in (0, 4):
        return np.repeat(s[..., :1], 3, -1)
    return np.ascontiguousarray(s[..., :3])
