"""Baseline JPEG decoding as `tf.io.decode_jpeg(data, channels=3)` or PIL does it.

TF decodes with libjpeg-turbo: the IFAST inverse DCT (its default
`dct_method`), fancy upsampling, then RGB; a grey image is replicated to 3
channels. PIL (`Image.open(...).convert("RGB")`) takes the same stages with
the ISLOW inverse DCT (`jidctint.c`), which the caller asks for with
`idct="islow"`; the default stays IFAST. Two decoders give either, bit for
bit:

  decode_jpeg        the host library's (`hostsrc/jpeg_decode.cc`, built by
                     `_host_build.py`): the training loader's, called from a
                     pool of threads (ctypes releases the GIL).
  decode_jpeg_plain  the plain version: the byte stream parsed and
                     entropy-decoded here in Python, then `processing/jpeg.py`'s
                     torch stages (`dequantize`, `inverse_dct`,
                     `upsample_h2v2`, `ycbcr_to_rgb`). Tests hold the host
                     library to it; nothing on the training path uses it.

Both read SOI, APPn and COM (skipped), DQT (8- and 16-bit), SOF0 and SOF1,
DHT, SOS, DRI, RSTn and EOI, and take 4:2:0, 4:4:4 and grey. Progressive,
lossless, hierarchical, arithmetic-coded and 12-bit streams raise, naming
their SOF marker, as does any other sampling layout.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from openvla_oft_tpu_torch.processing import jpeg as J

_ERR_LEN = 256


def _check(rc: int, err) -> None:
    if rc != 0:
        raise ValueError(f"JPEG decode failed: {err.value.decode(errors='replace')}")


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(height, width) from the frame header (host library)."""
    from openvla_oft_tpu_torch._host_build import library

    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(library().openvla_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                                       err, _ERR_LEN), err)
    return h.value, w.value


IDCTS = ("ifast", "islow")


def _check_idct(idct: str) -> None:
    if idct not in IDCTS:
        raise ValueError(f"idct {idct!r}: use 'ifast' (TF's decode) or 'islow' (PIL's)")


def decode_jpeg(data: bytes, idct: str = "ifast") -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3) RGB, by the host library. idct:
    "ifast" gives `tf.io.decode_jpeg`'s pixels, "islow" PIL's
    (`Image.open(...).convert("RGB")`)."""
    from openvla_oft_tpu_torch._host_build import library

    _check_idct(idct)
    data = bytes(data)
    h, w = jpeg_size(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(library().openvla_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes,
                                         int(idct == "islow"), err, _ERR_LEN), err)
    return out


# === The plain version ===
# jutils.c jpeg_natural_order, with libjpeg's 16 extra entries for corrupt runs.
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16)
_REFUSED = {0xC2: "progressive DCT (SOF2)", 0xC3: "lossless (SOF3)",
            0xC5: "differential sequential (SOF5)", 0xC6: "differential progressive (SOF6)",
            0xC7: "differential lossless (SOF7)", 0xC9: "arithmetic-coded sequential (SOF9)",
            0xCA: "arithmetic-coded progressive (SOF10)",
            0xCB: "arithmetic-coded lossless (SOF11)",
            0xCC: "arithmetic coding conditioning (DAC)",
            0xCD: "arithmetic-coded differential sequential (SOF13)",
            0xCE: "arithmetic-coded differential progressive (SOF14)",
            0xCF: "arithmetic-coded differential lossless (SOF15)"}


def _lookup(counts: List[int], symbols: bytes) -> List[int]:
    """Huffman table -> a list indexed by the next 16 bits:
    (code length << 8) | symbol, 0 where no code is a prefix."""
    table = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("JPEG decode failed: bad Huffman table (code space)")
            lo, hi = code << (16 - length), (code + 1) << (16 - length)
            table[lo:hi] = [(length << 8) | symbols[k]] * (hi - lo)
            code += 1
            k += 1
        code <<= 1
    return table


def _intervals(d: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from `pos` to the next marker other than RSTn,
    one unstuffed byte string per restart interval, and that marker's
    position."""
    out, cur, n = [], bytearray(), len(d)
    while True:
        j = d.find(b"\xff", pos)
        if j < 0:
            cur += d[pos:]
            pos = n
            break
        cur += d[pos:j]
        k = j + 1
        while k < n and d[k] == 0xFF:
            k += 1
        if k >= n:
            pos = n
            break
        if d[k] == 0x00:
            cur.append(0xFF)
            pos = k + 1
        elif 0xD0 <= d[k] <= 0xD7:
            out.append(bytes(cur))
            cur = bytearray()
            pos = k + 1
        else:
            pos = j
            break
    out.append(bytes(cur))
    return out, pos


class _Bits:
    """MSB-first bit reader over unstuffed data, zeros past its end."""

    def __init__(self, data: bytes):
        padded = data + bytes(8)
        a = np.frombuffer(padded, np.uint8).astype(np.uint32)
        # the 32 bits starting at each byte
        self.win = ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]).tolist()
        self.limit = len(self.win) - 1
        self.pos = 0

    def peek16(self) -> int:
        i = self.pos >> 3
        if i >= self.limit:
            return 0
        return (self.win[i] >> (16 - (self.pos & 7))) & 0xFFFF

    def get(self, k: int) -> int:
        i = self.pos >> 3
        v = 0 if i >= self.limit else (self.win[i] >> (32 - (self.pos & 7) - k)) & ((1 << k) - 1)
        self.pos += k
        return v


def _symbol(bits: _Bits, table: List[int]) -> int:
    e = table[bits.peek16()]
    if not e:
        raise ValueError("JPEG decode failed: corrupt JPEG data: bad Huffman code")
    bits.pos += e >> 8
    return e & 0xFF


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _parse(d: bytes) -> Dict:
    """Markers and every scan's quantized coefficients: {"size": (H, W),
    "comps": [{"h", "v", "tq", "coef" int32 (blocks_h, blocks_w, 64)
    natural order, "width", "height"}], "tables": {tq: (8, 8) int64},
    "adobe_transform"}."""
    if len(d) < 2 or d[:2] != b"\xff\xd8":
        raise ValueError("JPEG decode failed: not a JPEG stream (no SOI)")
    pos, n = 2, len(d)
    tables, huff = {}, {}
    comps: List[Dict] = []
    frame = None
    restart, adobe = 0, -1
    scanned = False

    def word(i):
        return (d[i] << 8) | d[i + 1]

    while True:
        if pos >= n or d[pos] != 0xFF:
            raise ValueError("JPEG decode failed: expected a marker")
        while pos < n and d[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError("JPEG decode failed: premature end of JPEG data")
        m = d[pos]
        pos += 1
        if m == 0xD9:
            break
        if m in _REFUSED:
            raise ValueError(f"JPEG decode failed: unsupported JPEG: {_REFUSED[m]}")
        if pos + 2 > n:
            raise ValueError("JPEG decode failed: premature end of JPEG data")
        end = pos + word(pos)
        body = pos + 2
        if m in (0xC0, 0xC1):
            precision = d[body]
            if precision != 8:
                raise ValueError(f"JPEG decode failed: unsupported JPEG: {precision}-bit "
                                 "samples (SOF precision)")
            height, width, nc = word(body + 1), word(body + 3), d[body + 5]
            if height == 0 or width == 0:
                raise ValueError("JPEG decode failed: unsupported JPEG: zero image size (DNL)")
            if nc not in (1, 3):
                raise ValueError(f"JPEG decode failed: unsupported JPEG: {nc} components")
            for c in range(nc):
                cid, hv, tq = d[body + 6 + 3 * c: body + 9 + 3 * c]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
            if nc == 1:
                comps[0]["h"] = comps[0]["v"] = 1
            hv = [(c["h"], c["v"]) for c in comps]
            if nc == 3 and (hv[1:] != [(1, 1), (1, 1)] or hv[0] not in ((1, 1), (2, 2))):
                raise ValueError(f"JPEG decode failed: unsupported JPEG sampling {hv}: only "
                                 "4:4:4, 4:2:0 and grey")
            hmax, vmax = max(h for h, _ in hv), max(v for _, v in hv)
            mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c["width"] = -(-width * c["h"] // hmax)
                c["height"] = -(-height * c["v"] // vmax)
                c["coef"] = np.zeros((my * c["v"], mx * c["h"], 64), np.int32)
            frame = (height, width, mx, my)
        elif m == 0xDB:
            i = body
            while i < end:
                pq, tq = d[i] >> 4, d[i] & 15
                i += 1
                vals = [word(i + 2 * k) for k in range(64)] if pq else list(d[i:i + 64])
                i += 128 if pq else 64
                t = np.zeros(64, np.int64)
                t[_NATURAL[:64]] = vals
                tables[tq] = t.reshape(8, 8)
        elif m == 0xC4:
            i = body
            while i < end:
                tc, th = d[i] >> 4, d[i] & 15
                counts = list(d[i + 1:i + 17])
                total = sum(counts)
                huff[(tc, th)] = _lookup(counts, d[i + 17:i + 17 + total])
                i += 17 + total
        elif m == 0xDD:
            restart = word(body)
        elif m == 0xDC:
            raise ValueError("JPEG decode failed: unsupported JPEG: DNL marker")
        elif m == 0xEE and d[body:body + 5] == b"Adobe" and end - body >= 12:
            adobe = d[body + 11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError("JPEG decode failed: SOS before a frame header")
            ns = d[body]
            sc = []
            for k in range(ns):
                cid, t = d[body + 1 + 2 * k], d[body + 2 + 2 * k]
                c = next(c for c in comps if c["id"] == cid)
                sc.append((c, huff[(0, t >> 4)], huff[(1, t & 15)]))
            ss, se, a = d[body + 1 + 2 * ns: body + 4 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise ValueError("JPEG decode failed: unsupported JPEG: a progressive scan")
            pos = _scan(d, end, sc, frame, restart)
            scanned = True
            continue
        pos = end
    if frame is None or not scanned:
        raise ValueError("JPEG decode failed: no frame or no scan before EOI")
    return {"size": frame[:2], "comps": comps, "tables": tables, "adobe_transform": adobe}


def _scan(d: bytes, start: int, sc, frame, restart: int) -> int:
    """Entropy-decode one scan into its components' coefficient arrays;
    returns the position of the marker after it."""
    _, _, mx, my = frame
    single = len(sc) == 1
    if single:
        c = sc[0][0]
        ux, uy = -(-c["width"] // 8), -(-c["height"] // 8)
    else:
        ux, uy = mx, my
    data, end = _intervals(d, start)
    total = ux * uy
    per = restart or total
    bits = _Bits(data[0])
    preds = [0] * len(sc)
    natural = _NATURAL.tolist()
    for m in range(total):
        if m and m % per == 0:
            seg = m // per
            bits = _Bits(data[seg] if seg < len(data) else b"")
            preds = [0] * len(sc)
        bx0, by0 = m % ux, m // ux
        for ci, (c, dc, ac) in enumerate(sc):
            bh, bv = (1, 1) if single else (c["h"], c["v"])
            coef = c["coef"]
            for by in range(bv):
                for bx in range(bh):
                    blk = [0] * 64
                    s = _symbol(bits, dc)
                    if s:
                        preds[ci] += _extend(bits.get(s), s)
                    blk[0] = preds[ci]
                    k = 1
                    while k < 64:
                        rs = _symbol(bits, ac)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[natural[k]] = _extend(bits.get(s), s)
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            break
                    coef[by0 * bv + by, bx0 * bh + bx] = blk
    return end


def _plane(coef: np.ndarray, table: np.ndarray, idct: str) -> torch.Tensor:
    """Quantized (bh, bw, 64) -> samples (1, 8 bh, 8 bw), int32."""
    bh, bw, _ = coef.shape
    blocks = torch.from_numpy(coef).reshape(1, bh, bw, 8, 8)
    if idct == "islow":
        return J.from_blocks(J.inverse_dct_islow(
            blocks.long() * torch.from_numpy(J.islow_multipliers(table))))
    # jddctmgr.c keeps the IFAST multiplier in a short (a 16-bit DQT can wrap)
    mult = J.ifast_multipliers(table).astype(np.int16).astype(np.int32)
    return J.from_blocks(J.inverse_dct(blocks * torch.from_numpy(mult)))


def decode_jpeg_plain(data: bytes, idct: str = "ifast") -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3) RGB: the byte stream in Python, the
    sample stages in `processing/jpeg.py`'s torch integer ops; `idct` as
    `decode_jpeg`'s."""
    _check_idct(idct)
    p = _parse(bytes(data))
    h, w = p["size"]
    planes = []
    for c in p["comps"]:
        if c["tq"] not in p["tables"]:
            raise ValueError("JPEG decode failed: a component uses an undefined "
                             "quantization table")
        planes.append(_plane(c["coef"], p["tables"][c["tq"]], idct))
    if len(planes) == 1:
        y = planes[0][0, :h, :w]
        return y[..., None].expand(h, w, 3).to(torch.uint8).numpy().copy()
    if p["adobe_transform"] == 0:
        raise ValueError("JPEG decode failed: unsupported JPEG: RGB components (Adobe "
                         "transform 0)")
    y = planes[0][:, :h, :w]
    cb_c, cr_c = p["comps"][1], p["comps"][2]
    chroma = torch.cat([planes[1][:, :cb_c["height"], :cb_c["width"]],
                        planes[2][:, :cr_c["height"], :cr_c["width"]]])
    if p["comps"][0]["h"] == 2:
        chroma = J.upsample_h2v2(chroma)
    chroma = chroma[:, :h, :w]
    rgb = J.ycbcr_to_rgb(torch.stack([y[0], chroma[0], chroma[1]], -1))
    return rgb.to(torch.uint8).numpy()
