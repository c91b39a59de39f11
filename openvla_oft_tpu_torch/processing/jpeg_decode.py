"""JPEG decoding as `tf.io.decode_jpeg(data, channels=3)` or PIL does it.

TF decodes with libjpeg-turbo 2.1.4: the IFAST inverse DCT (its default
`dct_method`), fancy upsampling, then RGB; a grey image is replicated to 3
channels. PIL (`Image.open(...).convert("RGB")`) takes the same stages with
libjpeg-turbo 3.x and the ISLOW inverse DCT (`jidctint.c`), which the caller
asks for with `idct="islow"`; the default stays IFAST. Two decoders give
either, bit for bit:

  decode_jpeg        the host library's (`hostsrc/jpeg_decode.cc`, built by
                     `_host_build.py`): the training loader's, called from a
                     pool of threads (ctypes releases the GIL).
  decode_jpeg_plain  the plain version: the byte stream parsed and
                     entropy-decoded here in Python, then `processing/jpeg.py`'s
                     torch stages (`inverse_dct` or `inverse_dct_islow` over
                     the dequantized blocks, `upsample`, `ycbcr_to_rgb`,
                     `ycck_to_cmyk`, `cmyk_to_rgb_pil` / `_tf`). Tests hold the
                     host library to it; nothing on the training path uses it.

Both read SOI, APPn (JFIF APP0 and Adobe APP14 read, the others skipped) and
COM, DQT (8- and 16-bit), SOF0, SOF1 and SOF2, DHT, SOS, DRI, RSTn and EOI.
A progressive frame (SOF2) takes jdphuff.c's four scan kinds into a
coefficient buffer kept across scans, and, where some of the first AC
coefficients were never refined to Al = 0 (a stream that stops after its
early scans), jdcoefct.c's block smoothing: the 5 x 5 DC estimate, walked as
libjpeg-turbo 3.x walks the blocks for "islow" (PIL's) and as 2.1.4 does for
"ifast" (TF's; the two differ at iMCU-row edges and on images two blocks
wide). Every integral sampling layout upsamples as jdsample.c chooses; 1, 3
(YCbCr, or RGB under Adobe transform 0) and 4 (CMYK, YCCK) components.
Lossless, hierarchical, arithmetic-coded and 12-bit streams, and DNL, raise,
naming their marker.
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
_NATURAL = np.concatenate([J.NATURAL_ORDER, [63] * 16])
_REFUSED = {0xC3: "lossless (SOF3)",
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
        if k == 0:
            return 0
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


def _int16(v: int) -> int:
    """A JCOEF (short) store."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _parse(d: bytes) -> Dict:
    """Markers and every scan's quantized coefficients: {"size": (H, W),
    "hmax", "vmax", "imcu_rows", "progressive", "comps": [{"id", "h", "v",
    "tq", "width", "height" (the real downsampled size), "bw", "bh" (its
    blocks), "blocks" (a list of 64-entry lists, natural order, over the
    MCU grid's padded rows and columns), "cols", "bits" (jdphuff.c's
    coef_bits: the Al of the last scan of each coefficient, -1 before any),
    "qt" (the table latched at the component's first scan)}], "jfif",
    "adobe_transform"}."""
    if len(d) < 2 or d[:2] != b"\xff\xd8":
        raise ValueError("JPEG decode failed: not a JPEG stream (no SOI)")
    pos, n = 2, len(d)
    tables, huff = {}, {}
    comps: List[Dict] = []
    frame = None
    restart, adobe, jfif = 0, -1, False
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
        if m in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("JPEG decode failed: a second frame header")
            precision = d[body]
            if precision != 8:
                raise ValueError(f"JPEG decode failed: unsupported JPEG: {precision}-bit "
                                 "samples (SOF precision)")
            height, width, nc = word(body + 1), word(body + 3), d[body + 5]
            if height == 0 or width == 0:
                raise ValueError("JPEG decode failed: unsupported JPEG: zero image size (DNL)")
            if nc not in (1, 3, 4):
                raise ValueError(f"JPEG decode failed: unsupported JPEG: {nc} components")
            for c in range(nc):
                cid, hv, tq = d[body + 6 + 3 * c: body + 9 + 3 * c]
                if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3:
                    raise ValueError("JPEG decode failed: bad component in the frame header")
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
            hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
            mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c["width"] = -(-width * c["h"] // hmax)
                c["height"] = -(-height * c["v"] // vmax)
                c["bw"], c["bh"] = -(-c["width"] // 8), -(-c["height"] // 8)
                c["cols"] = mx * c["h"]
                c["blocks"] = [[0] * 64 for _ in range(my * c["v"] * mx * c["h"])]
                c["bits"] = [-1] * 64
                c["qt"] = None
            frame = {"size": (height, width), "hmax": hmax, "vmax": vmax, "mx": mx,
                     "imcu_rows": my, "progressive": m == 0xC2}
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
        elif m == 0xE0 and end - body >= 14 and d[body:body + 5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and end - body >= 12 and d[body:body + 5] == b"Adobe":
            adobe = d[body + 11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError("JPEG decode failed: SOS before a frame header")
            ns = d[body]
            ss, se, a = d[body + 1 + 2 * ns: body + 4 + 2 * ns]
            sc = []
            for k in range(ns):
                cid, t = d[body + 1 + 2 * k], d[body + 2 + 2 * k]
                c = next((c for c in comps if c["id"] == cid), None)
                if c is None:
                    raise ValueError("JPEG decode failed: scan names an unknown component")
                if c["tq"] not in tables:
                    raise ValueError("JPEG decode failed: a component uses an undefined "
                                     "quantization table")
                if c["qt"] is None:  # jdinput.c latch_quant_tables
                    c["qt"] = tables[c["tq"]].copy()
                sc.append((c, huff.get((0, t >> 4)), huff.get((1, t & 15))))
            pos = _scan(d, end, sc, frame, restart, ss, se, a >> 4, a & 15)
            scanned = True
            continue
        pos = end
    if frame is None or not scanned:
        raise ValueError("JPEG decode failed: no frame or no scan before EOI")
    return {**frame, "comps": comps, "jfif": jfif, "adobe_transform": adobe}


def _scan(d: bytes, start: int, sc, frame, restart: int, ss: int, se: int, ah: int,
          al: int) -> int:
    """Entropy-decode one scan into its components' coefficients (jdhuff.c
    for a sequential frame; jdphuff.c's four scan kinds for a progressive
    one); returns the position of the marker after it."""
    if not frame["progressive"]:
        if (ss, se, ah, al) != (0, 63, 0, 0):
            raise ValueError("JPEG decode failed: unsupported JPEG: a progressive scan")
        kind = "sequential"
    elif ss == 0:
        if se != 0:
            raise ValueError("JPEG decode failed: bad progression (a DC scan with AC)")
        kind = "dc_first" if ah == 0 else "dc_refine"
    else:
        if len(sc) != 1 or se < ss or se > 63:
            raise ValueError("JPEG decode failed: bad progression (an AC scan)")
        kind = "ac_first" if ah == 0 else "ac_refine"
    for c, dc, ac in sc:
        if (kind in ("sequential", "dc_first") and dc is None) or (
                kind in ("sequential", "ac_first", "ac_refine") and ac is None):
            raise ValueError("JPEG decode failed: scan uses an undefined Huffman table")
    single = len(sc) == 1
    if single:
        c = sc[0][0]
        ux, uy = c["bw"], c["bh"]
    else:
        ux, uy = frame["mx"], frame["imcu_rows"]
    data, end = _intervals(d, start)
    total = ux * uy
    per = restart or total
    bits = _Bits(data[0])
    preds = [0] * len(sc)
    state = {"eobrun": 0}
    natural = _NATURAL.tolist()
    p1, m1 = 1 << al, -(1 << al)
    for m in range(total):
        if m and m % per == 0:
            # a restart: byte-aligned new data; predictors and EOBRUN reset
            seg = m // per
            bits = _Bits(data[seg] if seg < len(data) else b"")
            preds = [0] * len(sc)
            state["eobrun"] = 0
        bx0, by0 = m % ux, m // ux
        for ci, (c, dc, ac) in enumerate(sc):
            bh, bv = (1, 1) if single else (c["h"], c["v"])
            cols, blocks = c["cols"], c["blocks"]
            for by in range(bv):
                for bx in range(bh):
                    blk = blocks[(by0 * bv + by) * cols + bx0 * bh + bx]
                    if kind == "sequential":
                        _block_sequential(bits, dc, ac, blk, preds, ci, natural)
                    elif kind == "dc_first":
                        s = _symbol(bits, dc)
                        if s:
                            preds[ci] += _extend(bits.get(s), s)
                        blk[0] = _int16(preds[ci] << al)
                    elif kind == "dc_refine":
                        if bits.get(1):
                            blk[0] = _int16(blk[0] | p1)
                    elif kind == "ac_first":
                        _block_ac_first(bits, ac, blk, ss, se, al, state, natural)
                    else:
                        _block_ac_refine(bits, ac, blk, ss, se, p1, m1, state, natural)
    for c, _, _ in sc:
        c["bits"][ss:se + 1] = [al] * (se + 1 - ss)
    return end


def _block_sequential(bits, dc, ac, blk, preds, ci, natural) -> None:
    """jdhuff.c decode_mcu: one block, DC difference then the AC runs."""
    blk[:] = [0] * 64
    s = _symbol(bits, dc)
    if s:
        preds[ci] += _extend(bits.get(s), s)
    blk[0] = _int16(preds[ci])
    k = 1
    while k < 64:
        rs = _symbol(bits, ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            blk[natural[k]] = _int16(_extend(bits.get(s), s))
            k += 1
        elif r == 15:
            k += 16
        else:
            break


def _block_ac_first(bits, ac, blk, ss, se, al, state, natural) -> None:
    """jdphuff.c decode_mcu_AC_first: the band's first pass, EOB runs
    spanning blocks."""
    if state["eobrun"] > 0:
        state["eobrun"] -= 1
        return
    k = ss
    while k <= se:
        rs = _symbol(bits, ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            blk[natural[k]] = _int16(_extend(bits.get(s), s) << al)
        elif r == 15:
            k += 15
        else:
            eobrun = 1 << r
            if r:
                eobrun += bits.get(r)
            state["eobrun"] = eobrun - 1
            break
        k += 1


def _block_ac_refine(bits, ac, blk, ss, se, p1, m1, state, natural) -> None:
    """jdphuff.c decode_mcu_AC_refine: one more bit of the band; a
    correction bit for every coefficient already nonzero that the run
    passes, newly nonzero coefficients of +-1 << Al."""
    k = ss
    if state["eobrun"] == 0:
        while k <= se:
            rs = _symbol(bits, ac)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if bits.get(1) else m1
            elif r != 15:
                eobrun = 1 << r
                if r:
                    eobrun += bits.get(r)
                state["eobrun"] = eobrun
                break
            while k <= se:
                pos = natural[k]
                if blk[pos] != 0:
                    if bits.get(1) and blk[pos] & p1 == 0:
                        blk[pos] = _int16(blk[pos] + (p1 if blk[pos] >= 0 else m1))
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                blk[natural[k]] = s
            k += 1
    if state["eobrun"] > 0:
        while k <= se:
            pos = natural[k]
            if blk[pos] != 0 and bits.get(1) and blk[pos] & p1 == 0:
                blk[pos] = _int16(blk[pos] + (p1 if blk[pos] >= 0 else m1))
            k += 1
        state["eobrun"] -= 1


# jdcoefct.c: the natural-order positions of the first 9 zig-zag AC
# coefficients, which block smoothing estimates.
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)


def _smoothing_ok(p: Dict) -> bool:
    """jdcoefct.c smoothing_ok: a progressive frame whose every component has
    its DC at least partly known and nonzero quantizers at DC and the 9
    first AC positions, and some component with one of those AC
    coefficients not refined to Al = 0."""
    if not p["progressive"]:
        return False
    useful = False
    for c in p["comps"]:
        qt = c["qt"]
        if qt is None or any(qt.reshape(64)[k] == 0 for k in (0,) + _SMOOTH_POS):
            return False
        if c["bits"][0] < 0:
            return False
        useful |= any(b != 0 for b in c["bits"][1:10])
    return useful


# jdcoefct.c decompress_smooth_data (libjpeg-turbo >= 2.1): the kernels over
# the 5 x 5 DC neighbourhood, rows DC01..DC05 (two block rows up) to
# DC21..DC25 (two down), each row two blocks left to two right.
_K = {
    "ac01_dc": [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
                [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]],
    "ac01": [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-7, 50, 0, -50, 7], [0, 0, 0, 0, 0],
             [0, 0, 0, 0, 0]],
    "ac20_dc": [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0],
                [0, 0, 1, 0, 0]],
    "ac20": [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0],
             [0, 0, -1, 0, 0]],
    "ac11_dc": [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0], [0, -9, 0, 9, 0],
                [1, 0, 0, 0, -1]],
    "ac11": [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0, 0, 0, 0, 0], [1, -10, 0, 10, -1],
             [0, 1, 0, -1, 0]],
    "ac03_dc": [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0],
                [0, 0, 0, 0, 0]],
    "ac12_dc": [[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0], [0, -1, 3, -1, 0],
                [0, 0, 0, 0, 0]],
    "dc": [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
           [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]],
}


def _t(k):
    return [list(r) for r in zip(*k)]


# (zig-zag index, natural position, kernel with DC interpolation, without)
_SMOOTH = [
    (1, 1, _K["ac01_dc"], _K["ac01"]),
    (2, 8, _t(_K["ac01_dc"]), _t(_K["ac01"])),
    (3, 16, _K["ac20_dc"], _K["ac20"]),
    (4, 9, _K["ac11_dc"], _K["ac11"]),
    (5, 2, _t(_K["ac20_dc"]), _t(_K["ac20"])),
    (6, 3, _K["ac03_dc"], None),
    (7, 10, _K["ac12_dc"], None),
    (8, 17, _t(_K["ac12_dc"]), None),
    (9, 24, _t(_K["ac03_dc"]), None),
]


def smoothing_rows(bh: int, v: int, imcu_rows: int, turbo: str) -> np.ndarray:
    """jdcoefct.c decompress_smooth_data's block rows, walked as libjpeg
    walks them, one iMCU row (v block rows) at a time: for each real block
    row a, the rows it reads as two up, one up, itself, one down and two
    down, (bh, 5).

    turbo "3" (libjpeg-turbo 3.x, PIL's): a row's place is counted in rows
    of its own iMCU row's length (r n + b, n the real block rows of iMCU row
    r), and the image's in n imcu_rows; so the last iMCU row, when it is
    short, is indexed by its own count, not by v. turbo "2.1" (2.1.4, TF's):
    the rows above exist from block row b > k or iMCU row r > k (k = 0 for
    one up, 1 for two up) and the rows below from b < n - 1 - k or from an
    iMCU row k + 1 before the last. Either may read a dummy row of the
    padded MCU grid (its DC from an interleaved scan, else 0)."""
    rows, last = [], imcu_rows - 1
    for r in range(imcu_rows):
        n = v if r < last else (bh % v or v)
        for b in range(n):
            a = r * v + b
            if turbo == "3":
                i, total = r * n + b, n * imcu_rows
                up, up2 = i > 0, i > 1
                down, down2 = i < total - 1, i < total - 2
            else:
                up, up2 = b > 0 or r > 0, b > 1 or r > 1
                down, down2 = b < n - 1 or r < last, b < n - 2 or r + 1 < last
            prev = a - 1 if up else a
            nxt = a + 1 if down else a
            rows.append((a - 2 if up2 else prev, prev, a, nxt, a + 2 if down2 else nxt))
    return np.array(rows[:bh], np.int64).reshape(bh, 5)


def smoothing_cols(bw: int, turbo: str) -> np.ndarray:
    """The block columns decompress_smooth_data reads for each block, two
    left to two right, (bw, 5): the edge block repeated past either edge.
    libjpeg-turbo 2.1.4 (TF's) loads the third column into its sliding
    window only from the second block on, so an image two blocks wide
    keeps the first block's DC there: [0 0 0 1 0] and then [0 0 1 0 0]."""
    if turbo == "2.1" and bw == 2:
        return np.array([[0, 0, 0, 1, 0], [0, 0, 1, 0, 0]], np.int64)
    return np.clip(np.arange(bw)[:, None] + np.arange(-2, 3)[None], 0, bw - 1)


def smooth_blocks(coef: np.ndarray, bits: List[int], qt: np.ndarray, bh: int, bw: int,
                  v: int, imcu_rows: int, turbo: str) -> np.ndarray:
    """jdcoefct.c decompress_smooth_data on one component: quantized
    (padded rows, padded cols, 64) natural order -> its real (bh, bw, 64)
    blocks with the first 9 AC coefficients estimated from the DC values of
    the 5 x 5 neighbourhood where a coefficient is still 0 and not known to
    full precision (its Al != 0), clamped below 1 << Al; with no AC scan
    at all (DC interpolation), the DC too. The neighbourhood follows
    `smoothing_rows` and `smoothing_cols` of libjpeg-turbo `turbo`."""
    q = qt.reshape(64).astype(np.int64)
    dc_all = coef[..., 0].astype(np.int64)
    rows = smoothing_rows(bh, v, imcu_rows, turbo)              # (bh, 5)
    cols = smoothing_cols(bw, turbo)                            # (bw, 5)
    dcs = dc_all[rows[:, :, None, None], cols[None, None, :, :]]  # (bh, 5, bw, 5)
    dcs = dcs.transpose(0, 2, 1, 3)                             # (bh, bw, 5, 5)
    out = coef[:bh, :bw].astype(np.int64).copy()
    change_dc = all(b == -1 for b in bits[1:10])
    for zz, pos, k_dc, k_ac in _SMOOTH:
        kernel = k_dc if change_dc else k_ac
        al = bits[zz]
        if kernel is None or al == 0:
            continue
        num = q[0] * np.einsum("ijrc,rc->ij", dcs, np.array(kernel, np.int64))
        qk = int(q[pos])
        pred = ((qk << 7) + np.abs(num)) // (qk << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num >= 0, pred, -pred)
        out[..., pos] = np.where(out[..., pos] == 0, pred, out[..., pos])
    if change_dc:
        num = q[0] * np.einsum("ijrc,rc->ij", dcs, np.array(_K["dc"], np.int64))
        pred = ((q[0] << 7) + np.abs(num)) // (q[0] << 8)
        out[..., 0] = np.where(num >= 0, pred, -pred)
    return out


def _plane(coef: np.ndarray, table: np.ndarray, idct: str) -> torch.Tensor:
    """Quantized (bh, bw, 64) -> samples (1, 8 bh, 8 bw), int32."""
    bh, bw, _ = coef.shape
    blocks = torch.from_numpy(np.ascontiguousarray(coef, np.int64)).reshape(1, bh, bw, 8, 8)
    if idct == "islow":
        return J.from_blocks(J.inverse_dct_islow(
            blocks * torch.from_numpy(J.islow_multipliers(table))))
    # jddctmgr.c keeps the IFAST multiplier in a short (a 16-bit DQT can wrap)
    mult = J.ifast_multipliers(table).astype(np.int16).astype(np.int32)
    return J.from_blocks(J.inverse_dct(blocks.to(torch.int32) * torch.from_numpy(mult)))


def colour_space(p: Dict) -> str:
    """jdapimin.c default_decompress_parms: the stream's colour space.
    3 components: a JFIF marker says YCbCr; else an Adobe marker's
    transform (0 RGB, else YCbCr); else the component ids (1, 2, 3 YCbCr;
    'R', 'G', 'B' RGB; else YCbCr). 4: Adobe transform 0 CMYK, any other
    YCCK, no Adobe marker CMYK."""
    nc, adobe = len(p["comps"]), p["adobe_transform"]
    if nc == 1:
        return "grey"
    if nc == 3:
        if p["jfif"]:
            return "ycbcr"
        if adobe >= 0:
            return "rgb" if adobe == 0 else "ycbcr"
        ids = tuple(c["id"] for c in p["comps"])
        return "rgb" if ids == (82, 71, 66) else "ycbcr"
    if adobe >= 0:
        return "cmyk" if adobe == 0 else "ycck"
    return "cmyk"


def decode_jpeg_plain(data: bytes, idct: str = "ifast") -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3) RGB: the byte stream in Python, the
    sample stages in `processing/jpeg.py`'s torch integer ops; `idct` as
    `decode_jpeg`'s (and with it, for CMYK, TF's or PIL's conversion to
    RGB)."""
    _check_idct(idct)
    p = _parse(bytes(data))
    h, w = p["size"]
    smooth = _smoothing_ok(p)
    planes = []
    for c in p["comps"]:
        if c["qt"] is None:
            raise ValueError("JPEG decode failed: a component has no scan")
        coef = np.array(c["blocks"], np.int64).reshape(-1, c["cols"], 64)
        if smooth:
            coef = smooth_blocks(coef, c["bits"], c["qt"], c["bh"], c["bw"], c["v"],
                                 p["imcu_rows"], "3" if idct == "islow" else "2.1")
        else:
            coef = coef[:c["bh"], :c["bw"]]
        plane = _plane(coef, c["qt"], idct)[:, :c["height"], :c["width"]]
        planes.append(J.upsample(plane, c["h"], c["v"], p["hmax"], p["vmax"])[0, :h, :w])
    space = colour_space(p)
    if space == "grey":
        return planes[0][..., None].expand(h, w, 3).to(torch.uint8).numpy().copy()
    x = torch.stack(planes, -1)
    if space == "rgb":
        rgb = x
    elif space == "ycbcr":
        rgb = J.ycbcr_to_rgb(x)
    else:
        cmyk = J.ycck_to_cmyk(x) if space == "ycck" else x
        rgb = (J.cmyk_to_rgb_pil(cmyk) if idct == "islow"
               else J.cmyk_to_rgb_tf(cmyk, p["adobe_transform"] >= 0))
    return rgb.to(torch.uint8).numpy()
