"""Baseline JPEG encoding that writes PIL's bytes, without PIL.

`encode_jpeg(frame, quality)` returns what
`PIL.Image.fromarray(frame).save(buf, "JPEG", quality=quality)` writes
(libjpeg-turbo under PIL's defaults), byte for byte:

    SOI, the JFIF APP0 as libjpeg writes it (version 1.01, no units,
    density 1 x 1, no thumbnail);
    one DQT marker a table, in the order the components use them
    (jcmarker.c emit_dqt), 8-bit, zig-zag order, the tables of
    `jpeg_set_quality(q, force_baseline=TRUE)` (`processing/jpeg.py`
    quant_table);
    SOF0: components 1, 2, 3 at 2x2, 1x1, 1x1 with tables 0, 1, 1 (RGB,
    4:2:0), or component 1 at 1x1 (a grey (H, W) frame);
    one DHT marker a table, each component's DC then AC table, in
    component order, each once (jcmarker.c write_scan_header), holding
    libjpeg's standard tables (jstdhuff.c);
    one interleaved baseline scan: jccoefct.c's dummy blocks at the right
    and bottom edges of the MCU grid (AC zero, DC the block before), DC
    differences and AC runs coded by jchuff.c encode_one_block, 0xFF
    stuffed with 0x00, the last byte padded with 1 bits; then EOI.

The sample stages are `processing/jpeg.py`'s (rgb_to_ycbcr, pad_edge,
downsample_h2v2, forward_dct, quantize). Two coders:

  encode_jpeg        the host library's (`hostsrc/jpeg_encode.cc`, built by
                     `_host_build.py`): what the data scripts call.
  encode_jpeg_plain  the plain version: the torch stages, then the entropy
                     coder in Python. Tests hold the host library to it and
                     to PIL.

`encode_planes_plain` is the plain writer under both: any components at
any sampling factors, tables and APPn markers. Tests build with it streams
PIL cannot write (4:1:1, 4:4:0, YCCK, Adobe RGB) for the decoders.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from openvla_oft_tpu_torch.processing import jpeg as J

_ERR_LEN = 256

# jstdhuff.c std_huff_tables: (class, id) -> (the 16 code-length counts,
# the symbols). Class 0 DC, 1 AC; id 0 luminance, 1 chrominance.
STD_HUFFMAN: Dict[Tuple[int, int], Tuple[bytes, bytes]] = {
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
        "535455565758595a636465666768696a737475767778797a838485868788898a"
        "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
        "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119]), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}

# jcmarker.c write_file_header: JFIF 1.01, density unit 0, 1 x 1, no thumbnail.
JFIF_APP0 = bytes.fromhex("ffe000104a46494600010100000100010000")


def adobe_app14(transform: int) -> bytes:
    """jcmarker.c emit_adobe_app14: version 100, flags 0, the transform
    (0 RGB or CMYK, 1 YCbCr, 2 YCCK)."""
    return bytes.fromhex("ffee000e41646f6265006400000000") + bytes([transform])


def _check(rc: int, err) -> None:
    if rc != 0:
        raise ValueError(f"JPEG encode failed: {err.value.decode(errors='replace')}")


def _check_frame(frame: np.ndarray, quality: int) -> np.ndarray:
    frame = np.ascontiguousarray(frame)
    if frame.dtype != np.uint8 or not (
            frame.ndim == 2 or (frame.ndim == 3 and frame.shape[2] == 3)):
        raise ValueError(f"expected a uint8 (H, W, 3) or (H, W) frame, got {frame.dtype} "
                         f"{frame.shape}")
    if frame.shape[0] == 0 or frame.shape[1] == 0 or max(frame.shape[:2]) > 65535:
        raise ValueError(f"JPEG frame size {frame.shape[:2]} out of range")
    if not 1 <= int(quality) <= 100:
        raise ValueError(f"JPEG quality {quality} not in [1, 100]")
    return frame


def encode_jpeg(frame: np.ndarray, quality: int = 75) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W) grey -> PIL's JPEG bytes at `quality`,
    by the host library."""
    from openvla_oft_tpu_torch._host_build import library

    frame = _check_frame(frame, quality)
    h, w = frame.shape[:2]
    channels = 1 if frame.ndim == 2 else 3
    lib = library()
    cap = lib.openvla_jpeg_encode_bound(h, w)
    out = np.empty(cap, np.uint8)
    n = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(lib.openvla_jpeg_encode(frame.ctypes.data, h, w, channels, int(quality),
                                   out.ctypes.data, cap, ctypes.byref(n), err, _ERR_LEN), err)
    return out[:n.value].tobytes()


# === The plain version ===
class _BitWriter:
    """jchuff.c emit_bits / flush_bits: MSB first, 0xFF stuffed with 0x00,
    the last partial byte padded with 1 bits."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, size: int) -> None:
        self.acc = (self.acc << size) | (code & ((1 << size) - 1))
        self.n += size
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put(0x7F, 8 - self.n)
        return bytes(self.out)


def _codes(counts: bytes, symbols: bytes) -> Dict[int, Tuple[int, int]]:
    """jchuff.c jpeg_make_c_derived_tbl: symbol -> (code, length)."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _encode_block(bw: _BitWriter, zz: Sequence[int], last_dc: int, dc, ac) -> None:
    """jchuff.c encode_one_block: one block's coefficients in zig-zag order."""
    diff = zz[0] - last_dc
    mag = -diff if diff < 0 else diff
    nbits = mag.bit_length()
    bw.put(*dc[nbits])
    if nbits:
        bw.put(diff - 1 if diff < 0 else diff, nbits)
    run = 0
    for k in range(1, 64):
        v = zz[k]
        if v == 0:
            run += 1
            continue
        while run > 15:
            bw.put(*ac[0xF0])
            run -= 16
        mag = -v if v < 0 else v
        nbits = mag.bit_length()
        bw.put(*ac[(run << 4) + nbits])
        bw.put(v - 1 if v < 0 else v, nbits)
        run = 0
    if run:
        bw.put(*ac[0x00])


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def quantized_blocks(plane: torch.Tensor, table: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """An int32 sample plane of at least (8 bh, 8 bw) -> its (bh, bw)
    blocks' quantized ISLOW coefficients, int64 (bh, bw, 64) in zig-zag
    order (jcdctmgr.c forward_DCT: samples - 128, jpeg_fdct_islow,
    quantize)."""
    blocks = J.to_blocks(plane[None, :8 * bh, :8 * bw].to(torch.int32))
    coef = J.quantize(J.forward_dct(blocks), table)
    return coef.reshape(bh, bw, 64).numpy().astype(np.int64)[..., J.NATURAL_ORDER]


def encode_planes_plain(planes: Sequence[torch.Tensor], size: Tuple[int, int],
                        factors: Sequence[Tuple[int, int]],
                        tables: Dict[int, np.ndarray], table_of: Sequence[int],
                        huffman_of: Sequence[int], ids: Sequence[int],
                        app: bytes = JFIF_APP0) -> bytes:
    """A baseline stream of any components: `planes[c]` int samples of
    component c at its sampled size, already padded (at least) to its
    blocks, 8 ceil(ceil(H v / vmax) / 8) x 8 ceil(ceil(W h / hmax) / 8);
    `size` the image's (H, W); `factors[c]` its (h, v); `tables` the
    quantization tables by id ((8, 8) natural order, entries <= 255),
    `table_of[c]` and `huffman_of[c]` (0 or 1, the standard tables) the
    component's; `ids` the component ids; `app` the markers after SOI.
    One interleaved scan (one component: its blocks alone), with
    jccoefct.c's dummy blocks."""
    height, width = size
    nc = len(planes)
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    comps = []
    for c in range(nc):
        h, v = factors[c]
        cw, ch = -(-width * h // hmax), -(-height * v // vmax)
        bw, bh = -(-cw // 8), -(-ch // 8)
        comps.append({"h": h, "v": v, "bw": bw, "bh": bh,
                      "coef": quantized_blocks(planes[c], tables[table_of[c]], bh, bw).tolist(),
                      "dc": _codes(*STD_HUFFMAN[(0, huffman_of[c])]),
                      "ac": _codes(*STD_HUFFMAN[(1, huffman_of[c])])})
    out = bytearray(b"\xff\xd8" + app)
    for t in dict.fromkeys(table_of):
        q = np.asarray(tables[t]).reshape(64)[J.NATURAL_ORDER]
        out += _segment(0xDB, bytes([t]) + bytes(int(x) for x in q))
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([nc])
    for c in range(nc):
        sof += bytes([ids[c], (factors[c][0] << 4) | factors[c][1], table_of[c]])
    out += _segment(0xC0, sof)
    sent = set()
    for c in range(nc):
        for cls in (0, 1):
            key = (cls, huffman_of[c])
            if key not in sent:
                sent.add(key)
                counts, symbols = STD_HUFFMAN[key]
                out += _segment(0xC4, bytes([(cls << 4) | key[1]]) + counts + symbols)
    sos = bytes([nc])
    for c in range(nc):
        sos += bytes([ids[c], (huffman_of[c] << 4) | huffman_of[c]])
    out += _segment(0xDA, sos + bytes([0, 63, 0]))
    bw = _BitWriter()
    last = [0] * nc
    zero = [0] * 64
    if nc == 1:
        c = comps[0]
        for row in c["coef"]:
            for blk in row:
                _encode_block(bw, blk, last[0], c["dc"], c["ac"])
                last[0] = blk[0]
    else:
        for my_i in range(my):
            for mx_i in range(mx):
                for ci, c in enumerate(comps):
                    h, v = c["h"], c["v"]
                    # jccoefct.c compress_data: the last MCU column's real
                    # blocks, the last MCU row's real block rows
                    cnt = h if mx_i < mx - 1 else (c["bw"] % h or h)
                    rows = v if my_i < my - 1 else (c["bh"] % v or v)
                    prev = None
                    for yi in range(v):
                        for xi in range(h):
                            if yi < rows and xi < cnt:
                                blk = c["coef"][my_i * v + yi][mx_i * h + xi]
                            else:  # a dummy block: AC zero, DC the block before
                                blk = [prev[0]] + zero[1:]
                            _encode_block(bw, blk, last[ci], c["dc"], c["ac"])
                            last[ci] = blk[0]
                            prev = blk
    out += bw.flush() + b"\xff\xd9"
    return bytes(out)


def encode_jpeg_plain(frame: np.ndarray, quality: int = 75) -> bytes:
    """`encode_jpeg`'s bytes by the plain version: the torch stages of
    `processing/jpeg.py`, then `encode_planes_plain`."""
    frame = _check_frame(frame, quality)
    h, w = frame.shape[:2]
    tables = {0: J.quant_table(quality, chroma=False), 1: J.quant_table(quality, chroma=True)}
    x = torch.from_numpy(frame).to(torch.int32)
    if frame.ndim == 2:
        plane = J.pad_edge(x[None], 8 * -(-h // 8), 8 * -(-w // 8))[0]
        return encode_planes_plain([plane], (h, w), [(1, 1)], tables, [0], [0], [1])
    ycc = J.rgb_to_ycbcr(x)
    luma = J.pad_edge(ycc[None, ..., 0], 8 * -(-h // 8), 8 * -(-w // 8))[0]
    chroma = J.downsample_h2v2(ycc[..., 1:].permute(2, 0, 1))
    return encode_planes_plain([luma, chroma[0], chroma[1]], (h, w), [(2, 2), (1, 1), (1, 1)],
                               tables, [0, 1, 1], [0, 1, 1], [1, 2, 3])
