"""The baseline JPEG round trip of libjpeg(-turbo) under TF's settings, in torch.

`tf.io.decode_image(tf.io.encode_jpeg(x, quality=q))` on an RGB frame is
libjpeg's baseline codec with 4:2:0 chroma, the ISLOW forward DCT, the IJG
standard tables scaled by `q`, the IFAST inverse DCT (`JDCT_IFAST`, TF's
decode default) and fancy upsampling. Entropy coding is lossless, so the
round trip is the integer pipeline below with no bitstream. Every stage is
a plain function over a batch, vectorised over every 8 x 8 block, on the
frames' own device; each cites the libjpeg source it follows:

    rgb_to_ycbcr       jccolor.c   rgb_ycc_convert
    pad_edge,          jcsample.c  expand_right_edge, h2v2_downsample;
    downsample_h2v2    jcprepct.c  expand_bottom_edge
    forward_dct        jfdctint.c  jpeg_fdct_islow (jcdctmgr.c: samples - 128)
    quant_table        jcparam.c   jpeg_quality_scaling, jpeg_add_quant_table
    quantize           jcdctmgr.c  quantize (divisor 8 q, rounded)
    dequantize         jddctmgr.c  the IFAST multipliers
    inverse_dct        jidctfst.c  jpeg_idct_ifast
    inverse_dct_islow  jidctint.c  jpeg_idct_islow (PIL's decode; the JPEG
                                   decoder's `idct="islow"`, not the round trip)
    upsample_h2v2      jdsample.c  h2v2_fancy_upsample, h2v2_upsample
    upsample_h2v1,     jdsample.c  h2v1_fancy_upsample, h2v1_upsample,
    upsample_h1v2,                 h1v2_fancy_upsample, int_upsample, and
    int_upsample,                  jinit_upsampler's choice among them
    upsample                       (the JPEG decoder's other samplings)
    ycbcr_to_rgb       jdcolor.c   ycc_rgb_convert
    ycck_to_cmyk       jdcolor.c   ycck_cmyk_convert
    cmyk_to_rgb_pil    PIL         `CMYK;I` unpacking, Convert.c cmyk2rgb
    cmyk_to_rgb_tf     TF          jpeg_mem.cc's CMYK -> RGB

Where the libraries differ: TF's and PIL's encoders write the same
coefficients at a given quality; their decoders differ. TF decodes with the
IFAST inverse DCT, PIL with ISLOW, and the two disagree by up to 5 levels on
most pixels of a random frame. This module is TF's.

Integer width: int32 everywhere. The widest values are in the forward DCT's
second pass: its inputs are the first pass's outputs, |v| <= 2^12 (an 8-point
DCT of samples in [-128, 127], scaled by sqrt(8) and 2^2), so its sums of two
to four inputs stay below 2^15 and its sums of three products by constants
below 25,172 stay below 1.2e9 < 2^31. Every other stage is smaller. Right
shifts of negative values are arithmetic (floor), as `>>` is on torch
integers and in libjpeg's RIGHT_SHIFT.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_I32 = torch.int32

# jcparam.c: the IJG standard tables (JPEG spec, Annex K), natural order.
STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64).reshape(8, 8)
STD_CHROMINANCE = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    *[99] * 32], np.int64).reshape(8, 8)

# jutils.c jpeg_natural_order: the natural-order index of zig-zag entry k.
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# jddctmgr.c: the AA&N scale factors of the IFAST multipliers, scaled by 2^14.
AANSCALES = np.array([
    16384, 22725, 21407, 19266, 16384, 12873, 8867, 4520,
    22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,
    19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867, 4520,
    12873, 17855, 16819, 15137, 12873, 10114, 6967, 3552,
    8867, 12299, 11585, 10426, 8867, 6967, 4799, 2446,
    4520, 6270, 5906, 5315, 4520, 3552, 2446, 1247], np.int64).reshape(8, 8)


def _fix(x: float) -> int:
    """jccolor.c / jdcolor.c FIX(x) at SCALEBITS = 16."""
    return int(x * 65536 + 0.5)


_HALF = 1 << 15
_CBCR_OFFSET = 128 << 16


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """jccolor.c rgb_ycc_convert: int32 (..., 3) RGB -> int32 (..., 3)
    YCbCr. Cb and Cr round with 0.5 - epsilon, so 255 stays 255."""
    r, g, b = rgb.unbind(-1)
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + _HALF) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + _CBCR_OFFSET + _HALF - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + _CBCR_OFFSET + _HALF - 1) >> 16
    return torch.stack([y, cb, cr], -1)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    """jdcolor.c ycc_rgb_convert: int32 (..., 3) YCbCr -> int32 (..., 3) RGB
    in [0, 255] (the range-limit table clamps)."""
    y, cb, cr = ycc.unbind(-1)
    cb, cr = cb - 128, cr - 128
    r = y + ((_fix(1.40200) * cr + _HALF) >> 16)
    g = y + ((-_fix(0.34414) * cb + _HALF - _fix(0.71414) * cr) >> 16)
    b = y + ((_fix(1.77200) * cb + _HALF) >> 16)
    return torch.stack([r, g, b], -1).clamp_(0, 255)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def pad_edge(plane: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, h, w) -> (N, height, width), the last row and column replicated
    (jcsample.c expand_right_edge, jcprepct.c expand_bottom_edge)."""
    _, h, w = plane.shape
    if height > h:
        plane = torch.cat([plane, plane[:, -1:].expand(-1, height - h, -1)], 1)
    if width > w:
        plane = torch.cat([plane, plane[:, :, -1:].expand(-1, -1, width - w)], 2)
    return plane


def downsample_h2v2(plane: torch.Tensor) -> torch.Tensor:
    """jcsample.c h2v2_downsample with jcprepct.c's padding: full-size
    chroma (N, H, W) -> (N, 8 ceil(ceil(H/2)/8), 8 ceil(ceil(W/2)/8)).

    The rows are replicated to an even count and the columns to 16 per
    output block; each output is the 2 x 2 sum plus a bias of 1, 2, 1, 2...
    along the row, >> 2; the subsampled rows are then replicated to a
    multiple of 8 (the iMCU's dummy rows)."""
    _, h, w = plane.shape
    out_w = 8 * _ceil(_ceil(w, 2), 8)
    p = pad_edge(plane, 2 * _ceil(h, 2), 2 * out_w)
    s = p[:, 0::2, 0::2] + p[:, 0::2, 1::2] + p[:, 1::2, 0::2] + p[:, 1::2, 1::2]
    bias = torch.arange(out_w, device=plane.device, dtype=_I32) % 2 + 1
    s = (s + bias) >> 2
    return pad_edge(s, 8 * _ceil(s.shape[1], 8), out_w)


def to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(N, 8a, 8b) -> (N, a, b, 8, 8)."""
    n, h, w = plane.shape
    return plane.reshape(n, h // 8, 8, w // 8, 8).transpose(2, 3)


def from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(N, a, b, 8, 8) -> (N, 8a, 8b)."""
    n, a, b = blocks.shape[:3]
    return blocks.transpose(2, 3).reshape(n, 8 * a, 8 * b)


# jfdctint.c (8-bit samples): CONST_BITS 13, PASS1_BITS 2, FIX_* at 2^13.
_FDCT_CONST_BITS, _PASS1_BITS = 13, 2


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """jdct.h DESCALE: a right shift that rounds half up."""
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d: torch.Tensor, first_pass: bool) -> torch.Tensor:
    """One pass of jpeg_fdct_islow along the last axis (LL&M)."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d.unbind(-1)
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if first_pass:
        out0 = (tmp10 + tmp11) << _PASS1_BITS
        out4 = (tmp10 - tmp11) << _PASS1_BITS
        n = _FDCT_CONST_BITS - _PASS1_BITS
    else:
        out0 = _descale(tmp10 + tmp11, _PASS1_BITS)
        out4 = _descale(tmp10 - tmp11, _PASS1_BITS)
        n = _FDCT_CONST_BITS + _PASS1_BITS
    z1 = (tmp12 + tmp13) * 4433                               # FIX_0_541196100
    out2 = _descale(z1 + tmp13 * 6270, n)                     # FIX_0_765366865
    out6 = _descale(z1 + tmp12 * -15137, n)                   # FIX_1_847759065
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633                                     # FIX_1_175875602
    tmp4 = tmp4 * 2446                                        # FIX_0_298631336
    tmp5 = tmp5 * 16819                                       # FIX_2_053119869
    tmp6 = tmp6 * 25172                                       # FIX_3_072711026
    tmp7 = tmp7 * 12299                                       # FIX_1_501321110
    z1 = z1 * -7373                                           # FIX_0_899976223
    z2 = z2 * -20995                                          # FIX_2_562915447
    z3 = z3 * -16069 + z5                                     # FIX_1_961570560
    z4 = z4 * -3196 + z5                                      # FIX_0_390180644
    out7 = _descale(tmp4 + z1 + z3, n)
    out5 = _descale(tmp5 + z2 + z4, n)
    out3 = _descale(tmp6 + z2 + z3, n)
    out1 = _descale(tmp7 + z1 + z4, n)
    return torch.stack([out0, out1, out2, out3, out4, out5, out6, out7], -1)


def forward_dct(blocks: torch.Tensor) -> torch.Tensor:
    """jcdctmgr.c + jfdctint.c: int32 samples (..., 8, 8) in [0, 255] ->
    the ISLOW DCT of samples - 128, rows then columns, scaled by 8;
    [..., u, v] is vertical frequency u, horizontal v."""
    x = _fdct_1d(blocks - 128, first_pass=True)
    return _fdct_1d(x.transpose(-1, -2), first_pass=False).transpose(-1, -2)


@functools.lru_cache(maxsize=16)
def quant_table(quality: int, chroma: bool) -> np.ndarray:
    """jcparam.c: the standard table scaled by jpeg_quality_scaling(quality)
    (5000 / q below 50, else 200 - 2q), each entry (t s + 50) // 100
    clipped to [1, 255] (baseline). int64 (8, 8), natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    base = STD_CHROMINANCE if chroma else STD_LUMINANCE
    table = np.clip((base * scale + 50) // 100, 1, 255)
    table.flags.writeable = False
    return table


def quantize(coef: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """jcdctmgr.c quantize: divisor d = 8 q (the DCT's scale folded in),
    sign(c) ((|c| + d // 2) // d). libjpeg-turbo's reciprocal form gives
    the same quotient for every |c| < 2^15 and d = 8 q, q in [1, 255]."""
    d = torch.as_tensor(8 * table, dtype=_I32, device=coef.device)
    q = (coef.abs() + d // 2) // d
    return torch.where(coef < 0, -q, q)


def _ifast_mul(v: torch.Tensor, c: int) -> torch.Tensor:
    """jidctfst.c MULTIPLY at CONST_BITS 8: DESCALE is a bare right shift."""
    return (v * c) >> 8


def _idct_1d(t: torch.Tensor) -> torch.Tensor:
    """One pass of jpeg_idct_ifast along the last axis (AA&N)."""
    c0, c1, c2, c3, c4, c5, c6, c7 = t.unbind(-1)
    tmp10, tmp11 = c0 + c4, c0 - c4                           # even part
    tmp13 = c2 + c6
    tmp12 = _ifast_mul(c2 - c6, 362) - tmp13                  # FIX_1_414213562
    tmp0, tmp3 = tmp10 + tmp13, tmp10 - tmp13
    tmp1, tmp2 = tmp11 + tmp12, tmp11 - tmp12
    z13, z10 = c5 + c3, c5 - c3                               # odd part
    z11, z12 = c1 + c7, c1 - c7
    tmp7 = z11 + z13
    tmp11 = _ifast_mul(z11 - z13, 362)                        # FIX_1_414213562
    z5 = _ifast_mul(z10 + z12, 473)                           # FIX_1_847759065
    tmp10 = _ifast_mul(z12, 277) - z5                         # FIX_1_082392200
    tmp12 = _ifast_mul(z10, -669) + z5                        # FIX_2_613125930
    tmp6 = tmp12 - tmp7
    tmp5 = tmp11 - tmp6
    tmp4 = tmp10 + tmp5
    return torch.stack([tmp0 + tmp7, tmp1 + tmp6, tmp2 + tmp5, tmp3 - tmp4,
                        tmp3 + tmp4, tmp2 - tmp5, tmp1 - tmp6, tmp0 - tmp7], -1)


def ifast_multipliers(table: np.ndarray) -> np.ndarray:
    """jddctmgr.c (JDCT_IFAST): (q aanscales + 2^11) >> 12, the
    dequantization multipliers at IFAST_SCALE_BITS 2."""
    return (table * AANSCALES + (1 << 11)) >> 12


def dequantize(qcoef: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """jddctmgr.c (JDCT_IFAST): quantized int32 (..., 8, 8) times the IFAST
    multipliers of `table`."""
    return qcoef * torch.as_tensor(ifast_multipliers(table), dtype=_I32, device=qcoef.device)


def inverse_dct(coef: torch.Tensor) -> torch.Tensor:
    """jidctfst.c: dequantized int32 (..., 8, 8) -> samples in [0, 255]:
    columns then rows, then (x >> 5) + 128 clamped (PASS1_BITS + 3; the
    SIMD decoder saturates, the C range-limit table agrees for
    |x >> 5| <= 512)."""
    x = _idct_1d(_idct_1d(coef.transpose(-1, -2)).transpose(-1, -2))
    return ((x >> (_PASS1_BITS + 3)) + 128).clamp_(0, 255)


def _islow_1d(t: torch.Tensor, n: int) -> torch.Tensor:
    """One pass of jpeg_idct_islow along the last axis (LL&M), each output
    DESCALEd by n bits."""
    c0, c1, c2, c3, c4, c5, c6, c7 = t.unbind(-1)
    z1 = (c2 + c6) * 4433                                     # FIX_0_541196100
    tmp2 = z1 + c6 * -15137                                   # FIX_1_847759065
    tmp3 = z1 + c2 * 6270                                     # FIX_0_765366865
    tmp0 = (c0 + c4) << _FDCT_CONST_BITS
    tmp1 = (c0 - c4) << _FDCT_CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = c7, c5, c3, c1                   # odd part
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * 9633                                     # FIX_1_175875602
    tmp0 = tmp0 * 2446                                        # FIX_0_298631336
    tmp1 = tmp1 * 16819                                       # FIX_2_053119869
    tmp2 = tmp2 * 25172                                       # FIX_3_072711026
    tmp3 = tmp3 * 12299                                       # FIX_1_501321110
    z1 = z1 * -7373                                           # FIX_0_899976223
    z2 = z2 * -20995                                          # FIX_2_562915447
    z3 = z3 * -16069 + z5                                     # FIX_1_961570560
    z4 = z4 * -3196 + z5                                      # FIX_0_390180644
    tmp0, tmp1 = tmp0 + z1 + z3, tmp1 + z2 + z4
    tmp2, tmp3 = tmp2 + z2 + z3, tmp3 + z1 + z4
    return torch.stack([_descale(v, n) for v in (
        tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
        tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)], -1)


def islow_multipliers(table: np.ndarray) -> np.ndarray:
    """jddctmgr.c (JDCT_ISLOW): the table itself, kept in an
    ISLOW_MULT_TYPE (short: a 16-bit DQT entry above 32767 wraps)."""
    return np.asarray(table).astype(np.int16).astype(np.int64)


def inverse_dct_islow(coef: torch.Tensor) -> torch.Tensor:
    """jidctint.c: dequantized (..., 8, 8) -> samples in [0, 255], int32:
    columns then rows in int64 (libjpeg's JLONG), the first pass DESCALEd
    by CONST_BITS - PASS1_BITS, the second by CONST_BITS + PASS1_BITS + 3,
    then + 128 clamped (the SIMD decoder saturates; the C range-limit
    table agrees for in-range data). The shortcuts for all-zero AC
    columns and rows give the same values, so they are not taken."""
    x = coef.to(torch.int64)
    x = _islow_1d(x.transpose(-1, -2), _FDCT_CONST_BITS - _PASS1_BITS).transpose(-1, -2)
    x = _islow_1d(x, _FDCT_CONST_BITS + _PASS1_BITS + 3)
    return (x + 128).clamp_(0, 255).to(_I32)


def upsample_h2v2(plane: torch.Tensor) -> torch.Tensor:
    """jdsample.c: decoded chroma (N, h, w) at its real size (ceil(H/2),
    ceil(W/2)) -> (N, 2h, 2w).

    w > 2 (jinit_upsampler's do_fancy rule): h2v2_fancy_upsample, a
    triangle filter. Each output row's column sums are 3 x its nearest
    input row + the next nearest (the row above for even output rows, below
    for odd; the edge rows replicated); then along the row
    (3 this + left + 8) >> 4 and (3 this + right + 7) >> 4, the edge
    columns replicated, which gives the first and last outputs' (4 this +
    8) >> 4 and (4 this + 7) >> 4. Otherwise h2v2_upsample: each sample
    replicated 2 x 2."""
    n, h, w = plane.shape
    if w <= 2:
        return plane.repeat_interleave(2, 1).repeat_interleave(2, 2)
    up = torch.cat([plane[:, :1], plane[:, :-1]], 1)
    down = torch.cat([plane[:, 1:], plane[:, -1:]], 1)
    cols = torch.stack([3 * plane + up, 3 * plane + down], 2).reshape(n, 2 * h, w)
    left = torch.cat([cols[:, :, :1], cols[:, :, :-1]], 2)
    right = torch.cat([cols[:, :, 1:], cols[:, :, -1:]], 2)
    even = (3 * cols + left + 8) >> 4
    odd = (3 * cols + right + 7) >> 4
    return torch.stack([even, odd], 3).reshape(n, 2 * h, 2 * w)



def upsample_h2v1(plane: torch.Tensor) -> torch.Tensor:
    """jdsample.c: (N, h, w) -> (N, h, 2w). w > 2: h2v1_fancy_upsample,
    (3 this + left + 1) >> 2 and (3 this + right + 2) >> 2 along the row,
    the edge columns replicated (so the first and last outputs are the
    samples themselves). Otherwise h2v1_upsample: each sample twice."""
    n, h, w = plane.shape
    if w <= 2:
        return plane.repeat_interleave(2, 2)
    left = torch.cat([plane[:, :, :1], plane[:, :, :-1]], 2)
    right = torch.cat([plane[:, :, 1:], plane[:, :, -1:]], 2)
    even = (3 * plane + left + 1) >> 2
    odd = (3 * plane + right + 2) >> 2
    return torch.stack([even, odd], 3).reshape(n, h, 2 * w)


def upsample_h1v2(plane: torch.Tensor) -> torch.Tensor:
    """jdsample.c h1v2_fancy_upsample: (N, h, w) -> (N, 2h, w), each output
    row (3 nearest + next nearest + bias) >> 2, the next nearest the row
    above (bias 1) for even output rows and below (bias 2) for odd; the
    edge rows replicated (jdmainct.c's context rows). libjpeg takes it at
    every width."""
    n, h, w = plane.shape
    up = torch.cat([plane[:, :1], plane[:, :-1]], 1)
    down = torch.cat([plane[:, 1:], plane[:, -1:]], 1)
    even = (3 * plane + up + 1) >> 2
    odd = (3 * plane + down + 2) >> 2
    return torch.stack([even, odd], 2).reshape(n, 2 * h, w)


def int_upsample(plane: torch.Tensor, h_expand: int, v_expand: int) -> torch.Tensor:
    """jdsample.c int_upsample (and h2v1_upsample, h2v2_upsample): each
    sample replicated h_expand x v_expand."""
    return plane.repeat_interleave(v_expand, 1).repeat_interleave(h_expand, 2)


def upsample(plane: torch.Tensor, h_in: int, v_in: int, h_out: int, v_out: int) -> torch.Tensor:
    """jdsample.c jinit_upsampler's choice for one component with fancy
    upsampling on (libjpeg's default, PIL's and TF's): a decoded plane
    (N, h, w) at its real size, sampled h_in x v_in of the frame's
    h_out x v_out -> (N, h v_out / v_in, w h_out / h_in). Equal factors
    pass through; 2:1 across is h2v1 (fancy above 2 columns), 1:2 down
    h1v2 (fancy), 2:1 both ways h2v2 (fancy above 2 columns); any other
    integral ratio int_upsample. A fractional ratio raises, as libjpeg
    does (JERR_FRACT_SAMPLE_NOTIMPL)."""
    if (h_in, v_in) == (h_out, v_out):
        return plane
    if h_in * 2 == h_out and v_in == v_out:
        return upsample_h2v1(plane)
    if h_in == h_out and v_in * 2 == v_out:
        return upsample_h1v2(plane)
    if h_in * 2 == h_out and v_in * 2 == v_out:
        return upsample_h2v2(plane)
    if h_out % h_in or v_out % v_in:
        raise ValueError(f"JPEG decode failed: unsupported JPEG sampling: fractional "
                         f"upsampling {h_in}x{v_in} of {h_out}x{v_out}")
    return int_upsample(plane, h_out // h_in, v_out // v_in)


def ycck_to_cmyk(ycck: torch.Tensor) -> torch.Tensor:
    """jdcolor.c ycck_cmyk_convert: int32 (..., 4) YCCK -> CMYK, each of C,
    M, Y 255 minus ycc_rgb_convert's clamped R, G, B; K passes through."""
    rgb = ycbcr_to_rgb(ycck[..., :3])
    return torch.cat([255 - rgb, ycck[..., 3:]], -1)


def cmyk_to_rgb_pil(cmyk: torch.Tensor) -> torch.Tensor:
    """PIL: the CMYK samples libjpeg hands back, read as `CMYK;I` (Adobe's
    inverted polarity: each byte 255 - v) and then `convert("RGB")`
    (Convert.c cmyk2rgb: nk = 255 - K, each channel nk - MULDIV255(C, nk),
    MULDIV255(a, b) = ((t >> 8) + t) >> 8 with t = a b + 128). int32
    (..., 4) -> (..., 3)."""
    inv = 255 - cmyk
    nk = 255 - inv[..., 3:]
    t = inv[..., :3] * nk + 128
    return (nk - (((t >> 8) + t) >> 8)).clamp_(0, 255)


def cmyk_to_rgb_tf(cmyk: torch.Tensor, adobe: bool) -> torch.Tensor:
    """`tf.io.decode_jpeg(..., channels=3)` on a 4-component file
    (jpeg/jpeg_mem.cc): libjpeg's CMYK, then each channel K C / 255 where
    the file has an Adobe marker (inverted polarity), else
    (255 - K)(255 - C) / 255, in integer division. int32 (..., 4) ->
    (..., 3)."""
    c, k = cmyk[..., :3], cmyk[..., 3:]
    if adobe:
        return (k * c) // 255
    return ((255 - k) * (255 - c)) // 255

def jpeg_roundtrip(frames: torch.Tensor, quality: int = 95) -> torch.Tensor:
    """uint8 (N, H, W, 3) RGB -> uint8 (N, H, W, 3): what
    `tf.io.decode_image(tf.io.encode_jpeg(frame, quality=quality))` gives
    for each frame (baseline, 4:2:0, ISLOW forward, IFAST inverse, fancy
    upsampling), on the frames' device. Bit for bit the same on every
    device: each stage is integer arithmetic."""
    if frames.dtype != torch.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected uint8 (N, H, W, 3) frames, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    n, h, w, _ = frames.shape
    ycc = rgb_to_ycbcr(frames.to(_I32))
    luma = to_blocks(pad_edge(ycc[..., 0], 8 * _ceil(h, 8), 8 * _ceil(w, 8)))
    # Cb and Cr share a table and a geometry: one batch of 2N planes.
    chroma = to_blocks(downsample_h2v2(ycc[..., 1:].permute(3, 0, 1, 2).reshape(2 * n, h, w)))
    # Every block of the batch through one forward and one inverse DCT.
    n_luma = luma.numel() // 64
    coef = forward_dct(torch.cat([luma.reshape(-1, 8, 8), chroma.reshape(-1, 8, 8)]))
    coef = torch.cat([dequantize(quantize(part, table), table) for part, table in (
        (coef[:n_luma], quant_table(quality, chroma=False)),
        (coef[n_luma:], quant_table(quality, chroma=True)))])
    samples = inverse_dct(coef)
    y = from_blocks(samples[:n_luma].reshape(luma.shape))[:, :h, :w]
    chroma = from_blocks(samples[n_luma:].reshape(chroma.shape))
    chroma = upsample_h2v2(chroma[:, :_ceil(h, 2), :_ceil(w, 2)])[:, :h, :w]
    return ycbcr_to_rgb(torch.stack([y, chroma[:n], chroma[n:]], -1)).to(torch.uint8)
