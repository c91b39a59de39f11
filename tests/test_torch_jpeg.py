"""The port's JPEG round trip (`openvla_oft_tpu_torch/processing/jpeg.py`)
against TF's libjpeg, bit for bit, and each of its stages against a
straight transcription of its libjpeg formula.

- The codec against `tf.io.decode_image(tf.io.encode_jpeg(x, quality))`
  (what the reference's eval conditioning and the JAX package call), exactly:
  at quality 95 on odd sizes (1 x 1, 9 x 1, 2 x 3: chroma 1 or 2 wide, the
  plain-replication upsampler) and larger ones, with random, smooth,
  checkerboard, all-0 and all-255 content; batches of random sizes; a few
  frames at qualities 10, 50, 75 and 100.
- Each stage against numpy or scalar Python written from the libjpeg
  source it follows (jccolor.c, jcsample.c, jfdctint.c, jcparam.c,
  jcdctmgr.c, jidctfst.c, jdsample.c, jdcolor.c), exactly; and the int32
  width of the forward DCT against int64 on the blocks that maximize each
  coefficient.
- `tests/goldens/jpeg_tf_q95.npz`: frames and TF's round trips, which
  `chip_smoke.py` holds the codec to on the card. It is rebuilt with TF
  here and must be unchanged (`REGEN_GOLDENS=1` rewrites it), and the codec
  reproduces it without TF.
- On the card (`gpu`): CUDA bitwise equal to the CPU and to the goldens.

TF is imported inside the tests (`pytest.importorskip`): the port never
imports it.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_oft_tpu_torch.processing import jpeg as J

GOLDEN = Path(__file__).parent / "goldens" / "jpeg_tf_q95.npz"


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def tf_roundtrip(tf, frame: np.ndarray, quality: int = 95) -> np.ndarray:
    enc = tf.io.encode_jpeg(tf.constant(frame), quality=quality)
    return tf.io.decode_image(enc, expand_animations=False, dtype=tf.uint8).numpy()


def content(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    if kind == "random":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "smooth":
        return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                         (xx + 2 * yy) * 3 % 256], -1).astype(np.uint8)
    if kind == "checkerboard":
        return np.repeat((((yy + xx) % 2) * 255).astype(np.uint8)[..., None], 3, -1)
    return np.full((h, w, 3), {"zeros": 0, "full": 255}[kind], np.uint8)


def codec(frames: np.ndarray, quality: int = 95) -> np.ndarray:
    return J.jpeg_roundtrip(torch.from_numpy(frames), quality).numpy()


SIZES = [(1, 1), (9, 1), (2, 3), (17, 31), (37, 53), (64, 80), (120, 160)]
CONTENTS = ["random", "smooth", "checkerboard", "zeros", "full"]


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("kind", CONTENTS)
def test_roundtrip_matches_tf_at_q95(tf, hw, kind):
    frame = content(kind, *hw)
    np.testing.assert_array_equal(codec(frame[None])[0], tf_roundtrip(tf, frame))


def test_batches_of_random_sizes_match_tf(tf):
    rng = np.random.default_rng(1)
    for _ in range(4):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        frames = rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)
        got = codec(frames)
        for f, g in zip(frames, got):
            np.testing.assert_array_equal(g, tf_roundtrip(tf, f), err_msg=f"{h}x{w}")


@pytest.mark.parametrize("quality", [10, 50, 75, 100])
@pytest.mark.parametrize("kind,hw", [("random", (37, 53)), ("smooth", (64, 80)),
                                     ("checkerboard", (9, 1))])
def test_other_qualities_match_tf(tf, quality, kind, hw):
    frame = content(kind, *hw, seed=quality)
    np.testing.assert_array_equal(codec(frame[None], quality)[0],
                                  tf_roundtrip(tf, frame, quality))


def test_refuses_what_is_not_a_uint8_rgb_batch():
    for bad in (torch.zeros((1, 8, 8, 3), dtype=torch.int32),
                torch.zeros((8, 8, 3), dtype=torch.uint8),
                torch.zeros((1, 8, 8, 4), dtype=torch.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            J.jpeg_roundtrip(bad)


# === each stage against its libjpeg formula ===
def FIX(x):
    return int(x * 65536 + 0.5)


def test_rgb_to_ycbcr_is_jccolor(rng):
    rgb = rng.integers(0, 256, (500, 3)).astype(np.int64)
    rgb = np.concatenate([rgb, [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]]])
    r, g, b = rgb.T
    y = (FIX(0.299) * r + FIX(0.587) * g + FIX(0.114) * b + 32768) >> 16
    cb = (-FIX(0.16874) * r - FIX(0.33126) * g + FIX(0.5) * b + (128 << 16) + 32767) >> 16
    cr = (FIX(0.5) * r - FIX(0.41869) * g - FIX(0.08131) * b + (128 << 16) + 32767) >> 16
    got = J.rgb_to_ycbcr(torch.from_numpy(rgb).int()).numpy()
    np.testing.assert_array_equal(got, np.stack([y, cb, cr], -1))
    assert got.min() >= 0 and got.max() <= 255


def test_ycbcr_to_rgb_is_jdcolor(rng):
    cb, cr = np.meshgrid(np.arange(256), np.arange(256))           # every chroma pair
    ycc = np.stack([rng.integers(0, 256, cb.size), cb.ravel(), cr.ravel()], -1)
    y, cb, cr = ycc[:, 0], ycc[:, 1] - 128, ycc[:, 2] - 128
    want = np.stack([y + ((FIX(1.402) * cr + 32768) >> 16),
                     y + ((-FIX(0.34414) * cb + 32768 - FIX(0.71414) * cr) >> 16),
                     y + ((FIX(1.772) * cb + 32768) >> 16)], -1).clip(0, 255)
    np.testing.assert_array_equal(J.ycbcr_to_rgb(torch.from_numpy(ycc).int()).numpy(), want)


@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (16, 16), (9, 33)])
def test_downsample_is_h2v2_downsample(rng, hw):
    h, w = hw
    plane = rng.integers(0, 256, (1, h, w))
    out_w = 8 * -(-(-(-w // 2)) // 8)
    out_h = -(-h // 2)
    want = np.zeros((8 * -(-out_h // 8), out_w), np.int64)
    for i in range(want.shape[0]):
        for j in range(out_w):
            bias = 1 if j % 2 == 0 else 2
            r0 = min(2 * min(i, out_h - 1), h - 1)          # the replicated rows
            r1 = min(2 * min(i, out_h - 1) + 1, h - 1)
            c0, c1 = min(2 * j, w - 1), min(2 * j + 1, w - 1)
            want[i, j] = (plane[0, r0, c0] + plane[0, r0, c1] + plane[0, r1, c0]
                          + plane[0, r1, c1] + bias) >> 2
    np.testing.assert_array_equal(J.downsample_h2v2(torch.from_numpy(plane).int())[0].numpy(),
                                  want)


def _fdct_islow(block):
    """jfdctint.c jpeg_fdct_islow on one 8 x 8 block of samples - 128, in
    Python integers (its C loops, DESCALE rounding half up)."""
    data = [list(map(int, row)) for row in block]

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one(d, first):
        tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
        tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
        tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
        tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
        tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        out = [0] * 8
        if first:
            out[0], out[4], n = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2, 11
        else:
            out[0], out[4], n = descale(tmp10 + tmp11, 2), descale(tmp10 - tmp11, 2), 15
        z1 = (tmp12 + tmp13) * 4433
        out[2] = descale(z1 + tmp13 * 6270, n)
        out[6] = descale(z1 - tmp12 * 15137, n)
        z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * 9633
        tmp4, tmp5, tmp6, tmp7 = tmp4 * 2446, tmp5 * 16819, tmp6 * 25172, tmp7 * 12299
        z1, z2 = -z1 * 7373, -z2 * 20995
        z3, z4 = -z3 * 16069 + z5, -z4 * 3196 + z5
        out[7] = descale(tmp4 + z1 + z3, n)
        out[5] = descale(tmp5 + z2 + z4, n)
        out[3] = descale(tmp6 + z2 + z3, n)
        out[1] = descale(tmp7 + z1 + z4, n)
        return out

    rows = [one([v - 128 for v in r], True) for r in data]
    cols = [one([rows[i][j] for i in range(8)], False) for j in range(8)]
    return np.array([[cols[j][i] for j in range(8)] for i in range(8)])


def _extreme_blocks():
    """For each (u, v), the samples 0 / 255 by the sign of the DCT basis
    function: the block that maximizes |coefficient (u, v)|."""
    k = np.arange(8)
    basis = np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi / 16)       # (x, u)
    signs = np.einsum("xu,yv->uvyx", basis, basis) >= 0
    return np.where(signs, 255, 0).reshape(64, 8, 8)


def test_forward_dct_is_jfdctint(rng):
    blocks = np.concatenate([rng.integers(0, 256, (20, 8, 8)), _extreme_blocks(),
                             np.zeros((1, 8, 8), int), np.full((1, 8, 8), 255)])
    got = J.forward_dct(torch.from_numpy(blocks).int()).numpy()
    want = np.stack([_fdct_islow(b) for b in blocks])
    np.testing.assert_array_equal(got, want)
    # an orthonormal DCT-II scaled by 8, within the integer rounding
    c = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                   for x in range(8)] for u in range(8)])
    ref = 8 * np.einsum("ux,nxy,vy->nuv", c, blocks - 128.0, c)
    assert np.abs(got - ref).max() <= 8


def test_int32_holds_the_forward_dct():
    """The width the module's docstring derives: int32 gives int64's answer
    on the blocks that maximize each coefficient."""
    blocks = torch.from_numpy(_extreme_blocks())
    np.testing.assert_array_equal(J.forward_dct(blocks.int()).numpy(),
                                  J.forward_dct(blocks.long()).numpy())


@pytest.mark.parametrize("quality", [1, 10, 49, 50, 51, 75, 95, 100])
def test_quant_tables_are_jcparam(quality):
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    for chroma, base in ((False, J.STD_LUMINANCE), (True, J.STD_CHROMINANCE)):
        want = [[min(max((int(t) * scale + 50) // 100, 1), 255) for t in row] for row in base]
        np.testing.assert_array_equal(J.quant_table(quality, chroma), want)
    if quality == 50:
        np.testing.assert_array_equal(J.quant_table(50, False), J.STD_LUMINANCE)
    if quality == 100:
        assert (J.quant_table(100, True) == 1).all()


def test_quantize_is_jcdctmgr(rng):
    table = J.quant_table(95, False)
    coef = rng.integers(-8192, 8193, (50, 8, 8))
    d = 8 * table
    want = np.sign(coef) * ((np.abs(coef) + d // 2) // d)
    np.testing.assert_array_equal(J.quantize(torch.from_numpy(coef).int(), table).numpy(), want)
    # libjpeg-turbo's reciprocal quantizer (compute_reciprocal) gives the same
    # quotients for every 15-bit magnitude and every divisor of a baseline table
    t = np.arange(1 << 15, dtype=np.int64)
    for q in range(1, 256):
        div = 8 * q
        r = 16 + div.bit_length() - 1
        fq, fr = divmod(1 << r, div)
        corr = div // 2
        if fr == 0:
            fq, r = fq >> 1, r - 1
        elif fr <= div // 2:
            corr += 1
        else:
            fq += 1
        assert np.array_equal(((t + corr) * fq) >> r, (t + div // 2) // div), q


def _idct_ifast(qblock, mult):
    """jidctfst.c jpeg_idct_ifast on one quantized block, in Python integers
    (MULTIPLY a bare >> 8; columns, then rows; output range-limited)."""
    def m(v, c):
        return (v * c) >> 8

    def one(t):
        tmp10, tmp11, tmp13 = t[0] + t[4], t[0] - t[4], t[2] + t[6]
        tmp12 = m(t[2] - t[6], 362) - tmp13
        tmp0, tmp3, tmp1, tmp2 = tmp10 + tmp13, tmp10 - tmp13, tmp11 + tmp12, tmp11 - tmp12
        z13, z10, z11, z12 = t[5] + t[3], t[5] - t[3], t[1] + t[7], t[1] - t[7]
        tmp7 = z11 + z13
        tmp11 = m(z11 - z13, 362)
        z5 = m(z10 + z12, 473)
        tmp10 = m(z12, 277) - z5
        tmp12 = m(z10, -669) + z5
        tmp6 = tmp12 - tmp7
        tmp5 = tmp11 - tmp6
        tmp4 = tmp10 + tmp5
        return [tmp0 + tmp7, tmp1 + tmp6, tmp2 + tmp5, tmp3 - tmp4, tmp3 + tmp4,
                tmp2 - tmp5, tmp1 - tmp6, tmp0 - tmp7]

    deq = [[int(qblock[i][j]) * int(mult[i][j]) for j in range(8)] for i in range(8)]
    cols = [one([deq[i][j] for i in range(8)]) for j in range(8)]
    rows = [one([cols[j][i] for j in range(8)]) for i in range(8)]
    return np.array([[min(max((v >> 5) + 128, 0), 255) for v in r] for r in rows])


def test_inverse_dct_is_jidctfst(rng):
    table = J.quant_table(95, True)
    mult = (table * J.AANSCALES + 2048) >> 12
    np.testing.assert_array_equal(J.ifast_multipliers(table), mult)
    qcoef = rng.integers(-30, 31, (30, 8, 8)) * (rng.random((30, 8, 8)) < 0.3)
    qcoef[:, 0, 0] = rng.integers(-128, 128, 30)
    got = J.inverse_dct(J.dequantize(torch.from_numpy(qcoef).int(), table)).numpy()
    np.testing.assert_array_equal(got, np.stack([_idct_ifast(b, mult) for b in qcoef]))


def _h2v2_fancy(plane):
    """jdsample.c h2v2_fancy_upsample in its C loops, the context rows
    replicated at the top and bottom (jdmainct.c)."""
    h, w = plane.shape
    p = [list(map(int, r)) for r in plane]
    out = []
    for i in range(h):
        for other in (p[max(i - 1, 0)], p[min(i + 1, h - 1)]):
            col = [3 * p[i][j] + other[j] for j in range(w)]
            row = [(col[0] * 4 + 8) >> 4, (col[0] * 3 + col[1] + 7) >> 4]
            for j in range(1, w - 1):
                row += [(col[j] * 3 + col[j - 1] + 8) >> 4, (col[j] * 3 + col[j + 1] + 7) >> 4]
            row += [(col[w - 1] * 3 + col[w - 2] + 8) >> 4, (col[w - 1] * 4 + 7) >> 4]
            out.append(row)
    return np.array(out)


@pytest.mark.parametrize("hw", [(1, 3), (4, 3), (5, 9), (8, 16)])
def test_fancy_upsample_is_jdsample(rng, hw):
    plane = rng.integers(0, 256, (1, *hw))
    np.testing.assert_array_equal(J.upsample_h2v2(torch.from_numpy(plane).int())[0].numpy(),
                                  _h2v2_fancy(plane[0]))


@pytest.mark.parametrize("hw", [(1, 1), (3, 2)])
def test_narrow_chroma_is_replicated(rng, hw):
    plane = rng.integers(0, 256, (1, *hw))
    np.testing.assert_array_equal(J.upsample_h2v2(torch.from_numpy(plane).int())[0].numpy(),
                                  np.repeat(np.repeat(plane[0], 2, 0), 2, 1))


# === the goldens the card's run holds the codec to ===
def golden_arrays(tf) -> dict:
    """Frames from seed 0 and TF's round trips at quality 95."""
    frames = {"random_1x1": content("random", 1, 1), "random_9x1": content("random", 9, 1),
              "random_2x3": content("random", 2, 3), "random_17x31": content("random", 17, 31),
              "random_37x53": content("random", 37, 53),
              "random_64x80": content("random", 64, 80),
              "smooth_120x160": content("smooth", 120, 160),
              "checkerboard_48x64": content("checkerboard", 48, 64)}
    out = {}
    for name, f in frames.items():
        out[f"frame_{name}"] = f
        out[f"tf_{name}"] = tf_roundtrip(tf, f)
    return out


def test_golden_file_is_tfs_output(tf):
    arrays = golden_arrays(tf)
    if os.environ.get("REGEN_GOLDENS") == "1":
        np.savez_compressed(GOLDEN, **arrays)
    stored = np.load(GOLDEN)
    assert sorted(stored.files) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(stored[key], value, err_msg=key)
    assert GOLDEN.stat().st_size < 200_000


def _golden_pairs():
    stored = np.load(GOLDEN)
    return [(stored[k], stored["tf_" + k[len("frame_"):]]) for k in stored.files
            if k.startswith("frame_")]


def test_codec_reproduces_the_goldens_without_tf():
    pairs = _golden_pairs()
    assert len(pairs) == 8
    for frame, want in pairs:
        np.testing.assert_array_equal(codec(frame[None])[0], want)


@pytest.mark.gpu
def test_cuda_is_bitwise_the_cpu_and_the_goldens():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for frame, want in _golden_pairs():
        x = torch.from_numpy(frame)[None]
        got = J.jpeg_roundtrip(x.cuda()).cpu()
        assert torch.equal(got, J.jpeg_roundtrip(x))
        np.testing.assert_array_equal(got[0].numpy(), want)
    batch = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (3, 256, 256, 3),
                                                               dtype=np.uint8))
    assert torch.equal(J.jpeg_roundtrip(batch.cuda()).cpu(), J.jpeg_roundtrip(batch))
