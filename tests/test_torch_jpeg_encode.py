"""The port's JPEG encoder (`processing/jpeg_encode.py`) against PIL's
bytes, bit for bit.

`encode_jpeg` (the host library, `hostsrc/jpeg_encode.cc`) and
`encode_jpeg_plain` (the torch stages and a Python entropy coder) on RGB
(4:2:0) and grey frames at qualities 50, 75, 90 and 95 and at sizes that
are not multiples of 16 (the MCU grid's dummy blocks), against
`PIL.Image.fromarray(frame).save(buf, "JPEG", quality=q)`; the streams
decode back through the port's decoder to PIL's pixels; bad frames and
qualities raise; a pool of threads encodes as one thread does.
"""

import io

import numpy as np
import pytest

from openvla_oft_tpu_torch.processing.jpeg_decode import decode_jpeg
from openvla_oft_tpu_torch.processing.jpeg_encode import (STD_HUFFMAN, encode_jpeg,
                                                          encode_jpeg_plain)

SIZES = [(1, 1), (7, 9), (17, 33), (37, 45), (23, 16), (16, 100), (64, 48)]


def frame(h, w, seed, grey=False):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 5 + y * 3) % 256, (x * 2 - y * 7) % 256, (x * y) % 256], -1)
    a = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
    return a[..., 0].copy() if grey else a


def pil_bytes(a, quality):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("encoder", [encode_jpeg, encode_jpeg_plain],
                         ids=["host_library", "plain"])
@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
@pytest.mark.parametrize("quality", [50, 75, 90, 95])
def test_bytes_are_pils(encoder, grey, quality):
    pytest.importorskip("PIL")
    for i, (h, w) in enumerate(SIZES):
        a = frame(h, w, 10 * i + quality, grey)
        assert encoder(a, quality) == pil_bytes(a, quality), (h, w)


@pytest.mark.parametrize("quality", [1, 10, 100])
def test_extreme_qualities_are_pils(quality):
    pytest.importorskip("PIL")
    a = frame(29, 31, quality)
    assert encode_jpeg(a, quality) == encode_jpeg_plain(a, quality) == pil_bytes(a, quality)


def test_host_library_equals_plain_on_a_libero_frame():
    """A 256 x 256 frame of the synthetic set's kind, without PIL."""
    from openvla_oft_tpu_torch.scripts.make_synthetic_rlds import task_image

    a = task_image(np.random.default_rng(0), 3, 10, 64, 256, 8)
    data = encode_jpeg(a, 90)
    assert data == encode_jpeg_plain(a, 90)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    out = decode_jpeg(data, idct="islow")
    assert out.shape == a.shape and np.abs(out.astype(int) - a).mean() < 8


def test_decodes_to_pils_pixels():
    Image = pytest.importorskip("PIL.Image")
    for grey in (False, True):
        a = frame(41, 27, 3, grey)
        data = encode_jpeg(a, 80)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_jpeg(data, idct="islow"), want)


def test_standard_tables_are_pils():
    """The DHT segments PIL writes hold jstdhuff.c's tables."""
    pytest.importorskip("PIL")
    data = pil_bytes(frame(16, 16, 0), 75)
    pos, tables = 2, {}
    while data[pos + 1] != 0xDA:
        n = (data[pos + 2] << 8) | data[pos + 3]
        body = data[pos + 4:pos + 2 + n]
        if data[pos + 1] == 0xC4:
            tables[(body[0] >> 4, body[0] & 15)] = (body[1:17], body[17:])
        pos += 2 + n
    assert tables == STD_HUFFMAN


@pytest.mark.parametrize("encoder", [encode_jpeg, encode_jpeg_plain],
                         ids=["host_library", "plain"])
def test_refusals(encoder):
    a = frame(8, 8, 0)
    with pytest.raises(ValueError, match="uint8"):
        encoder(a.astype(np.float32), 75)
    with pytest.raises(ValueError, match="uint8"):
        encoder(np.zeros((8, 8, 4), np.uint8), 75)
    with pytest.raises(ValueError, match="quality"):
        encoder(a, 0)
    with pytest.raises(ValueError, match="quality"):
        encoder(a, 101)
    with pytest.raises(ValueError, match="size"):
        encoder(np.zeros((0, 8, 3), np.uint8), 75)


def test_threads_encode_as_one_thread():
    from concurrent.futures import ThreadPoolExecutor

    frames = [frame(40 + i, 50 - i, i, grey=i % 3 == 0) for i in range(12)]
    want = [encode_jpeg(a, 90) for a in frames]
    with ThreadPoolExecutor(6) as pool:
        got = list(pool.map(lambda a: encode_jpeg(a, 90), frames * 3))
    assert got == want * 3
