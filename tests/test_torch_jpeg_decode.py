"""The port's JPEG decoders (`openvla_oft_tpu_torch/processing/jpeg_decode.py`)
against `tf.io.decode_jpeg(data, channels=3)`, bit for bit.

- `decode_jpeg` (the host library, `hostsrc/jpeg_decode.cc`, built with the
  host's C++ compiler at first use) and `decode_jpeg_plain` (Python entropy
  decoding, `processing/jpeg.py`'s torch stages) on every entry of
  `tests/goldens/jpeg_decode_tf.npz`: JPEG byte strings and TF's pixels for
  PIL at quality 75 / 90 / 95, TF's encoder at 95, PIL `optimize=True`
  (custom Huffman tables), 4:4:4, grey, restart markers every MCU row and
  every 4 MCUs, odd sizes (1 x 1, 17 x 31, 37 x 53) and 256 x 256
  LIBERO-like frames (which `chip_smoke.py` uses as its episode images).
  These run without TF or PIL. Where both import, the golden is built again
  and must be unchanged (`REGEN_GOLDENS=1` rewrites it).
- Live cases against TF: random sizes, contents and qualities.
- Refusals: lossless (SOF3), arithmetic-coded (SOF9), 12-bit streams and a
  fractional sampling raise naming what they are, and so does corrupt data;
  PIL's progressive and 4:2:2 streams decode to its pixels
  (`tests/test_torch_image_modes.py` holds every other mode).
- The ISLOW inverse DCT (`idct="islow"`), PIL's decode: both decoders
  against `Image.open(...).convert("RGB")` bit for bit on every entry of
  `tests/goldens/jpeg_decode_pil.npz` (PIL's bytes and pixels: 4:2:0, 4:4:4
  and grey at qualities 50, 75 and 95, an odd size, restart markers, and
  two 224-pixel frames that `chip_smoke.py` trains on), and on frames drawn
  by hypothesis. The default stays IFAST, whose cases above keep their bits.
"""

import io
import os
from pathlib import Path

import numpy as np
import pytest

from openvla_oft_tpu_torch.processing.jpeg_decode import (decode_jpeg, decode_jpeg_plain,
                                                          jpeg_size)

GOLDEN = Path(__file__).parent / "goldens" / "jpeg_decode_tf.npz"
PIL_GOLDEN = Path(__file__).parent / "goldens" / "jpeg_decode_pil.npz"


def scene(h: int, w: int, seed: int, noise: float = 4.0) -> np.ndarray:
    """A LIBERO-like frame: a lit table, a wall, two blocks and mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.empty((h, w, 3))
    horizon = h * (0.35 + 0.1 * rng.random())
    wall = np.array([150, 160, 175]) + 20 * rng.random(3)
    table = np.array([140, 105, 70]) + 30 * rng.random(3)
    img[:] = np.where((yy < horizon)[..., None], wall, table)
    img *= (0.8 + 0.2 * (1 - yy / h))[..., None]
    for _ in range(2):
        cy, cx = rng.uniform(horizon, h - 10), rng.uniform(10, w - 10)
        r = rng.uniform(0.05, 0.12) * w
        inside = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < r)
        img[inside] = rng.integers(30, 230, 3)
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def golden_cases():
    """(name, JPEG bytes) of the golden, made by PIL and TF from seeded frames."""
    from PIL import Image
    import tensorflow as tf

    def pil(a, **kw):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="JPEG", **kw)
        return buf.getvalue()

    small = scene(48, 64, seed=1, noise=20.0)
    wide = scene(48, 96, seed=2, noise=20.0)
    cases = [(f"pil_q{q}_48x64", pil(small, quality=q)) for q in (75, 90, 95)]
    cases += [
        ("tf_q95_48x64", tf.io.encode_jpeg(tf.constant(small), quality=95).numpy()),
        ("pil_optimize_48x64", pil(small, quality=90, optimize=True)),
        ("pil_444_48x64", pil(small, quality=90, subsampling=0)),
        ("pil_grey_48x64", pil(small[..., 1], quality=90)),
        ("pil_restart_rows_48x96", pil(wide, quality=90, restart_marker_rows=1)),
        ("pil_restart_blocks_48x96", pil(wide, quality=90, restart_marker_blocks=4)),
    ]
    for h, w in ((1, 1), (17, 31), (37, 53)):
        cases.append((f"pil_q90_{h}x{w}", pil(scene(h, w, seed=h + w, noise=20.0)
                                              if h > 1 else np.full((1, 1, 3), 77, np.uint8),
                                              quality=90)))
    cases += [(f"libero_pil_q90_256_{i}", pil(scene(256, 256, seed=10 + i), quality=90))
              for i in range(2)]
    cases.append(("libero_tf_q95_256", tf.io.encode_jpeg(tf.constant(scene(256, 256, seed=20)),
                                                         quality=95).numpy()))
    return cases


def pil_golden_cases():
    """(name, JPEG bytes) of the ISLOW golden, made by PIL from seeded frames."""
    from PIL import Image

    def pil(a, **kw):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="JPEG", **kw)
        return buf.getvalue()

    small = scene(48, 64, seed=3, noise=20.0)
    cases = []
    for q in (50, 75, 95):
        cases += [(f"q{q}_420_48x64", pil(small, quality=q)),
                  (f"q{q}_444_48x64", pil(small, quality=q, subsampling=0)),
                  (f"q{q}_grey_48x64", pil(small[..., 2], quality=q))]
    cases.append(("q90_420_37x53", pil(scene(37, 53, seed=4, noise=20.0), quality=90)))
    cases.append(("q90_restart_48x96", pil(scene(48, 96, seed=5, noise=20.0), quality=90,
                                           restart_marker_blocks=3)))
    cases += [(f"llava_q95_224_{i}", pil(scene(224, 224 - 32 * i, seed=30 + i), quality=95))
              for i in range(2)]
    return cases


def load_golden(path=GOLDEN):
    with np.load(path) as z:
        names = [str(n) for n in z["names"]]
        return [(n, z[f"data_{i}"].tobytes(), z[f"pixels_{i}"]) for i, n in enumerate(names)]


def test_golden_is_unchanged_when_rebuilt():
    tf = pytest.importorskip("tensorflow")
    pytest.importorskip("PIL")
    cases = golden_cases()
    entries = [(n, d, tf.io.decode_jpeg(d, channels=3).numpy()) for n, d in cases]
    if os.environ.get("REGEN_GOLDENS"):
        GOLDEN.parent.mkdir(exist_ok=True)
        arrays = {"names": np.array([n for n, _, _ in entries])}
        for i, (_, d, px) in enumerate(entries):
            arrays[f"data_{i}"] = np.frombuffer(d, np.uint8)
            arrays[f"pixels_{i}"] = px
        np.savez_compressed(GOLDEN, **arrays)
    stored = load_golden()
    assert [n for n, _, _ in stored] == [n for n, _, _ in entries]
    for (name, d, px), (_, d0, px0) in zip(entries, stored):
        assert d == d0, name
        np.testing.assert_array_equal(px, px0, err_msg=name)
    assert GOLDEN.stat().st_size < 400_000


@pytest.mark.parametrize("decoder", [decode_jpeg, decode_jpeg_plain],
                         ids=["host_library", "plain"])
def test_golden_bitwise(decoder):
    entries = load_golden()
    assert len(entries) == 15
    for name, data, pixels in entries:
        got = decoder(data)
        assert got.dtype == np.uint8 and got.shape == pixels.shape, name
        np.testing.assert_array_equal(got, pixels, err_msg=name)


def test_pil_golden_is_unchanged_when_rebuilt():
    Image = pytest.importorskip("PIL.Image")
    entries = [(n, d, np.asarray(Image.open(io.BytesIO(d)).convert("RGB")))
               for n, d in pil_golden_cases()]
    if os.environ.get("REGEN_GOLDENS"):
        arrays = {"names": np.array([n for n, _, _ in entries])}
        for i, (_, d, px) in enumerate(entries):
            arrays[f"data_{i}"] = np.frombuffer(d, np.uint8)
            arrays[f"pixels_{i}"] = px
        np.savez_compressed(PIL_GOLDEN, **arrays)
    stored = load_golden(PIL_GOLDEN)
    assert [n for n, _, _ in stored] == [n for n, _, _ in entries]
    for (name, d, px), (_, d0, px0) in zip(entries, stored):
        assert d == d0, name
        np.testing.assert_array_equal(px, px0, err_msg=name)
    assert PIL_GOLDEN.stat().st_size < 400_000


@pytest.mark.parametrize("decoder", [decode_jpeg, decode_jpeg_plain],
                         ids=["host_library", "plain"])
def test_pil_golden_bitwise_islow(decoder):
    entries = load_golden(PIL_GOLDEN)
    assert len(entries) == 13
    for name, data, pixels in entries:
        got = decoder(data, idct="islow")
        assert got.dtype == np.uint8 and got.shape == pixels.shape, name
        np.testing.assert_array_equal(got, pixels, err_msg=name)
    # IFAST (the default) is another decode: it differs on these frames
    assert any(not np.array_equal(decoder(d), px) for _, d, px in entries)


def test_pil_golden_covers_the_layouts():
    entries = {n: d for n, d, _ in load_golden(PIL_GOLDEN)}
    sof = lambda d: d[d.index(b"\xff\xc0") + 9:][:10]            # noqa: E731
    for q in (50, 75, 95):
        assert sof(entries[f"q{q}_420_48x64"])[2] == 0x22
        assert sof(entries[f"q{q}_444_48x64"])[2] == 0x11
        assert sof(entries[f"q{q}_grey_48x64"])[0] == 1
    assert b"\xff\xdd" in entries["q90_restart_48x96"]
    assert jpeg_size(entries["q90_420_37x53"]) == (37, 53)
    assert jpeg_size(entries["llava_q95_224_1"]) == (224, 192)


def test_unknown_idct_raises():
    data = load_golden(PIL_GOLDEN)[0][1]
    for decoder in (decode_jpeg, decode_jpeg_plain):
        with pytest.raises(ValueError, match="idct"):
            decoder(data, idct="float")


def test_golden_covers_the_layouts():
    """The golden holds what its names say: restart intervals, 4:4:4, grey,
    custom tables, the odd sizes."""
    entries = {n: d for n, d, _ in load_golden()}
    sof = lambda d: d[d.index(b"\xff\xc0") + 9:][:10]            # noqa: E731
    assert b"\xff\xdd" in entries["pil_restart_rows_48x96"]
    assert b"\xff\xdd" in entries["pil_restart_blocks_48x96"]
    assert entries["pil_restart_rows_48x96"] != entries["pil_restart_blocks_48x96"]
    assert sof(entries["pil_444_48x64"])[2] == 0x11 and sof(entries["pil_q90_48x64"])[2] == 0x22
    assert sof(entries["pil_grey_48x64"])[0] == 1
    assert entries["pil_optimize_48x64"] != entries["pil_q90_48x64"]
    assert jpeg_size(entries["pil_q90_37x53"]) == (37, 53)
    assert jpeg_size(entries["libero_tf_q95_256"]) == (256, 256)


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def pil():
    return pytest.importorskip("PIL.Image")


def _pil_jpeg(pil, a, **kw):
    buf = io.BytesIO()
    pil.fromarray(a).save(buf, format="JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("seed", range(6))
def test_live_cases_against_tf(tf, pil, seed):
    """Random sizes, contents, qualities and layouts, both decoders."""
    rng = np.random.default_rng(100 + seed)
    h, w = (int(x) for x in rng.integers(1, 90, 2))
    a = (scene(h, w, seed) if seed % 2 and min(h, w) > 20 else
         rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    q = int(rng.integers(5, 101))
    cases = [_pil_jpeg(pil, a, quality=q), _pil_jpeg(pil, a, quality=q, subsampling=0),
             _pil_jpeg(pil, a[..., 0], quality=q),
             _pil_jpeg(pil, a, quality=q, optimize=True, restart_marker_blocks=3),
             tf.io.encode_jpeg(tf.constant(a), quality=q).numpy()]
    for data in cases:
        want = tf.io.decode_jpeg(data, channels=3).numpy()
        np.testing.assert_array_equal(decode_jpeg(data), want)
        np.testing.assert_array_equal(decode_jpeg_plain(data), want)


def _with_sof(data: bytes, marker: int) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


@pytest.mark.parametrize("decoder", [decode_jpeg, decode_jpeg_plain],
                         ids=["host_library", "plain"])
def test_refusals(decoder):
    entries = {n: d for n, d, _ in load_golden()}
    base = entries["pil_q90_48x64"]
    with pytest.raises(ValueError, match=r"lossless \(SOF3\)"):
        decoder(_with_sof(base, 0xC3))
    with pytest.raises(ValueError, match=r"arithmetic-coded sequential \(SOF9\)"):
        decoder(_with_sof(base, 0xC9))
    i = base.index(b"\xff\xc0")
    twelve = base[:i + 4] + bytes([12]) + base[i + 5:]
    with pytest.raises(ValueError, match="12-bit"):
        decoder(twelve)
    # Y 3x2 over chroma 2x2: not an integral ratio
    j = i + 11
    fractional = base[:j] + bytes([0x32]) + base[j + 1:j + 3] + bytes([0x22]) + base[j + 4:]
    with pytest.raises(ValueError, match="sampling"):
        decoder(fractional)
    with pytest.raises(ValueError, match="SOI"):
        decoder(b"not a jpeg")
    with pytest.raises(ValueError, match="JPEG decode failed"):
        decoder(base[:len(base) // 3])


def test_pil_progressive_and_422_raise(pil):
    """PIL's progressive and 4:2:2 streams, which the decoders refused
    before they took every mode: now PIL's pixels under ISLOW."""
    a = scene(32, 48, seed=5)
    for data in (_pil_jpeg(pil, a, quality=90, progressive=True),
                 _pil_jpeg(pil, a, quality=90, subsampling=1)):
        want = np.asarray(pil.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_jpeg(data, idct="islow"), want)


def test_threads_decode_in_parallel_and_agree():
    """The host decoder from a pool of threads: every result equal to the
    one-thread result (no state shared between calls)."""
    from concurrent.futures import ThreadPoolExecutor

    entries = load_golden()
    datas = [d for _, d, _ in entries] * 4
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(decode_jpeg, datas))
    for (name, _, pixels), out in zip(entries * 4, got):
        np.testing.assert_array_equal(out, pixels, err_msg=name)


@pytest.mark.parametrize("subsampling", [2, 0, "grey"])
def test_islow_against_pil_drawn(pil, subsampling):
    """Frames, sizes and qualities drawn by hypothesis, both decoders with
    `idct="islow"` against PIL's decode bit for bit."""
    from hypothesis import HealthCheck, given, settings, strategies as st

    @settings(max_examples=12, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(h=st.integers(1, 70), w=st.integers(1, 70), quality=st.integers(5, 100),
           seed=st.integers(0, 2 ** 16), smooth=st.booleans())
    def check(h, w, quality, seed, smooth):
        rng = np.random.default_rng(seed)
        a = (scene(h, w, seed) if smooth and min(h, w) > 20 else
             rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        data = (_pil_jpeg(pil, a[..., 0], quality=quality) if subsampling == "grey" else
                _pil_jpeg(pil, a, quality=quality, subsampling=subsampling))
        want = np.asarray(pil.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_jpeg(data, idct="islow"), want)
        np.testing.assert_array_equal(decode_jpeg_plain(data, idct="islow"), want)

    check()
