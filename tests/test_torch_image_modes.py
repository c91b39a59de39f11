"""Every JPEG and PNG mode the JAX package reads through PIL, against PIL's
and TF's pixels, bit for bit.

- JPEG (`processing/jpeg_decode.py`): both decoders, the host library's
  `decode_jpeg` and the plain `decode_jpeg_plain`, under `idct="islow"`
  against `Image.open(...).convert("RGB")` and under "ifast" against
  `tf.io.decode_jpeg(data, channels=3)` (where TF decodes the stream), on
  PIL's progressive streams (the default script, with restart markers,
  `optimize=True`, grey, 4:2:2, 4:4:4), PIL's 4:2:2 and CMYK, and streams
  PIL cannot write, made by `processing/jpeg_encode.py::encode_planes_plain`
  (4:1:1, 4:4:0, 3:1, mixed upsamplers, YCCK, Adobe RGB, RGB by component
  ids, CMYK with no Adobe marker); and the block-smoothing cases:
  progressive streams cut after their early scans, at the sizes where
  libjpeg-turbo 2.1.4 (TF's) and 3.x (PIL's) walk the blocks differently.
- PNG (`processing/png_decode.py`): every colour type at every bit depth,
  each plain and Adam7-interlaced, every filter, against PIL.
- `processing/image_io.py::read_image` dispatching on the magic bytes, and
  refusing GIF, BMP, WebP and TIFF by name.

The cases live in `tests/goldens/image_modes.npz` (streams and pixels), so
the decoders are held to PIL and TF where neither imports (`chip_smoke.py`'s
phase 20 reads it on the card's machine). Where both import, the golden is
built again and must be unchanged; `REGEN_GOLDENS=1` rewrites it.
"""

import io
import os
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_oft_tpu_torch.processing import jpeg as J
from openvla_oft_tpu_torch.processing.image_io import image_format, read_image
from openvla_oft_tpu_torch.processing.jpeg_decode import decode_jpeg, decode_jpeg_plain
from openvla_oft_tpu_torch.processing.jpeg_encode import (JFIF_APP0, adobe_app14,
                                                          encode_planes_plain)
from openvla_oft_tpu_torch.processing.png_decode import decode_png

GOLDEN = Path(__file__).parent / "goldens" / "image_modes.npz"


# === Stream builders (PIL, TF and the plain encoder) ===
def scene(h, w, seed, ch=3):
    """Gradients and noise: every block busy, chroma varied."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7 + y * 3) % 256, (x * 2 - y * 5) % 256, (x * y + 40) % 256,
                     (x * 11 + 90) % 256][:ch], -1).astype(np.float64)
    return np.clip(base + rng.normal(0, 24, base.shape), 0, 255).astype(np.uint8)


def pil_jpeg(a, mode=None, **kw):
    from PIL import Image

    im = Image.fromarray(a) if mode is None else Image.fromarray(a).convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def cut_scans(data: bytes, n: int) -> bytes:
    """The stream's first `n` scans, then EOI: what a progressive file that
    stops after its early scans holds (PIL decodes it, smoothing)."""
    pos, seen = 2, 0
    while True:
        marker = data[pos + 1]
        if marker == 0xDA:
            seen += 1
            if seen > n:
                return data[:pos] + b"\xff\xd9"
        if marker == 0xD9:
            return data
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:        # skip the entropy-coded data and its RSTn
            while True:
                j = data.index(b"\xff", pos)
                if data[j + 1] == 0 or 0xD0 <= data[j + 1] <= 0xD7:
                    pos = j + 2
                    continue
                pos = j
                break


def sampled_planes(samples: np.ndarray, factors):
    """(H, W, C) component samples -> each component averaged over its
    sampling cell and edge-padded to its blocks (`encode_planes_plain`'s
    input)."""
    h, w, _ = samples.shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    planes = []
    for c, (fh, fv) in enumerate(factors):
        sx, sy = hmax // fh, vmax // fv
        cw, ch = -(-w * fh // hmax), -(-h * fv // vmax)
        p = J.pad_edge(torch.from_numpy(samples[..., c].astype(np.int32))[None],
                       ch * sy, cw * sx)[0]
        p = p.reshape(ch, sy, cw, sx).sum((1, 3)) // (sx * sy)
        planes.append(J.pad_edge(p[None], 8 * -(-ch // 8), 8 * -(-cw // 8))[0])
    return planes


def planes_jpeg(samples, factors, quality=80, app=JFIF_APP0, ids=None, tables_of=None):
    tables = {0: J.quant_table(quality, False), 1: J.quant_table(quality, True)}
    n = len(factors)
    table_of = tables_of or ([0] + [1] * (n - 1) if n == 3 else [0, 1, 1, 0][:n])
    return encode_planes_plain(sampled_planes(samples, factors), samples.shape[:2], factors,
                               tables, table_of, table_of, ids or list(range(1, n + 1)), app)


def jpeg_cases():
    """(name, stream) of every JPEG case."""
    a = scene(37, 45, 1)
    g = scene(29, 23, 2, 1)[..., 0]
    out = [
        ("pil_progressive_420", pil_jpeg(a, quality=75, progressive=True)),
        ("pil_progressive_restart_blocks", pil_jpeg(a, quality=85, progressive=True,
                                                    restart_marker_blocks=3)),
        ("pil_progressive_restart_rows", pil_jpeg(scene(40, 52, 3), quality=70,
                                                  progressive=True, subsampling=1,
                                                  restart_marker_rows=1)),
        ("pil_progressive_optimize", pil_jpeg(a, quality=90, progressive=True, optimize=True)),
        ("pil_progressive_grey", pil_jpeg(g, quality=80, progressive=True)),
        ("pil_progressive_422", pil_jpeg(a, quality=75, progressive=True, subsampling=1)),
        ("pil_progressive_444", pil_jpeg(scene(21, 30, 4), quality=95, progressive=True,
                                         subsampling=0)),
        ("pil_baseline_422", pil_jpeg(a, quality=75, subsampling=1)),
        ("pil_baseline_422_narrow", pil_jpeg(scene(19, 3, 5), quality=75, subsampling=1)),
        ("pil_cmyk", pil_jpeg(scene(26, 31, 6, 4), "CMYK", quality=85)),
        ("pil_cmyk_progressive", pil_jpeg(scene(26, 31, 7, 4), "CMYK", quality=85,
                                          progressive=True)),
    ]
    out += [
        ("enc_411", planes_jpeg(J.rgb_to_ycbcr(torch.from_numpy(scene(21, 53, 8)).int()).numpy(),
                                [(4, 1), (1, 1), (1, 1)])),
        ("enc_440", planes_jpeg(J.rgb_to_ycbcr(torch.from_numpy(scene(35, 22, 9)).int()).numpy(),
                                [(1, 2), (1, 1), (1, 1)])),
        ("enc_310", planes_jpeg(J.rgb_to_ycbcr(torch.from_numpy(scene(17, 40, 10)).int()).numpy(),
                                [(3, 1), (1, 1), (1, 1)])),
        ("enc_mixed_upsamplers", planes_jpeg(
            J.rgb_to_ycbcr(torch.from_numpy(scene(27, 34, 11)).int()).numpy(),
            [(2, 2), (1, 2), (2, 1)])),
        ("enc_ycck", planes_jpeg(scene(25, 38, 12, 4), [(2, 2), (1, 1), (1, 1), (2, 2)],
                                 app=adobe_app14(2), tables_of=[0, 1, 1, 0])),
        ("enc_cmyk_no_adobe", planes_jpeg(scene(18, 20, 13, 4), [(1, 1)] * 4, app=b"",
                                          tables_of=[0, 0, 0, 0])),
        ("enc_adobe_rgb", planes_jpeg(scene(23, 29, 14), [(1, 1)] * 3, app=adobe_app14(0),
                                      tables_of=[0, 0, 0])),
        ("enc_rgb_ids", planes_jpeg(scene(15, 26, 15), [(1, 1)] * 3, app=b"", ids=[82, 71, 66],
                                    tables_of=[0, 0, 0])),
    ]
    # Block smoothing: the early scans only. 20 x 33 (4:2:0): two iMCU rows,
    # the second short; 9 x 16 grey: two blocks wide; 37 x 45: a dummy block
    # row read from below.
    for name, data, cuts in (
            ("420_37x45", pil_jpeg(a, quality=75, progressive=True), (1, 2, 5, 9)),
            ("420_20x33", pil_jpeg(scene(20, 33, 16), quality=75, progressive=True), (1, 3)),
            ("444_16x16", pil_jpeg(scene(16, 16, 17), quality=75, progressive=True,
                                   subsampling=0), (1, 2)),
            ("422_24x35", pil_jpeg(scene(24, 35, 18), quality=60, progressive=True,
                                   subsampling=1), (1, 4)),
            ("grey_9x16", pil_jpeg(scene(9, 16, 19, 1)[..., 0], quality=75, progressive=True),
             (1, 2)),
            ("grey_30x12", pil_jpeg(scene(30, 12, 20, 1)[..., 0], quality=50,
                                    progressive=True), (1, 3))):
        out += [(f"smooth_{name}_scans{n}", cut_scans(data, n)) for n in cuts]
    return out


# PNG: a writer that covers what PIL's does not choose (every filter, every
# depth, interlacing, short palettes).
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _rows(s: np.ndarray, depth: int):
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in s]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in s]
    shifts = np.arange(depth - 1, -1, -1)
    return [np.packbits(((r[:, 0][:, None] >> shifts) & 1).reshape(-1).astype(np.uint8))
            .tobytes() for r in s]


def _filtered(rows, bpp: int, first: int) -> bytes:
    """Each row under filter (first + row) % 5."""
    out, prior = bytearray(), bytes(len(rows[0]))
    for i, r in enumerate(rows):
        f = (first + i) % 5
        out.append(f)
        for x in range(len(r)):
            a = r[x - bpp] if x >= bpp else 0
            b, c = prior[x], (prior[x - bpp] if x >= bpp else 0)
            if f == 4:
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                p = (0, a, b, (a + b) >> 1)[f]
            out.append((r[x] - p) & 0xFF)
        prior = r
    return bytes(out)


def png_bytes(s, depth, ctype, interlace=False, palette=None, trns=None):
    h, w, _ = s.shape
    bpp = max(1, _CHANNELS[ctype] * depth // 8)
    raw = b""
    for y0, x0, dy, dx in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = s[y0::dy, x0::dx]
        if sub.size:
            raw += _filtered(_rows(sub, depth), bpp, depth + ctype)
    z = zlib.compress(raw)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                           0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    out += _chunk(b"tEXt", b"Comment\x00a test image")
    return out + _chunk(b"IDAT", z[:9]) + _chunk(b"IDAT", z[9:]) + _chunk(b"IEND", b"")


def png_cases(h=13, w=11):
    """(name, stream): each colour type at each depth, plain and interlaced;
    16-bit grey with samples past 255, palettes shorter than the depth's
    range, tRNS on grey, RGB and palette images."""
    from PIL import Image

    rng = np.random.default_rng(h * 100 + w)
    out = []
    for ctype, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)),
                          (6, (8, 16))):
        for depth in depths:
            for interlace in (False, True):
                palette = trns = None
                if ctype == 3:
                    n = min(1 << depth, 7) if depth < 8 else 200
                    palette = rng.integers(0, 256, (n, 3))
                    s = rng.integers(0, 1 << depth, (h, w, 1))
                    trns = bytes(rng.integers(0, 256, 3).astype(np.uint8))
                else:
                    s = rng.integers(0, 1 << depth, (h, w, _CHANNELS[ctype]))
                    if ctype == 0 and depth == 16:
                        s[0, :4, 0] = [0, 255, 256, 308]
                    if ctype in (0, 2) and depth == 8:
                        trns = b"\x00\x05" * _CHANNELS[ctype]
                out.append((f"type{ctype}_depth{depth}{'_adam7' if interlace else ''}",
                            png_bytes(s, depth, ctype, interlace, palette, trns)))
    for mode in ("RGBA", "P"):
        buf = io.BytesIO()
        Image.fromarray(scene(17, 19, 21)).convert(mode).save(buf, "PNG", optimize=True)
        out.append((f"pil_{mode}", buf.getvalue()))
    return out


def pil_rgb(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def tf_rgb(data: bytes):
    import tensorflow as tf

    try:
        return tf.io.decode_jpeg(data, channels=3).numpy()
    except Exception:  # noqa: BLE001 - a stream TF refuses has no TF entry
        return None


def build_golden() -> dict:
    z = {}
    jpegs = jpeg_cases()
    z["jpeg_names"] = np.array([n for n, _ in jpegs])
    for i, (_, data) in enumerate(jpegs):
        z[f"jpeg_{i}"] = np.frombuffer(data, np.uint8)
        z[f"jpeg_pil_{i}"] = pil_rgb(data)
        t = tf_rgb(data)
        if t is not None:
            z[f"jpeg_tf_{i}"] = t
    pngs = png_cases()
    z["png_names"] = np.array([n for n, _ in pngs])
    for i, (_, data) in enumerate(pngs):
        z[f"png_{i}"] = np.frombuffer(data, np.uint8)
        z[f"png_pil_{i}"] = pil_rgb(data)
    return z


def load_golden() -> dict:
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def golden_jpegs():
    z = load_golden()
    return [(str(n), z[f"jpeg_{i}"].tobytes(), z[f"jpeg_pil_{i}"], z.get(f"jpeg_tf_{i}"))
            for i, n in enumerate(z["jpeg_names"])]


def golden_pngs():
    z = load_golden()
    return [(str(n), z[f"png_{i}"].tobytes(), z[f"png_pil_{i}"])
            for i, n in enumerate(z["png_names"])]


_JPEG_NAMES = [n for n, *_ in golden_jpegs()] if GOLDEN.exists() else []
_PNG_NAMES = [n for n, *_ in golden_pngs()] if GOLDEN.exists() else []


def test_golden_reproduces():
    """The streams and pixels are what PIL, TF and the plain encoder give
    here (REGEN_GOLDENS=1 rewrites the file)."""
    pytest.importorskip("PIL")
    pytest.importorskip("tensorflow")
    z = build_golden()
    old = load_golden() if GOLDEN.exists() else {}
    if os.environ.get("REGEN_GOLDENS") == "1":
        np.savez_compressed(GOLDEN, **z)
        old = load_golden()
    assert set(old) == set(z)
    for k, v in z.items():
        np.testing.assert_array_equal(old[k], v, err_msg=k)


def test_golden_covers_every_mode():
    z = load_golden()
    names = set(_JPEG_NAMES)
    for want in ("pil_progressive_420", "pil_progressive_restart_blocks",
                 "pil_progressive_optimize", "pil_progressive_grey", "pil_baseline_422",
                 "pil_cmyk", "enc_411", "enc_440", "enc_ycck", "enc_adobe_rgb"):
        assert want in names
    assert sum(n.startswith("smooth_") for n in names) >= 12
    # TF decodes every stream here, so each has both references
    assert all(f"jpeg_tf_{i}" in z for i in range(len(_JPEG_NAMES)))
    assert {f"type{t}_depth{d}_adam7" for t, ds in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                                    (3, (1, 2, 4, 8)), (4, (8, 16)),
                                                    (6, (8, 16))) for d in ds} <= set(_PNG_NAMES)
    assert GOLDEN.stat().st_size < 300_000


@pytest.mark.parametrize("decoder", [decode_jpeg, decode_jpeg_plain],
                         ids=["host_library", "plain"])
@pytest.mark.parametrize("name", _JPEG_NAMES)
def test_jpeg_mode_islow_is_pils(name, decoder):
    data, pil = next((d, p) for n, d, p, _ in golden_jpegs() if n == name)
    np.testing.assert_array_equal(decoder(data, idct="islow"), pil)


@pytest.mark.parametrize("decoder", [decode_jpeg, decode_jpeg_plain],
                         ids=["host_library", "plain"])
@pytest.mark.parametrize("name", _JPEG_NAMES)
def test_jpeg_mode_ifast_is_tfs(name, decoder):
    data, tf = next((d, t) for n, d, _, t in golden_jpegs() if n == name)
    np.testing.assert_array_equal(decoder(data, idct="ifast"), tf)


@pytest.mark.parametrize("name", _PNG_NAMES)
def test_png_mode_is_pils(name):
    data, pil = next((d, p) for n, d, p in golden_pngs() if n == name)
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == pil.shape
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(read_image(data), pil)


def test_smoothing_runs_and_the_two_walks_differ():
    """The cut streams smooth (without it the pixels differ from PIL's), and
    the 2.1.4 and 3.x walks give different pixels on the cases built for
    them."""
    from openvla_oft_tpu_torch.processing import jpeg_decode as JD

    cases = {n: (d, p, t) for n, d, p, t in golden_jpegs() if n.startswith("smooth_")}
    walk_differs = set()
    for name, (data, pil, tf) in cases.items():
        p = JD._parse(data)
        assert JD._smoothing_ok(p), name
        for idct, want in (("islow", pil), ("ifast", tf)):
            other = "2.1" if idct == "islow" else "3"
            for c in p["comps"]:
                coef = np.array(c["blocks"], np.int64).reshape(-1, c["cols"], 64)
                a = JD.smooth_blocks(coef, c["bits"], c["qt"], c["bh"], c["bw"], c["v"],
                                     p["imcu_rows"], "3" if idct == "islow" else "2.1")
                b = JD.smooth_blocks(coef, c["bits"], c["qt"], c["bh"], c["bw"], c["v"],
                                     p["imcu_rows"], other)
                if not np.array_equal(a, b):
                    walk_differs.add(name)
    assert {"smooth_420_20x33_scans1", "smooth_grey_9x16_scans1"} <= walk_differs
    # without smoothing, PIL's pixels are not reached
    orig = JD._smoothing_ok
    try:
        JD._smoothing_ok = lambda p: False
        data, pil, _ = cases["smooth_420_37x45_scans1"]
        assert not np.array_equal(JD.decode_jpeg_plain(data, "islow"), pil)
    finally:
        JD._smoothing_ok = orig


def test_smoothing_rows_quirks():
    """smoothing_rows on the short last iMCU row (v = 2, 3 block rows, 2
    iMCU rows): 3.x reads the row above as two up; 2.1.4 at the first row
    of the second iMCU row reads one up as two up, and at the last full
    iMCU row reads the dummy row below."""
    from openvla_oft_tpu_torch.processing.jpeg_decode import smoothing_rows

    np.testing.assert_array_equal(smoothing_rows(3, 2, 2, "3"),
                                  [[0, 0, 0, 1, 2], [0, 0, 1, 2, 3], [1, 1, 2, 2, 2]])
    np.testing.assert_array_equal(smoothing_rows(3, 2, 2, "2.1"),
                                  [[0, 0, 0, 1, 1], [0, 0, 1, 2, 2], [1, 1, 2, 2, 2]])
    np.testing.assert_array_equal(smoothing_rows(2, 1, 2, "3"), smoothing_rows(2, 1, 2, "2.1"))


@pytest.mark.parametrize("seed", range(6))
def test_live_modes_against_pil_and_tf(seed):
    """Random sizes and qualities through every PIL-writable mode, the
    progressive ones cut at a random scan too."""
    pytest.importorskip("PIL")
    pytest.importorskip("tensorflow")
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, 70, 2))
    q = int(rng.integers(20, 100))
    a = scene(h, w, seed + 100)
    streams = [pil_jpeg(a, quality=q, progressive=True, subsampling=int(seed % 3)),
               pil_jpeg(a, quality=q, subsampling=1),
               pil_jpeg(scene(h, w, seed, 4), "CMYK", quality=q, progressive=bool(seed % 2))]
    streams.append(cut_scans(streams[0], int(rng.integers(1, 6))))
    for data in streams:
        for decoder in (decode_jpeg, decode_jpeg_plain):
            np.testing.assert_array_equal(decoder(data, idct="islow"), pil_rgb(data))
            np.testing.assert_array_equal(decoder(data, idct="ifast"), tf_rgb(data))


@pytest.mark.parametrize("fmt,maker", [
    ("GIF", lambda: b"GIF89a" + bytes(20)),
    ("BMP", lambda: b"BM" + bytes(40)),
    ("WebP", lambda: b"RIFF\x10\x00\x00\x00WEBPVP8 " + bytes(12)),
    ("TIFF", lambda: b"II*\x00" + bytes(20)),
    ("TIFF", lambda: b"MM\x00*" + bytes(20)),
])
def test_read_image_refuses_by_name(fmt, maker):
    data = maker()
    assert image_format(data) == fmt
    with pytest.raises(ValueError, match=f"unsupported image format: {fmt}"):
        read_image(data)


def test_read_image_dispatch_and_unknown():
    z = golden_jpegs()
    data, pil = z[0][1], z[0][2]
    assert image_format(data) == "JPEG"
    np.testing.assert_array_equal(read_image(data), pil)
    np.testing.assert_array_equal(read_image(data, idct="ifast"), z[0][3])
    with pytest.raises(ValueError, match="unsupported image format"):
        read_image(b"not an image at all")


@pytest.mark.parametrize("decoder", [decode_jpeg, decode_jpeg_plain],
                         ids=["host_library", "plain"])
@pytest.mark.parametrize("marker,name", [
    (0xC3, r"lossless \(SOF3\)"), (0xC5, r"differential sequential \(SOF5\)"),
    (0xC6, r"differential progressive \(SOF6\)"), (0xC7, r"differential lossless \(SOF7\)"),
    (0xC9, r"arithmetic-coded sequential \(SOF9\)"),
    (0xCA, r"arithmetic-coded progressive \(SOF10\)"),
    (0xCB, r"arithmetic-coded lossless \(SOF11\)"),
    (0xCD, r"arithmetic-coded differential sequential \(SOF13\)"),
    (0xCE, r"arithmetic-coded differential progressive \(SOF14\)"),
    (0xCF, r"arithmetic-coded differential lossless \(SOF15\)")])
def test_jpeg_refusals_name_their_marker(decoder, marker, name):
    data = dict((n, d) for n, d, *_ in golden_jpegs())["pil_progressive_420"]
    i = data.index(b"\xff\xc2")
    with pytest.raises(ValueError, match=name):
        decoder(data[:i + 1] + bytes([marker]) + data[i + 2:])


@pytest.mark.parametrize("decoder", [decode_jpeg, decode_jpeg_plain],
                         ids=["host_library", "plain"])
def test_jpeg_refuses_dac_dnl_and_12_bit(decoder):
    data = dict((n, d) for n, d, *_ in golden_jpegs())["pil_progressive_420"]
    i = data.index(b"\xff\xc2")
    dac = data[:i] + b"\xff\xcc\x00\x04\x01\x10" + data[i:]
    with pytest.raises(ValueError, match=r"arithmetic coding conditioning \(DAC\)"):
        decoder(dac)
    dnl = data[:i] + b"\xff\xdc\x00\x04\x00\x10" + data[i:]
    with pytest.raises(ValueError, match="DNL"):
        decoder(dnl)
    with pytest.raises(ValueError, match="12-bit"):
        decoder(data[:i + 4] + bytes([12]) + data[i + 5:])


def test_png_refusals():
    z = golden_pngs()
    data = z[0][1]
    with pytest.raises(ValueError, match="bad CRC in a IHDR chunk"):
        decode_png(data[:29] + bytes([data[29] ^ 1]) + data[30:])
    with pytest.raises(ValueError, match="no signature"):
        decode_png(b"\x89PNX" + data[4:])
    with pytest.raises(ValueError, match="premature end"):
        decode_png(data[:40])
    bad_depth = png_bytes(np.zeros((2, 2, 3), np.uint8), 8, 2)
    bad_depth = bad_depth[:24] + bytes([4]) + bad_depth[25:]
    body = bad_depth[12:29]
    bad_depth = bad_depth[:29] + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + bad_depth[33:]
    with pytest.raises(ValueError, match="bit depth 4 with colour type 2"):
        decode_png(bad_depth)
