"""Training-frame augmentation: the port's `_augment_image`
(`openvla_oft_tpu/data/rlds/pipeline.py:133-154`; reference aug kwargs,
`prismatic/vla/datasets/datasets.py:159-173`), split into the draws and a
deterministic function of (image, draws).

TF draws from its own stateless generator, which the port does not
reproduce: `draw_augmentation` takes a numpy Generator. Given TF's draws,
`augment_image` follows TF's ops stage by stage, on the host in float32:

  1. crop (sqrt(0.9) of each side, `int(h * 0.94868)`: 242 of 256) at the
     drawn offset (`stateless_random_crop`);
  2. lanczos3 antialiased resize back to (h, w) (`tf.image.resize`, TF's
     ScaleAndTranslate kernel: float32 weights over each output's span,
     normalized, gathered along the columns, then the rows), rounded half
     to even and clipped to uint8;
  3. brightness: + delta in [-0.2, 0.2) (`adjust_brightness`);
  4. contrast: mean + f (x - mean) per channel, f in [0.8, 1.2), the mean
     summed by TF's halving folds (`adjust_contrastv2`);
  5. saturation: HSV, s * f clamped to [0, 1], f in [0.8, 1.2)
     (`adjust_saturation`);
  6. hue: + delta * 6 on TF's hue-and-range form, delta in [-0.05, 0.05)
     (`adjust_hue`).

Each TF op converts uint8 to float32 (x * float32(1 / 255)) and back
(x * 255.5, truncated; brightness and contrast clamp to [0, 255] first),
and so does this function, at the same places.

`augment_image` runs in the host library (`hostsrc/augment.cc`, the
loader's, without the GIL); `augment_image_plain` is its numpy plain
version, the same float32 operations in the same order, which the tests
hold it to bit for bit.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np

_F = np.float32
_INV255 = _F(1.0 / 255)
CROP_SCALE = 0.94868                       # sqrt(0.9), as `int(h * 0.94868)`


def crop_size(height: int, width: int):
    """(ch, cw) of the crop; an image too small to keep a pixel raises."""
    ch, cw = int(_F(height) * _F(CROP_SCALE)), int(_F(width) * _F(CROP_SCALE))
    if ch < 1 or cw < 1:
        raise ValueError(f"a {height} x {width} image is too small to crop")
    return ch, cw


def draw_augmentation(rng: np.random.Generator, height: int, width: int) -> Dict:
    """One frame's draws: the crop offset, then brightness, contrast,
    saturation and hue, each uniform over TF's range."""
    ch, cw = crop_size(height, width)
    return {"crop": (int(rng.integers(0, height - ch + 1)), int(rng.integers(0, width - cw + 1))),
            "brightness": _F(rng.uniform(-0.2, 0.2)),
            "contrast": _F(rng.uniform(0.8, 1.2)),
            "saturation": _F(rng.uniform(0.8, 1.2)),
            "hue": _F(rng.uniform(-0.05, 0.05))}


def _lanczos3(x: float) -> np.float32:
    """sampling_kernels.h LanczosKernelFunc(3) in float32."""
    x = abs(_F(x))
    if x > 3:
        return _F(0)
    if x <= _F(1e-3):
        return _F(1)
    pi = _F(3.14159265359)
    sin = lambda v: _F(math.sin(float(v)))    # noqa: E731
    return _F(3) * sin(pi * x) * sin(pi * x / _F(3)) / (pi * pi * x * x)


@functools.lru_cache(maxsize=16)
def _spans(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """scale_and_translate_op.cc ComputeSpansCore for lanczos3, antialiased,
    no translation: (starts (out,), weights (out, span) float32, zero past
    each span's real end)."""
    scale = _F(out_size) / _F(in_size)
    inv_scale = _F(1.0 / float(scale))
    kernel_scale = max(inv_scale, _F(1))
    span = min(2 * int(math.ceil(3 * float(kernel_scale))) + 1, in_size)
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, span), _F)
    for x in range(out_size):
        sample = _F(_F(x) + _F(0.5)) * inv_scale
        if sample < 0 or sample > in_size:
            continue
        lo = math.ceil(float(sample - _F(3) * kernel_scale - _F(0.5)))
        hi = math.floor(float(sample + _F(3) * kernel_scale - _F(0.5)))
        lo, hi = min(max(lo, 0), in_size - 1), min(max(hi, 0), in_size - 1) + 1
        ws = [_lanczos3((_F(src) + _F(0.5) - sample) * (_F(1) / kernel_scale))
              for src in range(lo, hi)]
        total = _F(0)
        for w in ws:
            total = _F(total + w)
        if abs(total) >= _F(1000) * np.finfo(_F).tiny:
            inv = _F(1) / total
            weights[x, :len(ws)] = [_F(w * inv) for w in ws]
        starts[x] = lo
    starts.flags.writeable = weights.flags.writeable = False   # shared by the cache
    return starts, weights


def _gather(x: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One axis of the ScaleAndTranslate gather: each output the float32
    sum, in span order, of weight * input."""
    starts, weights = _spans(x.shape[axis], out_size)
    x = np.moveaxis(x, axis, 0)
    out = np.zeros((out_size,) + x.shape[1:], _F)
    idx = np.arange(out_size)
    for k in range(weights.shape[1]):
        src = np.minimum(starts + k, x.shape[0] - 1)   # weight 0 past the span
        out += weights[:, k].reshape((-1,) + (1,) * (x.ndim - 1)) * x[src[idx]]
    return np.moveaxis(out, 0, axis)


def _to_float(x: np.ndarray) -> np.ndarray:
    return x.astype(_F) * _INV255


def _to_uint8(x: np.ndarray, saturate: bool) -> np.ndarray:
    x = x * _F(255.5)
    if saturate:
        x = np.clip(x, _F(0), _F(255))
    return x.astype(np.uint8)


def _channel_mean(x: np.ndarray) -> np.ndarray:
    """(N, C) -> (C,): TF's ReduceMeanAcrossImage, the rows folded in half
    until one is left, times float32(1 / N)."""
    n = x.shape[0]
    right = n // 2
    left = n - right
    s = x[left:left + right] + x[:right]
    if left > right:
        s = np.concatenate([s, x[right:right + 1]])
    n = left
    while n > 1:
        right = n // 2
        left = n - right
        s[:right] += s[left:left + right]
        n = left
    return s[0] * (_F(1) / _F(x.shape[0]))


def _saturation(f: np.ndarray, scale: np.float32) -> np.ndarray:
    """adjust_saturation_op.cc: rgb_to_hsv, s * scale clamped, hsv_to_rgb."""
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    v = np.maximum(r, np.maximum(g, b))
    span = v - np.minimum(r, np.minimum(g, b))
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(v > 0, span / v, _F(0)).astype(_F)
        norm = _F(1) / (_F(6) * span)
        h = np.where(r == v, norm * (g - b),
                     np.where(g == v, (norm * (b - r)).astype(np.float64) + 2.0 / 6.0,
                              (norm * (r - g)).astype(np.float64) + 4.0 / 6.0)).astype(_F)
    h = np.where(span <= 0, _F(0), h)
    h = np.where(h < 0, h + _F(1), h)
    s = np.minimum(_F(1), np.maximum(_F(0), s * scale))
    c = s * v
    m = v - c
    dh = h * _F(6)
    cat = dh.astype(np.int32)
    fmodu = np.fmod(dh, _F(2))
    x = c * (_F(1) - np.abs(fmodu - _F(1)))
    z = np.zeros_like(c)
    cats = [cat == k for k in range(6)]                  # any other category is 0
    rr = np.select(cats, [c, x, z, z, x, c], z)
    gg = np.select(cats, [x, c, c, x, z, z], z)
    bb = np.select(cats, [z, z, x, c, c, x], z)
    return np.stack([rr + m, gg + m, bb + m], -1)


def _hue(f: np.ndarray, delta: np.float32) -> np.ndarray:
    """adjust_hue_op.cc: rgb_to_hv_range, h + delta * 6 wrapped to [0, 6),
    hv_range_to_rgb."""
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    rg = r < g
    conds = [rg & (b < r), rg & (b > g), rg, b < g, b > r]
    vmax = np.select(conds, [g, b, g, r, b], r)
    vmid = np.select(conds, [r, g, b, g, r], b)
    vmin = np.select(conds, [b, r, r, b, g], g)
    cat = np.select(conds, [1, 3, 2, 0, 4], 5).astype(np.int32)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (vmid - vmin) / (vmax - vmin)
    h = cat.astype(_F) + np.where(cat % 2 == 0, ratio, _F(1) - ratio)
    h = np.where(vmax == vmin, _F(0), h).astype(_F)
    h = h + delta * _F(6)
    h = np.where(h < 0, h + _F(6), h)
    h = np.where(h >= 6, h - _F(6), h)
    cat = h.astype(np.int32)
    ratio = h - cat.astype(_F)
    ratio = np.where(cat % 2 == 0, ratio, _F(1) - ratio)
    vmid = vmin + ratio * (vmax - vmin)
    cats = [cat == k for k in range(5)]                  # category 5 is the default
    rr = np.select(cats, [vmax, vmid, vmin, vmin, vmid], vmax)
    gg = np.select(cats, [vmid, vmax, vmax, vmid, vmin], vmin)
    bb = np.select(cats, [vmin, vmin, vmid, vmax, vmax], vmid)
    return np.stack([rr, gg, bb], -1)


def augment_image(img: np.ndarray, draws: Dict) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (H, W, 3): TF's augmentation stages given
    `draws` (see the module docstring), by the host library."""
    from openvla_oft_tpu_torch._host_build import library

    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    ch, cw = crop_size(h, w)
    oy, ox = (int(v) for v in draws["crop"])
    if not (0 <= oy <= h - ch and 0 <= ox <= w - cw):
        raise ValueError(f"crop offset {(oy, ox)} out of range for {(h, w)}")
    col_starts, col_w = _spans(cw, w)
    row_starts, row_w = _spans(ch, h)
    out = np.empty_like(img)
    library().openvla_augment_image(
        img.ctypes.data, h, w, oy, ox, ch, cw, *(float(_F(draws[k])) for k in (
            "brightness", "contrast", "saturation", "hue")),
        col_starts.ctypes.data, col_w.ctypes.data, col_w.shape[1],
        row_starts.ctypes.data, row_w.ctypes.data, row_w.shape[1], out.ctypes.data)
    return out


def augment_image_plain(img: np.ndarray, draws: Dict) -> np.ndarray:
    """The numpy plain version of `augment_image`."""
    h, w, _ = img.shape
    ch, cw = crop_size(h, w)
    oy, ox = draws["crop"]
    x = _gather(_gather(img[oy:oy + ch, ox:ox + cw].astype(_F), 1, w), 0, h)
    img = np.clip(np.round(x), 0, 255).astype(np.uint8)
    img = _to_uint8(_to_float(img) + draws["brightness"], saturate=True)
    f = _to_float(img)
    mean = _channel_mean(f.reshape(-1, 3))
    img = _to_uint8(mean + draws["contrast"] * (f - mean), saturate=True)
    img = _to_uint8(_saturation(_to_float(img), draws["saturation"]), saturate=False)
    return _to_uint8(_hue(_to_float(img), draws["hue"]), saturate=False)
