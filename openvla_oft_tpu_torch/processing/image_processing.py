"""Image preprocessing for the serving and training paths.

Port of `openvla_oft_tpu/processing/image_processing.py`: `device_preprocess`,
`center_crop_resize`, `normalize_and_stack`, `make_device_transform` (the
processor transform: "resize-naive", "resize-crop" and "letterbox"),
`jpeg_roundtrip` and the staged pipeline `prepare_images_for_policy`, which
runs on the policy's device. The reference's eval conditioning: uint8
camera frames -> the JPEG round trip at quality 95 (`processing/jpeg.py`,
libjpeg's integer pipeline as TF runs it) -> lanczos3 antialiased resize
-> round to uint8 -> 0.9-area center crop (bilinear, the reference's
floor(v*255.5) uint8 rule) -> [0, 1] -> the processor transform (bicubic
antialiased resize where the size differs, per-backbone normalize,
backbone stack).

torch has no lanczos mode, and its bicubic antialiased resize is not
`jax.image.resize`'s, so the separable (in, out) weight matrices are built
in numpy from the formula `jax.image.resize(..., antialias=True)` uses (the
kernel widened by 1/scale when downsampling, normalised by its column sums,
zero where the sample falls outside the input) with the lanczos3 kernel or
Keys' cubic kernel (a = -0.5), and applied as fp32 matmuls.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from openvla_oft_tpu_torch.config import OpenVLAConfig
from openvla_oft_tpu_torch.processing import jpeg as _jpeg

_F32 = np.float32


def _lanczos3_kernel(x: np.ndarray) -> np.ndarray:
    radius = _F32(3.0)
    pi = _F32(np.pi)
    y = radius * np.sin(pi * x) * np.sin(pi * x / radius)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > _F32(1e-3),
                       y / np.where(x != 0, _F32(np.pi ** 2) * (x * x), _F32(1.0)),
                       _F32(1.0))
    return np.where(x > radius, _F32(0.0), out)


def _keys_cubic_kernel(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (jax.image's "cubic")."""
    out = ((_F32(1.5) * x - _F32(2.5)) * x) * x + _F32(1.0)
    out = np.where(x >= _F32(1.0),
                   ((_F32(-0.5) * x + _F32(2.5)) * x - _F32(4.0)) * x + _F32(2.0), out)
    return np.where(x >= _F32(2.0), _F32(0.0), out)


_KERNELS = {"lanczos3": _lanczos3_kernel, "cubic": _keys_cubic_kernel}


@functools.lru_cache(maxsize=32)
def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(in_size, out_size) fp32 weights of an antialiased resize, `method`
    "lanczos3" or "cubic" (jax.image's scale_and_translate weights)."""
    inv_scale = _F32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, _F32(1.0))
    sample_f = (np.arange(out_size, dtype=_F32) + _F32(0.5)) * inv_scale - _F32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=_F32)[:, None]) / kernel_scale
    weights = _KERNELS[method](x.astype(_F32)).astype(_F32)
    total = weights.sum(axis=0, keepdims=True, dtype=_F32)
    weights = np.where(np.abs(total) > _F32(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, _F32(1.0)), _F32(0.0))
    inside = (sample_f >= _F32(-0.5)) & (sample_f <= _F32(in_size - 0.5))
    return np.where(inside[None, :], weights, _F32(0.0)).astype(_F32)


def lanczos3_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) fp32 weights of an antialiased lanczos3 resize."""
    return resize_weights(in_size, out_size, "lanczos3")


def resize(x: torch.Tensor, height: int, width: int, method: str) -> torch.Tensor:
    """Float (M, H, W, C) -> (M, height, width, C), antialiased; an axis
    already at its size is left as it is, as in jax.image.resize."""
    _, h, w, _ = x.shape
    if h != height:
        wh = torch.from_numpy(resize_weights(h, height, method)).to(x.device)
        x = torch.einsum("mhwc,hi->miwc", x, wh)
    if w != width:
        ww = torch.from_numpy(resize_weights(w, width, method)).to(x.device)
        x = torch.einsum("mhwc,wj->mhjc", x, ww)
    return x


def resize_lanczos3(x: torch.Tensor, size: int) -> torch.Tensor:
    """Float (M, H, W, C) -> (M, size, size, C), lanczos3 antialiased."""
    return resize(x, size, size, "lanczos3")


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """jnp.linspace's fp32 values as XLA computes them for constant bounds.

    jnp.linspace is start*(1-step) + stop*step with step = i/(num-1). XLA
    rewrites the division as a multiply by r = fl(1/(num-1)), folds stop*r
    into one constant and fuses the sum into a multiply-add:
    fma(i, fl(stop*r), start*(1 - i*r)), with the exact endpoint appended.
    One ulp matters here: the coordinates feed floor().
    """
    start, stop = _F32(start), _F32(stop)
    r = _F32(_F32(1.0) / _F32(num - 1))
    i = np.arange(num - 1, dtype=_F32)
    head = start * (_F32(1.0) - i * r)
    # An fp32 product is exact in fp64, so this rounds once, like an fma.
    out = (i.astype(np.float64) * np.float64(_F32(stop * r))
           + head.astype(np.float64)).astype(_F32)
    return np.concatenate([out, [stop]]).astype(_F32)


@functools.lru_cache(maxsize=16)
def _crop_coords(n: int, crop_scale: float):
    sqrt_s = float(np.sqrt(crop_scale))
    y1 = (1.0 - sqrt_s) / 2.0
    coords = _linspace_f32(y1 * (n - 1), (y1 + sqrt_s) * (n - 1), n)
    i0 = np.floor(coords).astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    w1 = (coords - i0.astype(_F32)).astype(_F32)
    return i0, i1, w1


def center_crop_resize(image: torch.Tensor, crop_scale: float = 0.9) -> torch.Tensor:
    """uint8 (B, H, W, C) -> uint8 (B, H, W, C): the centered crop_scale-area
    box resampled bilinearly back to the input size (tf.image.crop_and_resize
    semantics), then converted to uint8 as floor(v + v/510)."""
    x = image.float()

    def sample_axis(arr, axis):
        i0, i1, w1 = _crop_coords(arr.shape[axis], crop_scale)
        dev = arr.device
        a0 = arr.index_select(axis, torch.from_numpy(i0).to(dev))
        a1 = arr.index_select(axis, torch.from_numpy(i1).to(dev))
        shape = [1] * arr.ndim
        shape[axis] = len(w1)
        w = torch.from_numpy(w1).to(dev).reshape(shape)
        return a0 * (1 - w) + a1 * w

    out = sample_axis(sample_axis(x, 1), 2)
    return torch.clamp(torch.floor(out + out / 510.0), 0, 255).to(torch.uint8)


def normalize_and_stack(cfg: OpenVLAConfig, x01: torch.Tensor) -> torch.Tensor:
    """[0, 1] float (M, S, S, 3) -> (M, n_backbones, S, S, 3), per-backbone
    normalized, order [primary, fused]."""
    outs = []
    for v in cfg.vision_configs:
        mean = torch.tensor(v.mean, dtype=torch.float32, device=x01.device)
        std = torch.tensor(v.std, dtype=torch.float32, device=x01.device)
        outs.append((x01 - mean) / std)
    return torch.stack(outs, dim=1)


def make_device_transform(cfg: OpenVLAConfig):
    """The processor transform (JAX `make_device_transform`): uint8
    (N, H, W, 3) -> (N, n_backbones, S, S, 3) fp32, normalized, keyed off
    `cfg.image_resize_strategy` (reference `processing_prismatic.py:115-123`):
      - "resize-naive": squash-resize to (S, S), bicubic and antialiased;
      - "resize-crop": the shorter side to S (aspect kept), then a center crop;
      - "letterbox": pad to a square (fill = the last backbone's mean * 255,
        as the reference's loop leaves it), then as "resize-crop";
    then [0, 1] -> per-backbone mean/std. Frames already at S are not
    resampled. Other strategies raise, as the reference does (`:122-123`).
    """
    size = cfg.vision_configs[0].image_size
    strategy = getattr(cfg, "image_resize_strategy", "resize-naive")
    if strategy not in ("resize-naive", "resize-crop", "letterbox"):
        raise ValueError(f"image_resize_strategy {strategy!r} is not supported! expected "
                         "'resize-naive', 'resize-crop', or 'letterbox' (reference "
                         "processing_prismatic.py:116-123)")
    fill = torch.tensor([int(m * 255) for m in cfg.vision_configs[-1].mean],
                        dtype=torch.float32) / 255.0

    def transform(images_u8) -> torch.Tensor:
        x = torch.as_tensor(images_u8).float() / 255.0
        n, h, w = x.shape[:3]
        if strategy == "letterbox" and h != w:
            # Symmetric constant border to a (near-)square: torchvision's
            # TVF.pad with int((max - d) / 2) a side; an odd difference leaves
            # the long side 1 px longer, as the reference does.
            hp, vp = (max(h, w) - w) // 2, (max(h, w) - h) // 2
            canvas = fill.to(x.device).expand(n, h + 2 * vp, w + 2 * hp, 3).clone()
            canvas[:, vp:vp + h, hp:hp + w] = x
            x, h, w = canvas, h + 2 * vp, w + 2 * hp
        if h != size or w != size:
            if strategy == "resize-naive":
                nh = nw = size
            else:
                # torchvision Resize(int): the shorter side -> S, the long
                # side truncated in proportion.
                nh, nw = (size, int(size * w / h)) if h <= w else (int(size * h / w), size)
            x = torch.clamp(resize(x, nh, nw, "cubic"), 0.0, 1.0)
            if (nh, nw) != (size, size):
                # torchvision center_crop: top = round((H - S) / 2)
                top, left = int(round((nh - size) / 2.0)), int(round((nw - size) / 2.0))
                x = x[:, top:top + size, left:left + size, :]
        return normalize_and_stack(cfg, x)

    return transform


def device_preprocess(cfg: OpenVLAConfig, images_u8: torch.Tensor,
                      resize_size: int = 224, center_crop: bool = True) -> torch.Tensor:
    """uint8 frames (M, H, W, 3) -> (M, n_backbones, S, S, 3) normalized
    pixels, keeping the staged host path's uint8 roundings."""
    x = resize_lanczos3(images_u8.float(), resize_size)
    x = torch.clamp(torch.round(x), 0, 255)
    if center_crop:
        x = center_crop_resize(x.to(torch.uint8), 0.9)
    return normalize_and_stack(cfg, x.float() / 255.0)


def jpeg_roundtrip(image: np.ndarray, quality: int = 95) -> np.ndarray:
    """JPEG encode and decode of one uint8 (H, W, 3) frame, the artifact the
    reference's eval conditioning adds (openvla_utils.py:516-539), as
    `tf.io.decode_image(tf.io.encode_jpeg(image, quality))` gives it, bit
    for bit: the port's own codec (`processing/jpeg.py`), on the CPU.

    TF's and PIL's encoders write the same coefficients; their decoders
    differ (TF's inverse DCT is libjpeg's IFAST, PIL's the accurate ISLOW,
    up to 5 levels apart), so PIL's round trip is not the reference's."""
    return _jpeg.jpeg_roundtrip(torch.from_numpy(np.ascontiguousarray(image))[None],
                                quality)[0].numpy()


def prepare_images_for_policy(images: Sequence[np.ndarray], cfg: OpenVLAConfig,
                              center_crop: bool = True, use_jpeg_roundtrip: bool = True,
                              resize_size: int = 224, device="cpu") -> torch.Tensor:
    """The staged eval-side pipeline (reference `prepare_images_for_vla`,
    openvla_utils.py:678-708): each frame through the JPEG round trip at
    quality 95, the lanczos3 resize to `resize_size` (rounded to uint8) and
    the optional 0.9 center crop, then the processor transform, all on
    `device`; frames of one shape go through as one batch.
    (N, n_backbones, S, S, 3) fp32 normalized pixels on `device`."""
    frames = []
    for img in images:
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        frames.append(img)
    conditioned = [None] * len(frames)
    for shape in dict.fromkeys(f.shape for f in frames):
        idx = [i for i, f in enumerate(frames) if f.shape == shape]
        x = torch.from_numpy(np.stack([frames[i] for i in idx])).to(device)
        if use_jpeg_roundtrip:
            x = _jpeg.jpeg_roundtrip(x)
        x = torch.clamp(torch.round(resize_lanczos3(x.float(), resize_size)), 0, 255)
        x = x.to(torch.uint8)
        if center_crop:
            x = center_crop_resize(x, 0.9)
        for i, xi in zip(idx, x):
            conditioned[i] = xi
    return make_device_transform(cfg)(torch.stack(conditioned))
