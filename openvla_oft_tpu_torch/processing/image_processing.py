"""Device image preprocessing for the serving and training paths.

Port of `openvla_oft_tpu/processing/image_processing.py::device_preprocess`,
`center_crop_resize`, `normalize_and_stack` and (for frames already at the
backbone's size) `make_device_transform`. Serving: uint8 camera frames ->
lanczos3 antialiased resize -> round to uint8 -> 0.9-area center crop
(bilinear, the reference's floor(v*255.5) uint8 rule) -> [0, 1] -> per-backbone
normalize -> backbone stack.

torch has no lanczos mode, so the separable (in, out) weight matrices are
built in numpy from the formula `jax.image.resize(..., "lanczos3",
antialias=True)` uses (kernel widened by 1/scale when downsampling,
normalised by its column sums, zero where the sample falls outside the input)
and applied as two fp32 matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openvla_oft_tpu_torch.config import OpenVLAConfig

_F32 = np.float32


@functools.lru_cache(maxsize=16)
def lanczos3_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) fp32 weights of an antialiased lanczos3 resize."""
    radius = _F32(3.0)
    inv_scale = _F32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, _F32(1.0))
    sample_f = (np.arange(out_size, dtype=_F32) + _F32(0.5)) * inv_scale - _F32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=_F32)[:, None]) / kernel_scale
    pi = _F32(np.pi)
    y = radius * np.sin(pi * x) * np.sin(pi * x / radius)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > _F32(1e-3),
                       y / np.where(x != 0, _F32(np.pi ** 2) * (x * x), _F32(1.0)),
                       _F32(1.0))
    weights = np.where(x > radius, _F32(0.0), out).astype(_F32)
    total = weights.sum(axis=0, keepdims=True, dtype=_F32)
    weights = np.where(np.abs(total) > _F32(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, _F32(1.0)), _F32(0.0))
    inside = (sample_f >= _F32(-0.5)) & (sample_f <= _F32(in_size - 0.5))
    return np.where(inside[None, :], weights, _F32(0.0)).astype(_F32)


def resize_lanczos3(x: torch.Tensor, size: int) -> torch.Tensor:
    """Float (M, H, W, C) -> (M, size, size, C); an axis already at `size`
    is left as it is, as in jax.image.resize."""
    _, h, w, _ = x.shape
    if h != size:
        wh = torch.from_numpy(lanczos3_weights(h, size)).to(x.device)
        x = torch.einsum("mhwc,hi->miwc", x, wh)
    if w != size:
        ww = torch.from_numpy(lanczos3_weights(w, size)).to(x.device)
        x = torch.einsum("mhwc,wj->mhjc", x, ww)
    return x


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
    """The training image transform (JAX `make_device_transform`): uint8
    (N, H, W, 3) -> (N, n_backbones, S, S, 3) fp32, normalized.

    Ported for "resize-naive" on frames already at the backbone's size
    (what the dummy dataset and RLDS frames resized by the loader give):
    [0, 1] -> per-backbone normalize. Resizing and the other strategies
    raise (ROADMAP queue 1, item 7).
    """
    size = cfg.vision_configs[0].image_size
    strategy = getattr(cfg, "image_resize_strategy", "resize-naive")
    if strategy != "resize-naive":
        raise NotImplementedError(f"image_resize_strategy {strategy!r} is not "
                                  "ported yet (ROADMAP queue 1, item 7)")

    def transform(images_u8) -> torch.Tensor:
        x = torch.as_tensor(images_u8)
        if tuple(x.shape[1:3]) != (size, size):
            raise NotImplementedError(
                f"frames of {tuple(x.shape[1:3])} need a resize to {size}, which "
                "the training transform does not port yet (ROADMAP queue 1, item 7)")
        return normalize_and_stack(cfg, x.float() / 255.0)

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
