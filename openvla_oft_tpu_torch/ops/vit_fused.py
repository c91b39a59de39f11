"""Fused LayerNorm + matmul (+ activation) for the ViT serving path: kernel K4.

Port of `openvla_oft_tpu/ops/vit_fused.py`. The TPU kernel `_kernel` (:47)
becomes the CUDA kernel in `csrc/ln_matmul.cu`:

    y[i, j] = act(standardize(x[i, :]) @ w[:, j] + b[j])

where standardize is LayerNorm without its affine (the affine is folded into
w and b by `models/vit.py::fuse_vit_inference_weights`). Used for the ViT
qkv projection (no activation) and the MLP fc1 (the backbone's GELU).

x (..., M, D), w (D, N) (a layer view of a stacked kernel is fine), b (N,)
or None -> (..., M, N) in x's dtype. A CUDA tensor goes to K4 (bf16 x, w and
b only) or raises; a CPU tensor goes to the plain version `ln_matmul_ref`.
There is no fallback between them. `ln_matmul.launches` counts the launches;
`ln_matmul.last_plan` is the (BM, BN, CTAs) of the last one, from `_k4_plan`.

The switch: the JAX package reads `OPENVLA_VIT_FUSED` from the environment at
trace time. The port reads no environment variable: the caller chooses once
(`OpenVLAPolicy.vit_fused`, `serve_action_chunk(vit_fused=...)`) and the
choice reaches `models/vit.py::_ln_linear` through the `vit_fused` context
below. The default is off, as in the JAX package. The TPU wrapper's block
knobs (`OPENVLA_VIT_FUSED_BM`, `_BN`) do not carry over: `_k4_plan` picks
the kernel's tile per launch.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

import torch

EPS = 1e-6
ACTS = (None, "gelu", "gelu_tanh", "quick_gelu")

_VIT_FUSED = contextvars.ContextVar("vit_fused", default=False)


@contextlib.contextmanager
def vit_fused(enabled: bool = True):
    """Inside this block, the ViTs' folded LN -> qkv and LN -> fc1 (+ GELU)
    run as one `ln_matmul` each (kernel K4 on CUDA)."""
    token = _VIT_FUSED.set(bool(enabled))
    try:
        yield
    finally:
        _VIT_FUSED.reset(token)


def vit_fused_enabled() -> bool:
    return _VIT_FUSED.get()


def _activate(acc: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The kernel's activations on an fp32 tensor. gelu is exact erf (the TPU
    kernel's A&S 7.1.26 polynomial stands in for erf only because Mosaic has
    none; the two differ by less than 1.5e-7); gelu_tanh takes tanh in the
    exp form 1 - 2/(e^{2z}+1)."""
    if act is None:
        return acc
    if act == "gelu":
        return acc * 0.5 * (1.0 + torch.erf(acc / 1.4142135623730951))
    if act == "gelu_tanh":
        z = 0.7978845608028654 * (acc + 0.044715 * acc * acc * acc)
        return 0.5 * acc * (1.0 + (1.0 - 2.0 / (torch.exp(2.0 * z) + 1.0)))
    if act == "quick_gelu":
        return acc * torch.sigmoid(1.702 * acc)
    raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def ln_matmul_ref(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  act: Optional[str] = None, eps: float = EPS) -> torch.Tensor:
    """Plain K4: the kernel's own formula. Row statistics in fp32 with var =
    E[x^2] - mean^2; the standardized x rounded to x's dtype; the product in
    fp32; the bias added and the activation applied in fp32; one rounding."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    normed = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    acc = torch.matmul(normed.float(), w.float())
    if b is not None:
        acc = acc + b.float()
    return _activate(acc, act).to(x.dtype)


# K4's compiled tiles (`csrc/ln_matmul.cu`, one instance each): rows x columns
# of y per CTA, largest first; the depth of a stage and the card's SM count.
K4_TILES = ((128, 256), (128, 192), (128, 128), (64, 128))
K4_BK, K4_SMS = 64, 132
# A CTA's rate on its tile relative to the 128 x 256 tile's, per SM: a CTA's
# prologue statistics and its ring's x rows cost the same at every width, so
# narrower tiles do less per byte (fitted to the tile sweep of
# scripts/exp_k4_parts.py on the card, PERF.md).
_K4_RATE = {(128, 256): 1.0, (128, 192): 0.9, (128, 128): 0.65, (64, 128): 0.45}


@functools.lru_cache(maxsize=256)
def _k4_plan(m: int, d: int, n: int) -> tuple:
    """K4's launch (BM, BN, grid CTAs) for x (m, d) and w (d, n): one CTA per
    BM x BN tile of y, one wave of the card's SMs at a time, each CTA over
    all of d. Among the tiles whose grid fills at least 3/4 of a wave (all
    tiles, where none does), the least estimated time: waves x stages x
    BM x BN / the tile's rate; a tie goes to the larger tile."""
    best = None
    for bm, bn in K4_TILES:
        ctas = -(-m // bm) * -(-n // bn)
        est = -(-ctas // K4_SMS) * -(-d // K4_BK) * bm * bn / _K4_RATE[(bm, bn)]
        key = (ctas < 0.75 * K4_SMS, est)
        if best is None or key < best[0]:
            best = (key, (bm, bn, ctas))
    return best[1]


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether K4's TMA copies can read the 2-D bf16 tensor `t` as it is:
    contiguous rows, a 16-byte aligned base and a row stride of a multiple
    of 16 bytes. Otherwise the wrapper hands K4 a padded copy (`_padded`)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and (t.stride(0) * t.element_size()) % 16 == 0)


def _padded(t: torch.Tensor) -> torch.Tensor:
    """A copy of the 2-D `t` whose rows are padded with zeros to a multiple
    of 16 bytes; K4 reads only its first t.shape[1] columns."""
    per = 16 // t.element_size()
    out = t.new_zeros((t.shape[0], -(-t.shape[1] // per) * per))
    out[:, :t.shape[1]] = t
    return out


def _launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], act: Optional[str],
            eps: float, tile: Optional[tuple] = None) -> torch.Tensor:
    """K4 on x's device, with the plan's tile, or with `tile` (BM, BN), one
    of K4_TILES (the parts script's tile sweep)."""
    from openvla_oft_tpu_torch import _build

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        raise NotImplementedError("ln_matmul (K4) is a serving kernel and has no backward")
    for t, what in ((x, "x"), (w, "w"), (b, "b")):
        if t is not None and t.dtype != torch.bfloat16:
            raise TypeError(f"ln_matmul (K4) takes bfloat16 x, w and b; {what} is {t.dtype}")
        if t is not None and t.device != x.device:
            raise ValueError(f"ln_matmul (K4): {what} is on {t.device}, x on {x.device}")
    d, n = w.shape
    if w.stride(-1) != 1 or w.stride(0) < n:
        raise ValueError(f"ln_matmul (K4): w needs contiguous rows (a layer or column "
                         f"view is fine), got strides {w.stride()}")
    x2 = x.reshape(-1, d).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    bias = None if b is None else b.contiguous()
    if not _tma_ready(x2):
        x2 = _padded(x2)
    if not _tma_ready(w):
        w = _padded(w)
    plan = _k4_plan(m, d, n)
    if tile is not None:
        if tile not in K4_TILES:
            raise ValueError(f"ln_matmul (K4) compiles the tiles {K4_TILES}, not {tile}")
        plan = (*tile, -(-m // tile[0]) * -(-n // tile[1]))
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.openvla_ln_matmul(
            x2.data_ptr(), w.data_ptr(), 0 if bias is None else bias.data_ptr(), out.data_ptr(),
            m, d, n, x2.stride(0), w.stride(0), ACTS.index(act), eps, plan[0], plan[1], stream)
    _build.check_launch(err, "ln_matmul (K4)")
    ln_matmul.launches += 1
    ln_matmul.last_plan = plan
    return out


def ln_matmul(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
              act: Optional[str] = None, eps: float = EPS) -> torch.Tensor:
    """act(standardize(x) @ w + b): K4 on CUDA, the plain version on the CPU."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if w.ndim != 2 or x.shape[-1] != w.shape[0] or (b is not None and b.shape != w.shape[1:]):
        raise ValueError(f"ln_matmul: x {tuple(x.shape)}, w {tuple(w.shape)} and b "
                         f"{None if b is None else tuple(b.shape)} do not fit")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"ln_matmul runs on CUDA or CPU, not {x.device}")
        return ln_matmul_ref(x, w, b, act, eps)
    out = _launch(x, w, b, act, eps)
    return out.reshape(*x.shape[:-1], w.shape[1])


ln_matmul.launches = 0
ln_matmul.last_plan = None
