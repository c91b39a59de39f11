"""Int4 weight quantization and the int4 linear (the reference's
`load_in_4bit` analog).

Port of the int4 half of `openvla_oft_tpu/ops/quant.py`: group-wise
symmetric 4-bit weights packed two per int8 byte (`quantize_weight_int4`),
`int4_linear` with the JAX package's dispatch rule, and `quantize_tree`.
Packing: byte row i of `kernel_q4` (in/2, out) holds weight row 2i in its
low nibble and row 2i+1 in its high nibble; `scale_w4` (in/group, out) is
fp32.

W4A16 or W4A8. The JAX package reads `OPENVLA_INT4_A8` from the environment
at trace time. The port reads no environment variable: the caller chooses
once (`OpenVLAPolicy.int4_a8`, `serve_action_chunk(int4_a8=...)`) and the
choice reaches `int4_linear` through the `int4_a8` context below. The default
is W4A16.

int8 (`bits=8`) is not ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict

import torch

Params = Dict[str, Any]

INT4_GROUP = 128

# Subtrees never quantized: the output head's kernel is consumed directly by
# lm_logits, and bitsandbytes (the reference analog) keeps it high precision.
_QUANT_EXCLUDE = frozenset({"lm_head"})

# The fused kernels take at most this many rows (x's leading dims flattened);
# larger batches go to the dequant path. A TPU crossover in the JAX package,
# kept as its shape rule.
FUSED_MAX_ROWS = 1024

_INT4_A8 = contextvars.ContextVar("int4_a8", default=False)


@contextlib.contextmanager
def int4_a8(enabled: bool = True):
    """Inside this block, int4 linears that take a fused kernel run W4A8
    (kernel K6, per-token int8 activations) instead of W4A16 (K5)."""
    token = _INT4_A8.set(bool(enabled))
    try:
        yield
    finally:
        _INT4_A8.reset(token)


def _int4_group_for(d_in: int, group: int = INT4_GROUP) -> int:
    """Largest even divisor of d_in that is <= the requested group size; 0
    when d_in is odd (two per byte cannot pack it)."""
    if d_in % 2:
        return 0
    g = min(group, d_in)
    while g > 2 and (d_in % g or g % 2):
        g -= 1
    return g


def quantize_weight_int4(w: torch.Tensor, group: int = INT4_GROUP) -> Dict[str, torch.Tensor]:
    """(..., in, out) float -> {"kernel_q4": int8 (..., in/2, out),
    "scale_w4": fp32 (..., in/group', out)}, group' from `_int4_group_for`.
    The arithmetic is the JAX version's, so the bytes and scales are equal."""
    *lead, d_in, d_out = w.shape
    group = _int4_group_for(d_in, group)
    if not group:
        raise ValueError(f"int4 packing needs an even d_in, got {d_in}")
    wf = w.float().reshape(*lead, d_in // group, group, d_out)
    scale = wf.abs().amax(dim=-2, keepdim=True) / 7.0
    q = torch.clamp(torch.round(wf / torch.clamp(scale, min=1e-12)), -7, 7).to(torch.int8)
    q = q.reshape(*lead, d_in, d_out).to(torch.int32)
    packed = ((q[..., 1::2, :] & 0xF) << 4) | (q[..., 0::2, :] & 0xF)   # 0..255
    packed = torch.where(packed > 127, packed - 256, packed).to(torch.int8)
    return {"kernel_q4": packed, "scale_w4": scale[..., 0, :].reshape(*lead, d_in // group, d_out)}


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8 (..., in/2, out) -> int8 (..., in, out), sign-extended nibbles."""
    w = packed.to(torch.int32)
    low = (w << 28) >> 28                                 # sign-extend the low nibble
    high = w >> 4                                         # arithmetic shift
    *lead, half, d_out = packed.shape
    return torch.stack([low, high], dim=-2).reshape(*lead, half * 2, d_out).to(torch.int8)


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(in/2, out) packed and (G, out) scales -> the (in, out) weight:
    nibble x scale in fp32, then one rounding to `dtype`."""
    q = _unpack_int4(packed).float()
    d_in, d_out = q.shape[-2:]
    groups = scales.shape[-2]
    w = q.reshape(*q.shape[:-2], groups, d_in // groups, d_out) * scales.float()[..., None, :]
    return w.reshape(q.shape).to(dtype)


def int4_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(kernel_q4, scale_w4) (+ bias), in x's dtype.

    The JAX package's dispatch: one layer's 2-D weight (a view included), at
    most FUSED_MAX_ROWS rows of x, and half-groups g2 = group / 2 that are a
    multiple of 8 take the fused kernels (`ops/int4_matmul.py`: K5, or K6
    inside `int4_a8()`); otherwise the whole weight is dequantized first
    (`int4_matmul_ref`, W4A16 in either mode, as in the JAX package). Scales
    and packed bytes get no gradient; x does (straight through the
    dequantized weight). The bias adds in fp32.
    """
    from openvla_oft_tpu_torch.ops import int4_matmul as M

    packed, scales = p["kernel_q4"], p["scale_w4"].detach()
    if packed.ndim != 2:
        raise ValueError(f"int4_linear takes one layer's (in/2, out) weight, got "
                         f"{tuple(packed.shape)}; index stacked layers first "
                         "(bridge.index_layer)")
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if rows <= FUSED_MAX_ROWS and (packed.shape[0] // scales.shape[0]) % 8 == 0:
        fn = M.int4_matmul_fused_a8 if _INT4_A8.get() else M.int4_matmul_fused
        y = fn(x, packed, scales)
    else:
        y = M.int4_matmul_ref(x, packed, scales)
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def _is_quantizable(node: dict, min_dim: int) -> bool:
    k = node.get("kernel")
    return (isinstance(k, torch.Tensor) and k.ndim >= 2 and k.is_floating_point()
            and k.shape[-2] >= min_dim and k.shape[-2] % 2 == 0)


def _quantize_leaf(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """quantize_weight_int4 one leading slice (one stacked layer) at a time,
    so the fp32 temporary stays one layer large."""
    if kernel.ndim == 2:
        return quantize_weight_int4(kernel)
    *lead, d_in, d_out = kernel.shape
    group = _int4_group_for(d_in)
    flat = kernel.reshape(-1, d_in, d_out)
    packed = torch.empty((flat.shape[0], d_in // 2, d_out), dtype=torch.int8,
                         device=kernel.device)
    scales = torch.empty((flat.shape[0], d_in // group, d_out), dtype=torch.float32,
                         device=kernel.device)
    for i in range(flat.shape[0]):
        q = quantize_weight_int4(flat[i])
        packed[i], scales[i] = q["kernel_q4"], q["scale_w4"]
    return {"kernel_q4": packed.reshape(*lead, d_in // 2, d_out),
            "scale_w4": scales.reshape(*lead, d_in // group, d_out)}


def quantize_tree(params: Params, min_dim: int = 1024, bits: int = 4) -> Params:
    """Quantize every 'kernel' leaf whose contraction dim (shape[-2]) is at
    least `min_dim` and even: the kernel is replaced by kernel_q4/scale_w4.
    Norm scales, biases, embeddings, small projections and `lm_head` stay.
    Returns a new tree; the caller drops the old one to free its kernels."""
    if bits == 8:
        raise NotImplementedError("int8 quantization is not ported yet "
                                  "(ROADMAP queue 1, item 9)")
    if bits != 4:
        raise ValueError(f"bits must be 4 (or 8, not ported yet), got {bits}")

    def visit(node, name=""):
        if isinstance(node, dict):
            if name in _QUANT_EXCLUDE:
                return node
            if _is_quantizable(node, min_dim):
                out = {k: v for k, v in node.items() if k != "kernel"}
                out.update(_quantize_leaf(node["kernel"]))
                return out
            return {k: visit(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        return node

    return visit(params)
