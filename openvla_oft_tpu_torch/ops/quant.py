"""Weight quantization and the quantized linears: int8 (the reference's
`load_in_8bit` analog) and int4 (`load_in_4bit`).

Port of `openvla_oft_tpu/ops/quant.py`.

int8, W8A8: symmetric per-output-channel int8 weights (`quantize_weight`,
fp32 `scale_w` (out,)) and int8 activations, per token (dynamic) or with a
calibrated per-layer scalar `scale_x` (static, `ops/quant_calibrate.py`).
The product is exact in int32 and is the library's `torch._int_mm`
(`int8_mm`), as the JAX package leaves it to XLA's `dot_general`; the
activation quantize and the epilogue are eager ops around it:

    y[t, o] = (sum_k qx[t, k] * qw[k, o]) * sx[t] * sw[o]

An int8 kernel is logically (in, out), stacked (L, in, out), but stored
transposed, (out, in) in memory: CUDA `torch._int_mm` runs that
column-major weight several times faster than a row-major one (on the
H100, `chip_smoke.py` phase 8b times both; PERF.md keeps the numbers), and
layer views (`bridge.index_layer`) and column views (the `out_window`
layer's q/k/v) of it stay column-major, so they reach `torch._int_mm`
without a copy.

int4: group-wise symmetric 4-bit weights packed two per int8 byte
(`quantize_weight_int4`) and `int4_linear` with the JAX package's dispatch
rule. Packing: byte row i of `kernel_q4` (in/2, out) holds weight row 2i in
its low nibble and row 2i+1 in its high nibble; `scale_w4` (in/group, out)
is fp32.

W4A16 or W4A8. The JAX package reads `OPENVLA_INT4_A8` from the environment
at trace time. The port reads no environment variable: the caller chooses
once (`OpenVLAPolicy.int4_a8`, `serve_action_chunk(int4_a8=...)`) and the
choice reaches `int4_linear` through the `int4_a8` context below. The default
is W4A16.
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


# === int8 ===

# CUDA torch._int_mm takes more than 16 rows of x; fewer are padded with zero
# rows, which add nothing to the product.
INT_MM_MIN_ROWS = 17


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d by IEEE division on every device. CUDA computes a tensor divided
    by a Python number as a * fl(1/d), an ulp off in some elements, so the
    card's codes and scales would differ from the CPU's and the JAX
    package's; a 0-d tensor on a's device keeps the division."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def empty_int8_kernel(shape: tuple, device) -> torch.Tensor:
    """An uninitialised int8 kernel of logical shape (..., in, out) in the
    serving layout: (..., out, in) in memory, handed out as its (in, out)
    view."""
    *lead, d_in, d_out = shape
    return torch.empty((*lead, d_out, d_in), dtype=torch.int8,
                       device=device).transpose(-1, -2)


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., in, out) float -> {"kernel": int8 (..., in, out), "scale_w":
    fp32 (..., out)}: per output channel, scale = absmax / 127, then round
    half to even and clip to +-127, the JAX arithmetic step for step, so the
    codes and scales are equal bit for bit. One leading slice (one stacked
    layer) at a time, so the fp32 temporaries stay one layer large. The
    kernel comes in the serving layout (`empty_int8_kernel`)."""
    *lead, d_in, d_out = w.shape
    kernel = empty_int8_kernel(w.shape, w.device)
    scale_w = torch.empty((*lead, d_out), dtype=torch.float32, device=w.device)
    flat_w, flat_k = w.reshape(-1, d_in, d_out), kernel.reshape(-1, d_in, d_out)
    flat_s = scale_w.reshape(-1, d_out)
    for i in range(flat_w.shape[0]):
        wf = flat_w[i].float()
        scale = _div(wf.abs().amax(dim=-2, keepdim=True), 127.0)
        flat_k[i] = torch.clamp(torch.round(wf / torch.clamp(scale, min=1e-12)), -127, 127)
        flat_s[i] = scale[0]
    return {"kernel": kernel, "scale_w": scale_w}


def quantize_act_rows(x2: torch.Tensor):
    """Per-token symmetric int8 (the JAX `_int8_matmul`'s and
    `_quantize_act_rows`'s): sx = absmax / 127, round half to even, clip to
    +-127. Returns (int8 (T, K), fp32 (T, 1)). The W8A8 linear and K6's
    wrapper both quantize x with it."""
    xf = x2.float()
    sx = _div(xf.abs().amax(dim=-1, keepdim=True), 127.0)
    q = torch.clamp(torch.round(xf / torch.clamp(sx, min=1e-12)), -127, 127)
    return q.to(torch.int8), sx


def int8_mm(x8: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """(T, K) int8 @ (K, N) int8 -> (T, N) int32, exact: the library's
    `torch._int_mm`, on the card and on the CPU. Fewer than INT_MM_MIN_ROWS
    rows are padded with zero rows (CUDA refuses them; exact either way).
    On CUDA, K and N must be multiples of 8: there is no float fallback.
    `int8_mm.launches` counts the products."""
    t, k = x8.shape
    n = kernel.shape[-1]
    if x8.is_cuda and (k % 8 or n % 8):
        raise ValueError(f"int8_mm: CUDA torch._int_mm takes K and N that are multiples "
                         f"of 8, got K={k}, N={n}")
    if t < INT_MM_MIN_ROWS:
        x8 = torch.cat([x8, x8.new_zeros((INT_MM_MIN_ROWS - t, k))])
    out = torch._int_mm(x8, kernel)
    int8_mm.launches += 1
    return out[:t]


int8_mm.launches = 0


def int8_mm_ref(x8: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain `int8_mm`: the int8 operands multiplied as float64, which is
    exact (|sum| <= 127 * 127 * K < 2**53), rounded to int32."""
    return torch.matmul(x8.double(), kernel.double()).round().to(torch.int32)


def _int8_forward(x, kernel, scale_w, scale_x) -> torch.Tensor:
    """The JAX `_int8_matmul` (scale_x None) or `_int8_matmul_static`'s
    scalar branch, fp32 out, with their epilogue orders: (acc * sx) * sw,
    or acc * (sx * sw)."""
    x2 = x.reshape(-1, x.shape[-1])
    if scale_x is None:
        x8, sx = quantize_act_rows(x2)
        y = (int8_mm(x8, kernel).float() * sx) * scale_w.float()
    else:
        sxf = scale_x.float()
        inv = 1.0 / torch.clamp(sxf, min=1e-12)
        x8 = torch.clamp(torch.round(x2.float() * inv), -127, 127).to(torch.int8)
        y = int8_mm(x8, kernel).float() * (sxf * scale_w.float())
    return y.reshape(*x.shape[:-1], kernel.shape[-1])


class _Int8Matmul(torch.autograd.Function):
    """The int8 forward; the backward is the JAX `_int8_matmul_bwd`,
    straight through the bf16 dequantized weight: g in bf16 times
    kernel.bf16 * scale_w.bf16, an fp32 product of the bf16 values, then x's
    dtype. The kernel and scale_w get no gradient; scale_x (calibration
    state) a zero one in its own dtype."""

    @staticmethod
    def forward(ctx, x, kernel, scale_w, scale_x):
        ctx.save_for_backward(kernel, scale_w)
        ctx.x_dtype = x.dtype
        ctx.sx_like = None if scale_x is None else (scale_x.shape, scale_x.dtype,
                                                     scale_x.device)
        return _int8_forward(x, kernel, scale_w, scale_x)

    @staticmethod
    def backward(ctx, g):
        kernel, scale_w = ctx.saved_tensors
        wdeq = kernel.to(torch.bfloat16) * scale_w.to(torch.bfloat16)
        # An fp32 product of bf16 values (a bf16 matmul would return bf16).
        gx = torch.matmul(g.to(torch.bfloat16).float(), wdeq.float().t())
        gsx = None
        if ctx.sx_like is not None and ctx.needs_input_grad[3]:
            shape, dtype, device = ctx.sx_like
            gsx = torch.zeros(shape, dtype=dtype, device=device)
        return gx.to(ctx.x_dtype), None, None, gsx


def int8_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = int8 product of x and the int8 kernel, dequantized (+ bias in
    fp32), in x's dtype. Per-token activation scales by default; a "scale_x"
    (0-d, one layer's calibrated scalar) switches to the static path. Takes
    one layer's 2-D weight (a layer or column view included). Differentiable
    in x, straight through (`_Int8Matmul`)."""
    kernel, scale_w = p["kernel"], p["scale_w"].detach()
    scale_x = p.get("scale_x")
    if kernel.ndim != 2:
        raise ValueError(f"int8_linear takes one layer's (in, out) weight, got "
                         f"{tuple(kernel.shape)}; index stacked layers first "
                         "(bridge.index_layer)")
    if scale_x is not None and scale_x.ndim != 0:
        raise ValueError(f"int8_linear takes one layer's 0-d scale_x, got "
                         f"{tuple(scale_x.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or (scale_x is not None
                                                        and scale_x.requires_grad)):
        y = _Int8Matmul.apply(x, kernel, scale_w, scale_x)
    else:
        y = _int8_forward(x, kernel, scale_w, scale_x)
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# === int4 ===

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
    scale = _div(wf.abs().amax(dim=-2, keepdim=True), 7.0)
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


def _is_quantizable(node: dict, min_dim: int, bits: int) -> bool:
    """A float 'kernel' leaf (stacked or not) whose contraction dim
    (shape[-2]) is at least `min_dim` (and even, for int4's packing)."""
    k = node.get("kernel")
    return (isinstance(k, torch.Tensor) and k.ndim >= 2 and k.is_floating_point()
            and k.shape[-2] >= min_dim and (bits == 8 or k.shape[-2] % 2 == 0))


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


def _copy_dicts(node):
    """The tree's dicts and lists copied, its tensors shared."""
    if isinstance(node, dict):
        return {k: _copy_dicts(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_copy_dicts(v) for v in node]
    return node


def quantize_tree(params: Params, min_dim: int = 1024, bits: int = 8) -> Params:
    """Quantize every float 'kernel' leaf whose contraction dim (shape[-2])
    is at least `min_dim`. bits=8: the kernel becomes int8 beside an fp32
    `scale_w` (W8A8, `int8_linear`); bits=4: it is replaced by kernel_q4 and
    scale_w4 (d_in even; `int4_linear`). Norm scales, biases, embeddings,
    small projections and `lm_head` stay. Returns a new tree and leaves
    `params` as it was; the caller drops the old one to free its kernels
    (`quantize_tree_lowmem` on a copy of the tree's dicts)."""
    return quantize_tree_lowmem(_copy_dicts(params), min_dim=min_dim, bits=bits)


def quantize_tree_lowmem(params: Params, min_dim: int = 1024, bits: int = 8) -> Params:
    """`quantize_tree`, CONSUMING `params`: each quantized node's source
    kernel is popped from it and released before the next leaf, and the node
    itself is reused. A stacked kernel quantizes one layer at a time, so the
    build's peak is the float tree plus one quantized leaf plus one layer's
    fp32 temporaries (the JAX version donates the kernel to a per-layer
    `lax.map`)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def visit(node, name=""):
        if isinstance(node, dict):
            if name in _QUANT_EXCLUDE:
                return node
            if _is_quantizable(node, min_dim, bits):
                kernel = node.pop("kernel")
                node.update(quantize_weight(kernel) if bits == 8 else _quantize_leaf(kernel))
                return node
            return {k: visit(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        return node

    return visit(params)
