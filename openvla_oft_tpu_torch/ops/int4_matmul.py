"""Fused int4 dequant-matmuls: kernels K5 (W4A16) and K6 (W4A8).

Port of `openvla_oft_tpu/ops/int4_matmul.py`. Its four TPU kernels become
two CUDA kernels:
- K5 (`csrc/int4_w4a16.cu`) replaces `_kernel` (:43, `int4_matmul_fused`)
  and `_kernel_stacked` (:199, `int4_matmul_fused_stacked`). It runs wgmma
  with the dequantized weight as the register operand, fed by a ring of
  asynchronous copies; `_k5_plan` picks its tile of x's rows and its split
  over K;
- K6 (`csrc/int4_w4a8.cu`) replaces `_kernel_a8` (:432,
  `int4_matmul_fused_a8`) and `_kernel_stacked_a8` (:527,
  `int4_matmul_fused_stacked_a8`). It runs int8 wgmma with the weight
  unpacked to a K-major int8 tile in shared memory, fed by the same kind of
  ring, and scales each group's exact int32 partial in fp32 while the next
  group's products run; `_k6_plan` picks its tile of x's rows and its split
  over K.
The stacked TPU variants exist because a custom call cannot read a slice of
a stacked buffer without a copy. Here layer l of a stacked (L, K/2, N) weight
is the view `packed[l]`, and each kernel reads its operands through their
row strides, so the stacked variants are K5 and K6 on a view. Column views
(the `out_window` layer's q/k/v slices of wqkv) are read the same way.

    y = x @ W,  W[k, n] = nibble(k, n) * scales[k // group, n]     (W4A16)
    y = sx * sum_g (int32 sum over group g of x8 * nibble) * scales[g]  (W4A8)

x (..., T, K) float, packed (K/2, N) int8, scales (G, N) float (G = K / group)
-> (..., T, N) fp32. A CUDA tensor goes to the kernel or raises; a CPU tensor
goes to the plain versions `int4_matmul_ref` and `int4_matmul_a8_ref`. There
is no fallback between them. `int4_matmul_fused.launches` and
`int4_matmul_fused_a8.launches` count kernel launches.

The backward of both (training through a frozen int4 base) is the JAX
package's `_fused_bwd`: the gradient through the bf16-rounded dequantized
weight; packed bytes and scales get none.
"""

from __future__ import annotations

import functools

import torch

from openvla_oft_tpu_torch.ops.quant import (_unpack_int4, dequantize_int4, quantize_act_rows,
                                             quantize_rows)


def int4_matmul_ref(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain K5 (the JAX `_int4_matmul_xla`): dequantize the whole weight in
    fp32, round it to x's dtype, and take the product of x's values with it
    in fp32. On bf16 inputs these are the kernel's bf16 products."""
    w = dequantize_int4(packed, scales, x.dtype)
    return torch.matmul(x.float(), w.float())


def _act8(x2: torch.Tensor, sx=None) -> tuple:
    """(x8, sx): x2's per-token int8 codes and scales, with the given scale
    sx (T, 1) where there is one (a row-parallel block's, of the whole rows)."""
    return quantize_act_rows(x2) if sx is None else (quantize_rows(x2, sx), sx)


def int4_matmul_a8_ref(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                       sx=None) -> torch.Tensor:
    """Plain K6: per-token int8 activations (scale `sx` where given); group
    by group an exact integer product over the group's depth (fp32 holds it
    exactly: |sum| <= 127 * 7 * 128 < 2**24), times the group's scale,
    summed over the groups in order; then times the token scale."""
    x8, sx = _act8(x.reshape(-1, x.shape[-1]), sx)
    w8 = _unpack_int4(packed)
    k_dim, n = w8.shape
    groups = scales.shape[0]
    g = k_dim // groups
    parts = torch.bmm(x8.float().reshape(-1, groups, g).transpose(0, 1),
                      w8.float().reshape(groups, g, n))              # (G, T, N)
    acc = torch.zeros((x8.shape[0], n), dtype=torch.float32, device=x8.device)
    for gi in range(groups):
        acc = acc + parts[gi] * scales[gi].float()
    return (acc * sx).reshape(*x.shape[:-1], n)


def _check_weight(name: str, x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor):
    """What the kernels need of the weight; returns (K, N, group)."""
    k_dim = x.shape[-1]
    if packed.dtype != torch.int8 or packed.ndim != 2:
        raise TypeError(f"{name}: packed must be a 2-D int8 tensor, got "
                        f"{packed.dtype} {tuple(packed.shape)}")
    if scales.ndim != 2 or not scales.is_floating_point():
        raise TypeError(f"{name}: scales must be a 2-D float tensor")
    k2, n = packed.shape
    groups = scales.shape[0]
    if k_dim != 2 * k2 or scales.shape[1] != n or groups == 0 or k_dim % groups:
        raise ValueError(f"{name}: x (..., {k_dim}), packed {tuple(packed.shape)} and "
                         f"scales {tuple(scales.shape)} do not fit")
    for t, what in ((packed, "packed"), (scales, "scales")):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on {x.device}")
        if t.stride(-1) != 1 or t.stride(0) < t.shape[1]:
            raise ValueError(f"{name}: {what} needs contiguous rows (a row- or "
                             f"column-slice view is fine), got strides {t.stride()}")
    return k_dim, n, k_dim // groups


def _check_group(name: str, group: int) -> None:
    """Both kernels take groups that are multiples of 16: a group then holds
    whole k16 steps of the tensor cores."""
    if group % 16:
        raise ValueError(f"{name} takes groups that are multiples of 16, got {group}")


# K5's compiled tiles of x's rows (`csrc/int4_w4a16.cu`, one instance each),
# the output columns and depth of its CTA, and the card's SM count.
K5_T_TILES = (64, 128, 192, 256)
K5_BN, K5_BK, K5_SMS = 128, 64, 132


def _plan(t: int, k: int, n: int, group: int, t_tiles: tuple, bk: int, row_cost: int,
          rate: float) -> tuple:
    """A launch (t_tile, splits, grid CTAs) for x (t, k) and a (k, n) weight
    in groups of `group`, for a kernel whose CTA computes 128 output columns
    for t_tile rows of x over k / splits of the depth, in stages `bk` deep.

    Where the grid is under one wave of the card's SMs, the depth is split:
    `splits` is the smallest divisor of the number of groups that fills the
    wave and leaves each split whole stages (else the largest such divisor).
    Of the compiled t_tiles, the plan takes the one with the least estimated
    time: waves times one CTA's work (its rows at `row_cost` each, plus about
    64 rows' worth for the weight tile, at the SM's share of `rate`, in
    operations per ns), plus the split's partials written and read at the
    memory rate; a tie goes to the larger tile."""
    groups = k // group
    ntiles = -(-n // 128)
    valid = [d for d in range(1, groups + 1)
             if groups % d == 0 and (d == 1 or (k // d) % bk == 0)]
    best = None
    for t_tile in sorted(t_tiles, reverse=True):
        ctas = -(-t // t_tile) * ntiles
        splits = 1
        if ctas < K5_SMS:
            splits = next((d for d in valid if ctas * d >= K5_SMS), valid[-1])
        waves = -(-ctas * splits // K5_SMS)
        ns = waves * (k // splits) * (row_cost * t_tile + 64) * 2 * 128 / rate
        if splits > 1:
            ns += t * n * splits * 8 / 3350.0
        if best is None or ns < best[0]:
            best = (ns, (t_tile, splits, ctas * splits))
    return best[1]


@functools.lru_cache(maxsize=256)
def _k5_plan(t: int, k: int, n: int, group: int, t_tiles: tuple = K5_T_TILES) -> tuple:
    """K5's launch (`_plan`): its t_tiles (or those of a probe mode), 64-deep
    stages, the bf16 rate."""
    return _plan(t, k, n, group, t_tiles, K5_BK, 1, 7500.0)


# K6's compiled tiles of x8's rows (`csrc/int4_w4a8.cu`), and the output
# columns and depth of its CTA.
K6_T_TILES = (64, 96)
K6_BN, K6_BK = 128, 128


@functools.lru_cache(maxsize=256)
def _k6_plan(t: int, k: int, n: int, group: int) -> tuple:
    """K6's launch (`_plan`): its t_tiles, 128-deep stages, the int8 rate
    (twice bf16's) with each row costing about as much again for the
    per-group scaling of its int32 partials. Groups that are not a multiple
    of 32 take twice the products; that does not change the choice."""
    return _plan(t, k, n, group, K6_T_TILES, K6_BK, 2, 15000.0)


def _launch_machine(counted, name: str, x2: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor, plan, entry: str, *extra: int) -> torch.Tensor:
    """One launch of K5's machine (`csrc/int4_w4a16.cuh`) through the C entry
    `entry` of the kernel library: x2 (T, K) rounded to bf16 with a 16-byte
    base, the launch `plan(t, k, n, group)` -> (t_tile, splits, CTAs), the
    split's partials and counters, then `extra` (the probe's mode) before the
    stream. K5 and the K5 timing probe (`ops/int4_probe.py`) launch through
    it; a launch adds one to `counted.launches`."""
    from openvla_oft_tpu_torch import _build

    k_dim, n, group = _check_weight(name, x2, packed, scales)
    _check_group(name, group)
    xb = x2.to(torch.bfloat16).contiguous()          # rounded to bf16, as the TPU kernel does
    if xb.data_ptr() % 16:                           # the TMA copies need a 16-byte base
        xb = xb.clone()
    sc = scales.float()
    t = xb.shape[0]
    out = torch.empty((t, n), dtype=torch.float32, device=x2.device)
    if t == 0:
        return out
    t_tile, splits, _ = plan(t, k_dim, n, group)
    work = counters = None
    if splits > 1:                                   # partials, and a counter per output tile
        work = torch.empty((splits, t, n), dtype=torch.float32, device=x2.device)
        counters = torch.zeros(-(-n // K5_BN) * -(-t // t_tile), dtype=torch.int32,
                               device=x2.device)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = getattr(lib, entry)(
            xb.data_ptr(), packed.data_ptr(), sc.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(),
            None if counters is None else counters.data_ptr(),
            t, k_dim, n, group, packed.stride(0), sc.stride(0), t_tile, splits, *extra, stream)
    _build.check_launch(err, name)
    counted.launches += 1
    return out


def _launch_w4a16(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return _launch_machine(int4_matmul_fused, "int4_matmul_fused (K5)", x2, packed, scales,
                           _k5_plan, "openvla_int4_matmul_w4a16")


def _launch_w4a8(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                 sx=None) -> torch.Tensor:
    from openvla_oft_tpu_torch import _build

    name = "int4_matmul_fused_a8 (K6)"
    k_dim, n, group = _check_weight(name, x2, packed, scales)
    _check_group(name, group)
    if group > K6_BK:
        raise ValueError(f"{name} takes groups of at most {K6_BK}, got {group}")
    x8, sx = _act8(x2, sx)
    sx = sx.float().contiguous()                     # one fp32 scale a row
    x8 = x8.contiguous()                             # the TMA copies need rows K bytes apart
    if x8.data_ptr() % 16:                           # and a 16-byte base
        x8 = x8.clone()
    sc = scales.float()
    t = x8.shape[0]
    out = torch.empty((t, n), dtype=torch.float32, device=x2.device)
    if t == 0:
        return out
    t_tile, splits, _ = _k6_plan(t, k_dim, n, group)
    work = counters = None
    if splits > 1:                                   # partials, and a counter per output tile
        work = torch.empty((splits, t, n), dtype=torch.float32, device=x2.device)
        counters = torch.zeros(-(-n // K6_BN) * -(-t // t_tile), dtype=torch.int32,
                               device=x2.device)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.openvla_int4_matmul_w4a8(
            x8.data_ptr(), sx.data_ptr(), packed.data_ptr(), sc.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(),
            None if counters is None else counters.data_ptr(),
            t, k_dim, n, group, packed.stride(0), sc.stride(0), t_tile, splits, stream)
    _build.check_launch(err, name)
    int4_matmul_fused_a8.launches += 1
    return out


def _on_cpu(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"int4 matmul runs on CUDA or CPU, not {x.device}")
    return True


def _forward(x, packed, scales, a8: bool, sx=None) -> torch.Tensor:
    if _on_cpu(x):
        if a8:
            return int4_matmul_a8_ref(x, packed, scales, sx)
        return int4_matmul_ref(x, packed, scales)
    x2 = x.reshape(-1, x.shape[-1])
    out = _launch_w4a8(x2, packed, scales, sx) if a8 else _launch_w4a16(x2, packed, scales)
    return out.reshape(*x.shape[:-1], out.shape[-1])


class _Int4Matmul(torch.autograd.Function):
    """K5 or K6 forward; the backward is the JAX `_fused_bwd`."""

    @staticmethod
    def forward(ctx, x, packed, scales, a8, sx=None):
        ctx.save_for_backward(packed, scales)
        ctx.x_dtype = x.dtype
        return _forward(x, packed, scales, a8, sx)

    @staticmethod
    def backward(ctx, g):
        packed, scales = ctx.saved_tensors
        w = dequantize_int4(packed, scales, torch.bfloat16)
        gx = torch.matmul(g.to(torch.bfloat16).float(), w.float().t())
        return gx.to(ctx.x_dtype), None, None, None, None


def _apply(x, packed, scales, a8: bool, sx=None) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Int4Matmul.apply(x, packed, scales.detach(), a8, sx)
    return _forward(x, packed, scales, a8, sx)


def int4_matmul_fused(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """W4A16: x @ dequant(packed, scales) in fp32, kernel K5 on CUDA (x
    rounded to bf16 first), the plain version on the CPU. packed and scales
    may be layer or column views of larger tensors."""
    return _apply(x, packed, scales, False)


def int4_matmul_fused_a8(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                         sx=None) -> torch.Tensor:
    """W4A8: per-token int8 activations (quantized here, as the JAX wrapper
    does), exact int32 group products, kernel K6 on CUDA, the plain version
    on the CPU. The same operands as `int4_matmul_fused`. `sx` (T, 1): the
    per-token scale to quantize x with instead of its own (a row-parallel
    block's, of the whole rows: `ops/layers.py::_linear_tp`)."""
    return _apply(x, packed, scales, True, sx)


int4_matmul_fused.launches = 0
int4_matmul_fused_a8.launches = 0
