"""The K5 timing probe: K5's kernel with its dequant step varied.

Port of `vla_scripts/exp_int4_probe.py::_kernel_probe` (:53). The CUDA kernel
is K5's own (`csrc/int4_w4a16.cuh`) with its dequant step varied, launched
through `csrc/int4_probe.cu` with K5's operands, workspace and a plan from
`_probe_plan`; `scripts/exp_int4_probe.py` times it beside K5 and K6 to split
K5's time into scale multiply, nibble unpack and product. Modes, with
x_e = x[:, 0::2] and x_o = x[:, 1::2] in bf16 and lo, hi the sign-extended
low and high nibbles of each packed byte:

    no-scale    x_e @ lo + x_o @ hi                   (no scale: WRONG NUMBERS
                                                       by design)
    no-unpack   x_e @ B + x_o @ B, B the raw byte     (WRONG NUMBERS by design)
    group-dots  sum_g (x_e,g @ lo_g + x_o,g @ hi_g) * scales[g]
                                                      (a correct W4A16: the
                                                       scale hits the fp32
                                                       partial of each group)

x (T, K) float, packed (K/2, N) int8, scales (G, N) fp32 (K5's operand
contract; groups that are multiples of 16 on CUDA) -> (T, N) fp32. A CUDA
tensor goes to the kernel or raises; a CPU tensor goes to the plain version
`int4_probe_ref`. `int4_probe.launches` counts the launches.
"""

from __future__ import annotations

import functools

import torch

from openvla_oft_tpu_torch.ops import int4_matmul as M
from openvla_oft_tpu_torch.ops.quant import _unpack_int4

MODES = ("no-scale", "no-unpack", "group-dots")


def _halves(x: torch.Tensor, packed: torch.Tensor):
    """(x_e, x_o, lo, hi) in fp32: x's even and odd columns rounded to bf16,
    and the low and high nibbles of each byte (weight rows 2i and 2i+1)."""
    xb = x.to(torch.bfloat16).float()
    nib = _unpack_int4(packed).float()
    return xb[:, 0::2], xb[:, 1::2], nib[0::2], nib[1::2]


def int4_probe_ref(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                   mode: str) -> torch.Tensor:
    """Plain probe, as `_kernel_probe` computes each mode: fp32 products of
    bf16 values."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    x_e, x_o, lo, hi = _halves(x, packed)
    if mode == "no-scale":
        return x_e @ lo + x_o @ hi
    if mode == "no-unpack":
        raw = packed.float()
        return x_e @ raw + x_o @ raw
    groups = scales.shape[0]
    g2 = packed.shape[0] // groups
    t, n = x.shape[0], packed.shape[1]
    parts = (torch.bmm(x_e.reshape(t, groups, g2).transpose(0, 1), lo.reshape(groups, g2, n))
             + torch.bmm(x_o.reshape(t, groups, g2).transpose(0, 1), hi.reshape(groups, g2, n)))
    out = torch.zeros((t, n), dtype=torch.float32, device=x.device)
    for g in range(groups):
        out = out + parts[g] * scales[g].float()
    return out


# group-dots keeps each group's partial beside the sum, twice K5's accumulator
# registers: its compiled tiles of x's rows stop at 128 (`csrc/int4_probe.cu`).
GROUP_DOTS_T_TILES = (64, 128)


@functools.lru_cache(maxsize=256)
def _probe_plan(t: int, k: int, n: int, group: int, mode: str) -> tuple:
    """The probe's launch (t_tile, splits, grid CTAs): K5's plan
    (`int4_matmul._k5_plan`) in no-scale and no-unpack, and in group-dots the
    same rule over its tiles of at most 128 rows."""
    if mode == "group-dots":
        return M._k5_plan(t, k, n, group, GROUP_DOTS_T_TILES)
    return M._k5_plan(t, k, n, group)


def int4_probe(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               mode: str) -> torch.Tensor:
    """One probe mode: the kernel on CUDA, the plain version on the CPU."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.ndim != 2:
        raise ValueError(f"int4_probe takes x (T, K), got {tuple(x.shape)}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"int4_probe runs on CUDA or CPU, not {x.device}")
        return int4_probe_ref(x, packed, scales, mode)
    return M._launch_machine(int4_probe, f"int4_probe {mode}", x, packed, scales,
                             functools.partial(_probe_plan, mode=mode), "openvla_int4_probe",
                             MODES.index(mode))


int4_probe.launches = 0
