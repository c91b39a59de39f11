"""Functional layer primitives on torch tensors.

Port of `openvla_oft_tpu/ops/layers.py`. Parameters are nested dicts of
tensors in the JAX layout ((in, out) kernels), and the numerics policy is the
same: matmuls accumulate in fp32 and return the input's dtype, normalization
statistics and softmax are fp32.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W + b with W stored (in, out); fp32 accumulation, x's dtype out.

    Mixed dtypes promote like jnp.dot (an fp32 activation against bf16
    weights computes in fp32), then the result casts back to x's dtype.

    Injected LoRA factors ("lora_a" rank-major (r, in) and pre-scaled,
    "lora_b" (r, out); training/lora.py::inject_lora) add
    (x @ lora_a^T) @ lora_b merge-free, with the JAX version's roundings:
    the down projection rounds to x's dtype, the up projection keeps an fp32
    result on x's-dtype operands, and the sum with y rounds once.

    An int4-packed dict ("kernel_q4", "scale_w4") goes to
    `ops/quant.py::int4_linear`, an int8 one ("kernel" int8, "scale_w") to
    `ops/quant.py::int8_linear`.
    """
    if "kernel_q4" in p:
        if "lora_a" in p:
            raise NotImplementedError("LoRA over an int4 base (QLoRA) is not ported "
                                      "yet (ROADMAP queue 1, item 14)")
        from openvla_oft_tpu_torch.ops.quant import int4_linear

        return int4_linear(p, x)
    w = p["kernel"]
    if w.dtype == torch.int8:
        if "lora_a" in p:
            raise NotImplementedError("LoRA over an int8 base (QLoRA) is not ported "
                                      "yet (ROADMAP queue 1, item 14)")
        from openvla_oft_tpu_torch.ops.quant import int8_linear

        return int8_linear(p, x)
    dt = torch.promote_types(x.dtype, w.dtype)
    if "bias" not in p:
        y = torch.matmul(x.to(dt), w.to(dt)).to(x.dtype)
    else:
        # addmm adds the bias to the fp32 accumulator before the one rounding
        # to dt, as the JAX version adds it to its fp32 dot output.
        y = torch.addmm(p["bias"].to(dt), x.reshape(-1, x.shape[-1]).to(dt),
                        w.to(dt))
        y = y.reshape(x.shape[:-1] + (w.shape[-1],)).to(x.dtype)
    if "lora_a" not in p:
        return y
    down = torch.matmul(x, p["lora_a"].to(x.dtype).transpose(-1, -2))
    # An fp32 product of x's-dtype values: a bf16 matmul would round delta
    # to bf16 before the add.
    delta = torch.matmul(down.float(), p["lora_b"].to(x.dtype).float())
    return (y.float() + delta).to(x.dtype)


def rms_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Llama RMSNorm, stats in fp32. An empty dict = scale folded away
    (`fuse_inference_weights`): standardize only."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    if "scale" not in p:
        return normed
    # HF LlamaRMSNorm casts back to the input dtype before the scale multiply.
    return normed * p["scale"].to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with fp32 stats; an empty dict = affine folded away."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    if "scale" in p:
        normed = normed * p["scale"].float() + p["bias"].float()
    return normed.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's quick-GELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


# Odd degrees 1,3,..,15 in u = x/9 approximating logit(Phi(x)); the same
# coefficients as openvla_oft_tpu/ops/layers.py (fit: vla_scripts/fit_fast_gelu.py).
_FAST_GELU_LOGIT_COEFFS = (
    14.326675442146776,
    55.601626553079456,
    -61.74191841860001,
    52.43234722688412,
    18.626706769273262,
    -93.53937487961036,
    82.68346492258014,
    -24.763048331986408,
)


def gelu_erf_fast(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU through x * sigmoid(poly(x)), the serving form for bf16.

    The polynomial's error (1.7e-3) is below half a bf16 ulp, so on bf16 it
    agrees with exact GELU to within one ulp; wider dtypes keep exact GELU.
    """
    if x.dtype != torch.bfloat16:
        return gelu(x)
    xf = x.float()
    u = xf.clamp(-9.0, 9.0) * (1.0 / 9.0)
    v = u * u
    acc = torch.full_like(u, _FAST_GELU_LOGIT_COEFFS[-1])
    for c in _FAST_GELU_LOGIT_COEFFS[-2::-1]:
        acc = acc * v + c
    t = acc * u
    # Explicit exp form: exp overflow at very negative t gives 1/inf = 0.
    sig = 1.0 / (1.0 + torch.exp(-t))
    return (xf * sig).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU with tanh in the exp form 1 - 2/(e^{2z}+1)."""
    z = 0.7978845608028654 * (x + 0.044715 * x * x * x)
    t = 1.0 - 2.0 / (torch.exp(2.0 * z) + 1.0)
    return 0.5 * x * (1.0 + t)


ACTIVATIONS = {
    "gelu": gelu,
    "gelu_tanh": gelu_tanh,
    "quick_gelu": quick_gelu,
    "gelu_erf_fast": gelu_erf_fast,
}
