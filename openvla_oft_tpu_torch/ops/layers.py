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
from torch.distributed.tensor import DTensor

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

    An int4-packed dict ("kernel_q4", "scale_w4") takes its product from
    `ops/quant.py::int4_linear`, an int8 one ("kernel" int8, "scale_w") from
    `ops/quant.py::int8_linear`; LoRA factors beside them add the same delta
    (QLoRA: a frozen quantized base, straight-through gradients for x).

    A kernel that is a DTensor over the tp mesh (the compute form of a
    sharded tree, `parallel/sharding.py`), or an x that is one, takes
    `_linear_tp`.
    """
    if isinstance(x, DTensor) or any(isinstance(t, DTensor) for t in p.values()):
        return _linear_tp(p, x)
    if "kernel_q4" in p:
        from openvla_oft_tpu_torch.ops.quant import int4_linear

        y = int4_linear(p, x)
    elif p["kernel"].dtype == torch.int8:
        from openvla_oft_tpu_torch.ops.quant import int8_linear

        y = int8_linear(p, x)
    else:
        w = p["kernel"]
        dt = torch.promote_types(x.dtype, w.dtype)
        if "bias" not in p:
            y = torch.matmul(x.to(dt), w.to(dt)).to(x.dtype)
        else:
            # addmm adds the bias to the fp32 accumulator before the one
            # rounding to dt, as the JAX version adds it to its fp32 dot output.
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


def _linear_tp(p: Params, x) -> torch.Tensor:
    """`linear` with its kernel sharded over the tp mesh, Megatron-style and
    with the collectives written out: each rank computes its block with the
    plain `linear` on local tensors.

    column-parallel (kernel Shard(1), the output columns): x whole, the
    output a DTensor Shard(-1); x's gradient is a partial sum over tp (an
    all-reduce in the backward), as is the replicated LoRA A's. The bias and
    LoRA B take their own columns, and so do a quantized kernel's scales
    (`scale_w`, `scale_w4`: column views).
    row-parallel (kernel Shard(0), the input rows): x's own columns (a free
    slice of a whole x), partial outputs summed by an all-reduce into a plain
    tensor, then the bias; LoRA A takes its rows and B, replicated, a
    partial gradient. A quantized block (`_row_parallel_quant`) sums in
    int32 (W8A8) or fp32 (int4) and rounds once.
    A kernel replicated over tp (a quantized weight kept whole,
    `parallel/sharding.py::quant_block_fits`) computes the whole product on
    every rank, its input gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from openvla_oft_tpu_torch.parallel.sharding import replicate

    name = "kernel_q4" if "kernel_q4" in p else "kernel"
    w = p[name]
    mesh = next(t.device_mesh for t in (w, *p.values(), x) if isinstance(t, DTensor))
    last = x.ndim - 1

    def local(t, want, grad=None):
        """t's local block under the placement `want`: a gather (`replicate`)
        of a sharded DTensor, a free slice of a whole tensor."""
        if isinstance(t, DTensor) and want == Replicate():
            t = replicate(t)
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()], run_check=False)
        if t.placements[0] != want:
            t = t.redistribute(mesh, [want])
        return t.to_local(grad_placements=None if grad is None else [grad])

    role = w.placements[0] if isinstance(w, DTensor) else Replicate()
    if role == Shard(1):
        lp = {name: w.to_local()}
        for k in ("bias", "scale_w", "scale_w4"):
            if k in p:
                lp[k] = local(p[k], Shard(p[k].ndim - 1))
        if "scale_x" in p:
            lp["scale_x"] = local(p["scale_x"], Replicate())
        if "lora_a" in p:
            lp["lora_a"] = local(p["lora_a"], Replicate(), Partial())
            lp["lora_b"] = local(p["lora_b"], Shard(1))
        y = linear(lp, local(x, Replicate(), Partial()))
        return DTensor.from_local(y, mesh, [Shard(last)], run_check=False)
    if role == Shard(0):
        lp = {name: w.to_local()}
        if "scale_w4" in p:
            lp["scale_w4"] = local(p["scale_w4"], Shard(0))
        for k in ("scale_w", "scale_x"):
            if k in p:
                lp[k] = local(p[k], Replicate())
        if "lora_a" in p:
            lp["lora_a"] = local(p["lora_a"], Shard(1))
            lp["lora_b"] = local(p["lora_b"], Replicate(), Partial())
        xl = local(x, Shard(last))
        if name == "kernel_q4" or w.dtype == torch.int8:
            if "bias" in p:
                lp["bias"] = local(p["bias"], Replicate())
            return _row_parallel_quant(lp, xl, mesh.get_group())
        y = replicate(DTensor.from_local(linear(lp, xl), mesh, [Partial()], run_check=False))
        if "bias" in p:
            y = y + local(p["bias"], Replicate()).to(y.dtype)
        return y
    return linear({k: local(t, Replicate()) for k, t in p.items()}, local(x, Replicate()))


def _row_parallel_quant(lp: Params, xl: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel quantized product on this rank's block: x's own
    columns `xl` against the kernel's own rows (`lp`, with the whole bias),
    summed over the tp `group`; then the bias and one rounding to x's dtype,
    as the one-device path does. W8A8 quantizes x with the per-token scale
    of the whole rows (an all-reduce MAX of the ranks' absmaxes; none with a
    static `scale_x`) and sums the exact int32 accumulators, so the result
    is bitwise the unsharded product's; int4 sums the fp32 products (K6
    with the whole rows' scale too). LoRA factors in `lp` add their
    row-parallel delta, summed likewise. Every collective goes through c10d
    (`parallel/sharding.py::all_reduce`) and is counted."""
    from openvla_oft_tpu_torch.ops import quant as Q
    from openvla_oft_tpu_torch.parallel.sharding import all_reduce

    base = {k: v for k, v in lp.items() if k not in ("lora_a", "lora_b")}
    int8 = "kernel" in base
    per_token = "scale_x" not in base if int8 else Q.int4_takes_a8(base, xl)
    sx = None
    if per_token:
        absmax = Q.act_absmax_rows(xl.detach().reshape(-1, xl.shape[-1]))
        sx = Q.act_scale(all_reduce(absmax, group, "max"))
    product = Q.int8_linear if int8 else Q.int4_linear
    y = product(base, xl, sx=sx, reduce=lambda t: all_reduce(t, group))
    if "lora_a" not in lp:
        return y
    down = torch.matmul(xl, lp["lora_a"].to(xl.dtype).transpose(-1, -2))
    delta = all_reduce(torch.matmul(down.float(), lp["lora_b"].to(xl.dtype).float()), group)
    return (y.float() + delta).to(xl.dtype)


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
