"""Joint padded execution of the SigLIP + DINOv2 featurizer pair.

Port of `openvla_oft_tpu/models/vit_joint.py`: the two backbones run as one
program over a group axis G = 2, every dimension padded to the larger
backbone, so that each of a block's four products is ONE batched product
(`torch.bmm`, or in int8 one `torch._int_mm` per group) instead of one per
backbone:

  - width 1024 -> 1152 and mlp 4096 -> 4304 with zero rows and columns: the
    padded residual dims stay exactly 0 through every block;
  - head_dim 64 -> 72 with zero q/k/v slots; the softmax scale difference
    (1/sqrt(64) against the joint attention's 1/sqrt(72)) is folded into the
    q columns at build time, in fp32 and rounded once per element;
  - tokens 256 -> 261 zero rows, masked out of attention as keys (the dense
    attention of `ops/attention.py`: head_dim 72 is not a K1 shape);
  - depth 23 -> 26 with all-zero "identity" layers (a zero-weight pre-norm
    block adds +0 on both residual branches);
  - per-group LayerNorm standardization with each group's true width as the
    divisor and padded dims masked out of the variance.

It is an opt-in serving layout (`serving/deploy.py::serving_params`'s
`joint_vit` / `joint_vit_int8`): bf16 from the folded trees
(`fuse_vit_inference_weights(fold_norms=True)`), int8 from the unfolded ones
(the LayerNorm affines stacked per group and applied after the
standardization), quantized after the build (`quantize_joint_vit`), so that
the int8 grids are the per-backbone path's. No Pallas kernel stands behind
it in the JAX package (its products are `jnp.einsum` and a grouped
`lax.dot_general`), so none does here: the products are library calls.
`grouped_mm.launches` counts the batched float products. The joint layout
never takes K4 and is not sharded over tp by rule (its leaves replicate).
Every function runs on `device="meta"` too (the bench's zero tree).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from openvla_oft_tpu_torch.config import ViTConfig
from openvla_oft_tpu_torch.models.vit import vit_frontend
from openvla_oft_tpu_torch.ops.attention import attention
from openvla_oft_tpu_torch.ops.layers import ACTIVATIONS
from openvla_oft_tpu_torch.ops.quant import int8_mm, quantize_act_rows, quantize_weight
from openvla_oft_tpu_torch.parallel.sharding import compute_view, layer_params

Params = Dict[str, Any]

NAMES = ("featurizer", "fused_featurizer")
_KERNELS = ("qkv_k", "proj_k", "fc1_k", "fc2_k")


def _joint_dims(cfgs: Sequence[ViTConfig]) -> Tuple[int, int, int, int]:
    """(head_dim, width, mlp_dim, layers) of the joint program: each the
    larger backbone's; the layers those that run (depth - 1)."""
    return (max(c.head_dim for c in cfgs), max(c.width for c in cfgs),
            max(c.mlp_dim for c in cfgs), max(c.depth - 1 for c in cfgs))


def _place(out: torch.Tensor, g: int, src: torch.Tensor) -> None:
    """Copy `src` into the leading corner of out[:, g] (the rest stays 0)."""
    dst = out[:, g]
    for axis, n in enumerate(src.shape):
        dst = dst.narrow(axis, 0, n)
    dst.copy_(src)


def build_joint_vit_pair(params_by_name: Dict[str, Params], cfgs: Sequence[ViTConfig],
                         names: Sequence[str] = NAMES) -> Params:
    """Stack two per-backbone ViT trees (LayerScale folded; the LayerNorm
    affines folded, or both unfolded) into one joint tree.

    Returns {"front": [each group's front end: patch embed, pos embed,
    prefix tokens, unpadded], "layers": {...}}, every layer leaf (Lj, G, ...)
    padded to the joint dims: qkv_k (Lj, G, Dj, 3 * nh * hdj), qkv_b, proj_k,
    proj_b, fc1_k, fc1_b, fc2_k, fc2_b, and with unfolded trees n1_g, n1_b,
    n2_g, n2_b (zero on padded dims and identity layers). Each leaf is
    allocated zero and filled per group, so the build holds the per-backbone
    tree and the joint one and no padded temporary."""
    if len(names) != 2 or len(cfgs) != 2:
        raise ValueError("the joint path is a pair design: two backbones")
    nh = cfgs[0].num_heads
    if any(c.num_heads != nh for c in cfgs):
        raise ValueError("the joint pair needs equal head counts")
    hdj, dj, mlpj, lj = _joint_dims(cfgs)
    g_n = len(names)
    # The norm affines stay unfolded on the int8 serving path (a fold scales
    # kernel rows and coarsens the per-output-channel grids); then they are
    # stacked and applied after the grouped standardization.
    with_affine = ["scale" in params_by_name[n]["layers"]["norm1"] for n in names]
    if with_affine[0] != with_affine[1]:
        raise ValueError("the joint pair needs both groups folded or both unfolded")

    fronts: List[Params] = []
    for name in names:
        lay = params_by_name[name]["layers"]
        if "ls1" in lay or "ls2" in lay:
            raise ValueError("build_joint_vit_pair requires folded LayerScale "
                             "(fuse_vit_inference_weights first; its LayerScale fold is "
                             "quantization-exact)")
        for sub in (lay["attn"]["qkv"], lay["attn"]["proj"], lay["mlp"]["fc1"],
                    lay["mlp"]["fc2"]):
            if "kernel" not in sub or sub["kernel"].dtype == torch.int8 \
                    or any("lora" in k for k in sub):
                raise ValueError("the joint pair is a bf16/fp32 serving layout (no "
                                 "quantized or LoRA-carrying kernels)")
        fronts.append({k: v for k, v in params_by_name[name].items() if k != "layers"})

    first = params_by_name[names[0]]["layers"]["attn"]["qkv"]
    kdt, bdt = first["kernel"].dtype, first["bias"].dtype
    dev = first["kernel"].device

    def zeros(shape, dtype):
        return torch.zeros((lj, g_n) + shape, dtype=dtype, device=dev)

    layers = {"qkv_k": zeros((dj, 3, nh, hdj), kdt), "qkv_b": zeros((3, nh, hdj), bdt),
              "proj_k": zeros((nh, hdj, dj), kdt), "proj_b": zeros((dj,), bdt),
              "fc1_k": zeros((dj, mlpj), kdt), "fc1_b": zeros((mlpj,), bdt),
              "fc2_k": zeros((mlpj, dj), kdt), "fc2_b": zeros((dj,), bdt)}
    norm_dt = params_by_name[names[0]]["layers"]["norm1"].get("scale", first["bias"]).dtype
    if with_affine[0]:
        layers.update({k: zeros((dj,), norm_dt) for k in ("n1_g", "n1_b", "n2_g", "n2_b")})

    for g, (name, cfg) in enumerate(zip(names, cfgs)):
        lay = params_by_name[name]["layers"]
        d, hd = cfg.width, cfg.head_dim
        # Only blocks [0, depth - 1) run (the tap never reads the last block).
        n_run = cfg.depth - 1
        _place(layers["qkv_k"], g,
               lay["attn"]["qkv"]["kernel"][:n_run].reshape(n_run, d, 3, nh, hd))
        _place(layers["qkv_b"], g, lay["attn"]["qkv"]["bias"][:n_run].reshape(n_run, 3, nh, hd))
        if hd != hdj:
            # The joint attention divides by sqrt(hdj): the q columns take
            # sqrt(hdj / hd), computed in fp32 and rounded ONCE per element
            # (a bf16 scalar, 1.060660 -> 1.0625, would bias every logit).
            adj = (hdj / hd) ** 0.5
            for q in (layers["qkv_k"][:n_run, g, :d, 0, :, :hd],
                      layers["qkv_b"][:n_run, g, 0, :, :hd]):
                q.copy_((q.float() * adj).to(q.dtype))
        # proj's input side is (nh, hd) flattened: padded per head.
        _place(layers["proj_k"], g, lay["attn"]["proj"]["kernel"][:n_run].reshape(
            n_run, nh, hd, d))
        _place(layers["proj_b"], g, lay["attn"]["proj"]["bias"][:n_run])
        _place(layers["fc1_k"], g, lay["mlp"]["fc1"]["kernel"][:n_run])
        _place(layers["fc1_b"], g, lay["mlp"]["fc1"]["bias"][:n_run])
        _place(layers["fc2_k"], g, lay["mlp"]["fc2"]["kernel"][:n_run])
        _place(layers["fc2_b"], g, lay["mlp"]["fc2"]["bias"][:n_run])
        if with_affine[0]:
            for key, src, sub in (("n1_g", "norm1", "scale"), ("n1_b", "norm1", "bias"),
                                  ("n2_g", "norm2", "scale"), ("n2_b", "norm2", "bias")):
                _place(layers[key], g, lay[src][sub][:n_run])
    flat = {"qkv_k": (dj, 3 * nh * hdj), "qkv_b": (3 * nh * hdj,), "proj_k": (nh * hdj, dj)}
    for key, shape in flat.items():
        layers[key] = layers[key].reshape((lj, g_n) + shape)
    return {"front": fronts, "layers": layers}


def quantize_joint_vit(joint: Params) -> Params:
    """int8-quantize the four joint kernel stacks per layer, group and output
    channel (`ops/quant.py::quantize_weight` over the (Lj, G, d_in, d_out)
    leaves: kernel int8 in the serving layout, `<name>_s` fp32 (Lj, G,
    d_out)). Zero-padded columns quantize to zeros with scale 0, so the
    padding stays exact. Biases and affines stay float. Consumes `joint`:
    each float stack is replaced by its int8 copy as soon as that exists."""
    layers = joint["layers"]
    for key in _KERNELS:
        q = quantize_weight(layers[key])
        layers[key], layers[key[:-2] + "_s"] = q["kernel"], q["scale_w"]
    return {"front": joint["front"], "layers": layers}


def joint_vision(vision: Dict[str, Params], cfgs: Sequence[ViTConfig], int8: bool) -> Params:
    """A serving vision tree as the joint pair, `{"joint": ...}`: built from
    the per-backbone trees (folded for bf16, unfolded for int8) and, with
    `int8`, quantized after the build, in place of the per-backbone
    quantization."""
    tree = build_joint_vit_pair(vision, cfgs)
    return {"joint": quantize_joint_vit(tree) if int8 else tree}


def grouped_mm(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G, M, d) @ (G, d, o) -> (G, M, o) in h's dtype: one batched product.
    `grouped_mm.launches` counts the calls."""
    grouped_mm.launches += 1
    return torch.bmm(h, w)


grouped_mm.launches = 0


def _int8_mm_grouped(h: torch.Tensor, kq: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """The JAX `_int8_einsum_g`: h (G, M, d) float, kq (G, d, o) int8, sw (G,
    o) fp32 -> (G, M, o) fp32. Per-token activation quantization over all
    rows at once (`quantize_act_rows`: absmax / 127, round half to even,
    clip), the exact int32 product per group (`int8_mm`, torch._int_mm on
    the column-major layer view), then (acc * sx) * sw."""
    g_n, m, d = h.shape
    qx, sx = quantize_act_rows(h.reshape(g_n * m, d))
    qx, sx = qx.reshape(g_n, m, d), sx.reshape(g_n, m, 1)
    acc = torch.stack([int8_mm(qx[g], kq[g]) for g in range(g_n)])
    return (acc.float() * sx) * sw[:, None, :].float()


def _standardize_grouped(x: torch.Tensor, vd: torch.Tensor, dmask: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Per-group LayerNorm standardization over a zero-padded feature axis.

    x (G, M, Dj) with padded dims exactly 0; vd (G, 1, 1) the true widths;
    dmask (G, 1, Dj) 1.0 on valid dims. Padded entries of the result are
    masked back to exactly 0: they only ever meet zero kernel rows in bf16,
    but the int8 path's per-token absmax must not see them."""
    xf = x.float()
    mean = xf.sum(-1, keepdim=True) / vd
    cent = (xf - mean) * dmask
    var = (cent * cent).sum(-1, keepdim=True) / vd
    return (cent * torch.rsqrt(var + eps)).to(x.dtype)


def vit_pair_featurize_joint(joint: Params, cfgs: Sequence[ViTConfig],
                             images_by_group: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Both backbones as one G = 2 program. images_by_group[g]: (B, H, W, 3)
    pixels normalized for backbone g. Returns one (B, num_patches, width_g)
    tap per group (the second-to-last block's patch tokens, as
    `vit_featurize`)."""
    g_n = len(cfgs)
    nh = cfgs[0].num_heads
    hdj, dj, _, lj = _joint_dims(cfgs)
    front = compute_view({"front": joint["front"]})["front"]
    fronts = [vit_frontend(front[g], cfgs[g], images_by_group[g]) for g in range(g_n)]
    b = fronts[0].shape[0]
    m_g = [f.shape[1] for f in fronts]
    mj = max(m_g)
    dev = fronts[0].device
    x = fronts[0].new_zeros((g_n, b, mj, dj))
    for g, f in enumerate(fronts):
        x[g, :, :f.shape[1], :f.shape[2]] = f
    x = x.reshape(g_n, b * mj, dj)

    widths = torch.tensor([c.width for c in cfgs], device=dev)
    vd = widths.float()[:, None, None]
    dmask = (torch.arange(dj, device=dev)[None, None, :] < widths[:, None, None]).float()
    key_mask = None
    if min(m_g) != mj:
        kv = torch.arange(mj, device=dev)[None, :] < torch.tensor(m_g, device=dev)[:, None]
        key_mask = kv[:, None, None, None, :].expand(g_n, b, 1, 1, mj).reshape(
            g_n * b, 1, 1, mj)
    acts = [ACTIVATIONS[c.act] for c in cfgs]

    for i in range(lj):
        lp = layer_params(joint["layers"], i)
        int8 = lp["qkv_k"].dtype == torch.int8

        def mm(h, key, bias):
            if int8:
                # The bias in fp32, one cast after (as int8_linear).
                y = _int8_mm_grouped(h, lp[key], lp[key[:-2] + "_s"]) + bias.float()[:, None]
                return y.to(x.dtype)
            # The bias added after the product, in x's dtype (the JAX einsum's
            # two roundings in bf16), not folded into the accumulator.
            return grouped_mm(h, lp[key]) + bias[:, None]

        def norm(z, which):
            h = _standardize_grouped(z, vd, dmask)
            if f"{which}_g" in lp:      # the unfolded-affine (int8 serving) layout
                h = h * lp[f"{which}_g"][:, None] + lp[f"{which}_b"][:, None]
            return h

        qkv = mm(norm(x, "n1"), "qkv_k", lp["qkv_b"]).reshape(g_n, b, mj, 3, nh, hdj)
        q, k, v = (qkv[..., j, :, :].reshape(g_n * b, mj, nh, hdj) for j in range(3))
        o = attention(q, k, v, mask=key_mask).reshape(g_n, b * mj, nh * hdj)
        x = x + mm(o, "proj_k", lp["proj_b"])
        h = mm(norm(x, "n2"), "fc1_k", lp["fc1_b"])
        if cfgs[0].act == cfgs[1].act:
            h = acts[0](h)
        else:
            h = torch.cat([act(h[g:g + 1]) for g, act in enumerate(acts)], dim=0)
        x = x + mm(h, "fc2_k", lp["fc2_b"])

    x = x.reshape(g_n, b, mj, dj)
    return tuple(x[g, :, c.num_prefix_tokens:c.num_prefix_tokens + c.num_patches, :c.width]
                 for g, c in enumerate(cfgs))
