"""Vision Transformer featurizer (DINOv2 ViT-L/14-reg4, SigLIP so400m/14).

Port of `openvla_oft_tpu/models/vit.py` for serving: patchify + matmul patch
embedding, optional class/register tokens, pre-norm blocks with optional
LayerScale, optional FiLM (x := x * (1 + gamma) + beta between the
attention and MLP residual branches, gamma and beta linear in the mean
language embedding), and the OpenVLA tap (the second-to-last block's patch
tokens, no final norm; the last block never runs). Layers stay stacked (L,
...) and run as a Python loop over views, each block optionally under
activation remat.

Inside `ops/vit_fused.py::vit_fused()` the folded LN -> qkv and LN -> fc1
(+ GELU) run as kernel K4 (`_ln_linear`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Shard

from openvla_oft_tpu_torch.config import ViTConfig
from openvla_oft_tpu_torch.models.llama import run_block
from openvla_oft_tpu_torch.ops import vit_fused as VF
from openvla_oft_tpu_torch.ops.attention import attention
from openvla_oft_tpu_torch.ops.layers import ACTIVATIONS, layer_norm, linear
from openvla_oft_tpu_torch.parallel.sharding import layer_params, like_replicated, replicate

Params = Dict[str, Any]


def fuse_vit_inference_weights(params: Params, fold_norms: bool = True) -> Params:
    """Serving-path folds (numerics-exact up to fp reassociation), as the JAX
    version: LayerNorm affine into the following matmul (norm1 -> qkv, norm2
    -> fc1; the norms keep only standardization) when `fold_norms`, and
    LayerScale into the preceding matmul (ls1 -> proj, ls2 -> fc2) always.
    Folds compute in fp32 one layer at a time, then cast to the kernel dtype.
    """
    layers = dict(params["layers"])

    def fold_into_following(norm, lin):
        kernel = torch.empty_like(lin["kernel"])
        bias_dtype = lin.get("bias", lin["kernel"]).dtype
        bias = torch.empty(kernel.shape[0], kernel.shape[-1], dtype=bias_dtype,
                           device=kernel.device)
        for i in range(kernel.shape[0]):
            k = lin["kernel"][i].float()
            kernel[i] = (k * norm["scale"][i].float()[:, None]).to(kernel.dtype)
            b = norm["bias"][i].float() @ k
            if "bias" in lin:
                b = b + lin["bias"][i].float()
            bias[i] = b.to(bias_dtype)
        return {"kernel": kernel, "bias": bias}

    def fold_into_preceding(lin, ls):
        g = ls["scale_factor"].float()                     # (L, d)
        kernel = torch.empty_like(lin["kernel"])
        for i in range(kernel.shape[0]):
            kernel[i] = (lin["kernel"][i].float() * g[i][None, :]).to(kernel.dtype)
        new = {"kernel": kernel}
        if "bias" in lin:
            new["bias"] = (lin["bias"].float() * g).to(lin["bias"].dtype)
        return new

    attn = dict(layers["attn"])
    mlp = dict(layers["mlp"])
    if fold_norms:
        attn["qkv"] = fold_into_following(layers["norm1"], attn["qkv"])
        mlp["fc1"] = fold_into_following(layers["norm2"], mlp["fc1"])
        layers["norm1"], layers["norm2"] = {}, {}
    if "ls1" in layers:
        attn["proj"] = fold_into_preceding(attn["proj"], layers.pop("ls1"))
    if "ls2" in layers:
        mlp["fc2"] = fold_into_preceding(mlp["fc2"], layers.pop("ls2"))
    layers["attn"], layers["mlp"] = attn, mlp
    return {**params, "layers": layers}


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, patch*patch*3), row-major grid, (dy, dx, c)
    order inside a patch; pixels past a patch multiple are cropped."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images[:, :gh * patch, :gw * patch].reshape(b, gh, patch, gw, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, patch * patch * c)


def _use_fused_ln_matmul(norm_p: Params, lin_p: Params) -> bool:
    """The JAX gate (`models/vit.py::_use_fused_ln_matmul`) without its
    platform test: the `vit_fused` switch is on, the norm's affine is folded
    away, and the linear is a plain float kernel (no int8, no int4, no
    LoRA), whole or a tp DTensor of its output columns (the rules shard the
    folded qkv and fc1 so)."""
    if not VF.vit_fused_enabled() or "scale" in norm_p or "kernel_q4" in lin_p:
        return False
    k = lin_p.get("kernel")
    return k is not None and k.dtype != torch.int8 and "lora_a" not in lin_p and \
        (not isinstance(k, DTensor) or k.placements[0] == Shard(1))


def _ln_linear(norm_p: Params, lin_p: Params, x: torch.Tensor,
               act_name: Optional[str] = None) -> torch.Tensor:
    """LayerNorm -> linear (-> activation): one `ln_matmul` (K4 on CUDA) where
    the gate allows, else the separate ops. K4 computes exact-erf GELU in
    fp32, so it takes "gelu" for `gelu_erf_fast`, as the JAX path does.
    Under tp, K4 runs on the whole x and this rank's column block of the
    kernel and of the bias; the output is a DTensor Shard(-1), as the
    column-parallel `linear` gives."""
    if not _use_fused_ln_matmul(norm_p, lin_p):
        y = linear(lin_p, layer_norm(norm_p, x))
        return y if act_name is None else ACTIVATIONS[act_name](y)
    act = "gelu" if act_name == "gelu_erf_fast" else act_name
    w, bias = lin_p["kernel"], lin_p.get("bias")
    if not isinstance(w, DTensor):
        return VF.ln_matmul(x, w, bias, act=act)
    local = w.to_local()
    if bias is not None:
        bias = replicate(bias)
        n = local.shape[-1]
        bias = bias.narrow(-1, w.device_mesh.get_local_rank() * n, n).clone()
    y = VF.ln_matmul(replicate(x), local, bias, act=act)
    return DTensor.from_local(y, w.device_mesh, [Shard(y.ndim - 1)], run_check=False)


def _vit_attend(p: Params, cfg: ViTConfig, x: torch.Tensor) -> torch.Tensor:
    """A ViT block's first half: LN, qkv, attention -> the attention output
    (B, S, width) before proj (what JAX's "attn_out" remat policy keeps)."""
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    # Under tp the fused [q|k|v] columns shard contiguously, not by head:
    # gathered whole before the split.
    y = _ln_linear(p["norm1"], p["attn"]["qkv"], x)
    q, k, v = like_replicated((t.reshape(b, s, nh, hd)
                               for t in replicate(y).split(nh * hd, dim=-1)), y)
    return attention(q, k, v).reshape(b, s, d)


def _vit_finish(p: Params, cfg: ViTConfig, x: torch.Tensor, o: torch.Tensor,
                film: Optional[tuple] = None) -> torch.Tensor:
    """A ViT block's second half: proj, layer scale and the residual, FiLM,
    then the MLP; `film` = (gamma, beta), each (B, width) in x's dtype, or
    None."""
    o = linear(p["attn"]["proj"], o)
    if "ls1" in p:
        o = o * p["ls1"]["scale_factor"]
    x = x + o
    if film is not None:
        gamma, beta = film
        # In x's dtype: in bf16, 1 + gamma rounds before the multiply, as in JAX.
        x = x * (1.0 + gamma[:, None, :]) + beta[:, None, :]
    m = _ln_linear(p["norm2"], p["mlp"]["fc1"], x, act_name=cfg.act)
    m = linear(p["mlp"]["fc2"], m)
    if "ls2" in p:
        m = m * p["ls2"]["scale_factor"]
    return x + m


def _vit_block(p: Params, cfg: ViTConfig, x: torch.Tensor,
               film: Optional[tuple] = None) -> torch.Tensor:
    """One pre-norm ViT block (`_vit_attend`, then `_vit_finish`)."""
    return _vit_finish(p, cfg, x, _vit_attend(p, cfg, x), film)


def vit_frontend(params: Params, cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """Patch embed + position embed + prefix tokens (+ pre-norm):
    (B, H, W, 3) -> (B, num_prefix + num_patches, width)."""
    b = images.shape[0]
    x = linear(params["patch_embed"], patchify(images, cfg.patch_size))
    prefix = [params[name][None].expand((b,) + params[name].shape)
              for name in ("cls_token", "reg_token") if name in params]
    if cfg.pos_embed_patches_only:
        x = x + params["pos_embed"].to(x.dtype)
        if prefix:
            x = torch.cat(prefix + [x], dim=1).to(x.dtype)
    else:
        if prefix:
            x = torch.cat(prefix + [x], dim=1)
        x = x + params["pos_embed"].to(x.dtype)
    if cfg.use_pre_norm:
        x = layer_norm(params["norm_pre"], x)
    return x


def _film(film_params: Params, le: torch.Tensor, i: int, dtype) -> tuple:
    """Block i's (gamma, beta), (B, width): fp32 products of the fp32
    language embedding with the layer's FiLM kernels, plus the bias, then one
    cast to the ViT's dtype (the JAX version computes all layers at once;
    one layer at a time keeps the fp32 temporary one layer large)."""
    return tuple((le @ film_params[k]["kernel"][i].float()
                  + film_params[k]["bias"][i].float()).to(dtype)
                 for k in ("scale", "shift"))


def vit_featurize(params: Params, cfg: ViTConfig, images: torch.Tensor,
                  film_params: Optional[Params] = None,
                  language_embedding: Optional[torch.Tensor] = None,
                  remat_policy: Optional[str] = None) -> torch.Tensor:
    """(B, H, W, 3) normalized pixels -> (B, num_patches, width): the patch
    tokens after block depth-2 (blocks 0 .. depth-2 run).

    film_params + language_embedding (B, llm_dim): FiLM in every block that
    runs. remat_policy: recompute each block in the backward, like the Llama
    blocks (`models/llama.py::run_block`).
    Training gradients flow through the ViTs (LoRA targets their kernels).
    """
    x = vit_frontend(params, cfg, images)
    film = film_params is not None and language_embedding is not None
    le = language_embedding.float() if film else None
    for i in range(cfg.depth - 1):
        f = _film(film_params, le, i, x.dtype) if film else None
        x = run_block(_vit_attend, _vit_finish, remat_policy,
                      layer_params(params["layers"], i), cfg, x, finish_args=(f,))
    return x[:, cfg.num_prefix_tokens:]
