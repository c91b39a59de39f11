"""Phi-2 decoder: the VLA's LLM for the `phi-2-3b` backbone.

Port of `openvla_oft_tpu/models/phi.py` (`embed_tokens`,
`_apply_partial_rope`, `_block`, `phi_model`, `lm_logits`, `phi_prefill`,
`phi_decode_step`; the init is `bridge.param_spec`'s Phi branch). Against
Llama (`models/llama.py`):

  - parallel residual blocks: one biased LayerNorm feeds both branches, and
    the block returns `x + attn_out + mlp_out`, summed in that order;
  - biased q/k/v/dense and fc1/fc2 projections, a biased lm_head;
  - RoPE over the first `rotary_dim = int(0.4 * head_dim)` dims of each
    head (32 of Phi-2's 80), the rest passed through;
  - a gelu_tanh MLP; no GQA (kv heads = heads).

Attention is always the dense path (`ops/attention.py`, `use_flash=False`),
as the JAX `phi_model` takes XLA's attention with an explicit mask and
swallows `use_flash`, `out_window` and `tp_mesh`; kernel K1 would refuse
head_dim 80 anyway (`resolve_use_flash`). Layers stay stacked (L, ...) and
run as a Python loop over per-layer views
(`parallel/sharding.py::layer_params`), which
also covers int8 and int4 layers (`ops/layers.py::linear` adds the bias).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from openvla_oft_tpu_torch.bridge import tree_leaves
from openvla_oft_tpu_torch.config import PhiConfig
from openvla_oft_tpu_torch.models.llama import KVCache, embed_tokens, run_block
from openvla_oft_tpu_torch.models.llama import lm_logits as _unbiased_logits
from openvla_oft_tpu_torch.ops.attention import attention
from openvla_oft_tpu_torch.ops.layers import gelu_tanh, layer_norm, linear
from openvla_oft_tpu_torch.ops.masks import make_block_bidirectional_mask
from openvla_oft_tpu_torch.ops.rotary import apply_rope, rope_sin_cos
from openvla_oft_tpu_torch.parallel.sharding import layer_params

Params = Dict[str, Any]

__all__ = ["embed_tokens", "lm_logits", "phi_decode_step", "phi_model", "phi_prefill"]


def _apply_partial_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                        rotary_dim: int) -> torch.Tensor:
    """RoPE over the first `rotary_dim` dims of each head; the rest untouched."""
    return torch.cat([apply_rope(x[..., :rotary_dim], sin, cos), x[..., rotary_dim:]], dim=-1)


def _qkv(p: Params, cfg: PhiConfig, xa: torch.Tensor, sin, cos):
    b, s, _ = xa.shape
    h, hd, rd = cfg.num_heads, cfg.head_dim, cfg.rotary_dim
    q = linear(p["attn"]["wq"], xa).reshape(b, s, h, hd)
    k = linear(p["attn"]["wk"], xa).reshape(b, s, h, hd)
    v = linear(p["attn"]["wv"], xa).reshape(b, s, h, hd)
    return _apply_partial_rope(q, sin, cos, rd), _apply_partial_rope(k, sin, cos, rd), v


def _mlp(p: Params, xa: torch.Tensor) -> torch.Tensor:
    return linear(p["mlp"]["fc2"], gelu_tanh(linear(p["mlp"]["fc1"], xa)))


def _attend(p: Params, cfg: PhiConfig, x: torch.Tensor, sin, cos, mask,
            is_causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention branch up to its output (B, S, H * hd), before `wo`,
    and the LayerNorm's output, which the MLP branch reads too."""
    b, s, _ = x.shape
    xa = layer_norm(p["ln"], x, cfg.layer_norm_eps)
    q, k, v = _qkv(p, cfg, xa, sin, cos)
    o = attention(q, k, v, mask=mask, is_causal=is_causal)
    return o.reshape(b, s, cfg.num_heads * cfg.head_dim), xa


def _finish(p: Params, cfg: PhiConfig, x: torch.Tensor, attended: tuple) -> torch.Tensor:
    """`wo`, the MLP branch on the same LayerNorm, and the parallel residual."""
    o_flat, xa = attended
    return x + linear(p["attn"]["wo"], o_flat) + _mlp(p, xa)


def _n_layers(params: Params) -> int:
    return tree_leaves(params["layers"])[0].shape[0]


def phi_model(params: Params, cfg: PhiConfig, inputs_embeds: torch.Tensor,
              padding_mask: Optional[torch.Tensor] = None,
              bidir_mask: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None,
              attn_mask: Optional[torch.Tensor] = None,
              remat_policy: Optional[str] = None, **_ignored) -> torch.Tensor:
    """The decoder stack; returns post-final-LayerNorm hidden states (B, S, D).

    Masks in the JAX order: an explicit `attn_mask`, else the OFT
    block-bidirectional mask from the 1-D `padding_mask` and `bidir_mask`,
    else key padding plus causal, else causal alone. `**_ignored` swallows
    Llama's serving switches (`use_flash`, `bidir_block`, `out_window`), as
    the JAX version does: every row of every layer is computed, through the
    dense attention. remat_policy: `models/llama.py::resolve_remat`'s names;
    under "attn_out" the block's LayerNorm output is kept with the attention
    output, since both halves read it.
    """
    b, s, _ = inputs_embeds.shape
    device = inputs_embeds.device
    if positions is None:
        positions = torch.arange(s, device=device).expand(b, s)
    sin, cos = rope_sin_cos(positions, cfg.rotary_dim, cfg.rope_theta)

    is_causal = False
    if attn_mask is not None:
        mask = attn_mask
    elif bidir_mask is not None:
        pad = padding_mask.bool() if padding_mask is not None else \
            torch.ones((b, s), dtype=torch.bool, device=device)
        mask = make_block_bidirectional_mask(pad, bidir_mask.bool())[:, None]
    elif padding_mask is not None:
        mask = padding_mask.bool()[:, None, None, :]
        is_causal = True
    else:
        mask = None
        is_causal = True

    x = inputs_embeds
    for i in range(_n_layers(params)):
        x = run_block(_attend, _finish, remat_policy, layer_params(params["layers"], i), cfg,
                      x, (sin, cos, mask, is_causal))
    return layer_norm(params["final_norm"], x, cfg.layer_norm_eps)


def lm_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """The biased vocab projection in fp32 (HF `PhiForCausalLM.lm_head` has
    a bias): the fp32 product of `models/llama.py::lm_logits`, then the
    bias added in fp32, as the JAX version adds it."""
    return _unbiased_logits(params, hidden) + params["lm_head"]["bias"].float()


def phi_prefill(params: Params, cfg: PhiConfig, inputs_embeds: torch.Tensor,
                cache: KVCache, positions: Optional[torch.Tensor] = None,
                key_valid: Optional[torch.Tensor] = None, **_ignored
                ) -> Tuple[torch.Tensor, KVCache]:
    """Causal prefill that fills `cache` (a `models/llama.py::KVCache`, kv
    heads = heads) from row 0, written in place; returns (post-norm hidden
    (B, S, D), cache). key_valid (B, S): False for left pads, which are then
    excluded as keys here and in later decode steps."""
    b, s, _ = inputs_embeds.shape
    device = inputs_embeds.device
    if positions is None:
        positions = torch.arange(s, device=device).expand(b, s)
    sin, cos = rope_sin_cos(positions, cfg.rotary_dim, cfg.rope_theta)
    if key_valid is None:
        key_valid = torch.ones((b, s), dtype=torch.bool, device=device)
    key_valid = key_valid.bool()
    x = inputs_embeds
    for i in range(_n_layers(params)):
        p = layer_params(params["layers"], i)
        xa = layer_norm(p["ln"], x, cfg.layer_norm_eps)
        q, k, v = _qkv(p, cfg, xa, sin, cos)
        o = attention(q, k, v, is_causal=True, key_valid=key_valid)
        x = x + linear(p["attn"]["wo"], o.reshape(b, s, -1)) + _mlp(p, xa)
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    cache.valid[:, :s] = key_valid
    cache.index = s
    return layer_norm(params["final_norm"], x, cfg.layer_norm_eps), cache


def phi_decode_step(params: Params, cfg: PhiConfig, token_embed: torch.Tensor,
                    cache: KVCache, positions: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, KVCache]:
    """One cached decode step: token_embed (B, 1, D) at row `cache.index`;
    returns (post-norm hidden (B, 1, D), cache), the cache written in place.
    positions (B, 1) default to the count of valid cached keys per row."""
    b = token_embed.shape[0]
    idx = cache.index
    if idx >= cache.k.shape[2]:
        raise ValueError(f"the cache is full: {idx} of {cache.k.shape[2]} rows")
    if positions is None:
        positions = cache.valid.sum(dim=1, keepdim=True)
    sin, cos = rope_sin_cos(positions, cfg.rotary_dim, cfg.rope_theta)
    cache.valid[:, idx] = True
    mask = cache.valid[:, None, None, :]
    x = token_embed
    for i in range(_n_layers(params)):
        p = layer_params(params["layers"], i)
        xa = layer_norm(p["ln"], x, cfg.layer_norm_eps)
        q, k, v = _qkv(p, cfg, xa, sin, cos)
        cache.k[i, :, idx] = k[:, 0]
        cache.v[i, :, idx] = v[:, 0]
        o = attention(q, cache.k[i], cache.v[i], mask=mask)
        x = x + linear(p["attn"]["wo"], o.reshape(b, 1, -1)) + _mlp(p, xa)
    cache.index = idx + 1
    return layer_norm(params["final_norm"], x, cfg.layer_norm_eps), cache
