"""Llama-2 decoder for the OFT parallel-decoding prefill.

Port of `openvla_oft_tpu/models/llama.py` (`embed_tokens`,
`fuse_inference_weights`, `_block`, `_qkv_proj`, `_mlp`, `llama_model` with
`out_window` and activation remat). RMSNorm -> RoPE attention with the OFT
block-bidirectional mask -> SwiGLU; hidden states are returned after the
final RMSNorm. Layers stay stacked (L, ...) and run as a Python loop over
per-layer views (`bridge.index_layer`). That covers int4 layers too: the
JAX package's `_has_int4`/`_index_layer` keep the stacked int4 leaves and
pass a layer index to its stacked kernels, while here `kernel_q4[l]` and
`scale_w4[l]` are views that the int4 kernels read without a copy; int8
layers likewise (`kernel[l]`, `scale_w[l]`, and a static `scale_x[l]`, 0-d).
`collect_act_stats` is the static-quant calibration forward.

On the flash path every layer but a sliced `out_window` last layer runs its
attention through kernel K1 (`ops/flash_attention.py`); the window layer has
fewer query rows than keys and always takes the dense path.

The diffusion head's serving path adds `KVCache`, `llama_prefill` (a causal
prefill that fills the cache, through K1 where K1 takes the call) and
`llama_suffix_forward` (suffix rows against the cached prefix K/V plus
their own: the dense path with a 4-D mask, or `attention_split_kv`). The
discrete head adds `lm_logits` (fp32 logits from bf16 operands) and the
autoregressive decode's `llama_decode_step` (one row against the cache).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from openvla_oft_tpu_torch.config import LlamaConfig
from openvla_oft_tpu_torch.bridge import index_layer, tree_leaves
from openvla_oft_tpu_torch.ops.attention import (attention, attention_split_kv,
                                                 resolve_use_flash)
from openvla_oft_tpu_torch.ops.layers import linear, rms_norm
from openvla_oft_tpu_torch.ops.masks import make_block_bidirectional_mask
from openvla_oft_tpu_torch.ops.quant import empty_int8_kernel
from openvla_oft_tpu_torch.ops.rotary import apply_rope, rope_sin_cos

Params = Dict[str, Any]


def resolve_remat(remat_policy: Optional[str]) -> bool:
    """Whether each block runs under activation remat (JAX
    `resolve_remat_policy` with its call sites' "none" check).

    "all": the block's forward is recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant); None / "none": activations
    are kept.
    """
    if remat_policy in (None, "none"):
        return False
    if remat_policy == "all":
        return True
    if remat_policy in ("dots", "attn_out"):
        raise NotImplementedError(f"remat_policy={remat_policy!r} is not ported "
                                  "yet (ROADMAP queue 1, item 14)")
    raise ValueError(f"Unknown remat policy {remat_policy!r} (use 'all', 'dots', "
                     "'attn_out' or 'none')")


def run_block(block, remat: bool, *args):
    """block(*args), under `torch.utils.checkpoint` when `remat` and grad is on."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)
    return block(*args)


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"]["embedding"][input_ids.long()]


def fuse_inference_weights(llm_params: Params, fold_norms: bool = True) -> Params:
    """wq|wk|wv -> wqkv and gate|up -> gate_up (every leaf concatenated on
    its last, output, axis), and with `fold_norms` the RMSNorm scales folded
    into the float kernels ((standardize(x) * g) @ W = standardize(x) @
    (diag(g) W)); the folded norms become empty dicts, which `rms_norm` reads
    as standardize-only. Folds compute in fp32 one layer at a time, then
    cast, as the JAX version does for the whole stack, so fp32 temporaries
    stay one layer large.

    The concatenation also takes quantized projections (int8 kernel and
    scale_w, or kernel_q4 and scale_w4): each output column quantizes on its
    own, so quantizing first and concatenating after gives the tree that the
    JAX loader's fuse-then-quantize gives, bit for bit, without a float copy
    of wqkv and gate_up (`serving/deploy.py::serving_params`). Quantized
    kernels take no fold, and static activation scales attach after fusing.
    """
    layers = llm_params["layers"]
    attn, mlp = layers["attn"], layers["mlp"]
    if "attn_norm" not in layers:
        raise NotImplementedError("only Llama-family trees are ported")
    if any("lora" in key for sub in (attn, mlp) for leaf in sub.values()
           for key in leaf):
        raise ValueError("fuse_inference_weights after LoRA merge, not before")
    if any("scale_x" in leaf for sub in (attn, mlp) for leaf in sub.values()):
        raise ValueError("attach static activation scales after fuse_inference_weights")

    def concat_fold(norm, nodes):
        out = {}
        for name, ref in nodes[0].items():
            parts = [node[name] for node in nodes]
            shape = ref.shape[:-1] + (sum(t.shape[-1] for t in parts),)
            fold = fold_norms and name == "kernel"
            if fold and not ref.is_floating_point():
                raise ValueError("fold_norms needs float kernels: fold before quantizing")
            # Only W8A8's int8 kernel takes the column-major serving layout;
            # int4's packed bytes (kernel_q4, also int8) stay row-major for K5/K6.
            dst = empty_int8_kernel(shape, ref.device) \
                if name == "kernel" and ref.dtype == torch.int8 \
                else torch.empty(shape, dtype=ref.dtype, device=ref.device)
            for i in range(ref.shape[0]):
                cat = torch.cat([t[i] for t in parts], dim=-1)
                if fold:
                    cat = (cat.float() * norm["scale"][i].float()[:, None]).to(ref.dtype)
                dst[i] = cat
            out[name] = dst
        return out

    new_attn, new_mlp = dict(attn), dict(mlp)
    attn_norm, mlp_norm = layers["attn_norm"], layers["mlp_norm"]
    if "wq" in attn and "bias" not in attn["wq"]:
        new_attn = {"wqkv": concat_fold(attn_norm, [attn[n] for n in ("wq", "wk", "wv")]),
                    "wo": attn["wo"]}
        if fold_norms:
            attn_norm = {}
    if "gate" in mlp and "bias" not in mlp["gate"]:
        new_mlp = {"gate_up": concat_fold(mlp_norm, [mlp["gate"], mlp["up"]]),
                   "down": mlp["down"]}
        if fold_norms:
            mlp_norm = {}
    return {**llm_params,
            "layers": {**layers, "attn": new_attn, "mlp": new_mlp,
                       "attn_norm": attn_norm, "mlp_norm": mlp_norm}}


def _qkv_proj(attn: Params, cfg: LlamaConfig, xa: torch.Tensor):
    """q/k/v projections; the fused wqkv layout gives strided views of one
    matmul's output (kernel K1 reads them through their strides)."""
    b, s, _ = xa.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "wqkv" in attn:
        qkv = linear(attn["wqkv"], xa)
        return (qkv[..., :h * hd].reshape(b, s, h, hd),
                qkv[..., h * hd:(h + kv) * hd].reshape(b, s, kv, hd),
                qkv[..., (h + kv) * hd:].reshape(b, s, kv, hd))
    return (linear(attn["wq"], xa).reshape(b, s, h, hd),
            linear(attn["wk"], xa).reshape(b, s, kv, hd),
            linear(attn["wv"], xa).reshape(b, s, kv, hd))


def _mlp(mlp: Params, xm: torch.Tensor, collect_act: bool = False):
    """SwiGLU, handling the fused gate_up layout. collect_act: also return
    the absmax of the down projection's input (the one linear input that
    `_block` does not see)."""
    if "gate_up" in mlp:
        gu = linear(mlp["gate_up"], xm)
        inter = gu.shape[-1] // 2
        act = F.silu(gu[..., :inter]) * gu[..., inter:]
    else:
        act = F.silu(linear(mlp["gate"], xm)) * linear(mlp["up"], xm)
    y = linear(mlp["down"], act)
    if collect_act:
        return y, _absmax(act)
    return y


def _absmax(a: torch.Tensor) -> torch.Tensor:
    return a.float().abs().amax()


def _block(p: Params, cfg: LlamaConfig, x: torch.Tensor, sin, cos, mask,
           is_causal: bool, use_flash: bool, bidir_block, key_valid=None,
           bidir_1d=None, collect_act_stats: bool = False):
    """One decoder block. collect_act_stats (static-quant calibration): also
    return each linear's input absmax (0-d fp32), keyed by the param tree's
    paths, so that stacked over the layers they attach as "scale_x" leaves
    (`ops/quant_calibrate.py::attach_static_act_scales`)."""
    b, s, _ = x.shape
    xa = rms_norm(p["attn_norm"], x, cfg.rms_norm_eps)
    q, k, v = _qkv_proj(p["attn"], cfg, xa)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    o = attention(q, k, v, mask=mask, is_causal=is_causal, use_flash=use_flash,
                  key_valid=key_valid, bidir_mask=bidir_1d,
                  bidir_block=bidir_block)
    o_flat = o.reshape(b, s, cfg.num_heads * cfg.head_dim)
    x = x + linear(p["attn"]["wo"], o_flat)
    xm = rms_norm(p["mlp_norm"], x, cfg.rms_norm_eps)
    if not collect_act_stats:
        return x + _mlp(p["mlp"], xm)
    y_mlp, am_act = _mlp(p["mlp"], xm, collect_act=True)
    am_xa, am_xm = _absmax(xa), _absmax(xm)
    attn_stats = ({"wqkv": am_xa} if "wqkv" in p["attn"]
                  else {"wq": am_xa, "wk": am_xa, "wv": am_xa})
    attn_stats["wo"] = _absmax(o_flat)
    mlp_stats = ({"gate_up": am_xm} if "gate_up" in p["mlp"]
                 else {"gate": am_xm, "up": am_xm})
    mlp_stats["down"] = am_act
    return x + y_mlp, {"attn": attn_stats, "mlp": mlp_stats}


def _window(b: int, s: int, start_len: Tuple[int, int], device) -> torch.Tensor:
    w0, wl = start_len
    out = torch.zeros((b, s), dtype=torch.bool, device=device)
    out[:, w0:w0 + wl] = True
    return out


def llama_model(params: Params, cfg: LlamaConfig, inputs_embeds: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                bidir_mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                use_flash=False,
                bidir_block: Optional[tuple] = None,
                out_window: Optional[Tuple[int, int]] = None,
                remat_policy: Optional[str] = None,
                collect_act_stats: bool = False):
    """Run the decoder stack; returns post-final-norm hidden states (B, S, D),
    or with `out_window=(start, len)` only those rows of the last layer
    (B, len, D) — every earlier layer still computes all rows as keys.

    use_flash: True | False | "auto" (K1 where it takes the call, see
    ops/attention.py::resolve_use_flash).
    remat_policy: activation remat of each block (`resolve_remat`).
    collect_act_stats: the static-quant calibration forward (full width, no
    out_window, no remat); returns (hidden, stats), stats the per-layer input
    absmaxes of every linear stacked to (L,) fp32 leaves that mirror the
    layer tree ({"attn": {"wqkv" | "wq", "wk", "wv", "wo"}, "mlp":
    {"gate_up" | "gate", "up", "down"}}).
    """
    b, s, _ = inputs_embeds.shape
    device = inputs_embeds.device
    # Every attention below but the out_window layer's is self-attention with the
    # 1-D mask vectors, on q of inputs_embeds' dtype.
    use_flash = resolve_use_flash(use_flash, (b, s, cfg.num_heads, cfg.head_dim),
                                  inputs_embeds.dtype, device, s)
    if positions is None:
        positions = torch.arange(s, device=device).expand(b, s)
    sin, cos = rope_sin_cos(positions, cfg.head_dim, cfg.rope_theta)

    is_causal = False
    key_valid = bidir_1d = None
    if use_flash:
        mask = None
        is_causal = True
        key_valid = padding_mask.bool() if padding_mask is not None else None
        bidir_1d = bidir_mask
    elif bidir_mask is not None or bidir_block is not None:
        if bidir_mask is None:
            bidir_mask = _window(b, s, bidir_block, device)
        pad = padding_mask.bool() if padding_mask is not None else \
            torch.ones((b, s), dtype=torch.bool, device=device)
        mask = make_block_bidirectional_mask(pad, bidir_mask)[:, None]
    elif padding_mask is not None:
        mask = padding_mask.bool()[:, None, None, :]
        is_causal = True
    else:
        mask = None
        is_causal = True

    layers = params["layers"]
    n_layers = tree_leaves(layers)[0].shape[0]
    n_full = n_layers if out_window is None else n_layers - 1
    checkpointed = resolve_remat(remat_policy)
    x = inputs_embeds
    if collect_act_stats:
        if out_window is not None or checkpointed:
            raise ValueError("collect_act_stats is a calibration-only forward: no "
                             "out_window, no remat")
        per_layer = []
        for i in range(n_layers):
            x, stats = _block(index_layer(layers, i), cfg, x, sin, cos, mask, is_causal,
                              use_flash, bidir_block, key_valid, bidir_1d,
                              collect_act_stats=True)
            per_layer.append(stats)
        stacked = {group: {key: torch.stack([st[group][key] for st in per_layer])
                           for key in group_stats}
                   for group, group_stats in per_layer[0].items()}
        return rms_norm(params["final_norm"], x, cfg.rms_norm_eps), stacked
    for i in range(n_full):
        x = run_block(_block, checkpointed, index_layer(layers, i), cfg, x, sin,
                      cos, mask, is_causal, use_flash, bidir_block, key_valid,
                      bidir_1d)
    if out_window is None:
        return rms_norm(params["final_norm"], x, cfg.rms_norm_eps)

    # Sliced final layer: Q and MLP over the window rows only, keys/values
    # over all rows, through the dense path with the window's mask rows.
    w0, wl = out_window
    last = index_layer(layers, n_layers - 1)
    if mask is not None and mask.shape[2] == s and not is_causal:
        win_mask = mask[:, :, w0:w0 + wl]
    else:
        kv_full = key_valid if key_valid is not None else padding_mask
        kv_full = torch.ones((b, s), dtype=torch.bool, device=device) \
            if kv_full is None else kv_full.bool()
        if bidir_1d is None and bidir_block is not None:
            bidir_1d = _window(b, s, bidir_block, device)
        rows = w0 + torch.arange(wl, device=device)
        allow = kv_full[:, None, :] & (
            torch.arange(s, device=device)[None, None, :] <= rows[None, :, None])
        if bidir_1d is not None:
            bidir_1d = bidir_1d.bool()
            allow = allow | (bidir_1d[:, rows][:, :, None]
                             & bidir_1d[:, None, :] & kv_full[:, None, :])
        win_mask = allow[:, None]

    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xa = rms_norm(last["attn_norm"], x, cfg.rms_norm_eps)
    xa_w = xa[:, w0:w0 + wl]
    x_w = x[:, w0:w0 + wl]
    if "wqkv" in last["attn"]:
        wqkv = last["attn"]["wqkv"]

        # Every leaf's last axis is `out`, so these are column views: of the
        # bf16 kernel, of kernel_q4 and scale_w4, whose row stride is then
        # larger than their width (the int4 kernels read it), or of the int8
        # kernel and scale_w (the kernel's column-major storage makes a column
        # view a block of whole rows in memory). A 0-d leaf, the static
        # scale_x, is the whole projection's and passes unsliced (the JAX
        # version slices it too and raises there).
        def col_slice(lo, hi):
            return {name: leaf if leaf.ndim == 0 else leaf[..., lo:hi]
                    for name, leaf in wqkv.items()}

        q = linear(col_slice(0, h * hd), xa_w).reshape(b, wl, h, hd)
        k = linear(col_slice(h * hd, (h + kv) * hd), xa).reshape(b, s, kv, hd)
        v = linear(col_slice((h + kv) * hd, (h + 2 * kv) * hd), xa
                   ).reshape(b, s, kv, hd)
    else:
        q = linear(last["attn"]["wq"], xa_w).reshape(b, wl, h, hd)
        k = linear(last["attn"]["wk"], xa).reshape(b, s, kv, hd)
        v = linear(last["attn"]["wv"], xa).reshape(b, s, kv, hd)
    q = apply_rope(q, sin[:, w0:w0 + wl], cos[:, w0:w0 + wl])
    k = apply_rope(k, sin, cos)
    o = attention(q, k, v, mask=win_mask)
    x_w = x_w + linear(last["attn"]["wo"], o.reshape(b, wl, h * hd))
    xm = rms_norm(last["mlp_norm"], x_w, cfg.rms_norm_eps)
    x_w = x_w + _mlp(last["mlp"], xm)
    return rms_norm(params["final_norm"], x_w, cfg.rms_norm_eps)


def lm_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Post-norm hidden states (..., D) -> vocab logits (..., V) in fp32,
    the JAX `jnp.dot(hidden, lm_head, preferred_element_type=float32)`.

    A bf16 product rounded to bf16 ties and flips the argmax over 32,064
    logits, so bf16 operands give fp32 products without an fp32 copy of the
    kernel: on CUDA the library's `torch.mm(..., out_dtype=torch.float32)`;
    on the CPU, which has no such op, both operands upcast (bf16 values are
    exact in fp32), the plain version. An fp32 tree computes in fp32.
    """
    w = params["lm_head"]["kernel"]
    h2 = hidden.reshape(-1, hidden.shape[-1])
    if h2.is_cuda and h2.dtype == w.dtype == torch.bfloat16:
        out = torch.mm(h2, w, out_dtype=torch.float32)
    else:
        out = h2.float() @ w.float()
    return out.reshape(*hidden.shape[:-1], w.shape[-1])


@dataclasses.dataclass
class KVCache:
    """Static-shape K/V cache: k/v (L, B, T_max, Hkv, Dh) post-RoPE, written
    in place; `index` the filled length, a Python int, so that a decode loop
    reads it without a device sync; `valid` (B, T_max) bool on the device,
    the real (non-pad) cached positions."""

    k: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    index: int = 0

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device="cpu") -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch, max_len), dtype=torch.bool, device=device))


def llama_prefill(params: Params, cfg: LlamaConfig, inputs_embeds: torch.Tensor,
                  cache: KVCache, positions: Optional[torch.Tensor] = None,
                  key_valid: Optional[torch.Tensor] = None,
                  use_flash="auto") -> Tuple[torch.Tensor, KVCache]:
    """Causal prefill that fills `cache` from row 0; returns (post-final-norm
    hidden (B, S, D), cache), with `cache.index` = S and `cache.valid`'s
    first S columns = key_valid. The cache is written in place (the JAX
    version returns a new one), so that no second copy of it is made.

    key_valid: (B, S) bool, False for (left-)padded positions, which are
    then excluded as keys, here and in later decode steps. use_flash: as in
    `llama_model`; on the card "auto" gives K1 every layer's attention
    (self-attention, the 1-D mask: causal and key padding, no bidirectional
    window).
    """
    b, s, _ = inputs_embeds.shape
    device = inputs_embeds.device
    h, hd = cfg.num_heads, cfg.head_dim
    use_flash = resolve_use_flash(use_flash, (b, s, h, hd), inputs_embeds.dtype, device, s)
    if positions is None:
        positions = torch.arange(s, device=device).expand(b, s)
    sin, cos = rope_sin_cos(positions, hd, cfg.rope_theta)
    if key_valid is None:
        key_valid = torch.ones((b, s), dtype=torch.bool, device=device)
    key_valid = key_valid.bool()
    layers = params["layers"]
    x = inputs_embeds
    for i in range(tree_leaves(layers)[0].shape[0]):
        p = index_layer(layers, i)
        xa = rms_norm(p["attn_norm"], x, cfg.rms_norm_eps)
        q, k, v = _qkv_proj(p["attn"], cfg, xa)
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        o = attention(q, k, v, is_causal=True, use_flash=use_flash, key_valid=key_valid)
        x = x + linear(p["attn"]["wo"], o.reshape(b, s, h * hd))
        x = x + _mlp(p["mlp"], rms_norm(p["mlp_norm"], x, cfg.rms_norm_eps))
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    cache.valid[:, :s] = key_valid
    cache.index = s
    return rms_norm(params["final_norm"], x, cfg.rms_norm_eps), cache


def llama_decode_step(params: Params, cfg: LlamaConfig, token_embed: torch.Tensor,
                      cache: KVCache, positions: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, KVCache]:
    """One cached decode step: token_embed (B, 1, D) at row `cache.index`;
    returns (post-final-norm hidden (B, 1, D), cache), the cache written in
    place (each layer's new K/V row, the row marked valid, index + 1).

    positions (B, 1): the RoPE position; by default the count of valid
    cached keys per row, not the write index, which overstates it by each
    row's left pads. The new row is marked valid before the attention,
    which is the dense path over the whole cache (one query row against
    T_max keys: K1 never takes it). Stacked int4 and int8 layers are read
    through their per-layer views, as in `llama_prefill`.
    """
    b = token_embed.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    idx = cache.index
    if idx >= cache.k.shape[2]:
        raise ValueError(f"the cache is full: {idx} of {cache.k.shape[2]} rows")
    if positions is None:
        positions = cache.valid.sum(dim=1, keepdim=True)
    sin, cos = rope_sin_cos(positions, hd, cfg.rope_theta)
    cache.valid[:, idx] = True
    mask = cache.valid[:, None, None, :]
    layers = params["layers"]
    x = token_embed
    for i in range(tree_leaves(layers)[0].shape[0]):
        p = index_layer(layers, i)
        xa = rms_norm(p["attn_norm"], x, cfg.rms_norm_eps)
        q, k, v = _qkv_proj(p["attn"], cfg, xa)
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        cache.k[i, :, idx] = k[:, 0]
        cache.v[i, :, idx] = v[:, 0]
        o = attention(q, cache.k[i], cache.v[i], mask=mask)
        x = x + linear(p["attn"]["wo"], o.reshape(b, 1, h * hd))
        x = x + _mlp(p["mlp"], rms_norm(p["mlp_norm"], x, cfg.rms_norm_eps))
    cache.index = idx + 1
    return rms_norm(params["final_norm"], x, cfg.rms_norm_eps), cache


def llama_suffix_forward(params: Params, cfg: LlamaConfig, suffix_embeds: torch.Tensor,
                         prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                         positions: torch.Tensor, attn_mask: torch.Tensor,
                         split_kv: bool = False) -> torch.Tensor:
    """Suffix rows (B, S_suf, D) through every layer, attending to the cached
    prefix K/V (L, B, T_pre, Hkv, Dh, post-RoPE) and to themselves under
    `attn_mask` (B, 1, S_suf, T_pre + S_suf) bool; `positions` (B, S_suf)
    are their logical RoPE positions. Returns post-final-norm hidden states
    (B, S_suf, D).

    The attention is the dense path on the concatenated keys (S != T, so K1
    never takes it), or with `split_kv` the two-block merge
    `attention_split_kv`, which writes no concatenated copy. The JAX version
    reads that switch from OPENVLA_SPLIT_KV while it traces; here the
    caller chooses it.
    """
    b, s, _ = suffix_embeds.shape
    h, hd = cfg.num_heads, cfg.head_dim
    sin, cos = rope_sin_cos(positions, hd, cfg.rope_theta)
    t_pre = prefix_k.shape[2]
    layers = params["layers"]
    x = suffix_embeds
    for i in range(tree_leaves(layers)[0].shape[0]):
        p = index_layer(layers, i)
        xa = rms_norm(p["attn_norm"], x, cfg.rms_norm_eps)
        q, k, v = _qkv_proj(p["attn"], cfg, xa)
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        pk, pv = prefix_k[i].to(k.dtype), prefix_v[i].to(v.dtype)
        if split_kv:
            o = attention_split_kv(q, pk, pv, k, v, mask_pre=attn_mask[..., :t_pre],
                                   mask_suf=attn_mask[..., t_pre:])
        else:
            o = attention(q, torch.cat([pk, k], dim=1), torch.cat([pv, v], dim=1),
                          mask=attn_mask)
        x = x + linear(p["attn"]["wo"], o.reshape(b, s, h * hd))
        x = x + _mlp(p["mlp"], rms_norm(p["mlp_norm"], x, cfg.rms_norm_eps))
    return rms_norm(params["final_norm"], x, cfg.rms_norm_eps)
