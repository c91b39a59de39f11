"""Prismatic VLM + OpenVLA action prediction: the training forward and the
serving prefill.

Port of `openvla_oft_tpu/models/prismatic.py` (`prismatic_forward`,
`predict_action_hidden` and their helpers, the diffusion head's serving
path: `compute_patch_features`, `DiffusionPrefix`, `build_diffusion_prefix`,
`diffusion_suffix_step`, and the discrete head's: `lm_logits`, the
KV-cached greedy decode `predict_action_autoregressive`,
`detokenize_discrete_actions`). FiLM conditions the ViTs in serving, not
yet in training.

Training (`prismatic_forward`): right-padded batches as the collator emits
them, physical layout [BOS][patches (+proprio)][text rest][PAD], action-token
embeddings zeroed, and a per-row bidirectional window over the action slots
and the STOP that follows them.

Serving (`predict_action_hidden`): the prompt is LEFT-padded into a static
bucket and a per-row gather places the tokens in their logical order:

    [pads (p)][BOS][patches (+proprio)][prompt rest][action slots][STOP]

so attention is causal + key padding + a static bidirectional window over the
action slots and STOP, and the action-slot hidden states are a static tail
slice. RoPE positions are (physical index - pad count). The diffusion
head's steps put the timestep token after the patch block and the projected
noisy actions in the action slots. The autoregressive decode (vanilla
OpenVLA) uses the same layout without the action slots and STOP.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from openvla_oft_tpu_torch.config import OpenVLAConfig, PhiConfig
from openvla_oft_tpu_torch.constants import (
    EMPTY_TOKEN_ID,
    IGNORE_INDEX,
    STOP_INDEX,
    NormalizationType,
    PlatformSpec,
)
from openvla_oft_tpu_torch.models.llama import (KVCache, embed_tokens, llama_decode_step,
                                               llama_model, llama_prefill,
                                               llama_suffix_forward)
from openvla_oft_tpu_torch.models.llama import lm_logits as llama_lm_logits
from openvla_oft_tpu_torch.models.projector import (noisy_action_projector,
                                                   proprio_projector, vision_projector)
from openvla_oft_tpu_torch.models.vision_backbone import vision_backbone_forward
from openvla_oft_tpu_torch.ops.masks import (get_all_actions_mask,
                                            make_block_bidirectional_mask)

Params = Dict[str, Any]


def lm_logits(llm_params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 vocab logits of post-norm hidden states (`models/llama.py::
    lm_logits`). A biased lm_head is Phi-2's, which is not ported."""
    if "bias" in llm_params["lm_head"]:
        raise NotImplementedError("Phi-2's biased lm_head is not ported yet (ROADMAP "
                                  "queue 1, item 16)")
    return llama_lm_logits(llm_params, hidden)


def _patch_block(params: Params, cfg: OpenVLAConfig, pixels: torch.Tensor,
                 language_embedding: Optional[torch.Tensor],
                 proprio: Optional[torch.Tensor], dtype,
                 remat_policy: Optional[str] = None,
                 diffusion_t_emb: Optional[torch.Tensor] = None,
                 precomputed_patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vision features (FiLM-conditioned with `cfg.use_film`) -> projector
    (+ one proprio token)(+ the diffusion timestep token (B, 1, D)), in
    `dtype`. `precomputed_patches` (`compute_patch_features`) stands in for
    the ViTs and the projector: the diffusion loop computes them once."""
    if precomputed_patches is not None:
        proj = precomputed_patches.to(dtype)
    else:
        film = params.get("film") if cfg.use_film else None
        feats = vision_backbone_forward(params["vision_backbone"], cfg, pixels.to(dtype),
                                        film_params=film,
                                        language_embedding=language_embedding,
                                        remat_policy=remat_policy)
        proj = vision_projector(params["projector"], feats,
                                fast_gelu=cfg.fast_gelu).to(dtype)
    extra = []
    if proprio is not None:
        p_tok = proprio_projector(params["proprio_projector"], proprio.float())
        extra.append(p_tok[:, None, :].to(dtype))
    if diffusion_t_emb is not None:
        extra.append(diffusion_t_emb.to(dtype))
    return torch.cat([proj] + extra, dim=1) if extra else proj


def _noisy_action_tokens(params: Params, noisy_actions: torch.Tensor, dtype) -> torch.Tensor:
    """(B, chunk, action_dim) noisy actions -> one token per scalar action,
    (B, chunk_len, D) in `dtype`, for the action slots."""
    flat = noisy_actions.reshape(noisy_actions.shape[0], -1)[..., None]
    return noisy_action_projector(params["noisy_action_projector"], flat).to(dtype)


def _film_language_embedding(params: Params, input_ids: torch.Tensor,
                             prompt_mask: torch.Tensor, dtype) -> torch.Tensor:
    """The FiLM conditioning vector of the serving path: the masked mean of
    the prompt's token embeddings and one STOP embedding (the reference
    averages BOS + prompt + STOP at batch-1 inference,
    film_vit_wrapper.py:241-242). (B, llm_dim) fp32."""
    b = input_ids.shape[0]
    prompt_mask = prompt_mask.bool()
    text_embeds = embed_tokens(params["llm"], input_ids).to(dtype) * prompt_mask[..., None]
    stop_ids = torch.full((b, 1), STOP_INDEX, dtype=input_ids.dtype, device=input_ids.device)
    stop_embed = embed_tokens(params["llm"], stop_ids).to(dtype)
    valid = torch.cat([prompt_mask, torch.ones((b, 1), dtype=torch.bool,
                                               device=prompt_mask.device)], dim=1)
    return _masked_mean_language_embedding(torch.cat([text_embeds, stop_embed], dim=1), valid)


def _masked_mean_language_embedding(text_embeds: torch.Tensor,
                                    valid: torch.Tensor) -> torch.Tensor:
    """Mean of the valid text embeddings in fp32 (pads excluded, as the
    reference's batch-1 inference has none)."""
    w = valid.float()[..., None]
    return (text_embeds.float() * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)


class ForwardOutput(NamedTuple):
    hidden_states: torch.Tensor            # (B, S_mm, D) post-final-norm
    logits: Optional[torch.Tensor]         # (B, S_mm, V) fp32 with compute_logits, else None
    multimodal_labels: torch.Tensor        # (B, S_mm)
    actions_hidden: torch.Tensor           # (B, chunk_len, D) at action slots
    all_actions_mask: torch.Tensor         # (B, S_txt) action positions


def prismatic_forward(params: Params, cfg: OpenVLAConfig, platform: PlatformSpec,
                      input_ids: torch.Tensor, attention_mask: torch.Tensor,
                      pixels: torch.Tensor, labels: torch.Tensor,
                      proprio: Optional[torch.Tensor] = None,
                      noisy_actions: Optional[torch.Tensor] = None,
                      diffusion_t_emb: Optional[torch.Tensor] = None,
                      use_flash="auto", compute_logits: bool = False,
                      remat_policy: Optional[str] = None) -> ForwardOutput:
    """The training forward (reference `PrismaticForConditionalGeneration.
    forward`, modeling_prismatic.py:575-675, plus the fine-tune hidden-state
    gather, vla-scripts/finetune.py:384-394).

    input_ids / attention_mask / labels (B, S_txt) right-padded; pixels
    (B, N, n_backbones, H, W, 3). use_flash: True | False | "auto" (K1/K2/K3
    where K1 takes the call, see ops/attention.py::resolve_use_flash).
    compute_logits: also the fp32 logits over every row (the discrete
    objective's input; the objective itself is ROADMAP queue 1, item 14).
    """
    if isinstance(cfg.llm, PhiConfig):
        raise NotImplementedError("Phi-2 is not ported yet (ROADMAP queue 1, item 16)")
    if cfg.use_film:
        raise NotImplementedError("FiLM in training is not ported yet (ROADMAP queue 1, item 14)")
    if noisy_actions is not None or diffusion_t_emb is not None:
        raise NotImplementedError(
            "the diffusion objective is not ported yet (ROADMAP queue 1, item 14)")
    b = input_ids.shape[0]
    dtype = params["llm"]["embed"]["embedding"].dtype
    device = input_ids.device
    pad_mask = attention_mask.bool()

    all_actions_mask = get_all_actions_mask(labels, platform.action_dim)
    text_embeds = embed_tokens(params["llm"], input_ids).to(dtype) \
        * (~all_actions_mask)[..., None]
    patch_embeds = _patch_block(params, cfg, pixels, None, proprio, dtype, remat_policy)
    n_patch = patch_embeds.shape[1]

    # Physical layout: [BOS][patch block][rest of text] (insertion after BOS,
    # reference `_build_multimodal_attention`, modeling_prismatic.py:462-486).
    mm_embeds = torch.cat([text_embeds[:, :1], patch_embeds, text_embeds[:, 1:]], dim=1)
    none = torch.zeros((b, 1 + n_patch), dtype=torch.bool, device=device)
    mm_pad = torch.cat([pad_mask[:, :1], ~none[:, 1:], pad_mask[:, 1:]], dim=1)
    # The bidirectional window spans the action slots AND the STOP after them
    # (modeling_prismatic.py:742); the gather mask stays actions-only.
    after_action = torch.nn.functional.pad(all_actions_mask[:, :-1], (1, 0))
    attn_bidir_txt = all_actions_mask | ((input_ids == STOP_INDEX) & after_action)
    mm_actions = torch.cat([none, all_actions_mask[:, 1:]], dim=1)
    mm_bidir = torch.cat([none, attn_bidir_txt[:, 1:]], dim=1)
    ignore = torch.full((b, n_patch), IGNORE_INDEX, dtype=labels.dtype, device=device)
    mm_labels = torch.cat([labels[:, :1], ignore, labels[:, 1:]], dim=1)

    hidden = llama_model(params["llm"], cfg.llm, mm_embeds, padding_mask=mm_pad,
                         bidir_mask=mm_bidir, use_flash=use_flash,
                         remat_policy=remat_policy)

    # Hidden states at positions whose NEXT token is an action token: the
    # multimodal action mask shifted left by one.
    predictor = torch.cat([mm_actions[:, 1:], none[:, :1]], dim=1)
    actions_hidden = _gather_mask_rows(hidden, predictor, platform.chunk_len)
    logits = lm_logits(params["llm"], hidden) if compute_logits else None
    return ForwardOutput(hidden, logits, mm_labels, actions_hidden, all_actions_mask)


def _gather_mask_rows(x: torch.Tensor, mask: torch.Tensor, count: int) -> torch.Tensor:
    """Per row, the first `count` True positions of `mask` gathered from x:
    (B, count, D). Rows must hold at least `count` Trues."""
    idx = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, :count]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _left_padded_layout(text_embeds: torch.Tensor, patch_embeds: torch.Tensor,
                        prompt_mask: torch.Tensor,
                        tail_embeds: Optional[torch.Tensor] = None):
    """staged [text (P)][patches][tail] -> [pads][BOS][patches][text rest][tail]
    by a per-row gather. Returns (embeds, positions, key_valid, pad_counts)."""
    b, p_len = prompt_mask.shape
    n_patch = patch_embeds.shape[1]
    parts = [text_embeds, patch_embeds]
    if tail_embeds is not None:
        parts.append(tail_embeds)
    staged = torch.cat(parts, dim=1)
    s = staged.shape[1]
    pad_counts = p_len - prompt_mask.long().sum(dim=1)
    i = torch.arange(s, device=staged.device)[None, :]
    p = pad_counts[:, None]
    src = torch.where(
        i <= p, i,
        torch.where(i < p + 1 + n_patch, p_len + (i - (p + 1)),      # patches
                    torch.where(i < p_len + n_patch, i - n_patch,    # text rest
                                i)))                                 # tail
    embeds = torch.gather(staged, 1, src[..., None].expand(b, s, staged.shape[-1]))
    positions = torch.clamp(i - p, min=0)
    key_valid = i >= p
    return embeds, positions, key_valid, pad_counts


class PredictOutput(NamedTuple):
    actions_hidden: torch.Tensor                    # (B, chunk_len, D)
    action_logits: Optional[torch.Tensor] = None    # (B, chunk_len, V) fp32 if asked for


def compute_patch_features(params: Params, cfg: OpenVLAConfig, input_ids: torch.Tensor,
                           prompt_mask: torch.Tensor, pixels: torch.Tensor) -> torch.Tensor:
    """The projected vision patches of the serving path (FiLM-conditioned as
    `predict_action_hidden` conditions them), computed once for a diffusion
    loop (reference modeling_prismatic.py:810); the proprio and timestep
    tokens are appended per call (`precomputed_patches`)."""
    dtype = params["llm"]["embed"]["embedding"].dtype
    lang = _film_language_embedding(params, input_ids, prompt_mask.bool(), dtype) \
        if cfg.use_film else None
    return _patch_block(params, cfg, pixels, lang, None, dtype)


def predict_action_hidden(params: Params, cfg: OpenVLAConfig,
                          platform: PlatformSpec, input_ids: torch.Tensor,
                          prompt_mask: torch.Tensor, pixels: torch.Tensor,
                          proprio: Optional[torch.Tensor] = None,
                          use_flash="auto", collect_act_stats: bool = False,
                          noisy_actions: Optional[torch.Tensor] = None,
                          diffusion_t_emb: Optional[torch.Tensor] = None,
                          precomputed_patches: Optional[torch.Tensor] = None,
                          compute_logits: bool = False):
    """One prefill with parallel decoding; returns the action-slot hidden
    states (the rows whose NEXT token is an action slot), and with
    `compute_logits` their fp32 logits (the discrete head's).

    input_ids / prompt_mask (B, P) left-padded; pixels (B, N, n_backbones,
    H, W, 3). use_flash: True | False | "auto" (kernel K1 where it takes the
    call, see ops/attention.py::resolve_use_flash).
    A diffusion step passes noisy_actions (B, chunk, action_dim), projected
    into the action slots (`noisy_action_projector`), and diffusion_t_emb
    (B, 1, D), the timestep token after the patch block; with
    precomputed_patches (`compute_patch_features`) the ViTs do not run.
    collect_act_stats: static-quant calibration (`ops/quant_calibrate.py::
    attach_static_act_scales`): the full-width forward on the dense path,
    as the JAX version runs it, returning (PredictOutput, stats) with the
    LLM linears' per-layer input absmaxes (`llama_model`).
    """
    if isinstance(cfg.llm, PhiConfig):
        raise NotImplementedError("Phi-2 is not ported yet (ROADMAP queue 1, item 16)")
    b, p_len = input_ids.shape
    chunk = platform.chunk_len
    dtype = params["llm"]["embed"]["embedding"].dtype
    prompt_mask = prompt_mask.bool()

    text_embeds = embed_tokens(params["llm"], input_ids).to(dtype) * prompt_mask[..., None]
    lang = _film_language_embedding(params, input_ids, prompt_mask, dtype) \
        if cfg.use_film and precomputed_patches is None else None
    patch_embeds = _patch_block(params, cfg, pixels, lang, proprio, dtype,
                                diffusion_t_emb=diffusion_t_emb,
                                precomputed_patches=precomputed_patches)
    n_patch = patch_embeds.shape[1]
    if noisy_actions is not None:
        action_embeds = _noisy_action_tokens(params, noisy_actions, dtype)
    else:
        action_embeds = torch.zeros((b, chunk, cfg.llm_dim), dtype=dtype,
                                    device=text_embeds.device)
    stop_ids = torch.full((b, 1), STOP_INDEX, dtype=input_ids.dtype,
                          device=input_ids.device)
    stop_embeds = embed_tokens(params["llm"], stop_ids).to(dtype)
    embeds, positions, key_valid, _ = _left_padded_layout(
        text_embeds, patch_embeds, prompt_mask,
        tail_embeds=torch.cat([action_embeds, stop_embeds], dim=1))
    s = p_len + n_patch + chunk + 1
    # Bidirectional window: the action slots and the trailing STOP.
    window = (p_len + n_patch, chunk + 1)
    bidir = torch.zeros((b, s), dtype=torch.bool, device=embeds.device)
    bidir[:, window[0]:window[0] + chunk + 1] = True
    # Predictor rows: the last prompt token through the second-to-last slot.
    start = p_len + n_patch - 1
    if collect_act_stats:
        hidden, stats = llama_model(params["llm"], cfg.llm, embeds, positions=positions,
                                    padding_mask=key_valid, bidir_mask=bidir,
                                    use_flash=False, bidir_block=window,
                                    collect_act_stats=True)
        return PredictOutput(hidden[:, start:start + chunk]), stats
    actions_hidden = llama_model(params["llm"], cfg.llm, embeds,
                                 positions=positions, padding_mask=key_valid,
                                 bidir_mask=bidir, use_flash=use_flash,
                                 bidir_block=window, out_window=(start, chunk))
    logits = lm_logits(params["llm"], actions_hidden) if compute_logits else None
    return PredictOutput(actions_hidden, logits)


class DiffusionPrefix(NamedTuple):
    """What the DDIM steps of one request share.

    The sequence [BOS][patches][proprio][t][prompt][actions][STOP] (the
    timestep token follows patches and proprio, reference
    modeling_prismatic.py:826-830) has a prefix, [BOS][patches][proprio],
    that is the same in every step: it precedes the timestep token, so under
    causal attention nothing in it depends on the step. Its K/V is computed
    once; each step forwards only the suffix [t][pads][prompt right-aligned]
    [actions][STOP] (`diffusion_suffix_step`), whose logical positions and
    mask give `predict_action_hidden`'s numbers.
    """

    prefix_k: torch.Tensor    # (L, B, T_pre, Hkv, Dh) post-RoPE
    prefix_v: torch.Tensor    # (L, B, T_pre, Hkv, Dh)
    text_rest: torch.Tensor   # (B, P-1, D) the prompt without BOS, pads left (zeroed)
    text_valid: torch.Tensor  # (B, P-1) bool
    pad_counts: torch.Tensor  # (B,) int
    stop_embed: torch.Tensor  # (B, 1, D)


def build_diffusion_prefix(params: Params, cfg: OpenVLAConfig, input_ids: torch.Tensor,
                           prompt_mask: torch.Tensor, pixels: torch.Tensor,
                           proprio: Optional[torch.Tensor] = None,
                           use_flash="auto") -> DiffusionPrefix:
    """The ViTs, the projector and the proprio token once, then the prefill
    of [BOS][patches][proprio] into a K/V cache (`llama_prefill`: through
    K1 on the card under "auto"). input_ids / prompt_mask (B, P) left-padded."""
    b, p_len = input_ids.shape
    dtype = params["llm"]["embed"]["embedding"].dtype
    device = input_ids.device
    prompt_mask = prompt_mask.bool()
    pad_counts = p_len - prompt_mask.long().sum(dim=1)

    text_embeds = embed_tokens(params["llm"], input_ids).to(dtype) * prompt_mask[..., None]
    lang = _film_language_embedding(params, input_ids, prompt_mask, dtype) \
        if cfg.use_film else None
    patch_embeds = _patch_block(params, cfg, pixels, lang, proprio, dtype)

    # BOS sits at physical index pad_counts of the left-padded prompt.
    d = text_embeds.shape[-1]
    bos = torch.gather(text_embeds, 1, pad_counts[:, None, None].expand(b, 1, d))
    prefix_embeds = torch.cat([bos, patch_embeds], dim=1)
    cache = KVCache.create(cfg.llm, b, prefix_embeds.shape[1], dtype=dtype, device=device)
    _, cache = llama_prefill(params["llm"], cfg.llm, prefix_embeds, cache,
                             use_flash=use_flash)

    # The suffix's text: the prompt without BOS (index pad_counts skipped),
    # the pads kept on the left.
    j = torch.arange(p_len - 1, device=device)[None, :]
    src = j + (j >= pad_counts[:, None]).long()
    text_rest = torch.gather(text_embeds, 1, src[..., None].expand(b, p_len - 1, d))
    text_valid = j >= pad_counts[:, None]
    stop_ids = torch.full((b, 1), STOP_INDEX, dtype=input_ids.dtype, device=device)
    stop_embed = embed_tokens(params["llm"], stop_ids).to(dtype)
    return DiffusionPrefix(cache.k, cache.v, text_rest, text_valid, pad_counts, stop_embed)


def diffusion_suffix_layout(prefix: DiffusionPrefix,
                            chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The suffix's logical RoPE positions (B, S_suf) and its mask (B, 1,
    S_suf, T_pre + S_suf): every prefix key, then causal with key padding
    and the bidirectional block over the actions and STOP."""
    b, n_pre = prefix.pad_counts.shape[0], prefix.prefix_k.shape[2]
    p_len = prefix.text_rest.shape[1] + 1
    s_suf = p_len + chunk + 1
    device = prefix.pad_counts.device
    i = torch.arange(s_suf, device=device)[None, :]
    # The t token continues the prefix at n_pre; each later real row sits at
    # n_pre + i - pad_count (pad rows clamp to junk and are masked out).
    positions = n_pre + torch.where(i == 0, 0,
                                    torch.clamp(i - prefix.pad_counts[:, None], min=0))
    ones = torch.ones((b, 1), dtype=torch.bool, device=device)
    key_valid = torch.cat([ones, prefix.text_valid, ones.expand(b, chunk + 1)], dim=1)
    window = (i >= p_len).expand(b, s_suf)
    suf_mask = make_block_bidirectional_mask(key_valid, window)
    mask = torch.cat([torch.ones((b, s_suf, n_pre), dtype=torch.bool, device=device),
                      suf_mask], dim=-1)[:, None]
    return positions, mask


def diffusion_suffix_step(params: Params, cfg: OpenVLAConfig, platform: PlatformSpec,
                          prefix: DiffusionPrefix, diffusion_t_emb: torch.Tensor,
                          noisy_actions: torch.Tensor, split_kv: bool = False,
                          layout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                          ) -> torch.Tensor:
    """One DDIM step's LLM work: the suffix [t][pads][prompt][actions][STOP]
    against the cached prefix (`llama_suffix_forward`, `split_kv` as
    there). diffusion_t_emb (B, 1, D); noisy_actions (B, chunk, action_dim).
    Returns actions_hidden (B, chunk_len, D), `predict_action_hidden`'s
    numbers. `layout`: `diffusion_suffix_layout(prefix, chunk_len)`, which
    depends on the request only, so a loop builds it once."""
    chunk = platform.chunk_len
    dtype = params["llm"]["embed"]["embedding"].dtype
    p_len = prefix.text_rest.shape[1] + 1
    action_embeds = _noisy_action_tokens(params, noisy_actions, dtype)
    suffix = torch.cat([diffusion_t_emb.to(dtype), prefix.text_rest, action_embeds,
                        prefix.stop_embed], dim=1)
    positions, mask = diffusion_suffix_layout(prefix, chunk) if layout is None else layout
    hidden = llama_suffix_forward(params["llm"], cfg.llm, suffix, prefix.prefix_k,
                                  prefix.prefix_v, positions, mask, split_kv=split_kv)
    # Predictor rows: the last prompt token through the second-to-last action
    # slot, suffix rows [p_len - 1, p_len - 1 + chunk).
    return hidden[:, p_len - 1:p_len - 1 + chunk]


def autoregressive_layout(params: Params, cfg: OpenVLAConfig, input_ids: torch.Tensor,
                          prompt_mask: torch.Tensor, pixels: torch.Tensor):
    """The autoregressive decode's prefill rows, [pads][BOS][patches][prompt
    rest] (no proprio, action slots or STOP; FiLM off, as in the JAX
    version): (embeds (B, S, D), positions, key_valid, pad_counts), S = P +
    patches."""
    dtype = params["llm"]["embed"]["embedding"].dtype
    prompt_mask = prompt_mask.bool()
    text_embeds = embed_tokens(params["llm"], input_ids).to(dtype) * prompt_mask[..., None]
    patch_embeds = _patch_block(params, cfg, pixels, None, None, dtype)
    return _left_padded_layout(text_embeds, patch_embeds, prompt_mask)


def predict_action_autoregressive(params: Params, cfg: OpenVLAConfig,
                                  platform: PlatformSpec, input_ids: torch.Tensor,
                                  prompt_mask: torch.Tensor, pixels: torch.Tensor,
                                  num_new_tokens: int, use_flash="auto",
                                  return_logits: bool = False):
    """Greedy KV-cached decode of `num_new_tokens` tokens, the vanilla
    OpenVLA path (reference `prismatic/models/vlas/openvla.py:36-103`):
    one causal prefill (`llama_prefill`, through K1 on the card under
    "auto") fills the cache, then each token is the argmax of the fp32
    logits of the last hidden state, and all but the last go through one
    `llama_decode_step` at RoPE position index - pad count. The JAX
    version's scan runs one decode step more, whose output nothing reads;
    the tokens are the same. The tokens stay on the device until the caller
    reads them. Returns (B, num_new_tokens) int64 token ids, and with
    `return_logits` also each step's logits (B, num_new_tokens, V) fp32.

    input_ids / prompt_mask (B, P) left-padded; pixels (B, N, n_backbones,
    H, W, 3). `platform` is unused, as in the JAX version's signature.
    """
    if isinstance(cfg.llm, PhiConfig):
        raise NotImplementedError("Phi-2's decode is not ported yet (ROADMAP queue 1, item 16)")
    if num_new_tokens < 1:
        raise ValueError(f"num_new_tokens must be at least 1, got {num_new_tokens}")
    llm = params["llm"]
    embeds, positions, key_valid, pad_counts = autoregressive_layout(
        params, cfg, input_ids, prompt_mask, pixels)
    b, s, _ = embeds.shape
    cache = KVCache.create(cfg.llm, b, s + num_new_tokens - 1, dtype=embeds.dtype,
                           device=embeds.device)
    hidden, cache = llama_prefill(llm, cfg.llm, embeds, cache, positions=positions,
                                  key_valid=key_valid, use_flash=use_flash)
    last = hidden[:, -1:]
    tokens = torch.empty((b, num_new_tokens), dtype=torch.long, device=embeds.device)
    all_logits = []
    for step in range(num_new_tokens):
        logits = lm_logits(llm, last)[:, 0]                          # (B, V) fp32
        tokens[:, step] = logits.argmax(dim=-1)
        if return_logits:
            all_logits.append(logits)
        if step + 1 < num_new_tokens:
            emb = embed_tokens(llm, tokens[:, step:step + 1]).to(embeds.dtype)
            last, cache = llama_decode_step(llm, cfg.llm, emb, cache,
                                            positions=(cache.index - pad_counts)[:, None])
    if return_logits:
        return tokens, torch.stack(all_logits, dim=1)
    return tokens


def detokenize_discrete_actions(action_token_ids: np.ndarray, cfg: OpenVLAConfig,
                                platform: PlatformSpec) -> np.ndarray:
    """Argmax token ids (..., chunk_len) -> normalized actions (...,
    num_actions_chunk, action_dim), on the host (reference
    modeling_prismatic.py:929-942, action_tokenizer.py:56-72): the id's
    distance below the true vocab size picks one of the 255 bin centres,
    clipped at both ends."""
    bins = np.linspace(-1, 1, cfg.n_action_bins)
    bin_centers = (bins[:-1] + bins[1:]) / 2.0
    disc = cfg.true_vocab_size - np.asarray(action_token_ids)
    disc = np.clip(disc - 1, 0, bin_centers.shape[0] - 1)
    return bin_centers[disc].reshape(*np.shape(action_token_ids)[:-1],
                                     platform.num_actions_chunk, platform.action_dim)


def prepare_prompt_ids(tokenizer, instruction: str, bucket: int,
                       max_length: int = 2048) -> tuple:
    """Tokenize the OFT prompt (+ the 29871 empty-token fixup) and LEFT-pad it
    to `bucket`; longer prompts escalate to the next multiple of `bucket`."""
    from openvla_oft_tpu_torch.processing.processor import build_prompt

    ids = tokenizer(build_prompt(instruction), add_special_tokens=True)["input_ids"]
    if ids[-1] != EMPTY_TOKEN_ID:
        ids = ids + [EMPTY_TOKEN_ID]
    if len(ids) > bucket:
        bucket = -(-len(ids) // bucket) * bucket
    if bucket > max_length:
        raise ValueError(f"Prompt length {len(ids)} exceeds llm_max_length {max_length}")
    pad = bucket - len(ids)
    input_ids = np.asarray([0] * pad + ids, dtype=np.int32)
    mask = np.asarray([0] * pad + [1] * len(ids), dtype=np.int32)
    return input_ids, mask


def unnormalize_actions(normalized: np.ndarray, action_stats: dict,
                        norm_type: NormalizationType) -> np.ndarray:
    """Reference `_unnormalize_actions` (modeling_prismatic.py:772-791)."""
    if norm_type == NormalizationType.BOUNDS:
        low, high = np.asarray(action_stats["min"]), np.asarray(action_stats["max"])
    elif norm_type == NormalizationType.BOUNDS_Q99:
        low, high = np.asarray(action_stats["q01"]), np.asarray(action_stats["q99"])
    else:
        raise ValueError(f"Unsupported normalization type {norm_type}")
    mask = np.asarray(action_stats.get("mask", np.ones_like(low, dtype=bool)))
    return np.where(mask, 0.5 * (normalized + 1) * (high - low + 1e-8) + low,
                    normalized)
