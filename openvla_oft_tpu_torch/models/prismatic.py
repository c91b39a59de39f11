"""Prismatic VLM + OpenVLA action prediction: the training forward and the
serving prefill.

Port of `openvla_oft_tpu/models/prismatic.py` (`prismatic_forward`,
`predict_action_hidden` and their helpers), L1 head. FiLM conditions the
ViTs in serving (`predict_action_hidden`), not yet in training.

Training (`prismatic_forward`): right-padded batches as the collator emits
them, physical layout [BOS][patches (+proprio)][text rest][PAD], action-token
embeddings zeroed, and a per-row bidirectional window over the action slots
and the STOP that follows them.

Serving (`predict_action_hidden`): the prompt is LEFT-padded into a static
bucket and a per-row gather places the tokens in their logical order:

    [pads (p)][BOS][patches (+proprio)][prompt rest][action slots][STOP]

so attention is causal + key padding + a static bidirectional window over the
action slots and STOP, and the action-slot hidden states are a static tail
slice. RoPE positions are (physical index - pad count).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

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
from openvla_oft_tpu_torch.models.llama import embed_tokens, llama_model
from openvla_oft_tpu_torch.models.projector import proprio_projector, vision_projector
from openvla_oft_tpu_torch.models.vision_backbone import vision_backbone_forward
from openvla_oft_tpu_torch.ops.masks import get_all_actions_mask

Params = Dict[str, Any]


def _patch_block(params: Params, cfg: OpenVLAConfig, pixels: torch.Tensor,
                 language_embedding: Optional[torch.Tensor],
                 proprio: Optional[torch.Tensor], dtype,
                 remat_policy: Optional[str] = None) -> torch.Tensor:
    """Vision features (FiLM-conditioned with `cfg.use_film`) -> projector
    (+ one proprio token), in `dtype`."""
    film = params.get("film") if cfg.use_film else None
    feats = vision_backbone_forward(params["vision_backbone"], cfg, pixels.to(dtype),
                                    film_params=film, language_embedding=language_embedding,
                                    remat_policy=remat_policy)
    proj = vision_projector(params["projector"], feats,
                            fast_gelu=cfg.fast_gelu).to(dtype)
    if proprio is None:
        return proj
    p_tok = proprio_projector(params["proprio_projector"], proprio.float())
    return torch.cat([proj, p_tok[:, None, :].to(dtype)], dim=1)


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
    logits: Optional[torch.Tensor]         # always None: lm_head is not ported
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
    """
    if isinstance(cfg.llm, PhiConfig):
        raise NotImplementedError("Phi-2 is not ported yet (ROADMAP queue 1, item 16)")
    if cfg.use_film:
        raise NotImplementedError("FiLM in training is not ported yet (ROADMAP queue 1, item 14)")
    if noisy_actions is not None or diffusion_t_emb is not None:
        raise NotImplementedError(
            "the diffusion objective is not ported yet (ROADMAP queue 1, item 14)")
    if compute_logits:
        raise NotImplementedError(
            "logits (the discrete objective) are not ported yet (ROADMAP queue 1, item 14)")
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
    return ForwardOutput(hidden, None, mm_labels, actions_hidden, all_actions_mask)


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
    actions_hidden: torch.Tensor          # (B, chunk_len, D)


def predict_action_hidden(params: Params, cfg: OpenVLAConfig,
                          platform: PlatformSpec, input_ids: torch.Tensor,
                          prompt_mask: torch.Tensor, pixels: torch.Tensor,
                          proprio: Optional[torch.Tensor] = None,
                          use_flash="auto", collect_act_stats: bool = False):
    """One prefill with parallel decoding; returns the action-slot hidden
    states (the rows whose NEXT token is an action slot).

    input_ids / prompt_mask (B, P) left-padded; pixels (B, N, n_backbones,
    H, W, 3). use_flash: True | False | "auto" (kernel K1 where it takes the
    call, see ops/attention.py::resolve_use_flash).
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
        if cfg.use_film else None
    patch_embeds = _patch_block(params, cfg, pixels, lang, proprio, dtype)
    n_patch = patch_embeds.shape[1]
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
    return PredictOutput(actions_hidden)


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
