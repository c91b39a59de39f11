"""Fused dual vision backbone (DINOv2 primary + SigLIP fused).

Port of `openvla_oft_tpu/models/vision_backbone.py::vision_backbone_forward`
for the per-backbone layout: pixels (B, N, n_backbones, H, W, 3), both ViTs
over all N images as one batch each, features concatenated per patch, with
optional FiLM conditioning on a language embedding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from openvla_oft_tpu_torch.config import OpenVLAConfig
from openvla_oft_tpu_torch.models.vit import vit_featurize

Params = Dict[str, Any]


def featurizer_names(cfg: OpenVLAConfig) -> Tuple[str, ...]:
    return ("featurizer", "fused_featurizer")[: len(cfg.vision_configs)]


def vision_backbone_forward(params: Params, cfg: OpenVLAConfig,
                            pixels: torch.Tensor,
                            film_params: Optional[Params] = None,
                            language_embedding: Optional[torch.Tensor] = None,
                            remat_policy: Optional[str] = None) -> torch.Tensor:
    """pixels (B, N, n_backbones, H, W, 3) normalized -> (B, N*patches, vision_dim).

    With `cfg.fast_gelu` the exact-erf GELU MLPs (DINOv2) use
    `gelu_erf_fast`; tanh and quick variants are already exp-based.
    film_params ({featurizer name: FiLM params}) + language_embedding (B,
    llm_dim): FiLM in each ViT, the embedding repeated for each of a row's N
    images. remat_policy: activation remat of each ViT block (training).
    """
    if "joint" in params:
        raise NotImplementedError(
            "the joint ViT-pair layout is not carried over (ROADMAP queue 1, item 18)")
    b, n, nb, h, w, _ = pixels.shape
    names = featurizer_names(cfg)
    if nb != len(names):
        raise ValueError(f"expected {len(names)} backbone channel groups, got {nb}")
    vision_configs = cfg.vision_configs
    if cfg.fast_gelu:
        vision_configs = tuple(
            dataclasses.replace(v, act="gelu_erf_fast") if v.act == "gelu" else v
            for v in vision_configs)
    film = film_params is not None and language_embedding is not None
    le = language_embedding.repeat_interleave(n, 0) if film else None    # (B*N, llm_dim)
    feats = []
    for i, (name, vcfg) in enumerate(zip(names, vision_configs)):
        imgs = pixels[:, :, i].reshape(b * n, h, w, 3)
        f = vit_featurize(params[name], vcfg, imgs, film_params[name] if film else None, le,
                          remat_policy=remat_policy)
        feats.append(f.reshape(b, n * vcfg.num_patches, vcfg.width))
    return feats[0] if len(feats) == 1 else torch.cat(feats, dim=-1)
