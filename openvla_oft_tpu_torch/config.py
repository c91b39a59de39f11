"""Model-architecture configurations (the port's own copy of
`openvla_oft_tpu/config.py`, kept identical field for field;
`tests/test_torch_import.py` checks that the two do not drift).


Replaces the reference's HF `PretrainedConfig` hierarchy
(`prismatic/extern/hf/configuration_prismatic.py:15-141`) with plain frozen
dataclasses. The registry maps the reference's `vision_backbone_id` /
`llm_backbone_id` strings to explicit architecture hyperparameters so that an
HF `config.json` written by the reference loads directly.

All sizes are static Python ints — the whole model compiles with static shapes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

from openvla_oft_tpu_torch.constants import (
    LLAMA2_VOCAB_SIZE,
    N_ACTION_BINS,
    PAD_TO_MULTIPLE_OF,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """A timm-style Vision Transformer.

    Covers both featurizers used by OpenVLA: SigLIP so400m/14@224 and
    DINOv2 ViT-L/14 with 4 register tokens (reference
    `configuration_prismatic.py:26-38` via timm model ids).
    """

    width: int
    depth: int
    num_heads: int
    mlp_dim: int
    patch_size: int = 14
    image_size: int = 224
    num_cls_tokens: int = 0       # DINOv2: 1 class token; SigLIP: 0
    num_reg_tokens: int = 0       # DINOv2 reg4: 4 register tokens
    use_layer_scale: bool = False  # DINOv2: LayerScale after attn/mlp
    # timm `no_embed_class`: position embeddings apply to patch tokens only
    # (prefix cls/reg tokens get none). True for DINOv2-reg4.
    pos_embed_patches_only: bool = False
    use_pre_norm: bool = False     # CLIP: LayerNorm before the block stack
    act: str = "gelu"              # "gelu" (exact) | "quick_gelu" (CLIP)
    mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    interpolation: str = "bicubic"

    @property
    def grid_size(self) -> int:
        # timm's stride-`patch` conv floors (e.g. SigLIP-384: 384//14 = 27,
        # dropping the last 6 pixels); patchify crops to match.
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_prefix_tokens(self) -> int:
        return self.num_cls_tokens + self.num_reg_tokens

    @property
    def head_dim(self) -> int:
        assert self.width % self.num_heads == 0
        return self.width // self.num_heads


# SigLIP so400m/14 @ 224 (timm `vit_so400m_patch14_siglip_224`).
# act: timm's siglip entries use tanh-approximate GELU (mirroring big_vision,
# whose jax.nn.gelu defaults to approximate=True; HF SiglipVisionConfig's
# default is likewise "gelu_pytorch_tanh"), and the reference's
# timm_override_act_layers is None for dinosiglip
# (configuration_prismatic.py:39-45) — so the timm default applies.
SIGLIP_SO400M_224 = ViTConfig(
    width=1152, depth=27, num_heads=16, mlp_dim=4304,
    mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), act="gelu_tanh",
)

# DINOv2 ViT-L/14 reg4 (timm `vit_large_patch14_reg4_dinov2.lvd142m`), run at 224.
DINOV2_VIT_L_224 = ViTConfig(
    width=1024, depth=24, num_heads=16, mlp_dim=4096,
    num_cls_tokens=1, num_reg_tokens=4, use_layer_scale=True,
    pos_embed_patches_only=True,
    mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
)

import dataclasses as _dc

SIGLIP_SO400M_384 = _dc.replace(SIGLIP_SO400M_224, image_size=384)
DINOV2_VIT_L_336 = _dc.replace(DINOV2_VIT_L_224, image_size=336)
DINOV2_VIT_L_384 = _dc.replace(DINOV2_VIT_L_224, image_size=384)

# CLIP ViT-L/14 (timm `vit_large_patch14_clip_*.openai`): class token, pre-norm
# before the blocks, quick-GELU activation (configuration_prismatic.py:40-45).
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CLIP_VIT_L_224 = ViTConfig(width=1024, depth=24, num_heads=16, mlp_dim=4096,
                           num_cls_tokens=1, use_pre_norm=True,
                           act="quick_gelu", mean=_CLIP_MEAN, std=_CLIP_STD)
CLIP_VIT_L_336 = _dc.replace(CLIP_VIT_L_224, image_size=336)

# IN1K ViT-L/16 (timm `vit_large_patch16_224.augreg_in21k_ft_in1k`).
IN1K_VIT_L_224 = ViTConfig(width=1024, depth=24, num_heads=16, mlp_dim=4096,
                           patch_size=16, num_cls_tokens=1,
                           mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Llama-2 family decoder config (HF `text_config` equivalent)."""

    vocab_size: int = LLAMA2_VOCAB_SIZE + PAD_TO_MULTIPLE_OF  # 32064 padded rows
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 2048
    pad_token_id: int = 32000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


LLAMA2_7B = LlamaConfig()
LLAMA2_13B = LlamaConfig(hidden_size=5120, intermediate_size=13824,
                         num_layers=40, num_heads=40, num_kv_heads=40)
# Mistral-7B (reference `llm/mistral.py`): GQA with 8 kv heads; its sliding
# window (4096) exceeds every VLA sequence here, so plain causal attention is
# exact for this workload.
MISTRAL_7B = LlamaConfig(vocab_size=32000 + PAD_TO_MULTIPLE_OF,
                         intermediate_size=14336, num_kv_heads=8,
                         max_position_embeddings=32768)


@dataclasses.dataclass(frozen=True)
class PhiConfig:
    """Phi-2 decoder config (reference `llm/phi.py:19-25` "phi-2-3b").

    Architecture differs from Llama: parallel attention+MLP residual blocks,
    LayerNorm (with bias) instead of RMSNorm, biased q/k/v/dense + fc1/fc2
    projections, partial rotary embeddings (rotary over the first
    `int(partial_rotary_factor * head_dim)` dims of each head), gelu_new MLP
    activation, and a biased lm_head. Implemented in `models/phi.py`.
    """

    vocab_size: int = 51200
    hidden_size: int = 2560
    intermediate_size: int = 10240
    num_layers: int = 32
    num_heads: int = 32
    partial_rotary_factor: float = 0.4
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    max_position_embeddings: int = 2048
    pad_token_id: int = 50256  # reference adds <|pad|> and resizes to /64

    # Phi has no GQA; mirror LlamaConfig's surface so shared code duck-types.
    @property
    def num_kv_heads(self) -> int:
        return self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.partial_rotary_factor * self.head_dim)


PHI_2 = PhiConfig()


# Reference `VISION_BACKBONE_TO_TIMM_ID` (`configuration_prismatic.py:26-38`)
# lists "dinosiglip-vit-so-224px" as [dinov2, siglip]; the reference builds
# `featurizer` from timm_model_ids[0] (`modeling_prismatic.py:100-112`), so the
# *primary* featurizer is DINOv2 and the *fused* one is SigLIP. Patch features
# concatenate [primary, fused] = [dino(1024), siglip(1152)] -> 2176, and pixel
# channels stack in the same order (processing_prismatic.py:128-148).
_VISION_REGISTRY: Dict[str, Tuple[ViTConfig, ...]] = {
    "dinosiglip-vit-so-224px": (DINOV2_VIT_L_224, SIGLIP_SO400M_224),
    "dinosiglip-vit-so-384px": (DINOV2_VIT_L_384, SIGLIP_SO400M_384),
    "dinoclip-vit-l-336px": (DINOV2_VIT_L_336, CLIP_VIT_L_336),
    "siglip-vit-so400m": (SIGLIP_SO400M_224,),
    "siglip-vit-so400m-384px": (SIGLIP_SO400M_384,),
    "dinov2-vit-l": (DINOV2_VIT_L_224,),
    "clip-vit-l": (CLIP_VIT_L_224,),
    "clip-vit-l-336px": (CLIP_VIT_L_336,),
    "in1k-vit-l": (IN1K_VIT_L_224,),
}

_LLM_REGISTRY: Dict[str, Any] = {  # LlamaConfig | PhiConfig
    "llama2-7b-pure": LLAMA2_7B,
    "llama2-7b-chat": LLAMA2_7B,
    "llama2-13b-pure": LLAMA2_13B,
    "llama2-13b-chat": LLAMA2_13B,
    "vicuna-v15-7b": LLAMA2_7B,
    "vicuna-v15-13b": LLAMA2_13B,
    "mistral-v0.1-7b-pure": MISTRAL_7B,
    "mistral-v0.1-7b-instruct": MISTRAL_7B,
    "phi-2-3b": PHI_2,
}


@dataclasses.dataclass(frozen=True)
class OpenVLAConfig:
    """Top-level model config (reference `OpenVLAConfig`, configuration_prismatic.py:129-141).

    `norm_stats` (dataset statistics for action un-normalization) is carried
    separately as a plain dict because it is data, not architecture.
    """

    vision_backbone_id: str = "dinosiglip-vit-so-224px"
    llm_backbone_id: str = "llama2-7b-pure"
    image_resize_strategy: str = "resize-naive"
    llm_max_length: int = 2048
    pad_token_id: int = 32000
    pad_to_multiple_of: int = PAD_TO_MULTIPLE_OF
    n_action_bins: int = N_ACTION_BINS
    num_images_in_input: int = 1
    use_film: bool = False
    # Serving numerics lever: swap exact erf-GELU (DINOv2 MLPs + vision
    # projector) for ops/layers.py::gelu_erf_fast — sub-bf16-ulp equivalent
    # (exhaustively enumerated, tests/test_fast_gelu.py) and ~5x cheaper on
    # the VPU. Training/parity paths keep the default False.
    fast_gelu: bool = False

    @property
    def vision_configs(self) -> Tuple[ViTConfig, ...]:
        try:
            return _VISION_REGISTRY[self.vision_backbone_id]
        except KeyError:
            raise KeyError(
                f"Unknown vision_backbone_id {self.vision_backbone_id!r}; "
                f"registered: {sorted(_VISION_REGISTRY)}. Register custom "
                f"architectures in openvla_oft_tpu_torch.config._VISION_REGISTRY.")

    @property
    def use_fused_vision_backbone(self) -> bool:
        return len(self.vision_configs) == 2

    @property
    def llm(self) -> LlamaConfig:
        try:
            return _LLM_REGISTRY[self.llm_backbone_id]
        except KeyError:
            raise KeyError(
                f"Unknown llm_backbone_id {self.llm_backbone_id!r}; "
                f"registered: {sorted(_LLM_REGISTRY)}. Register custom "
                f"architectures in openvla_oft_tpu_torch.config._LLM_REGISTRY.")

    @property
    def vision_dim(self) -> int:
        """Concatenated featurizer width (2176 for DINOv2+SigLIP)."""
        return sum(v.width for v in self.vision_configs)

    @property
    def num_patches_per_image(self) -> int:
        return self.vision_configs[0].num_patches

    @property
    def llm_dim(self) -> int:
        return self.llm.hidden_size

    @property
    def true_vocab_size(self) -> int:
        """Vocab size used for action de-tokenization (reference
        `modeling_prismatic.py:731-732`): padded vocab minus pad rows."""
        return self.llm.vocab_size - self.pad_to_multiple_of

    # === HF config.json interop ===
    @classmethod
    def from_hf_config(cls, hf: dict) -> "OpenVLAConfig":
        """Build from a reference-written `config.json` dict.

        Checkpoints exported by this framework carry self-describing
        `tpu_vision_configs` / `tpu_llm_config` payloads
        (utils/hf_import.py::export_openvla_checkpoint); unknown backbone ids
        are auto-registered from them so a fresh process can load any export
        without pre-registering tiny/custom architectures."""
        vb = hf.get("vision_backbone_id", "dinosiglip-vit-so-224px")
        lb = hf.get("llm_backbone_id", "llama2-7b-pure")
        if vb not in _VISION_REGISTRY and "tpu_vision_configs" in hf:
            _VISION_REGISTRY[vb] = tuple(
                ViTConfig(**{k: tuple(x) if isinstance(x, list) else x
                             for k, x in v.items()})
                for v in hf["tpu_vision_configs"])
        if lb not in _LLM_REGISTRY and "tpu_llm_config" in hf:
            _LLM_REGISTRY[lb] = LlamaConfig(
                **{k: tuple(x) if isinstance(x, list) else x
                   for k, x in hf["tpu_llm_config"].items()})
        return cls(
            vision_backbone_id=hf.get("vision_backbone_id", "dinosiglip-vit-so-224px"),
            llm_backbone_id=hf.get("llm_backbone_id", "llama2-7b-pure"),
            image_resize_strategy=hf.get("image_resize_strategy", "resize-naive"),
            llm_max_length=hf.get("llm_max_length", 2048),
            pad_token_id=hf.get("pad_token_id", 32000),
            pad_to_multiple_of=hf.get("pad_to_multiple_of", PAD_TO_MULTIPLE_OF),
            n_action_bins=hf.get("n_action_bins", N_ACTION_BINS),
        )

    @classmethod
    def from_json_file(cls, path: str) -> Tuple["OpenVLAConfig", Optional[dict]]:
        """Load (config, norm_stats) from an HF-format config.json."""
        with open(path) as f:
            hf = json.load(f)
        return cls.from_hf_config(hf), hf.get("norm_stats")


# Tiny configs for tests: keep every contract (dual backbone, reg tokens,
# LayerScale, GQA-free Llama) at toy sizes so CPU tests are fast.
TINY_SIGLIP = ViTConfig(width=32, depth=3, num_heads=4, mlp_dim=64, patch_size=14,
                        image_size=28, act="gelu_tanh")
TINY_DINOV2 = ViTConfig(width=48, depth=3, num_heads=4, mlp_dim=96, patch_size=14,
                        image_size=28, num_cls_tokens=1, num_reg_tokens=4,
                        use_layer_scale=True, pos_embed_patches_only=True,
                        mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
TINY_LLAMA = LlamaConfig(vocab_size=32064, hidden_size=64, intermediate_size=128,
                         num_layers=2, num_heads=4, num_kv_heads=4,
                         max_position_embeddings=4096)
