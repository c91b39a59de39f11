"""The serving hot path and a policy object for the L1, diffusion and discrete heads.

Port of `openvla_oft_tpu/policy.py::serve_action_chunk` and
`OpenVLAPolicy` (`predict_action_from_frames`, the staged `predict_action`,
`_diffusion_loop`): uint8 camera frames -> device preprocessing -> prefill
with parallel decoding -> L1 head -> device un-normalization; or, with
`head="diffusion"`, normalized pixels -> the reverse DDIM loop (the
[BOS][patches][proprio] prefix K/V computed once, each step a suffix
forward, the noise predictor and `DDIMScheduler.step`) -> host
un-normalization; or, with `head="discrete"`, the same prefill with
parallel decoding -> fp32 logits of the action rows -> argmax on the
device -> host de-tokenization and un-normalization. Nothing is compiled;
the functions run eagerly, and the JAX version's `lax.scan` over the DDIM
steps is a Python loop.

An int4-quantized LLM (`ops/quant.py::quantize_tree`, the `load_in_4bit`
path) runs W4A16 by default and W4A8 with `int4_a8=True`; with
`vit_fused=True` the ViTs' folded LN -> qkv and LN -> fc1 run as kernel K4.
Both are chosen here by the caller rather than read from the environment.
int8 weights (`load_in_8bit`, `load_vision_in_8bit`) need no switch: each
int8 linear runs W8A8 (`ops/quant.py::int8_linear`), static where the tree
carries calibrated `scale_x` leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from openvla_oft_tpu_torch.config import OpenVLAConfig
from openvla_oft_tpu_torch.constants import NormalizationType, PlatformSpec
from openvla_oft_tpu_torch.models.action_heads import (diffusion_predict_noise,
                                                     diffusion_scheduler, l1_head_predict,
                                                     sinusoidal_time_encoding)
from openvla_oft_tpu_torch.models.prismatic import (build_diffusion_prefix,
                                                   compute_patch_features,
                                                   detokenize_discrete_actions,
                                                   diffusion_suffix_layout,
                                                   diffusion_suffix_step,
                                                   predict_action_hidden, prepare_prompt_ids,
                                                   unnormalize_actions)
from openvla_oft_tpu_torch.ops.ddim import DDIMScheduler
from openvla_oft_tpu_torch.ops.quant import int4_a8 as int4_a8_mode
from openvla_oft_tpu_torch.ops.vit_fused import vit_fused as vit_fused_mode
from openvla_oft_tpu_torch.processing.image_processing import device_preprocess

Params = Dict[str, Any]


def normalize_proprio(proprio: torch.Tensor, low: torch.Tensor, high: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      zero: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bounds normalization to [-1, 1]: masked-out dims pass through clipped,
    degenerate dims (`zero`, by default low == high) map to 0."""
    scaled = torch.clamp(2.0 * (proprio - low) / (high - low + 1e-8) - 1.0, -1.0, 1.0)
    if mask is None:
        mask = torch.ones_like(low, dtype=torch.bool)
    out = torch.where(mask, scaled, torch.clamp(proprio, -1.0, 1.0))
    if zero is None:
        zero = low == high
    return torch.where(zero, torch.zeros_like(out), out)


def serve_action_chunk(params: Params, cfg: OpenVLAConfig, platform: PlatformSpec,
                       frames_u8: torch.Tensor, input_ids: torch.Tensor,
                       prompt_mask: torch.Tensor, proprio: Optional[torch.Tensor],
                       action_low: torch.Tensor, action_high: torch.Tensor,
                       action_mask: torch.Tensor,
                       proprio_low: Optional[torch.Tensor] = None,
                       proprio_high: Optional[torch.Tensor] = None,
                       proprio_mask: Optional[torch.Tensor] = None,
                       proprio_zero: Optional[torch.Tensor] = None,
                       use_flash="auto", center_crop: bool = True,
                       resize_size: int = 224, fast_gelu: bool = True,
                       int4_a8: bool = False, vit_fused: bool = False) -> torch.Tensor:
    """frames_u8 (B, N, H, W, 3) uint8 -> unnormalized actions
    (B, num_actions_chunk, action_dim) fp32.

    fast_gelu (the serving default) swaps exact erf-GELU for `gelu_erf_fast`;
    False keeps exact GELU. int4_a8: int4 linears run W4A8 (kernel K6)
    instead of W4A16 (K5); no effect on a model without int4 weights.
    vit_fused: the ViTs' folded LN + qkv and LN + fc1 (+ GELU, exact erf)
    run as `ln_matmul` (kernel K4 on CUDA); no effect on unfolded norms.
    """
    if fast_gelu and not cfg.fast_gelu:
        cfg = dataclasses.replace(cfg, fast_gelu=True)
    b, n = frames_u8.shape[:2]
    flat = frames_u8.reshape((b * n,) + tuple(frames_u8.shape[2:]))
    pixels = device_preprocess(cfg, flat, resize_size=resize_size,
                               center_crop=center_crop)
    pixels = pixels.reshape((b, n) + tuple(pixels.shape[1:]))
    if proprio is not None and proprio_low is not None:
        proprio = normalize_proprio(proprio, proprio_low, proprio_high,
                                    proprio_mask, proprio_zero)
    with int4_a8_mode(int4_a8), vit_fused_mode(vit_fused):
        out = predict_action_hidden(params, cfg, platform, input_ids=input_ids,
                                    prompt_mask=prompt_mask, pixels=pixels,
                                    proprio=proprio, use_flash=use_flash)
    norm = l1_head_predict(params["action_head"], out.actions_hidden.float(), platform)
    un = 0.5 * (norm + 1.0) * (action_high - action_low + 1e-8) + action_low
    return torch.where(action_mask, un, norm)


def _first_key(stats: dict, *keys):
    for k in keys:
        if k in stats:
            return stats[k]
    raise KeyError(f"none of {keys} in stats {list(stats)}")


@dataclasses.dataclass
class OpenVLAPolicy:
    """Owns the params (on their device) and the un-normalization stats;
    head "l1", "diffusion" or "discrete" (the action rows' logits, argmax,
    de-tokenized; the params carry llm["lm_head"]).

    Diffusion: `num_diffusion_steps` is the scheduler's training T, and
    every one of its steps runs unless `num_diffusion_steps_inference`
    subsamples them (the reference couples the two). `diffusion_prefix_kv`
    computes the [BOS][patches][proprio] K/V once and runs each step over
    the suffix rows; False runs a full `predict_action_hidden` per step (the
    parity oracle). `split_kv`: the suffix attention as two online-softmax
    blocks instead of a concatenated K/V (the JAX version's OPENVLA_SPLIT_KV).
    The starting noise of each request comes from `generator`, which lives
    on the params' device (seed 0 unless the caller passes one). The DDIM
    scheduler and its table are built once, with the policy, so
    `num_diffusion_steps` is fixed then.
    """

    cfg: OpenVLAConfig
    platform: PlatformSpec
    params: Params
    norm_stats: Optional[dict] = None
    head: str = "l1"
    prompt_bucket: int = 64
    use_flash: Any = "auto"
    tokenizer: Any = None
    fast_gelu: bool = True
    int4_a8: bool = False       # int4 LLM linears: W4A8 (K6) instead of W4A16 (K5)
    vit_fused: bool = False     # the ViTs' folded LN + qkv / fc1 as one K4 launch each
    num_diffusion_steps: int = 50
    num_diffusion_steps_inference: Optional[int] = None
    diffusion_prefix_kv: bool = True
    split_kv: bool = False
    generator: Optional[torch.Generator] = None
    scheduler: Optional[DDIMScheduler] = dataclasses.field(default=None, init=False,
                                                           repr=False)

    def __post_init__(self):
        if self.head not in ("l1", "diffusion", "discrete"):
            raise ValueError(f"head must be 'l1', 'diffusion' or 'discrete', got {self.head!r}")
        if self.head == "discrete" and "lm_head" not in self.params["llm"]:
            raise ValueError("head='discrete' needs llm['lm_head'] in the params "
                             "(bridge.init_params(..., head='discrete'))")
        if self.fast_gelu and not self.cfg.fast_gelu:
            self.cfg = dataclasses.replace(self.cfg, fast_gelu=True)
        if self.tokenizer is None:
            from openvla_oft_tpu_torch.processing.processor import FakeLlamaTokenizer

            self.tokenizer = FakeLlamaTokenizer()
        if self.head == "diffusion":
            self.scheduler = diffusion_scheduler(self.num_diffusion_steps, self.device)
            if self.generator is None:
                self.generator = torch.Generator(device=self.device).manual_seed(0)

    @property
    def device(self) -> torch.device:
        return self.params["llm"]["embed"]["embedding"].device

    def _diffusion_loop(self, input_ids: torch.Tensor, prompt_mask: torch.Tensor,
                        pixels: torch.Tensor, proprio: Optional[torch.Tensor],
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The reverse DDIM loop: normalized actions (B, chunk, action_dim)
        fp32. noise: the starting x_T (B, chunk, action_dim); None draws it
        from `generator`."""
        params, cfg, platform = self.params, self.cfg, self.platform
        sched = self.scheduler
        n_inf = self.num_diffusion_steps_inference or self.num_diffusion_steps
        b = input_ids.shape[0]
        if noise is None:
            noise = torch.randn((b, platform.num_actions_chunk, platform.action_dim),
                                generator=self.generator, device=self.device,
                                dtype=torch.float32)
        if self.diffusion_prefix_kv:
            prefix = build_diffusion_prefix(params, cfg, input_ids, prompt_mask, pixels,
                                            proprio, use_flash=self.use_flash)
            layout = diffusion_suffix_layout(prefix, platform.chunk_len)
        else:
            # The vision block is the same in every step: computed once
            # (reference modeling_prismatic.py:810).
            patches = compute_patch_features(params, cfg, input_ids, prompt_mask, pixels)
        x_t = noise
        for t in sched.timesteps(n_inf).tolist():
            t_emb = sinusoidal_time_encoding(
                torch.full((b,), t, dtype=torch.int64, device=self.device), cfg.llm_dim)[:, None]
            if self.diffusion_prefix_kv:
                hidden = diffusion_suffix_step(params, cfg, platform, prefix, t_emb, x_t,
                                               split_kv=self.split_kv, layout=layout)
            else:
                hidden = predict_action_hidden(
                    params, cfg, platform, input_ids, prompt_mask, pixels, proprio=proprio,
                    use_flash=self.use_flash, noisy_actions=x_t, diffusion_t_emb=t_emb,
                    precomputed_patches=patches).actions_hidden
            eps = diffusion_predict_noise(params["action_head"], hidden.float(), platform)
            x_t = sched.step(eps, t, x_t, n_inf)
        return x_t

    @torch.inference_mode()
    def predict_action(self, images, instruction: str, proprio=None,
                       unnorm_key: Optional[str] = None,
                       noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """The staged path: normalized pixels (num_images, n_backbones, H, W,
        3), as the processor gives them (numpy, or a tensor already on the
        device) -> the action chunk (chunk, action_dim), un-normalized on the
        host where the policy has stats. proprio (numpy or a tensor) goes in
        as given (normalized). The discrete head's argmax token ids stay on
        the device until one copy to the host. noise: the diffusion head's
        starting noise (1, chunk, action_dim); None draws it from
        `generator`."""
        dev = self.device
        ids, mask = prepare_prompt_ids(self.tokenizer, instruction, self.prompt_bucket)
        ids = torch.as_tensor(ids, device=dev)[None]
        mask = torch.as_tensor(mask, device=dev)[None]
        pixels = torch.as_tensor(images, device=dev)[None]
        proprio_t = None if proprio is None else \
            torch.as_tensor(proprio, dtype=torch.float32, device=dev)[None]
        with int4_a8_mode(self.int4_a8), vit_fused_mode(self.vit_fused):
            if self.head == "diffusion":
                actions = self._diffusion_loop(ids, mask, pixels, proprio_t, noise)
            else:
                out = predict_action_hidden(self.params, self.cfg, self.platform, ids, mask,
                                            pixels, proprio=proprio_t,
                                            use_flash=self.use_flash,
                                            compute_logits=self.head == "discrete")
                actions = out.action_logits.argmax(dim=-1) if self.head == "discrete" else \
                    l1_head_predict(self.params["action_head"], out.actions_hidden.float(),
                                    self.platform)
        normalized = actions[0].cpu().numpy()
        if self.head == "discrete":
            normalized = detokenize_discrete_actions(normalized, self.cfg, self.platform)
        if self.norm_stats is None:
            return normalized
        return unnormalize_actions(normalized, self._action_stats(unnorm_key),
                                   self.platform.norm_type)

    def _action_stats(self, unnorm_key: Optional[str]) -> dict:
        if not self.norm_stats:
            raise ValueError("no dataset statistics loaded")
        if unnorm_key is None:
            if len(self.norm_stats) != 1:
                raise ValueError(f"pass unnorm_key from {list(self.norm_stats)}")
            unnorm_key = next(iter(self.norm_stats))
        return self.norm_stats[unnorm_key]["action"]

    @torch.inference_mode()
    def predict_action_from_frames(self, frames_u8: np.ndarray, instruction: str,
                                   proprio: Optional[np.ndarray] = None,
                                   unnorm_key: Optional[str] = None,
                                   center_crop: bool = True) -> np.ndarray:
        """RAW uint8 frames (N, H, W, 3) -> unnormalized action chunk
        (num_actions_chunk, action_dim), through `serve_action_chunk`; the
        L1 head only, as in the JAX version (the diffusion and discrete
        heads serve through `predict_action`)."""
        if self.head != "l1":
            raise ValueError(f"predict_action_from_frames serves the L1 head; use "
                             f"predict_action for head={self.head!r}")
        dev = self.device
        stats = self._action_stats(unnorm_key)
        q99 = self.platform.norm_type == NormalizationType.BOUNDS_Q99
        lo_k, hi_k = ("q01", "q99") if q99 else ("min", "max")
        low, high = stats[lo_k], stats[hi_k]
        amask = stats.get("mask", [True] * len(np.asarray(low)))
        p_stats = None
        if proprio is not None and self.norm_stats is not None:
            p_stats = self.norm_stats[unnorm_key or next(iter(self.norm_stats))].get("proprio")

        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)

        def mask_t(a):
            return torch.tensor(np.asarray(a, bool), device=dev)

        p_kw = {}
        if p_stats is not None:
            p_low = _first_key(p_stats, lo_k, "q01", "min")
            p_high = _first_key(p_stats, hi_k, "q99", "max")
            zero = (np.asarray(p_stats["min"]) == np.asarray(p_stats["max"])
                    if "min" in p_stats and "max" in p_stats
                    else np.asarray(p_low) == np.asarray(p_high))
            p_kw = {"proprio_low": f32(p_low), "proprio_high": f32(p_high),
                    "proprio_mask": mask_t(p_stats["mask"]) if "mask" in p_stats else None,
                    "proprio_zero": mask_t(zero)}
        ids, m = prepare_prompt_ids(self.tokenizer, instruction, self.prompt_bucket)
        actions = serve_action_chunk(
            self.params, self.cfg, self.platform,
            frames_u8=torch.tensor(np.asarray(frames_u8, np.uint8), device=dev)[None],
            input_ids=torch.as_tensor(ids, device=dev)[None],
            prompt_mask=torch.as_tensor(m, device=dev)[None],
            proprio=None if proprio is None else f32(proprio)[None],
            action_low=f32(low), action_high=f32(high), action_mask=mask_t(amask),
            use_flash=self.use_flash, center_crop=center_crop,
            resize_size=self.cfg.vision_configs[0].image_size,
            fast_gelu=self.fast_gelu, int4_a8=self.int4_a8, vit_fused=self.vit_fused,
            **p_kw)
        return actions[0].cpu().numpy()
