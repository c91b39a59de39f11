"""The bench's timed program: the flagship serving step on zero weights.

Port of `__graft_entry__.py::_flagship_cfg` (`:19`), `_cheap_params`
(`:27-121`) and `entry` (`:124-188`). `entry()` returns `(fn, args)`: `fn`
is the whole serving hot path, `policy.py::serve_action_chunk` (uint8
camera frames -> device preprocessing -> prefill with parallel decoding ->
L1 head -> un-normalization on the device), on the flagship
(`dinosiglip-vit-so-224px` + `llama2-7b-pure`) at LIBERO geometry (2
frames of 256², proprio, an 8 x 7 chunk) or, with `geometry="aloha"`, 3
frames, FiLM and a 25 x 14 chunk.

`cheap_params` builds the flagship tree as zeros, directly on the device:
the serving recipe (fusions, folds, quantization) runs on `device="meta"`
tensors, which carry shapes, dtypes and strides but no data (the JAX
version's `jax.eval_shape`), and every leaf, int8 and int4 scales too, is
then allocated as zeros in the layout the recipe gives it. The recipes, by
`quant`, are the JAX bench's. Three of them are the loader's own,
`serving/deploy.py::serving_params`:
  - None (bf16): the LLM's and the ViTs' norms folded, wqkv / gate_up fused
    (`serving_params(params)`);
  - "int8": no folds; the LLM, the projector and both ViTs int8 at
    `min_dim=1024` (`load_in_8bit`);
  - "int8_vit": the LLM folded and bf16; the projector and the ViTs int8
    (`load_vision_in_8bit`);
  - "int4" is the bench's own: no folds; the LLM int4, the projector AND
    the ViTs int8. This is the JAX bench's tree, not the port's
    `load_in_4bit`, which packs the LLM only (`__graft_entry__.py:86-90,
    112-113` against the loader).
The joint-ViT branches are arguments too: `joint_vit` (`OPENVLA_VIT_JOINT`)
builds the ViT pair as one joint tree (`models/vit_joint.py`) at quant=None
only, `joint_vit_int8` (`OPENVLA_VIT_JOINT_INT8`) the int8 joint tree for
"int8", "int8_vit" and "int4" (`__graft_entry__.py:63-75, 96-111`); the
geometry with FiLM (ALOHA) refuses both, as the JAX forward does. The other
switches the JAX entry reads from the environment (`OPENVLA_BENCH_GEOMETRY`,
`_BENCH_BUCKET`, `OPENVLA_USE_FLASH`, `OPENVLA_INT4_A8`, `OPENVLA_VIT_FUSED`,
`OPENVLA_QUANT`) are arguments as well.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

QUANTS = (None, "int8", "int8_vit", "int4")
GEOMETRIES = ("libero", "aloha")
# The synthetic prompt: [BOS] 100 x 22 [29871], left-padded into the bucket.
PROMPT = [1] + [100] * 22 + [29871]
FRAME_HW = 256          # LIBERO's simulator renders 256 x 256
QUANT_MIN_DIM = 1024


def flagship_cfg():
    """The bench's model: DINOv2 + SigLIP, Llama-2-7B, 2 images."""
    from openvla_oft_tpu_torch.config import OpenVLAConfig

    return OpenVLAConfig(vision_backbone_id="dinosiglip-vit-so-224px",
                         llm_backbone_id="llama2-7b-pure", num_images_in_input=2)


def _meta(spec, dtype=torch.bfloat16):
    """The `Init` tree `spec` as `device="meta"` tensors of `dtype`."""
    from openvla_oft_tpu_torch.bridge import Init

    if isinstance(spec, Init):
        return torch.empty(spec.shape, dtype=dtype, device="meta")
    if isinstance(spec, dict):
        return {k: _meta(v, dtype) for k, v in spec.items()}
    return [_meta(v, dtype) for v in spec]


# The loader's flags for the recipes it shares with the JAX bench.
LOADER_FLAGS = {None: {}, "int8": {"load_in_8bit": True},
                "int8_vit": {"load_vision_in_8bit": True}}


def bench_recipe(params: dict, quant: Optional[str], joint_vit: bool = False,
                 joint_vit_int8: bool = False, vision_configs=None) -> dict:
    """The JAX bench's fusions and quantization of a serving tree
    (`__graft_entry__.py:41-116`): `serving_params` but for int4. joint_vit
    (at quant None) and joint_vit_int8 (the int8 quants) put the ViT pair
    into one joint tree; they need the backbones' `vision_configs`.
    Consumes `params`."""
    from openvla_oft_tpu_torch.models.llama import fuse_inference_weights
    from openvla_oft_tpu_torch.models.vit import fuse_vit_inference_weights
    from openvla_oft_tpu_torch.models.vit_joint import joint_vision
    from openvla_oft_tpu_torch.ops.quant import quantize_tree_lowmem
    from openvla_oft_tpu_torch.serving.deploy import serving_params

    if quant not in QUANTS:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
    if quant in LOADER_FLAGS:
        return serving_params(params, **LOADER_FLAGS[quant], joint_vit=joint_vit,
                              joint_vit_int8=joint_vit_int8, vision_configs=vision_configs)
    params["llm"] = quantize_tree_lowmem(
        fuse_inference_weights(params["llm"], fold_norms=False), min_dim=QUANT_MIN_DIM, bits=4)
    vision = {name: fuse_vit_inference_weights(v, fold_norms=False)
              for name, v in params["vision_backbone"].items()}
    params["vision_backbone"] = joint_vision(vision, vision_configs, int8=True) \
        if joint_vit_int8 else quantize_tree_lowmem(vision, min_dim=QUANT_MIN_DIM)
    params["projector"] = quantize_tree_lowmem(params["projector"], min_dim=QUANT_MIN_DIM)
    return params


def _zeros(tree, device):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree, device=device)     # the meta leaf's strides too
    if isinstance(tree, dict):
        return {k: _zeros(v, device) for k, v in tree.items()}
    return [_zeros(v, device) for v in tree]


def cheap_params(cfg, platform, quant: Optional[str] = None,
                 modules: Optional[Sequence[str]] = None, device="cuda",
                 joint_vit: bool = False, joint_vit_int8: bool = False) -> dict:
    """The flagship-shaped serving tree of `quant`'s recipe, as zeros on
    `device` (no random draw, no host transfer). modules: only these
    top-level groups are allocated (e.g. ("vision_backbone",) for a
    component bench that must not hold the LLM's zeros beside it).
    joint_vit / joint_vit_int8: `bench_recipe`'s."""
    from openvla_oft_tpu_torch.bridge import param_spec

    shapes = bench_recipe(_meta(param_spec(cfg, platform, "l1")), quant, joint_vit=joint_vit,
                          joint_vit_int8=joint_vit_int8, vision_configs=cfg.vision_configs)
    if modules is not None:
        shapes = {k: shapes[k] for k in modules}
    return _zeros(shapes, torch.device(device))


def bench_inputs(cfg, platform, bucket: int = 48, device="cuda") -> dict:
    """Every array of the timed call but the params (`__graft_entry__.py:
    150-169`): the prompt (1, bucket) int32 and its mask, zero uint8 frames
    (1, N, 256, 256, 3), zero proprio, action bounds +-0.8 with the last
    dim not un-normalized, proprio bounds +-1."""
    if bucket < len(PROMPT):
        raise ValueError(f"bucket={bucket}: the synthetic prompt occupies the last "
                         f"{len(PROMPT)} slots, so the bucket must be >= {len(PROMPT)}")
    dev = torch.device(device)
    ids = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    ids[0, -len(PROMPT):] = torch.tensor(PROMPT, dtype=torch.int32)
    mask = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    mask[0, -len(PROMPT):] = 1
    a, p = platform.action_dim, platform.proprio_dim

    def full(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    return {"input_ids": ids, "prompt_mask": mask,
            "frames": torch.zeros((1, cfg.num_images_in_input, FRAME_HW, FRAME_HW, 3),
                                  dtype=torch.uint8, device=dev),
            "proprio": torch.zeros((1, p), dtype=torch.float32, device=dev),
            "action_low": full(a, -0.8), "action_high": full(a, 0.8),
            "action_mask": torch.tensor([True] * (a - 1) + [False], device=dev),
            "proprio_low": full(p, -1.0), "proprio_high": full(p, 1.0)}


def geometry_of(geometry: str, cfg=None) -> tuple:
    """(cfg, platform) of the bench's geometry: LIBERO, or ALOHA with 3
    images and FiLM (`__graft_entry__.py:139-143`). cfg: the model (the
    flagship by default; the tests pass a small one)."""
    from openvla_oft_tpu_torch.constants import ALOHA, LIBERO

    if geometry not in GEOMETRIES:
        raise ValueError(f"geometry must be one of {GEOMETRIES}, got {geometry!r}")
    cfg = flagship_cfg() if cfg is None else cfg
    if geometry == "aloha":
        return dataclasses.replace(cfg, num_images_in_input=3, use_film=True), ALOHA
    return cfg, LIBERO


def entry(geometry: str = "libero", quant: Optional[str] = None, bucket: int = 48,
          use_flash="auto", int4_a8: bool = False, vit_fused: bool = False,
          device="cuda", cfg=None, joint_vit: bool = False,
          joint_vit_int8: bool = False) -> tuple:
    """(fn, args): fn(*args) is one serving call on `quant`'s zero tree.
    use_flash: "auto" (K1 where it takes the call), True or False. int4_a8:
    the int4 linears run W4A8 (K6) instead of W4A16 (K5). vit_fused: the
    ViTs' folded LN + matmuls as K4 (a bf16 tree only: int8 ViTs keep their
    norms; the joint pair never takes K4). joint_vit / joint_vit_int8: the
    ViT pair as one joint tree (`bench_recipe`; not with FiLM)."""
    from openvla_oft_tpu_torch.policy import serve_action_chunk

    cfg, platform = geometry_of(geometry, cfg)
    if (joint_vit or joint_vit_int8) and cfg.use_film:
        raise ValueError("the joint ViT pair does not support FiLM (the ALOHA geometry)")
    params = cheap_params(cfg, platform, quant=quant, device=device, joint_vit=joint_vit,
                          joint_vit_int8=joint_vit_int8)
    x = bench_inputs(cfg, platform, bucket, device)
    resize = cfg.vision_configs[0].image_size

    @torch.inference_mode()
    def fn(params, input_ids, prompt_mask, frames, proprio):
        return serve_action_chunk(
            params, cfg, platform, frames_u8=frames, input_ids=input_ids,
            prompt_mask=prompt_mask, proprio=proprio, action_low=x["action_low"],
            action_high=x["action_high"], action_mask=x["action_mask"],
            proprio_low=x["proprio_low"], proprio_high=x["proprio_high"],
            use_flash=use_flash, resize_size=resize, int4_a8=int4_a8, vit_fused=vit_fused)

    return fn, (params, x["input_ids"], x["prompt_mask"], x["frames"], x["proprio"])
