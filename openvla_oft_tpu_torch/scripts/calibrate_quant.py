"""Quantization calibration CLI: int8/int4 accuracy against bf16.

Port of `vla_scripts/calibrate_quant.py`. Builds the model (`random:7b`, the
flagship DINOv2 + SigLIP + Llama-2-7B with seeded random bf16 weights;
`random:tiny`, the TINY configs with min_dim 1; or a local HF-format
checkpoint dir, its LLM, ViTs and projector loaded in bf16 and the rest
drawn from the seed, as the JAX script does), draws `random_observations`,
and prints the JSON report of `ops/quant_calibrate.py::calibrate` (weight
errors, activation drift, action L1 delta against the two floors).

    python -m openvla_oft_tpu_torch.scripts.calibrate_quant --vla_path random:7b --bits 8
    python -m openvla_oft_tpu_torch.scripts.calibrate_quant --vla_path random:tiny --device cpu
    python -m openvla_oft_tpu_torch.scripts.calibrate_quant --vla_path CHECKPOINT_DIR

It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch


@dataclasses.dataclass
class CalibrateConfig:
    vla_path: str = "random:7b"
    bits: int = 8
    n_observations: int = 4
    min_dim: int = 1024
    robot_platform: str = "libero"
    out: str = ""                       # optional JSON output path
    seed: int = 0
    low_memory: bool = False            # quantize in place after the float pass
    # comma-separated modules to quantize (int4 deployments quantize the LLM only)
    modules: str = "llm,vision_backbone,projector"
    weight_errors: bool = True          # the per-layer weight-error pass
    device: str = "cuda"


def main(argv=None) -> dict:
    import openvla_oft_tpu_torch.config as C
    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.ops.quant_calibrate import calibrate, random_observations
    from openvla_oft_tpu_torch.utils.cli import parse_args

    cfg = parse_args(CalibrateConfig, argv)
    platform = get_platform(cfg.robot_platform)
    device = torch.device(cfg.device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    loaded = None
    if not cfg.vla_path.startswith("random:"):
        from openvla_oft_tpu_torch.serving.openvla_utils import _local_dir
        from openvla_oft_tpu_torch.utils.hf_import import load_openvla_checkpoint

        model_cfg, loaded, _ = load_openvla_checkpoint(_local_dir(cfg.vla_path),
                                                       dtype=torch.bfloat16, device=device,
                                                       head="l1")
        model_cfg = dataclasses.replace(model_cfg, num_images_in_input=2)
        min_dim = cfg.min_dim
    elif cfg.vla_path == "random:tiny":
        C._VISION_REGISTRY.setdefault("tiny-dual", (C.TINY_DINOV2, C.TINY_SIGLIP))
        C._LLM_REGISTRY.setdefault("tiny-llama", C.TINY_LLAMA)
        model_cfg = C.OpenVLAConfig(vision_backbone_id="tiny-dual",
                                    llm_backbone_id="tiny-llama", num_images_in_input=2)
        min_dim = 1
    elif cfg.vla_path == "random:7b":
        model_cfg = C.OpenVLAConfig(num_images_in_input=2)
        min_dim = cfg.min_dim
    else:
        raise ValueError(f"--vla_path takes random:7b or random:tiny, got {cfg.vla_path!r}")
    params = init_params(model_cfg, platform, gen, device=device, dtype=torch.bfloat16)
    params.update(loaded or {})
    obs = random_observations(model_cfg, platform, n=cfg.n_observations, seed=cfg.seed,
                              device=device)
    report = calibrate(model_cfg, platform, params, obs, bits=cfg.bits, min_dim=min_dim,
                       low_memory=cfg.low_memory, weight_errors=cfg.weight_errors,
                       quant_modules=tuple(m.strip() for m in cfg.modules.split(",")
                                           if m.strip()))
    text = json.dumps(report, indent=2)
    print(text)
    if cfg.out:
        Path(cfg.out).write_text(text)
    return report


if __name__ == "__main__":
    main()
