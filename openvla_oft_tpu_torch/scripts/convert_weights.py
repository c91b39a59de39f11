"""Convert checkpoints between the reference's HF format and the port's training format.

The port's copy of `vla_scripts/convert_weights.py` (reference
`vla-scripts/extern/convert_openvla_weights_to_hf.py:83-160` and the
reverse):

  import:  an HF checkpoint dir -> `{output}/{step:06d}.pt`
           (`training/checkpoint.py::save_checkpoint`, {"params": tree}), with
           `meta.json` (the backbone ids and their architectures) and
           `dataset_statistics.json` beside it;
  export:  that step file -> an HF checkpoint dir (safetensors + config.json).

    python -m openvla_oft_tpu_torch.scripts.convert_weights --direction import \
        --source HF_DIR --output OUT_DIR [--step 0]
    python -m openvla_oft_tpu_torch.scripts.convert_weights --direction export \
        --source OUT_DIR --output HF_DIR [--step 0]

Both run on the CPU and keep each tensor's stored dtype.
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass
class ConvertConfig:
    direction: str = "import"     # "import" | "export"
    source: str = ""
    output: str = ""
    step: int = 0                 # the step file's number


def convert(cfg: ConvertConfig) -> str:
    from openvla_oft_tpu_torch.config import OpenVLAConfig
    from openvla_oft_tpu_torch.data.transforms import save_dataset_statistics
    from openvla_oft_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
    from openvla_oft_tpu_torch.utils.hf_import import (export_openvla_checkpoint, hf_config,
                                                       load_openvla_checkpoint)

    if cfg.direction == "import":
        model_cfg, params, norm_stats = load_openvla_checkpoint(cfg.source, dtype=None)
        path = save_checkpoint(cfg.output, cfg.step, {"params": params})
        # The step file holds tensors only; the architecture goes beside it,
        # with the payloads that let another process load an unregistered id.
        with open(os.path.join(cfg.output, "meta.json"), "w") as f:
            json.dump({k: v for k, v in hf_config(model_cfg).items() if k != "norm_stats"},
                      f, indent=2)
        if norm_stats:
            save_dataset_statistics(norm_stats, cfg.output)
        print(f"[convert] imported HF checkpoint -> {path}")
        return path
    if cfg.direction == "export":
        restored = restore_checkpoint(cfg.source, cfg.step, map_location="cpu")
        meta_path = os.path.join(cfg.source, "meta.json")
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        model_cfg = OpenVLAConfig.from_hf_config(meta)
        norm_stats = None
        stats_path = os.path.join(cfg.source, "dataset_statistics.json")
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                norm_stats = json.load(f)
        out = export_openvla_checkpoint(model_cfg, restored["params"], cfg.output,
                                        norm_stats=norm_stats)
        print(f"[convert] exported -> {out}")
        return out
    raise ValueError(f"unknown direction {cfg.direction!r}")


def main(argv=None) -> str:
    from openvla_oft_tpu_torch.utils.cli import parse_args

    return convert(parse_args(ConvertConfig, argv))


if __name__ == "__main__":
    main()
