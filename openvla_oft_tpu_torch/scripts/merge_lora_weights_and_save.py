"""Merge a fine-tuning run's LoRA factors into its base and export the model.

The port's copy of `vla_scripts/merge_lora_weights_and_save.py` (reference
`vla-scripts/merge_lora_weights_and_save.py:33-73`): loads the base
checkpoint dir (HF format, each tensor in its stored dtype) onto the device,
restores the run's resume file `ckpt/{step:06d}.pt` (the latest unless
`--step` is given; `training/checkpoint.py`), merges W + alpha/r * A^T B
(`training/lora.py::merge_lora_into_params`, accepting the pre-rank-major A
layout) into a host tree one leaf at a time, and writes
`{finetune_run_dir}/merged--{step}_chkpt` (or `--output_dir`): the
safetensors, config.json with the base's statistics, the base's tensors the
exporter does not produce (`extras_from`), and its tokenizer files.

    python -m openvla_oft_tpu_torch.scripts.merge_lora_weights_and_save \
        --base_checkpoint BASE_DIR --finetune_run_dir RUN_DIR [--step N] \
        [--lora_rank 32] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class MergeConfig:
    base_checkpoint: str = ""        # HF-format base model dir
    finetune_run_dir: str = ""       # run dir holding ckpt/<step>.pt
    step: Optional[int] = None       # default: latest
    output_dir: str = ""             # where to write the merged checkpoint
    lora_rank: int = 32
    device: str = "cuda"             # where the merge runs: "cuda", "cuda:N" or "cpu"


def merge(cfg: MergeConfig) -> str:
    import torch

    from openvla_oft_tpu_torch.training.checkpoint import latest_step, restore_checkpoint
    from openvla_oft_tpu_torch.training.finetune import _copy_tokenizer, _device
    from openvla_oft_tpu_torch.training.lora import merge_lora_into_params
    from openvla_oft_tpu_torch.utils.hf_import import (export_openvla_checkpoint,
                                                       load_openvla_checkpoint)

    device = _device(cfg.device)
    ckpt_dir = os.path.join(cfg.finetune_run_dir, "ckpt")
    step = cfg.step if cfg.step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    lora = restore_checkpoint(ckpt_dir, step, map_location=device)["trainables"]["lora"]
    model_cfg, base, norm_stats = load_openvla_checkpoint(cfg.base_checkpoint, dtype=None,
                                                          device=device)
    with torch.no_grad():
        merged = merge_lora_into_params(base, lora, rank=cfg.lora_rank,
                                        alpha=float(min(cfg.lora_rank, 16)), out_device="cpu")
    del base
    out = cfg.output_dir or os.path.join(cfg.finetune_run_dir, f"merged--{step}_chkpt")
    # extras_from keeps the base's tensors past the tap (the featurizers'
    # final norm, SigLIP's attn_pool), so the merged dir is key-complete.
    export_openvla_checkpoint(model_cfg, merged, out, norm_stats=norm_stats,
                              extras_from=cfg.base_checkpoint)
    _copy_tokenizer(cfg.base_checkpoint, out)
    print(f"[merge] wrote merged checkpoint to {out}")
    return out


if __name__ == "__main__":
    from openvla_oft_tpu_torch.utils.cli import parse_args

    merge(parse_args(MergeConfig))
