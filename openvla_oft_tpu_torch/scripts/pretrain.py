"""VLM pretraining: the align and finetune stages on LLaVA-format data, in PyTorch.

The counterpart of `vla_scripts/pretrain.py` (reference `scripts/pretrain.py`:
projector alignment, then instruct tuning), with its flags plus `--device`
(cuda by default):

    python -m openvla_oft_tpu_torch.scripts.pretrain --stage align \\
      --pretrained_checkpoint random:7b --llava_json chat.json --image_root images/ \\
      --batch_size 8 --max_steps 3 --run_root_dir /tmp/runs

Stage "align" trains the projector on captions, "finetune" the projector and
the LLM on multi-turn instruct data; the objective is the next-token CE over
the multimodal sequence. The data is `--llava_json` with `--image_root`, or
the named variant `--dataset_id` under `--dataset_root_dir`
(`data/vlm_datasets.py`), each example truncated to `--seq_bucket` tokens and
batched by the fixed-length collator. Images decode as PIL decodes them
(`processing/image_io.py`: JPEG, progressive too, and PNG); a GIF, BMP,
WebP or TIFF file raises, naming itself. The trainables are saved every `save_interval` steps
and at the last one. `--mesh_*` shard the run over one process per GPU
(`torchrun --nproc-per-node N -m openvla_oft_tpu_torch.scripts.pretrain
--mesh_fsdp N ...`), as `scripts/train.py` does.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Callable, Optional

import torch

from openvla_oft_tpu_torch.scripts.train import (build_full_model, device_of, model_config,
                                                 run_loop, shard_stage, split_stage)
from openvla_oft_tpu_torch.training.finetune import data_rank


@dataclasses.dataclass
class PretrainConfig:
    # fmt: off
    model_id: str = "prism-dinosiglip-224px+7b"
    pretrained_checkpoint: Optional[str] = None   # None/random:* = fresh
    stage: str = "align"                          # "align" | "finetune"
    llava_json: str = ""                          # LLaVA-format json
    image_root: str = ""
    # a named variant (reference conf/datasets.py DatasetRegistry), used when
    # llava_json is empty: its json and images under dataset_root_dir
    dataset_id: str = "llava-v15"
    dataset_root_dir: str = ""
    run_root_dir: Path = Path("runs")

    batch_size: int = 16
    learning_rate: float = 1e-3                   # align default; 2e-5 finetune
    max_steps: int = 10_000
    save_interval: int = 2500
    seq_bucket: int = 128
    seed: int = 7

    mesh_dp: int = 1
    mesh_fsdp: int = 1
    mesh_tp: int = 1

    device: str = "cuda"                          # "cuda", "cuda:N" or "cpu"
    # fmt: on


STAGE_TRAINABLE = {"align": ("projector",), "finetune": ("projector", "llm")}


def pretrain(cfg: PretrainConfig, on_step: Optional[Callable] = None,
             on_start: Optional[Callable] = None) -> dict:
    """Run the stage; returns {"final_step", "run_dir", "ckpt", "state"};
    on_start and on_step as `scripts/train.py::train` takes them."""
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.data.collator import (PaddedCollatorForActionPrediction,
                                                     batch_iterator, rank_rows)
    from openvla_oft_tpu_torch.data.vlm_datasets import VLMPretrainDataset, resolve_vlm_dataset
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor
    from openvla_oft_tpu_torch.training.train_step import (TrainConfig as StepConfig,
                                                           create_train_state)
    from openvla_oft_tpu_torch.utils.overwatch import initialize_overwatch

    overwatch = initialize_overwatch("pretrain")
    if cfg.stage not in STAGE_TRAINABLE:
        raise ValueError(f"unknown stage {cfg.stage!r}; use one of {sorted(STAGE_TRAINABLE)}")
    device = device_of(cfg.device)

    ckpt = cfg.pretrained_checkpoint or "random:tiny"
    model_cfg = model_config(ckpt)
    full, _ = build_full_model(ckpt, model_cfg, LIBERO, device, cfg.seed, use_proprio=False)
    base, trainables = split_stage(full, STAGE_TRAINABLE[cfg.stage])
    del full
    mesh, base, trainables = shard_stage(base, trainables, cfg, device)
    proc, n_data = data_rank(mesh)
    if cfg.batch_size % n_data:
        raise ValueError(f"the global batch {cfg.batch_size} must divide over the "
                         f"{n_data} data ranks (dp x fsdp)")
    overwatch.info(f"stage={cfg.stage} trainable={sorted(trainables)}")

    scfg = StepConfig(objective="discrete", learning_rate=cfg.learning_rate,
                      use_proprio=False, num_steps_before_decay=10 ** 9)
    run_id = f"{cfg.model_id}+stage-{cfg.stage}+x{cfg.seed}"
    run_dir = os.path.join(str(cfg.run_root_dir), run_id)
    os.makedirs(run_dir, exist_ok=True)

    llava_json, image_root = cfg.llava_json, cfg.image_root
    if not llava_json:
        llava_json, image_root = resolve_vlm_dataset(cfg.dataset_id, cfg.stage,
                                                     cfg.dataset_root_dir)
    # truncated to the bucket, so long conversations fit the fixed-shape collator
    dataset = VLMPretrainDataset(llava_json, image_root, PrismaticProcessor(model_cfg),
                                 stage=cfg.stage, llm_backbone_id=model_cfg.llm_backbone_id,
                                 max_length=cfg.seq_bucket)
    collator = PaddedCollatorForActionPrediction(pad_token_id=model_cfg.pad_token_id,
                                                 max_length=cfg.seq_bucket)

    def examples():
        while True:
            yield from dataset

    state = create_train_state(base, trainables, scfg,
                               torch.Generator(device=device).manual_seed(cfg.seed))
    if on_start is not None:
        on_start(state)
    # every data rank builds the global batches alike and trains on its rows
    batches = rank_rows(batch_iterator(examples(), cfg.batch_size, collator), proc, n_data)
    last = run_loop(state, batches, model_cfg, LIBERO, scfg, run_dir, run_id, cfg.max_steps,
                    cfg.save_interval, overwatch, device, on_step, with_optimizer=False,
                    mesh=mesh)
    return {"final_step": state.step, "run_dir": run_dir, "ckpt": last, "state": state}


def main(argv=None, on_step: Optional[Callable] = None,
         on_start: Optional[Callable] = None) -> dict:
    from openvla_oft_tpu_torch.utils.cli import parse_args

    return pretrain(parse_args(PretrainConfig, argv), on_step=on_step, on_start=on_start)


if __name__ == "__main__":
    main()
