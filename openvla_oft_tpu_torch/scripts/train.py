"""Full-parameter VLA training with freeze stages, in PyTorch.

The counterpart of `vla_scripts/train.py` (reference `vla-scripts/train.py`),
with its flags plus `--device` (cuda by default):

    python -m openvla_oft_tpu_torch.scripts.train --stage vla-full-train \\
      --pretrained_checkpoint random:7b --data_root_dir dummy \\
      --robot_platform libero --batch_size 8 --max_steps 3 --run_root_dir /tmp/runs

The next-token CE (the discrete objective) over the multimodal sequence, with
the stage choosing the trainable subtrees (`STAGE_TRAINABLE`, reference
`PrismaticVLM.freeze_backbones`, vlms/prismatic.py:129-242); the rest stay
frozen in the base. The model is `random:tiny`, `random:7b` (drawn on the
device from a generator seeded `--seed`: bf16, the projector and the proprio
projector fp32, as the JAX init draws them) or a checkpoint dir (bf16). bf16
trainables take optax's AdamW in bf16 with bf16 moments
(`training/train_step.py::Bf16AdamW`), fp32 ones torch's AdamW. The data is
`dummy` or RLDS episode shards under `--data_root_dir` (no TensorFlow), whose
statistics go into the run dir. Metrics go through `VLAMetrics`; the
trainables and the optimizer's state are saved every `save_interval` steps
and at the last one (`{run_dir}/ckpt/{step:06d}.pt`, written in the
background). `--mesh_dp/--mesh_fsdp/--mesh_tp` shard the run over one process
per GPU (`torchrun --nproc-per-node N -m openvla_oft_tpu_torch.scripts.train
--mesh_fsdp N ...`, `parallel/`): the base and the trainables under the
sharding rules, each data rank on its rows of the global batch, the
checkpoints gathered and written by rank 0.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Callable, Optional

import torch

from openvla_oft_tpu_torch.training.finetune import (_device as device_of, data_rank,
                                                    local_batches, run_mesh)


@dataclasses.dataclass
class TrainConfig:
    # fmt: off
    vla_id: str = "prism-dinosiglip-224px+mx-oxe-magic-soup-plus"
    stage: str = "vla-full-train"
    pretrained_checkpoint: Optional[str] = None   # HF-format dir or random:*
    data_root_dir: Path = Path("datasets/open-x-embodiment")
    dataset_name: str = "bridge"
    run_root_dir: Path = Path("runs")
    run_id: Optional[str] = None

    batch_size: int = 32
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    max_steps: int = 200_000
    save_interval: int = 2500
    image_aug: bool = False
    shuffle_buffer_size: int = 256_000
    seed: int = 7

    mesh_dp: int = 1
    mesh_fsdp: int = 1
    mesh_tp: int = 1
    robot_platform: Optional[str] = None

    device: str = "cuda"                          # "cuda", "cuda:N" or "cpu"
    # fmt: on


# Reference freeze_backbones (prismatic/models/vlms/prismatic.py:129-235):
#   vla-train            : projector + full LLM (vision frozen)
#   vla-full-train       : everything
#   vla-sandwich-train   : vision + projector + LAST LLM layer only
#   vla-last-layer-train : LAST LLM layer only (projector + vision frozen)
# "LAST LLM layer" = (embed_tokens, layers[-1], lm_head) (llm/llama2.py:101-102):
# the `llm_last_layer` trainables (training/train_step.py::last_layer_trainables).
STAGE_TRAINABLE = {
    "vla-full-train": ("llm", "vision_backbone", "projector"),
    "vla-train": ("llm", "projector"),
    "vla-sandwich-train": ("vision_backbone", "projector", "llm_last_layer"),
    "vla-last-layer-train": ("llm_last_layer",),
}


def shard_stage(base: dict, trainables: dict, cfg, device) -> tuple:
    """(mesh, base, trainables): the mesh of `--mesh_*` (None for 1 x 1 x 1,
    `training/finetune.py::run_mesh`) and the trees sharded on it."""
    mesh = run_mesh(cfg, device)
    if mesh is None:
        return None, base, trainables
    from openvla_oft_tpu_torch.parallel.sharding import shard_params

    return mesh, shard_params(base, mesh), shard_params(trainables, mesh)


def model_config(ckpt: str):
    """The OpenVLAConfig of a checkpoint dir, or of `random:tiny` (the TINY
    configs) or another `random:` (the flagship), as the JAX script reads
    them."""
    import openvla_oft_tpu_torch.config as C
    from openvla_oft_tpu_torch.serving.openvla_utils import random_model_config

    if not ckpt.startswith("random:"):
        if not os.path.isdir(ckpt):
            raise ValueError(f"{ckpt!r} is neither random:<tiny|7b> nor a checkpoint dir: "
                             "the port downloads nothing")
        return C.OpenVLAConfig.from_json_file(os.path.join(ckpt, "config.json"))[0]
    return random_model_config(ckpt, 1, False)


def build_full_model(ckpt: str, model_cfg, platform, device, seed: int,
                     use_proprio: bool = True):
    """(params, norm_stats): a `random:` tree drawn on `device` from a
    generator seeded `seed` (the JAX init's dtypes: bf16, the projector and
    proprio projector fp32; the lm_head, no action head), or a checkpoint
    dir's tree in bf16 with its statistics."""
    from openvla_oft_tpu_torch.bridge import init_params

    if ckpt.startswith("random:"):
        keys = ("llm", "vision_backbone", "projector") + (("proprio_projector",)
                                                          if use_proprio else ())
        params = init_params(model_cfg, platform, torch.Generator(device=device).manual_seed(seed),
                             device=device, dtype=torch.bfloat16, head_dtype=torch.float32,
                             head="discrete", keys=keys)
        return params, None
    from openvla_oft_tpu_torch.utils.hf_import import load_openvla_checkpoint

    _, params, norm_stats = load_openvla_checkpoint(ckpt, dtype=torch.bfloat16, device=device)
    return params, norm_stats


def split_stage(params: dict, trainable_keys) -> tuple:
    """(frozen base, trainables) of a stage (the JAX script's split): the
    trainable modules move out of the base; `llm_last_layer` gets copies of
    the LLM's last layer slices, embed and lm_head (the base keeps its LLM).
    requires_grad is set in place: False on the base, True on the
    trainables."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.ops import vit_fused as VF
    from openvla_oft_tpu_torch.training.train_step import last_layer_trainables

    if "vision_backbone" in trainable_keys and VF.vit_fused_enabled():
        raise ValueError("vit_fused is on, and this stage trains the vision backbone: K4 "
                         "(ln_matmul) has no backward")
    base = {k: v for k, v in params.items() if k not in trainable_keys}
    trainables = {k: params[k] for k in trainable_keys if k in params}
    if "llm_last_layer" in trainable_keys:
        trainables["llm_last_layer"] = last_layer_trainables(params["llm"])
    for t in tree_leaves(base):
        t.requires_grad_(False)
    for t in tree_leaves(trainables):
        t.requires_grad_(True)
    return base, trainables


def run_loop(state, batches, model_cfg, platform, scfg, run_dir: str, run_id: str,
             max_steps: int, save_interval: int, overwatch, device,
             on_step: Optional[Callable] = None, with_optimizer: bool = True,
             mesh=None) -> Optional[str]:
    """The training loop of train.py and pretrain.py: `max_steps` steps of
    `train_step` on the prefetched batches, metrics through `VLAMetrics`
    (logged every 10 steps), the trainables (and the optimizer's state,
    with `with_optimizer`) saved every `save_interval` steps and at the last.
    on_step(i, metrics, state) runs after each
    step with its metrics as floats and `step_time` (host clock, ending in
    a device synchronize). On a `mesh` the batches are this data rank's
    rows, the metrics are logged by rank 0, and a save gathers the trees
    (every rank) for rank 0 to write. Returns the last checkpoint's path."""
    import time

    from openvla_oft_tpu_torch.data.prefetch import DevicePrefetcher
    from openvla_oft_tpu_torch.parallel.sharding import gather_params
    from openvla_oft_tpu_torch.training.checkpoint import (checkpoint_path, save_checkpoint,
                                                           wait_for_checkpoints)
    from openvla_oft_tpu_torch.training.metrics import JSONLinesTracker, VLAMetrics
    from openvla_oft_tpu_torch.training.train_step import train_step

    primary = mesh is None or torch.distributed.get_rank() == 0
    metrics = VLAMetrics([JSONLinesTracker(run_dir, run_id)] if primary else [])
    prefetched = DevicePrefetcher(batches, device)
    ckpt = None
    try:
        for i, batch in enumerate(prefetched):
            if i >= max_steps:
                break
            t0 = time.perf_counter()
            state, m = train_step(state, batch, model_cfg, platform, scfg)
            m = {k: float(v) for k, v in m.items()}
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_time = time.perf_counter() - t0
            metrics.commit(**m)
            if i % 10 == 0:
                s = metrics.push(i)
                overwatch.info(f"[step {i}] loss={s.get('loss', -1):.4f} "
                               f"acc={s.get('token_accuracy', -1):.3f}")
            if on_step is not None:
                on_step(i, dict(m, step_time=step_time), state)
            if (i + 1) % save_interval == 0 or i + 1 == max_steps:
                saved = {"trainables": state.trainables}
                if with_optimizer:
                    saved["optimizer"] = state.optimizer.state_dict()
                ckpt_dir = os.path.join(run_dir, "ckpt")
                if mesh is not None:
                    saved = gather_params(saved, to_host=True)
                ckpt = save_checkpoint(ckpt_dir, i + 1, saved, block=False) if primary \
                    else checkpoint_path(ckpt_dir, i + 1)
    finally:
        prefetched.close()
        wait_for_checkpoints()
    metrics.finalize()
    return ckpt


def train(cfg: TrainConfig, on_step: Optional[Callable] = None,
          on_start: Optional[Callable] = None) -> dict:
    """Run the stage; returns {"final_step", "run_dir", "ckpt" (the last
    checkpoint written, or None), "state", "norm_stats"}. on_start(state)
    runs once the state is built, before the first step; on_step as
    `run_loop` says."""
    from openvla_oft_tpu_torch.constants import detect_robot_platform, get_platform
    from openvla_oft_tpu_torch.data.collator import PaddedCollatorForActionPrediction
    from openvla_oft_tpu_torch.data.datasets import DummyDataset, RLDSBatchTransform
    from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor
    from openvla_oft_tpu_torch.training.train_step import (TrainConfig as StepConfig,
                                                           create_train_state)
    from openvla_oft_tpu_torch.utils.overwatch import initialize_overwatch

    overwatch = initialize_overwatch("train")
    if cfg.stage not in STAGE_TRAINABLE:
        raise ValueError(f"unknown stage {cfg.stage!r}; use one of {sorted(STAGE_TRAINABLE)}")
    device = device_of(cfg.device)
    platform = get_platform(cfg.robot_platform) if cfg.robot_platform else \
        detect_robot_platform(cfg.dataset_name)

    ckpt = cfg.pretrained_checkpoint or "random:tiny"
    model_cfg = model_config(ckpt)
    full, norm_stats = build_full_model(ckpt, model_cfg, platform, device, cfg.seed)
    base, trainables = split_stage(full, STAGE_TRAINABLE[cfg.stage])
    del full
    mesh, base, trainables = shard_stage(base, trainables, cfg, device)
    proc, n_data = data_rank(mesh)
    if cfg.batch_size % n_data:
        raise ValueError(f"the global batch {cfg.batch_size} must divide over the "
                         f"{n_data} data ranks (dp x fsdp)")
    overwatch.info(f"stage={cfg.stage} trainable={sorted(trainables)} frozen={sorted(base)}")

    scfg = StepConfig(objective="discrete", learning_rate=cfg.learning_rate,
                      weight_decay=cfg.weight_decay, use_proprio=False,
                      num_steps_before_decay=10 ** 9)
    run_id = cfg.run_id or f"{cfg.vla_id}+stage-{cfg.stage}+x{cfg.seed}"
    run_dir = os.path.join(str(cfg.run_root_dir), run_id)
    os.makedirs(run_dir, exist_ok=True)
    state = create_train_state(base, trainables, scfg,
                               torch.Generator(device=device).manual_seed(cfg.seed))
    if on_start is not None:
        on_start(state)

    transform = RLDSBatchTransform(PrismaticProcessor(model_cfg), ActionTokenizer(), platform)
    if str(cfg.data_root_dir) == "dummy":
        dataset = DummyDataset(transform, image_size=model_cfg.vision_configs[0].image_size,
                               num_samples=cfg.max_steps * cfg.batch_size)
    else:
        from openvla_oft_tpu_torch.data.rlds.pipeline import make_rlds_iterator
        from openvla_oft_tpu_torch.data.transforms import save_dataset_statistics

        dataset, data_stats = make_rlds_iterator(
            str(cfg.data_root_dir), cfg.dataset_name, transform, platform,
            shuffle_buffer_size=cfg.shuffle_buffer_size, image_aug=cfg.image_aug,
            process_index=proc, process_count=n_data)
        # reference train.py:202-204: the statistics ride with the run, so
        # that an eval can un-normalize actions
        if mesh is None or torch.distributed.get_rank() == 0:
            save_dataset_statistics(data_stats, run_dir)
        norm_stats = norm_stats or data_stats
    collator = PaddedCollatorForActionPrediction(pad_token_id=model_cfg.pad_token_id)
    last = run_loop(state, local_batches(cfg, dataset, collator, proc, n_data), model_cfg,
                    platform, scfg, run_dir, run_id, cfg.max_steps, cfg.save_interval,
                    overwatch, device, on_step, mesh=mesh)
    return {"final_step": state.step, "run_dir": run_dir, "ckpt": last, "state": state,
            "norm_stats": norm_stats}


def main(argv=None, on_step: Optional[Callable] = None,
         on_start: Optional[Callable] = None) -> dict:
    from openvla_oft_tpu_torch.utils.cli import parse_args

    return train(parse_args(TrainConfig, argv), on_step=on_step, on_start=on_start)


if __name__ == "__main__":
    main()
