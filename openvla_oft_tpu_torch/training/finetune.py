"""Fine-tune OpenVLA-OFT with LoRA and the L1 objective, in PyTorch.

The counterpart of `vla_scripts/finetune.py::finetune`, with the same flags
(its `FinetuneConfig`) plus `--device`:

    python -m openvla_oft_tpu_torch.training.finetune --device cuda \\
      --vla_path random:7b --data_root_dir dummy --robot_platform libero \\
      --use_l1_regression True --use_proprio True --num_images_in_input 2 \\
      --lora_rank 32 --batch_size 8 --max_steps 3 \\
      --merge_lora_during_training False --run_root_dir /tmp/runs

Ported: random weights (`random:tiny` or `random:7b`, drawn on the device
from a seeded generator), the `dummy` dataset, `--recipe`, the L1 objective
on the LIBERO platform, remat "all"/"none", gradient accumulation, metrics
through `VLAMetrics` (JSONL), and a checkpoint at every `save_freq` gradient
steps and at the last. Flags for what is not ported raise at startup,
naming their ROADMAP item. `--device cuda` never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

_Q1 = "ROADMAP queue 1, item"


# The flags of `vla_scripts/finetune.py` (FinetuneConfig) and its run id,
# copied field for field.
@dataclasses.dataclass
class FinetuneConfig:
    # fmt: off
    vla_path: str = "openvla/openvla-7b"          # checkpoint dir (HF format) or "random:<tiny|7b>" for smoke runs

    # Dataset
    data_root_dir: Path = Path("datasets/rlds")   # RLDS root (or "dummy")
    dataset_name: str = "aloha_scoop_x_into_bowl"
    run_root_dir: Path = Path("runs")
    shuffle_buffer_size: int = 100_000

    # Algorithm / architecture
    use_l1_regression: bool = True
    use_diffusion: bool = False
    num_diffusion_steps: int = 50
    use_film: bool = False
    num_images_in_input: int = 1
    use_proprio: bool = False

    # Training
    batch_size: int = 8                           # GLOBAL batch (sharded over mesh)
    learning_rate: float = 5e-4
    lr_warmup_steps: int = 0
    num_steps_before_decay: int = 100_000
    grad_accumulation_steps: int = 1
    max_steps: int = 200_000
    use_val_set: bool = False
    val_freq: int = 10_000
    val_time_limit: int = 180
    save_freq: int = 10_000
    save_latest_checkpoint_only: bool = False
    resume: bool = False
    resume_step: Optional[int] = None
    image_aug: bool = True
    diffusion_sample_freq: int = 50

    # LoRA
    use_lora: bool = True
    lora_rank: int = 32
    lora_dropout: float = 0.0
    merge_lora_during_training: bool = True

    # Logging
    wandb_entity: str = "your-wandb-entity"
    wandb_project: str = "your-wandb-project"
    run_id_note: Optional[str] = None
    run_id_override: Optional[str] = None
    wandb_log_freq: int = 10

    # TPU-native additions
    recipe: Optional[str] = None                  # named recipe (training/recipes.py)
    multihost: bool = False                       # jax.distributed.initialize()
    coordinator_address: Optional[str] = None     # explicit cluster wiring for
    num_processes: Optional[int] = None           # environments without TPU-pod
    process_id: Optional[int] = None              # metadata (e.g. the 2-process
                                                  # CPU dryrun, dryrun_multiprocess.py)
    mesh_dp: int = 1
    mesh_fsdp: int = 1
    mesh_tp: int = 1
    robot_platform: Optional[str] = None          # default: sniff dataset_name
    seq_bucket: int = 0                           # 0 = auto (pad to multiple of 8)
    use_flash_attention: str = "auto"             # "auto" | "true" | "false";
                                                  # auto = K1 where it takes the
                                                  # call, the dense path elsewhere
                                                  # (ops/attention.py::
                                                  # resolve_use_flash)
    quantize_base: bool = False                   # QLoRA-style int8 frozen base
                                                  # (fits 7B LoRA on one 16 GB chip;
                                                  # straight-through bwd, ops/quant.py)
    quantize_base_min_dim: int = 1024             # smallest contraction dim quantized
    quantize_base_bits: int = 8                   # 8 (int8 MXU) | 4 (packed int4,
                                                  # max HBM headroom for b>=2)
    remat_policy: str = "all"                     # "all" | "dots" | "attn_out" | "none"
                                                  # (activation remat; see
                                                  # training/train_step.py)
    # fmt: on


def get_run_id(cfg: FinetuneConfig) -> str:
    """Reference run-ID convention (finetune.py:159-190)."""
    if cfg.run_id_override is not None:
        return cfg.run_id_override
    if cfg.resume:
        run_id = cfg.vla_path.split("/")[-1]
        if "chkpt" in run_id.split("--")[-1]:
            run_id = "--".join(run_id.split("--")[:-1])
        return run_id
    run_id = (f"{cfg.vla_path.split('/')[-1]}+{cfg.dataset_name}"
              f"+b{cfg.batch_size * cfg.grad_accumulation_steps}"
              f"+lr-{cfg.learning_rate}")
    if cfg.use_lora:
        run_id += f"+lora-r{cfg.lora_rank}+dropout-{cfg.lora_dropout}"
    if cfg.image_aug:
        run_id += "--image_aug"
    if cfg.run_id_note is not None:
        run_id += f"--{cfg.run_id_note}"
    return run_id


@dataclasses.dataclass
class TorchFinetuneConfig(FinetuneConfig):
    device: str = "cuda"                          # "cuda", "cuda:N" or "cpu"


def unported_flags(cfg: FinetuneConfig) -> list:
    """(flag, ROADMAP item) for every set flag the port does not run yet."""
    checks = [
        (cfg.multihost, "multihost", f"{_Q1} 17"),
        ((cfg.mesh_dp, cfg.mesh_fsdp, cfg.mesh_tp) != (1, 1, 1), "mesh_*", f"{_Q1} 17"),
        (cfg.quantize_base, "quantize_base", f"{_Q1} 14 (QLoRA base)"),
        (cfg.use_diffusion, "use_diffusion", f"{_Q1} 14 (diffusion objective)"),
        (not cfg.use_l1_regression and not cfg.use_diffusion,
         "use_l1_regression False (discrete objective)", f"{_Q1} 14"),
        (cfg.use_film, "use_film", f"{_Q1} 14 (FiLM in training)"),
        (cfg.use_val_set, "use_val_set", f"{_Q1} 14 (validation)"),
        (cfg.resume, "resume", f"{_Q1} 14 (resume)"),
        (cfg.merge_lora_during_training and cfg.use_lora,
         "merge_lora_during_training True", f"{_Q1} 14 (merged export)"),
        (cfg.remat_policy in ("dots", "attn_out"), f"remat_policy {cfg.remat_policy}",
         f"{_Q1} 14"),
        (str(cfg.data_root_dir) != "dummy", "data_root_dir other than dummy (RLDS)",
         f"{_Q1} 14 (data path)"),
        (not cfg.vla_path.startswith("random:"), "vla_path of a checkpoint",
         f"{_Q1} 14 (checkpoint loading)"),
    ]
    return [(flag, item) for bad, flag, item in checks if bad]


def parse_config(argv=None) -> TorchFinetuneConfig:
    """The CLI's flags (`--flag value`, as the JAX CLI takes them)."""
    from openvla_oft_tpu_torch.utils.cli import parse_args

    return parse_args(TorchFinetuneConfig, argv)


def model_config(cfg: FinetuneConfig):
    """The OpenVLAConfig of `--vla_path random:tiny|random:7b`."""
    import openvla_oft_tpu_torch.config as C

    size = cfg.vla_path.split(":", 1)[1]
    if size == "tiny":
        C._VISION_REGISTRY.setdefault("tiny-dual", (C.TINY_DINOV2, C.TINY_SIGLIP))
        C._LLM_REGISTRY.setdefault("tiny-llama", C.TINY_LLAMA)
        return C.OpenVLAConfig(vision_backbone_id="tiny-dual",
                               llm_backbone_id="tiny-llama",
                               num_images_in_input=cfg.num_images_in_input)
    if size == "7b":
        return C.OpenVLAConfig(vision_backbone_id="dinosiglip-vit-so-224px",
                               llm_backbone_id="llama2-7b-pure",
                               num_images_in_input=cfg.num_images_in_input)
    raise ValueError(f"vla_path random:{size}: use random:tiny or random:7b")


def _use_flash(value) -> object:
    """--use_flash_attention: "auto" | "true" | "false" (case-insensitive).
    Anything else raises, where the JAX CLI would map it to "auto"."""
    choice = {"auto": "auto", "true": True, "false": False}.get(str(value).strip().lower())
    if choice is None:
        raise ValueError(f"--use_flash_attention {value!r}: use auto, true or false")
    return choice


def platform_of(cfg: FinetuneConfig):
    """The robot platform of `--robot_platform` (or of the dataset's name);
    only LIBERO is ported."""
    from openvla_oft_tpu_torch.constants import LIBERO, detect_robot_platform, get_platform

    platform = get_platform(cfg.robot_platform) if cfg.robot_platform else \
        detect_robot_platform(cfg.dataset_name)
    if platform != LIBERO:
        raise NotImplementedError(f"platform {platform.name!r} is not ported yet "
                                  f"({_Q1} 14); the port trains on LIBERO")
    return platform


def train_config(cfg: FinetuneConfig):
    """The TrainConfig the CLI's flags give."""
    from openvla_oft_tpu_torch.training.train_step import TrainConfig

    return TrainConfig(learning_rate=cfg.learning_rate,
                       num_steps_before_decay=cfg.num_steps_before_decay,
                       warmup_steps=cfg.lr_warmup_steps, lora_rank=cfg.lora_rank,
                       lora_alpha=float(min(cfg.lora_rank, 16)),
                       use_proprio=cfg.use_proprio,
                       grad_accumulation_steps=cfg.grad_accumulation_steps,
                       remat_policy=cfg.remat_policy)


def training_data(cfg: FinetuneConfig, model_cfg, platform, num_samples: int):
    """(dataset, collator): the `dummy` dataset through the training
    transform, and the collator that batches it."""
    from openvla_oft_tpu_torch.data.collator import PaddedCollatorForActionPrediction
    from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer
    from openvla_oft_tpu_torch.data.datasets import DummyDataset, RLDSBatchTransform
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor

    transform = RLDSBatchTransform(PrismaticProcessor(model_cfg), ActionTokenizer(),
                                   platform)
    dataset = DummyDataset(transform, image_size=model_cfg.vision_configs[0].image_size,
                           num_samples=num_samples, num_images=cfg.num_images_in_input)
    collator = PaddedCollatorForActionPrediction(pad_token_id=model_cfg.pad_token_id,
                                                 max_length=cfg.seq_bucket or None)
    return dataset, collator


def first_batch(cfg: FinetuneConfig) -> dict:
    """The first batch the CLI trains on, as numpy arrays."""
    dataset, collator = training_data(cfg, model_config(cfg), platform_of(cfg),
                                      cfg.batch_size)
    batch = collator(list(dataset))
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch sees no CUDA device")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: use cuda or cpu")
    return device


def finetune(cfg: TorchFinetuneConfig,
             on_step: Optional[Callable[[int, dict, object], None]] = None) -> dict:
    """Run the fine-tuning loop; returns {"final_step", "run_dir", "ckpt"}.

    on_step(grad_step, metrics, state), if given, runs after every
    micro-step with the step's metrics as floats (and `step_time`, seconds on
    the host clock, ending in a device synchronize).
    """
    from openvla_oft_tpu_torch.data.collator import batch_iterator
    from openvla_oft_tpu_torch.data.transforms import save_dataset_statistics
    from openvla_oft_tpu_torch.training.metrics import JSONLinesTracker, VLAMetrics
    from openvla_oft_tpu_torch.bridge import init_params, split_base_trainables
    from openvla_oft_tpu_torch.training.checkpoint import save_checkpoint
    from openvla_oft_tpu_torch.training.train_step import create_train_state, train_step

    if cfg.recipe:
        from openvla_oft_tpu_torch.training.recipes import apply_recipe

        cfg = apply_recipe(cfg, cfg.recipe)
        print(f"[finetune] applied recipe {cfg.recipe!r}")
    if cfg.use_l1_regression and cfg.use_diffusion:
        raise ValueError("choose at most one continuous objective")
    if not cfg.use_lora:
        raise ValueError("only LoRA fine-tuning is supported (reference finetune.py:779)")
    if cfg.lora_dropout != 0.0:
        raise ValueError("lora_dropout is not implemented (the reference recipes use 0.0)")
    unported = unported_flags(cfg)
    if unported:
        raise NotImplementedError("not ported yet: " + "; ".join(
            f"--{flag} ({item})" for flag, item in unported))
    platform = platform_of(cfg)
    use_flash = _use_flash(cfg.use_flash_attention)
    device = _device(cfg.device)

    run_id = get_run_id(cfg)
    run_dir = os.path.join(str(cfg.run_root_dir), run_id)
    os.makedirs(run_dir, exist_ok=True)
    print(f"[finetune] run_id={run_id} objective=l1 platform={platform.name} "
          f"device={device}")

    # === Model: bf16 base, fp32 heads and LoRA, drawn on the device ===
    model_cfg = model_config(cfg)
    params = init_params(model_cfg, platform,
                         torch.Generator(device=device).manual_seed(0),
                         device=device, dtype=torch.bfloat16, head_dtype=torch.float32)
    base, trainables = split_base_trainables(
        params, torch.Generator(device=device).manual_seed(1), cfg.lora_rank,
        cfg.use_proprio)
    del params
    tcfg = train_config(cfg)
    state = create_train_state(base, trainables, tcfg)

    # === Data ===
    g = max(cfg.grad_accumulation_steps, 1)
    dataset, collator = training_data(cfg, model_cfg, platform,
                                      max(cfg.max_steps, 1) * cfg.batch_size * g)
    stats = {cfg.dataset_name: {
        "action": {"min": [-1.0] * platform.action_dim, "max": [1.0] * platform.action_dim,
                   "q01": [-1.0] * platform.action_dim, "q99": [1.0] * platform.action_dim},
        "num_transitions": len(dataset), "num_trajectories": 1}}
    save_dataset_statistics(stats, run_dir)
    metrics = VLAMetrics([JSONLinesTracker(run_dir, run_id)], window=g)

    ckpt_dir = os.path.join(run_dir, "ckpt")
    ckpt = None
    t_start = time.time()
    for micro, batch in enumerate(batch_iterator(dataset, cfg.batch_size, collator)):
        grad_step = micro // g
        if grad_step >= cfg.max_steps:
            break
        batch = {k: torch.as_tensor(v).to(device, non_blocking=True)
                 for k, v in batch.items() if isinstance(v, np.ndarray)}
        t0 = time.perf_counter()
        state, m = train_step(state, batch, model_cfg, platform, tcfg, use_flash)
        m = {k: float(v) for k, v in m.items()}     # waits for the device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        m["step_time"] = time.perf_counter() - t0
        if not np.isfinite(m["loss"]):
            raise FloatingPointError(f"non-finite loss at micro-step {micro}: {m}")
        metrics.commit(**{k: v for k, v in m.items() if k != "step_time"})
        at_boundary = (micro + 1) % g == 0
        if grad_step % cfg.wandb_log_freq == 0 and at_boundary:
            smoothed = metrics.push(grad_step)
            print(f"[step {grad_step}] " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(smoothed.items())), flush=True)
        if on_step is not None:
            on_step(grad_step, m, state)
        if at_boundary and ((grad_step + 1) % cfg.save_freq == 0
                            or grad_step + 1 == cfg.max_steps):
            ckpt = save_checkpoint(ckpt_dir, grad_step + 1, {
                "trainables": state.trainables,
                "optimizer": state.optimizer.state_dict()})
            print(f"[finetune] saved checkpoint for step {grad_step + 1}: {ckpt}")
    metrics.finalize()
    print(f"[finetune] done: {state.step} micro-steps in {time.time() - t_start:.1f} s")
    return {"final_step": state.step, "run_dir": run_dir, "ckpt": ckpt}


def main(argv=None,
         on_step: Optional[Callable[[int, dict, object], None]] = None) -> dict:
    """Parse `argv` (sys.argv[1:] when None) and run `finetune`."""
    return finetune(parse_config(argv), on_step=on_step)


if __name__ == "__main__":
    main()
