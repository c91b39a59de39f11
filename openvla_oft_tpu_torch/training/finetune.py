"""Fine-tune OpenVLA-OFT with LoRA, in PyTorch.

The counterpart of `vla_scripts/finetune.py::finetune`, with the same flags
(its `FinetuneConfig`) plus `--device`:

    python -m openvla_oft_tpu_torch.training.finetune --device cuda \\
      --vla_path random:7b --data_root_dir dummy --robot_platform libero \\
      --use_l1_regression True --use_proprio True --num_images_in_input 2 \\
      --lora_rank 32 --batch_size 8 --max_steps 3 --run_root_dir /tmp/runs

Ported: random weights (`random:tiny` or `random:7b`, drawn on the device
from a seeded generator) or a checkpoint dir (its LLM, vision backbone and
projector loaded onto the device; the heads, FiLM and LoRA drawn as for
`random:`), a QLoRA base (`--quantize_base`, int8 or int4, quantized on the
device after LoRA is drawn on the float base), the `dummy` dataset or RLDS
episode shards under `--data_root_dir` (`data/rlds/pipeline.py::
make_rlds_iterator`, no TensorFlow; its statistics saved to the run dir),
the batches moved to the device by `data/prefetch.py::DevicePrefetcher` on a
side stream, validation on a held-out stream (`--use_val_set`), `--recipe`,
the three objectives (L1, `--use_diffusion` with the periodic sampling
metric, and the discrete CE of `--use_l1_regression False`), FiLM
(`--use_film`) on every registered platform, the remat policies ("all",
"dots", "attn_out", "none"), gradient accumulation, metrics through
`VLAMetrics` (JSONL), and checkpoints at every `save_freq` gradient steps
and at the last (`save_training_checkpoint`: the resume file, written in the
background, and the reference's layout of per-module `.pt` files and, with
`--merge_lora_during_training`, the merged model), `--resume`, and
preemption (SIGTERM or SIGINT: a checkpoint, then a clean return), and
several GPUs, one process each (`parallel/`): `--multihost True` sets up the
process group (from torchrun's environment, or `--coordinator_address`,
`--num_processes`, `--process_id`) and `--mesh_dp/--mesh_fsdp/--mesh_tp`
shape the mesh, whose product is the process count:

    torchrun --nproc-per-node 4 -m openvla_oft_tpu_torch.training.finetune \
      --multihost True --mesh_fsdp 2 --mesh_tp 2 --seq_bucket 640 ...

`--batch_size` is the global batch, split over the dp x fsdp data ranks.
`--device cuda` never falls back to the CPU, and nothing is downloaded: a
`vla_path` that is neither `random:` nor a dir raises.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

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


def run_mesh(cfg, device: torch.device):
    """The ("dp", "fsdp", "tp") mesh of `--mesh_*` over the process group, or
    None for a run on one device without a group (mesh 1 x 1 x 1, no
    `--multihost`). `--multihost` sets the group up from
    `--coordinator_address`, `--num_processes` and `--process_id` (a
    "host:port" or a `file://` / `tcp://` URL), else from torchrun's
    environment; a larger mesh without `--multihost` takes torchrun's. One
    process drives one device: the mesh's product is the process count."""
    from openvla_oft_tpu_torch.parallel.mesh import init_distributed, make_mesh

    multihost = getattr(cfg, "multihost", False)
    shape = (cfg.mesh_dp, cfg.mesh_fsdp, cfg.mesh_tp)
    if not multihost and shape == (1, 1, 1):
        return None
    if multihost:
        init_distributed(device.type, cfg.coordinator_address, cfg.num_processes,
                         cfg.process_id)
    else:
        init_distributed(device.type)
    return make_mesh(*shape, device_type=device.type)


def data_rank(mesh) -> tuple:
    """(index, count) of this process among the ranks the batch splits over
    (dp x fsdp; the tp ranks of a data rank read the same rows)."""
    if mesh is None:
        return 0, 1
    dp, fsdp = mesh.size(0), mesh.size(1)
    c = mesh.get_coordinate()
    return c[0] * fsdp + c[1], dp * fsdp


def objective_of(cfg: FinetuneConfig) -> str:
    """"l1", "diffusion" or "discrete", from the flags (JAX finetune.py:191-192)."""
    return "l1" if cfg.use_l1_regression else "diffusion" if cfg.use_diffusion \
        else "discrete"


def parse_config(argv=None) -> TorchFinetuneConfig:
    """The CLI's flags (`--flag value`, as the JAX CLI takes them)."""
    from openvla_oft_tpu_torch.utils.cli import parse_args

    return parse_args(TorchFinetuneConfig, argv)


def model_config(cfg: FinetuneConfig):
    """The OpenVLAConfig of `--vla_path`: `random:tiny`, `random:7b`, or a
    checkpoint dir's config.json, with `num_images_in_input` and `use_film`
    from the flags. Anything else (a hub id) raises: nothing is downloaded."""
    import openvla_oft_tpu_torch.config as C

    kw = dict(num_images_in_input=cfg.num_images_in_input, use_film=cfg.use_film)
    if cfg.vla_path.startswith("random:"):
        size = cfg.vla_path.split(":", 1)[1]
        if size == "tiny":
            C._VISION_REGISTRY.setdefault("tiny-dual", (C.TINY_DINOV2, C.TINY_SIGLIP))
            C._LLM_REGISTRY.setdefault("tiny-llama", C.TINY_LLAMA)
            return C.OpenVLAConfig(vision_backbone_id="tiny-dual",
                                   llm_backbone_id="tiny-llama", **kw)
        if size == "7b":
            return C.OpenVLAConfig(vision_backbone_id="dinosiglip-vit-so-224px",
                                   llm_backbone_id="llama2-7b-pure", **kw)
        raise ValueError(f"vla_path random:{size}: use random:tiny or random:7b")
    if os.path.isdir(cfg.vla_path):
        model_cfg, _ = C.OpenVLAConfig.from_json_file(os.path.join(cfg.vla_path,
                                                                   "config.json"))
        return dataclasses.replace(model_cfg, **kw)
    raise ValueError(f"--vla_path {cfg.vla_path!r} is neither random:<tiny|7b> nor a "
                     "checkpoint dir: the port downloads nothing, so a hub id needs a "
                     "local copy of its checkpoint dir")


def _use_flash(value) -> object:
    """--use_flash_attention: "auto" | "true" | "false" (case-insensitive).
    Anything else raises, where the JAX CLI would map it to "auto"."""
    choice = {"auto": "auto", "true": True, "false": False}.get(str(value).strip().lower())
    if choice is None:
        raise ValueError(f"--use_flash_attention {value!r}: use auto, true or false")
    return choice


def platform_of(cfg: FinetuneConfig):
    """The robot platform of `--robot_platform` (or of the dataset's name)."""
    from openvla_oft_tpu_torch.constants import detect_robot_platform, get_platform

    return get_platform(cfg.robot_platform) if cfg.robot_platform else \
        detect_robot_platform(cfg.dataset_name)


def train_config(cfg: FinetuneConfig):
    """The TrainConfig the CLI's flags give."""
    from openvla_oft_tpu_torch.training.train_step import TrainConfig

    return TrainConfig(objective=objective_of(cfg), learning_rate=cfg.learning_rate,
                       num_steps_before_decay=cfg.num_steps_before_decay,
                       warmup_steps=cfg.lr_warmup_steps, lora_rank=cfg.lora_rank,
                       lora_alpha=float(min(cfg.lora_rank, 16)),
                       use_proprio=cfg.use_proprio, use_film=cfg.use_film,
                       num_diffusion_steps=cfg.num_diffusion_steps,
                       grad_accumulation_steps=cfg.grad_accumulation_steps,
                       remat_policy=cfg.remat_policy)


def training_data(cfg: FinetuneConfig, model_cfg, platform, num_samples: int,
                  train: bool = True, process: tuple = (0, 1)):
    """(dataset, collator, stats): the examples through the training
    transform, the collator that batches them, and {dataset_name: stats}.
    `dummy`: `num_samples` random examples (seed 0, or 999 for the
    validation stream); else the RLDS episodes under `data_root_dir`, train
    mode shuffled over `shuffle_buffer_size` frames and repeated, the
    validation stream (`train=False`) one pass in order. `process` = (index,
    count) of this data rank: the RLDS reader takes its shard of the
    episode files (`local_batches` cuts the dummy set's global batches)."""
    from openvla_oft_tpu_torch.data.collator import PaddedCollatorForActionPrediction
    from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer
    from openvla_oft_tpu_torch.data.datasets import DummyDataset, RLDSBatchTransform
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor

    transform = RLDSBatchTransform(PrismaticProcessor(model_cfg), ActionTokenizer(),
                                   platform)
    if str(cfg.data_root_dir) == "dummy":
        dataset = DummyDataset(transform, image_size=model_cfg.vision_configs[0].image_size,
                               num_samples=num_samples, num_images=cfg.num_images_in_input,
                               seed=0 if train else 999)
        stats = {cfg.dataset_name: {
            "action": {"min": [-1.0] * platform.action_dim, "max": [1.0] * platform.action_dim,
                       "q01": [-1.0] * platform.action_dim, "q99": [1.0] * platform.action_dim},
            "num_transitions": len(dataset), "num_trajectories": 1}}
    else:
        from openvla_oft_tpu_torch.data.rlds.pipeline import make_rlds_iterator

        dataset, stats = make_rlds_iterator(
            str(cfg.data_root_dir), cfg.dataset_name, transform, platform,
            shuffle_buffer_size=cfg.shuffle_buffer_size if train else 1000,
            image_aug=cfg.image_aug, train=train, num_images=cfg.num_images_in_input,
            process_index=process[0], process_count=process[1])
    collator = PaddedCollatorForActionPrediction(pad_token_id=model_cfg.pad_token_id,
                                                 max_length=cfg.seq_bucket or None)
    return dataset, collator, stats


def local_batches(cfg: FinetuneConfig, dataset, collator, index: int, count: int):
    """This data rank's batches of `batch_size // count` rows: from its own
    shard of the episodes, or, for `dummy`, its rows of every global batch
    (so that a run on any mesh trains on the global batches of one
    device)."""
    from openvla_oft_tpu_torch.data.collator import batch_iterator, rank_rows

    if str(cfg.data_root_dir) != "dummy" or count == 1:
        return batch_iterator(dataset, cfg.batch_size // count, collator)
    return rank_rows(batch_iterator(dataset, cfg.batch_size, collator), index, count)


def _any_rank(flag: bool, mesh, device: torch.device) -> bool:
    """`flag` of any rank (an all-reduce), or the flag itself without a mesh."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return bool(t.item())


def first_batch(cfg: FinetuneConfig) -> dict:
    """The first batch the CLI trains on, as numpy arrays."""
    from openvla_oft_tpu_torch.data.collator import batch_iterator

    dataset, collator, _ = training_data(cfg, model_config(cfg), platform_of(cfg),
                                         cfg.batch_size)
    batch = next(batch_iterator(dataset, cfg.batch_size, collator))
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch sees no CUDA device")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: use cuda or cpu")
    return device


_BASE = ("llm", "vision_backbone", "projector")


def build_model(cfg: FinetuneConfig, model_cfg, platform, device: torch.device):
    """(frozen base, trainables): a bf16 base and fp32 heads, FiLM and LoRA.
    `random:` draws the whole tree from a generator seeded 0 on the device;
    a checkpoint dir's LLM, vision backbone and projector are loaded onto the
    device leaf by leaf (with the lm_head for the discrete objective, which
    raises naming `language_model.lm_head.weight` where the dir has none)
    and the rest is drawn from the same generator. LoRA comes from a
    generator seeded 1 (`bridge.py::split_base_trainables`), on the float
    base. `--quantize_base` then quantizes the LLM, the vision backbone and
    the projector (`ops/quant.py::quantize_tree_lowmem`, int8 or int4 by
    `--quantize_base_bits`, kernels with at least `--quantize_base_min_dim`
    inputs), leaf by leaf, so the float and quantized trees never coexist
    (the JAX CLI's order, finetune.py:252-268)."""
    from openvla_oft_tpu_torch.bridge import init_params, param_spec, split_base_trainables

    head = objective_of(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    kw = dict(device=device, dtype=torch.bfloat16, head_dtype=torch.float32, head=head)
    if cfg.vla_path.startswith("random:"):
        params = init_params(model_cfg, platform, gen, **kw)
    else:
        from openvla_oft_tpu_torch.utils.hf_import import load_openvla_checkpoint

        _, params, _ = load_openvla_checkpoint(cfg.vla_path, dtype=torch.bfloat16,
                                               device=device, head=head)
        heads = [k for k in param_spec(model_cfg, platform, head) if k not in _BASE]
        params.update(init_params(model_cfg, platform, gen, keys=heads, **kw))
    base, trainables = split_base_trainables(
        params, torch.Generator(device=device).manual_seed(1), cfg.lora_rank, cfg.use_proprio)
    del params
    if cfg.quantize_base:
        from openvla_oft_tpu_torch.ops.quant import quantize_tree_lowmem

        for k in _BASE:
            base[k] = quantize_tree_lowmem(base[k], min_dim=cfg.quantize_base_min_dim,
                                           bits=cfg.quantize_base_bits)
    return base, trainables


def checkpoint_norm_stats(cfg: FinetuneConfig) -> Optional[dict]:
    """The statistics of the `--vla_path` dir (its config.json's, else its
    `dataset_statistics.json`), None for `random:`: what the merged export
    carries, as the JAX CLI passes the loader's norm_stats."""
    if not os.path.isdir(cfg.vla_path):
        return None
    import openvla_oft_tpu_torch.config as C
    from openvla_oft_tpu_torch.utils.hf_import import _read_norm_stats

    _, stats = C.OpenVLAConfig.from_json_file(os.path.join(cfg.vla_path, "config.json"))
    return _read_norm_stats(cfg.vla_path, stats)


def restore_training_state(state, cfg: FinetuneConfig, ckpt_dir: str,
                           device: torch.device) -> int:
    """`--resume`: the trainables and the optimizer's state (its moments,
    step count, accumulation and the LR scheduler's position) of gradient
    step `--resume_step`, else of the latest one in `ckpt_dir`, into
    `state`, whose micro-step becomes step x grad_accumulation_steps (JAX
    finetune.py:334-365); sharded trainables and moments take their slices
    of the file's whole tensors, at any world size. Returns the step. The
    data stream and the step's generator restart from their seeds, as in
    the JAX CLI."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.parallel.sharding import copy_into
    from openvla_oft_tpu_torch.training.checkpoint import (checkpoint_path, latest_step,
                                                           restore_checkpoint)

    step0 = cfg.resume_step if cfg.resume_step is not None else latest_step(ckpt_dir)
    if step0 is None or not os.path.exists(checkpoint_path(ckpt_dir, step0)):
        which = "" if step0 is None else f" for step {step0}"
        raise FileNotFoundError(f"--resume: no checkpoint{which} in {ckpt_dir}")
    restored = restore_checkpoint(ckpt_dir, step0, map_location=device)
    dst, src = tree_leaves(state.trainables), tree_leaves(restored["trainables"])
    shapes = [tuple(t.shape) for t in dst], [tuple(t.shape) for t in src]
    if shapes[0] != shapes[1]:
        raise RuntimeError(f"--resume: the trainables in {ckpt_dir} step {step0} do not fit "
                           "this run's (another model, rank or LoRA layout; a pre-rank-major "
                           "checkpoint can still be merged offline, scripts/"
                           "merge_lora_weights_and_save.py migrates its A factors)")
    with torch.no_grad():
        for d, s in zip(dst, src):
            copy_into(d, s)
    state.optimizer.load_state_dict(restored["optimizer"])
    state.step = step0 * max(cfg.grad_accumulation_steps, 1)
    return step0


def _copy_tokenizer(src_dir: str, dst_dir: str) -> None:
    """The tokenizer files of a checkpoint dir, copied beside a merged export
    (the reference saves its processor with the model; `get_vla` needs it)."""
    import shutil

    from openvla_oft_tpu_torch.serving.openvla_utils import TOKENIZER_FILES

    for name in TOKENIZER_FILES:
        if os.path.isfile(os.path.join(src_dir, name)):
            shutil.copyfile(os.path.join(src_dir, name), os.path.join(dst_dir, name))


def save_training_checkpoint(cfg: FinetuneConfig, state, grad_step: int, run_dir: str,
                             stats: dict, model_cfg, norm_stats: Optional[dict] = None,
                             mesh=None) -> str:
    """The layout of the JAX CLI's `save_training_checkpoint`
    (finetune.py:509-619). The resume file goes to `run_dir/ckpt` without
    blocking (`save_checkpoint(block=False)`). Into `{run_dir}--{N}_chkpt`,
    or `run_dir` with the label `latest` under
    `--save_latest_checkpoint_only` (which also prunes the older resume
    files): `dataset_statistics.json`, the per-module `.pt` files, the FiLMed
    vision backbone's `.pt` (FiLM on, base not quantized), and with
    `--merge_lora_during_training` the merged model
    (`training/lora.py::merge_lora_into_params` on the base's device, into a
    host tree one leaf at a time; `export_openvla_checkpoint`). Under
    `--quantize_base` the merge reloads the float base from `--vla_path` in
    its stored dtype, or is skipped where `--vla_path` is not a dir. Returns
    the resume file's path.

    On a mesh every rank calls it: the trainables and the optimizer's state
    are gathered whole (`parallel/sharding.py::gather_params`, a
    collective), then rank 0 alone writes the single-file format, which a
    resume at any world size re-shards. Over several processes the merged
    export runs only from a `--vla_path` dir (the float base reloaded from
    it, as under `--quantize_base`), as in the JAX CLI."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.data.transforms import save_dataset_statistics
    from openvla_oft_tpu_torch.parallel.sharding import gather_params
    from openvla_oft_tpu_torch.training.checkpoint import (checkpoint_path,
                                                           export_film_vision_backbone_pt,
                                                           export_module_pt,
                                                           prune_old_steps, save_checkpoint,
                                                           wait_for_checkpoints)

    ckpt_dir = os.path.join(run_dir, "ckpt")
    tr, opt = state.trainables, state.optimizer.state_dict()
    n_proc = 1 if mesh is None else mesh.size()
    film = cfg.use_film and "film" in tr and not cfg.quantize_base
    vision = state.base_params["vision_backbone"] if film else None
    if mesh is not None:
        tr, opt = gather_params(tr, to_host=True), gather_params(opt, to_host=True)
        vision = gather_params(vision, to_host=True) if film else None
        if torch.distributed.get_rank() != 0:
            return checkpoint_path(ckpt_dir, grad_step)
    ckpt = save_checkpoint(ckpt_dir, grad_step, {"trainables": tr, "optimizer": opt},
                           block=False)
    if cfg.save_latest_checkpoint_only:
        chkpt_dir, label = run_dir, "latest"
        prune_old_steps(ckpt_dir)            # waits for the write first
    else:
        chkpt_dir, label = f"{run_dir}--{grad_step}_chkpt", str(grad_step)
    os.makedirs(chkpt_dir, exist_ok=True)
    save_dataset_statistics(stats, chkpt_dir)
    print(f"[finetune] saved checkpoint for step {grad_step}")
    for mod in ("action_head", "proprio_projector", "noisy_action_projector"):
        if mod in tr:
            export_module_pt(tr[mod], mod, chkpt_dir, label)
    if film:
        export_film_vision_backbone_pt(vision, tr["film"], model_cfg, chkpt_dir, label)
    if not (cfg.merge_lora_during_training and cfg.use_lora):
        return ckpt
    from openvla_oft_tpu_torch.training.lora import merge_lora_into_params
    from openvla_oft_tpu_torch.utils.hf_import import (export_openvla_checkpoint,
                                                       load_openvla_checkpoint)

    from_dir = os.path.isdir(cfg.vla_path)
    if n_proc > 1 and not from_dir:
        print("[finetune] skipping merged export under multihost: the sharded base "
              "would need a full cross-host gather; merge offline with "
              "merge_lora_weights_and_save.py")
        return ckpt
    if cfg.quantize_base or n_proc > 1:
        if not from_dir:
            print("[finetune] skipping merged export: base is quantized and vla_path is "
                  "not a local checkpoint to re-merge against; use "
                  "merge_lora_weights_and_save.py offline")
            return ckpt
        wait_for_checkpoints()
        device = tree_leaves(state.trainables)[0].device      # tr may be on the host
        _, loaded, _ = load_openvla_checkpoint(cfg.vla_path, dtype=None, device=device)
        base = {k: loaded[k] for k in _BASE}
        del loaded
    else:
        base = gather_params(state.base_params)      # one rank: the local tensors
    with torch.no_grad():
        merged = merge_lora_into_params(base, tr["lora"], rank=cfg.lora_rank,
                                        alpha=float(min(cfg.lora_rank, 16)), out_device="cpu")
    del base
    export_openvla_checkpoint(model_cfg, merged, chkpt_dir, norm_stats=norm_stats,
                              extras_from=cfg.vla_path if from_dir else None)
    if from_dir:
        _copy_tokenizer(cfg.vla_path, chkpt_dir)
    print(f"[finetune] merged LoRA checkpoint -> {chkpt_dir}")
    return ckpt


def run_validation(state, val_batches, model_cfg, platform, tcfg, device: torch.device,
                   time_limit: float, use_flash="auto") -> tuple:
    """The validation loss and metrics over `val_batches` (host batches) as
    long as `time_limit` seconds allow, without gradients (reference
    `run_validation`, finetune.py:678-760): ({f"val_{name}": mean}, batches
    run). The diffusion draws come from a generator seeded 4242."""
    from openvla_oft_tpu_torch.parallel.sharding import dtensor_context
    from openvla_oft_tpu_torch.training.train_step import loss_and_metrics

    gen = torch.Generator(device=device).manual_seed(4242)
    agg: dict = {}
    t0 = time.perf_counter()
    with torch.no_grad(), dtensor_context(state.trainables):
        for vb in val_batches:
            if time.perf_counter() - t0 > time_limit:
                break
            vb = {k: torch.as_tensor(v).to(device) for k, v in vb.items()
                  if isinstance(v, np.ndarray)}
            _, m = loss_and_metrics(state.trainables, state.base_params, vb, model_cfg,
                                    platform, tcfg, gen, use_flash)
            for k, v in m.items():
                agg.setdefault(k, []).append(float(v))
    return {f"val_{k}": float(np.mean(v)) for k, v in agg.items()}, len(agg.get("loss", []))


def finetune(cfg: TorchFinetuneConfig,
             on_step: Optional[Callable[[int, dict, object], None]] = None,
             on_validation: Optional[Callable[[int, dict, int], None]] = None) -> dict:
    """Run the fine-tuning loop; returns {"final_step" (micro-steps taken,
    counting those before a resume), "run_dir", "ckpt" (the last resume
    file written, or None)}.

    on_step(grad_step, metrics, state), if given, runs after every
    micro-step with the step's metrics as floats (and `step_time`, seconds on
    the host clock around the step, ending in a device synchronize, and
    `data_time`, the wait for the prefetched batch). On a step that ran the
    diffusion sampling metric they hold its metrics and `sample_time` too.
    on_validation(grad_step, val_metrics, n_batches) runs after each
    validation pass (`--use_val_set`, every `val_freq` gradient steps).

    SIGTERM or SIGINT during the run (`training/preemption.py`) makes the
    loop save a checkpoint after the micro-step in flight, labelled
    grad_step + 1 as in the JAX CLI (also in the middle of an accumulation
    window: the optimizer's partial sums are in the resume file), and
    return. The handlers are restored when the loop ends, also on an
    exception, and every background write is waited for.
    """
    from openvla_oft_tpu_torch.data.collator import batch_iterator
    from openvla_oft_tpu_torch.data.prefetch import DevicePrefetcher
    from openvla_oft_tpu_torch.data.transforms import save_dataset_statistics
    from openvla_oft_tpu_torch.training.metrics import JSONLinesTracker, VLAMetrics
    from openvla_oft_tpu_torch.training.checkpoint import wait_for_checkpoints
    from openvla_oft_tpu_torch.training.preemption import PreemptionGuard
    from openvla_oft_tpu_torch.training.train_step import (create_train_state,
                                                           diffusion_sampling_metrics,
                                                           train_step)

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
    platform = platform_of(cfg)
    use_flash = _use_flash(cfg.use_flash_attention)
    device = _device(cfg.device)
    model_cfg = model_config(cfg)
    objective = objective_of(cfg)
    mesh = run_mesh(cfg, device)
    proc, n_data = data_rank(mesh)
    n_proc = mesh.size() if mesh is not None else 1
    is_primary = mesh is None or torch.distributed.get_rank() == 0
    if cfg.batch_size % n_data:
        raise ValueError(f"the global batch {cfg.batch_size} must divide over the "
                         f"{n_data} data ranks (dp x fsdp)")
    if n_proc > 1 and cfg.seq_bucket <= 0:
        raise ValueError("multihost requires --seq_bucket: auto length-bucketing is "
                         "per-process and the padded lengths would diverge across ranks")
    if device.type == "cuda" and mesh is not None:
        device = torch.device("cuda", torch.cuda.current_device())

    run_id = get_run_id(cfg)
    run_dir = os.path.join(str(cfg.run_root_dir), run_id)
    ckpt_dir = os.path.join(run_dir, "ckpt")
    if cfg.resume and not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"--resume: no checkpoint in {ckpt_dir}")
    os.makedirs(run_dir, exist_ok=True)
    print(f"[finetune] run_id={run_id} objective={objective} platform={platform.name} "
          f"film={model_cfg.use_film} device={device}"
          + ("" if mesh is None else f" rank={torch.distributed.get_rank()}/{n_proc} "
             f"mesh={tuple(mesh.mesh.shape)}"))

    # === Model: bf16 (or quantized) base, fp32 heads, FiLM and LoRA, on the device ===
    base, trainables = build_model(cfg, model_cfg, platform, device)
    if mesh is not None:
        from openvla_oft_tpu_torch.parallel.sharding import shard_params

        base, trainables = shard_params(base, mesh), shard_params(trainables, mesh)
    tcfg = train_config(cfg)
    state = create_train_state(base, trainables, tcfg,
                               torch.Generator(device=device).manual_seed(2))
    if cfg.resume:
        step0 = restore_training_state(state, cfg, ckpt_dir, device)
        print(f"[finetune] resumed at gradient step {step0}")
    norm_stats = checkpoint_norm_stats(cfg)

    # === Data: each data rank takes its rows of the global batch ===
    g = max(cfg.grad_accumulation_steps, 1)
    dataset, collator, stats = training_data(cfg, model_cfg, platform,
                                             max(cfg.max_steps, 1) * cfg.batch_size * g,
                                             process=(proc, n_data))
    if is_primary:
        save_dataset_statistics(stats, run_dir)
    # Host IO on the primary process only; every rank computes the metrics.
    metrics = VLAMetrics([JSONLinesTracker(run_dir, run_id)] if is_primary else [], window=g)
    val_batches = None        # the validation stream, built once, at its first use

    ckpt = None
    start = state.step
    t_start = time.time()
    prefetched = DevicePrefetcher(local_batches(cfg, dataset, collator, proc, n_data), device)
    try:
        with PreemptionGuard() as guard:
            micro = state.step - 1
            while True:
                t_wait = time.perf_counter()
                batch = next(prefetched, None)
                if batch is None or (micro + 1) // g >= cfg.max_steps:
                    break
                micro += 1
                grad_step = micro // g
                t0 = time.perf_counter()
                state, m = train_step(state, batch, model_cfg, platform, tcfg, use_flash)
                m = {k: float(v) for k, v in m.items()}     # waits for the device
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                m["step_time"] = time.perf_counter() - t0
                m["data_time"] = t0 - t_wait
                metrics.commit(**{k: v for k, v in m.items()
                                  if k not in ("step_time", "data_time")})
                at_boundary = (micro + 1) % g == 0
                if cfg.use_diffusion and at_boundary \
                        and (grad_step + 1) % cfg.diffusion_sample_freq == 0:
                    # Reverse diffusion on the step's batch, its generator seeded
                    # from the step (the JAX CLI's PRNGKey(grad_step)).
                    t0 = time.perf_counter()
                    dm = diffusion_sampling_metrics(
                        state.trainables, state.base_params, batch, model_cfg, platform, tcfg,
                        torch.Generator(device=device).manual_seed(grad_step), use_flash)
                    dm = {k: float(v) for k, v in dm.items()}
                    metrics.commit(**dm)
                    m.update(dm, sample_time=time.perf_counter() - t0)
                if grad_step % cfg.wandb_log_freq == 0 and at_boundary:
                    smoothed = metrics.push(grad_step)
                    print(f"[step {grad_step}] " + " ".join(
                        f"{k}={v:.4f}" for k, v in sorted(smoothed.items())), flush=True)
                if on_step is not None:
                    on_step(grad_step, m, state)
                if cfg.use_val_set and at_boundary and (grad_step + 1) % cfg.val_freq == 0:
                    if val_batches is None:
                        val_set, _, _ = training_data(cfg, model_cfg, platform,
                                                      8 * cfg.batch_size, train=False)
                        val_batches = batch_iterator(val_set, cfg.batch_size, collator)
                    extra, n_val = run_validation(state, val_batches, model_cfg, platform,
                                                  tcfg, device, cfg.val_time_limit, use_flash)
                    if n_val:
                        metrics.push(grad_step, extra=extra)
                        print(f"[finetune] val_loss={extra['val_loss']:.4f} ({n_val} batches)",
                              flush=True)
                    if on_validation is not None:
                        on_validation(grad_step, extra, n_val)
                # The signal's flag is polled once the micro-step is done, so the
                # checkpoint is the consistent post-step state; on several
                # ranks any rank's signal stops them all (the save is collective).
                preempted = _any_rank(guard.should_stop, mesh, device)
                if preempted or (at_boundary and ((grad_step + 1) % cfg.save_freq == 0
                                                  or grad_step + 1 == cfg.max_steps)):
                    ckpt = save_training_checkpoint(cfg, state, grad_step + 1, run_dir, stats,
                                                    model_cfg, norm_stats, mesh)
                if preempted:
                    print(f"[finetune] preempted (signal {guard.received_signal}); "
                          f"checkpoint saved at step {grad_step + 1} - resume with "
                          "--resume True", flush=True)
                    break
    finally:
        prefetched.close()      # the worker and its buffered device batches
        wait_for_checkpoints()  # the background writes, also on an exception
    metrics.finalize()
    print(f"[finetune] done: {state.step - start} micro-steps in "
          f"{time.time() - t_start:.1f} s")
    return {"final_step": state.step, "run_dir": run_dir, "ckpt": ckpt}


def main(argv=None,
         on_step: Optional[Callable[[int, dict, object], None]] = None,
         on_validation: Optional[Callable[[int, dict, int], None]] = None) -> dict:
    """Parse `argv` (sys.argv[1:] when None) and run `finetune`."""
    return finetune(parse_config(argv), on_step=on_step, on_validation=on_validation)


if __name__ == "__main__":
    main()
