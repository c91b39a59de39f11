"""The LoRA fine-tuning step for the L1 objective.

Port of `openvla_oft_tpu/training/train_step.py` (reference
`vla-scripts/finetune.py` training loop and `run_forward_pass`):

  loss = mean |gt_actions - l1_head(actions_hidden)|   (finetune.py:396-400)

The base VLA is frozen (requires_grad=False); the trainables are
{lora, action_head, proprio_projector}. LoRA enters merge-free
(`training/lora.py::inject_lora`), so the base is never copied. The
optimizer is torch AdamW with the JAX chain's semantics: optional global-norm
clipping (optax `clip_by_global_norm`), the warmup + step-decay schedule
evaluated at the count of applied updates (optax's count; `LambdaLR` starts
at lr(0)), and gradient accumulation that averages `grad_accumulation_steps`
micro-batch gradients before one update (`optax.MultiSteps`).

Unlike the JAX step, which returns a new state, `train_step` updates the
trainables and the optimizer state in place and returns the same state.
The diffusion and discrete objectives are not ported (ROADMAP queue 1,
item 14).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from openvla_oft_tpu_torch.config import OpenVLAConfig
from openvla_oft_tpu_torch.constants import PlatformSpec
from openvla_oft_tpu_torch.bridge import tree_leaves
from openvla_oft_tpu_torch.models.action_heads import l1_head_predict
from openvla_oft_tpu_torch.models.prismatic import prismatic_forward
from openvla_oft_tpu_torch.training.lora import inject_lora

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX `TrainConfig` that the ported step reads."""

    objective: str = "l1"
    learning_rate: float = 5e-4
    num_steps_before_decay: int = 100_000
    lr_decay_factor: float = 0.1          # MultiStepLR gamma (finetune.py:955-962)
    warmup_steps: int = 0
    lora_rank: int = 32
    lora_alpha: float = 16.0
    max_grad_norm: float = 0.0            # 0 = no clipping (reference default)
    use_proprio: bool = True
    weight_decay: float = 0.01            # torch AdamW default
    grad_accumulation_steps: int = 1
    remat_policy: str = "all"             # "all" | "none" ("dots", "attn_out" raise)


def lr_schedule(cfg: TrainConfig):
    """step -> lr: 10%->100% linear warmup (reference finetune.py:1094-1096),
    then constant, times `lr_decay_factor` from `num_steps_before_decay`."""

    def fn(step: int) -> float:
        lr = cfg.learning_rate
        if cfg.warmup_steps > 0:
            lr = lr * (0.1 + 0.9 * min((step + 1) / cfg.warmup_steps, 1.0))
        return lr * cfg.lr_decay_factor if step >= cfg.num_steps_before_decay else lr

    return fn


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in fp32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """The JAX chain `MultiSteps(chain(clip_by_global_norm, adamw))` over a
    fixed list of fp32 trainable tensors."""

    def __init__(self, cfg: TrainConfig, params: List[torch.Tensor]):
        self.cfg = cfg
        self.params = params
        schedule = lr_schedule(cfg)
        self.adamw = torch.optim.AdamW(params, lr=cfg.learning_rate,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=cfg.weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lambda count: schedule(count) / cfg.learning_rate)
        self.micro = 0
        self.accum: Optional[List[torch.Tensor]] = None

    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one micro-batch's gradients; apply an update at the end of
        each accumulation window. Returns whether an update was applied."""
        k = max(self.cfg.grad_accumulation_steps, 1)
        if k > 1:
            if self.accum is None:
                self.accum = [torch.zeros_like(p) for p in self.params]
            for a, g in zip(self.accum, grads):
                a.add_(g)
            self.micro += 1
            if self.micro % k:
                return False
            grads = [a / k for a in self.accum]
            self.accum = None
        if self.cfg.max_grad_norm > 0:
            norm = global_norm(grads)
            if norm >= self.cfg.max_grad_norm:
                grads = [g / norm * self.cfg.max_grad_norm for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        self.adamw.step()
        self.scheduler.step()
        self.adamw.zero_grad(set_to_none=True)
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "micro": self.micro, "accum": self.accum}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.micro, self.accum = state["micro"], state["accum"]


def make_optimizer(cfg: TrainConfig, trainables: Params) -> Optimizer:
    return Optimizer(cfg, tree_leaves(trainables))


@dataclasses.dataclass
class TrainState:
    base_params: Params     # frozen VLA (llm + vision_backbone + projector)
    trainables: Params      # {lora, action_head, proprio_projector}
    optimizer: Optimizer
    step: int = 0           # micro-steps taken


def create_train_state(base_params: Params, trainables: Params,
                       cfg: TrainConfig) -> TrainState:
    return TrainState(base_params, trainables, make_optimizer(cfg, trainables))


def _merged_params(base: Params, trainables: Params, cfg: TrainConfig) -> Params:
    """The base with LoRA injected and the trainable proprio projector."""
    params = inject_lora(base, trainables["lora"], cfg.lora_rank, cfg.lora_alpha) \
        if "lora" in trainables else dict(base)
    if "proprio_projector" in trainables:
        params["proprio_projector"] = trainables["proprio_projector"]
    return params


def loss_and_metrics(trainables: Params, base_params: Params,
                     batch: Dict[str, torch.Tensor], model_cfg: OpenVLAConfig,
                     platform: PlatformSpec, cfg: TrainConfig,
                     use_flash="auto") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of one batch: the differentiable L1 loss, and the
    detached `loss`, `curr_action_l1_loss` and `next_actions_l1_loss`."""
    if cfg.objective != "l1":
        raise NotImplementedError(f"objective {cfg.objective!r} is not ported yet "
                                  "(ROADMAP queue 1, item 14)")
    params = _merged_params(base_params, trainables, cfg)
    out = prismatic_forward(
        params, model_cfg, platform, input_ids=batch["input_ids"],
        attention_mask=batch["attention_mask"], pixels=batch["pixel_values"],
        labels=batch["labels"],
        proprio=batch.get("proprio") if cfg.use_proprio else None,
        use_flash=use_flash, remat_policy=cfg.remat_policy)
    gt = batch["actions"].float()
    pred = l1_head_predict(trainables["action_head"],
                           out.actions_hidden.to(torch.bfloat16), platform).float()
    loss = (gt - pred).abs().mean()
    with torch.no_grad():
        metrics = {"loss": loss.detach(),
                   "curr_action_l1_loss": (gt[:, 0] - pred[:, 0]).abs().mean(),
                   "next_actions_l1_loss": (gt[:, 1:] - pred[:, 1:]).abs().mean()}
    return loss, metrics


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               model_cfg: OpenVLAConfig, platform: PlatformSpec, cfg: TrainConfig,
               use_flash="auto") -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One micro-step: forward, backward, and (at the end of an accumulation
    window) an optimizer update. Metrics add `grad_norm`, the global norm of
    this micro-batch's gradients."""
    leaves = state.optimizer.params
    loss, metrics = loss_and_metrics(state.trainables, state.base_params, batch,
                                     model_cfg, platform, cfg, use_flash)
    grads = torch.autograd.grad(loss, leaves)
    metrics["grad_norm"] = global_norm(grads).detach()
    state.optimizer.update(grads)
    state.step += 1
    return state, metrics
