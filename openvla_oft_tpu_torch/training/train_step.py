"""The LoRA fine-tuning step for the three OFT objectives.

Port of `openvla_oft_tpu/training/train_step.py` (reference
`vla-scripts/finetune.py` training loop and `run_forward_pass`):
  - "l1":        mean |gt_actions - l1_head(actions_hidden)|   (finetune.py:396-400)
  - "diffusion": MSE(predicted noise, sampled noise)          (finetune.py:402-407)
  - "discrete":  next-token CE over the labels that are not IGNORE (HF loss
                 semantics), with token and action accuracies and the L1 of
                 the decoded bin centres as metrics.
`diffusion_sampling_metrics` runs the reverse diffusion on a training batch
(reference `run_diffusion_sampling`, finetune.py:454-540).

The base VLA is frozen (requires_grad=False); the trainables are
{lora, action_head, proprio_projector, noisy_action_projector, film}, as far
as the model has them. LoRA enters merge-free
(`training/lora.py::inject_lora`), so the base is never copied. Full-parameter
training (`scripts/train.py`, `scripts/pretrain.py`) makes whole `llm`,
`vision_backbone` or `projector` subtrees trainable, or `llm_last_layer`: the
last slice of every stacked layer leaf with `embed` and `lm_head`, which the
merged tree reads in place of the stack's slice L-1 without a copy of the
stack (`LastSliceOverride`).

The optimizer has the JAX chain's semantics: optional global-norm clipping
(optax `clip_by_global_norm`), the warmup + step-decay schedule evaluated at
the count of applied updates (optax's count; `LambdaLR` starts at lr(0)),
gradient accumulation that averages `grad_accumulation_steps` micro-batch
gradients before one update (`optax.MultiSteps`), and AdamW: torch's for
fp32 trainables, and for bf16 ones (the full-parameter stages, which JAX
trains in bf16 with bf16 moments) optax's own op order in bf16
(`Bf16AdamW`), a leaf or a layer slice at a time.

Unlike the JAX step, which returns a new state, `train_step` updates the
trainables and the optimizer state in place and returns the same state. The
state carries a `torch.Generator` (the JAX state's `rng`) that the diffusion
objective draws its noise and timesteps from.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from openvla_oft_tpu_torch.config import OpenVLAConfig
from openvla_oft_tpu_torch.constants import (IGNORE_INDEX, LLAMA2_VOCAB_SIZE, N_ACTION_BINS,
                                            PlatformSpec)
from openvla_oft_tpu_torch.bridge import tree_leaves
from openvla_oft_tpu_torch.models import action_heads as AH
from openvla_oft_tpu_torch.models.prismatic import prismatic_forward
from openvla_oft_tpu_torch.ops.masks import get_current_action_mask, get_next_actions_mask
from openvla_oft_tpu_torch.parallel.mesh import mesh_shape
from openvla_oft_tpu_torch.parallel.sharding import (compute_view, copy_into, distribute,
                                                     dtensor_context)
from openvla_oft_tpu_torch.processing.image_processing import _linspace_f32
from openvla_oft_tpu_torch.training.lora import inject_lora

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX `TrainConfig` that the ported step reads."""

    objective: str = "l1"                 # "l1" | "diffusion" | "discrete"
    learning_rate: float = 5e-4
    num_steps_before_decay: int = 100_000
    lr_decay_factor: float = 0.1          # MultiStepLR gamma (finetune.py:955-962)
    warmup_steps: int = 0
    lora_rank: int = 32
    lora_alpha: float = 16.0
    max_grad_norm: float = 0.0            # 0 = no clipping (reference default)
    use_proprio: bool = True
    use_film: bool = False
    num_diffusion_steps: int = 100
    weight_decay: float = 0.01            # torch AdamW default
    grad_accumulation_steps: int = 1
    remat_policy: str = "all"             # "all" | "dots" | "attn_out" | "none"


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
    """sqrt of the sum of squares over all tensors, in fp32 (optax.global_norm).
    A sharded (DTensor) tensor's sum is reduced across its ranks."""
    return torch.sqrt(sum(_whole(t.float().square().sum()) for t in tensors))


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _like(full: torch.Tensor, param):
    """A whole tensor placed as `param` is (its slice, for a DTensor)."""
    if not isinstance(param, DTensor) or isinstance(full, DTensor):
        return full
    return distribute(full, param.device_mesh, param.placements)


def _f32_pow(x: float, n: int) -> np.float32:
    """x ** n in fp32 by repeated squaring: what XLA computes for optax's
    `decay ** count` (a weak float to an int32 power)."""
    base, acc = np.float32(x), np.float32(1.0)
    while n:
        if n & 1:
            acc = np.float32(acc * base)
        base = np.float32(base * base)
        n >>= 1
    return acc


class Bf16AdamW:
    """`optax.adamw(lr_schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay)`
    on bf16 leaves with bf16 moments, op for op as optax writes it, each op
    rounded to bf16 and every Python constant taken as a bf16 value (JAX's
    weak types):
        mu = (1 - b1) g + b1 mu            nu = (1 - b2) g^2 + b2 nu
        u  = (mu / c1) / (sqrt(nu / c2) + eps),  c = bf16(fp32(1 - b ** count))
        u  = u + wd p;  p = p + bf16(-lr(count)) u
    Stacked (L, ...) leaves update one layer slice at a time, so the
    temporaries stay one slice large; a sharded (DTensor) leaf updates its
    local shard."""

    def __init__(self, cfg: TrainConfig, params: List[torch.Tensor]):
        self.params = params
        self.weight_decay = cfg.weight_decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0          # updates applied (optax's count)

    @staticmethod
    def _slices(t: torch.Tensor):
        return t.unbind(0) if t.ndim >= 3 else (t,)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        device = self.params[0].device

        def bf16(x) -> torch.Tensor:
            # Rounded on the host, filled on the device: no blocking copy, so
            # the host queues the update while the backward still runs.
            value = torch.tensor(float(x), dtype=torch.float32).to(torch.bfloat16).item()
            return torch.full((), value, dtype=torch.bfloat16, device=device)

        count = self.count + 1
        b1, c1 = bf16(0.9), bf16(1 - 0.9)
        b2, c2 = bf16(0.999), bf16(1 - 0.999)
        bc1 = bf16(np.float32(1) - _f32_pow(0.9, count))
        bc2 = bf16(np.float32(1) - _f32_pow(0.999, count))
        eps, wd, neg_lr = bf16(1e-8), bf16(self.weight_decay), bf16(np.float32(-lr))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            # Elementwise: a sharded leaf updates its own slice.
            p, g, mu, nu = (_local(t) for t in (p, g.to(p.dtype), mu, nu))
            for ps, gs, ms, ns in zip(*map(self._slices, (p, g, mu, nu))):
                ms.mul_(b1).add_(gs * c1)
                ns.mul_(b2).add_((gs * gs) * c2)
                u = (ms / bc1).div_((ns / bc2).sqrt_().add_(eps))
                if self.weight_decay:
                    u.add_(ps * wd)
                ps.add_(u.mul_(neg_lr))
        self.count = count

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
                copy_into(dst, src)
        self.count = state["count"]


class Optimizer:
    """The JAX chain `MultiSteps(chain(clip_by_global_norm, adamw))` over a
    fixed list of trainable tensors: torch AdamW for the fp32 ones,
    `Bf16AdamW` for the bf16 ones."""

    def __init__(self, cfg: TrainConfig, params: List[torch.Tensor]):
        self.cfg = cfg
        self.params = params
        self.schedule = schedule = lr_schedule(cfg)
        other = {p.dtype for p in params} - {torch.float32, torch.bfloat16}
        if other:
            raise TypeError(f"trainables of dtype {sorted(map(str, other))}: the optimizer "
                            "takes fp32 and bf16 leaves")
        self.fp32 = [i for i, p in enumerate(params) if p.dtype == torch.float32]
        self.bf16 = [i for i, p in enumerate(params) if p.dtype == torch.bfloat16]
        self.adamw = self.scheduler = self.low = None
        if self.fp32:
            self.adamw = torch.optim.AdamW([params[i] for i in self.fp32], lr=cfg.learning_rate,
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=cfg.weight_decay)
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.adamw, lambda count: schedule(count) / cfg.learning_rate)
        if self.bf16:
            self.low = Bf16AdamW(cfg, [params[i] for i in self.bf16])
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
        if self.low is not None:
            self.low.step([grads[i] for i in self.bf16], self.schedule(self.low.count))
        if self.adamw is not None:
            for i in self.fp32:
                self.params[i].grad = grads[i].to(self.params[i].dtype)
            self.adamw.step()
            self.scheduler.step()
            self.adamw.zero_grad(set_to_none=True)
        return True

    def state_dict(self) -> dict:
        state = {"adamw": None, "scheduler": None, "micro": self.micro, "accum": self.accum}
        if self.adamw is not None:
            state.update(adamw=self.adamw.state_dict(), scheduler=self.scheduler.state_dict())
        if self.low is not None:
            state["bf16_adamw"] = self.low.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        """Load a state whose tensors are whole (`state_dict` gathered, as
        the resume file holds it): a sharded parameter's moments and
        accumulated gradients take their slices."""
        if self.adamw is not None:
            self.adamw.load_state_dict(state["adamw"])
            self.scheduler.load_state_dict(state["scheduler"])
            for p in self.adamw.param_groups[0]["params"]:
                st = self.adamw.state[p]
                for k in ("exp_avg", "exp_avg_sq"):
                    if k in st:
                        st[k] = _like(st[k], p)
        if self.low is not None:
            self.low.load_state_dict(state["bf16_adamw"])
        self.micro = state["micro"]
        self.accum = None if state["accum"] is None else \
            [_like(a.to(p.device), p) for a, p in zip(state["accum"], self.params)]


def make_optimizer(cfg: TrainConfig, trainables: Params) -> Optimizer:
    return Optimizer(cfg, tree_leaves(trainables))


OBJECTIVES = ("l1", "diffusion", "discrete")


@dataclasses.dataclass
class TrainState:
    base_params: Params     # frozen VLA (llm + vision_backbone + projector)
    trainables: Params      # {lora, action_head, proprio_projector, ...}
    optimizer: Optimizer
    generator: torch.Generator   # the step's random draws (the JAX state's rng)
    step: int = 0           # micro-steps taken


def create_train_state(base_params: Params, trainables: Params, cfg: TrainConfig,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    """The state of a run. generator: the draws of the diffusion objective;
    None seeds one with 2 (the JAX CLI's PRNGKey(2)) on the trainables'
    device."""
    if generator is None:
        device = tree_leaves(trainables)[0].device
        generator = torch.Generator(device=device).manual_seed(2)
    return TrainState(base_params, trainables, make_optimizer(cfg, trainables), generator)


_SHADOWED = ("llm", "vision_backbone", "projector", "proprio_projector",
             "noisy_action_projector", "film")


class LastSliceOverride:
    """A stacked (L, ...) leaf whose slice L-1 is another tensor: the merged
    tree's view of a layer stack under the `llm_last_layer` trainables.
    Indexing it (`bridge.index_layer`) gives the stack's slice, or `last` at
    L-1, so the trainable slice takes the gradient and the stack is neither
    copied nor written."""

    def __init__(self, stack: torch.Tensor, last: torch.Tensor):
        if tuple(last.shape) != tuple(stack.shape[1:]):
            raise ValueError(f"last slice {tuple(last.shape)} does not fit the stack "
                             f"{tuple(stack.shape)}")
        self.stack, self.last = stack, last.to(stack.dtype)

    @property
    def shape(self):
        return self.stack.shape

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.last if i in (-1, self.stack.shape[0] - 1) else self.stack[i]


def _override_last(stack, last):
    if isinstance(stack, dict):
        return {k: _override_last(v, last[k]) for k, v in stack.items()}
    return LastSliceOverride(stack, last)


def last_layer_trainables(llm: Params) -> Params:
    """The `llm_last_layer` trainables of an LLM tree (reference
    last_layer_finetune_modules = (embed_tokens, layers[-1], lm_head),
    llm/llama2.py:101-102): copies of the last slice of every stacked layer
    leaf, of `embed` and of `lm_head`, so that the base stays as it is."""
    def copy(tree):
        return {k: copy(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else tree.detach().clone()

    def last(tree):
        return {k: last(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else tree[-1].detach().clone()

    out = {"layers": last(llm["layers"]), "embed": copy(llm["embed"])}
    if "lm_head" in llm:
        out["lm_head"] = copy(llm["lm_head"])
    return out


def _merged_params(base: Params, trainables: Params, cfg: TrainConfig) -> Params:
    """The base with LoRA injected, and the trainable subtrees in their
    places: whole modules shadow the base's, and `llm_last_layer` supplies
    the stack's slice L-1, `embed` and `lm_head` (JAX `_merged_params`)."""
    params = inject_lora(base, trainables["lora"], cfg.lora_rank, cfg.lora_alpha) \
        if "lora" in trainables else dict(base)
    for k in _SHADOWED:
        if k in trainables:
            params[k] = trainables[k]
    if "llm_last_layer" in trainables:
        t = trainables["llm_last_layer"]
        llm = dict(params["llm"])
        llm["layers"] = _override_last(llm["layers"], t["layers"])
        llm["embed"] = t["embed"]
        if "lm_head" in llm and "lm_head" in t:
            llm["lm_head"] = t["lm_head"]
        params["llm"] = llm
    return params


def _forward(params: Params, batch: Dict[str, torch.Tensor], model_cfg: OpenVLAConfig,
             platform: PlatformSpec, cfg: TrainConfig, use_flash, **kw):
    return prismatic_forward(
        params, model_cfg, platform, input_ids=batch["input_ids"],
        attention_mask=batch["attention_mask"], pixels=batch["pixel_values"],
        labels=batch["labels"], proprio=batch.get("proprio") if cfg.use_proprio else None,
        use_flash=use_flash, remat_policy=cfg.remat_policy, **kw)


def _bin_centers(device) -> torch.Tensor:
    """The 255 centres of the uniform action bins on [-1, 1], from the fp32
    values XLA gives `jnp.linspace(-1, 1, 256)` (one ulp matters here)."""
    bins = torch.from_numpy(_linspace_f32(-1.0, 1.0, N_ACTION_BINS)).to(device)
    return (bins[:-1] + bins[1:]) / 2.0


def discrete_metrics(logits: torch.Tensor, labels: torch.Tensor,
                     platform: PlatformSpec) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of the discrete objective: logits (B, S, V) fp32 and
    the multimodal labels (B, S). HF CausalLM CE: logits shifted left and
    labels right, the mean NLL over labels that are not IGNORE (the label's
    log-prob gathered, never a one-hot); token accuracy, the current and
    next actions' accuracies and the L1 of their decoded bin centres
    (reference finetune.py:363-377, train_utils.py:42-56)."""
    logits, labels = logits[:, :-1], labels[:, 1:]
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, safe[..., None])[..., 0]

    def masked_mean(x, mask):
        return (x * mask).sum() / torch.clamp(mask.sum(), min=1)

    loss = masked_mean(nll, valid)
    with torch.no_grad():
        preds = torch.argmax(logits, dim=-1)
        hit = preds == labels
        cur = get_current_action_mask(labels, platform.action_dim)
        nxt = get_next_actions_mask(labels, platform.action_dim)
        centers = _bin_centers(logits.device)

        def decode(ids):
            return centers[torch.clamp(LLAMA2_VOCAB_SIZE - ids - 1, 0, N_ACTION_BINS - 2)]

        dist = (decode(preds) - decode(labels)).abs()
        metrics = {"token_accuracy": masked_mean(hit & valid, valid),
                   "curr_action_accuracy": masked_mean(hit & cur, cur),
                   "next_actions_accuracy": masked_mean(hit & nxt, nxt),
                   "curr_action_l1_loss": masked_mean(dist, cur),
                   "next_actions_l1_loss": masked_mean(dist, nxt)}
    return loss, metrics


def loss_and_metrics(trainables: Params, base_params: Params,
                     batch: Dict[str, torch.Tensor], model_cfg: OpenVLAConfig,
                     platform: PlatformSpec, cfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     use_flash="auto") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of one batch: the differentiable loss of
    `cfg.objective` and its detached metrics, `loss` among them. The
    diffusion objective draws its noise and timesteps from `generator`."""
    if cfg.objective not in OBJECTIVES:
        raise ValueError(f"Unknown objective {cfg.objective!r}")
    trainables, base_params = compute_view(trainables), compute_view(base_params)
    params = _merged_params(base_params, trainables, cfg)
    gt = batch.get("actions")
    if cfg.objective == "discrete":
        out = _forward(params, batch, model_cfg, platform, cfg, use_flash,
                       compute_logits=True, gather_actions=False)
        loss, metrics = discrete_metrics(out.logits, out.multimodal_labels, platform)
    elif cfg.objective == "diffusion":
        if generator is None:
            raise ValueError("the diffusion objective draws from a torch.Generator")
        nd = AH.diffusion_sample_noisy_actions(
            trainables["action_head"], generator, gt, platform, llm_dim=model_cfg.llm_dim,
            num_diffusion_steps=cfg.num_diffusion_steps)
        out = _forward(params, batch, model_cfg, platform, cfg, use_flash,
                       noisy_actions=nd["noisy_actions"],
                       diffusion_t_emb=nd["diffusion_timestep_embeddings"])
        pred_noise = AH.diffusion_predict_noise(
            trainables["action_head"], out.actions_hidden.to(torch.bfloat16), platform)
        loss = (pred_noise.float() - nd["noise"].float()).square().mean()
        metrics = {}
    else:
        out = _forward(params, batch, model_cfg, platform, cfg, use_flash)
        gt = gt.float()
        pred = AH.l1_head_predict(trainables["action_head"],
                                  out.actions_hidden.to(torch.bfloat16), platform).float()
        loss = (gt - pred).abs().mean()
        with torch.no_grad():
            metrics = {"curr_action_l1_loss": (gt[:, 0] - pred[:, 0]).abs().mean(),
                       "next_actions_l1_loss": (gt[:, 1:] - pred[:, 1:]).abs().mean()}
    metrics["loss"] = loss.detach()
    return loss, metrics


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               model_cfg: OpenVLAConfig, platform: PlatformSpec, cfg: TrainConfig,
               use_flash="auto") -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One micro-step: forward, backward, and (at the end of an accumulation
    window) an optimizer update. Metrics add `grad_norm`, the global norm of
    this micro-batch's gradients."""
    leaves = state.optimizer.params
    n_data = data_ranks(leaves)
    with dtensor_context(leaves):
        loss, metrics = loss_and_metrics(state.trainables, state.base_params,
                                         batch, model_cfg, platform, cfg,
                                         state.generator, use_flash)
        # Each rank's loss is the mean over its own rows; the gradients sum
        # over the data ranks, so 1/n of each gives the global batch's mean.
        grads = torch.autograd.grad(loss / n_data if n_data > 1 else loss, leaves)
        grads = [placed_like(g, p) for g, p in zip(grads, leaves)]
        metrics = mean_over_data(metrics, leaves)
        metrics["grad_norm"] = global_norm(grads).detach()
        state.optimizer.update(grads)
    state.step += 1
    return state, metrics


def placed_like(grad, param):
    """`grad` placed as `param` is. A leaf replicated over the data axes
    gets its gradient back as a partial sum there (each rank's rows give a
    part of it, `parallel/sharding.py::compute_leaf`): this reduces it, so
    that every replica takes the same update."""
    if isinstance(grad, DTensor) and tuple(grad.placements) != tuple(param.placements):
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def data_ranks(leaves: Sequence[torch.Tensor]) -> int:
    """The ranks the batch splits over (dp x fsdp) on the mesh of the first
    sharded leaf; 1 without one."""
    for t in leaves:
        if isinstance(t, DTensor):
            shape = mesh_shape(t.device_mesh)
            return shape["dp"] * shape["fsdp"]
    return 1


def mean_over_data(metrics: Dict[str, torch.Tensor], leaves) -> Dict[str, torch.Tensor]:
    """Each metric averaged over the data ranks (an all-reduce of the stacked
    scalars); unchanged on one rank."""
    if data_ranks(leaves) == 1 or not metrics:
        return metrics
    import torch.distributed as dist

    keys = sorted(metrics)
    vals = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(vals)
    vals = vals / dist.get_world_size()
    return {k: vals[i] for i, k in enumerate(keys)}


@torch.no_grad()
def diffusion_sampling_metrics(trainables: Params, base_params: Params,
                               batch: Dict[str, torch.Tensor], model_cfg: OpenVLAConfig,
                               platform: PlatformSpec, cfg: TrainConfig,
                               generator: torch.Generator,
                               use_flash="auto") -> Dict[str, torch.Tensor]:
    """Reverse diffusion on a TRAINING batch -> the action L1 metrics
    (reference `run_diffusion_sampling`, finetune.py:454-540, run every
    `diffusion_sample_freq` steps): noise drawn from `generator`, then, for
    each t of `timesteps(num_diffusion_steps)`, the whole training-layout
    forward (ViTs included, as the JAX `lax.scan` runs it), the predicted
    noise and one DDIM step. On a mesh each data rank samples its own rows
    and the metrics are averaged over the data ranks."""
    leaves = tree_leaves(trainables)
    with dtensor_context(leaves):
        metrics = _sampling_metrics(compute_view(trainables), compute_view(base_params),
                                    batch, model_cfg, platform, cfg,
                                    generator, use_flash)
        return mean_over_data(metrics, leaves)


def _sampling_metrics(trainables, base_params, batch, model_cfg, platform, cfg,
                      generator, use_flash):
    params = _merged_params(base_params, trainables, cfg)
    gt = batch["actions"]
    b, device = gt.shape[0], gt.device
    sched = AH.diffusion_scheduler(cfg.num_diffusion_steps, device=device)
    x_t = AH.draw_noise(generator, gt.shape, device)
    for t in sched.timesteps(cfg.num_diffusion_steps):
        t_emb = AH.sinusoidal_time_encoding(
            torch.full((b,), int(t), dtype=torch.int64, device=device), model_cfg.llm_dim)
        out = _forward(params, batch, model_cfg, platform, cfg, use_flash,
                       noisy_actions=x_t, diffusion_t_emb=t_emb[:, None, :])
        eps = AH.diffusion_predict_noise(trainables["action_head"],
                                         out.actions_hidden.to(torch.bfloat16), platform)
        x_t = sched.step(eps.float(), int(t), x_t, cfg.num_diffusion_steps)
    l1 = (gt.float() - x_t).abs()
    return {"sampled_actions_l1_loss": l1.mean(),
            "curr_action_l1_loss_sampled": l1[:, 0].mean(),
            "next_actions_l1_loss_sampled": l1[:, 1:].mean()}
