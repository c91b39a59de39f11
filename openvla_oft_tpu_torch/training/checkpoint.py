"""Training checkpoints as torch state dicts, and the reference's per-module `.pt` files.

The counterpart of `openvla_oft_tpu/training/checkpoint.py`: where the JAX
package writes Orbax steps, the port writes one `torch.save` file per
gradient step, `{ckpt_dir}/{step:06d}.pt`, holding the trainables and the
optimizer's state dict. A save takes a host snapshot of the state first (a
device-to-host copy into pinned host tensors, synchronized), so that the next
step may update the state in place; the file is then written under a
temporary name, on a background thread with `block=False` (Orbax's async
save), and renamed when complete. `wait_for_checkpoints()` waits for the
writes in flight and re-raises a write's error; restore and prune wait
first. A checkpoint holds every trainable group the run has (LoRA, the
action head, the proprio and noisy-action projectors, FiLM).

The reference's per-module fine-tune files `{name}--{label}_checkpoint.pt`
(action heads, projectors, the FiLMed vision backbone) are read by the
importers and written by the exporters (`export_module_pt`,
`export_film_vision_backbone_pt`): plain state dicts with the reference's
key names and fp32 (out, in) weights on the host.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from openvla_oft_tpu_torch.models.vision_backbone import featurizer_names
from openvla_oft_tpu_torch.utils.weights import (dict_getter, port_fc_mlp, port_mlp_resnet,
                                                 port_timm_vit, strip_ddp_prefix)

Params = Dict[str, Any]

_STEP_FILE = re.compile(r"^(\d{6,})\.pt$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{step:06d}.pt")


def _tensors(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def host_snapshot(tree):
    """A copy of `tree` (nested dicts, lists and tuples) whose tensors live
    on the host and share nothing with the originals: CUDA tensors copied
    into pinned host tensors and synchronized, host tensors cloned. Other
    leaves are kept."""
    cuda_devices = set()

    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(copy(v) for v in node)
        if not isinstance(node, torch.Tensor):
            return node
        node = node.detach()
        if not node.is_cuda:
            return node.clone()
        cuda_devices.add(node.device)
        out = torch.empty(node.shape, dtype=node.dtype, pin_memory=True)
        out.copy_(node, non_blocking=True)
        return out

    snap = copy(tree)
    for device in cuda_devices:
        torch.cuda.synchronize(device)
    return snap


def _write(state: Dict[str, Any], path: str, record: dict) -> str:
    t0 = time.perf_counter()
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    record["write_s"] = time.perf_counter() - t0
    return path


_WRITER: Optional[concurrent.futures.ThreadPoolExecutor] = None
_PENDING: List[concurrent.futures.Future] = []
# The last saves' records, on the host clock: {"path", "bytes" (the
# snapshot's tensors), "snapshot_s" (the device-to-host copy, synchronized),
# "write_s" (the file, set when written)}.
SAVE_LOG: collections.deque = collections.deque(maxlen=64)


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any],
                    block: bool = True) -> str:
    """Write `state` (e.g. {"trainables": ..., "optimizer": ...}) for `step`;
    returns the file's path. The state is snapshotted to the host before
    this returns (`host_snapshot`), so the caller may go on updating it. The
    file appears under its final name only once complete. block=False
    writes it on a background thread (one at a time, in order of the
    saves); call `wait_for_checkpoints()` before reading the files, pruning
    them, or exiting."""
    global _WRITER
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    t0 = time.perf_counter()
    snap = host_snapshot(state)
    record = {"path": path, "snapshot_s": time.perf_counter() - t0,
              "bytes": sum(t.numel() * t.element_size() for t in _tensors(snap))}
    SAVE_LOG.append(record)
    if block:
        return _write(snap, path, record)
    if _WRITER is None:
        _WRITER = concurrent.futures.ThreadPoolExecutor(max_workers=1,
                                                        thread_name_prefix="ckpt-writer")
    _PENDING.append(_WRITER.submit(_write, snap, path, record))
    return path


def wait_for_checkpoints() -> None:
    """Block until every `save_checkpoint(block=False)` has written its file;
    a write that failed raises here (the others are still waited for)."""
    errors = []
    while _PENDING:
        try:
            _PENDING.pop(0).result()
        except Exception as e:          # noqa: BLE001 - re-raised below
            errors.append(e)
    if errors:
        raise errors[0]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       map_location=None) -> Dict[str, Any]:
    """Read the state saved for `step` (the latest one when None), after
    the writes in flight."""
    wait_for_checkpoints()
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return torch.load(checkpoint_path(ckpt_dir, step), map_location=map_location,
                      weights_only=True)


def prune_old_steps(ckpt_dir: str) -> None:
    """Delete every step file but the newest (`--save_latest_checkpoint_only`),
    after the writes in flight. Steps are compared as integers, and only
    complete files (`{step:06d}.pt`) count: a temporary file left by a
    killed write is neither kept as the newest nor touched."""
    wait_for_checkpoints()
    steps = sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(ckpt_dir)) if m)
    for step in steps[:-1]:
        os.remove(checkpoint_path(ckpt_dir, step))


# === The reference's per-module `.pt` files ===
def load_module_pt(path: str) -> Dict[str, torch.Tensor]:
    """A `{name}--{step}_checkpoint.pt` state dict on the CPU, its DDP prefix
    stripped (reference loading at openvla_utils.py:201-250)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return strip_ddp_prefix(sd)


def find_checkpoint_file(pretrained_dir: str, file_pattern: str) -> str:
    """Reference `find_checkpoint_file` (openvla_utils.py:436-460): the one
    file in the dir whose name contains `file_pattern`."""
    matches = [f for f in os.listdir(pretrained_dir) if file_pattern in f
               and os.path.isfile(os.path.join(pretrained_dir, f))]
    if len(matches) != 1:
        raise FileNotFoundError(f"expected exactly 1 '{file_pattern}' checkpoint in "
                                f"{pretrained_dir}, found {len(matches)}")
    return os.path.join(pretrained_dir, matches[0])


def import_action_head_pt(path: str, head: str = "l1", dtype: Optional[torch.dtype] = None,
                          device="cpu") -> Params:
    """An L1 or diffusion action-head `.pt` -> the tree (in `dtype`, None:
    as stored)."""
    get = dict_getter(load_module_pt(path))
    if head == "l1":
        return {"model": port_mlp_resnet(get, "model.", dtype=dtype, device=device)}
    if head == "diffusion":
        return {"noise_predictor": port_mlp_resnet(get, "noise_predictor.mlp_resnet.",
                                                   dtype=dtype, device=device)}
    raise ValueError(f"head must be 'l1' or 'diffusion', got {head!r}")


def import_projector_pt(path: str, kind: str = "proprio", dtype: Optional[torch.dtype] = None,
                        device="cpu") -> Params:
    """A proprio or noisy-action projector `.pt` (fc1, fc2) -> the tree."""
    if kind not in ("proprio", "noisy_action"):
        raise ValueError(f"kind must be 'proprio' or 'noisy_action', got {kind!r}")
    return port_fc_mlp(dict_getter(load_module_pt(path)), ("fc1", "fc2"), dtype=dtype,
                       device=device)


def import_film_vision_backbone_pt(path: str, cfg, dtype: Optional[torch.dtype] = torch.float32,
                                   device="cpu") -> Tuple[Params, Params]:
    """A reference `vision_backbone--{step}_checkpoint.pt` saved from
    `FiLMedPrismaticVisionBackbone` (openvla_utils.py:311-349 loads it) ->
    (vision_backbone params, film params). The timm parameters live under
    `vision_backbone.<featurizer>.blocks.{i}.block.*`, the FiLM projectors
    under `...blocks.{i}.{scale,shift}.*`; linears wrapped by peft LoRA
    (`<module>.base_layer.weight` with `lora_A` / `lora_B.default.weight`,
    the reference applies LoRA before the FiLM wrap, finetune.py:862-884)
    are merged, W + min(r, 16) / r * B @ A in fp32. cfg: OpenVLAConfig."""
    get = dict_getter(load_module_pt(path))
    backbone: Params = {}
    film: Params = {}
    for name, vcfg in zip(featurizer_names(cfg), cfg.vision_configs):
        prefix = f"vision_backbone.{name}."

        def resolve(cand: str) -> torch.Tensor:
            try:
                return get(cand)
            except KeyError:
                pass
            if cand.endswith(".weight"):
                stem = cand[: -len(".weight")]
                w = get(f"{stem}.base_layer.weight").float()
                try:
                    a = get(f"{stem}.lora_A.default.weight").float()
                    b = get(f"{stem}.lora_B.default.weight").float()
                    r = a.shape[0]
                    w = w + (min(r, 16) / r) * (b @ a)
                except KeyError:
                    pass
                return w
            if cand.endswith(".bias"):
                return get(f"{cand[: -len('.bias')]}.base_layer.bias")
            raise KeyError(cand)

        def film_get(key: str, _prefix=prefix) -> torch.Tensor:
            if key.startswith(_prefix + "blocks."):
                idx, sub = key[len(_prefix + "blocks."):].split(".", 1)
                try:
                    return resolve(f"{_prefix}blocks.{idx}.block.{sub}")
                except KeyError:
                    pass                      # the plain (un-FiLM-wrapped) layout
            return resolve(key)

        backbone[name] = port_timm_vit(film_get, vcfg, prefix=prefix, dtype=dtype,
                                       device=device)
        film[name] = {
            proj: {"kernel": torch.stack([get(f"{prefix}blocks.{i}.{proj}.weight").T
                                          for i in range(vcfg.depth)]).to(device, dtype),
                   "bias": torch.stack([get(f"{prefix}blocks.{i}.{proj}.bias")
                                        for i in range(vcfg.depth)]).to(device, dtype)}
            for proj in ("scale", "shift")}
    return backbone, film


# === The reference's per-module `.pt` files: the exporters ===
def _host_f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).contiguous()


def _export_linear(sd: dict, name: str, p: Params) -> None:
    sd[f"{name}.weight"] = _host_f32(p["kernel"].T)
    if "bias" in p:
        sd[f"{name}.bias"] = _host_f32(p["bias"])


def _export_layer_norm(sd: dict, name: str, p: Params) -> None:
    sd[f"{name}.weight"] = _host_f32(p["scale"])
    sd[f"{name}.bias"] = _host_f32(p["bias"])


def _export_mlp_resnet(sd: dict, prefix: str, p: Params) -> None:
    _export_layer_norm(sd, prefix + "layer_norm1", p["ln_in"])
    _export_linear(sd, prefix + "fc1", p["fc_in"])
    for i, blk in enumerate(p["blocks"]):
        _export_layer_norm(sd, f"{prefix}mlp_resnet_blocks.{i}.ffn.0", blk["ln"])
        _export_linear(sd, f"{prefix}mlp_resnet_blocks.{i}.ffn.1", blk["fc"])
    _export_layer_norm(sd, prefix + "layer_norm2", p["ln_out"])
    _export_linear(sd, prefix + "fc2", p["fc_out"])


def export_module_pt(module_params: Params, module_name: str, run_dir: str, step) -> str:
    """Write `{run_dir}/{module_name}--{step}_checkpoint.pt` (step: a number
    or "latest"), the reference's layout (finetune.py:614-656): the L1 or
    diffusion action head, or the proprio or noisy-action projector, as a
    state dict the reference's eval utils and `import_action_head_pt` /
    `import_projector_pt` read."""
    sd: dict = {}
    if module_name == "action_head":
        if "model" in module_params:                    # L1 head
            _export_mlp_resnet(sd, "model.", module_params["model"])
        else:                                           # diffusion head
            _export_mlp_resnet(sd, "noise_predictor.mlp_resnet.",
                               module_params["noise_predictor"])
    elif module_name in ("proprio_projector", "noisy_action_projector"):
        _export_linear(sd, "fc1", module_params["fc1"])
        _export_linear(sd, "fc2", module_params["fc2"])
    else:
        raise ValueError(f"unknown module {module_name!r}")
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"{module_name}--{step}_checkpoint.pt")
    torch.save(sd, path)
    return path


def export_film_vision_backbone_pt(backbone: Params, film: Params, cfg, run_dir: str,
                                   step) -> str:
    """The inverse of `import_film_vision_backbone_pt`: the FiLMed vision
    backbone as the reference's `vision_backbone--{step}_checkpoint.pt`,
    the timm parameters under `vision_backbone.<featurizer>.blocks.{i}.block.*`
    and the FiLM projectors under `...blocks.{i}.{scale,shift}.*`. Written
    one tensor at a time to the host in fp32. cfg: OpenVLAConfig."""
    sd: dict = {}
    for name, vcfg in zip(featurizer_names(cfg), cfg.vision_configs):
        vp = backbone[name]
        pre = f"vision_backbone.{name}."
        k = vp["patch_embed"]["kernel"]                              # (p*p*3, D)
        sd[pre + "patch_embed.proj.weight"] = _host_f32(
            k.reshape(vcfg.patch_size, vcfg.patch_size, 3, k.shape[1]).permute(3, 2, 0, 1))
        sd[pre + "patch_embed.proj.bias"] = _host_f32(vp["patch_embed"]["bias"])
        sd[pre + "pos_embed"] = _host_f32(vp["pos_embed"][None])
        for tok in ("cls_token", "reg_token"):
            if tok in vp:
                sd[pre + tok] = _host_f32(vp[tok][None])
        lay = vp["layers"]
        fmt_map = {
            "blocks.{i}.block.norm1.weight": (lay["norm1"]["scale"], False),
            "blocks.{i}.block.norm1.bias": (lay["norm1"]["bias"], False),
            "blocks.{i}.block.norm2.weight": (lay["norm2"]["scale"], False),
            "blocks.{i}.block.norm2.bias": (lay["norm2"]["bias"], False),
        }
        for mod, sub in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
            fmt_map[f"blocks.{{i}}.block.{mod}.{sub}.weight"] = (lay[mod][sub]["kernel"], True)
            fmt_map[f"blocks.{{i}}.block.{mod}.{sub}.bias"] = (lay[mod][sub]["bias"], False)
        if "ls1" in lay:
            fmt_map["blocks.{i}.block.ls1.scale_factor"] = (lay["ls1"]["scale_factor"], False)
            fmt_map["blocks.{i}.block.ls2.scale_factor"] = (lay["ls2"]["scale_factor"], False)
        for fmt, (arr, transpose) in fmt_map.items():
            for i in range(vcfg.depth):
                sd[pre + fmt.format(i=i)] = _host_f32(arr[i].T if transpose else arr[i])
        for i in range(vcfg.depth):
            for proj in ("scale", "shift"):
                sd[f"{pre}blocks.{i}.{proj}.weight"] = _host_f32(
                    film[name][proj]["kernel"][i].T)
                sd[f"{pre}blocks.{i}.{proj}.bias"] = _host_f32(film[name][proj]["bias"][i])
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"vision_backbone--{step}_checkpoint.pt")
    torch.save(sd, path)
    return path
