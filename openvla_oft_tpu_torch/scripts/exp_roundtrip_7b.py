"""The checkpoint converter's round trip at the flagship's full size: the
port's copy of `vla_scripts/exp_roundtrip_7b.py`.

  1. Draw the OpenVLA-7B-OFT tree on the device from an explicit
     `torch.Generator`: the backbone and the projector in bf16, the L1
     action head and the proprio projector in fp32, no lm_head on the
     device (the OFT L1 path never reads it); an lm_head drawn on the host
     (bf16) joins the exported tree, as in the released checkpoints.
  2. Run `predict_action_hidden` and the L1 head on a fixed input (K1 on
     the card) for the action chunk.
  3. Export: `utils/hf_import.py::export_openvla_checkpoint`
     (`model.safetensors` + `config.json`, one tensor on the host at a
     time) and `training/checkpoint.py::export_module_pt` (the
     `{name}--150000_checkpoint.pt` heads of the released checkpoints).
  4. Free the tree, then re-import: `load_openvla_checkpoint` onto the
     device, `import_action_head_pt`, `import_projector_pt`.
  5. Every leaf bitwise equal (dtype, shape and bytes) to the tree drawn
     again from the same generators, one group on the device beside the
     loaded tree at a time (no host copy of either tree), and the action
     chunk of the loaded tree bitwise equal to the first one.

    python -m openvla_oft_tpu_torch.scripts.exp_roundtrip_7b [--scale tiny|7b]
        [--out DIR] [--keep] [--no_forward] [--device cuda|cpu]

It runs on the card unless `--device cpu`. `--no_forward` skips steps 2 and
5's chunk. Returns (and prints) the bytes written, the write and load
seconds, the load's GB/s and the host's peak resident set.
"""

from __future__ import annotations

import argparse
import gc
import os
import resource
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import torch

STEP = 150000                  # the released LIBERO checkpoints' step
SEED, LM_HEAD_SEED, PIXEL_SEED = 11, 17, 3


def config(scale: str):
    from openvla_oft_tpu_torch import config as C

    if scale == "tiny":
        C._VISION_REGISTRY.setdefault("tiny-dual", (C.TINY_DINOV2, C.TINY_SIGLIP))
        C._LLM_REGISTRY.setdefault("tiny-llama", C.TINY_LLAMA)
        return C.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                               num_images_in_input=2)
    return C.OpenVLAConfig(vision_backbone_id="dinosiglip-vit-so-224px",
                           llm_backbone_id="llama2-7b-pure", num_images_in_input=2)


def draw_tree(cfg, platform, device) -> Dict:
    """The drill's tree: bf16 backbone and projector, fp32 heads."""
    from openvla_oft_tpu_torch.bridge import init_params

    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(cfg, platform, gen, device=device, dtype=torch.bfloat16,
                         head_dtype=torch.float32, head="l1")
    params["projector"] = {k: {n: t.to(torch.bfloat16) for n, t in v.items()}
                           for k, v in params["projector"].items()}
    return params


def draw_lm_head(cfg) -> Dict:
    """The host lm_head (bf16), the released checkpoints' (hidden, vocab)."""
    gen = torch.Generator().manual_seed(LM_HEAD_SEED)
    return {"kernel": (torch.randn((cfg.llm.hidden_size, cfg.llm.vocab_size), generator=gen)
                       * 0.02).to(torch.bfloat16)}


def fixed_inputs(cfg, platform, device):
    """The drill's prompt (48 tokens, the last 24 real), pixels and proprio."""
    ids = torch.zeros((1, 48), dtype=torch.int64)
    ids[0, -24:] = torch.tensor([1] + [100] * 22 + [29871])
    mask = torch.zeros((1, 48), dtype=torch.int64)
    mask[0, -24:] = 1
    h = cfg.vision_configs[0].image_size
    gen = torch.Generator().manual_seed(PIXEL_SEED)
    pixels = torch.randn((1, cfg.num_images_in_input, 2, h, h, 3), generator=gen)
    proprio = torch.linspace(-0.5, 0.5, platform.proprio_dim)[None]
    return (ids.to(device), mask.to(device), pixels.to(torch.bfloat16).to(device),
            proprio.to(device))


def action_chunk(params, cfg, platform, inputs) -> torch.Tensor:
    from openvla_oft_tpu_torch.models.action_heads import l1_head_predict
    from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden

    ids, mask, pixels, proprio = inputs
    with torch.inference_mode():
        hidden = predict_action_hidden(params, cfg, platform, ids, mask, pixels,
                                       proprio=proprio).actions_hidden
        return l1_head_predict(params["action_head"], hidden.float(), platform)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def leaves_bitwise_equal(want, got, label: str) -> int:
    """Every leaf of `want` and `got` equal in dtype, shape and bytes (on
    `got`'s device); returns the bytes compared."""
    a, b = dict(_leaves(want)), dict(_leaves(got))
    if a.keys() != b.keys():
        raise AssertionError(f"{label}: tree keys differ: only drawn "
                             f"{sorted(a.keys() - b.keys())[:5]}, only loaded "
                             f"{sorted(b.keys() - a.keys())[:5]}")
    n = 0
    for key, x in a.items():
        y = b[key]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{label}{key}: {x.dtype} {tuple(x.shape)} drawn, "
                                 f"{y.dtype} {tuple(y.shape)} loaded")
        x = x.to(y.device).contiguous()
        y = y.contiguous()
        if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            raise AssertionError(f"{label}{key}: the loaded leaf's bytes differ")
        n += y.numel() * y.element_size()
    return n


def peak_rss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run(scale: str = "7b", out: Optional[str] = None, keep: bool = False,
        no_forward: bool = False, device: str = "cuda") -> Dict:
    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.training.checkpoint import (export_module_pt,
                                                           find_checkpoint_file,
                                                           import_action_head_pt,
                                                           import_projector_pt)
    from openvla_oft_tpu_torch.utils.hf_import import (export_openvla_checkpoint,
                                                       load_openvla_checkpoint)

    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    cfg, platform = config(scale), get_platform("libero")
    out = out or os.path.join(tempfile.gettempdir(), "roundtrip_7b")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    result: Dict = {"scale": scale, "device": str(device)}
    try:
        # 1-2. the tree on the device, the forward
        t0 = time.perf_counter()
        params = draw_tree(cfg, platform, device)
        inputs = fixed_inputs(cfg, platform, device)
        chunk = None if no_forward else action_chunk(params, cfg, platform, inputs).clone()
        sync()
        print(f"[roundtrip] init{'' if no_forward else ' + forward'}: "
              f"{time.perf_counter() - t0:.1f} s"
              + ("" if chunk is None else f", actions {tuple(chunk.shape)} mean "
                 f"{float(chunk.float().mean()):+.6f}"))

        # 3. export
        t0 = time.perf_counter()
        core = {"llm": {**params["llm"], "lm_head": draw_lm_head(cfg)},
                "projector": params["projector"], "vision_backbone": params["vision_backbone"]}
        export_openvla_checkpoint(cfg, core, out, norm_stats={"libero_synth": {}})
        export_module_pt(params["action_head"], "action_head", out, STEP)
        export_module_pt(params["proprio_projector"], "proprio_projector", out, STEP)
        os.sync()
        result["write_s"] = time.perf_counter() - t0
        result["bytes"] = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        print(f"[roundtrip] export: {result['write_s']:.1f} s, {result['bytes']:,} B "
              f"({sorted(os.listdir(out))})")

        # 4. free the tree, re-import
        del params, core
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _, loaded, norm_stats = load_openvla_checkpoint(out, dtype=torch.bfloat16,
                                                        device=device, head=None)
        loaded["action_head"] = import_action_head_pt(
            find_checkpoint_file(out, "action_head"), head="l1", device=device)
        loaded["proprio_projector"] = import_projector_pt(
            find_checkpoint_file(out, "proprio_projector"), device=device)
        sync()
        result["load_s"] = time.perf_counter() - t0
        result["load_gbps"] = result["bytes"] / result["load_s"] / 1e9
        if "libero_synth" not in (norm_stats or {}):
            raise AssertionError("norm_stats lost in the round trip")
        print(f"[roundtrip] re-import: {result['load_s']:.1f} s, {result['load_gbps']:.2f} GB/s "
              f"(the files just written: likely from the page cache)")

        # 5. bitwise: each group drawn again beside the loaded tree
        t0 = time.perf_counter()
        drawn = draw_tree(cfg, platform, device)
        n = 0
        for group in ("vision_backbone", "projector", "action_head", "proprio_projector"):
            n += leaves_bitwise_equal(drawn.pop(group), loaded[group], group)
        lm_head = loaded["llm"].pop("lm_head")
        n += leaves_bitwise_equal(drawn.pop("llm"), loaded["llm"], "llm")
        n += leaves_bitwise_equal(draw_lm_head(cfg), lm_head, "llm/lm_head")
        del drawn, lm_head
        gc.collect()
        result["leaf_bytes"] = n
        print(f"[roundtrip] bitwise identity: OK over {n:,} B of leaves "
              f"({time.perf_counter() - t0:.1f} s)")
        if chunk is not None:
            again = action_chunk(loaded, cfg, platform, inputs)
            if again.dtype != chunk.dtype or not torch.equal(again, chunk):
                raise AssertionError(f"the action chunk changed in the round trip: max|d| "
                                     f"{(again.float() - chunk.float()).abs().max().item()}")
            print(f"[roundtrip] action chunk: bitwise equal ({chunk.numel()} values)")
            result["chunk"] = again.float().cpu()
        del loaded
    finally:
        if not keep:
            shutil.rmtree(out, ignore_errors=True)
    result["peak_rss"] = peak_rss_bytes()
    print(f"[roundtrip] OK scale={scale}; host peak resident set "
          f"{result['peak_rss'] / 2**30:.2f} GiB")
    return result


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", default="7b", choices=["tiny", "7b"])
    ap.add_argument("--out", default=None, help="the checkpoint dir (a temporary one by "
                                                "default)")
    ap.add_argument("--keep", action="store_true", help="keep the exported checkpoint dir")
    ap.add_argument("--no_forward", action="store_true",
                    help="skip the action chunk (the leaves' bitwise identity stands)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return run(a.scale, a.out, a.keep, a.no_forward, a.device)


if __name__ == "__main__":
    main()
