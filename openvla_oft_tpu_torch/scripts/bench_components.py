"""Per-stage latency of the serving path on one card (LIBERO geometry).

Port of `vla_scripts/bench_components.py`. Each stage is its own
measurement (`scripts/bench_timing.py::measure`: two untimed calls, then K
queued calls and one synchronize), on the bench's zero tree
(`scripts/bench_entry.py::cheap_params`):
  - device preprocessing of 2 frames, 256 -> 224;
  - each ViT (DINOv2, SigLIP) on 2 images, and with `--vit-fused` each
    again through K4 (the ViTs' folded LN + matmuls; a bf16 tree only);
  - in bf16, the joint pair (`models/vit_joint.py`: both ViTs as one G = 2
    program), built from the per-backbone tree on the card;
  - the projector on 512 x 2,176 patch features;
  - the Llama prefill at S = 618 under the OFT mask (dense attention), the
    prefill with `out_window` (the last layer on the action rows only), and
    with `--flash` the prefill through K1 (`use_flash=True`);
  - the full `serve_action_chunk` (`bench_entry.entry`), unless
    `--skip_full`.
The vision stages run on a tree of the ViTs alone, which is freed before
the projector and the LLM are allocated, and that tree before the full
call's, so that the 13.5 GB of LLM zeros are never resident beside another
copy.

Two rows of the JAX script have no counterpart here: "scan" against
"unrolled" ViT blocks (an XLA compile choice; the port runs its blocks in
a Python loop), and the flash prefill at block_q 128 / 256
(`OPENVLA_FLASH_BLOCK_Q`; K1's plan is fixed,
`ops/flash_attention.py::_fwd_plan`).

    python -m openvla_oft_tpu_torch.scripts.bench_components [--quant int8] [--k 20]
        [--skip_full] [--flash] [--vit-fused] [--device cuda]

It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import gc

import numpy as np
import torch


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quant", default=None, choices=["int8"])
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--skip_full", action="store_true")
    ap.add_argument("--flash", action="store_true",
                    help="also time the prefill through K1 (use_flash=True)")
    ap.add_argument("--vit-fused", action="store_true",
                    help="also time each ViT through K4 (bf16 only)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None, cfg=None) -> dict:
    """{row label: ms}. cfg: the model in place of the flagship (tests pass
    a small one)."""
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.models.llama import llama_model
    from openvla_oft_tpu_torch.models.projector import vision_projector
    from openvla_oft_tpu_torch.models.vit import vit_featurize
    from openvla_oft_tpu_torch.models.vit_joint import (build_joint_vit_pair,
                                                        vit_pair_featurize_joint)
    from openvla_oft_tpu_torch.ops.vit_fused import vit_fused
    from openvla_oft_tpu_torch.processing.image_processing import device_preprocess
    from openvla_oft_tpu_torch.scripts.bench_entry import cheap_params, entry, flagship_cfg
    from openvla_oft_tpu_torch.scripts.bench_timing import measure

    args = parse(argv)
    if args.vit_fused and args.quant:
        raise SystemExit("--vit-fused needs the bf16 tree: an int8 ViT keeps its norms")
    dev = torch.device(args.device)
    cfg = flagship_cfg() if cfg is None else cfg
    platform = LIBERO
    rng = np.random.default_rng(0)
    rows = {}

    def row(label, fn, *fargs):
        rows[label] = measure(fn, fargs, args.k, label=label)[0]

    size = cfg.vision_configs[0].image_size
    frames = torch.as_tensor(rng.integers(0, 255, (2, 256, 256, 3)), dtype=torch.uint8,
                             device=dev)
    row(f"preprocess (2 frames 256->{size})", lambda f: device_preprocess(cfg, f), frames)

    # Phase 1: the ViTs alone.
    vis = cheap_params(cfg, platform, quant=args.quant, modules=("vision_backbone",),
                       device=dev)["vision_backbone"]
    imgs = torch.as_tensor(rng.normal(0, 1, (2, size, size, 3)), dtype=torch.bfloat16,
                           device=dev)
    for name, vcfg in zip(("featurizer", "fused_featurizer"), cfg.vision_configs):
        tag = f"vit {name} ({vcfg.width}x{vcfg.depth - 1})"
        row(tag, lambda p, x, vc=vcfg: vit_featurize(p, vc, x), vis[name], imgs)
        if args.vit_fused:
            def fused(p, x, vc=vcfg):
                with vit_fused(True):
                    return vit_featurize(p, vc, x)

            row(tag + " K4", fused, vis[name], imgs)
    if args.quant is None:
        # The joint tree beside the per-backbone one; the LLM is not resident.
        joint = build_joint_vit_pair(vis, cfg.vision_configs)
        # The last group's tap: the queue's last kernel, which `measure` waits for.
        row("vit JOINT pair (G=2 batched)",
            lambda j, x: vit_pair_featurize_joint(j, cfg.vision_configs, [x, x])[-1], joint,
            imgs)
        del joint
    del vis, imgs
    _free(dev)

    # Phase 2: the projector and the LLM.
    params = cheap_params(cfg, platform, quant=args.quant, modules=("projector", "llm"),
                          device=dev)
    n_patch = 2 * cfg.num_patches_per_image
    feats = torch.as_tensor(rng.normal(0, 1, (1, n_patch, cfg.vision_dim)),
                            dtype=torch.bfloat16, device=dev)
    row(f"projector ({n_patch}x{cfg.vision_dim})", vision_projector, params["projector"],
        feats)
    chunk = platform.chunk_len
    s = 48 + n_patch + 1 + chunk + 1
    embeds = torch.as_tensor(rng.normal(0, 1, (1, s, cfg.llm_dim)), dtype=torch.bfloat16,
                             device=dev)
    bidir = torch.zeros((1, s), dtype=torch.bool, device=dev)
    bidir[:, -(chunk + 1):] = True
    llm = cfg.llm
    row(f"llama prefill (S={s})", lambda p, e: llama_model(p, llm, e, bidir_mask=bidir),
        params["llm"], embeds)
    row(f"llama prefill out_window (S={s})",
        lambda p, e: llama_model(p, llm, e, bidir_mask=bidir,
                                 out_window=(s - chunk - 1, chunk)), params["llm"], embeds)
    if args.flash:
        row(f"llama prefill FLASH K1 (S={s})",
            lambda p, e: llama_model(p, llm, e, bidir_mask=bidir, use_flash=True),
            params["llm"], embeds)
    del params, embeds, feats
    _free(dev)

    if not args.skip_full:
        fn, fargs = entry(quant=args.quant, device=dev, cfg=cfg)
        row("FULL serve_action_chunk", fn, *fargs)
        del fn, fargs
        _free(dev)
    return rows


if __name__ == "__main__":
    main()
