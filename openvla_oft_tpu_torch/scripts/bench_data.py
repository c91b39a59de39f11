"""Training input throughput: can the episode pipeline feed the card?

Port of `vla_scripts/bench_data.py`. It synthesizes LIBERO-format episode
shards (224² JPEG frames, a wrist frame each, actions, proprio; the JAX
script's draws from `np.random.default_rng(0)` in its order; frames encoded
by `processing/jpeg_encode.py::encode_jpeg` at quality 95, the default of
the `tf.io.encode_jpeg` that the JAX script calls), writes them with
`data/rlds/pipeline.py::write_episode_tfrecords`, then measures the whole
training input path in frames/s and batches/s at the fine-tuning batch
size: the shard reader, JPEG decode and augmentation
(`make_rlds_iterator`, or with `--interleave` a 0.7 / 0.3 mixture of two
sets through `make_interleaved_iterator`), `RLDSBatchTransform` (prompt,
action labels, wrist frame, proprio), `PaddedCollatorForActionPrediction`
and `batch_iterator`, and then what the JAX script has no counterpart of,
the copy of each batch to the device that the fine-tuning CLI makes
(`data/prefetch.py::DevicePrefetcher`; `--device cpu` keeps the batches on
the host).

`--sweep` prints a frames/s line for each thread budget 1, 2, 4 and the
default (the JAX script's read / transform / decode parallelism); the
port's reader accepts `transform_parallelism` and ignores it (episodes are
parsed in the consumer's thread), which the sweep's lines say.

    python -m openvla_oft_tpu_torch.scripts.bench_data [--episodes 24]
        [--batches 40] [--batch_size 8] [--num_images {1,2,3}] [--no_aug]
        [--interleave] [--sweep] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

import numpy as np

JPEG_QUALITY = 95     # tf.io.encode_jpeg's default


def encode_frame(img: np.ndarray) -> bytes:
    from openvla_oft_tpu_torch.processing.jpeg_encode import encode_jpeg

    return encode_jpeg(img, quality=JPEG_QUALITY)


def _jpeg(rng, size: int) -> bytes:
    return encode_frame(rng.integers(0, 255, (size, size, 3), np.uint8))


def write_set(root: str, name: str, n_episodes: int, rng) -> None:
    """`n_episodes` synthetic LIBERO episodes of 30-36 steps under root/name."""
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.data.rlds.pipeline import write_episode_tfrecords

    episodes = []
    for e in range(n_episodes):
        t = 30 + (e % 7)
        episodes.append({
            "images": [_jpeg(rng, 224) for _ in range(t)],
            "wrist_images": [_jpeg(rng, 224) for _ in range(t)],
            "actions": rng.uniform(-1, 1, (t, LIBERO.action_dim)),
            "proprio": rng.standard_normal((t, LIBERO.proprio_dim)),
            "language_instruction": f"pick up the object and place it {e}",
        })
    write_episode_tfrecords(str(Path(root) / name), episodes)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--episodes", type=int, default=24)
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_images", type=int, default=2, choices=[1, 2, 3])
    ap.add_argument("--no_aug", action="store_true")
    ap.add_argument("--interleave", action="store_true",
                    help="a two-set weighted mixture instead of one stream")
    ap.add_argument("--sweep", action="store_true",
                    help="frames/s over thread budgets 1, 2, 4 and the default")
    ap.add_argument("--device", default="cuda", help="where the batches are copied")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """{"frames_per_s", "batches_per_s" (None under --sweep), "first_batch"
    (the first host batch), "sweep" ({budget: frames/s})}."""
    import torch

    from openvla_oft_tpu_torch.config import OpenVLAConfig
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.data.collator import (PaddedCollatorForActionPrediction,
                                                     batch_iterator)
    from openvla_oft_tpu_torch.data.datasets import RLDSBatchTransform
    from openvla_oft_tpu_torch.data.prefetch import DevicePrefetcher
    from openvla_oft_tpu_torch.data.rlds.pipeline import (make_interleaved_iterator,
                                                          make_rlds_iterator)
    from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor

    args = parse(argv)
    device = torch.device(args.device)
    rng = np.random.default_rng(0)
    cfg = OpenVLAConfig(vision_backbone_id="dinosiglip-vit-so-224px",
                        llm_backbone_id="llama2-7b-pure", num_images_in_input=args.num_images)
    platform = LIBERO
    out = {"frames_per_s": None, "batches_per_s": None, "first_batch": None, "sweep": {}}

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_set(root, "libero_synth_a", args.episodes, rng)
        names = ["libero_synth_a"]
        if args.interleave:
            write_set(root, "libero_synth_b", args.episodes, rng)
            names.append("libero_synth_b")
        print(f"# wrote {args.episodes * len(names)} episodes in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)

        transform = RLDSBatchTransform(PrismaticProcessor(cfg), ActionTokenizer(), platform)
        collator = PaddedCollatorForActionPrediction(pad_token_id=cfg.pad_token_id)

        def measure(dataset) -> tuple:
            """(frames/s, batches/s) of `args.batches` batches after one
            (the first shuffle fill), copied to the device."""
            def tap(batches):
                for b in batches:
                    if out["first_batch"] is None:
                        out["first_batch"] = b
                    yield b

            batches = DevicePrefetcher(tap(batch_iterator(dataset, args.batch_size, collator)),
                                       device=device)
            try:
                next(batches)
                t0 = time.perf_counter()
                n = 0
                for _ in range(args.batches):
                    b = next(batches)
                    n += b["input_ids"].shape[0]
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
            finally:
                batches.close()
            return n / dt, args.batches / dt

        if args.sweep:
            cores = os.cpu_count() or 1
            print(f"# sweep on a {cores}-core host, b={args.batch_size}, "
                  f"images={args.num_images}, aug={not args.no_aug}", flush=True)
            for par in (1, 2, 4, None):
                dataset, _ = make_rlds_iterator(
                    root, names[0], transform, platform, shuffle_buffer_size=2000,
                    image_aug=not args.no_aug, num_images=args.num_images,
                    read_parallelism=par, transform_parallelism=par, decode_parallelism=par,
                    cycle_length=max(par or 4, 2))
                fps, _ = measure(dataset)
                label = "default" if par is None else str(par)
                out["sweep"][label] = fps
                print(f"pipeline[sweep par={label:>8}]: {fps:7.1f} frames/s "
                      f"({fps / cores:.1f} frames/s/core; read and decode threads {label}, "
                      f"transform_parallelism accepted and ignored)", flush=True)
            return out

        if args.interleave:
            dataset, _ = make_interleaved_iterator(
                root, names, [0.7, 0.3], transform, platform, shuffle_buffer_size=2000,
                image_aug=not args.no_aug, num_images=args.num_images)
        else:
            dataset, _ = make_rlds_iterator(
                root, names[0], transform, platform, shuffle_buffer_size=2000,
                image_aug=not args.no_aug, num_images=args.num_images)
        fps, bps = measure(dataset)
        out["frames_per_s"], out["batches_per_s"] = fps, bps
        mode = "interleaved" if args.interleave else "single"
        print(f"pipeline[{mode}, aug={not args.no_aug}, images={args.num_images}]: "
              f"{fps:7.1f} frames/s  ({bps:.2f} batches/s at b={args.batch_size}, "
              f"to {device.type})", flush=True)
    return out


if __name__ == "__main__":
    main()
