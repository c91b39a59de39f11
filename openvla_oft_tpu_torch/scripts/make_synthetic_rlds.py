"""Write a synthetic but learnable episode set in the native TFRecord
format, without PIL or TF: the port's copy of `vla_scripts/make_synthetic_rlds.py`.

With the same arguments on the same host its shard files and
`native_format.json` are byte for byte the JAX script's: the same numpy
draws, frames encoded by `processing/jpeg_encode.py::encode_jpeg` (the host
library; PIL's bytes at quality 90) and written by
`data/rlds/pipeline.py::write_episode_tfrecords`. Across hosts the frames
stay bitwise, but the actions' float32 `np.sin` moves by 1 ULP on some
inputs between NumPy versions (2.0 and 2.1 and later), and the proprio with
them; `set_summary` and `compare_to_golden` hold a set to a recorded one
on those terms.

K tasks; task k fixes the instruction, the image (a task colour, a square
whose position encodes the step's phase, pixel noise), the action
trajectory (per-dimension sinusoids plus noise, a binary gripper schedule)
and the proprio (the actions integrated), so that the L1 loss has signal.

    python -m openvla_oft_tpu_torch.scripts.make_synthetic_rlds \\
        --out datasets/synth_rlds --name libero_synth_l1 \\
        --episodes 48 --steps 64 --tasks 8 --image-size 256
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
from pathlib import Path
from typing import List, Optional

import numpy as np

OBJECTS = ["black bowl", "red block", "blue mug", "green plate",
           "yellow cup", "white box", "purple ball", "orange spoon"]
TARGETS = ["plate", "basket", "tray", "shelf", "drawer", "stove",
           "rack", "bin"]


def encode_frame(arr: np.ndarray) -> bytes:
    """PIL's JPEG bytes of the frame at quality 90."""
    from openvla_oft_tpu_torch.processing.jpeg_encode import encode_jpeg

    return encode_jpeg(arr, 90)


def task_image(rng, k: int, t: int, T: int, size: int, n_tasks: int) -> np.ndarray:
    """Task-coloured background + a step-phase-encoding square + noise."""
    hue = np.array([(k * 97) % 256, (k * 57 + 60) % 256, (k * 31 + 120) % 256],
                   np.float32)
    img = np.broadcast_to(hue, (size, size, 3)).copy()
    # the square sweeps across the image over the episode, so the step's
    # phase (and with it each step's action) is observable
    frac = t / max(T - 1, 1)
    cx = int((0.15 + 0.7 * frac) * size)
    cy = int((0.25 + 0.5 * (k / max(n_tasks - 1, 1))) * size)
    s = size // 8
    img[max(cy - s, 0):cy + s, max(cx - s, 0):cx + s] = 255.0 - hue
    img += rng.normal(0, 8.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def task_actions(rng, k: int, T: int, action_dim: int, noise: float) -> np.ndarray:
    """Per-task sinusoids in [-0.85, 0.85] + iid noise; the gripper (last
    dimension) a task-dependent binary schedule, as in LIBERO's data."""
    t = np.arange(T, dtype=np.float32)[:, None]
    dim = np.arange(action_dim, dtype=np.float32)[None, :]
    amp = 0.3 + 0.5 * ((k * 13 + dim * 7) % 8) / 8.0
    freq = 2 * np.pi * (1.0 + ((k * 5 + dim * 3) % 4)) / T
    phase = 2 * np.pi * ((k * 11 + dim * 17) % 16) / 16.0
    acts = (amp * np.sin(freq * t + phase)).astype(np.float32)
    acts[:, -1] = ((t[:, 0] / T + k / 8.0) % 1.0 > 0.5).astype(np.float32)
    acts[:, :-1] += rng.normal(0, noise, (T, action_dim - 1)).astype(np.float32)
    return acts


def generate(out: str, name: str, episodes: int, steps: int, tasks: int,
             image_size: int, action_dim: int = 7, proprio_dim: int = 8,
             noise: float = 0.02, seed: int = 0, wrist: bool = False,
             shard_size: int = 64) -> str:
    """Write the set to `out/name`; returns that directory."""
    from openvla_oft_tpu_torch.data.rlds.pipeline import write_episode_tfrecords

    rng = np.random.default_rng(seed)
    eps = []
    for e in range(episodes):
        k = e % tasks
        T = steps + int(rng.integers(0, 8))  # episode lengths vary a little
        acts = task_actions(rng, k, T, action_dim, noise)
        proprio = np.zeros((T, proprio_dim), np.float32)
        proprio[:, :action_dim] = np.cumsum(acts, 0) * 0.05
        proprio[:, action_dim:] = acts[:, -1:]  # the gripper state mirrored
        images = [encode_frame(task_image(rng, k, t, T, image_size, tasks)) for t in range(T)]
        ep = {
            "images": images,
            "actions": acts,
            "proprio": proprio,
            "language_instruction":
                f"pick up the {OBJECTS[k % len(OBJECTS)]} and place it on "
                f"the {TARGETS[k % len(TARGETS)]}",
        }
        if wrist:
            ep["wrist_images"] = [
                encode_frame(task_image(rng, (k + 3) % tasks, t, T, image_size, tasks))
                for t in range(T)]
        eps.append(ep)
    out_dir = str(Path(out) / name)
    write_episode_tfrecords(out_dir, eps, shard_size=shard_size)
    # marked as standardized, so the pipeline's "auto" hook skips the OXE
    # registry even where the name collides with a registered one
    with open(Path(out_dir) / "native_format.json", "w") as f:
        json.dump({"standardized": True, "synthetic": True,
                   "episodes": episodes, "tasks": tasks}, f)
    print(f"[make_synthetic_rlds] wrote {episodes} episodes "
          f"({tasks} tasks, ~{steps} steps, {image_size}px) -> {out_dir}")
    return out_dir


def set_digest(set_dir: str, canonical: bool = False) -> str:
    """SHA-256 over the set's files in name order (each name, a 0 byte, the
    file's bytes). With `canonical`, each `.tfrecord` shard counts as the
    port's writer would frame its records, every record re-serialized with
    its features in name order (`data/rlds/tfrecord.py::serialize_example`):
    TF's protobuf writes a `Features` map in an order seeded anew in every
    process, so two runs of the JAX script agree on each record's features
    but not on their order in its bytes. The port's shards are canonical,
    so both digests of its set agree."""
    from openvla_oft_tpu_torch.data.rlds.tfrecord import (crc32c, masked_crc, parse_example,
                                                          read_tfrecords, serialize_example)

    h = hashlib.sha256()
    for name in sorted(os.listdir(set_dir)):
        path = os.path.join(set_dir, name)
        h.update(name.encode() + b"\0")
        if canonical and name.endswith(".tfrecord"):
            for record in read_tfrecords(path):
                data = serialize_example(parse_example(record))
                head = struct.pack("<Q", len(data))
                h.update(head + struct.pack("<I", masked_crc(crc32c(head))) + data
                         + struct.pack("<I", masked_crc(crc32c(data))))
        else:
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


ACTION_KEY, PROPRIO_KEY = "steps/action", "steps/observation/proprio"


def set_summary(set_dir: str) -> dict:
    """The set split for a comparison across hosts: `frames_sha256` over
    every JPEG frame (record order, each length-prefixed), `other_sha256`
    over everything else but the float values (file names, every record's
    feature names and kinds, the floats' counts, the instructions,
    `native_format.json`), the `actions` (steps, 7) and `proprio` (steps, 8)
    float32 arrays, episodes concatenated, and each episode's `lengths`."""
    from openvla_oft_tpu_torch.data.rlds.tfrecord import parse_example, read_tfrecords

    frames, other = hashlib.sha256(), hashlib.sha256()
    floats = {ACTION_KEY: [], PROPRIO_KEY: []}
    for name in sorted(os.listdir(set_dir)):
        path = os.path.join(set_dir, name)
        other.update(name.encode() + b"\0")
        if not name.endswith(".tfrecord"):
            with open(path, "rb") as f:
                other.update(f.read())
            continue
        for record in read_tfrecords(path):
            ex = parse_example(record)
            for key in sorted(ex):
                kind, values = ex[key]
                other.update(key.encode() + b"\0" + kind.encode() + b"\0")
                if kind == "float":
                    arr = np.asarray(values, np.float32)
                    other.update(struct.pack("<Q", arr.size))
                    floats[key].append(arr)
                    continue
                sink = frames if "image" in key else other
                for v in values:
                    sink.update(struct.pack("<Q", len(v)) + bytes(v))
    return {"frames_sha256": frames.hexdigest(), "other_sha256": other.hexdigest(),
            "lengths": np.array([a.size // 7 for a in floats[ACTION_KEY]]),
            "actions": np.concatenate(floats[ACTION_KEY]).reshape(-1, 7),
            "proprio": np.concatenate(floats[PROPRIO_KEY]).reshape(-1, 8)}


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 distance in units in the last place."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(2**31) - i, i)

    return np.abs(ordered(a) - ordered(b))


def compare_to_golden(summary: dict, golden: dict) -> dict:
    """Holds a `set_summary` to a recorded one: the frames and everything
    but the floats bitwise, every action within 1 ULP (NumPy's float32 sine
    differs by that much between versions), and the proprio bitwise what
    the script makes of these actions (their running sum times 0.05, the
    gripper mirrored). Raises AssertionError; returns the actions' count of
    values that differ and their largest distance in ULP."""
    for key in ("frames_sha256", "other_sha256"):
        if summary[key] != str(golden[key]):
            raise AssertionError(f"the set's {key} {summary[key]} is not the golden's "
                                 f"{golden[key]}")
    acts, want = summary["actions"], np.asarray(golden["actions"])
    if acts.shape != want.shape:
        raise AssertionError(f"actions of shape {acts.shape}, the golden's {want.shape}")
    d = ulps(acts, want)
    if d.max(initial=0) > 1:
        raise AssertionError(f"{int((d > 1).sum())} actions differ from the golden's by more "
                             f"than 1 ULP (at most {int(d.max())})")
    ends = np.cumsum(summary["lengths"])
    proprio = np.zeros_like(summary["proprio"])
    for start, end in zip(np.concatenate([[0], ends[:-1]]), ends):
        a = acts[start:end]
        proprio[start:end, :7] = np.cumsum(a, 0) * 0.05
        proprio[start:end, 7:] = a[:, -1:]
    if summary["proprio"].tobytes() != proprio.tobytes():
        raise AssertionError("the proprio is not the running sum of the set's actions")
    return {"actions_off_by_1_ulp": int((d == 1).sum()), "actions": int(acts.size)}


def main(argv: Optional[List[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="datasets/synth_rlds")
    ap.add_argument("--name", default="libero_synth_l1")
    ap.add_argument("--episodes", type=int, default=48)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--tasks", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wrist", action="store_true")
    a = ap.parse_args(argv)
    return generate(a.out, a.name, a.episodes, a.steps, a.tasks, a.image_size,
                    noise=a.noise, seed=a.seed, wrist=a.wrist)


if __name__ == "__main__":
    main()
