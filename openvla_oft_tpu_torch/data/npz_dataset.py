"""TF-free episode store and streaming loader: the port's copy of
`openvla_oft_tpu/data/npz_dataset.py`, reading its frames with the port's
image reader (`processing/image_io.py`) where the JAX module takes PIL's
`Image.open(...).convert("RGB")`: the ISLOW inverse DCT, so that a frame
equals the JAX store's PIL pixels bit for bit.

Episodes live as one `.npz` per episode (JPEG bytes + actions + proprio +
instruction), and the loader streams chunked and normalized frames using
the NumPy transform core (data/transforms.py) with its own shuffle buffer.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from openvla_oft_tpu_torch.constants import PlatformSpec
from openvla_oft_tpu_torch.data.transforms import (
    chunk_actions,
    compute_dataset_statistics,
    load_dataset_statistics,
    normalize,
    save_dataset_statistics,
)


def write_npz_episodes(out_dir: str, episodes: List[Dict]) -> List[str]:
    """episodes: dicts with images (list of JPEG bytes), actions (T, D),
    proprio (T, P), language_instruction (str), optional wrist_images."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, ep in enumerate(episodes):
        path = os.path.join(out_dir, f"episode_{i:06d}.npz")
        payload = {
            "images": np.asarray(ep["images"], dtype=object),
            "actions": np.asarray(ep["actions"], np.float32),
            "proprio": np.asarray(ep.get("proprio", []), np.float32),
            "language_instruction": np.asarray(ep["language_instruction"]),
        }
        if "wrist_images" in ep:
            payload["wrist_images"] = np.asarray(ep["wrist_images"],
                                                 dtype=object)
        # NOTE: savez has no allow_pickle kwarg — passing it would store a
        # spurious array named "allow_pickle" in the archive
        np.savez_compressed(path, **payload)
        paths.append(path)
    return paths


def _decode_jpeg(data: bytes) -> np.ndarray:
    from openvla_oft_tpu_torch.processing.image_io import read_image

    return read_image(data, idct="islow")


def _load_episode(path: str) -> Dict:
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def compute_stats_npz(ds_dir: str, max_episodes: int = 1000) -> Dict:
    files = sorted(glob.glob(os.path.join(ds_dir, "episode_*.npz")))
    assert files, f"no episode_*.npz under {ds_dir}"
    acts, props = [], []
    for path in files[:max_episodes]:
        ep = _load_episode(path)
        acts.append(ep["actions"])
        if ep["proprio"].size:
            props.append(ep["proprio"])
    return compute_dataset_statistics(
        np.concatenate(acts), np.concatenate(props) if props else None,
        num_trajectories=min(len(files), max_episodes))


def make_npz_iterator(
    root: str,
    name: str,
    batch_transform,
    platform: PlatformSpec,
    shuffle_buffer_size: int = 1000,
    train: bool = True,
    seed: int = 0,
    num_images: int = 1,
) -> Tuple[Iterator[Dict[str, np.ndarray]], Dict]:
    """Mirror of `make_rlds_iterator` without TensorFlow."""
    ds_dir = os.path.join(root, name)
    stats_path = os.path.join(ds_dir, "dataset_statistics.json")
    if os.path.exists(stats_path):
        stats = load_dataset_statistics(stats_path)
    else:
        stats = compute_stats_npz(ds_dir)
        save_dataset_statistics(stats, ds_dir)

    files = sorted(glob.glob(os.path.join(ds_dir, "episode_*.npz")))
    future = platform.num_actions_chunk - 1
    rng = np.random.default_rng(seed)

    def frames():
        while True:
            order = rng.permutation(len(files)) if train else range(len(files))
            for fi in order:
                ep = _load_episode(files[int(fi)])
                actions = normalize(ep["actions"], stats["action"],
                                    platform.norm_type)
                chunks = chunk_actions(actions, 1, future)
                eff = chunks.shape[0]
                proprio = ep["proprio"]
                if proprio.size and stats.get("proprio"):
                    proprio = normalize(proprio, stats["proprio"],
                                        platform.norm_type)
                lang = str(ep["language_instruction"])
                for t in range(eff):
                    obs = {"image_primary": _decode_jpeg(ep["images"][t])}
                    if num_images > 1 and "wrist_images" in ep:
                        obs["image_wrist"] = _decode_jpeg(ep["wrist_images"][t])
                    if proprio.size:
                        obs["proprio"] = proprio[t]
                    yield {
                        "observation": obs,
                        "task": {"language_instruction": lang},
                        "action": chunks[t],
                        "dataset_name": name,
                    }
            if not train:
                return

    def shuffled():
        buf: List[Dict] = []
        for frame in frames():
            buf.append(frame)
            if len(buf) >= shuffle_buffer_size:
                idx = rng.integers(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield batch_transform(buf.pop())
        while buf:
            yield batch_transform(buf.pop())

    return (shuffled() if train else
            (batch_transform(f) for f in frames())), {name: stats}
