"""Preprocess raw ALOHA HDF5 demos on the port: downsize images, split
train/val (reference `experiments/robot/aloha/preprocess_split_aloha_data.py:58-204`).

Raw episodes hold per-step camera arrays + qpos/actions; output episodes carry
256x256 images ready for the RLDS builder. Requires h5py (import-gated).
The resize runs on `cfg.device`.

    python -m openvla_oft_tpu_torch.experiments.robot.aloha.preprocess_split_aloha_data \
        --dataset_path /path/to/raw --out_base_dir /path/to/out
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import torch

from openvla_oft_tpu_torch.processing.image_processing import resize_lanczos3


@dataclasses.dataclass
class PreprocessConfig:
    dataset_path: str = ""
    out_base_dir: str = ""
    percent_val: float = 0.05
    out_image_size: int = 256
    camera_names: str = "cam_high,cam_left_wrist,cam_right_wrist"
    split_seed: int = 0       # reference shuffles episodes before splitting
    device: str = "cuda"      # where the frames are resized ("cpu" in the tests)


def relative_actions(actions: np.ndarray) -> np.ndarray:
    """Per-step joint-position deltas, last step copying the second-to-last
    (reference preprocess_split_aloha_data.py:194-200) — consumed by the
    relative-actions ALOHA training pipeline."""
    rel = np.zeros_like(actions)
    rel[:-1] = actions[1:] - actions[:-1]
    if len(rel) > 1:
        rel[-1] = rel[-2]
    return rel


def resize_frames(frames: np.ndarray, size: int, device: str = "cuda") -> np.ndarray:
    """uint8 (T, H, W, 3) -> uint8 (T, size, size, 3): the lanczos3 resize,
    rounded and clipped to uint8, on `device`, all frames as one batch."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(device).float()
    x = torch.clamp(torch.round(resize_lanczos3(x, size)), 0, 255)
    return x.to(torch.uint8).cpu().numpy()


def preprocess(cfg: PreprocessConfig) -> None:
    import h5py

    files = sorted(glob.glob(os.path.join(cfg.dataset_path, "episode_*.hdf5")))
    assert files, f"no episode_*.hdf5 under {cfg.dataset_path}"
    # RANDOM episode split (reference :123-128 shuffles indices): a sorted
    # tail split would make validation the temporally-last demos — biased
    # for sequentially collected data
    order = np.random.default_rng(cfg.split_seed).permutation(len(files))
    files = [files[i] for i in order]
    n_val = max(int(len(files) * cfg.percent_val), 1)
    splits = {"train": files[:-n_val], "val": files[-n_val:]}
    cameras = cfg.camera_names.split(",")

    for split, split_files in splits.items():
        out_dir = os.path.join(cfg.out_base_dir, split)
        os.makedirs(out_dir, exist_ok=True)
        for i, path in enumerate(split_files):
            with h5py.File(path, "r") as f:
                out_path = os.path.join(out_dir, f"episode_{i}.hdf5")
                with h5py.File(out_path, "w") as out:
                    actions = f["/action"][()]
                    out.create_dataset("action", data=actions)
                    out.create_dataset("relative_action",
                                       data=relative_actions(actions))
                    out.attrs["sim"] = bool(f.attrs.get("sim", False))
                    out.create_dataset("observations/qpos",
                                       data=f["/observations/qpos"][()])
                    for key in ("qvel", "effort"):
                        if f.get(f"/observations/{key}") is not None:
                            out.create_dataset(
                                f"observations/{key}",
                                data=f[f"/observations/{key}"][()])
                    for cam in cameras:
                        frames = f[f"/observations/images/{cam}"][()]
                        out.create_dataset(
                            f"observations/images/{cam}",
                            data=resize_frames(frames, cfg.out_image_size, cfg.device),
                            compression="gzip", compression_opts=4)
            print(f"[{split}] wrote {out_path}")


if __name__ == "__main__":
    from openvla_oft_tpu_torch.utils.cli import parse_args

    preprocess(parse_args(PreprocessConfig))
