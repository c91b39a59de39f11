"""Batch transform and dummy dataset.

Port of `openvla_oft_tpu/data/datasets.py::RLDSBatchTransform` and
`DummyDataset` (reference `prismatic/vla/datasets/datasets.py:27-269`) on
the port's processor. Examples are numpy arrays, as the JAX classes give
them, so the JAX package's collator (`data/collator.py`, no JAX import)
batches them; with the same seed both yield the same arrays.

  input_ids = tokenize("In: What action should the robot take to {lang}?\\nOut: ")
              + action-chunk token ids + </s>
  labels    = input_ids with everything before the action tokens masked
  pixels    = primary + wrist/gripper frames -> (N, n_backbones, H, W, 3)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List

import numpy as np

from openvla_oft_tpu_torch.constants import EMPTY_TOKEN_ID, IGNORE_INDEX, STOP_INDEX, PlatformSpec
from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer
from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor, build_prompt


@dataclasses.dataclass
class RLDSBatchTransform:
    processor: PrismaticProcessor
    action_tokenizer: ActionTokenizer
    platform: PlatformSpec
    predict_stop_token: bool = True

    def __call__(self, rlds_batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        lang = rlds_batch["task"]["language_instruction"]
        if isinstance(lang, bytes):
            lang = lang.decode()
        obs = rlds_batch["observation"]
        actions = np.asarray(rlds_batch["action"], np.float32)   # (chunk, dim)

        def frame(x):
            x = np.asarray(x)
            return x[-1] if x.ndim == 4 else x   # window axis -> current frame

        images: List[np.ndarray] = [frame(obs["image_primary"])]
        for key in sorted(obs):
            if "wrist" in key or "gripper" in key:
                images.append(frame(obs[key]))

        ids = list(self.processor.tokenizer(build_prompt(lang),
                                            add_special_tokens=True)["input_ids"])
        if ids[-1] != EMPTY_TOKEN_ID:
            ids.append(EMPTY_TOKEN_ID)
        action_ids = self.action_tokenizer(actions).reshape(-1).tolist()
        ids = ids + action_ids + [STOP_INDEX]

        # Every action token and the STOP are supervised (reference
        # datasets.py:74-77); predict_stop_token=False masks the STOP.
        labels = np.asarray(ids, np.int32).copy()
        labels[:len(labels) - (len(action_ids) + 1)] = IGNORE_INDEX
        if not self.predict_stop_token:
            labels[-1] = IGNORE_INDEX

        pixels = self.processor.transform(
            np.stack([np.asarray(im, np.uint8) for im in images])).numpy()
        out = {
            "input_ids": np.asarray(ids, np.int32),
            "labels": labels,
            "pixel_values": pixels,              # (N, n_backbones, H, W, 3)
            "actions": actions,
            "dataset_name": rlds_batch.get("dataset_name", "unknown"),
        }
        if "proprio" in obs:
            proprio = np.asarray(obs["proprio"], np.float32)
            out["proprio"] = proprio[-1] if proprio.ndim == 2 else proprio
        return out


@dataclasses.dataclass
class DummyDataset:
    """Random frames with the RLDS contract (reference datasets.py:217-269),
    drawn from `np.random.default_rng(seed)` in the JAX class's order."""

    transform: RLDSBatchTransform
    image_size: int = 224
    num_samples: int = 1000
    num_images: int = 1
    seed: int = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        p = self.transform.platform
        for _ in range(self.num_samples):
            obs = {
                "image_primary": (rng.random(
                    (self.image_size, self.image_size, 3)) * 255).astype(np.uint8),
                "proprio": rng.standard_normal(p.proprio_dim).astype(np.float32),
            }
            for i in range(self.num_images - 1):
                obs[f"image_wrist{i}"] = (rng.random(
                    (self.image_size, self.image_size, 3)) * 255).astype(np.uint8)
            yield self.transform({
                "observation": obs,
                "task": {"language_instruction": "do something spectacular"},
                "action": rng.uniform(-1, 1, (p.num_actions_chunk, p.action_dim))
                .astype(np.float32),
                "dataset_name": "dummy_dataset",
            })

    def __len__(self) -> int:
        return self.num_samples
