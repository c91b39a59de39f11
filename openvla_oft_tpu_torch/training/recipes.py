"""Training-recipe registry (reference `prismatic/conf/vla.py` VLAConfig /
VLARegistry dataclass hierarchy, :20-235).

Each recipe captures a documented reproduction configuration (LIBERO.md:92-119
and ALOHA.md:59-84) as `vla_scripts/finetune.py` flag overrides, retrievable
by ID. `apply_recipe` merges a recipe into a FinetuneConfig.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

RECIPES: Dict[str, Dict[str, Any]] = {}


def register_recipe(recipe_id: str, **overrides) -> Dict[str, Any]:
    RECIPES[recipe_id] = overrides
    return overrides


# === OFT LIBERO reproduction (LIBERO.md:92-119): 8 GPUs x batch 8, LR 5e-4,
# 10x decay @ 100K, 150K steps (goal suite evaluated at 50K). ===
for _suite in ("spatial", "object", "goal", "10"):
    register_recipe(
        f"oft-libero-{_suite}",
        dataset_name=f"libero_{_suite}_no_noops",
        use_l1_regression=True, use_proprio=True, num_images_in_input=2,
        batch_size=64, learning_rate=5e-4, num_steps_before_decay=100_000,
        max_steps=150_005 if _suite != "goal" else 50_005,
        image_aug=True, use_lora=True, lora_rank=32,
        robot_platform="libero",
    )

# === OFT+ ALOHA (ALOHA.md:59-84): batch 4 x 8, FiLM, 3 images, 100K steps,
# decay @ 50K. ===
for _task in ("aloha_scoop_x_into_bowl", "aloha1_put_X_into_pot_300_demos",
              "aloha1_fold_shirt_30_demos"):
    register_recipe(
        f"oft-plus-{_task}",
        dataset_name=_task,
        use_l1_regression=True, use_proprio=True, use_film=True,
        num_images_in_input=3, batch_size=32, learning_rate=5e-4,
        num_steps_before_decay=50_000, max_steps=100_005,
        image_aug=True, use_lora=True, lora_rank=32,
        robot_platform="aloha",
    )

# === Fork UR5e recipes ===
register_recipe(
    "oft-ur5e-pick-place",
    dataset_name="ur5e_pick_place", use_l1_regression=True, use_proprio=True,
    num_images_in_input=2, batch_size=32, learning_rate=5e-4,
    num_steps_before_decay=100_000, max_steps=150_005, image_aug=True,
    use_lora=True, lora_rank=32, robot_platform="ur5e",
)

# === Diffusion-head variant (paper's alternative continuous head) ===
register_recipe(
    "oft-libero-spatial-diffusion",
    dataset_name="libero_spatial_no_noops", use_l1_regression=False,
    use_diffusion=True, use_proprio=True, num_images_in_input=2,
    batch_size=64, learning_rate=5e-4, num_steps_before_decay=100_000,
    max_steps=150_005, image_aug=True, use_lora=True, lora_rank=32,
    robot_platform="libero",
)


def available_recipes() -> Tuple[str, ...]:
    return tuple(sorted(RECIPES))


def apply_recipe(cfg, recipe_id: str):
    """Return a copy of `cfg` (a FinetuneConfig) with the recipe applied."""
    overrides = RECIPES[recipe_id]
    return dataclasses.replace(cfg, **overrides)
