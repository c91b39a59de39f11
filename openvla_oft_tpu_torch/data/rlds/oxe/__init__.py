"""Open-X Embodiment registry: dataset configs, standardization transforms,
named mixtures, and kwargs materialization.

The port's copy of `openvla_oft_tpu/data/rlds/oxe/`, the full breadth of the reference
`prismatic/vla/datasets/rlds/oxe/` package (configs.py, transforms.py,
mixtures.py, materialize.py, utils/droid_utils.py).
"""

from openvla_oft_tpu_torch.data.rlds.oxe.configs import (
    ActionEncoding,
    OXE_DATASET_CONFIGS,
    OXE_STANDARDIZATION_TRANSFORMS,
    OXEDatasetConfig,
    StateEncoding,
    register_dataset,
)
from openvla_oft_tpu_torch.data.rlds.oxe.materialize import (
    get_oxe_dataset_kwargs_and_weights,
    make_oxe_dataset_kwargs,
)
from openvla_oft_tpu_torch.data.rlds.oxe.mixtures import OXE_NAMED_MIXTURES
from openvla_oft_tpu_torch.data.rlds.oxe.transforms import (
    aloha_dataset_transform,
    bridge_orig_dataset_transform,
    libero_dataset_transform,
    relabel_bridge_actions,
    rt1_dataset_transform,
    ur5e_pick_place_dataset_transform,
)

# the old single-module API exposed bridge_dataset_transform
bridge_dataset_transform = bridge_orig_dataset_transform

__all__ = [
    "ActionEncoding",
    "StateEncoding",
    "OXEDatasetConfig",
    "OXE_DATASET_CONFIGS",
    "OXE_STANDARDIZATION_TRANSFORMS",
    "OXE_NAMED_MIXTURES",
    "register_dataset",
    "make_oxe_dataset_kwargs",
    "get_oxe_dataset_kwargs_and_weights",
    "libero_dataset_transform",
    "aloha_dataset_transform",
    "bridge_orig_dataset_transform",
    "bridge_dataset_transform",
    "rt1_dataset_transform",
    "ur5e_pick_place_dataset_transform",
    "relabel_bridge_actions",
]
