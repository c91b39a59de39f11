"""Action-token masks and the OFT block-bidirectional attention mask.

Port of `openvla_oft_tpu/ops/masks.py`. The label -> mask rule mirrors the
reference's cumsum construction (`prismatic/training/train_utils.py:8-39`):
positions whose label is not IGNORE_INDEX are counted left to right; counts
1..action_dim are the current action, later counts the next actions; both
intersected with "token id is an action-bin token". The attention mask is
causal everywhere, except that action-chunk positions attend to each other
in both directions.
"""

from __future__ import annotations

import torch

from openvla_oft_tpu_torch.constants import ACTION_TOKEN_BEGIN_IDX, IGNORE_INDEX


def _label_counts(token_ids: torch.Tensor) -> torch.Tensor:
    return torch.cumsum((token_ids != IGNORE_INDEX).to(torch.int32), dim=-1)


def get_current_action_mask(token_ids: torch.Tensor, action_dim: int) -> torch.Tensor:
    """(B, S) labels -> mask of the first `action_dim` action tokens."""
    counts = _label_counts(token_ids)
    return (counts >= 1) & (counts <= action_dim) & (token_ids > ACTION_TOKEN_BEGIN_IDX)


def get_next_actions_mask(token_ids: torch.Tensor, action_dim: int) -> torch.Tensor:
    """(B, S) labels -> mask of every action token after the current action."""
    return (_label_counts(token_ids) > action_dim) & (token_ids > ACTION_TOKEN_BEGIN_IDX)


def get_all_actions_mask(token_ids: torch.Tensor, action_dim: int) -> torch.Tensor:
    """Union of the current- and next-action masks (reference
    `_process_action_masks`, modeling_prismatic.py:432-436)."""
    return get_current_action_mask(token_ids, action_dim) \
        | get_next_actions_mask(token_ids, action_dim)


def make_block_bidirectional_mask(padding_mask: torch.Tensor,
                                  bidir_mask: torch.Tensor) -> torch.Tensor:
    """(B, S) padding (True = real token) and (B, S) window -> (B, S, S) bool:
    query i may attend key j iff (j <= i OR both in the window) AND j is real."""
    s = padding_mask.shape[-1]
    causal = torch.ones((s, s), dtype=torch.bool,
                        device=padding_mask.device).tril()
    block = bidir_mask[:, :, None] & bidir_mask[:, None, :]
    return (causal[None] | block) & padding_mask.bool()[:, None, :]


def make_prefix_positions(padding_mask: torch.Tensor) -> torch.Tensor:
    """Position ids = index within the non-padded prefix (right padding)."""
    return torch.cumsum(padding_mask.to(torch.int32), dim=-1, dtype=torch.int32) - 1
