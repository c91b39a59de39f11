"""The OFT block-bidirectional attention mask (port of the serving part of
`openvla_oft_tpu/ops/masks.py`): causal attention everywhere, except that
action-chunk positions attend to each other in both directions."""

from __future__ import annotations

import torch


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
