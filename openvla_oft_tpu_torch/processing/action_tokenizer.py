"""ActionTokenizer: continuous actions <-> the last 256 Llama vocab ids.

Reference: `prismatic/vla/action_tokenizer.py:13-72`. Bins are the 256-point
uniform grid over [-1, 1]; token id = vocab_size - digitize(action), so the
*least-used* tail of the vocabulary is overwritten. Decoding subtracts from
vocab_size, clips into the 255 bin centers.

This implementation works directly on token *ids* (the reference detours
through decoded strings because its data pipeline is text-based).
"""

from __future__ import annotations

import numpy as np

from openvla_oft_tpu_torch.constants import LLAMA2_VOCAB_SIZE, N_ACTION_BINS


class ActionTokenizer:
    def __init__(self, vocab_size: int = LLAMA2_VOCAB_SIZE,
                 bins: int = N_ACTION_BINS, min_action: float = -1.0,
                 max_action: float = 1.0) -> None:
        self.vocab_size = vocab_size
        self.n_bins = bins
        self.min_action, self.max_action = min_action, max_action
        self.bins = np.linspace(min_action, max_action, bins)
        self.bin_centers = (self.bins[:-1] + self.bins[1:]) / 2.0
        self.action_token_begin_idx = vocab_size - (bins + 1)

    def encode_to_token_ids(self, action: np.ndarray) -> np.ndarray:
        """Continuous actions -> Llama token ids (vocab tail)."""
        a = np.clip(action, self.min_action, self.max_action)
        discretized = np.digitize(a, self.bins)
        return self.vocab_size - discretized

    def decode_token_ids_to_actions(self, token_ids: np.ndarray) -> np.ndarray:
        discretized = self.vocab_size - np.asarray(token_ids)
        discretized = np.clip(discretized - 1, 0, self.bin_centers.shape[0] - 1)
        return self.bin_centers[discretized]

    def __call__(self, action: np.ndarray) -> np.ndarray:
        return self.encode_to_token_ids(action)
