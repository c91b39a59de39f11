"""Robot-platform constants and action/proprio normalization schemes (the
port's own copy of `openvla_oft_tpu/constants.py`, kept identical).

TPU-native redesign of the reference's global-constant module
(`prismatic/vla/constants.py:10-97` in the reference repo). The reference chooses
platform constants by *sniffing sys.argv at import time* and exposes them as
load-bearing module globals. Here the platform is an explicit, immutable
:class:`PlatformSpec` value that is threaded through configs — no global state,
no import-order hazards, and every sequence-geometry quantity needed for XLA
static shapes is derivable from the spec.

For CLI compatibility we still provide :func:`detect_robot_platform`, but it
operates on an explicit string (e.g. a task-suite name), never on sys.argv.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict

# === Llama-2 token constants (tokenizer contract, identical to reference) ===
IGNORE_INDEX = -100
# First vocab id - 1 of the 256 action-bin tokens: 32000 - 256 - 1 = 31743.
ACTION_TOKEN_BEGIN_IDX = 31743
STOP_INDEX = 2  # '</s>'
# The Llama SentencePiece id for the "empty" token U+2581 that trails "Out: ".
EMPTY_TOKEN_ID = 29871
# Llama-2 vocab (true) and the HF checkpoint's padded embedding rows.
LLAMA2_VOCAB_SIZE = 32000
PAD_TO_MULTIPLE_OF = 64
N_ACTION_BINS = 256


class NormalizationType(str, enum.Enum):
    """Supported normalization schemes for actions and proprioceptive state.

    Mirrors reference `prismatic/vla/constants.py:18-23`.
    """

    NORMAL = "normal"          # mean 0 / std 1
    BOUNDS = "bounds"          # [min, max] -> [-1, 1]
    BOUNDS_Q99 = "bounds_q99"  # [q01, q99] -> [-1, 1]


@dataclasses.dataclass(frozen=True)
class PlatformSpec:
    """Static geometry of one robot platform's action/proprio space.

    Every field is a Python int/enum so that anything derived from a spec is a
    static shape under `jax.jit`.
    """

    name: str
    num_actions_chunk: int
    action_dim: int
    proprio_dim: int
    norm_type: NormalizationType

    @property
    def chunk_len(self) -> int:
        """Number of action-token slots in the LLM sequence (= dim * chunk)."""
        return self.num_actions_chunk * self.action_dim


# Reference values: `prismatic/vla/constants.py:26-52`.
LIBERO = PlatformSpec("libero", 8, 7, 8, NormalizationType.BOUNDS_Q99)
ALOHA = PlatformSpec("aloha", 25, 14, 14, NormalizationType.BOUNDS)
BRIDGE = PlatformSpec("bridge", 5, 7, 7, NormalizationType.BOUNDS_Q99)
UR5E = PlatformSpec("ur5e", 8, 7, 6, NormalizationType.BOUNDS)

PLATFORMS: Dict[str, PlatformSpec] = {
    "libero": LIBERO,
    "aloha": ALOHA,
    "bridge": BRIDGE,
    "ur5e": UR5E,
}


def get_platform(name: str) -> PlatformSpec:
    try:
        return PLATFORMS[name.lower()]
    except KeyError:
        raise KeyError(f"Unknown robot platform {name!r}; choose from {sorted(PLATFORMS)}")


def detect_robot_platform(hint: str, default: str = "libero") -> PlatformSpec:
    """Resolve a platform from a free-form hint string (task suite, dataset name).

    Unlike the reference (which greps sys.argv at import time), this is explicit
    and pure: pass the string you want sniffed.
    """
    h = hint.lower()
    for key in ("libero", "aloha", "bridge", "ur5e"):
        if key in h:
            return PLATFORMS[key]
    return PLATFORMS[default]
