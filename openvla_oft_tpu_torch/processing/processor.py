"""Prompt building, the deterministic stand-in tokenizer, and the processor.

Small copies of `openvla_oft_tpu/processing/processor.py::build_prompt`,
`FakeLlamaTokenizer` and the part of `PrismaticProcessor` that training
uses: that module imports the JAX image pipeline at its top, and this
package must import where JAX is absent.
"""

from __future__ import annotations

import zlib

from openvla_oft_tpu_torch.config import OpenVLAConfig
from openvla_oft_tpu_torch.constants import EMPTY_TOKEN_ID
from openvla_oft_tpu_torch.processing.image_processing import make_device_transform

PROMPT_TEMPLATE = "In: What action should the robot take to {instruction}?\nOut: "


def build_prompt(instruction: str) -> str:
    """The reference prompt format (openvla_utils.py:753)."""
    return PROMPT_TEMPLATE.format(instruction=instruction.lower())


class FakeLlamaTokenizer:
    """Deterministic stand-in with the Llama-2 vocab contract (32000 tokens,
    BOS=1, EOS=2, 29871 = '▁'): words hash (crc32) into stable mid-vocab ids,
    the same ids as the JAX package's stand-in."""

    vocab_size = 32000
    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 32000

    def __call__(self, text: str, add_special_tokens=True):
        ids = [self.bos_token_id] if add_special_tokens else []
        for w in text.replace("\n", " \n ").split(" "):
            if w:
                ids.append(3 + (zlib.crc32(w.encode()) % 28000))
        if text.endswith(" "):
            ids.append(EMPTY_TOKEN_ID)
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}


class PrismaticProcessor:
    """A tokenizer (the stand-in by default) and the training image
    transform (`image_processing.make_device_transform`)."""

    def __init__(self, cfg: OpenVLAConfig, tokenizer=None):
        self.cfg = cfg
        self.tokenizer = tokenizer if tokenizer is not None else FakeLlamaTokenizer()
        self.transform = make_device_transform(cfg)
