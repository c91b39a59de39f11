"""Prompt building, the tokenizers, and the processor.

Copies of `openvla_oft_tpu/processing/processor.py::build_prompt`,
`load_tokenizer`, `derive_prompt_bucket`, `FakeLlamaTokenizer` and the part
of `PrismaticProcessor` that training and serving use: that module imports
the JAX image pipeline at its top, and this package must import where JAX
is absent.
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


def load_tokenizer(path_or_dir: str, hf: bool = False):
    """The Llama-2 tokenizer of a checkpoint dir (or a `tokenizer.model`
    path): the port's pure-Python SentencePiece over `tokenizer.model`;
    with `hf`, or where there is no usable `tokenizer.model`, HF
    `AutoTokenizer` from the local files (an ImportError says so where
    `transformers` is not installed)."""
    if not hf:
        from openvla_oft_tpu_torch.processing.sentencepiece import load_sentencepiece

        sp = load_sentencepiece(path_or_dir)
        if sp is not None:
            return sp
    try:
        from transformers import AutoTokenizer
    except ImportError as err:
        raise ImportError(
            f"{path_or_dir}: " + ("the HF tokenizer was asked for" if hf else
                                  "no usable tokenizer.model") +
            ", and HF AutoTokenizer needs the `transformers` package, which is not "
            "installed") from err
    return AutoTokenizer.from_pretrained(path_or_dir, local_files_only=True)


def derive_prompt_bucket(tokenizer, instructions, multiple: int = 16,
                         headroom: int = 2) -> int:
    """The static prompt bucket from real tokenizations of a task corpus
    (e.g. a LIBERO suite's instructions): the longest prompt (with BOS and
    the 29871 fixup) plus `headroom`, rounded up to `multiple`, so that every
    instruction of the corpus fits the bucket."""
    longest = 0
    for ins in instructions:
        ids = tokenizer(build_prompt(ins), add_special_tokens=True)["input_ids"]
        longest = max(longest, len(ids) + (ids[-1] != EMPTY_TOKEN_ID))
    need = longest + headroom
    return -(-need // multiple) * multiple


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

    def decode(self, ids, **kw) -> str:
        """Each id as `<id>`, space-separated (the JAX stand-in's decode)."""
        import numpy as np

        return " ".join(f"<{i}>" for i in np.atleast_1d(np.asarray(ids)))


class PrismaticProcessor:
    """A tokenizer (the stand-in by default) and the training image
    transform (`image_processing.make_device_transform`)."""

    def __init__(self, cfg: OpenVLAConfig, tokenizer=None):
        self.cfg = cfg
        self.tokenizer = tokenizer if tokenizer is not None else FakeLlamaTokenizer()
        self.transform = make_device_transform(cfg)
