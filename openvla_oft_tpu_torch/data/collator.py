"""Batch collation with fixed-shape padding (the port's copy of
`openvla_oft_tpu/data/collator.py`, its pad/stack and attention mask in the
host library, `utils/native.py`).

Reference `PaddedCollatorForActionPrediction`
(`prismatic/util/data_utils.py:96-156`): right-pad input_ids with pad_token_id
and labels with IGNORE_INDEX, attention_mask = (ids != pad). TPU addition:
sequence lengths round up to `pad_to_multiple` buckets so the compiled train
step is reused across batches instead of recompiling per max-length.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from openvla_oft_tpu_torch.constants import IGNORE_INDEX


def _pad_stack(seqs, target: int, fill: int) -> np.ndarray:
    """Variable-length int sequences -> (n, target) int32, right-padded: the
    plain version the tests hold `utils/native.py::pad_stack` to."""
    out = np.full((len(seqs), target), fill, np.int32)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out


@dataclasses.dataclass
class PaddedCollatorForActionPrediction:
    pad_token_id: int = 32000
    pad_to_multiple: int = 8
    max_length: Optional[int] = None   # hard bucket; None = batch max rounded up

    def __call__(self, examples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        b = len(examples)
        lens = [len(e["input_ids"]) for e in examples]
        target = self.max_length or 0
        if not target:
            m = self.pad_to_multiple
            target = ((max(lens) + m - 1) // m) * m
        if max(lens) > target:
            raise ValueError(f"sequence length {max(lens)} exceeds bucket {target}")

        from openvla_oft_tpu_torch.utils import native

        input_ids = native.pad_stack([e["input_ids"] for e in examples], target,
                                     self.pad_token_id)
        labels = native.pad_stack([e["labels"] for e in examples], target, IGNORE_INDEX)
        attn = native.attention_mask(lens, target)

        batch = {
            "input_ids": input_ids,
            "labels": labels,
            "attention_mask": attn,
            "pixel_values": np.stack([e["pixel_values"] for e in examples]),
        }
        # "actions" absent for pure-VLM (LLaVA) pretraining batches.
        for key in ("actions", "proprio"):
            if key in examples[0]:
                batch[key] = np.stack([e[key] for e in examples])
        return batch


def batch_iterator(dataset, batch_size: int, collator) :
    """Simple host-side batching loop (DataLoader num_workers=0 analog —
    the reference pins workers to 0 to avoid TF fork races, finetune.py:1027)."""
    buf = []
    for ex in dataset:
        buf.append(ex)
        if len(buf) == batch_size:
            yield collator(buf)
            buf = []


def rank_rows(batches, index: int, count: int):
    """Rows `index`/`count` of every batch (the arrays' leading dim cut in
    `count` equal parts): one data rank's share of global batches that every
    rank builds alike."""
    for batch in batches:
        n = next(len(v) for v in batch.values() if hasattr(v, "shape")) // count
        yield {k: v[index * n:(index + 1) * n] if hasattr(v, "shape") else v
               for k, v in batch.items()}
