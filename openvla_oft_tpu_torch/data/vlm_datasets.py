"""VLM pretraining datasets: the LLaVA align and instruct-tune stages (the port's
copy of `openvla_oft_tpu/data/vlm_datasets.py`, reference
`prismatic/preprocessing/datasets/` and `prismatic/conf/datasets.py`).

The LLaVA JSON format (a list of {id, image, conversations}) with an image
root directory. Two stages, as the reference's `scripts/pretrain.py` runs
them (align, then finetune):
  - "align":    the human turn is dropped; ids = <caption></s>, BOS masked;
  - "finetune": tokenized turn by turn through the prompt builder, every
                human turn masked, BOS masked.
Each example is truncated to `max_length`; the order is shuffled with
`shuffle_seed`. Images are read by `processing/image_io.py` (JPEG through
the host decoder's ISLOW inverse DCT, and PNG), PIL's pixels bit for bit
(the JAX dataset decodes with PIL); a file of another format raises, naming
it. The processor's transform applies the
model's resize strategy.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from openvla_oft_tpu_torch.constants import IGNORE_INDEX
from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor
from openvla_oft_tpu_torch.processing.prompting import get_prompt_builder

# Named dataset variants (reference `prismatic/conf/datasets.py:35-113`
# DatasetRegistry): each shares the LAION-CC-SBU-558k align stage and names
# its own instruct mixture for the finetune stage.
_ALIGN = ("download/llava-laion-cc-sbu-558k/chat.json",
          "download/llava-laion-cc-sbu-558k/")
_INSTRUCT_DIR = "download/llava-v1.5-instruct/"
VLM_DATASET_REGISTRY: Dict[str, Dict[str, tuple]] = {
    "llava-v15": {
        "align": _ALIGN,
        "finetune": (_INSTRUCT_DIR + "llava_v1_5_mix665k.json", _INSTRUCT_DIR)},
    "llava-multimodal": {  # no language-only ShareGPT co-training
        "align": _ALIGN,
        "finetune": (_INSTRUCT_DIR + "llava_v1_5_stripped625k.json", _INSTRUCT_DIR)},
    "llava-lvis4v": {
        "align": _ALIGN,
        "finetune": (_INSTRUCT_DIR + "llava_v1_5_lvis4v_mix888k.json", _INSTRUCT_DIR)},
    "llava-lrv": {
        "align": _ALIGN,
        "finetune": (_INSTRUCT_DIR + "llava_v1_5_lrv_mix1008k.json", _INSTRUCT_DIR)},
    "llava-lvis4v-lrv": {
        "align": _ALIGN,
        "finetune": (_INSTRUCT_DIR + "llava_v1_5_lvis4v_lrv_mix1231k.json", _INSTRUCT_DIR)},
}


def resolve_vlm_dataset(dataset_id: str, stage: str, dataset_root_dir: str) -> tuple:
    """(json_path, image_root) of a named variant's stage under
    `dataset_root_dir` (reference DatasetConfig.*_stage_components)."""
    if dataset_id not in VLM_DATASET_REGISTRY:
        raise KeyError(f"unknown VLM dataset {dataset_id!r}; known: "
                       f"{sorted(VLM_DATASET_REGISTRY)}")
    rel_json, rel_images = VLM_DATASET_REGISTRY[dataset_id][stage]
    return (os.path.join(dataset_root_dir, rel_json),
            os.path.join(dataset_root_dir, rel_images))


def load_image(path: str) -> np.ndarray:
    """A JPEG or PNG file -> uint8 (H, W, 3) RGB, PIL's pixels
    (`processing/image_io.py`: `Image.open(...).convert("RGB")`). Any other
    format, or a file the decoders refuse, raises naming the file."""
    from openvla_oft_tpu_torch.processing.image_io import read_image

    with open(path, "rb") as f:
        data = f.read()
    try:
        return read_image(data, idct="islow")
    except ValueError as err:
        raise ValueError(f"{path}: {err} (the VLM datasets read JPEG and PNG "
                         "files)") from err


@dataclasses.dataclass
class VLMPretrainDataset:
    json_path: str
    image_root: str
    processor: PrismaticProcessor
    stage: str = "finetune"              # "align" | "finetune"
    llm_backbone_id: str = "llama2-7b-pure"
    shuffle_seed: Optional[int] = 0
    max_length: Optional[int] = 2048     # reference: tokenizer.model_max_length

    def __post_init__(self):
        with open(self.json_path) as f:
            self.records: List[Dict] = json.load(f)

    def __len__(self) -> int:
        return len(self.records)

    def _tokens(self, convs: List[Dict]):
        tokenizer = self.processor.tokenizer
        if self.stage == "align":
            # Reference AlignDataset (datasets.py:49-85): the human prompt is
            # dropped; the caption is predicted from the image alone.
            caption = convs[-1]["value"].replace("<image>", "").strip()
            ids = np.asarray(tokenizer(caption + "</s>", add_special_tokens=True)["input_ids"],
                             np.int32)
            labels = ids.copy()
        else:
            # Reference FinetuneDataset (datasets.py:139-160): turn by turn,
            # every even (human) turn masked.
            builder = get_prompt_builder(self.llm_backbone_id)
            id_parts, label_parts = [], []
            for turn_idx, turn in enumerate(convs):
                role = "human" if turn.get("from") in ("human", "user") else "gpt"
                wrapped = builder.add_turn(role, turn["value"]).rstrip()
                turn_ids = tokenizer(wrapped, add_special_tokens=(turn_idx == 0))["input_ids"]
                id_parts.extend(turn_ids)
                label_parts.extend([IGNORE_INDEX] * len(turn_ids) if turn_idx % 2 == 0
                                   else list(turn_ids))
            ids = np.asarray(id_parts, np.int32)
            labels = np.asarray(label_parts, np.int32)
        labels[:1] = IGNORE_INDEX
        if self.max_length is not None:
            ids, labels = ids[: self.max_length], labels[: self.max_length]
        return ids, labels

    def _example_from_record(self, rec: Dict) -> Optional[Dict]:
        convs = rec.get("conversations", [])
        if not convs or "image" not in rec:
            return None
        ids, labels = self._tokens(convs)
        image = load_image(os.path.join(self.image_root, rec["image"]))
        pixels = self.processor.transform(image[None]).numpy()
        return {"input_ids": ids, "labels": labels, "pixel_values": pixels,
                "dataset_name": "llava"}

    def __iter__(self) -> Iterator[Dict]:
        order = np.arange(len(self.records))
        if self.shuffle_seed is not None:
            np.random.default_rng(self.shuffle_seed).shuffle(order)
        for idx in order:
            ex = self._example_from_record(self.records[idx])
            if ex is not None:
                yield ex
