"""Build the extended instruct-tuning mixtures (the port's copy of
`vla_scripts/build_instruct_mixtures.py`, reference
`scripts/additional-datasets/{lvis_instruct_4v,lrv_instruct}.py`).
Standard library only.

Produces the merged jsons that the llava-lvis4v / llava-lrv /
llava-lvis4v-lrv dataset variants (data/vlm_datasets.py) consume:

  llava_v1_5_mix665k.json  + lvis4v 220k          -> llava_v1_5_lvis4v_mix888k.json
  llava_v1_5_mix665k.json  + lrv (vg+chart) 343k  -> llava_v1_5_lrv_mix1008k.json
  llava_v1_5_lvis4v_mix888k.json + lrv            -> llava_v1_5_lvis4v_lrv_mix1231k.json

LRV examples are single-turn (question/answer) and are reformatted into the
LLaVA chat schema; mixtures are shuffled with the reference's seeding
(seed 7, shuffled three times) so example order — and therefore training
curricula — reproduce exactly. Raw inputs (lvis json, lrv jsons + image
dirs) must be staged under `--base_dir` as the reference documents; nothing
is downloaded.

    python -m openvla_oft_tpu_torch.scripts.build_instruct_mixtures \
      --base_dir data/download/llava-v1.5-instruct --build all
"""

from __future__ import annotations

import dataclasses
import json
import random
from pathlib import Path
from typing import Dict, List


@dataclasses.dataclass
class MixtureConfig:
    base_dir: Path = Path("data/download/llava-v1.5-instruct")
    build: str = "all"          # "lvis4v" | "lrv" | "all"
    verify_images: bool = True


def _shuffled(examples: List[Dict]) -> List[Dict]:
    """Reference determinism: seed 7, three shuffles."""
    random.seed(7)
    out = list(examples)
    for _ in range(3):
        random.shuffle(out)
    return out


def _verify(base_dir: Path, examples: List[Dict], what: str) -> None:
    missing = [e["image"] for e in examples
               if not (base_dir / e["image"]).exists()]
    assert not missing, (
        f"{what}: {len(missing)} referenced images missing under {base_dir} "
        f"(first: {missing[:3]})")


def _lrv_chat_examples(base_dir: Path) -> List[Dict]:
    """VG + chart LRV splits reformatted to the LLaVA chat schema
    (single human turn with <image> prefix, single gpt answer)."""
    lrv = base_dir / "lrv"
    examples: List[Dict] = []
    for fn in ("filter_cap1.json", "filter_cap_more1.json"):
        with open(lrv / fn) as f:
            for ex in json.load(f):
                examples.append({
                    "id": ex["image_id"],
                    "image": f"lrv/lrv-vg/{ex['image_id']}.jpg",
                    "conversations": [
                        {"from": "human",
                         "value": f"<image>\n{ex['question'].strip()}"},
                        {"from": "gpt", "value": ex["answer"].strip()},
                    ]})
    with open(lrv / "chart_release_update.json") as f:
        for ex in json.load(f):
            examples.append({
                "id": Path(ex["image_id"]).stem,
                "image": f"lrv/lrv-chart/{ex['image_id']}",
                "conversations": [
                    {"from": "human",
                     "value": f"<image>\n{ex['question'].strip()}"},
                    {"from": "gpt", "value": ex["answer"].strip()},
                ]})
    return examples


def build_lvis4v_mixture(base_dir: Path, verify_images: bool = True) -> Path:
    base_dir = Path(base_dir)
    with open(base_dir / "lvis_instruct4v_220k.json") as f:
        lvis = json.load(f)
    if verify_images:
        _verify(base_dir, lvis, "lvis4v")
    with open(base_dir / "llava_v1_5_mix665k.json") as f:
        base = json.load(f)
    out = base_dir / "llava_v1_5_lvis4v_mix888k.json"
    with open(out, "w") as f:
        json.dump(_shuffled(base + lvis), f)
    print(f"[mixtures] wrote {out} ({len(base) + len(lvis)} examples)")
    return out


def build_lrv_mixtures(base_dir: Path, verify_images: bool = True) -> List[Path]:
    base_dir = Path(base_dir)
    lrv = _lrv_chat_examples(base_dir)
    if verify_images:
        _verify(base_dir, lrv, "lrv")
    outs = []
    for base_name, out_name in (
            ("llava_v1_5_mix665k.json", "llava_v1_5_lrv_mix1008k.json"),
            ("llava_v1_5_lvis4v_mix888k.json",
             "llava_v1_5_lvis4v_lrv_mix1231k.json")):
        with open(base_dir / base_name) as f:
            base = json.load(f)
        out = base_dir / out_name
        with open(out, "w") as f:
            json.dump(_shuffled(base + lrv), f)
        print(f"[mixtures] wrote {out} ({len(base) + len(lrv)} examples)")
        outs.append(out)
    return outs


def main(cfg: MixtureConfig) -> None:
    if cfg.build in ("lvis4v", "all"):
        build_lvis4v_mixture(cfg.base_dir, cfg.verify_images)
    if cfg.build in ("lrv", "all"):
        build_lrv_mixtures(cfg.base_dir, cfg.verify_images)


if __name__ == "__main__":
    from openvla_oft_tpu_torch.utils.cli import parse_args

    main(parse_args(MixtureConfig))
