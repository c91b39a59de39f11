"""Interactive generation REPL, in PyTorch.

The counterpart of `vla_scripts/generate.py` (reference `scripts/generate.py`):
a checkpoint (`random:tiny`, `random:7b` or a local dir, through
`serving/openvla_utils.py::get_vla`) answers prompts about one image with
greedy KV-cached decoding (`models/prismatic.py::predict_action_autoregressive`:
the prefill through K1 on the card, the decode steps dense), the eyeball check
of a VLM's text. Each line of standard input is one prompt, wrapped by the
checkpoint family's prompt builder and left-padded into the static bucket;
end of input ends the REPL.

    echo "what is on the table?" | python -m openvla_oft_tpu_torch.scripts.generate \\
      --model_path random:7b --max_new_tokens 8

The image (`--image_path`, a JPEG or PNG) is read by the port's reader as
PIL reads it (`processing/image_io.py`), then the staged eval conditioning
(`prepare_images_for_policy`, no center crop); without one, a random frame.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional, TextIO

import numpy as np
import torch


@dataclasses.dataclass
class GenerateConfig:
    model_path: str = "random:tiny"
    image_path: Optional[str] = None
    max_new_tokens: int = 64
    prompt_bucket: int = 64
    device: str = "cuda"                          # "cuda", "cuda:N" or "cpu"


def generate(cfg: GenerateConfig, stream: Optional[TextIO] = None) -> List[str]:
    """Answer each line of `stream` (standard input when None); print and
    return the answers."""
    from openvla_oft_tpu_torch.data.vlm_datasets import load_image
    from openvla_oft_tpu_torch.models.prismatic import predict_action_autoregressive
    from openvla_oft_tpu_torch.processing.image_processing import prepare_images_for_policy
    from openvla_oft_tpu_torch.processing.prompting import get_prompt_builder
    from openvla_oft_tpu_torch.scripts.train import device_of
    from openvla_oft_tpu_torch.serving.openvla_utils import get_vla

    class _Cfg:
        pretrained_checkpoint = cfg.model_path
        num_images_in_input = 1
        use_l1_regression = False
        use_diffusion = False
        use_film = False
        device = device_of(cfg.device)

    vla = get_vla(_Cfg())
    if cfg.image_path:
        img = load_image(cfg.image_path)
    else:
        img = (np.random.rand(224, 224, 3) * 255).astype(np.uint8)
    pixels = prepare_images_for_policy([img], vla.cfg, center_crop=False,
                                       device=vla.device)[None]
    stream = sys.stdin if stream is None else stream
    answers = []
    print("Interactive generation REPL — Ctrl-D to exit.")
    while True:
        print(">>> ", end="", flush=True)
        line = stream.readline()
        if not line:
            break
        # The checkpoint family's VLM prompt builder wraps the question (the
        # reference REPL's), not the VLA action prompt.
        builder = get_prompt_builder(vla.cfg.llm_backbone_id)
        builder.add_turn("human", line.rstrip("\n"))
        tok = vla.tokenizer(builder.get_prompt(), add_special_tokens=True)
        raw = np.asarray(tok["input_ids"], np.int64)[: cfg.prompt_bucket]
        ids = np.zeros(cfg.prompt_bucket, np.int64)
        mask = np.zeros(cfg.prompt_bucket, np.int64)
        ids[-len(raw):] = raw                  # left-padded into the static bucket
        mask[-len(raw):] = 1
        tokens = predict_action_autoregressive(
            vla.params, vla.cfg, vla.platform, torch.from_numpy(ids)[None].to(vla.device),
            torch.from_numpy(mask)[None].to(vla.device), pixels,
            num_new_tokens=cfg.max_new_tokens)
        answers.append(vla.tokenizer.decode(tokens[0].cpu().numpy()))
        print(answers[-1], flush=True)
    return answers


def main(argv=None, stream: Optional[TextIO] = None) -> List[str]:
    from openvla_oft_tpu_torch.utils.cli import parse_args

    return generate(parse_args(GenerateConfig, argv), stream)


if __name__ == "__main__":
    main()
