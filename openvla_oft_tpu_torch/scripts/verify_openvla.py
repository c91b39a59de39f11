"""Smoke test and latency harness for an OpenVLA checkpoint.

    python -m openvla_oft_tpu_torch.scripts.verify_openvla --pretrained_checkpoint DIR \
        [--num_iterations 20] [--quant int8] [--device cuda]

Port of `vla_scripts/verify_openvla.py` (reference
`vla-scripts/extern/verify_openvla.py:30-89`): runs the staged
`predict_action` N times on one fixed observation through the port's
`get_vla` and prints each call's latency as p50 / p90 (`StepTimer`; the
first call is printed on its own and left out), the chunk's shape and that
it is finite. Takes a checkpoint dir or `random:tiny` / `random:7b`
weights (`zero_init` for the cheap all-zero tree). `--quant int8`
quantizes the LLM to W8A8 through `ops/quant.py::quantize_tree`, as the JAX
harness does. It runs on the card unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VerifyConfig:
    pretrained_checkpoint: str = "random:tiny"
    num_images_in_input: int = 2
    use_proprio: bool = True
    use_l1_regression: bool = True
    num_iterations: int = 20
    instruction: str = "place the bowl on the plate"
    quant: str = ""                      # "" | "int8"
    # The port's own fields.
    device: str = "cuda"
    zero_init: bool = False              # random: weights as zeros (a latency aid)


def verify(cfg: VerifyConfig) -> dict:
    from openvla_oft_tpu_torch.processing.image_processing import prepare_images_for_policy
    from openvla_oft_tpu_torch.serving.openvla_utils import get_vla
    from openvla_oft_tpu_torch.utils.profiling import StepTimer

    if cfg.quant not in ("", "int8"):
        raise ValueError(f"--quant takes '' or 'int8', got {cfg.quant!r}")
    vla = get_vla(cfg)
    if cfg.quant == "int8":
        from openvla_oft_tpu_torch.ops.quant import quantize_tree

        vla.params["llm"] = quantize_tree(vla.params["llm"], min_dim=1024)

    rng = np.random.default_rng(0)
    images = [(rng.random((224, 224, 3)) * 255).astype(np.uint8)
              for _ in range(cfg.num_images_in_input)]
    pixels = prepare_images_for_policy(images, vla.cfg, center_crop=True, device=vla.device,
                                       resize_size=vla.cfg.vision_configs[0].image_size)
    proprio = rng.random(vla.platform.proprio_dim).astype(np.float32) \
        if cfg.use_proprio else None

    timer = StepTimer()
    action = None
    for i in range(cfg.num_iterations):
        timer.start()
        action = vla.predict_action(pixels, cfg.instruction, proprio=proprio)
        timer.stop()
        if i == 0:
            print(f"first call (incl. warm-up): {timer.times[-1]:.2f}s")
            timer.times.clear()
    stats = timer.summary()
    print(f"action chunk shape: {np.asarray(action).shape}")
    print(f"finite: {np.isfinite(action).all()}")
    print("latency:", {k: round(v, 4) for k, v in stats.items()})
    assert np.isfinite(action).all()
    return stats


if __name__ == "__main__":
    from openvla_oft_tpu_torch.utils.cli import parse_args

    verify(parse_args(VerifyConfig))
