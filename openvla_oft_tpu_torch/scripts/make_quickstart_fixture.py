"""Write the quickstart's LIBERO-Spatial observation fixture, without PIL:
the port's copy of `vla_scripts/make_quickstart_fixture.py`.

The same seeded object as the JAX script's (and as the committed
`experiments/robot/libero/sample_libero_spatial_observation.pkl`, leaf for
leaf): third-person and wrist 256 x 256 x 3 uint8 frames from the synthetic
scene renderer (`scripts/make_synthetic_rlds.py::task_image`), an 8-dim
state and the README's task string. It writes to `--out` (a temporary file
by default) and never to the JAX tree's pickle.

    python -m openvla_oft_tpu_torch.scripts.make_quickstart_fixture --out obs.pkl
"""

from __future__ import annotations

import argparse
import os
import pickle
import tempfile
from typing import Dict, List, Optional

import numpy as np

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "sample_libero_spatial_observation.pkl")
TASK = ("pick up the black bowl between the plate and the ramekin and "
        "place it on the plate")


def observation() -> Dict:
    """The fixture's object (seed 7)."""
    from openvla_oft_tpu_torch.scripts.make_synthetic_rlds import task_image

    rng = np.random.default_rng(7)
    return {
        "full_image": task_image(rng, k=2, t=12, T=64, size=256, n_tasks=8),
        "wrist_image": task_image(rng, k=5, t=12, T=64, size=256, n_tasks=8),
        "state": rng.uniform(-0.5, 0.5, 8).astype(np.float64),
        "task_description": TASK,
    }


def main(argv: Optional[List[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    a = ap.parse_args(argv)
    with open(a.out, "wb") as f:
        pickle.dump(observation(), f)
    print(f"wrote {a.out} ({os.path.getsize(a.out) / 1024:.0f} KiB)")
    return a.out


if __name__ == "__main__":
    main()
