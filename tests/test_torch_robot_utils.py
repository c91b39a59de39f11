"""The port's robot-eval dispatcher (`serving/robot_utils.py`) against
`experiments/robot/robot_utils.py`.

- The gripper conventions, as `tests/test_misc_components.py::
  test_gripper_conventions` checks them, and both functions against the
  reference's on the same arrays, exactly.
- `get_model` and `get_action` on the tiny checkpoint dirs of
  `tests/test_torch_eval_api.py`, for the l1, diffusion and discrete heads
  on the staged path (the JAX side's TF JPEG round trip against the port's
  codec), within that file's rtol = atol = 1e-4 and with its diffusion
  noise pinning (both loops start from JAX's first draw). The port's
  `get_vla` is pinned to fp32, as JAX's loader is there.
- An unknown `model_family` raises in both packages; `set_seed_everywhere`
  seeds numpy and `random` as the reference does, and torch too.
"""

import functools
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu_torch.serving import openvla_utils as PU
from openvla_oft_tpu_torch.serving import robot_utils as RU
from test_torch_eval_api import (ATOL, RTOL, _modules, ckpts, eval_cfg,  # noqa: F401
                                 jax_fp32, observation)


def test_gripper_conventions():
    from experiments.robot.robot_utils import invert_gripper_action as j_invert
    from experiments.robot.robot_utils import normalize_gripper_action as j_normalize

    a = np.asarray([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.8])
    out = RU.normalize_gripper_action(a, binarize=True)
    assert out[-1] == 1.0
    np.testing.assert_array_equal(out[:-1], a[:-1])
    inv = RU.invert_gripper_action(out)
    assert inv[-1] == -1.0
    assert a[-1] == 0.8 and out[-1] == 1.0                  # the inputs are copied
    chunk = np.random.default_rng(0).uniform(0, 1, (5, 8, 7))
    chunk[0, 0, -1] = 0.5                                   # sign(0) = 0
    for binarize in (True, False):
        np.testing.assert_array_equal(RU.normalize_gripper_action(chunk, binarize),
                                      j_normalize(chunk, binarize))
    np.testing.assert_array_equal(RU.invert_gripper_action(chunk), j_invert(chunk))


@pytest.mark.parametrize("head", ["l1", "diffusion", "discrete"])
def test_get_model_and_get_action_match_jax(ckpts, jax_fp32, rng, monkeypatch, head):
    import experiments.robot.openvla_utils as JU
    import experiments.robot.robot_utils as JR

    monkeypatch.setattr(RU, "get_vla", functools.partial(PU.get_vla, dtype=torch.float32))
    cfg = eval_cfg(ckpts["diffusion" if head == "diffusion" else "l1"], head)
    j_vla, p_vla = JR.get_model(cfg), RU.get_model(cfg)
    assert p_vla.head == j_vla.head == head and p_vla.device == torch.device("cpu")
    if head == "diffusion":
        noise = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (
            1, LIBERO.num_actions_chunk, LIBERO.action_dim), dtype=jnp.float32))
        p_vla.predict_action = functools.partial(p_vla.predict_action,
                                                 noise=torch.from_numpy(noise))
    obs = observation(rng)
    want = JR.get_action(cfg, j_vla, dict(obs), "put the bowl on the stove",
                         processor=JU.get_processor(cfg), **_modules(JU, cfg, head))
    got = RU.get_action(cfg, p_vla, dict(obs), "put the bowl on the stove",
                        processor=PU.get_processor(cfg), **_modules(PU, cfg, head))
    assert len(got) == len(want) == 8 and got[0].shape == (7,)
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=RTOL, atol=ATOL)
    assert RU.get_image_resize_size(cfg) == JR.get_image_resize_size(cfg) == 224


def test_unknown_model_family_raises_in_both():
    import experiments.robot.robot_utils as JR

    cfg = types.SimpleNamespace(model_family="pi0")
    for mod in (RU, JR):
        for call in (lambda: mod.get_model(cfg), lambda: mod.get_image_resize_size(cfg),
                     lambda: mod.get_action(cfg, None, {}, "task")):
            with pytest.raises(ValueError, match="Unsupported model family: pi0"):
                call()


def test_set_seed_everywhere_seeds_numpy_random_and_torch():
    import experiments.robot.robot_utils as JR

    def draws():
        return (np.random.rand(3).tolist(), random.random(), torch.rand(3).tolist())

    RU.set_seed_everywhere(7)
    first = draws()
    RU.set_seed_everywhere(7)
    assert draws() == first
    JR.set_seed_everywhere(7)
    assert draws()[:2] == first[:2]
