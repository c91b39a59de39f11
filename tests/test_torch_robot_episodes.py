"""Whole eval episodes of the port's LIBERO and robosuite clients against
the JAX package's, on one checkpoint dir each.

A tiny checkpoint dir written by JAX's exporter (as in
`tests/test_torch_eval_api.py`, with its `jax_fp32` pin: both sides in
fp32) goes through JAX's `experiments/robot/*/run_*_eval.py::run_episode`
and the port's, each on its own copy of one scripted environment that
replays seeded frames and states and ends the episode after 20 steps. The
actions each side steps agree within rtol = atol = 1e-4 (the bound of
`tests/test_torch_serve.py`), with equal gripper bits: LIBERO's binarized,
inverted gripper and robosuite's closed bit. Both sides run the staged
conditioning (JAX's TF JPEG round trip against the port's own codec).

Where a lanczos3 resize changes a frame's size, the two sides' fp32 sums put
up to 0.1% of its pixels one level apart (held at that bound in
`tests/test_torch_robot_eval.py`, at these frame sizes too), and through
the tiny random ViTs one such pixel moves an action by about 1.4e-4 (with
the JAX side's pixels fed to the port, the episodes agree within 1e-4).
LIBERO's 256 x 256 frames, its real size, go through that resize on both
sides and the episodes agree within the bound. Robosuite's 200 x 360 front
camera goes through the crop and PIL's bilinear resize to 224 (bitwise the
same on both sides); its eye-in-hand camera renders here at 224 x 224, where
the lanczos3 resize is the identity on both sides, as the
`device_preprocess` case of `tests/test_torch_eval_api.py` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvla_oft_tpu.utils.hf_import as JH
from openvla_oft_tpu.constants import LIBERO, UR5E
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.training.checkpoint import export_module_pt
from openvla_oft_tpu_torch.serving import openvla_utils as PU
from test_torch_eval_api import CFG, STATS, jax_fp32, tokenizer_model  # noqa: F401

RTOL = ATOL = 1e-4
EPISODE_STEPS = 20
UR5E_STATS = {"ur5e_pick_place": {
    "action": {"min": [-1.0] * 7, "max": [1.0] * 7, "q01": [-0.9] * 7, "q99": [0.9] * 7,
               "mask": [True] * 6 + [False]},
    "proprio": {"min": [-2.0] * 6, "max": [2.0] * 6, "q01": [-1.8] * 6, "q99": [1.8] * 6},
}}


def _export(path, platform, stats):
    params = init_openvla_params(jax.random.PRNGKey(0), CFG, platform, dtype=jnp.float32,
                                 head="l1")
    base = {k: params[k] for k in ("llm", "vision_backbone", "projector")}
    d = JH.export_openvla_checkpoint(CFG, base, str(path), norm_stats=stats)
    (path / "tokenizer.model").write_bytes(tokenizer_model())
    export_module_pt(params["proprio_projector"], "proprio_projector", d, 10)
    export_module_pt(params["action_head"], "action_head", d, 10)
    return d


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    # Dir names free of platform words: get_vla reads the platform from the
    # checkpoint path, the task suite and the unnorm key.
    root = tmp_path_factory.mktemp("episodes")
    return {"libero": _export(root / "a", LIBERO, STATS),
            "ur5e": _export(root / "b", UR5E, UR5E_STATS)}


def _policies(j_cfg, p_cfg):
    """(model, processor, action_head, proprio_projector) of each side, the
    port's in fp32 on the CPU."""
    import experiments.robot.openvla_utils as JU

    j = (JU.get_vla(j_cfg), JU.get_processor(j_cfg), JU.get_action_head(j_cfg),
         JU.get_proprio_projector(j_cfg))
    p = (PU.get_vla(p_cfg, dtype=torch.float32), PU.get_processor(p_cfg),
         PU.get_action_head(p_cfg), PU.get_proprio_projector(p_cfg))
    return j, p


class _LiberoEnv:
    """LIBERO's OffScreenRenderEnv surface: seeded 256 x 256 frames and
    states replayed in turn, done at the 20th step."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        self.obs = [{"agentview_image": rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),
                     "robot0_eye_in_hand_image": rng.integers(0, 256, (256, 256, 3),
                                                              dtype=np.uint8),
                     "robot0_eef_pos": rng.uniform(-0.3, 0.3, 3),
                     "robot0_eef_quat": (q := rng.standard_normal(4)) / np.linalg.norm(q),
                     "robot0_gripper_qpos": rng.uniform(-0.04, 0.04, 2)} for _ in range(3)]
        self.stepped = []

    def reset(self):
        self.stepped = []

    def set_init_state(self, state):
        return self.obs[0]

    def step(self, action):
        self.stepped.append(np.asarray(action, np.float64))
        n = len(self.stepped)
        return self.obs[n % len(self.obs)], 0.0, n == EPISODE_STEPS, {}


def test_libero_episode_matches_jax(ckpts, jax_fp32):
    import experiments.robot.libero.run_libero_eval as J

    from openvla_oft_tpu_torch.experiments.robot.libero import run_libero_eval as P

    kw = dict(pretrained_checkpoint=ckpts["libero"], task_suite_name="libero_spatial")
    j_cfg, p_cfg = J.GenerateConfig(**kw), P.GenerateConfig(**kw, device="cpu")
    (j_model, *j_mods), (p_model, *p_mods) = _policies(j_cfg, p_cfg)
    J.check_unnorm_key(j_cfg, j_model)
    P.check_unnorm_key(p_cfg, p_model)
    assert p_cfg.unnorm_key == j_cfg.unnorm_key == "libero_spatial"
    envs = {}
    for side, mod, cfg, model, (proc, head, proprio) in (
            ("jax", J, j_cfg, j_model, j_mods), ("port", P, p_cfg, p_model, p_mods)):
        envs[side] = env = _LiberoEnv(11)
        success, replay = mod.run_episode(cfg, env, "put the bowl on the stove", model, 224,
                                          proc, head, proprio, None, initial_state=np.zeros(3))
        # 10 settle steps, then 10 of the policy's (2 queries of 8), and done
        assert success and len(env.stepped) == EPISODE_STEPS and len(replay) == 10
    got, want = np.stack(envs["port"].stepped), np.stack(envs["jax"].stepped)
    np.testing.assert_array_equal(got[:10], want[:10])                 # the settle no-ops
    np.testing.assert_allclose(got[10:, :6], want[10:, :6], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[:, 6], want[:, 6])
    assert set(np.unique(got[10:, 6])) <= {-1.0, 1.0}
    assert not np.array_equal(got[10], got[18])                        # two distinct queries


class _RobosuiteEnv:
    """The UR5e task env's surface: seeded 200 x 360 front and 224 x 224
    eye-in-hand frames and states, done at the 20th step."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        self.obs = [{"camera_front_image": rng.integers(0, 256, (200, 360, 3), dtype=np.uint8),
                     "eye_in_hand_image": rng.integers(0, 256, (224, 224, 3), dtype=np.uint8),
                     "eef_pos": rng.uniform(-0.3, 0.3, 3),
                     "eef_quat": (q := rng.standard_normal(4)) / np.linalg.norm(q),
                     "joint_pos": rng.uniform(-1.5, 1.5, 6)} for _ in range(3)]
        self.stepped = []

    def reset(self):
        self.stepped = []
        return dict(self.obs[0])

    def step(self, action):
        self.stepped.append(np.asarray(action, np.float64))
        n = len(self.stepped)
        return dict(self.obs[n % len(self.obs)]), 0.0, n == EPISODE_STEPS, {}


def test_robosuite_episode_matches_jax(ckpts, jax_fp32):
    import experiments.robot.robosuite.run_robosuite_eval as J

    from openvla_oft_tpu_torch.experiments.robot.robosuite import run_robosuite_eval as P

    kw = dict(pretrained_checkpoint=ckpts["ur5e"])
    j_cfg, p_cfg = J.GenerateConfig(**kw), P.GenerateConfig(**kw, device="cpu")
    (j_model, j_proc, j_head, j_proprio), (p_model, p_proc, p_head, p_proprio) = \
        _policies(j_cfg, p_cfg)
    assert p_model.platform.name == "ur5e" and p_model.platform.proprio_dim == 6
    envs = {}
    for side, mod, cfg, args in (("jax", J, j_cfg, (j_model, j_proc, j_head, j_proprio)),
                                 ("port", P, p_cfg, (p_model, p_proc, p_head, p_proprio))):
        envs[side] = env = _RobosuiteEnv(12)
        assert mod.run_episode(cfg, env, *args, "Pick the green box and place it into the "
                               "first bin") is False
        assert len(env.stepped) == EPISODE_STEPS                       # 3 queries of 8
    got, want = np.stack(envs["port"].stepped), np.stack(envs["jax"].stepped)
    np.testing.assert_allclose(got[:, :6], want[:, :6], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[:, 6], want[:, 6])
    assert set(np.unique(got[:, 6])) <= {-1.0, 1.0}
