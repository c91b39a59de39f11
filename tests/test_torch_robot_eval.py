"""The port's robot eval clients: the pure logic, the resizes and the
client loops that need no JAX policy.

The mirror of `tests/test_robot_envs.py` and `tests/test_robosuite_collect.py`
(the hardware and simulator stacks import lazily, the env builders are
injected), of `test_finetune_cli.py::test_eval_harnesses_importable` and
`test_policy_diffusion.py::test_libero_eval_helpers`. Beyond them:
`crop_front_image` bitwise PIL's BILINEAR (PIL imported here only); the
ALOHA, preprocessing and Bridge resizes against JAX's and TF's functions
within `tests/test_torch_serve.py`'s bound (at most 1 level on at most 0.1%
of pixels); the PNG frames of the LIBERO rollout writer through PIL;
`state_to_eep` against scipy's `Rotation`; the ALOHA client over the port's
stdlib server, with `input` patched, sending the server's answers; and the
Bridge client (`eval_bridge`, the discrete head) stepping what
`get_vla_action` and its gripper conventions give.
"""

import pickle
import socket
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_oft_tpu_torch.experiments.robot.aloha import constants as AC
from openvla_oft_tpu_torch.experiments.robot.robosuite import robosuite_utils as RU


def _within_one_level(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# --- tests/test_robot_envs.py ---------------------------------------------

def test_aloha_modules_import_without_ros():
    import openvla_oft_tpu_torch.experiments.robot.aloha.constants  # noqa: F401
    import openvla_oft_tpu_torch.experiments.robot.aloha.real_env  # noqa: F401
    import openvla_oft_tpu_torch.experiments.robot.aloha.robot_utils  # noqa: F401


def test_aloha_gripper_conversions_roundtrip():
    for x in np.linspace(0, 1, 7):
        np.testing.assert_allclose(
            AC.puppet_gripper_position_normalize(AC.puppet_gripper_position_unnormalize(x)), x,
            atol=1e-12)
        np.testing.assert_allclose(
            AC.master_gripper_joint_normalize(AC.master_gripper_joint_unnormalize(x)), x,
            atol=1e-12)
    np.testing.assert_allclose(AC.master2puppet_position(AC.MASTER_GRIPPER_POSITION_OPEN),
                               AC.PUPPET_GRIPPER_POSITION_OPEN, atol=1e-12)
    np.testing.assert_allclose(AC.master2puppet_joint(AC.MASTER_GRIPPER_JOINT_CLOSE),
                               AC.PUPPET_GRIPPER_JOINT_CLOSE, atol=1e-12)
    np.testing.assert_allclose(AC.puppet_joint2pos(AC.puppet_pos2joint(0.03)), 0.03, atol=1e-12)
    assert AC.PUPPET_GRIPPER_POSITION_NORMALIZE_FN is AC.puppet_gripper_position_normalize


def test_aloha_constants_match_jax():
    from experiments.robot.aloha import constants as JAC

    names = [n for n in dir(JAC) if n.isupper() and n != "DATA_DIR"]
    assert names and all(getattr(AC, n) == getattr(JAC, n) for n in names
                         if not callable(getattr(JAC, n)))
    for x in np.linspace(-0.5, 1.5, 9):
        for fn in ("master2puppet_joint", "puppet_pos2joint", "master_joint2pos",
                   "puppet_gripper_velocity_normalize"):
            assert getattr(AC, fn)(x) == getattr(JAC, fn)(x)


def test_aloha_interpolation_profile():
    from openvla_oft_tpu_torch.experiments.robot.aloha.robot_utils import interpolate_trajectory

    traj = interpolate_trajectory([[0.0, 0.0]], [[1.0, -2.0]], num_steps=5)
    assert traj.shape == (5, 1, 2)
    np.testing.assert_allclose(traj[0, 0], [0.0, 0.0])
    np.testing.assert_allclose(traj[-1, 0], [1.0, -2.0])
    np.testing.assert_allclose(np.diff(traj[:, 0, 0]), 0.25)


def test_aloha_split_action():
    from openvla_oft_tpu_torch.experiments.robot.aloha.real_env import split_action

    left, right = split_action(np.arange(14.0))
    np.testing.assert_array_equal(left, np.arange(7.0))
    np.testing.assert_array_equal(right, np.arange(7.0, 14.0))


def test_bridge_obs_conversions():
    from openvla_oft_tpu_torch.constants import BRIDGE
    from openvla_oft_tpu_torch.experiments.robot.bridge.widowx_env import (
        START_ROTATION, convert_obs, null_obs, start_transform)

    im = 8
    raw = {"image": np.arange(3 * im * im, dtype=np.float64).reshape(3, im, im) / (3 * im * im),
           "full_image": np.zeros((480, 640, 3), np.uint8),
           "state": np.arange(7, dtype=np.float64)}
    obs = convert_obs(raw, im)
    assert obs["image_primary"].shape == (im, im, 3) and obs["image_primary"].dtype == np.uint8
    np.testing.assert_array_equal(obs["proprio"], [0, 1, 2, 3, 4, 5, 6])
    assert obs["proprio"].shape[0] == BRIDGE.proprio_dim
    nu = null_obs(im)
    assert nu["image_primary"].shape == (im, im, 3) and nu["proprio"].shape == (7,)
    t = start_transform([0.1, 0.2, 0.3])
    assert t.shape == (4, 4)
    np.testing.assert_allclose(t[:3, 3], [0.1, 0.2, 0.3])
    np.testing.assert_allclose(t[:3, :3], START_ROTATION)
    np.testing.assert_allclose(t[3], [0, 0, 0, 1])
    np.testing.assert_allclose(START_ROTATION @ START_ROTATION.T, np.eye(3), atol=2e-3)


@pytest.mark.parametrize("zangle", [0.0, 0.4, -1.3, np.pi, 2.9])
def test_bridge_state_to_eep_matches_scipy(zangle):
    """The numpy quaternions give pyquaternion's pose: Rz(zangle) applied to
    the default rotation, against scipy's `Rotation`."""
    from scipy.spatial.transform import Rotation

    from openvla_oft_tpu_torch.experiments.robot.bridge.widowx_env import state_to_eep

    default = np.array([[0, 0, 1.0], [0, 1.0, 0], [-1.0, 0, 0]])
    pose = state_to_eep([0.3, 0.0, 0.15], zangle)
    want = (Rotation.from_euler("z", zangle) * Rotation.from_matrix(default)).as_matrix()
    assert pose.shape == (4, 4)
    np.testing.assert_allclose(pose[:3, 3], [0.3, 0.0, 0.15])
    np.testing.assert_allclose(pose[3], [0, 0, 0, 1])
    np.testing.assert_allclose(pose[:3, :3], want, atol=1e-12)
    np.testing.assert_allclose(pose[:3, :3] @ pose[:3, :3].T, np.eye(3), atol=1e-12)


def test_robosuite_create_video(tmp_path):
    from openvla_oft_tpu_torch.experiments.robot.robosuite.create_video import render_rollout

    traj = [{"obs": {"task_description": "pick the red block",
                     "camera_front_image": np.random.default_rng(0).integers(
                         0, 255, (64, 80, 3)).astype(np.uint8)}} for _ in range(4)]
    pkl_path = tmp_path / "traj000.pkl"
    with open(pkl_path, "wb") as f:
        pickle.dump(traj, f)
    out = render_rollout(str(pkl_path), str(tmp_path))
    assert Path(out).exists() and Path(out).stat().st_size > 0


def test_robosuite_rotation_helpers_match_scipy():
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        r = Rotation.from_quat(q)
        np.testing.assert_allclose(RU.quat2mat(q), r.as_matrix(), atol=1e-10)
        np.testing.assert_allclose(np.abs(RU.mat2quat(r.as_matrix()) @ q), 1.0, atol=1e-10)
        e = rng.uniform(-3, 3, 3)
        np.testing.assert_allclose(RU.euler2mat(e), Rotation.from_euler("xyz", e).as_matrix(),
                                   atol=1e-10)
        m = Rotation.random(random_state=rng.integers(1 << 30)).as_matrix()
        np.testing.assert_allclose(RU.euler2mat(RU.mat2euler(m)), m, atol=1e-9)
        np.testing.assert_allclose(RU.quat2axisangle(q if q[3] >= 0 else -q), r.as_rotvec(),
                                   atol=1e-9)


def test_robosuite_action_world_conversion():
    eef = np.array([0.1, -0.2, 0.9])
    action = np.array([0.02, -0.01, 0.03, 0.3, -0.2, 0.1, 0.99])
    world, closed = RU.convert_action_to_world(action, eef)
    np.testing.assert_allclose(world[:3], eef + action[:3])
    np.testing.assert_allclose(
        world[3:6], RU.quat2axisangle(RU.mat2quat(RU.euler2mat(-action[3:6]))))
    assert world[6] == 1.0 and closed == 1.0
    world2, closed2 = RU.convert_action_to_world(np.array([0, 0, 0, 0, 0, 0, 0.5]), eef,
                                                 abs_pose=True)
    np.testing.assert_allclose(world2[:3], [0, 0, 0])
    assert world2[6] == -1.0 and closed2 == 0.0


def test_robosuite_crop_and_obs_layout():
    img = np.random.default_rng(0).integers(0, 255, (200, 360, 3)).astype(np.uint8)
    assert RU.crop_front_image(img, "pick_place", out_size=224).shape == (224, 224, 3)
    obs = {"camera_front_image": img[:100, :100], "eye_in_hand_image": img[:100, :100],
           "eef_pos": np.array([0.1, 0.2, 0.3]), "eef_quat": np.array([0.0, 0.0, 0.0, 1.0]),
           "joint_pos": np.zeros(6)}
    o = RU.prepare_observation(obs, resize_size=64, gripper_closed=1.0, device="cpu")
    assert o["full_image"].shape == (64, 64, 3) and o["eef_pose"].shape == (6,)
    np.testing.assert_allclose(o["eef_pose"][:3], [0.1, 0.2, 0.3])
    assert o["gripper_closed"] == 1.0 and o["state"].shape == (6,)
    # the eye-in-hand frame is flipped left-right before its resize
    np.testing.assert_array_equal(o["wrist_image"], o["camera_gripper_image"])


def test_robosuite_env_adapter_wiring():
    assert RU.ROBOSUITE_TASK_MAP["pick_place"]["num_variations"] == 16
    assert RU.ROBOSUITE_TASK_MAP["pick_place"]["agent-teacher"][0] == "UR5e_PickPlaceDistractor"
    assert RU.ROBOSUITE_TASK_MAP["pick_place"]["object_set"] == 2
    assert RU.OSC_POSE_CONTROLLER["type"] == "OSC_POSE" and RU.OSC_POSE_CONTROLLER["kp"] == 150
    assert RU.OSC_POSE_CONTROLLER["control_delta"] is True
    try:
        import robosuite  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="robosuite"):
            RU.build_env_context("ur5e_pick_place", "", 0, 7)


# --- tests/test_robosuite_collect.py ----------------------------------------

class _FakeTraj(list):
    def get(self, t):
        return self[t]


def _fake_expert(env_type, **kwargs):
    return _FakeTraj([{"action": np.linspace(-1, 1, 7) * (t + 1) * 0.1, "obs": {}}
                      for t in range(8)])


def test_save_rollout_protocol(tmp_path):
    from openvla_oft_tpu_torch.experiments.robot.robosuite.collect_data.collect_task import (
        TASK_COMMAND, make_seed_schedule, save_rollout)

    n_tasks, per_group = 9, 2
    written = save_rollout(
        list(range(6)), task_name="nut_assembly", env_type="Panda_NutAssemblyDistractor",
        env_func=_fake_expert, save_dir=str(tmp_path), n_tasks=n_tasks,
        seeds=make_seed_schedule(6, n_tasks, per_group), n_per_group=per_group, object_set=1,
        controller_loader=lambda c: {"type": c})
    assert sorted(Path(p).parent.name for p in written) == [
        "task_00", "task_00", "task_01", "task_01", "task_02", "task_02"]
    with open(written[0], "rb") as f:
        rec = pickle.load(f)
    assert set(rec) == {"traj", "len", "env_type", "command", "task_id"}
    assert rec["len"] == 8 and rec["env_type"] == "Panda_NutAssemblyDistractor"
    assert rec["command"] == TASK_COMMAND["nut_assembly"]["0"]
    assert sorted(Path(p).name for p in written if "task_00" in p) == ["traj000.pkl",
                                                                      "traj001.pkl"]


def test_seed_schedule_and_commands_match_jax():
    from experiments.robot.robosuite.collect_data import collect_task as J

    from openvla_oft_tpu_torch.experiments.robot.robosuite.collect_data import collect_task as P

    base = 263237945
    assert P.make_seed_schedule(8, n_tasks=2, per_task_group=2) == [
        base + (i // 4) * 2 + i % 2 for i in range(8)]
    assert P.make_seed_schedule(3, 2, 2, random_seed=True) == [None] * 3
    fixed = P.make_seed_schedule(5, 2, 2, n_env=3)
    assert all(base <= s < base + 3 for s in fixed)
    assert fixed == J.make_seed_schedule(5, 2, 2, n_env=3)
    # the port's own copy of command.json is the fork's
    assert P.TASK_COMMAND == J.TASK_COMMAND and P.TASK_ENV_MAP == J.TASK_ENV_MAP


def test_task_instruction_reads_the_object_sets_commands():
    """The UR5e client's instruction comes from command.json: pick-place's
    object set 2 (the boxes, the default) is its "pick_place" entry, where
    the JAX copy looks up "pick_place_set_2", which command.json lacks."""
    from experiments.robot.robosuite import run_robosuite_eval as J

    from openvla_oft_tpu_torch.experiments.robot.robosuite import run_robosuite_eval as R

    cfg = R.GenerateConfig()
    assert [R.task_instruction(cfg, v) for v in (0, 15)] == [
        "Pick the green box and place it into the first bin",
        "Pick the red box and place it into the fourth bin"]
    assert R.task_instruction(R.GenerateConfig(object_set=1), 12) == \
        "Pick the can and place it into the first bin"
    with pytest.raises(KeyError, match="pick_place_set_2"):
        J.task_instruction(J.GenerateConfig(), 0)


def test_action_quantize_roundtrip():
    from openvla_oft_tpu_torch.experiments.robot.robosuite.collect_data.rollout_trajectory import (
        NORMALIZATION_RANGES, denormalize_action, normalize_action, quantize_roundtrip)

    rng = np.random.default_rng(0)
    lo, hi = NORMALIZATION_RANGES[:, 0], NORMALIZATION_RANGES[:, 1]
    for _ in range(20):
        a = np.concatenate([rng.uniform(lo, hi), [rng.choice([-1.0, 1.0])]])
        out = quantize_roundtrip(a)
        assert np.all(np.abs(out[:-1] - a[:-1]) <= (hi - lo) / 256.0 + 1e-9)
        assert np.sign(out[-1]) == np.sign(a[-1])
    n = normalize_action(np.concatenate([lo, [1.0]]), 256, NORMALIZATION_RANGES)
    assert np.allclose(n[:-1] * 128, np.round(n[:-1] * 128))
    assert np.allclose(denormalize_action(np.full(7, 5.0), NORMALIZATION_RANGES)[:6], hi)


# --- the harnesses ----------------------------------------------------------

def test_eval_harnesses_importable():
    """The clients import without their sim and robot stacks, and the gated
    ones raise a clear ImportError."""
    import openvla_oft_tpu_torch.experiments.robot.aloha.run_aloha_eval as aloha
    import openvla_oft_tpu_torch.experiments.robot.bridge.run_bridgev2_eval as bridge
    import openvla_oft_tpu_torch.experiments.robot.libero.run_libero_eval as libero
    import openvla_oft_tpu_torch.experiments.robot.robosuite.run_robosuite_eval as robosuite
    from openvla_oft_tpu_torch.experiments.robot.aloha.aloha_utils import make_real_env
    from openvla_oft_tpu_torch.experiments.robot.bridge.bridgev2_utils import get_widowx_env

    assert aloha.STEP_DURATION_IN_SEC == 1.0 / 25.0
    assert libero.TASK_MAX_STEPS["libero_10"] == 520
    assert hasattr(bridge, "eval_bridge") and hasattr(robosuite, "eval_robosuite")
    for cls in (aloha.GenerateConfig, bridge.GenerateConfig, libero.GenerateConfig,
                robosuite.GenerateConfig):
        assert cls().device == "cuda"
    with pytest.raises(ImportError, match="ALOHA"):
        make_real_env()
    with pytest.raises(ImportError, match="widowx_envs"):
        bridge.get_widowx_env(bridge.GenerateConfig())
    with pytest.raises(ImportError):
        get_widowx_env(bridge.GenerateConfig())


def test_libero_eval_helpers(rng):
    from openvla_oft_tpu_torch.experiments.robot.libero.libero_utils import quat2axisangle
    from openvla_oft_tpu_torch.experiments.robot.libero.run_libero_eval import (
        GenerateConfig, prepare_observation, process_action, validate_config)

    np.testing.assert_allclose(quat2axisangle(np.asarray([0, 0, 0, 1.0])), np.zeros(3),
                               atol=1e-9)
    q = np.asarray([0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)])
    np.testing.assert_allclose(quat2axisangle(q), [0, 0, np.pi / 2], atol=1e-6)
    obs = {"agentview_image": (rng.random((64, 64, 3)) * 255).astype(np.uint8),
           "robot0_eye_in_hand_image": (rng.random((64, 64, 3)) * 255).astype(np.uint8),
           "robot0_eef_pos": np.zeros(3), "robot0_eef_quat": np.asarray([0, 0, 0, 1.0]),
           "robot0_gripper_qpos": np.asarray([0.02, -0.02])}
    observation, img = prepare_observation(obs, 224)
    assert observation["state"].shape == (8,) and observation["full_image"].shape == (64, 64, 3)
    np.testing.assert_array_equal(img, obs["agentview_image"][::-1, ::-1])
    assert process_action(np.asarray([0.1, 0, 0, 0, 0, 0, 0.9]), "openvla")[-1] == -1.0
    validate_config(GenerateConfig(pretrained_checkpoint="x--image_aug", center_crop=True))
    with pytest.raises(AssertionError):
        validate_config(GenerateConfig(pretrained_checkpoint=""))


# --- PIL's BILINEAR, the resizes, the PNG frames ----------------------------

@pytest.mark.parametrize("task", sorted(RU.TASK_CROP))
def test_crop_front_image_is_pil_bilinear(task):
    from PIL import Image

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (200, 360, 3), dtype=np.uint8)
    img[:40] = 255                                     # saturated rows test the clip
    top, bottom, left, right = RU.TASK_CROP[task]
    want = np.asarray(Image.fromarray(img[top:200 - bottom, left:360 - right]).resize(
        (224, 224), Image.BILINEAR))
    np.testing.assert_array_equal(RU.crop_front_image(img, task), want)


@pytest.mark.parametrize("hw,out", [((480, 640), (224, 224)), ((200, 360), (97, 211)),
                                    ((50, 300), (224, 37))],
                         ids=["downscale", "down-ragged", "up-down"])
def test_bilinear_resize_is_pil_bilinear(hw, out):
    from PIL import Image

    img = np.random.default_rng(2).integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((out[1], out[0]), Image.BILINEAR))
    np.testing.assert_array_equal(RU.bilinear_resize(img, out[1], out[0]), want)


@pytest.mark.parametrize("hw", [(224, 224), (480, 640), (200, 360)])
def test_aloha_resize_matches_jax(hw):
    from experiments.robot.aloha.aloha_utils import resize_image_for_policy as jax_resize

    from openvla_oft_tpu_torch.experiments.robot.aloha.aloha_utils import resize_image_for_policy

    img = np.random.default_rng(3).integers(0, 256, (*hw, 3), dtype=np.uint8)
    _within_one_level(resize_image_for_policy(img, 224, device="cpu"),
                      np.asarray(jax_resize(img, 224)))


def test_preprocess_resize_frames_matches_jax():
    from experiments.robot.aloha.preprocess_split_aloha_data import resize_frames as jax_frames

    from openvla_oft_tpu_torch.experiments.robot.aloha.preprocess_split_aloha_data import (
        relative_actions, resize_frames)

    frames = np.random.default_rng(4).integers(0, 256, (3, 120, 160, 3), dtype=np.uint8)
    _within_one_level(resize_frames(frames, 64, device="cpu"), jax_frames(frames, 64))
    acts = np.cumsum(np.random.default_rng(5).standard_normal((6, 14)), 0)
    rel = relative_actions(acts)
    np.testing.assert_allclose(rel[:-1], acts[1:] - acts[:-1])
    np.testing.assert_array_equal(rel[-1], rel[-2])


def test_preprocess_split_writes_resized_episodes(tmp_path):
    h5py = pytest.importorskip("h5py")
    from openvla_oft_tpu_torch.experiments.robot.aloha.preprocess_split_aloha_data import (
        PreprocessConfig, preprocess, resize_frames)

    rng = np.random.default_rng(6)
    raw = tmp_path / "raw"
    raw.mkdir()
    cams = ("cam_high", "cam_left_wrist", "cam_right_wrist")
    for i in range(3):
        with h5py.File(raw / f"episode_{i}.hdf5", "w") as f:
            f.create_dataset("action", data=rng.standard_normal((4, 14)))
            f.create_dataset("observations/qpos", data=rng.standard_normal((4, 14)))
            for cam in cams:
                f.create_dataset(f"observations/images/{cam}",
                                 data=rng.integers(0, 256, (4, 48, 64, 3), dtype=np.uint8))
    preprocess(PreprocessConfig(dataset_path=str(raw), out_base_dir=str(tmp_path / "out"),
                                percent_val=0.34, out_image_size=32, device="cpu"))
    outs = sorted((tmp_path / "out").rglob("episode_*.hdf5"))
    assert [p.parent.name for p in outs] == ["train", "train", "val"]
    with h5py.File(outs[0], "r") as f:
        assert f["observations/images/cam_high"].shape == (4, 32, 32, 3)
        assert f["relative_action"].shape == (4, 14)


@pytest.mark.parametrize("hw,size", [((256, 256), (224, 224)), ((480, 640), (256, 256)),
                                     ((120, 160), (224, 200))])
def test_bridge_resize_image_matches_tf(hw, size):
    tf = pytest.importorskip("tensorflow")
    from openvla_oft_tpu_torch.experiments.robot.bridge.bridgev2_utils import resize_image

    img = np.random.default_rng(7).integers(0, 256, (*hw, 3), dtype=np.uint8)
    enc = tf.io.decode_image(tf.image.encode_jpeg(img), expand_animations=False, dtype=tf.uint8)
    want = tf.image.resize(enc, size, method="lanczos3", antialias=True)
    want = tf.cast(tf.clip_by_value(tf.round(want), 0, 255), tf.uint8).numpy()
    _within_one_level(resize_image(img, size, device="cpu"), want)


def test_png_frames_decode_through_pil(tmp_path, monkeypatch):
    from PIL import Image

    from openvla_oft_tpu_torch.experiments.robot.libero import libero_utils as LU

    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (33, 47, 3), dtype=np.uint8) for _ in range(45)]
    LU.write_png(str(tmp_path / "one.png"), frames[0])
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "one.png").convert("RGB")),
                                  frames[0])
    # Without imageio (as on the card's machine) the rollout is every
    # (45 // 20)-th frame as a PNG.
    monkeypatch.setitem(sys.modules, "imageio", None)
    path = LU.save_rollout_video(frames, 3, True, "put the bowl on the plate",
                                 rollout_dir=str(tmp_path / "rollouts"))
    pngs = sorted(Path(path).glob("*.png"))
    assert Path(path).name.startswith("episode=3--success--put_the_bowl") and len(pngs) == 23
    for i, p in enumerate(pngs):
        np.testing.assert_array_equal(np.asarray(Image.open(p)), frames[2 * i])
    with pytest.raises(ValueError):
        LU.write_png(str(tmp_path / "bad.png"), frames[0].astype(np.float32))


# --- the ALOHA and Bridge clients -------------------------------------------

def _tiny_policy(**kw):
    from openvla_oft_tpu_torch.serving.openvla_utils import get_vla

    return get_vla(types.SimpleNamespace(pretrained_checkpoint="random:tiny", device="cpu",
                                         **kw), dtype=torch.float32)


class _AlohaEnv:
    """The real ALOHA env's surface (reset, get_qpos, get_observation,
    step), replaying seeded 480 x 640 frames."""

    def __init__(self, rng, n_frames=3):
        self.frames = [{cam: rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                        for cam in ("cam_high", "cam_low", "cam_left_wrist", "cam_right_wrist")}
                       for _ in range(n_frames)]
        self.qpos = [rng.standard_normal(14) for _ in range(n_frames)]
        self.stepped, self.served = [], []

    def reset(self):
        return None

    def get_qpos(self):
        return self.qpos[0]

    def get_observation(self, t=0):
        obs = types.SimpleNamespace(observation={"images": self.frames[t % len(self.frames)],
                                                 "qpos": self.qpos[t % len(self.qpos)]})
        self.served.append(t)
        return obs

    def step(self, action):
        self.stepped.append(np.asarray(action))


def test_aloha_episode_sends_the_servers_answers(monkeypatch):
    from openvla_oft_tpu_torch.experiments.robot.aloha import run_aloha_eval as A
    from openvla_oft_tpu_torch.serving.deploy import build_server

    policy = _tiny_policy(num_images_in_input=3, use_film=True, task_suite_name="aloha",
                          fake_norm_stats=True)
    server = build_server(policy)
    port = _free_port()
    server._run_stdlib("127.0.0.1", port, background=True)
    answers = iter(["", "y"])
    monkeypatch.setattr(A, "input", lambda *a: next(answers), raising=False)
    monkeypatch.setattr(A, "time", types.SimpleNamespace(time=A.time.time, sleep=lambda s: None))
    env = _AlohaEnv(np.random.default_rng(9))
    cfg = A.GenerateConfig(max_steps=30, device="cpu")
    try:
        stats, replay = A.run_episode(cfg, env, "fold the towel",
                                      f"http://127.0.0.1:{port}/act")
    finally:
        server.shutdown()
    assert stats["success"] and stats["total_steps"] == 30 and len(replay) == 30
    assert len(env.stepped) == 30
    for start in (0, 25):                            # the two queries of 25 actions
        observation, *_ = A.prepare_observation(env.get_observation(t=start), 224, "cpu")
        want = server.predict(observation, "fold the towel")
        assert want.shape == (25, 14)
        got = np.stack(env.stepped[start:start + 25])
        np.testing.assert_array_equal(got, want[:len(got)])


class _WidowXClient:
    """The `widowx_envs` client's surface that `eval_bridge` drives."""

    def __init__(self, rng, n_frames=3):
        self.images = [rng.random(3 * 256 * 256) for _ in range(n_frames)]
        self.states = [rng.standard_normal(7) for _ in range(n_frames)]
        self.t, self.stepped, self.served = 0, [], []

    def reset(self):
        self.t = 0

    def get_observation(self):
        i = len(self.served) % len(self.images)
        self.served.append(i)
        return {"image": self.images[i], "state": self.states[i]}

    def step_action(self, action):
        self.stepped.append(np.asarray(action))


def test_bridge_client_steps_the_discrete_heads_actions(monkeypatch):
    from openvla_oft_tpu_torch.experiments.robot.bridge import run_bridgev2_eval as B
    from openvla_oft_tpu_torch.serving import openvla_utils as PU
    from openvla_oft_tpu_torch.serving.robot_utils import (invert_gripper_action,
                                                           normalize_gripper_action)

    client = _WidowXClient(np.random.default_rng(10))
    answers = iter(["wipe the table", "n", "quit"])
    monkeypatch.setattr(B, "input", lambda *a: next(answers), raising=False)
    monkeypatch.setattr(B, "get_widowx_env", lambda cfg: client)
    monkeypatch.setattr(B, "time", types.SimpleNamespace(time=B.time.time, sleep=lambda s: None))
    cfg = B.GenerateConfig(pretrained_checkpoint="random:tiny", max_steps=2, max_episodes=2,
                           device="cpu")
    assert B.eval_bridge(cfg) == 0.0
    assert len(client.stepped) == 2 * 5
    vla = PU.get_vla(cfg)
    assert vla.head == "discrete" and vla.platform.name == "bridge"
    for q, i in enumerate(client.served):
        obs = B.prepare_observation({"image": client.images[i], "state": client.states[i]})
        acts = PU.get_vla_action(cfg, vla, PU.get_processor(cfg), obs, "wipe the table")
        want = [invert_gripper_action(normalize_gripper_action(np.asarray(a))) for a in acts]
        np.testing.assert_array_equal(np.stack(client.stepped[5 * q:5 * q + 5]), np.stack(want))
