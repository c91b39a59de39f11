"""The port's OXE registry (`openvla_oft_tpu_torch/data/rlds/oxe/`) against
the JAX package's (`openvla_oft_tpu/data/rlds/oxe/`), case for case of
`tests/test_oxe_transforms.py`: every registered transform on the same
synthetic raw trajectory gives equal arrays on both sides; the configs,
mixtures, normalization masks and loading kwargs are equal; and each of
that file's semantic checks holds for the port's functions.
"""

import copy
import dataclasses

import numpy as np
import pytest

from openvla_oft_tpu.data.rlds import oxe as J
from openvla_oft_tpu.data.rlds.oxe import droid_utils as JD
from openvla_oft_tpu.data.rlds.oxe import materialize as JM
from openvla_oft_tpu_torch.data import transforms as PT
from openvla_oft_tpu_torch.data.rlds import oxe as P
from openvla_oft_tpu_torch.data.rlds.oxe import droid_utils as PD
from openvla_oft_tpu_torch.data.rlds.oxe import materialize as PM
from test_oxe_transforms import COVERED, T_, _DIM, _raw_traj


def by_name(x):
    """Functions by their name, recursively (each side has its own)."""
    if isinstance(x, dict):
        return {k: by_name(v) for k, v in x.items()}
    return x.__name__ if callable(x) else x


def assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("name", COVERED)
def test_transform_matches_jax(name):
    """The registered transform on the same raw trajectory, both sides."""
    raw = _raw_traj(name)
    want = J.OXE_STANDARDIZATION_TRANSFORMS[name](copy.deepcopy(raw))
    got = P.OXE_STANDARDIZATION_TRANSFORMS[name](copy.deepcopy(raw))
    if name.startswith("droid"):
        # the two exterior cameras swap at random (unseeded on both sides)
        pair = ("exterior_image_1_left", "exterior_image_2_left")
        for out in (got, want):
            imgs = sorted((out["observation"][k] for k in pair), key=lambda a: a.tobytes())
            out["observation"].update(zip(pair, imgs))
    assert_tree_equal(got, want)
    cfg = P.OXE_DATASET_CONFIGS[name]
    action = np.asarray(got["action"])
    assert action.shape[1] == _DIM[J.OXE_DATASET_CONFIGS[name].action_encoding]
    for key in cfg.state_obs_keys:
        if key is not None:
            assert len(np.asarray(got["observation"][key])) == action.shape[0]


def test_configs_mixtures_and_masks_match_jax():
    assert sorted(P.OXE_DATASET_CONFIGS) == sorted(J.OXE_DATASET_CONFIGS)
    for name, cfg in J.OXE_DATASET_CONFIGS.items():
        mine = P.OXE_DATASET_CONFIGS[name]
        for f in dataclasses.fields(cfg):
            a, b = getattr(cfg, f.name), getattr(mine, f.name)
            if f.name in ("state_encoding", "action_encoding"):
                assert (a.name, int(a)) == (b.name, int(b)), (name, f.name)
            elif f.name == "aux_kwargs":
                assert by_name(a) == by_name(b), name
            else:
                assert a == b, (name, f.name)
        assert JM.dataset_action_normalization_mask(name) == \
            PM.dataset_action_normalization_mask(name), name
        assert J.OXE_STANDARDIZATION_TRANSFORMS[name].__name__ == \
            P.OXE_STANDARDIZATION_TRANSFORMS[name].__name__, name
    assert P.OXE_NAMED_MIXTURES == J.OXE_NAMED_MIXTURES
    assert PM.dataset_action_normalization_mask("not_registered") is None


def test_dataset_kwargs_match_jax():
    for mix in ("rtx", "oxe_magic_soup_plus", "libero_4_task_suites_no_noops"):
        if mix not in J.OXE_NAMED_MIXTURES:
            continue
        want, w_want = J.get_oxe_dataset_kwargs_and_weights("/data", mix)
        got, w_got = P.get_oxe_dataset_kwargs_and_weights("/data", mix)
        assert w_got == w_want
        for a, b in zip(got, want):
            assert by_name(a) == by_name(b)


def test_coverage_spans_magic_soup_plus():
    for dname, _ in P.OXE_NAMED_MIXTURES["oxe_magic_soup_plus"]:
        assert dname in P.OXE_STANDARDIZATION_TRANSFORMS and dname in COVERED, dname


def test_libero_gripper_clip_invert():
    traj = _raw_traj("libero_spatial_no_noops")
    raw = np.asarray(traj["action"]).copy()
    out = P.OXE_STANDARDIZATION_TRANSFORMS["libero_spatial_no_noops"](traj)
    np.testing.assert_allclose(out["action"][:, -1], 1.0 - np.clip(raw[:, -1], 0, 1), atol=1e-6)
    np.testing.assert_allclose(out["action"][:, :6], raw[:, :6], atol=1e-6)
    assert out["observation"]["gripper_state"].shape[1] == 2


def test_rt1_gripper_rel2abs_range():
    out = P.OXE_STANDARDIZATION_TRANSFORMS["fractal20220817_data"](
        _raw_traj("fractal20220817_data"))
    g = out["action"][:, -1]
    assert ((g >= 0) & (g <= 1)).all()


def test_rel2abs_gripper_direction_matches_reference():
    rel = np.array([0.0, 0.0, 1.0, 0.0, -1.0])
    np.testing.assert_allclose(PT.rel2abs_gripper_actions(rel), [1.0, 1.0, 0.0, 0.0, 1.0])
    np.testing.assert_allclose(PT.rel2abs_gripper_actions(np.zeros(3)), [1.0, 1.0, 1.0])
    np.testing.assert_allclose(PT.rel2abs_gripper_actions(np.array([0.0, -1.0, 0.0])),
                               [0.0, 1.0, 1.0])


def test_bridge_truncation_and_relabel():
    traj = _raw_traj("bridge_orig")
    state = np.asarray(traj["observation"]["state"]).copy()
    out = P.OXE_STANDARDIZATION_TRANSFORMS["bridge_orig"](traj)
    assert out["action"].shape[0] == T_ - 2
    np.testing.assert_allclose(out["action"][:, :6], state[2:, :6] - state[1:-1, :6], atol=1e-6)
    assert set(np.unique(out["action"][:, -1])) <= {0.0, 1.0}


def test_droid_base_frame_actions():
    traj = _raw_traj("droid")
    vel = np.asarray(traj["action_dict"]["cartesian_velocity"]).copy()
    grip = np.asarray(traj["action_dict"]["gripper_position"]).copy()
    out = P.OXE_STANDARDIZATION_TRANSFORMS["droid"](traj)
    np.testing.assert_allclose(out["action"][:, :6], vel, atol=1e-6)
    np.testing.assert_allclose(out["action"][:, -1:], 1 - grip, atol=1e-6)
    assert out["observation"]["proprio"].shape == (T_, 7)


def test_droid_rotation_math_matches_jax():
    rng = np.random.default_rng(0)
    vel = rng.uniform(-0.5, 0.5, (5, 6))
    wrist = rng.uniform(-0.5, 0.5, (5, 6))
    e = rng.uniform(-1.0, 1.0, (7, 3))
    quat = rng.standard_normal((7, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    for fn, args in (("velocity_act_to_wrist_frame", (vel, wrist)), ("euler_to_rmat", (e,)),
                     ("rmat_to_euler", (JD.euler_to_rmat(e),)), ("quat_to_euler", (quat,)),
                     ("rotmat_to_rot6d", (JD.euler_to_rmat(e),)),
                     ("invert_rmat", (JD.euler_to_rmat(e),))):
        np.testing.assert_array_equal(getattr(PD, fn)(*args), getattr(JD, fn)(*args), err_msg=fn)
    out = PD.velocity_act_to_wrist_frame(vel, np.zeros((5, 6)))
    np.testing.assert_allclose(out[:, :3], vel[:, :3], atol=1e-6)
    np.testing.assert_allclose(PD.rmat_to_euler(PD.euler_to_rmat(e)), e, atol=1e-8)


def test_zero_action_filter():
    norm_zero = 2 * (0 - PD.DROID_Q01) / (PD.DROID_Q99 - PD.DROID_Q01 + 1e-8) - 1
    zeros = {"action": np.concatenate([np.tile(norm_zero, (4, 1)), np.ones((4, 1))], axis=1)}
    assert not PD.zero_action_filter(zeros)
    assert PD.zero_action_filter({"action": np.ones((4, 7))})
    np.testing.assert_array_equal(PD.DROID_Q01, JD.DROID_Q01)
    np.testing.assert_array_equal(PD.DROID_Q99, JD.DROID_Q99)


def test_every_mixture_member_resolves():
    members = {d for mix in P.OXE_NAMED_MIXTURES.values() for d, _ in mix}
    assert len(P.OXE_NAMED_MIXTURES) >= 21 and len(members) >= 50
    for name in sorted(members):
        cfg = P.OXE_DATASET_CONFIGS[name]
        encoding_ok = cfg.action_encoding.name in ("EEF_POS", "EEF_R6", "JOINT_POS_BIMANUAL")
        has_primary = cfg.image_obs_keys.get("primary") is not None or \
            "camera_front_image" in cfg.image_obs_keys
        views = ("camera_front_image",) if "camera_front_image" in cfg.image_obs_keys \
            else ("primary",)
        if encoding_ok and has_primary:
            kw = P.make_oxe_dataset_kwargs(name, "/data", load_camera_views=views)
            assert kw["standardize_fn"] is not None
            assert len(kw["absolute_action_mask"]) == len(kw["action_normalization_mask"])
        else:
            with pytest.raises(ValueError):
                P.make_oxe_dataset_kwargs(name, "/data")
