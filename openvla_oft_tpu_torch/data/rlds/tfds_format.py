"""TFDS-format RLDS datasets (the OXE on-disk layout), read without TensorFlow.

Port of `openvla_oft_tpu/data/rlds/tfds_format.py`. TFDS writes RLDS
episodes as TFRecord shards (`<name>-train.tfrecord-00000-of-000NN`), one
`tf.train.Example` an episode, whose keys flatten the nested `steps`:

    steps/observation/<image_key> : bytes, one a step (an encoded image)
    steps/observation/state       : floats (T * state_dim)
    steps/action                  : floats (T * action_dim)
    steps/language_instruction    : bytes, one a step

The records are read by `data/rlds/tfrecord.py` (`read_tfrecords`, each
record's CRCs checked; `parse_example`) in place of `tf.data` and
`tf.io.parse_single_example`: a feature the record lacks reads as an empty
list, as a `VarLenFeature` reads it. The OXE registry (`data/rlds/oxe/`)
names each dataset's image and state keys; the structured-feature plans
below cover the datasets whose standardization transforms read dict
actions or string and int observations. `convert_tfds_to_native` writes the
port's native episode format (`data/rlds/pipeline.py::
write_episode_tfrecords`) with its `native_format.json` marker, which the
pipeline then reads as any native dir.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from openvla_oft_tpu_torch.constants import PlatformSpec
from openvla_oft_tpu_torch.data.rlds import tfrecord
from openvla_oft_tpu_torch.data.rlds.oxe import OXE_DATASET_CONFIGS
from openvla_oft_tpu_torch.data.rlds.pipeline import _assemble_proprio


def find_tfds_files(root: str, name: str, split: str = "train") -> List[str]:
    """The TFDS shard files under `<root>/<name>[/<version>[/...]]/`."""
    for pattern in (os.path.join(root, name, f"*{split}.tfrecord*"),
                    os.path.join(root, name, "*", f"*{split}.tfrecord*"),
                    os.path.join(root, name, "*", "*", f"*{split}.tfrecord*")):
        files = sorted(glob.glob(pattern))
        if files:
            return files
    return []


# Raw float observation keys that commonly hold proprio in OXE datasets,
# probed besides the registry's state keys: the standardization transforms
# make keys such as EEF_state from these.
_RAW_STATE_CANDIDATES = (
    "state", "proprio", "robot_obs", "robot_state", "cartesian_position",
    "gripper_position", "eef_pose", "joint_state", "end_effector_cartesian_pos",
    "end_effector_pose", "tcp_pose",
)

# === Structured-feature plans (the JAX module's, entry for entry) ===
#   action:      steps/action/<k> -> traj["action"][k]   (dict action; ":scalar"
#                keys are one value a step, 1-D)
#   action_dict: steps/action_dict/<k> -> traj["action_dict"][k]   (droid)
#   obs_string:  per-step string observations (language, ZLIB blobs)
#   obs_int:     per-step int observations (language_table's codepoints)
_WVRD = {"world_vector": "float32", "rotation_delta": "float32"}
_RT1_ACT = {**_WVRD, "gripper_closedness_action": "float32"}
_NLI = ["natural_language_instruction"]
_TFDS_FEATURE_PLANS: Dict[str, Dict] = {
    "fractal20220817_data": {"action": _RT1_ACT, "obs_string": _NLI},
    "kuka": {"action": _RT1_ACT, "obs_string": _NLI + [
        "clip_function_input/base_pose_tool_reached", "gripper_closed"]},
    "bridge_oxe": {"action": {**_WVRD, "open_gripper": "int64:scalar"},
                   "obs_string": _NLI},
    "taco_play": {"action": {"rel_actions_world": "float32"}, "obs_string": _NLI},
    "jaco_play": {"action": {"world_vector": "float32",
                             "gripper_closedness_action": "float32"},
                  "obs_string": _NLI},
    "berkeley_cable_routing": {"action": dict(_WVRD), "obs_string": _NLI},
    "roboturk": {"action": _RT1_ACT, "obs_string": _NLI},
    "nyu_door_opening_surprising_effectiveness": {"action": _RT1_ACT, "obs_string": _NLI},
    "viola": {"action": {**_WVRD, "gripper_closedness_action": "float32:scalar"},
              "obs_string": _NLI},
    "berkeley_autolab_ur5": {
        "action": {**_WVRD, "gripper_closedness_action": "float32:scalar"},
        "obs_string": _NLI},
    "toto": {"action": {**_WVRD, "open_gripper": "int64:scalar"}, "obs_string": _NLI},
    "language_table": {"obs_int": ["instruction"]},
    "dlr_shared_control": {"obs_string": _NLI},
    "bc_z": {"action": {"future/xyz_residual": "float32",
                        "future/axis_angle_residual": "float32",
                        "future/target_close": "int64"},
             "obs_string": _NLI},
    "robo_net": {"obs_string": _NLI},
    "pusht": {"action": {**_WVRD, "gripper_closedness_action": "float32:scalar"},
              "obs_string": _NLI},
    "rh20t": {"action": {"tcp_base": "float32", "gripper": "float32:scalar"}},
    "droid": {"action_dict": {"cartesian_velocity": "float32",
                              "gripper_position": "float32"}},
    "droid_wipe": {"action_dict": {"cartesian_velocity": "float32",
                                   "gripper_position": "float32"}},
}

# A plan's dtype name -> the parsed feature's kind and numpy dtype.
_KINDS = {"float32": ("float", np.float32), "int64": ("int64", np.int64),
          "string": ("bytes", object)}


def tfds_feature_keys(name: str) -> Dict:
    """The dataset's TFDS image and state keys from the OXE registry."""
    cfg = OXE_DATASET_CONFIGS.get(name)
    image_keys = dict(cfg.image_obs_keys) if cfg else {"primary": "image"}
    state_keys = [k for k in (cfg.state_obs_keys if cfg else ()) if k]
    return {"image_keys": image_keys, "state_keys": state_keys}


def _var_len(ex: Dict, key: str, dtype: str) -> np.ndarray:
    """A `VarLenFeature` densified: the feature's values as an array of the
    dtype ("float32", "int64" or "string"), empty where the record lacks it."""
    kind, np_dtype = _KINDS[dtype]
    if key not in ex:
        return np.zeros(0, np_dtype)
    got, values = ex[key]
    if got != kind and len(values):
        raise ValueError(f"feature {key!r} holds a {got} list, expected {kind}")
    if kind == "bytes":
        out = np.empty(len(values), object)
        out[:] = [bytes(v) for v in values]
        return out
    return np.asarray(values, np_dtype)


def parse_tfds_episode(record_bytes: bytes, name: str, platform: PlatformSpec,
                       keep_raw_state: bool = False) -> Dict:
    """One TFDS RLDS episode record -> a numpy episode dict.

    With `keep_raw_state`, every float observation key present is kept on
    its own, under its raw name (the layout the standardization transforms
    read); otherwise the registry's state keys are concatenated into
    `proprio` and the images are keyed by alias (`image_primary`, ...)."""
    ex = tfrecord.parse_example(record_bytes)
    keys = tfds_feature_keys(name)
    plan = _TFDS_FEATURE_PLANS.get(name, {})
    non_float = set(plan.get("obs_string", [])) | set(plan.get("obs_int", []))
    float_keys = [k for k in keys["state_keys"] if k not in non_float]
    if keep_raw_state:
        float_keys += [k for k in _RAW_STATE_CANDIDATES
                       if k not in float_keys and k not in non_float]

    out: Dict = {"observation": {}}
    actions = _var_len(ex, "steps/action", "float32")
    t = None
    for alias, obs_key in keys["image_keys"].items():
        if not obs_key:
            continue
        imgs = _var_len(ex, f"steps/observation/{obs_key}", "string")
        if len(imgs):
            out["observation"][obs_key if keep_raw_state else f"image_{alias}"] = list(imgs)
            t = len(imgs)
    if t is None:
        raise ValueError(f"no image steps parsed for {name}")
    if plan.get("action"):
        act = {}
        for sub, dt in plan["action"].items():
            arr = _var_len(ex, f"steps/action/{sub}", dt.split(":")[0])
            act[sub] = arr.reshape(t) if dt.endswith(":scalar") else arr.reshape(t, -1)
        out["action"] = act
    else:
        out["action"] = actions.reshape(t, -1)
    if plan.get("action_dict"):
        out["action_dict"] = {
            sub: _var_len(ex, f"steps/action_dict/{sub}", dt.split(":")[0]).reshape(t, -1)
            for sub, dt in plan["action_dict"].items()}
    for sk in plan.get("obs_string", []):
        arr = _var_len(ex, f"steps/observation/{sk}", "string")
        if len(arr):
            out["observation"][sk] = arr
    for sk in plan.get("obs_int", []):
        arr = _var_len(ex, f"steps/observation/{sk}", "int64")
        if arr.size:
            out["observation"][sk] = arr.reshape(t, -1)
    lang = _var_len(ex, "steps/language_instruction", "string")
    out["language_instruction"] = lang[0] if len(lang) else b""
    if keep_raw_state:
        for sk in float_keys:
            arr = _var_len(ex, f"steps/observation/{sk}", "float32")
            if arr.size:
                out["observation"][sk] = arr.reshape(t, -1)
    else:
        states = [arr.reshape(t, -1) for arr in
                  (_var_len(ex, f"steps/observation/{sk}", "float32") for sk in float_keys)
                  if arr.size]
        if states:
            out["observation"]["proprio"] = np.concatenate(states, axis=1)
    return out


def iterate_tfds_episodes(root: str, name: str, platform: PlatformSpec,
                          split: str = "train", shuffle_seed: Optional[int] = None,
                          repeat: bool = False,
                          keep_raw_state: bool = False) -> Iterator[Dict]:
    """The episodes of a TFDS RLDS dataset dir, shard by shard in file order
    (shuffled by `shuffle_seed`), forever with `repeat`."""
    files = find_tfds_files(root, name, split)
    if not files:
        raise FileNotFoundError(f"no TFDS shards for {name!r} ({split}) under {root}")
    while True:
        order = list(files)
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed).shuffle(order)
        for path in order:
            for rec in tfrecord.read_tfrecords(path):
                yield parse_tfds_episode(rec, name, platform, keep_raw_state=keep_raw_state)
        if not repeat:
            return


def _lang_str(lang) -> str:
    """An episode's instruction as a str: a transform may leave scalar bytes
    or str, or a per-step array (language_table decodes codepoints a step)."""
    if isinstance(lang, np.ndarray) and lang.ndim > 0:
        lang = lang[0] if len(lang) else b""
    if isinstance(lang, np.ndarray):
        lang = lang.item()
    return lang.decode() if isinstance(lang, bytes) else str(lang)


def convert_tfds_to_native(root: str, name: str, platform: PlatformSpec, out_dir: str,
                           split: str = "train", max_episodes: Optional[int] = None,
                           standardize: bool = True) -> int:
    """Convert a TFDS RLDS dataset to the native episode format once; returns
    the number of episodes written.

    With `standardize` (the default) the OXE registry's transform for `name`
    runs during the conversion, so the actions land on disk standardized,
    and the `native_format.json` marker tells the pipeline not to apply it
    again. An unregistered name raises unless `standardize=False`."""
    from openvla_oft_tpu_torch.data.rlds.oxe import OXE_STANDARDIZATION_TRANSFORMS
    from openvla_oft_tpu_torch.data.rlds.pipeline import write_episode_tfrecords

    fn = None
    if standardize:
        if name not in OXE_STANDARDIZATION_TRANSFORMS:
            raise KeyError(f"no standardization transform registered for {name!r}; "
                           "pass standardize=False to convert raw intentionally")
        fn = OXE_STANDARDIZATION_TRANSFORMS[name]
    cfg = OXE_DATASET_CONFIGS.get(name)
    episodes = []
    for ep in iterate_tfds_episodes(root, name, platform, split,
                                    keep_raw_state=fn is not None):
        if fn is not None:
            ep = fn(ep)
            # raw image keys -> their aliases, after the transform (which may
            # swap cameras, as droid's does)
            obs = ep["observation"]
            for alias, obs_key in (cfg.image_obs_keys if cfg else {}).items():
                if obs_key and obs_key in obs:
                    obs[f"image_{alias}"] = obs.pop(obs_key)
        t = len(ep["action"])
        obs = ep["observation"]
        proprio = _assemble_proprio(obs, name, t)
        native = {
            "images": list(obs["image_primary"])[:t],
            "actions": np.asarray(ep["action"], np.float32),
            "proprio": np.asarray(proprio if proprio is not None
                                  else np.zeros((t, platform.proprio_dim)), np.float32)[:t],
            "language_instruction": _lang_str(ep["language_instruction"]),
        }
        if "image_wrist" in obs:
            native["wrist_images"] = list(obs["image_wrist"])[:t]
        episodes.append(native)
        if max_episodes and len(episodes) >= max_episodes:
            break
    write_episode_tfrecords(out_dir, episodes)
    with open(os.path.join(out_dir, "native_format.json"), "w") as f:
        json.dump({"standardized": fn is not None,
                   "transform": getattr(fn, "__name__", None)}, f)
    return len(episodes)
