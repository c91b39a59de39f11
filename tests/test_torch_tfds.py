"""The port's TFDS-format reader and converter, and the weighted dataset mixture.

Mirrors `tests/test_tfds_format.py`: TFDS-layout shards written with
TensorFlow (`tf.io.TFRecordWriter`, `tf.train.Example`), as that test
writes them, for the five dataset families it covers (the raw LIBERO
layout, the RT-1 family's dict actions, language_table's codepoints, kuka's
ZLIB-compressed state, droid's action dict). The port's
`data/rlds/tfds_format.py`, which reads them without TF, gives the episodes
the JAX module gives (every array equal, image bytes byte for byte), and its
conversion the same native dirs: the same records feature for feature, the
same marker, and the pipeline's statistics over them.

Mirrors the mixture cases of `tests/test_rlds_pipeline.py` (:80, :352,
:385) on `data/rlds/pipeline.py::make_interleaved_iterator`: the members'
statistics equal JAX's; each member's share of the sampled frames within
0.06 of its normalised weight over 600 frames (three binomial standard
deviations at p = 0.25 are 0.053); `balance_weights` multiplying the
weights by the transition counts; and members whose frames differ in
structure (an OXE dataset whose proprio is 7 wide mixed with one whose
proprio is 8 wide) taking the host mix of separately decoded members. The order
of the samples is the port's own (numpy draws), not TF's.
"""

import io
import json
import os
import zlib

import numpy as np
import pytest

import openvla_oft_tpu.config as JC
from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.data.rlds import pipeline as JPL
from openvla_oft_tpu.data.rlds import tfds_format as JTF
from openvla_oft_tpu_torch.data.rlds import pipeline as PPL
from openvla_oft_tpu_torch.data.rlds import tfds_format as PTF
from openvla_oft_tpu_torch.data.rlds.tfrecord import parse_example, read_tfrecords
from test_torch_import import port_platform

tf = pytest.importorskip("tensorflow")

SIZE = JC.TINY_DINOV2.image_size
PLAT = port_platform(LIBERO)
# A registered OXE name whose state_obs_keys assemble a 7-dim proprio.
NYU_ROT = "nyu_rot_dataset_converted_externally_to_rlds"


def _jpeg(rng, size=SIZE):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((rng.random((size, size, 3)) * 255).astype(np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def _example(feats: dict) -> bytes:
    f = {}
    for k, v in feats.items():
        if isinstance(v[0], bytes):
            f[k] = tf.train.Feature(bytes_list=tf.train.BytesList(value=v))
        elif isinstance(v[0], (int, np.integer)):
            f[k] = tf.train.Feature(int64_list=tf.train.Int64List(value=v))
        else:
            f[k] = tf.train.Feature(float_list=tf.train.FloatList(value=v))
    return tf.train.Example(features=tf.train.Features(feature=f)).SerializeToString()


def _write_shard(root, name, records):
    ds_dir = os.path.join(root, name, "1.0.0")
    os.makedirs(ds_dir)
    with tf.io.TFRecordWriter(os.path.join(ds_dir, f"{name}-train.tfrecord-00000-of-00001")) as w:
        for rec in records:
            w.write(rec)


def _libero_records(rng, n=3, t=10):
    """The raw LIBERO layout: image, wrist_image, an 8-dim `state`, gripper
    actions in -1 (open) .. +1 (close)."""
    return [_example({
        "steps/observation/image": [_jpeg(rng) for _ in range(t)],
        "steps/observation/wrist_image": [_jpeg(rng) for _ in range(t)],
        "steps/observation/state": list(rng.standard_normal(t * 8).astype(np.float32)),
        "steps/action": list(np.concatenate([
            rng.uniform(-1, 1, (t, 6)), np.where(rng.random((t, 1)) > 0.5, 1.0, -1.0)],
            axis=1).astype(np.float32).reshape(-1)),
        "steps/language_instruction": [f"task {e}".encode()] * t,
    }) for e in range(n)]


def _rt1_record(rng, t=10):
    rel_grip = [0.0, 1.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    return _example({
        "steps/observation/image": [_jpeg(rng) for _ in range(t)],
        "steps/observation/base_pose_tool_reached": list(
            rng.standard_normal(t * 7).astype(np.float32)),
        "steps/observation/gripper_closed": list(np.zeros(t, np.float32)),
        "steps/observation/natural_language_instruction": [b"pick coke can"] * t,
        "steps/action/world_vector": list(rng.uniform(-1, 1, t * 3).astype(np.float32)),
        "steps/action/rotation_delta": list(rng.uniform(-1, 1, t * 3).astype(np.float32)),
        "steps/action/gripper_closedness_action": list(np.asarray(rel_grip, np.float32)),
    })


def _language_table_record(rng, t=10, pad=16):
    text = "push the block"
    codes = [ord(c) for c in text] + [0] * (pad - len(text))
    return _example({
        "steps/observation/rgb": [_jpeg(rng) for _ in range(t)],
        "steps/observation/effector_translation": list(
            rng.standard_normal(t * 2).astype(np.float32)),
        "steps/observation/instruction": codes * t,
        "steps/action": list(rng.uniform(-1, 1, t * 2).astype(np.float32)),
    })


def _kuka_record(rng, t=5):
    return _example({
        "steps/observation/image": [_jpeg(rng) for _ in range(t)],
        "steps/observation/clip_function_input/base_pose_tool_reached": [
            zlib.compress(rng.standard_normal(7).astype(np.float32).tobytes())
            for _ in range(t)],
        "steps/observation/gripper_closed": [
            zlib.compress(np.asarray([i % 2], np.float32).tobytes()) for i in range(t)],
        "steps/observation/natural_language_instruction": [b"grasp"] * t,
        "steps/action/world_vector": list(rng.uniform(-1, 1, t * 3).astype(np.float32)),
        "steps/action/rotation_delta": list(rng.uniform(-1, 1, t * 3).astype(np.float32)),
        "steps/action/gripper_closedness_action": list(np.zeros(t, np.float32)),
    })


def _droid_record(rng, t=5):
    return _example({
        "steps/observation/exterior_image_1_left": [_jpeg(rng) for _ in range(t)],
        "steps/observation/exterior_image_2_left": [_jpeg(rng) for _ in range(t)],
        "steps/observation/wrist_image_left": [_jpeg(rng) for _ in range(t)],
        "steps/observation/cartesian_position": list(
            rng.standard_normal(t * 6).astype(np.float32)),
        "steps/observation/gripper_position": list(rng.random(t).astype(np.float32)),
        "steps/action_dict/cartesian_velocity": list(
            rng.uniform(-1, 1, t * 6).astype(np.float32)),
        "steps/action_dict/gripper_position": list(rng.random(t).astype(np.float32)),
        "steps/language_instruction": [b"wipe the table"] * t,
    })


FAMILIES = {
    "libero_spatial_no_noops": lambda rng: _libero_records(rng),
    "fractal20220817_data": lambda rng: [_rt1_record(rng)],
    "language_table": lambda rng: [_language_table_record(rng)],
    "kuka": lambda rng: [_kuka_record(rng)],
    "droid": lambda rng: [_droid_record(rng)],
}


@pytest.fixture(scope="module")
def tfds_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tfds"))
    for i, (name, make) in enumerate(FAMILIES.items()):
        _write_shard(root, name, make(np.random.default_rng(i)))
    return root


def _assert_same(got, want, path="episode"):
    """Equal trees: dicts key for key, arrays value for value (object arrays
    of bytes byte for byte), lists item for item."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape and got.dtype == want.dtype, (path, got.dtype, want.dtype)
        if want.dtype == object:
            assert [bytes(x) for x in got.ravel()] == [bytes(x) for x in want.ravel()], path
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("keep_raw_state", [True, False])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_episodes_match_jax(tfds_root, name, keep_raw_state):
    got = list(PTF.iterate_tfds_episodes(tfds_root, name, PLAT, keep_raw_state=keep_raw_state))
    want = list(JTF.iterate_tfds_episodes(tfds_root, name, LIBERO,
                                          keep_raw_state=keep_raw_state))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_iterate_tfds_episodes(tfds_root):
    """The JAX test's assertions, on the port."""
    eps = list(PTF.iterate_tfds_episodes(tfds_root, "libero_spatial_no_noops", PLAT,
                                         keep_raw_state=True))
    assert len(eps) == 3
    ep = eps[0]
    assert ep["action"].shape == (10, 7)
    assert len(ep["observation"]["image"]) == 10
    assert len(ep["observation"]["wrist_image"]) == 10
    assert ep["observation"]["state"].shape == (10, 8)
    assert ep["language_instruction"] == b"task 0"
    assert PTF.find_tfds_files(tfds_root, "kuka") == JTF.find_tfds_files(tfds_root, "kuka")
    assert PTF.find_tfds_files(tfds_root, "nothing") == []
    with pytest.raises(FileNotFoundError, match="no TFDS shards"):
        next(PTF.iterate_tfds_episodes(tfds_root, "nothing", PLAT))


def _records(path):
    return [parse_example(r) for f in sorted(os.listdir(path)) if ".tfrecord" in f
            for r in read_tfrecords(os.path.join(path, f))]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_conversion_matches_jax(tfds_root, tmp_path, name, monkeypatch):
    """Both converters write the same episodes: every feature equal, the
    image bytes byte for byte, and the same marker. droid's transform swaps
    its two exterior cameras at random (an unseeded draw, reference
    droid_utils.py:59-63); both sides' draws are fixed to "no swap"."""
    if name == "droid":
        from openvla_oft_tpu.data.rlds.oxe import droid_utils as JD
        from openvla_oft_tpu_torch.data.rlds.oxe import droid_utils as PD

        for module in (JD, PD):
            monkeypatch.setattr(module, "rand_swap_exterior_images",
                                lambda img1, img2, rng=None: (img1, img2))
    n_p = PTF.convert_tfds_to_native(tfds_root, name, PLAT, str(tmp_path / "port" / name))
    n_j = JTF.convert_tfds_to_native(tfds_root, name, LIBERO, str(tmp_path / "jax" / name))
    assert n_p == n_j == len(FAMILIES[name](np.random.default_rng(0)))
    got, want = _records(tmp_path / "port" / name), _records(tmp_path / "jax" / name)
    assert len(got) == len(want) == n_p
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            kind_g, vals_g = g[key]
            kind_w, vals_w = w[key]
            assert kind_g == kind_w, key
            if kind_w == "bytes":
                assert [bytes(v) for v in vals_g] == [bytes(v) for v in vals_w], key
            else:
                np.testing.assert_array_equal(vals_g, vals_w, err_msg=key)
    for side in ("port", "jax"):
        with open(tmp_path / side / name / "native_format.json") as f:
            marker = json.load(f)
        assert marker == {"standardized": True,
                          "transform": marker["transform"]} and marker["transform"]
    with open(tmp_path / "port" / name / "native_format.json") as f, \
            open(tmp_path / "jax" / name / "native_format.json") as g:
        assert json.load(f) == json.load(g)


def test_convert_and_train_pipeline(tfds_root, tmp_path):
    """The JAX test's pipeline run on the port: the conversion standardized
    the gripper once, and the pipeline honours the marker."""
    from openvla_oft_tpu_torch.data.datasets import RLDSBatchTransform
    from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor
    from test_torch_import import port_config

    out = tmp_path / "native" / "libero_spatial_no_noops"
    assert PTF.convert_tfds_to_native(tfds_root, "libero_spatial_no_noops", PLAT, str(out)) == 3
    with open(out / "native_format.json") as f:
        assert json.load(f) == {"standardized": True, "transform": "libero_dataset_transform"}
    cfg = JC.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama")
    transform = RLDSBatchTransform(PrismaticProcessor(port_config(cfg)), ActionTokenizer(), PLAT)
    it, stats = PPL.make_rlds_iterator(str(tmp_path / "native"), "libero_spatial_no_noops",
                                       transform, PLAT, shuffle_buffer_size=10,
                                       image_aug=False, num_images=2)
    st = stats["libero_spatial_no_noops"]["action"]
    assert st["min"][-1] == 0.0 and st["max"][-1] == 1.0
    ex = next(it)
    assert ex["pixel_values"].shape[0] == 2
    assert ex["actions"].shape == (LIBERO.num_actions_chunk, LIBERO.action_dim)
    assert ex["proprio"].shape == (LIBERO.proprio_dim,)


@pytest.mark.parametrize("name", ["fractal20220817_data", "language_table"])
def test_converted_families_through_the_pipeline(tfds_root, tmp_path, name):
    """The JAX test's reads: rel2abs gives the gripper [0, 1]; language_table's
    instruction decoded and its action padded to 7."""
    root = tmp_path / "native_root"
    assert PTF.convert_tfds_to_native(tfds_root, name, PLAT, str(root / name)) == 1
    frames = []
    it, stats = PPL.make_rlds_iterator(str(root), name, lambda b: frames.append(b) or b, PLAT,
                                       shuffle_buffer_size=4, image_aug=False, num_images=1)
    next(it)
    if name == "fractal20220817_data":
        g = stats[name]["action"]
        assert g["min"][-1] == 0.0 and g["max"][-1] == 1.0
    else:
        lang = frames[0]["task"]["language_instruction"]
        assert (lang.decode() if isinstance(lang, bytes) else str(lang)) == "push the block"
        assert np.asarray(frames[0]["action"]).shape[-1] == 7


def test_unregistered_name_raises_unless_raw(tfds_root, tmp_path):
    os.symlink(os.path.join(tfds_root, "kuka"), tmp_path / "not_in_registry")
    with pytest.raises(KeyError, match="no standardization transform"):
        PTF.convert_tfds_to_native(str(tmp_path), "not_in_registry", PLAT, str(tmp_path / "o"))


# === The weighted mixture ===

def _native_sets(root, spec, seed, size=SIZE):
    """Native episode sets: {name: (episodes, steps)}."""
    rng = np.random.default_rng(seed)
    for name, (n_ep, t) in spec.items():
        eps = [{"images": [_jpeg(rng, size) for _ in range(t)],
                "wrist_images": [_jpeg(rng, size) for _ in range(t)],
                "actions": rng.uniform(-1, 1, (t, LIBERO.action_dim)),
                "proprio": rng.standard_normal((t, LIBERO.proprio_dim)),
                "language_instruction": f"task {name}"} for _ in range(n_ep)]
        PPL.write_episode_tfrecords(os.path.join(root, name), eps)


def _assert_stats_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        for group in ("action", "proprio"):
            assert set(got[name][group]) == set(want[name][group])
            for k, v in want[name][group].items():
                np.testing.assert_allclose(np.asarray(got[name][group][k], np.float64),
                                           np.asarray(v, np.float64), rtol=1e-6, atol=1e-6)
        for k in ("num_transitions", "num_trajectories"):
            assert got[name][k] == want[name][k]


@pytest.fixture(scope="module")
def mix_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mix"))
    _native_sets(root, {"mix_a": (4, 12), "mix_b": (2, 10), NYU_ROT: (2, 10)}, seed=3)
    return root


def test_interleaved_mixture_matches_jax_statistics(mix_root):
    it, stats = PPL.make_interleaved_iterator(mix_root, ["mix_a", "mix_b"], [0.5, 0.5],
                                              lambda b: b, PLAT, shuffle_buffer_size=20)
    _, want = JPL.make_interleaved_iterator(mix_root, ["mix_a", "mix_b"], [0.5, 0.5],
                                            lambda b: b, LIBERO, shuffle_buffer_size=20)
    _assert_stats_equal(stats, want)
    seen = {next(it)["dataset_name"] for _ in range(30)}
    assert seen == {"mix_a", "mix_b"}


@pytest.mark.parametrize("weights,balance", [([0.75, 0.25], False), ([1.0, 1.0], True)],
                         ids=["weights", "balance_weights"])
def test_interleaved_shares_follow_the_weights(mix_root, weights, balance):
    """Shares over 600 frames within 0.06 of the normalised weights
    (`balance_weights`: 48 and 20 transitions, so 48/68 and 20/68)."""
    it, stats = PPL.make_interleaved_iterator(mix_root, ["mix_a", "mix_b"], weights,
                                              lambda b: b, PLAT, shuffle_buffer_size=64,
                                              image_aug=True, seed=1, balance_weights=balance)
    assert stats["mix_a"]["num_transitions"] == 48 and stats["mix_b"]["num_transitions"] == 20
    names = [next(it)["dataset_name"] for _ in range(600)]
    want = np.asarray(weights) * ((48, 20) if balance else (1, 1))
    share = names.count("mix_a") / len(names)
    assert abs(share - want[0] / want.sum()) <= 0.06, share


def test_interleaved_eval_mode_exhausts_every_member(mix_root):
    """train=False: one pass over each member in file order, every frame
    once; the mixture ends with its last member."""
    it, _ = PPL.make_interleaved_iterator(mix_root, ["mix_a", "mix_b"], [0.9, 0.1],
                                          lambda b: b, PLAT, train=False, image_aug=False)
    names = [f["dataset_name"] for f in it]
    eff = LIBERO.num_actions_chunk - 1
    assert names.count("mix_a") == 4 * (12 - eff) and names.count("mix_b") == 2 * (10 - eff)


def test_structure_mismatch_takes_the_host_mix(mix_root):
    """An unregistered member (the raw 8-dim proprio) mixed with an OXE one
    whose state_obs_keys give a 7-dim proprio: decoded apart, mixed on the
    host by the weights; each frame keeps its own member's proprio width."""
    it, stats = PPL.make_interleaved_iterator(mix_root, ["mix_a", NYU_ROT], [0.5, 0.5],
                                              lambda b: b, PLAT, shuffle_buffer_size=16,
                                              image_aug=False, seed=2, num_images=2)
    assert set(stats) == {"mix_a", NYU_ROT}
    assert len(stats[NYU_ROT]["proprio"]["mean"]) == 7
    frames = [next(it) for _ in range(400)]
    for f in frames:
        width = 8 if f["dataset_name"] == "mix_a" else 7
        assert np.asarray(f["observation"]["proprio"]).shape == (width,)
        assert f["observation"]["image_wrist"].shape == (SIZE, SIZE, 3)
    share = sum(f["dataset_name"] == "mix_a" for f in frames) / len(frames)
    assert abs(share - 0.5) <= 0.08, share
