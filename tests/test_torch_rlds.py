"""The port's RLDS episode pipeline (`openvla_oft_tpu_torch/data/rlds/pipeline.py`,
no TensorFlow) against the JAX package's tf.data one
(`openvla_oft_tpu/data/rlds/pipeline.py`), mirroring `tests/test_rlds_pipeline.py`
but for the interleaved mixture and multi-process sharding (not ported).

- At `train=False`, `image_aug=False`, on one shard: the frame stream
  (uint8 frames, action chunks, proprio, instruction, dataset name) is
  bitwise equal, with one camera and two, for an unregistered dataset and a
  raw `libero_*` one under `"auto"` standardization; so are the statistics
  JSON files; shards written by either side's writer read the same.
- Through each side's `RLDSBatchTransform`: ids and labels equal, pixels
  within the processor tolerance of `tests/test_torch_finetune_cli.py`.
- Train mode: the port's shuffles and draws are its own (TF's stateless RNG
  is not reproduced), so it is held to determinism and coverage.
- The augmentation function against TF's ops given TF's own draws: at most
  2 levels apart on at most 1e-4 of the values (the lanczos3 weights; the
  colour stages alone are bitwise); the host library's augmentation
  bitwise equal to its numpy plain version.
TF and PIL are imported inside the fixtures and tests.
"""

import io
import json
import os

import numpy as np
import pytest

from openvla_oft_tpu.config import TINY_DINOV2
from openvla_oft_tpu.constants import IGNORE_INDEX, LIBERO
from openvla_oft_tpu_torch.data.rlds import pipeline as PP
from test_torch_import import port_platform

PLATFORM = port_platform(LIBERO)
SIZE = TINY_DINOV2.image_size


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _jpeg(rng, size, quality=75):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((rng.random((size, size, 3)) * 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _episodes(rng, n, lengths, wrist, proprio_dim, raw_gripper=False, tag="task"):
    eps = []
    for e in range(n):
        t = lengths[e % len(lengths)]
        actions = rng.uniform(-2, 2, (t, LIBERO.action_dim))
        if raw_gripper:
            actions[:, -1] = np.where(np.arange(t) % 2 == 0, -1.0, 1.0)
        ep = {"images": [_jpeg(rng, SIZE) for _ in range(t)], "actions": actions,
              "proprio": rng.standard_normal((t, proprio_dim)),
              "language_instruction": f"{tag} {e}"}
        if wrist:
            ep["wrist_images"] = [_jpeg(rng, SIZE, 90) for _ in range(t)]
        eps.append(ep)
    return eps


@pytest.fixture(scope="module")
def root(tf, tmp_path_factory):
    """One shard each, written by the JAX package's (TF) writer: an
    unregistered one-camera set, an unregistered two-camera set, and raw
    LIBERO (gripper -1..1, 8-dim state, two cameras)."""
    pytest.importorskip("PIL")
    from openvla_oft_tpu.data.rlds.pipeline import write_episode_tfrecords

    rng = np.random.default_rng(0)
    out = tmp_path_factory.mktemp("rlds")
    write_episode_tfrecords(str(out / "libero_synth"),
                            _episodes(rng, 6, [12, 9, 15, 8, 14, 10], False, LIBERO.proprio_dim))
    write_episode_tfrecords(str(out / "two_cam"),
                            _episodes(rng, 5, [10, 13, 8], True, LIBERO.proprio_dim))
    write_episode_tfrecords(str(out / "libero_spatial_no_noops"),
                            _episodes(rng, 5, [14, 9, 11], True, 8, raw_gripper=True))
    return str(out)


def _stats_path(root, name):
    return os.path.join(root, name, "dataset_statistics.json")


def _frames(make, root, name, platform, **kw):
    """Every raw frame of a one-pass stream, and the statistics file the
    pipeline wrote (computed afresh: any earlier one is removed)."""
    if os.path.exists(_stats_path(root, name)):
        os.remove(_stats_path(root, name))
    seen = []
    it, stats = make(root, name, lambda b: seen.append(b) or b, platform, image_aug=False,
                     train=False, **kw)
    for _ in it:
        pass
    with open(_stats_path(root, name)) as f:
        return seen, stats, json.load(f)


def assert_frames_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g["observation"]) == sorted(w["observation"])
        for k in w["observation"]:
            a, b = np.asarray(g["observation"][k]), np.asarray(w["observation"][k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        assert g["action"].dtype == w["action"].dtype == np.float32
        np.testing.assert_array_equal(g["action"], w["action"])
        assert g["task"]["language_instruction"] == w["task"]["language_instruction"]
        assert g["dataset_name"] == w["dataset_name"]


STREAMS = [("libero_synth", 1), ("two_cam", 2), ("two_cam", 1),
           ("libero_spatial_no_noops", 2), ("libero_spatial_no_noops", 1)]


@pytest.mark.parametrize("name,num_images", STREAMS,
                         ids=[f"{n}-{k}cam" for n, k in STREAMS])
def test_eval_stream_and_statistics_match_jax(root, name, num_images):
    from openvla_oft_tpu.data.rlds.pipeline import make_rlds_iterator

    want, want_stats, want_file = _frames(make_rlds_iterator, root, name, LIBERO,
                                          num_images=num_images)
    got, got_stats, got_file = _frames(PP.make_rlds_iterator, root, name, PLATFORM,
                                       num_images=num_images)
    assert_frames_equal(got, want)
    assert got_stats == want_stats and got_file == want_file
    assert got[0]["observation"]["image_primary"].shape == (SIZE, SIZE, 3)
    if name == "libero_spatial_no_noops":
        st = got_file["action"]
        assert got_file["transform"] == "libero_dataset_transform"
        assert st["mask"] == [True] * 6 + [False] and st["min"][-1] == 0.0 and st["max"][-1] == 1.0
        assert all(np.isin(f["action"][..., -1], (0.0, 1.0)).all() for f in got)


def test_port_writer_reads_back_in_jax(root, tmp_path):
    """Shards from the port's writer give the JAX pipeline the stream the TF
    writer's shards give it."""
    from openvla_oft_tpu.data.rlds.pipeline import make_rlds_iterator

    rng = np.random.default_rng(3)
    eps = _episodes(rng, 3, [10, 12], True, LIBERO.proprio_dim)
    PP.write_episode_tfrecords(str(tmp_path / "mine"), eps)
    from openvla_oft_tpu.data.rlds.pipeline import write_episode_tfrecords

    write_episode_tfrecords(str(tmp_path / "theirs"), eps)
    a, _, _ = _frames(make_rlds_iterator, str(tmp_path), "mine", LIBERO, num_images=2)
    b, _, _ = _frames(make_rlds_iterator, str(tmp_path), "theirs", LIBERO, num_images=2)
    for x in (a, b):
        for f in x:
            f["dataset_name"] = "same"
    assert_frames_equal(a, b)


def test_batch_transform_matches_jax(root):
    """Each side's RLDSBatchTransform on each side's stream: token ids and
    labels equal, pixels to 1e-6."""
    from openvla_oft_tpu.data.datasets import RLDSBatchTransform as JT
    from openvla_oft_tpu.data.rlds.pipeline import make_rlds_iterator
    from openvla_oft_tpu.processing.action_tokenizer import ActionTokenizer as JTok
    from openvla_oft_tpu.processing.processor import PrismaticProcessor as JProc
    from openvla_oft_tpu_torch.data.datasets import RLDSBatchTransform
    from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor
    from test_torch_finetune_cli import CFG
    from test_torch_import import port_config
    import dataclasses

    cfg = dataclasses.replace(CFG, num_images_in_input=2)
    name = "libero_spatial_no_noops"
    want_it, _ = make_rlds_iterator(root, name, JT(JProc(cfg), JTok(), LIBERO), LIBERO,
                                    image_aug=False, train=False, num_images=2)
    got_it, _ = PP.make_rlds_iterator(
        root, name, RLDSBatchTransform(PrismaticProcessor(port_config(cfg)), ActionTokenizer(),
                                       PLATFORM), PLATFORM, image_aug=False, train=False,
        num_images=2)
    n = 0
    for got, want in zip(got_it, want_it):
        for key in ("input_ids", "labels", "actions", "proprio"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["pixel_values"].shape == want["pixel_values"].shape
        np.testing.assert_allclose(got["pixel_values"], want["pixel_values"], rtol=1e-6,
                                   atol=1e-6)
        assert (got["labels"] != IGNORE_INDEX).sum() == LIBERO.chunk_len + 1
        n += 1
    assert n == 7 + 2 + 4 + 7 + 2   # (14, 9, 11, 14, 9) steps, 7 future actions


def test_end_to_end_batches_through_the_collator(root):
    from openvla_oft_tpu_torch.data.collator import (PaddedCollatorForActionPrediction,
                                                     batch_iterator)
    from openvla_oft_tpu_torch.data.datasets import RLDSBatchTransform
    from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor
    from test_torch_finetune_cli import CFG
    from test_torch_import import port_config

    transform = RLDSBatchTransform(PrismaticProcessor(port_config(CFG)), ActionTokenizer(),
                                   PLATFORM)
    it, stats = PP.make_rlds_iterator(root, "libero_synth", transform, PLATFORM,
                                      shuffle_buffer_size=20, image_aug=True)
    assert len(stats["libero_synth"]["action"]["q99"]) == LIBERO.action_dim
    ex = next(it)
    assert ex["actions"].shape == (LIBERO.num_actions_chunk, LIBERO.action_dim)
    assert np.abs(ex["actions"]).max() <= 1.0 + 1e-6
    batch = next(batch_iterator(it, 3, PaddedCollatorForActionPrediction()))
    assert batch["input_ids"].shape[0] == 3 and batch["proprio"].shape == (3, LIBERO.proprio_dim)


def _train_frames(root, name, n, **kw):
    seen = []
    it, _ = PP.make_rlds_iterator(root, name, lambda b: seen.append(b) or b, PLATFORM,
                                  train=True, **kw)
    for _ in range(n):
        next(it)
    return seen


def test_train_mode_is_deterministic_and_covers_the_data(root):
    kw = dict(shuffle_buffer_size=16, image_aug=True, num_images=2, seed=5)
    a = _train_frames(root, "two_cam", 40, **kw)
    b = _train_frames(root, "two_cam", 40, **kw)
    assert_frames_equal(a, b)
    c = _train_frames(root, "two_cam", 40, **dict(kw, seed=6))
    assert [f["task"]["language_instruction"] for f in a] != \
        [f["task"]["language_instruction"] for f in c] or \
        any(not np.array_equal(x["action"], y["action"]) for x, y in zip(a, c))
    # coverage: 19 frames an epoch (5 episodes); 5 epochs' worth of draws
    # reach every frame
    eval_frames, _, _ = _frames(PP.make_rlds_iterator, root, "two_cam", PLATFORM, num_images=2)
    raw = {(f["task"]["language_instruction"], f["action"].tobytes()): f for f in eval_frames}
    assert len(raw) == len(eval_frames) == 19
    many = _train_frames(root, "two_cam", 95, **kw)
    assert {(f["task"]["language_instruction"], f["action"].tobytes()) for f in many} == set(raw)
    f = many[0]
    ref = raw[(f["task"]["language_instruction"], f["action"].tobytes())]
    for cam in ("image_primary", "image_wrist"):
        assert not np.array_equal(f["observation"][cam], ref["observation"][cam])


def test_every_shard_is_read(tmp_path):
    """The port reads every shard file (no per-process sharding)."""
    rng = np.random.default_rng(9)
    ds = tmp_path / "sharded"
    for i, task in enumerate(["alpha task", "bravo task", "charlie task"]):
        eps = _episodes(rng, 1, [9], False, LIBERO.proprio_dim, tag=task)
        path = PP.write_episode_tfrecords(str(tmp_path / f"stage{i}"), eps, shard_size=1)[0]
        os.makedirs(ds, exist_ok=True)
        os.rename(path, ds / f"episodes-{i:05d}.tfrecord")
    for reads in (None, 2, 3):
        frames, _, _ = _frames(PP.make_rlds_iterator, str(tmp_path), "sharded", PLATFORM,
                               read_parallelism=reads)
        assert {f["task"]["language_instruction"] for f in frames} == \
            {b"alpha task 0", b"bravo task 0", b"charlie task 0"}
        assert len(frames) == 3 * 2


def test_goal_relabel_and_task_augmentation(root):
    frames = _train_frames(root, "libero_spatial_no_noops", 24, shuffle_buffer_size=10,
                           image_aug=False, num_images=2, task_augment_prob=1.0, seed=11,
                           goal_relabeling_strategy="uniform")
    lang_only = goal_only = 0
    for f in frames:
        lang, goal = f["task"]["language_instruction"], f["task"]["image_primary"]
        assert isinstance(goal, (bytes, np.bytes_))
        if len(lang) == 0 and len(goal) > 0:
            assert goal[:2] == b"\xff\xd8"
            goal_only += 1
        elif len(goal) == 0 and len(lang) > 0:
            lang_only += 1
        else:
            raise AssertionError("kept or dropped both modalities")
    assert lang_only and goal_only
    with pytest.raises(ValueError, match="goal_relabeling_strategy"):
        PP.make_rlds_iterator(root, "libero_synth", lambda b: b, PLATFORM,
                              goal_relabeling_strategy="bogus")


def test_stale_stats_recomputed_on_transform_change(root):
    name = "libero_spatial_no_noops"
    _frames(PP.make_rlds_iterator, root, name, PLATFORM, num_images=2)
    with open(_stats_path(root, name)) as f:
        good = json.load(f)
    stale = dict(good)
    stale.pop("transform")
    stale["action"] = dict(stale["action"], min=[-9.0] * 7, max=[9.0] * 7)
    with open(_stats_path(root, name), "w") as f:
        json.dump(stale, f)
    _, stats = PP.make_rlds_iterator(root, name, lambda b: b, PLATFORM, image_aug=False,
                                     num_images=2)
    assert stats[name]["transform"] == "libero_dataset_transform"
    assert stats[name]["action"]["max"][-1] == 1.0
    with open(_stats_path(root, name)) as f:
        assert json.load(f) == good


def _tf_draws(tf, h, w, seed):
    """TF's own draws at `seed`, as `_augment_image` makes them."""
    from openvla_oft_tpu_torch.data.rlds.augment import crop_size

    s = tf.constant(seed, tf.int32)
    ch, cw = crop_size(h, w)
    offset = tf.random.stateless_uniform([3], seed=s, maxval=tf.int32.max,
                                         dtype=tf.int32) % tf.constant([h - ch + 1, w - cw + 1, 1])

    def u(k, lo, hi):
        return np.float32(tf.random.stateless_uniform(
            [], seed=tf.stack([s[0] + k, s[1]]), minval=lo, maxval=hi).numpy())

    return {"crop": (int(offset[0]), int(offset[1])), "brightness": u(1, -0.2, 0.2),
            "contrast": u(2, 0.8, 1.2), "saturation": u(3, 0.8, 1.2),
            "hue": u(4, -0.05, 0.05)}


@pytest.mark.parametrize("size", [(256, 256), (224, 224), (37, 53), (64, 64)])
def test_augmentation_matches_tf_given_tf_draws(tf, size):
    from openvla_oft_tpu.data.rlds.pipeline import _augment_image
    from openvla_oft_tpu_torch.data.rlds.augment import augment_image, augment_image_plain

    h, w = size
    rng = np.random.default_rng(h * w)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(xx / 7 + yy / 11), 128 + 90 * np.cos(yy / 5),
                    (xx * 3 + yy * 2) % 256], -1) + rng.normal(0, 20, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    for _ in range(3):
        seed = [int(x) for x in rng.integers(0, 2 ** 30, 2)]
        want = _augment_image(tf.constant(img), tf.constant(seed, tf.int32)).numpy()
        draws = _tf_draws(tf, h, w, seed)
        got = augment_image(img, draws)
        np.testing.assert_array_equal(got, augment_image_plain(img, draws))
        diff = np.abs(got.astype(np.int32) - want)
        assert diff.max() <= 2 and (diff > 0).mean() <= 1e-4, (diff.max(), (diff > 0).mean())


def test_colour_stages_are_tf_bitwise(tf):
    from openvla_oft_tpu_torch.data.rlds import augment as A

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    f = A._to_float(img)
    mean = A._channel_mean(f.reshape(-1, 3))
    for want, got in (
            (tf.image.adjust_brightness(img, 0.137), A._to_uint8(f + np.float32(0.137), True)),
            (tf.image.adjust_contrast(img, 1.137),
             A._to_uint8(mean + np.float32(1.137) * (f - mean), True)),
            (tf.image.adjust_saturation(img, 0.863),
             A._to_uint8(A._saturation(f, np.float32(0.863)), False)),
            (tf.image.adjust_hue(img, -0.0437),
             A._to_uint8(A._hue(f, np.float32(-0.0437)), False))):
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("size", [(256, 256), (224, 224), (37, 53), (9, 9), (120, 300)])
def test_host_augmentation_matches_plain(size):
    """`augment_image` (the host library) against `augment_image_plain`
    (numpy), bitwise, over random contents and the port's own draws; its
    draws cover TF's ranges."""
    from openvla_oft_tpu_torch.data.rlds.augment import (augment_image, augment_image_plain,
                                                         crop_size, draw_augmentation)

    h, w = size
    rng = np.random.default_rng(h + 7 * w)
    for i in range(6):
        img = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) if i % 2 else
               np.clip(rng.normal(128, 60 * i, (h, w, 3)), 0, 255).astype(np.uint8))
        draws = draw_augmentation(rng, h, w)
        ch, cw = crop_size(h, w)
        assert 0 <= draws["crop"][0] <= h - ch and 0 <= draws["crop"][1] <= w - cw
        assert -0.2 <= draws["brightness"] < 0.2 and 0.8 <= draws["contrast"] < 1.2
        assert 0.8 <= draws["saturation"] < 1.2 and -0.05 <= draws["hue"] < 0.05
        np.testing.assert_array_equal(augment_image(img, draws), augment_image_plain(img, draws))
    with pytest.raises(ValueError, match="crop offset"):
        augment_image(img, dict(draws, crop=(h, 0)))
    with pytest.raises(ValueError, match="too small"):
        augment_image(np.zeros((1, 5, 3), np.uint8), draws)
