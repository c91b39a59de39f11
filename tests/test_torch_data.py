"""The port's data modules against the JAX package's, mirroring
`tests/test_data.py` and the prefetcher test of `tests/test_misc_components.py`:
the trajectory transforms (`data/transforms.py`) equal on seeded inputs; the
TF-free npz episode store (`data/npz_dataset.py`) on the port's JPEG decoder,
its stream equal to the JAX module's but for the pixels, which are TF's
decode (the JAX module decodes with PIL) to the last bit; and the device
prefetcher (`data/prefetch.py`) on the CPU: order, bounded depth, the
source's exception raised in the consumer, `close()` emptying its queue.
"""

import io
import time

import numpy as np
import pytest
import torch

from openvla_oft_tpu.constants import LIBERO, NormalizationType as JN
from openvla_oft_tpu.data import transforms as JT
from openvla_oft_tpu_torch.constants import NormalizationType as PN
from openvla_oft_tpu_torch.data import transforms as PT
from openvla_oft_tpu_torch.data.prefetch import DevicePrefetcher
from test_torch_import import port_platform


@pytest.mark.parametrize("t,window,future", [(10, 1, 4), (9, 1, 7), (6, 3, 2), (8, 2, 0)])
def test_chunking_matches_jax(t, window, future):
    actions = np.random.default_rng(t).standard_normal((t, 7)).astype(np.float32)
    np.testing.assert_array_equal(PT.chunk_actions(actions, window, future),
                                  JT.chunk_actions(actions, window, future))
    np.testing.assert_array_equal(PT.chunk_obs_pad_mask(t, window, future),
                                  JT.chunk_obs_pad_mask(t, window, future))
    chunks = PT.chunk_actions(np.arange(10)[:, None].repeat(3, 1).astype(np.float32), 1, 4)
    np.testing.assert_array_equal(chunks[-1, :, 0], [5, 6, 7, 8, 9])


def test_normalize_and_proprio_match_jax():
    stats = {"min": [0.0, 0.0, 5.0], "max": [10.0, 10.0, 5.0], "q01": [1.0, 1.0, 5.0],
             "q99": [9.0, 9.0, 5.0], "mask": [True, False, True]}
    x = np.random.default_rng(0).uniform(-20, 20, (50, 3)).astype(np.float32)
    for jn, pn in ((JN.BOUNDS, PN.BOUNDS), (JN.BOUNDS_Q99, PN.BOUNDS_Q99)):
        np.testing.assert_array_equal(PT.normalize(x, stats, pn), JT.normalize(x, stats, jn))
        np.testing.assert_array_equal(PT.normalize_proprio(x, {"proprio": stats}, pn),
                                      JT.normalize_proprio(x, {"proprio": stats}, jn))
    out = PT.normalize(np.asarray([[5.0, 5.0, 5.0]]), stats, PN.BOUNDS_Q99)
    assert abs(out[0, 0]) < 1e-6 and out[0, 1] == 5.0 and out[0, 2] == 0.0


def test_gripper_relabels_match_jax():
    rng = np.random.default_rng(1)
    for a in (np.asarray([1.0, 0.97, 0.5, 0.02, 0.01, 0.6, 1.0]), rng.random(40),
              rng.choice([0.0, 0.5, 1.0], 30)):
        np.testing.assert_array_equal(PT.binarize_gripper_actions(a),
                                      JT.binarize_gripper_actions(a))
        np.testing.assert_array_equal(PT.invert_gripper_actions(a), JT.invert_gripper_actions(a))
    for rel in (rng.choice([-1.0, 0.0, 1.0], 25), np.zeros(4), rng.uniform(-1, 1, 12)):
        np.testing.assert_array_equal(PT.rel2abs_gripper_actions(rel),
                                      JT.rel2abs_gripper_actions(rel))
    np.testing.assert_array_equal(
        PT.binarize_gripper_actions(np.asarray([1.0, 0.97, 0.5, 0.02, 0.01, 0.6, 1.0])),
        [1, 1, 0, 0, 0, 1, 1])


def test_statistics_roundtrip_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    actions, proprio = rng.uniform(-2, 2, (500, 7)), rng.random((500, 8))
    stats = {"d": PT.compute_dataset_statistics(actions, proprio, num_trajectories=4)}
    assert stats["d"] == JT.compute_dataset_statistics(actions, proprio, num_trajectories=4)
    loaded = PT.load_dataset_statistics(PT.save_dataset_statistics(stats, str(tmp_path)))
    assert loaded == JT.load_dataset_statistics(str(tmp_path)) == stats


def _jpegs(rng, n, size):
    from PIL import Image

    out = []
    for _ in range(n):
        buf = io.BytesIO()
        Image.fromarray((rng.random((size, size, 3)) * 255).astype(np.uint8)).save(
            buf, format="JPEG")
        out.append(buf.getvalue())
    return out


def test_npz_dataset_tf_free(tmp_path):
    """The port's npz store against the JAX one: the same frames, actions,
    proprio and instructions in train and eval order; every frame PIL's
    pixels, bit for bit (the port reads no TF and no PIL)."""
    Image = pytest.importorskip("PIL.Image")
    from openvla_oft_tpu.data import npz_dataset as JNPZ
    from openvla_oft_tpu_torch.data import npz_dataset as PNPZ

    rng = np.random.default_rng(0)
    episodes = [{"images": _jpegs(rng, 12, 28), "wrist_images": _jpegs(rng, 12, 28),
                 "actions": rng.uniform(-2, 2, (12, LIBERO.action_dim)),
                 "proprio": rng.standard_normal((12, LIBERO.proprio_dim)),
                 "language_instruction": f"npz task {e}"} for e in range(3)]
    PNPZ.write_npz_episodes(str(tmp_path / "port" / "libero_npz"), episodes)
    JNPZ.write_npz_episodes(str(tmp_path / "jax" / "libero_npz"), episodes)
    platform = port_platform(LIBERO)
    for train in (True, False):
        kw = dict(shuffle_buffer_size=10, num_images=2, train=train, seed=4)
        got_it, got_stats = PNPZ.make_npz_iterator(str(tmp_path / "port"), "libero_npz",
                                                   lambda b: b, platform, **kw)
        want_it, want_stats = JNPZ.make_npz_iterator(str(tmp_path / "jax"), "libero_npz",
                                                     lambda b: b, LIBERO, **kw)
        assert got_stats == want_stats
        n = 0
        for got, want in zip(got_it, want_it):
            np.testing.assert_array_equal(got["action"], want["action"])
            np.testing.assert_array_equal(got["observation"]["proprio"],
                                          want["observation"]["proprio"])
            assert got["task"] == want["task"] and got["dataset_name"] == want["dataset_name"]
            for key in ("image_primary", "image_wrist"):
                # the same JPEG, decoded as PIL decodes it
                np.testing.assert_array_equal(got["observation"][key],
                                              want["observation"][key])
            n += 1
            if train and n == 20:
                break
        assert n == (20 if train else 15)       # eval: 3 episodes x (12 - 7) frames
    # the decoded pixels are PIL's
    first = next(PNPZ.make_npz_iterator(str(tmp_path / "port"), "libero_npz", lambda b: b,
                                        platform, train=False, num_images=2)[0])
    pil = Image.open(io.BytesIO(episodes[0]["images"][0])).convert("RGB")
    np.testing.assert_array_equal(first["observation"]["image_primary"], np.asarray(pil))


def test_device_prefetcher_order_and_errors():
    batches = ({"x": np.full((2, 2), i), "dataset_name": "d"} for i in range(5))
    pf = DevicePrefetcher(batches, device="cpu", depth=2)
    seen = list(pf)
    assert [int(b["x"][0, 0]) for b in seen] == [0, 1, 2, 3, 4]
    assert all(isinstance(b["x"], torch.Tensor) and "dataset_name" not in b for b in seen)

    def bad():
        yield {"x": np.ones(2)}
        raise RuntimeError("source died")

    pf2 = DevicePrefetcher(bad(), device="cpu")
    next(pf2)
    with pytest.raises(RuntimeError, match="source died"):
        next(pf2)


def test_device_prefetcher_depth_and_close():
    """At most `depth` batches wait in the queue; close() empties it and
    stops the worker, which would otherwise hold them."""
    made = []

    def source():
        for i in range(100):
            made.append(i)
            yield {"x": np.full(3, i)}

    pf = DevicePrefetcher(source(), device="cpu", depth=2)
    deadline = time.time() + 5
    while pf._queue.qsize() < 2 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    assert pf._queue.qsize() == 2 and len(made) <= 4      # depth 2, one in hand
    assert int(next(pf)["x"][0]) == 0
    pf.close()
    assert pf._queue.qsize() <= 1                            # at most the end marker
    assert not pf._thread.is_alive()
    assert len(made) < 100


def test_goal_relabel_and_task_augmentation_match_jax():
    """`data/rlds/goal_task_aug.py` against the JAX module on the same
    trajectories and generators: the same strictly-future goals and the
    same modality dropped."""
    from openvla_oft_tpu.data.rlds import goal_task_aug as JG
    from openvla_oft_tpu_torch.data.rlds import goal_task_aug as PG

    for seed in range(4):
        t = 3 + 4 * seed
        make = lambda: {"images": [bytes([i]) for i in range(t)],   # noqa: E731
                        "language_instruction": b"stack the blocks"}
        got = PG.uniform_goal_relabel(make(), np.random.default_rng(seed))
        want = JG.uniform_goal_relabel(make(), np.random.default_rng(seed))
        np.testing.assert_array_equal(got["task"]["image_goal_idx"],
                                      want["task"]["image_goal_idx"])
        idx = got["task"]["image_goal_idx"]
        assert (idx > np.minimum(np.arange(t), t - 2)).all() and (idx < t).all()
        assert got["task"]["image_goal"] == [got["images"][i] for i in idx]
        for p in (0.0, 0.5, 1.0):
            a = PG.keep_image_or_language(dict(got, task=dict(got["task"])),
                                          np.random.default_rng(seed), p)
            b = JG.keep_image_or_language(dict(want, task=dict(want["task"])),
                                          np.random.default_rng(seed), p)
            assert a["language_instruction"] == b["language_instruction"]
            assert sorted(a["task"]) == sorted(b["task"])
