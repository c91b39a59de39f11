"""The port's bench aids against the JAX scripts: `scripts/bench_deploy.py`
(its observation and request bytes, and a run against a random:tiny
server on the CPU) and `scripts/bench_data.py` (a small run, its first
batch against the JAX script's, and its JPEG frames against TF's encoder).

The counterparts of `tests/test_bench_aids.py` (the zero tree and the
[-1, 1] statistics of `get_vla`'s `zero_init` and `fake_norm_stats`, and no
statistics without them) are
`tests/test_torch_eval_api.py::test_random_checkpoints_and_their_switches`.
"""

import json
import sys
import tempfile

import numpy as np
import pytest

from openvla_oft_tpu_torch.scripts import bench_data, bench_deploy


@pytest.mark.parametrize("double_encode", [False, True], ids=["json-numpy", "double"])
@pytest.mark.parametrize("num_images,proprio_dim", [(2, 8), (3, 14)], ids=["libero", "aloha"])
def test_observation_and_body_are_jax_scripts(num_images, proprio_dim, double_encode):
    from openvla_oft_tpu.serving import json_numpy as jax_json_numpy
    from vla_scripts import bench_deploy as J

    ref = J.make_observation(num_images, proprio_dim)
    got = bench_deploy.make_observation(num_images, proprio_dim)
    assert list(got) == list(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype
            np.testing.assert_array_equal(got[key], value)
        else:
            assert got[key] == value
    want = jax_json_numpy.dumps(ref)
    want = json.dumps({"encoded": want}) if double_encode else want
    assert bench_deploy.request_body(got, double_encode) == want.encode()


def test_bench_deploy_serves_tiny(monkeypatch, tmp_path, capsys):
    """The deploy CLI in its own process (zero weights, fake statistics,
    one-pass preprocessing), 3 timed requests, the JSON summary last."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = bench_deploy.main(["--model", "tiny", "--device", "cpu", "--n", "3",
                             "--startup_timeout", "240"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    assert out["metric"] == "http_act_latency" and out["n"] == 3
    assert 0 < out["p50_ms"] <= out["p99_ms"] and out["request_mb"] > 0.5
    assert any("chunk shape (8, 7)" in ln for ln in lines)
    log = next(tmp_path.glob("bench_deploy_server_*.log")).read_text()
    assert "[deploy] warmup run" in log and "libero_bench" in log


def _jax_first_batch(monkeypatch, argv):
    """The JAX script's first batch at `argv`."""
    import openvla_oft_tpu.data.collator as JCOL
    from vla_scripts import bench_data as J

    seen = []
    batches = JCOL.batch_iterator

    def tap(*args, **kw):
        for b in batches(*args, **kw):
            seen.append(b)
            yield b

    monkeypatch.setattr(JCOL, "batch_iterator", tap)
    monkeypatch.setattr(sys, "argv", ["bench_data.py"] + argv)
    J.main()
    return seen[0]


def test_bench_data_run_and_first_batch(monkeypatch, capsys):
    argv = ["--episodes", "2", "--batches", "2", "--batch_size", "2"]
    out = bench_data.main(["--device", "cpu"] + argv)
    text = capsys.readouterr().out
    assert "pipeline[single, aug=True, images=2]" in text and "batches/s at b=2" in text
    assert out["frames_per_s"] > 0 and out["batches_per_s"] > 0
    ref = _jax_first_batch(monkeypatch, argv)
    got = out["first_batch"]
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        value = np.asarray(value)
        assert (got[key].shape, got[key].dtype) == (value.shape, value.dtype), key


def test_frames_decode_as_tfs_encoder():
    """The script's frames (its first draws from default_rng(0)) encoded at
    quality 95 decode to the pixels `tf.io.encode_jpeg`'s bytes decode to."""
    import tensorflow as tf

    rng = np.random.default_rng(0)
    for _ in range(3):
        img = rng.integers(0, 255, (224, 224, 3), np.uint8)
        ref = tf.io.decode_jpeg(tf.io.encode_jpeg(tf.convert_to_tensor(img))).numpy()
        got = tf.io.decode_jpeg(bench_data.encode_frame(img)).numpy()
        np.testing.assert_array_equal(got, ref)
