"""The port's data scripts against the JAX package's, without PIL or TF in
the port.

- `scripts/make_synthetic_rlds.py` (frames through
  `processing/jpeg_encode.py::encode_jpeg`) against
  `vla_scripts/make_synthetic_rlds.py` (PIL, TF's TFRecord writer): at 2
  episodes of 8 steps at 32 x 32 every record holds the same features, byte
  for byte, and the port's shards are the JAX shards written canonically
  (TF's protobuf orders a `Features` map by a seed drawn in each process,
  so two runs of the JAX script differ there; `set_digest`); at the
  defaults (48 episodes, 64 steps, 256 x 256) the port's shards are the JAX
  set's written canonically, and the JAX set has the frames, the rest and
  the actions `tests/goldens/synthetic_rlds.npz` records (REGEN_GOLDENS=1
  rewrites it; `chip_smoke.py`'s phase 20 holds the port's set on the card
  to it, where NumPy's float32 sine may put an action 1 ULP off).
- `scripts/make_quickstart_fixture.py`: its object equals the committed
  `experiments/robot/libero/sample_libero_spatial_observation.pkl`, leaf for
  leaf, and it never writes there.
- `scripts/exp_roundtrip_7b.py --scale tiny --device cpu`: bitwise on every
  leaf and on the action chunk; a changed leaf or chunk fails it.
"""

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_oft_tpu_torch.data.rlds.tfrecord import parse_example, read_tfrecords
from openvla_oft_tpu_torch.scripts import exp_roundtrip_7b as RT
from openvla_oft_tpu_torch.scripts import make_quickstart_fixture as QF
from openvla_oft_tpu_torch.scripts import make_synthetic_rlds as PS

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "synthetic_rlds.npz"
FIXTURE = ROOT / "experiments" / "robot" / "libero" / "sample_libero_spatial_observation.pkl"
DEFAULTS = dict(episodes=48, steps=64, tasks=8, image_size=256)


def jax_script():
    pytest.importorskip("PIL")
    pytest.importorskip("tensorflow")
    sys.path.insert(0, str(ROOT))
    from vla_scripts import make_synthetic_rlds as JS

    return JS


def records(set_dir):
    out = []
    for name in sorted(os.listdir(set_dir)):
        if name.endswith(".tfrecord"):
            out += [parse_example(r) for r in read_tfrecords(os.path.join(set_dir, name))]
    return out


def assert_same_features(a, b):
    assert a.keys() == b.keys()
    for key in a:
        (ka, va), (kb, vb) = a[key], b[key]
        assert ka == kb, key
        if ka == "float":
            assert np.asarray(va).dtype == np.asarray(vb).dtype == np.float32
            assert np.asarray(va).tobytes() == np.asarray(vb).tobytes(), key
        else:
            assert list(va) == list(vb), key


@pytest.mark.parametrize("wrist", [False, True], ids=["one_camera", "wrist"])
def test_synthetic_set_matches_the_jax_script(tmp_path, wrist):
    JS = jax_script()
    kw = dict(episodes=2, steps=8, tasks=8, image_size=32, wrist=wrist)
    j = JS.generate(str(tmp_path / "jax"), "libero_synth_l1", **kw)
    p = PS.generate(str(tmp_path / "port"), "libero_synth_l1", **kw)
    assert sorted(os.listdir(j)) == sorted(os.listdir(p)) == [
        "episodes-00000.tfrecord", "native_format.json"]
    got, want = records(p), records(j)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert_same_features(a, b)
    assert (Path(p) / "native_format.json").read_bytes() == \
        (Path(j) / "native_format.json").read_bytes()
    # the port's shards are canonical, and the JAX ones written canonically
    assert PS.set_digest(p) == PS.set_digest(p, canonical=True) == \
        PS.set_digest(j, canonical=True)


def test_synthetic_set_at_the_defaults_has_the_golden_digest(tmp_path):
    """The JAX script at its defaults has the golden's frames and rest,
    bitwise, and its actions within 1 ULP (REGEN_GOLDENS=1 records them);
    the port's shards at the defaults are the JAX set's, canonically
    written."""
    JS = jax_script()
    j = JS.generate(str(tmp_path / "jax"), "libero_synth_l1", **DEFAULTS)
    summary = PS.set_summary(j)
    if os.environ.get("REGEN_GOLDENS") == "1":
        np.savez_compressed(
            GOLDEN, args=np.array("make_synthetic_rlds --episodes 48 --steps 64 --tasks 8 "
                                  "--image-size 256 (its defaults)"),
            numpy=np.array(np.__version__), frames_sha256=np.array(summary["frames_sha256"]),
            other_sha256=np.array(summary["other_sha256"]), actions=summary["actions"])
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    out = PS.compare_to_golden(summary, golden)
    assert out["actions"] == golden["actions"].size > 20_000
    p = PS.main(["--out", str(tmp_path / "port")])
    assert PS.set_digest(p) == PS.set_digest(j, canonical=True)


@pytest.mark.parametrize("change", ["frame", "action_2_ulp", "proprio"])
def test_compare_to_golden_catches_a_change(change):
    """A changed frame byte, an action 2 ULP off and a proprio that is not
    the actions' running sum each fail the comparison; an action 1 ULP off
    passes and is counted."""
    def proprio_of(acts):
        proprio = np.zeros((7, 8), np.float32)
        for start, end in ((0, 3), (3, 7)):
            proprio[start:end, :7] = np.cumsum(acts[start:end], 0) * 0.05
            proprio[start:end, 7:] = acts[start:end, -1:]
        return proprio

    acts = np.random.default_rng(0).uniform(-1, 1, (7, 7)).astype(np.float32)
    golden = {"frames_sha256": np.array("f"), "other_sha256": np.array("o"), "actions": acts}
    one_off = acts.copy()
    one_off[2, 3] = np.nextafter(one_off[2, 3], np.float32(2))
    proprio = proprio_of(one_off)
    summary = {"frames_sha256": "f", "other_sha256": "o", "lengths": np.array([3, 4]),
               "actions": one_off, "proprio": proprio}
    assert PS.compare_to_golden(summary, golden) == {"actions_off_by_1_ulp": 1, "actions": 49}
    if change == "frame":
        bad, match = dict(summary, frames_sha256="g"), "frames_sha256"
    elif change == "action_2_ulp":
        two_off = one_off.copy()
        two_off[2, 3] = np.nextafter(two_off[2, 3], np.float32(2))
        bad, match = dict(summary, actions=two_off), "more than 1 ULP"
    else:
        moved = proprio.copy()
        moved[5, 1] = np.nextafter(moved[5, 1], np.float32(2))
        bad, match = dict(summary, proprio=moved), "running sum"
    with pytest.raises(AssertionError, match=match):
        PS.compare_to_golden(bad, golden)


def test_time_jpeg_host_compares_decoder_sources(tmp_path):
    """The decoder timing script on two copies of the decoder: both timed
    under ISLOW and IFAST, their pixels bitwise equal; a copy that decodes
    differently is refused."""
    from openvla_oft_tpu_torch import _host_build
    from openvla_oft_tpu_torch.scripts import time_jpeg_host as TJ

    src = _host_build.HOST_SRC_DIR / "jpeg_decode.cc"
    out = TJ.run([src, src], n_frames=2, repeats=1)
    assert [(d["idct"], d["src"]) for d in out["decoders"]] == \
        [("islow", str(src))] * 2 + [("ifast", str(src))] * 2
    assert all(d["ms_median"] > 0 for d in out["decoders"]) and out["encode_ms"]["min"] > 0
    broken = tmp_path / "jpeg_decode.cc"
    broken.write_text(src.read_text().replace("o[0] = clamp255(Y + ((cr_r * R + kHalf) >> 16));",
                                              "o[0] = clamp255(Y + 1);"))
    with pytest.raises(AssertionError, match="decode differently"):
        TJ.run([src, broken], n_frames=2, repeats=1)


def test_quickstart_fixture_equals_the_committed_pickle(tmp_path):
    before = FIXTURE.stat().st_mtime_ns
    out = QF.main(["--out", str(tmp_path / "obs.pkl")])
    with open(out, "rb") as f:
        got = pickle.load(f)
    with open(FIXTURE, "rb") as f:
        want = pickle.load(f)
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype and got[key].shape == value.shape
            assert got[key].tobytes() == value.tobytes(), key
        else:
            assert type(got[key]) is type(value) and got[key] == value, key
    assert FIXTURE.stat().st_mtime_ns == before
    assert Path(QF.DEFAULT_OUT).resolve() != FIXTURE


def test_roundtrip_tiny_on_the_cpu(tmp_path):
    out = RT.main(["--scale", "tiny", "--device", "cpu", "--out", str(tmp_path / "ckpt")])
    assert out["leaf_bytes"] > 0 and out["bytes"] > out["leaf_bytes"] // 2
    assert out["chunk"].shape == (1, 8, 7) and torch.isfinite(out["chunk"]).all()
    assert not (tmp_path / "ckpt").exists()                 # removed without --keep
    RT.main(["--scale", "tiny", "--device", "cpu", "--out", str(tmp_path / "kept"), "--keep",
             "--no_forward"])
    assert (tmp_path / "kept" / "model.safetensors").exists()


@pytest.mark.parametrize("where", ["leaf", "chunk"])
def test_roundtrip_fails_on_a_changed_leaf_or_chunk(tmp_path, monkeypatch, where):
    from openvla_oft_tpu_torch.utils import hf_import

    if where == "leaf":
        real = hf_import.load_openvla_checkpoint

        def load(*a, **kw):
            cfg, params, stats = real(*a, **kw)
            w = params["llm"]["layers"]["attn"]["wq"]["kernel"]
            w.view(torch.int16)[0, 0, 0] ^= 1                 # one bit of one leaf
            return cfg, params, stats

        monkeypatch.setattr(hf_import, "load_openvla_checkpoint", load)
        match = "bytes differ"
    else:
        real = RT.action_chunk
        calls = []

        def chunk(*a):
            calls.append(1)
            out = real(*a)
            return out if len(calls) == 1 else out + 1e-3

        monkeypatch.setattr(RT, "action_chunk", chunk)
        match = "action chunk changed"
    with pytest.raises(AssertionError, match=match):
        RT.run("tiny", str(tmp_path / "ckpt"), device="cpu")
