"""The VLM data path against the JAX package's, and the host data ops.

- `data/vlm_datasets.py::VLMPretrainDataset` against JAX's on the same
  LLaVA JSON (JPEGs PIL writes here), in the align and finetune stages and
  under two resize strategies ("resize-naive", "letterbox"): the example
  order, ids and labels equal; the decoded frames bitwise PIL's (the port
  decodes with the ISLOW inverse DCT, JAX with PIL); the pixels after the
  processor transform within 1e-5 (the two frameworks' resize products sum
  in other orders; eval-API tests hold the transform to the same bound).
- `data/batching.py::grouped_batch_iterator` against JAX's: the same
  batches, bitwise.
- `utils/native.py` (the host library's `hostsrc/data_ops.cc`) against the
  plain versions, mirroring `tests/test_native.py`: `pad_stack` against the
  collator's NumPy `_pad_stack`, the attention mask, the action tokenizer's
  encode and decode, the image normalize.
"""

import dataclasses
import json

import numpy as np
import pytest

from openvla_oft_tpu.config import OpenVLAConfig
from openvla_oft_tpu.data import vlm_datasets as JV
from openvla_oft_tpu.data.batching import grouped_batch_iterator as j_grouped
from openvla_oft_tpu.data.collator import PaddedCollatorForActionPrediction as JCollator
from openvla_oft_tpu.processing.processor import PrismaticProcessor as JProcessor
from openvla_oft_tpu_torch.data import vlm_datasets as PV
from openvla_oft_tpu_torch.data.batching import grouped_batch_iterator as p_grouped
from openvla_oft_tpu_torch.data.collator import PaddedCollatorForActionPrediction as PCollator
from openvla_oft_tpu_torch.data.collator import _pad_stack
from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor as PProcessor
from openvla_oft_tpu_torch.utils import native
from test_torch_import import port_config

CFG = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama")


@pytest.fixture(scope="module")
def llava(tmp_path_factory):
    """A LLaVA JSON of 8 records: JPEGs of several sizes, grey and colour,
    4:2:0 and 4:4:4; dialogues of 2 and 4 turns; one record without an image."""
    from PIL import Image

    from test_torch_jpeg_decode import scene

    root = tmp_path_factory.mktemp("llava")
    (root / "images").mkdir()
    recs = []
    for i in range(8):
        h, w = 24 + 9 * i, 40 + 5 * (i % 3)
        a = scene(h, w, seed=i, noise=10.0)
        im = Image.fromarray(a[..., 0] if i == 3 else a)
        im.save(root / "images" / f"{i}.jpg", quality=60 + 5 * i, subsampling=0 if i % 2 else 2)
        turns = [{"from": "human", "value": f"<image>\nWhat is in picture {i}?"},
                 {"from": "gpt", "value": f"A table and {i} blocks."}]
        if i % 2:
            turns += [{"from": "human", "value": "Which colour?"},
                      {"from": "gpt", "value": "Red and green, mostly."}]
        recs.append({"id": str(i), "image": f"{i}.jpg", "conversations": turns})
    recs.append({"id": "text", "conversations": [{"from": "human", "value": "hi"},
                                                 {"from": "gpt", "value": "hello"}]})
    (root / "chat.json").write_text(json.dumps(recs))
    return str(root / "chat.json"), str(root / "images")


@pytest.mark.parametrize("strategy", ["resize-naive", "letterbox"])
@pytest.mark.parametrize("stage", ["align", "finetune"])
def test_vlm_dataset_matches_jax(llava, stage, strategy):
    js, images = llava
    cfg = dataclasses.replace(CFG, image_resize_strategy=strategy)
    kw = dict(stage=stage, llm_backbone_id="llama2-7b-pure", shuffle_seed=3, max_length=24)
    want = list(JV.VLMPretrainDataset(js, images, JProcessor(cfg), **kw))
    got = list(PV.VLMPretrainDataset(js, images, PProcessor(port_config(cfg)), **kw))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert g["input_ids"].dtype == w["input_ids"].dtype
        assert g["pixel_values"].shape == w["pixel_values"].shape
        np.testing.assert_allclose(g["pixel_values"], np.asarray(w["pixel_values"]),
                                   rtol=0, atol=1e-5)
        assert len(g["input_ids"]) <= 24 and g["labels"][0] == -100
        assert g["dataset_name"] == w["dataset_name"]


def test_vlm_dataset_decodes_pils_pixels(llava):
    from PIL import Image

    js, images = llava
    for rec in json.load(open(js)):
        if "image" in rec:
            path = f"{images}/{rec['image']}"
            np.testing.assert_array_equal(PV.load_image(path),
                                          np.asarray(Image.open(path).convert("RGB")))


def test_vlm_dataset_refuses_what_is_not_a_baseline_jpeg(tmp_path):
    """A file of a format the reader refuses (GIF, BMP) raises naming the
    file; PNG and progressive JPEG files, refused before, now load."""
    from PIL import Image

    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(tmp_path / "a.gif")
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(tmp_path / "b.bmp")
    recs = [{"id": n, "image": n, "conversations": [{"from": "human", "value": "q"},
                                                    {"from": "gpt", "value": "a"}]}
            for n in ("a.gif", "b.bmp")]
    for rec in recs:
        (tmp_path / "d.json").write_text(json.dumps([rec]))
        ds = PV.VLMPretrainDataset(str(tmp_path / "d.json"), str(tmp_path),
                                   PProcessor(port_config(CFG)))
        with pytest.raises(ValueError, match=rec["image"]):
            next(iter(ds))
    frame = np.random.default_rng(3).integers(0, 256, (20, 28, 3), np.uint8)
    Image.fromarray(frame).save(tmp_path / "c.png")
    Image.fromarray(frame).save(tmp_path / "d.jpg", progressive=True, subsampling=1)
    for name in ("c.png", "d.jpg"):
        np.testing.assert_array_equal(PV.load_image(str(tmp_path / name)),
                                      np.asarray(Image.open(tmp_path / name).convert("RGB")))


def test_vlm_dataset_registry_matches_jax():
    assert PV.VLM_DATASET_REGISTRY == JV.VLM_DATASET_REGISTRY
    for name in JV.VLM_DATASET_REGISTRY:
        for stage in ("align", "finetune"):
            assert PV.resolve_vlm_dataset(name, stage, "/data") == \
                JV.resolve_vlm_dataset(name, stage, "/data")
    with pytest.raises(KeyError):
        PV.resolve_vlm_dataset("nope", "align", "/data")


@pytest.mark.parametrize("batch_size,buckets", [(4, (64, 96, 128)), (3, (16, 40))])
def test_grouped_batch_iterator_matches_jax(batch_size, buckets):
    rng = np.random.default_rng(1)
    examples = []
    for n in rng.integers(4, buckets[-1] + 1, 50):
        ids = rng.integers(3, 30000, int(n)).astype(np.int32)
        labels = np.where(rng.random(int(n)) < 0.5, -100, ids).astype(np.int32)
        examples.append({"input_ids": ids, "labels": labels,
                         "pixel_values": rng.random((1, 2, 4, 4, 3)).astype(np.float32)})
    want = list(j_grouped(iter(examples), batch_size, JCollator(), buckets=buckets))
    got = list(p_grouped(iter(examples), batch_size, PCollator(), buckets=buckets))
    assert len(got) == len(want) and sum(len(b["input_ids"]) for b in got) == 50
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


# === utils/native.py against the plain versions (tests/test_native.py) ===

def test_pad_stack_against_the_plain_version(rng):
    seqs = [rng.integers(0, 100, n).astype(np.int32) for n in (3, 7, 5, 0, 8)]
    for fill in (-1, 32000, -100):
        np.testing.assert_array_equal(native.pad_stack(seqs, 8, fill), _pad_stack(seqs, 8, fill))
    assert native.pad_stack([], 4, 0).shape == (0, 4)
    with pytest.raises(ValueError, match="exceeds target 8"):
        native.pad_stack([np.arange(9, dtype=np.int32)], target=8, fill=0)


def test_attention_mask():
    np.testing.assert_array_equal(native.attention_mask([2, 5, 0], target=6),
                                  [[1, 1, 0, 0, 0, 0], [1, 1, 1, 1, 1, 0], [0] * 6])


def test_encode_decode_against_the_action_tokenizer(rng):
    from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer

    at = ActionTokenizer()
    actions = rng.uniform(-1.2, 1.2, (64, 7)).astype(np.float32)
    ref_ids = at.encode_to_token_ids(actions)
    got_ids = native.encode_actions(actions)
    # float rounding at a bin edge may move a rare bin by one
    assert (ref_ids != got_ids).mean() < 0.01
    assert np.abs(ref_ids.astype(int) - got_ids).max() <= 1
    np.testing.assert_allclose(native.decode_actions(ref_ids.astype(np.int32)),
                               at.decode_token_ids_to_actions(ref_ids), rtol=1e-5, atol=1e-6)


def test_normalize_image_against_numpy(rng):
    img = (rng.random((2, 16, 16, 3)) * 255).astype(np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    ref = (img.astype(np.float32) / 255.0 - np.asarray(mean, np.float32)) \
        / np.asarray(std, np.float32)
    np.testing.assert_allclose(native.normalize_image(img, mean, std), ref,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(native.normalize_image(img, 0.5, 0.5),
                               (img.astype(np.float32) / 255.0 - 0.5) / 0.5, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="3"):
        native.normalize_image(img[..., :2], mean, std)


def test_collator_against_the_jax_collator(rng):
    exs = [{"input_ids": rng.integers(3, 100, n).astype(np.int32),
            "labels": rng.integers(3, 100, n).astype(np.int32),
            "pixel_values": rng.random((1, 2, 4, 4, 3)).astype(np.float32),
            "actions": rng.random((8, 7)).astype(np.float32)} for n in (5, 11, 2)]
    for kw in (dict(), dict(max_length=16), dict(pad_to_multiple=4)):
        want, got = JCollator(**kw)(exs), PCollator(**kw)(exs)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="exceeds bucket"):
        PCollator(max_length=8)(exs)

