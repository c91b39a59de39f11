"""The port's full-training and VLM scripts and the modules they stand on, on the CPU.

- `scripts/train.py` (each stage, 2 steps on dummy data, also from a
  checkpoint dir) and `scripts/pretrain.py` (both stages on a tiny LLaVA
  JSON whose JPEGs PIL writes here): the step count, finite metrics, the
  checkpoint restored bitwise equal to the trained state (the bf16 moments
  too). `--mesh_*` runs are in `test_torch_parallel_scripts.py`.
- `scripts/generate.py`: the REPL over stdin (in process and as a CLI with
  piped input) on `random:tiny`.
- `scripts/build_instruct_mixtures.py`: the same JSON files as the JAX
  script's, byte for byte.
- `models/registry.py`: the 49 + 5 rows equal to the JAX registry's, `load`
  and `load_vla` on a dir written here (bitwise the exported tree), and a
  registered id that is not local raising `FileNotFoundError` with its hub
  repo.
- Mirrors of `tests/test_misc_components.py`'s registry, overwatch, batcher
  and VLM-dataset cases on the port's modules.
"""

import dataclasses
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_oft_tpu_torch.bridge import tree_leaves
from openvla_oft_tpu_torch.scripts import generate as PG
from openvla_oft_tpu_torch.scripts import pretrain as PP
from openvla_oft_tpu_torch.scripts import train as PT
from openvla_oft_tpu_torch.training.checkpoint import restore_checkpoint

ROOT = Path(__file__).resolve().parents[1]


def _train_cfg(tmp_path, stage, **kw):
    return PT.TrainConfig(vla_id="tiny", stage=stage, pretrained_checkpoint="random:tiny",
                          data_root_dir=Path("dummy"), dataset_name="libero_dummy",
                          batch_size=2, max_steps=2, save_interval=2, run_root_dir=tmp_path,
                          learning_rate=1e-2, device="cpu", **kw)


def _assert_restores_bitwise(out, with_optimizer=True):
    restored = restore_checkpoint(str(Path(out["run_dir"]) / "ckpt"), out["final_step"])
    state = out["state"]
    got, want = tree_leaves(restored["trainables"]), tree_leaves(state.trainables)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b.detach())
    if with_optimizer:
        opt = state.optimizer.state_dict()
        saved = restored["optimizer"]
        if state.optimizer.low is not None:
            for a, b in zip(saved["bf16_adamw"]["mu"] + saved["bf16_adamw"]["nu"],
                            opt["bf16_adamw"]["mu"] + opt["bf16_adamw"]["nu"]):
                assert torch.equal(a, b)
            assert saved["bf16_adamw"]["count"] == opt["bf16_adamw"]["count"] == 2
        if state.optimizer.adamw is not None:
            for k, st in opt["adamw"]["state"].items():
                for name in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(saved["adamw"]["state"][k][name], st[name])
    else:
        assert "optimizer" not in restored


@pytest.mark.parametrize("stage", list(PT.STAGE_TRAINABLE))
def test_train_each_stage(tmp_path, stage):
    seen = []
    out = PT.train(_train_cfg(tmp_path, stage),
                   on_step=lambda i, m, s: seen.append((i, m)))
    assert out["final_step"] == 2 and [i for i, _ in seen] == [0, 1]
    for _, m in seen:
        assert np.isfinite(m["loss"]) and m["grad_norm"] > 0 and m["step_time"] > 0
    state = out["state"]
    assert sorted(state.trainables) == sorted(PT.STAGE_TRAINABLE[stage])
    assert all(t.requires_grad for t in tree_leaves(state.trainables))
    assert not any(t.requires_grad for t in tree_leaves(state.base_params))
    _assert_restores_bitwise(out)
    lines = (Path(out["run_dir"]) / "tiny+stage-{}+x7-metrics.jsonl".format(stage)).read_text()
    assert "loss" in lines


def test_train_from_a_checkpoint_dir_and_on_episodes(tmp_path):
    """`--pretrained_checkpoint DIR` (bf16, projector included) and RLDS
    episode shards: the statistics land in the run dir."""
    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.data.rlds.pipeline import write_episode_tfrecords
    from openvla_oft_tpu_torch.utils.hf_import import export_openvla_checkpoint
    from test_torch_jpeg_decode import load_golden

    cfg = PT.model_config("random:tiny")
    params, _ = PT.build_full_model("random:tiny", cfg, get_platform("libero"),
                                    torch.device("cpu"), 0)
    ckpt = export_openvla_checkpoint(cfg, params, str(tmp_path / "ckpt"))
    frames = [d for n, d, _ in load_golden() if n.endswith("48x64") and "grey" not in n]
    rng = np.random.default_rng(0)
    episodes = [{"images": [frames[(e + i) % len(frames)] for i in range(8)],
                 "wrist_images": [frames[(e + 2 * i) % len(frames)] for i in range(8)],
                 "actions": rng.uniform(-0.5, 0.5, (8, 7)), "proprio": rng.standard_normal((8, 8)),
                 "language_instruction": f"put the bowl on plate {e}"} for e in range(2)]
    write_episode_tfrecords(str(tmp_path / "data" / "libero_spatial_no_noops"), episodes)
    out = PT.train(dataclasses.replace(
        _train_cfg(tmp_path, "vla-train"), pretrained_checkpoint=ckpt,
        data_root_dir=tmp_path / "data", dataset_name="libero_spatial_no_noops",
        shuffle_buffer_size=8))
    assert out["final_step"] == 2
    assert {t.dtype for t in tree_leaves(out["state"].trainables)} == {torch.bfloat16}
    assert (Path(out["run_dir"]) / "dataset_statistics.json").exists()
    _assert_restores_bitwise(out)


def _llava(tmp_path, n=6):
    """A tiny LLaVA JSON with JPEGs PIL writes, two turns of dialogue each."""
    from PIL import Image

    rng = np.random.default_rng(0)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    recs = []
    for i in range(n):
        a = rng.integers(0, 256, (40 + 8 * i, 56, 3), dtype=np.uint8)
        Image.fromarray(a).save(img_dir / f"{i}.jpg", quality=90)
        recs.append({"id": str(i), "image": f"{i}.jpg", "conversations": [
            {"from": "human", "value": "<image>\nDescribe the picture."},
            {"from": "gpt", "value": f"a picture number {i} with some words"},
            {"from": "human", "value": "And then?"},
            {"from": "gpt", "value": "more words here"}]})
    path = tmp_path / "chat.json"
    path.write_text(json.dumps(recs))
    return str(path), str(img_dir)


@pytest.mark.parametrize("stage", ["align", "finetune"])
def test_pretrain_each_stage(tmp_path, stage):
    js, images = _llava(tmp_path)
    seen = []
    out = PP.pretrain(PP.PretrainConfig(stage=stage, pretrained_checkpoint="random:tiny",
                                        llava_json=js, image_root=images, batch_size=4,
                                        max_steps=2, save_interval=2, run_root_dir=tmp_path,
                                        seq_bucket=32, device="cpu"),
                      on_step=lambda i, m, s: seen.append(m))
    assert out["final_step"] == 2 and len(seen) == 2
    assert all(np.isfinite(m["loss"]) for m in seen)
    assert sorted(out["state"].trainables) == sorted(PP.STAGE_TRAINABLE[stage])
    _assert_restores_bitwise(out, with_optimizer=False)


def test_pretrain_resolves_a_named_variant(tmp_path):
    js, images = _llava(tmp_path)
    root = tmp_path / "root"
    align = root / "download" / "llava-laion-cc-sbu-558k"
    align.parent.mkdir(parents=True)
    shutil.copytree(images, align)
    shutil.copy(js, align / "chat.json")
    out = PP.pretrain(PP.PretrainConfig(stage="align", pretrained_checkpoint="random:tiny",
                                        dataset_id="llava-v15", dataset_root_dir=str(root),
                                        batch_size=2, max_steps=1, run_root_dir=tmp_path,
                                        seq_bucket=32, device="cpu"))
    assert out["final_step"] == 1 and out["ckpt"].endswith("000001.pt")


def test_unknown_stage_and_cuda_without_a_card(tmp_path):
    with pytest.raises(ValueError, match="unknown stage"):
        PT.train(_train_cfg(tmp_path, "vla-everything"))
    with pytest.raises(ValueError, match="unknown stage"):
        PP.pretrain(PP.PretrainConfig(stage="instruct", device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PT.train(dataclasses.replace(_train_cfg(tmp_path, "vla-train"), device="cuda"))


def test_vit_fused_refuses_a_trained_vision_backbone(tmp_path):
    from openvla_oft_tpu_torch.ops.vit_fused import vit_fused

    with vit_fused(True), pytest.raises(ValueError, match="no backward"):
        PT.train(_train_cfg(tmp_path, "vla-full-train"))


def test_generate_in_process(tmp_path):
    from PIL import Image

    img = tmp_path / "x.jpg"
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (48, 64, 3), np.uint8)).save(img)
    cfg = PG.GenerateConfig(model_path="random:tiny", image_path=str(img), max_new_tokens=4,
                            device="cpu")
    answers = PG.generate(cfg, io.StringIO("what is on the table?\nand then?\n"))
    assert len(answers) == 2
    for a in answers:
        toks = a.split()
        assert len(toks) == 4 and all(t.startswith("<") and t.endswith(">") for t in toks)
    assert PG.generate(cfg, io.StringIO("what is on the table?\n")) == answers[:1]
    (tmp_path / "x.png").write_bytes(b"\x89PNG\r\n")
    with pytest.raises(ValueError, match="x.png"):
        PG.generate(dataclasses.replace(cfg, image_path=str(tmp_path / "x.png")),
                    io.StringIO("q\n"))


def test_generate_cli_over_stdin():
    proc = subprocess.run(
        [sys.executable, "-m", "openvla_oft_tpu_torch.scripts.generate", "--model_path",
         "random:tiny", "--max_new_tokens", "3", "--device", "cpu"],
        input="describe the scene\n", capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(">>> <")]
    assert len(lines) == 1 and len(lines[0].split()) == 4


def _mixture_inputs(base):
    (base / "lrv").mkdir(parents=True)
    json.dump([{"id": f"b{i}", "image": "x.jpg",
                "conversations": [{"from": "human", "value": "<image>\nq"},
                                  {"from": "gpt", "value": f"a{i}"}]} for i in range(5)],
              open(base / "llava_v1_5_mix665k.json", "w"))
    json.dump([{"id": f"l{i}", "image": "y.jpg", "conversations": []} for i in range(3)],
              open(base / "lvis_instruct4v_220k.json", "w"))
    json.dump([{"image_id": "12", "question": " why? ", "answer": " so. "}],
              open(base / "lrv" / "filter_cap1.json", "w"))
    json.dump([{"image_id": "13", "question": "how", "answer": "thus"}],
              open(base / "lrv" / "filter_cap_more1.json", "w"))
    json.dump([{"image_id": "c.png", "question": "q2", "answer": "a2"}],
              open(base / "lrv" / "chart_release_update.json", "w"))


def test_build_instruct_mixtures_match_jax(tmp_path):
    """The port's script writes the JAX script's files byte for byte
    (the reference's seed-7, three-shuffle order), and mirrors
    tests/test_misc_components.py::test_build_instruct_mixtures."""
    sys.path.insert(0, str(ROOT))
    from vla_scripts import build_instruct_mixtures as J
    from openvla_oft_tpu_torch.scripts import build_instruct_mixtures as M

    names = ("llava_v1_5_lvis4v_mix888k.json", "llava_v1_5_lrv_mix1008k.json",
             "llava_v1_5_lvis4v_lrv_mix1231k.json")
    for side, mod in (("jax", J), ("port", M)):
        _mixture_inputs(tmp_path / side)
        mod.main(mod.MixtureConfig(base_dir=tmp_path / side, build="all", verify_images=False))
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    mix1008 = json.load(open(tmp_path / "port" / names[1]))
    assert len(mix1008) == 5 + 3
    lrv_ex = [e for e in mix1008 if e["id"] == "12"][0]
    assert lrv_ex["image"] == "lrv/lrv-vg/12.jpg"
    assert lrv_ex["conversations"][0]["value"] == "<image>\nwhy?"
    with pytest.raises(AssertionError):
        M.build_lvis4v_mixture(tmp_path / "port", verify_images=True)


# === models/registry.py ===

def test_registry_rows_match_jax():
    from openvla_oft_tpu.models import registry as J
    from openvla_oft_tpu_torch.models import registry as R

    assert R.available_models() == J.available_models()
    assert len(R.MODEL_REGISTRY) == 54
    assert sum(e.is_vla for e in R.MODEL_REGISTRY.values()) == 5
    for mid, e in J.MODEL_REGISTRY.items():
        assert dataclasses.asdict(R.MODEL_REGISTRY[mid]) == dataclasses.asdict(e), mid
        assert R.get_model_description(mid) == J.get_model_description(mid)


def test_model_registry():
    """Mirror of tests/test_misc_components.py::test_model_registry."""
    from openvla_oft_tpu_torch.models.registry import (available_models, get_model_description,
                                                       load, load_vla)

    assert "openvla-7b-oft-finetuned-libero-spatial" in available_models()
    assert "LIBERO-Spatial" in get_model_description("openvla-7b-oft-finetuned-libero-spatial")
    with pytest.raises(FileNotFoundError, match="openvla/openvla-7b"):
        load("openvla-7b", device="cpu")
    with pytest.raises(FileNotFoundError, match="moojink/openvla-7b-oft-finetuned-libero-10"):
        load_vla("openvla-7b-oft-finetuned-libero-10", device="cpu")
    with pytest.raises(FileNotFoundError, match="not found locally"):
        load("someone/some-model", device="cpu")


def test_model_registry_full_prismatic_breadth():
    """Mirror of test_misc_components.py::test_model_registry_full_prismatic_breadth."""
    import openvla_oft_tpu_torch.config as C
    from openvla_oft_tpu_torch.models.registry import MODEL_REGISTRY

    vlms = {mid: e for mid, e in MODEL_REGISTRY.items() if not e.is_vla}
    assert len(vlms) == 49
    for e in vlms.values():
        assert e.vision_backbone_id in C._VISION_REGISTRY, e.model_id
        assert e.llm_backbone_id in C._LLM_REGISTRY, e.model_id
        assert e.image_resize_strategy in ("resize-naive", "resize-crop", "letterbox")
    assert vlms["prism-dinosiglip-224px+7b"].vision_backbone_id == "dinosiglip-vit-so-224px"
    assert vlms["prism-siglip+13b"].vision_backbone_id == "clip-vit-l-336px"


def test_load_and_load_vla_from_a_local_dir(tmp_path):
    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.models import registry as R
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy
    from openvla_oft_tpu_torch.utils.hf_import import export_openvla_checkpoint

    cfg = PT.model_config("random:tiny")
    params, _ = PT.build_full_model("random:tiny", cfg, get_platform("libero"),
                                    torch.device("cpu"), 0, use_proprio=False)
    d = export_openvla_checkpoint(cfg, params, str(tmp_path / "openvla-7b"))
    got_cfg, got, _ = R.load(d, device="cpu")
    assert got_cfg.llm == cfg.llm
    for a, b in zip(tree_leaves(got), tree_leaves({k: params[k] for k in got})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a registered id found under cache_dir, with the entry's head and platform
    policy = R.load_vla("openvla-7b", cache_dir=str(tmp_path), device="cpu")
    assert isinstance(policy, OpenVLAPolicy)
    assert policy.head == "discrete" and policy.platform.name == "bridge"
    with pytest.raises(ValueError, match="not a VLA"):
        R.load_vla("prism-dinosiglip-224px+7b", cache_dir=str(tmp_path), device="cpu")


# === Mirrors of tests/test_misc_components.py ===

def test_overwatch_rank_zero():
    from openvla_oft_tpu_torch.utils.overwatch import initialize_overwatch

    ow = initialize_overwatch("test")
    assert ow.is_rank_zero() and ow.rank == 0
    calls = []
    ow.rank_zero_only(lambda: calls.append(1))()
    assert calls == [1]


def test_length_grouped_batcher():
    from openvla_oft_tpu_torch.data.batching import LengthGroupedBatcher

    rng = np.random.default_rng(0)
    examples = [{"input_ids": np.zeros(int(n), np.int32)} for n in rng.integers(10, 120, 64)]
    batches = list(LengthGroupedBatcher(batch_size=4, buckets=(64, 96, 128))(iter(examples)))
    assert batches
    seen = 0
    for bucket, group in batches:
        assert len(group) <= 4
        assert all(len(e["input_ids"]) <= bucket for e in group)
        seen += len(group)
    assert seen == 64
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        list(LengthGroupedBatcher(4, buckets=(8,))([{"input_ids": np.zeros(9)}]))


def test_vlm_pretrain_dataset(tmp_path):
    import openvla_oft_tpu_torch.config as C
    from PIL import Image
    from openvla_oft_tpu_torch.constants import IGNORE_INDEX
    from openvla_oft_tpu_torch.data.vlm_datasets import VLMPretrainDataset
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor

    cfg = C.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama")
    rng = np.random.default_rng(0)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(img_dir / "0.jpg")
    recs = [{"id": "0", "image": "0.jpg", "conversations": [
        {"from": "human", "value": "<image>\nDescribe."},
        {"from": "gpt", "value": "A pattern."}]}]
    jp = tmp_path / "d.json"
    jp.write_text(json.dumps(recs))
    PT.model_config("random:tiny")                    # registers the tiny entries
    ds = VLMPretrainDataset(str(jp), str(img_dir), PrismaticProcessor(cfg), stage="align",
                            llm_backbone_id="tiny-llama")
    ex = next(iter(ds))
    assert ex["pixel_values"].shape[0] == 1
    assert (ex["labels"] == IGNORE_INDEX).sum() > 0
    assert (ex["labels"] != IGNORE_INDEX).sum() > 0
