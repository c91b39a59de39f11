"""The port's fine-tuning CLI (`openvla_oft_tpu_torch.training.finetune`).

Its data path is held against the JAX package's (`DummyDataset` and
`RLDSBatchTransform` with the JAX processor): the same seed gives the same
arrays, token ids exactly and pixels to 1e-6. A 2-step `random:tiny` run on
the CPU writes its metrics JSONL and its checkpoint, and every flag for a
feature that is not ported raises at startup.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.data.collator import PaddedCollatorForActionPrediction, batch_iterator
from openvla_oft_tpu.data.datasets import DummyDataset as JaxDummy
from openvla_oft_tpu.data.datasets import RLDSBatchTransform as JaxTransform
from openvla_oft_tpu.processing.action_tokenizer import ActionTokenizer
from openvla_oft_tpu.processing.processor import PrismaticProcessor as JaxProcessor
from openvla_oft_tpu.training import recipes as jax_recipes
from openvla_oft_tpu_torch.data import collator as port_collator
from openvla_oft_tpu_torch.data.datasets import DummyDataset, RLDSBatchTransform
from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer as PortTokenizer
from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor
from openvla_oft_tpu_torch.training import finetune as FT
from openvla_oft_tpu_torch.training.checkpoint import latest_step, restore_checkpoint
from openvla_oft_tpu_torch.training.recipes import RECIPES, apply_recipe
from test_torch_import import port_config, port_platform
from test_training import CFG
from vla_scripts import finetune as jax_finetune

TINY_RUN = ["--device", "cpu", "--vla_path", "random:tiny", "--data_root_dir", "dummy",
            "--robot_platform", "libero", "--use_l1_regression", "True",
            "--use_proprio", "True", "--num_images_in_input", "2", "--lora_rank", "4",
            "--merge_lora_during_training", "False", "--wandb_log_freq", "1"]


@pytest.mark.parametrize("num_images", [1, 2])
def test_dummy_dataset_matches_jax(num_images):
    cfg = dataclasses.replace(CFG, num_images_in_input=num_images)
    kw = dict(image_size=cfg.vision_configs[0].image_size, num_samples=6,
              num_images=num_images, seed=3)
    port = DummyDataset(RLDSBatchTransform(PrismaticProcessor(port_config(cfg)),
                                           PortTokenizer(), port_platform(LIBERO)), **kw)
    ref = JaxDummy(JaxTransform(JaxProcessor(cfg), ActionTokenizer(), LIBERO), **kw)
    # Each side batches with its own collator (the port's pads with NumPy).
    collate = port_collator.PaddedCollatorForActionPrediction(pad_token_id=cfg.pad_token_id)
    collator = PaddedCollatorForActionPrediction(pad_token_id=cfg.pad_token_id)
    pairs = list(zip(port_collator.batch_iterator(port, 2, collate),
                     batch_iterator(ref, 2, collator)))
    assert len(pairs) == 3
    for got, want in pairs:
        assert set(got) == set(want)
        for key in want:
            if key == "pixel_values":
                assert got[key].shape == (2, num_images, 2, 28, 28, 3)
                np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6)
            else:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key])


def test_tiny_run_writes_metrics_and_checkpoint(tmp_path):
    out = FT.main(TINY_RUN + ["--batch_size", "2", "--max_steps", "2",
                              "--run_root_dir", str(tmp_path)])
    assert out["final_step"] == 2
    run_dir = Path(out["run_dir"])
    rows = [json.loads(line) for f in run_dir.glob("*-metrics.jsonl")
            for line in f.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        for key in ("loss", "grad_norm", "curr_action_l1_loss", "next_actions_l1_loss"):
            assert np.isfinite(r[key]) and r[key] > 0, (key, r)
    assert (run_dir / "dataset_statistics.json").exists()
    ckpt_dir = run_dir / "ckpt"
    assert latest_step(str(ckpt_dir)) == 2 and out["ckpt"] == str(ckpt_dir / "000002.pt")
    state = restore_checkpoint(str(ckpt_dir))
    assert set(state["trainables"]) == {"lora", "action_head", "proprio_projector"}
    assert state["optimizer"]["scheduler"]["last_epoch"] == 2
    # LoRA B starts at zero; two updates moved it.
    b = state["trainables"]["lora"]["llm"]["layers"]["attn"]["wq"]["b"]
    assert b.abs().max() > 0


UNPORTED = [
    (["--use_diffusion", "True", "--use_l1_regression", "False"], "diffusion"),
    (["--use_l1_regression", "False"], "discrete"),
    (["--use_film", "True"], "use_film"),
    (["--quantize_base", "True"], "quantize_base"),
    (["--use_val_set", "True"], "use_val_set"),
    (["--resume", "True"], "resume"),
    (["--merge_lora_during_training", "True"], "merge_lora"),
    (["--multihost", "True"], "multihost"),
    (["--mesh_fsdp", "2"], "mesh"),
    (["--remat_policy", "dots"], "remat_policy dots"),
    (["--data_root_dir", "datasets/rlds"], "RLDS"),
    (["--vla_path", "openvla/openvla-7b"], "checkpoint"),
    (["--robot_platform", "aloha"], "aloha"),
]


@pytest.mark.parametrize("flags,what", UNPORTED, ids=[w for _, w in UNPORTED])
def test_unported_flags_raise(tmp_path, flags, what):
    with pytest.raises(NotImplementedError, match=what):
        FT.main(TINY_RUN + flags + ["--max_steps", "1", "--run_root_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())         # raised before any work


def test_unknown_use_flash_attention_is_rejected(tmp_path):
    """The JAX CLI maps an unknown value to "auto"; the port raises."""
    assert FT._use_flash(" TRUE ") is True and FT._use_flash("Auto") == "auto"
    with pytest.raises(ValueError, match="use_flash_attention"):
        FT.main(TINY_RUN + ["--use_flash_attention", "yes", "--run_root_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_cuda_device_never_falls_back_to_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FT.main(TINY_RUN[2:] + ["--device", "cuda", "--run_root_dir", str(tmp_path)])


def test_libero_recipe_passes_the_startup_checks():
    cfg = apply_recipe(FT.TorchFinetuneConfig(vla_path="random:7b",
                                              data_root_dir=Path("dummy"),
                                              merge_lora_during_training=False),
                       "oft-libero-spatial")
    assert (cfg.use_l1_regression, cfg.use_proprio, cfg.num_images_in_input,
            cfg.lora_rank, cfg.robot_platform) == (True, True, 2, 32, "libero")
    assert FT.unported_flags(cfg) == []


def test_finetune_config_and_run_id_match_jax():
    """The port's copy of FinetuneConfig has the JAX CLI's flags and
    defaults, and the same run id."""
    port, ref = FT.FinetuneConfig(), jax_finetune.FinetuneConfig()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for kw in ({}, {"run_id_note": "x", "image_aug": False, "batch_size": 4,
                    "grad_accumulation_steps": 2}, {"run_id_override": "mine"},
               {"resume": True, "vla_path": "runs/a--b--20000_chkpt"}):
        assert FT.get_run_id(FT.FinetuneConfig(**kw)) == \
            jax_finetune.get_run_id(jax_finetune.FinetuneConfig(**kw)), kw


def test_recipes_match_jax():
    assert RECIPES == jax_recipes.RECIPES
