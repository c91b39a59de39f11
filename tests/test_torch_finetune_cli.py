"""The port's fine-tuning CLI (`openvla_oft_tpu_torch.training.finetune`).

Its data path is held against the JAX package's (`DummyDataset` and
`RLDSBatchTransform` with the JAX processor): the same seed gives the same
arrays, token ids exactly and pixels to 1e-6. 2-step `random:tiny` runs on
the CPU write their metrics JSONL and checkpoint for each objective (L1,
diffusion with its sampling metric, discrete), for ALOHA with FiLM and from
a checkpoint dir; on RLDS episode shards written by the port's writer (L1
with image augmentation, discrete with two cameras, and validation logging
its `val_*` metrics); a hub id raises at startup. The multi-GPU flags are
tested in `test_torch_parallel_cli.py`. With the JAX CLI's defaults (`--merge_lora_during_training True`)
a run writes the reference's layout of `--N_chkpt` dirs; resume, the QLoRA
base (int8, int4), the merge script and the restart wrapper mirror the JAX
package's slow tests (test_finetune_cli.py, test_merge_script*), which run
in seconds here.
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
from openvla_oft_tpu_torch.bridge import tree_leaves
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
    assert FT.run_mesh(cfg, torch.device("cpu")) is None      # one device, no group


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


def _rows(out) -> list:
    return [json.loads(line) for f in Path(out["run_dir"]).glob("*-metrics.jsonl")
            for line in f.read_text().splitlines()]


def test_diffusion_run_logs_the_sampling_metric(tmp_path):
    """Mirrors tests/test_finetune_cli.py::test_finetune_diffusion_with_sampling_metric."""
    out = FT.main(TINY_RUN + ["--use_l1_regression", "False", "--use_diffusion", "True",
                              "--num_diffusion_steps", "4", "--diffusion_sample_freq", "1",
                              "--batch_size", "2", "--max_steps", "2",
                              "--run_root_dir", str(tmp_path)])
    assert out["final_step"] == 2
    rows = _rows(out)
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        for key in ("loss", "sampled_actions_l1_loss", "curr_action_l1_loss_sampled",
                    "next_actions_l1_loss_sampled"):
            assert np.isfinite(r[key]), (key, r)
    state = restore_checkpoint(str(Path(out["run_dir"]) / "ckpt"))
    assert set(state["trainables"]) == {"lora", "action_head", "proprio_projector",
                                        "noisy_action_projector"}
    assert "noise_predictor" in state["trainables"]["action_head"]


def test_discrete_run_logs_token_accuracy(tmp_path):
    out = FT.main(TINY_RUN + ["--use_l1_regression", "False", "--batch_size", "2",
                              "--max_steps", "2", "--run_root_dir", str(tmp_path)])
    rows = _rows(out)
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        for key in ("loss", "token_accuracy", "curr_action_accuracy", "next_actions_accuracy",
                    "curr_action_l1_loss", "next_actions_l1_loss"):
            assert np.isfinite(r[key]), (key, r)
        assert 0 <= r["token_accuracy"] <= 1
    state = restore_checkpoint(str(Path(out["run_dir"]) / "ckpt"))
    assert set(state["trainables"]) == {"lora", "proprio_projector"}


ALOHA_RUN = ["--robot_platform", "aloha", "--use_film", "True", "--num_images_in_input", "3",
             "--batch_size", "2", "--max_steps", "2"]


def test_aloha_film_run_moves_the_film_group(tmp_path):
    """OFT+ ALOHA (3 images, FiLM, a 25 x 14 chunk): the checkpoint holds the
    FiLM projectors, moved from their draw."""
    from openvla_oft_tpu_torch.constants import ALOHA as PORT_ALOHA

    argv = TINY_RUN + ALOHA_RUN + ["--run_root_dir", str(tmp_path)]
    out = FT.main(argv)
    assert out["final_step"] == 2
    state = restore_checkpoint(str(Path(out["run_dir"]) / "ckpt"))
    assert set(state["trainables"]) == {"lora", "action_head", "proprio_projector", "film"}
    cfg = FT.parse_config(argv)
    _, drawn = FT.build_model(cfg, FT.model_config(cfg), PORT_ALOHA, torch.device("cpu"))
    moved = [(a - b).abs().max().item() for a, b in zip(
        tree_leaves(state["trainables"]["film"]), tree_leaves(drawn["film"]))]
    assert len(moved) == 2 * 2 * 2 and min(moved) > 0      # 2 ViTs x scale/shift x W/b
    head = state["trainables"]["action_head"]["model"]["fc_out"]["kernel"]
    assert head.shape[-1] == PORT_ALOHA.action_dim == 14


def _tiny_checkpoint(tmp_path, head):
    """A tiny bf16 checkpoint dir written with the port's exporter, and the
    tree it holds."""
    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.constants import LIBERO as PORT_LIBERO
    from openvla_oft_tpu_torch.utils.hf_import import export_openvla_checkpoint

    cfg = FT.model_config(FT.parse_config(TINY_RUN))
    params = init_params(cfg, PORT_LIBERO, torch.Generator().manual_seed(5),
                         dtype=torch.bfloat16, head=head)
    base = {k: params[k] for k in ("llm", "vision_backbone", "projector")}
    ckpt = tmp_path / f"ckpt-{head}"
    export_openvla_checkpoint(cfg, base, str(ckpt))
    return str(ckpt), base


def _assert_bitwise(a, b, path=""):
    """Same keys, dtypes, shapes and bits."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_bitwise(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{path}/{i}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), path


@pytest.mark.parametrize("objective", ["l1", "discrete"])
def test_run_from_a_checkpoint_dir_loads_its_base_bitwise(tmp_path, objective):
    """The frozen base that trains is the dir's, bit for bit (with the
    lm_head for the discrete objective), and stays so."""
    ckpt, base = _tiny_checkpoint(tmp_path, objective)
    seen = []
    flags = ["--use_l1_regression", "False"] if objective == "discrete" else []
    out = FT.main(TINY_RUN + flags + ["--vla_path", ckpt, "--batch_size", "2",
                                      "--max_steps", "2", "--run_root_dir",
                                      str(tmp_path / "runs")],
                  on_step=lambda step, m, state: seen.append(state.base_params))
    assert out["final_step"] == 2 and len(seen) == 2
    assert ("lm_head" in seen[-1]["llm"]) == (objective == "discrete")
    _assert_bitwise(seen[-1], base)
    assert all(not t.requires_grad for t in tree_leaves(seen[-1]))


def test_discrete_run_from_a_dir_without_lm_head_names_the_key(tmp_path):
    ckpt, _ = _tiny_checkpoint(tmp_path, "l1")
    steps = []
    with pytest.raises(KeyError, match="language_model.lm_head.weight"):
        FT.main(TINY_RUN + ["--use_l1_regression", "False", "--vla_path", ckpt,
                            "--max_steps", "1", "--run_root_dir", str(tmp_path / "runs")],
                on_step=lambda *a: steps.append(a))
    assert steps == []


@pytest.mark.parametrize("vla_path", ["openvla/openvla-7b", "random:13b"])
def test_hub_id_raises_before_any_work(tmp_path, vla_path):
    """Nothing is downloaded: a vla_path that is neither random:<tiny|7b> nor
    a dir raises before the run dir is made."""
    with pytest.raises(ValueError, match="random:"):
        FT.main(TINY_RUN + ["--vla_path", vla_path, "--max_steps", "1",
                            "--run_root_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_l1_objective_and_start_line(tmp_path, capsys):
    """The objective comes from the flags as in the JAX CLI (finetune.py:191-192),
    and the start line names it."""
    for flags, objective in ((["--use_l1_regression", "True"], "l1"),
                             (["--use_l1_regression", "False", "--use_diffusion", "True"],
                              "diffusion"),
                             (["--use_l1_regression", "False"], "discrete")):
        cfg = FT.parse_config(TINY_RUN + flags)
        assert FT.objective_of(cfg) == FT.train_config(cfg).objective == objective
    FT.main(TINY_RUN + ["--use_l1_regression", "False", "--max_steps", "1",
                        "--batch_size", "1", "--run_root_dir", str(tmp_path)])
    assert "objective=discrete platform=libero" in capsys.readouterr().out


@pytest.fixture(scope="module")
def episode_root(tmp_path_factory):
    """Raw LIBERO episodes (gripper -1..1, 8-dim state, two cameras) written
    by the port's writer, the golden's JPEG bytes as frames."""
    from openvla_oft_tpu_torch.data.rlds.pipeline import write_episode_tfrecords
    from test_torch_jpeg_decode import load_golden

    frames = [d for n, d, _ in load_golden() if n.endswith("48x64") and "grey" not in n]
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("episodes")
    episodes = []
    for e in range(4):
        t = 10 + 2 * e
        actions = rng.uniform(-0.5, 0.5, (t, LIBERO.action_dim))
        actions[:, -1] = np.where(np.arange(t) % 3 == 0, -1.0, 1.0)
        episodes.append({"images": [frames[(e + i) % len(frames)] for i in range(t)],
                         "wrist_images": [frames[(e + 2 * i) % len(frames)] for i in range(t)],
                         "actions": actions, "proprio": rng.standard_normal((t, 8)),
                         "language_instruction": f"put the bowl on plate {e}"})
    write_episode_tfrecords(str(root / "libero_spatial_no_noops"), episodes)
    return str(root)


def _episode_run(root, tmp_path, *flags, on_validation=None):
    out = FT.main(TINY_RUN + ["--data_root_dir", root, "--dataset_name",
                              "libero_spatial_no_noops", "--batch_size", "2", "--max_steps",
                              "3", "--shuffle_buffer_size", "16", "--run_root_dir",
                              str(tmp_path), *flags], on_validation=on_validation)
    assert out["final_step"] == 3
    with open(Path(root) / "libero_spatial_no_noops" / "dataset_statistics.json") as f:
        written = json.load(f)
    with open(Path(out["run_dir"]) / "dataset_statistics.json") as f:
        assert json.load(f) == {"libero_spatial_no_noops": written}
    assert written["transform"] == "libero_dataset_transform"
    return out


def test_l1_run_on_episode_shards_with_image_aug(episode_root, tmp_path):
    out = _episode_run(episode_root, tmp_path, "--image_aug", "True")
    rows = _rows(out)
    assert [r["step"] for r in rows] == [0, 1, 2]
    for r in rows:
        for key in ("loss", "grad_norm", "curr_action_l1_loss"):
            assert np.isfinite(r[key]) and r[key] > 0, (key, r)
    assert out["run_dir"].endswith("--image_aug")


def test_discrete_run_on_episode_shards_two_cameras(episode_root, tmp_path):
    out = _episode_run(episode_root, tmp_path, "--use_l1_regression", "False",
                       "--num_images_in_input", "2", "--image_aug", "False")
    for r in _rows(out):
        assert np.isfinite(r["loss"]) and 0 <= r["token_accuracy"] <= 1


def test_validation_logs_val_metrics(episode_root, tmp_path):
    seen = []
    out = _episode_run(episode_root, tmp_path, "--use_val_set", "True", "--val_freq", "2",
                       "--val_time_limit", "60",
                       on_validation=lambda step, m, n: seen.append((step, m, n)))
    assert [s for s, _, _ in seen] == [1] and seen[0][2] > 0
    rows = _rows(out)
    val = [r for r in rows if "val_loss" in r]
    assert len(val) == 1 and val[0]["step"] == 1
    for key in ("val_loss", "val_curr_action_l1_loss", "val_next_actions_l1_loss"):
        assert np.isfinite(val[0][key]), key
    assert val[0]["val_loss"] == pytest.approx(seen[0][1]["val_loss"])


# === run management: the reference's layout, resume, QLoRA, the scripts ===
DEFAULT_RUN = [f for f in TINY_RUN if f not in ("--merge_lora_during_training", "False")]


def test_defaults_write_the_reference_layout(tmp_path):
    """The JAX CLI's defaults (merge during training) on random:tiny: the
    per-module .pt files, the statistics and the merged model in every
    `--N_chkpt` dir; the merged model is the trained LoRA merged into the
    base, bit for bit, and the .pt files hold the trained heads."""
    from openvla_oft_tpu_torch.training.checkpoint import (import_action_head_pt,
                                                           import_projector_pt)
    from openvla_oft_tpu_torch.training.lora import apply_lora
    from openvla_oft_tpu_torch.utils.hf_import import load_openvla_checkpoint

    assert "--merge_lora_during_training" not in DEFAULT_RUN
    seen = []
    out = FT.main(DEFAULT_RUN + ["--batch_size", "2", "--max_steps", "3", "--save_freq", "2",
                                 "--run_root_dir", str(tmp_path)],
                  on_step=lambda step, m, state: seen.append(state))
    run_dir, state = out["run_dir"], seen[-1]
    assert sorted(p.name for p in (Path(run_dir) / "ckpt").iterdir()) == ["000002.pt",
                                                                         "000003.pt"]
    for n in (2, 3):
        files = {p.name for p in Path(f"{run_dir}--{n}_chkpt").iterdir()}
        assert files == {"config.json", "model.safetensors", "dataset_statistics.json",
                         f"action_head--{n}_checkpoint.pt",
                         f"proprio_projector--{n}_checkpoint.pt"}, files
    d3 = f"{run_dir}--3_chkpt"
    _, merged, _ = load_openvla_checkpoint(d3, dtype=None)
    with torch.no_grad():
        want = apply_lora(state.base_params, state.trainables["lora"], rank=4, alpha=4.0)
    _assert_bitwise(merged, want)
    heads = {"action_head": import_action_head_pt(f"{d3}/action_head--3_checkpoint.pt"),
             "proprio_projector": import_projector_pt(
                 f"{d3}/proprio_projector--3_checkpoint.pt")}
    for k, tree in heads.items():
        for a, b in zip(tree_leaves(tree), tree_leaves(state.trainables[k])):
            assert torch.equal(a, b.detach()), k


def test_save_latest_checkpoint_only(tmp_path):
    out = FT.main(TINY_RUN + ["--batch_size", "2", "--max_steps", "3", "--save_freq", "1",
                              "--save_latest_checkpoint_only", "True",
                              "--run_root_dir", str(tmp_path)])
    run_dir = Path(out["run_dir"])
    assert sorted(p.name for p in (run_dir / "ckpt").iterdir()) == ["000003.pt"]
    assert (run_dir / "action_head--latest_checkpoint.pt").exists()
    assert (run_dir / "proprio_projector--latest_checkpoint.pt").exists()
    assert not list(tmp_path.glob("*_chkpt"))


def test_finetune_resume(tmp_path):
    """Mirrors tests/test_finetune_cli.py::test_finetune_resume, and the
    restored state is the saved one: the trainables, the optimizer's moments,
    count and LR scheduler, the micro-step."""
    from openvla_oft_tpu_torch.training.checkpoint import host_snapshot, restore_checkpoint

    base = TINY_RUN + ["--batch_size", "2", "--save_freq", "2", "--wandb_log_freq", "100",
                       "--run_root_dir", str(tmp_path)]
    out1 = FT.main(base + ["--max_steps", "2"])
    assert out1["final_step"] == 2
    saved = restore_checkpoint(str(Path(out1["run_dir"]) / "ckpt"), 2)
    restored = {}
    original = FT.restore_training_state

    def capture(state, *args, **kw):
        step = original(state, *args, **kw)
        restored.update(step=step, micro=state.step,
                        opt=host_snapshot(state.optimizer.state_dict()),
                        trainables=[t.detach().clone() for t in tree_leaves(state.trainables)])
        return step

    FT.restore_training_state = capture
    try:
        out2 = FT.main(base + ["--max_steps", "4", "--resume", "True", "--run_id_override",
                               Path(out1["run_dir"]).name])
    finally:
        FT.restore_training_state = original
    assert out2["final_step"] == 4
    assert sorted(p.name for p in (Path(out1["run_dir"]) / "ckpt").iterdir()) == [
        "000002.pt", "000004.pt"]
    assert restored["step"] == 2 and restored["micro"] == 2
    for a, b in zip(restored["trainables"], tree_leaves(saved["trainables"])):
        assert torch.equal(a, b)
    assert restored["opt"]["scheduler"]["last_epoch"] == 2
    adam = restored["opt"]["adamw"]["state"]
    for i, st in saved["optimizer"]["adamw"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(adam[i][key], st[key]), (i, key)


def test_resume_without_a_checkpoint_names_the_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint.*ckpt"):
        FT.main(TINY_RUN + ["--resume", "True", "--run_id_override", "nothing-here",
                            "--run_root_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("bits,remat", [(8, "all"), (4, "dots")], ids=["int8", "int4-dots"])
def test_finetune_quantize_base(tmp_path, bits, remat):
    """Mirrors tests/test_finetune_cli.py::test_finetune_quantize_base[_int4]:
    a quantized frozen base (every kernel, min_dim 1) trains with finite
    losses, LoRA moving through the straight-through backward."""
    seen = []
    out = FT.main(TINY_RUN + ["--batch_size", "2", "--max_steps", "3", "--quantize_base",
                              "True", "--quantize_base_min_dim", "1", "--quantize_base_bits",
                              str(bits), "--remat_policy", remat, "--run_root_dir",
                              str(tmp_path)],
                  on_step=lambda step, m, state: seen.append((m["loss"], state)))
    assert out["final_step"] == 3
    assert all(np.isfinite(loss) for loss, _ in seen)
    base = seen[-1][1].base_params
    key = "kernel" if bits == 8 else "kernel_q4"
    assert base["llm"]["layers"]["attn"]["wq"][key].dtype == torch.int8
    b = seen[-1][1].trainables["lora"]["llm"]["layers"]["attn"]["wq"]["b"]
    assert b.abs().max() > 0


def test_quantized_merge_reloads_the_float_base(tmp_path):
    """--quantize_base with the merged export from a checkpoint dir: the merge
    reloads the dir's float base (its stored dtype) and equals the offline
    merge script's output on the same resume file, bit for bit."""
    from openvla_oft_tpu_torch.scripts.merge_lora_weights_and_save import MergeConfig, merge
    from openvla_oft_tpu_torch.utils.hf_import import load_openvla_checkpoint

    ckpt, _ = _tiny_checkpoint(tmp_path, "l1")
    out = FT.main(DEFAULT_RUN + ["--vla_path", ckpt, "--batch_size", "2", "--max_steps", "2",
                                 "--save_freq", "2", "--quantize_base", "True",
                                 "--quantize_base_min_dim", "1", "--run_root_dir",
                                 str(tmp_path / "runs")])
    in_training = f"{out['run_dir']}--2_chkpt"
    offline = merge(MergeConfig(base_checkpoint=ckpt, finetune_run_dir=out["run_dir"],
                                lora_rank=4, device="cpu"))
    assert offline == f"{out['run_dir']}/merged--2_chkpt"
    _, a, _ = load_openvla_checkpoint(in_training, dtype=None)
    _, b, _ = load_openvla_checkpoint(offline, dtype=None)
    _, float_base, _ = load_openvla_checkpoint(ckpt, dtype=None)
    _assert_bitwise(a, b)
    assert a["llm"]["layers"]["attn"]["wq"]["kernel"].dtype == torch.bfloat16
    assert not torch.equal(a["llm"]["layers"]["attn"]["wq"]["kernel"],
                           float_base["llm"]["layers"]["attn"]["wq"]["kernel"])


def test_quantized_merge_from_random_weights_is_skipped(tmp_path, capsys):
    out = FT.main(DEFAULT_RUN + ["--batch_size", "2", "--max_steps", "1", "--quantize_base",
                                 "True", "--quantize_base_min_dim", "1", "--run_root_dir",
                                 str(tmp_path)])
    assert "skipping merged export" in capsys.readouterr().out
    assert not (Path(f"{out['run_dir']}--1_chkpt") / "model.safetensors").exists()
    assert (Path(f"{out['run_dir']}--1_chkpt") / "action_head--1_checkpoint.pt").exists()


def test_run_finetune_adds_resume_after_the_first_attempt(monkeypatch):
    """The restart wrapper (mirrors vla_scripts/run_finetune.py): relaunch
    until exit 0, `--resume True` from the second attempt on, unless the
    arguments hold --resume already (`--resume_step` does not count)."""
    from openvla_oft_tpu_torch.scripts import run_finetune as RF

    calls = []

    def fake_run(cmd):
        calls.append(cmd)
        return type("P", (), {"returncode": 0 if len(calls) == 3 else 1})()

    monkeypatch.setattr(RF.subprocess, "run", fake_run)
    assert RF.main(["--restart_delay_s", "0", "--", "--max_steps", "5",
                    "--resume_step", "2"]) == 0
    assert [c[1:3] for c in calls] == [["-m", RF.FINETUNE]] * 3
    assert calls[0][3:] == ["--max_steps", "5", "--resume_step", "2"]
    assert calls[1][3:] == calls[2][3:] == ["--max_steps", "5", "--resume_step", "2",
                                            "--resume", "True"]
    assert RF.with_resume(["--resume=False"], 1) == ["--resume=False"]
    assert RF.with_resume(["--resume", "False"], 2) == ["--resume", "False"]
