"""`--mesh_*` in `scripts/train.py` and `scripts/pretrain.py` on the CPU.

Each mesh flag at 2 (they used to raise naming ROADMAP item 17) runs one
step of each script on two gloo processes (`torch_parallel_worker.py`):
dp and fsdp split the global batch of two, tp the heads. Both ranks report
the same finite loss (the metrics are averaged over the data ranks), and
rank 0 writes the checkpoint, whose trainables are whole: the shapes of the
one-device run's. Without a process group the flags raise and name torchrun.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_oft_tpu_torch.bridge import tree_leaves
from openvla_oft_tpu_torch.scripts import pretrain as PP
from openvla_oft_tpu_torch.scripts import train as PT
from openvla_oft_tpu_torch.training.checkpoint import restore_checkpoint
from test_torch_train_scripts import _llava
from torch_parallel_worker import launch

MESH = {"mesh_dp": (2, 1, 1), "mesh_fsdp": (1, 2, 1), "mesh_tp": (1, 1, 2)}


def _cfg(tmp_path, script):
    if script == "train":
        return dict(vla_id="tiny", stage="vla-train", pretrained_checkpoint="random:tiny",
                    data_root_dir=Path("dummy"), dataset_name="libero_dummy", batch_size=2,
                    max_steps=1, save_interval=1, learning_rate=1e-2, device="cpu")
    js, images = _llava(tmp_path)
    return dict(stage="finetune", pretrained_checkpoint="random:tiny", llava_json=js,
                image_root=images, batch_size=2, max_steps=1, save_interval=1,
                seq_bucket=48, device="cpu")


@pytest.mark.parametrize("script", ["train", "pretrain"])
@pytest.mark.parametrize("flag", list(MESH))
def test_mesh_flags_run(tmp_path, script, flag):
    cfg = {**_cfg(tmp_path, script), flag: 2, "run_root_dir": str(tmp_path / "run")}
    out = launch("train_script", 2, {"mesh": MESH[flag], "script": script, "cfg": cfg},
                 tmp_path / "ranks")
    losses = [o["losses"] for o in out]
    assert losses[0] == losses[1] and len(losses[0]) == 1 and np.isfinite(losses[0]).all()
    assert all(o["final_step"] == 1 for o in out)
    saved = restore_checkpoint(str(Path(out[0]["ckpt"]).parent), 1)
    cls = PT.TrainConfig if script == "train" else PP.PretrainConfig
    ref = (PT.train if script == "train" else PP.pretrain)(dataclasses.replace(
        cls(), **{**cfg, flag: 1, "max_steps": 0, "run_root_dir": str(tmp_path / "ref")}))
    want = [tuple(t.shape) for t in tree_leaves(ref["state"].trainables)]
    got = [tuple(t.shape) for t in tree_leaves(saved["trainables"])]
    assert got == want


@pytest.mark.parametrize("script", ["train", "pretrain"])
def test_mesh_flags_without_a_group_name_torchrun(tmp_path, script):
    cls = PT.TrainConfig if script == "train" else PP.PretrainConfig
    run = PT.train if script == "train" else PP.pretrain
    cfg = dataclasses.replace(cls(), **{**_cfg(tmp_path, script), "mesh_fsdp": 2,
                                        "run_root_dir": str(tmp_path)})
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        run(cfg)
    assert not torch.distributed.is_initialized()



@pytest.mark.parametrize("flag", ["mesh_dp", "mesh_fsdp"])
def test_bf16_replicas_take_the_summed_gradient(tmp_path, flag):
    """Two steps of vla-train (bf16 LLM trainables, `Bf16AdamW`) over two data
    ranks. Every rank's trainables, gathered whole, are bitwise those of the
    other rank: a leaf replicated over the data axes updates with the summed
    gradient, not its own rows' part. Against the one-process run: no
    element further than 4 lr + 2 ulp of bf16 at its size (two updates of
    at most 2 lr each), and at most 1% of the elements further than
    0.1 lr + 1 ulp (the rows' gradients sum in another order, which moves
    the second update where the gradient is near 0; about 0.2% do here,
    and 10-60% when each replica takes its own rows' gradient)."""
    cfg = {**_cfg(tmp_path, "train"), "max_steps": 2, "save_interval": 2, flag: 2,
           "run_root_dir": str(tmp_path / "run")}
    out = launch("train_script", 2, {"mesh": MESH[flag], "script": "train", "cfg": cfg},
                 tmp_path / "ranks")
    ref = PT.train(dataclasses.replace(PT.TrainConfig(), **{
        **cfg, flag: 1, "run_root_dir": str(tmp_path / "ref")}))
    want = [t.detach().float().numpy() for t in tree_leaves(ref["state"].trainables)]
    ranks = [tree_leaves(o["trainables"]) for o in out]
    lr = cfg["learning_rate"]
    assert len(ranks[0]) == len(ranks[1]) == len(want)
    for a, b, w in zip(*ranks, want):
        np.testing.assert_array_equal(a, b)
        ulp = np.abs(w) * 2.0 ** -7
        d = np.abs(a - w)
        assert (d <= 4 * lr + 2 * ulp).all()
        assert (d > 0.1 * lr + ulp).mean() <= 1e-2
