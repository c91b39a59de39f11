"""The port's sharded train step (`parallel/`, `training/train_step.py`) on the CPU.

(iv) One step on a (2, 1, 2) and a (1, 2, 2) mesh of four gloo processes
(`torch_parallel_worker.py`) against the port's step on one process and
JAX's step on the same numpy weights and batch, both computed here (the
children import no JAX): the loss and the gradient norm within 5e-4 of the
port's and 2e-4 / 1e-4 of JAX's, the trainables after one AdamW update
within test_torch_train_step.py's bounds (1% of lr where the gradient's sign
is well determined, 2 lr anywhere).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openvla_oft_tpu.config import OpenVLAConfig
from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.training import train_step as JT
from openvla_oft_tpu.training.lora import init_lora as jax_init_lora
from openvla_oft_tpu_torch.bridge import params_from_numpy, tree_leaves
from openvla_oft_tpu_torch.training import train_step as TT
from test_torch_import import port_config, port_platform
from torch_parallel_worker import launch

CFG = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama")
P_CFG = port_config(CFG)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


LR = 1e-3


def _train_setup():
    """test_torch_train_step.py's trees and batch: two real rows, one on each
    data rank of the (2, 1, 2) and (1, 2, 2) meshes."""
    from test_training import _batch

    full = init_openvla_params(jax.random.PRNGKey(0), CFG, LIBERO, dtype=jnp.float32,
                               head="l1", with_lm_head=False)
    base = {k: full[k] for k in ("llm", "vision_backbone", "projector")}
    lora = jax_init_lora(jax.random.PRNGKey(1), base, rank=4)
    rng = np.random.default_rng(5)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) + (0.02 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key == "b" else np.asarray(x), lora)
    trainables = {"lora": lora, "action_head": full["action_head"],
                  "proprio_projector": full["proprio_projector"]}
    return _np(base), _np(trainables), {k: np.asarray(v) for k, v in _batch().items()}


TRAIN_CFG = dict(learning_rate=LR, lora_rank=4, lora_alpha=4.0, remat_policy="none")


@functools.lru_cache(maxsize=1)
def _train_refs():
    """The inputs and both references of the sharded step: the port's step on
    one process (its trainables after the update, its loss and norm) and
    JAX's (the loss, the gradients, the trainables after the update)."""
    base, trainables, batch = _train_setup()
    port_trainables = params_from_numpy(trainables)
    for t in tree_leaves(port_trainables):
        t.requires_grad_(True)
    state = TT.create_train_state(params_from_numpy(base), port_trainables,
                                  TT.TrainConfig(**TRAIN_CFG))
    state, metrics = TT.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                   P_CFG, port_platform(LIBERO), TT.TrainConfig(**TRAIN_CFG),
                                   use_flash=True)
    single = [t.detach().numpy() for t in tree_leaves(state.trainables)]

    jcfg = JT.TrainConfig(objective="l1", learning_rate=LR, lora_rank=4, lora_alpha=4.0,
                          remat_policy="none")
    tr_j = jax.tree_util.tree_map(jnp.asarray, trainables)
    (loss_j, _), grads_j = jax.value_and_grad(JT.loss_and_metrics, has_aux=True)(
        tr_j, jax.tree_util.tree_map(jnp.asarray, base),
        {k: jnp.asarray(v) for k, v in batch.items()}, CFG, LIBERO, jcfg,
        jax.random.PRNGKey(0), True)
    tx = JT.make_optimizer(jcfg)
    updates, _ = tx.update(grads_j, tx.init(tr_j), tr_j)
    new_j = [np.asarray(x) for x in jax.tree_util.tree_leaves(optax.apply_updates(tr_j, updates))]
    return {"base": base, "trainables": trainables, "batch": batch, "single": single,
            "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "loss_j": float(loss_j), "grad_norm_j": float(optax.global_norm(grads_j)),
            "new_j": new_j, "grads_j": [np.asarray(x) for x in jax.tree_util.tree_leaves(grads_j)]}


@pytest.mark.parametrize("mesh", [(2, 1, 2), (1, 2, 2)], ids=["dp2-tp2", "fsdp2-tp2"])
def test_sharded_train_step_matches_single_device_and_jax(tmp_path, mesh):
    """One step (loss, grad norm, the trainables after AdamW) on a sharded
    mesh against the port's step on one process (5e-4 on the loss and the
    norm, the updated trainables to 1% of lr) and JAX's step on the same
    weights and batch, within test_torch_train_step's bounds."""
    ref = _train_refs()
    out = launch("train_step", 4, {"mesh": mesh, "base": ref["base"],
                                   "trainables": ref["trainables"], "batch": ref["batch"],
                                   "train_config": TRAIN_CFG, "platform": "libero",
                                   "use_flash": True, "num_images": 1}, tmp_path)
    for o in out:
        m = o["metrics"]
        np.testing.assert_allclose(m["loss"], ref["loss"], rtol=5e-4)
        np.testing.assert_allclose(m["grad_norm"], ref["grad_norm"], rtol=5e-4)
        np.testing.assert_allclose(m["loss"], ref["loss_j"], rtol=2e-4)
        np.testing.assert_allclose(m["grad_norm"], ref["grad_norm_j"], rtol=1e-4)
        got = tree_leaves(o["trainables"])
        assert len(got) == len(ref["single"]) == len(ref["new_j"])
        for g, s, pj, gj in zip(got, ref["single"], ref["new_j"], ref["grads_j"]):
            assert g.shape == s.shape == pj.shape
            sure = np.abs(gj) > 1e-2 * np.abs(gj).max()
            assert np.abs(g - s)[sure].max(initial=0) <= 1e-2 * LR
            assert np.abs(g - pj)[sure].max(initial=0) <= 1e-2 * LR
            assert np.abs(g - pj).max() <= 2 * LR + 1e-6
