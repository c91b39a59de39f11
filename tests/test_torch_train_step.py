"""Port parity for the training forward and the L1 train step.

Mirrors tests/test_training.py at the TINY configs: the same numpy weights
(the JAX init, fp32) and the same batch (`test_training._batch`) go through
the JAX `prismatic_forward` / `loss_and_metrics` / optax update and through
the port's. LoRA B is drawn non-zero so that every gradient is non-zero.
With `use_flash=True` the JAX side runs its Pallas kernels in interpret mode
and the port its plain K1/K2/K3 versions (CPU tensors).

Tolerances. The forward is fp32 except the bf16 rounding of the
action-slot hidden states before the head and the head's bf16 layers (both
frameworks). Hidden states agree to 1e-4. Fp32 noise of ~1e-6 flips a few of
the 7168 bf16 head inputs by one ulp, so the loss agrees to 2e-4 relative,
each gradient leaf to 1e-2 of its largest entry with a cosine >= 0.9999.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.models.prismatic import prismatic_forward as jax_forward
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.training import train_step as JT
from openvla_oft_tpu.training.lora import init_lora as jax_init_lora
from openvla_oft_tpu_torch.bridge import params_from_numpy, tree_leaves
from openvla_oft_tpu_torch.models.prismatic import prismatic_forward as port_forward
from openvla_oft_tpu_torch.training import train_step as TT
from test_torch_import import port_config, port_platform
from test_training import CFG, _batch

P_CFG, P_LIBERO = port_config(CFG), port_platform(LIBERO)     # the port's side

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LR = 1e-3


def _np_setup():
    """(base, trainables) as numpy trees: the JAX init with a non-zero B."""
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
    return (jax.tree_util.tree_map(np.asarray, base),
            jax.tree_util.tree_map(np.asarray, trainables))


NP_BASE, NP_TRAIN = _np_setup()
NP_BATCH = {k: np.asarray(v) for k, v in _batch().items()}


def _port_state(cfg, remat_policy="all"):
    base = params_from_numpy(NP_BASE)
    trainables = params_from_numpy(NP_TRAIN)
    for t in tree_leaves(trainables):
        t.requires_grad_(True)
    cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    return TT.create_train_state(base, trainables, cfg), cfg


def _port_batch(n=None):
    sl = slice(None) if n is None else n
    return {k: torch.from_numpy(v[sl]) for k, v in NP_BATCH.items()}


def _port_cfg(**kw):
    return TT.TrainConfig(learning_rate=LR, lora_rank=4, lora_alpha=4.0, **kw)


def _jax_cfg(**kw):
    return JT.TrainConfig(objective="l1", learning_rate=LR, lora_rank=4,
                          lora_alpha=4.0, **kw)


def _flat(tree):
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


def _port_flat(tree):
    return [t.detach().double().numpy() for t in tree_leaves(tree)]


@pytest.mark.parametrize("use_flash", [False, True])
def test_prismatic_forward_matches_jax(use_flash):
    cfg = _port_cfg()
    params_j = JT._merged_params(jax.tree_util.tree_map(jnp.asarray, NP_BASE),
                                 jax.tree_util.tree_map(jnp.asarray, NP_TRAIN), _jax_cfg())
    b = {k: jnp.asarray(v) for k, v in NP_BATCH.items()}
    ref = jax_forward(params_j, CFG, LIBERO, b["input_ids"], b["attention_mask"],
                      b["pixel_values"], b["labels"], proprio=b["proprio"],
                      use_flash=use_flash, compute_logits=False)
    state, _ = _port_state(cfg)
    pb = _port_batch()
    with torch.no_grad():
        out = port_forward(TT._merged_params(state.base_params, state.trainables, cfg),
                           P_CFG, P_LIBERO, pb["input_ids"], pb["attention_mask"],
                           pb["pixel_values"], pb["labels"], proprio=pb["proprio"],
                           use_flash=use_flash)
    np.testing.assert_allclose(out.hidden_states.numpy(), np.asarray(ref.hidden_states),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.actions_hidden.numpy(), np.asarray(ref.actions_hidden),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out.multimodal_labels.numpy(),
                                  np.asarray(ref.multimodal_labels))
    np.testing.assert_array_equal(out.all_actions_mask.numpy(),
                                  np.asarray(ref.all_actions_mask))


@pytest.mark.parametrize("use_flash", [False, True])
def test_train_step_matches_jax(use_flash):
    """Loss, every trainable gradient, and the trainables after one AdamW update.

    The JAX side runs eagerly: under jit XLA may skip the bf16 rounding of
    the head's input (excess precision), which the port keeps. It runs with
    remat "none" (remat changes no value; test_remat_all_matches_none) and
    the port with its default "all".
    """
    jcfg = _jax_cfg(remat_policy="none")
    tr_j = jax.tree_util.tree_map(jnp.asarray, NP_TRAIN)
    (loss_j, _), grads_j = jax.value_and_grad(JT.loss_and_metrics, has_aux=True)(
        tr_j, jax.tree_util.tree_map(jnp.asarray, NP_BASE),
        {k: jnp.asarray(v) for k, v in NP_BATCH.items()}, CFG, LIBERO, jcfg,
        jax.random.PRNGKey(0), use_flash)
    tx = JT.make_optimizer(jcfg)
    updates, _ = tx.update(grads_j, tx.init(tr_j), tr_j)
    new_j = optax.apply_updates(tr_j, updates)

    state, cfg = _port_state(_port_cfg())
    loss_t, _ = TT.loss_and_metrics(state.trainables, state.base_params, _port_batch(),
                                    P_CFG, P_LIBERO, cfg, use_flash=use_flash)
    grads_t = torch.autograd.grad(loss_t, tree_leaves(state.trainables))
    state, metrics = TT.train_step(state, _port_batch(), P_CFG, P_LIBERO, cfg,
                                   use_flash=use_flash)

    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=2e-4)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_j), rtol=2e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(optax.global_norm(grads_j)), rtol=1e-4)
    for gj, gt, pj, pt in zip(_flat(grads_j), grads_t, _flat(new_j),
                              _port_flat(state.trainables)):
        gt = gt.double().numpy()
        assert gj.shape == gt.shape == pj.shape == pt.shape
        scale = np.abs(gj).max()
        assert scale > 0
        assert np.abs(gt - gj).max() <= 1e-2 * scale
        assert _cos(gt, gj) >= 0.9999
        # Adam's first update is lr * g / (|g| + eps), about lr * sign(g):
        # where the sign is well determined (|g| above 1% of the leaf's
        # largest entry) the updated values agree to 1% of lr; elsewhere a
        # sign flip may move an entry by up to 2 lr.
        sure = np.abs(gj) > 1e-2 * scale
        assert np.abs(pt - pj)[sure].max() <= 1e-2 * LR
        assert np.abs(pt - pj).max() <= 2 * LR + 1e-6


def _cos(a, b):
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("clip,accum,warmup", [(0.0, 1, 0), (0.5, 1, 3), (0.0, 3, 0),
                                               (0.5, 2, 2)])
def test_optimizer_matches_optax(clip, accum, warmup):
    """AdamW with clipping, warmup, step decay and accumulation against the
    JAX chain (optax) on the same parameters and gradients, 6 micro-steps."""
    rng = np.random.default_rng(3)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(6)]
    kw = dict(max_grad_norm=clip, grad_accumulation_steps=accum, warmup_steps=warmup,
              num_steps_before_decay=2)
    tx = JT.make_optimizer(_jax_cfg(**kw))
    pj = [jnp.asarray(p) for p in params]
    opt = tx.init(pj)
    pt = [torch.from_numpy(p.copy()) for p in params]
    port = TT.Optimizer(_port_cfg(**kw), pt)
    for g in grads:
        upd, opt = tx.update([jnp.asarray(x) for x in g], opt, pj)
        pj = optax.apply_updates(pj, upd)
        port.update([torch.from_numpy(x) for x in g])
        for a, b in zip(pj, pt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=1000),
                                dict(warmup_steps=10, num_steps_before_decay=20,
                                     lr_decay_factor=0.5)])
def test_lr_schedule_matches_jax(kw):
    fj, ft = JT.lr_schedule(_jax_cfg(**kw)), TT.lr_schedule(_port_cfg(**kw))
    for step in (0, 1, 5, 9, 10, 19, 20, 499, 2000, 200_000):
        np.testing.assert_allclose(ft(step), float(fj(step)), rtol=1e-6)


def test_remat_all_matches_none():
    """remat changes only what is kept for the backward: loss and gradients
    of "all" equal those of "none" (mirrors test_remat_policy_matches_full_recompute)."""
    out = {}
    for policy in ("all", "none"):
        state, cfg = _port_state(_port_cfg(), remat_policy=policy)
        loss, _ = TT.loss_and_metrics(state.trainables, state.base_params, _port_batch(),
                                      P_CFG, P_LIBERO, cfg, use_flash=True)
        out[policy] = [loss] + list(torch.autograd.grad(loss, tree_leaves(state.trainables)))
    for a, b in zip(out["all"], out["none"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("policy,on", [(None, False), ("none", False), ("all", True),
                                       ("dots", True), ("attn_out", True),
                                       ("bogus", ValueError)])
def test_resolve_remat(policy, on):
    """remat_policy is the one switch: None and "none" keep activations,
    "all", "dots" and "attn_out" recompute (each its share of) each block,
    anything else raises."""
    from openvla_oft_tpu_torch.models.llama import resolve_remat

    if on is ValueError:
        with pytest.raises(ValueError, match="Unknown remat policy"):
            resolve_remat(policy)
    else:
        assert resolve_remat(policy) is on


def _loss_and_grads(policy, use_flash):
    state, cfg = _port_state(_port_cfg(), remat_policy=policy)
    loss, _ = TT.loss_and_metrics(state.trainables, state.base_params, _port_batch(),
                                  P_CFG, P_LIBERO, cfg, use_flash=use_flash)
    return [loss.detach()] + list(torch.autograd.grad(loss, tree_leaves(state.trainables)))


@pytest.mark.parametrize("policy", ["dots", "attn_out"])
def test_remat_policies_equal_all_bitwise(policy):
    """"dots" and "attn_out" change only what is kept for the backward: the
    loss and every gradient are bitwise those of "all", on the dense path and
    on K1/K2/K3's plain versions."""
    for use_flash in (False, True):
        want, got = _loss_and_grads("all", use_flash), _loss_and_grads(policy, use_flash)
        for a, b in zip(want, got):
            assert torch.equal(a, b), (policy, use_flash)


@pytest.mark.parametrize("policy", ["dots", "attn_out"])
def test_remat_policy_matches_jax(policy):
    """The loss and gradients under "dots" and "attn_out" against the JAX
    step with the same policy (its `jax.checkpoint` policies), at this
    file's tolerances ("all" and "none": test_train_step_matches_jax and
    test_remat_all_matches_none)."""
    jcfg = _jax_cfg(remat_policy=policy)
    (loss_j, _), grads_j = jax.value_and_grad(JT.loss_and_metrics, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, NP_TRAIN),
        jax.tree_util.tree_map(jnp.asarray, NP_BASE),
        {k: jnp.asarray(v) for k, v in NP_BATCH.items()}, CFG, LIBERO, jcfg,
        jax.random.PRNGKey(0), False)
    loss_t, *grads_t = _loss_and_grads(policy, False)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-4)
    for gj, gt in zip(_flat(grads_j), grads_t):
        gt = gt.double().numpy()
        scale = np.abs(gj).max()
        assert np.abs(gt - gj).max() <= 1e-2 * scale
        assert _cos(gt, gj) >= 0.9999


def test_loss_decreases():
    state, cfg = _port_state(_port_cfg())
    losses = []
    for _ in range(8):
        state, m = TT.train_step(state, _port_batch(), P_CFG, P_LIBERO, cfg)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert state.step == 8


def test_grad_accumulation_matches_larger_batch():
    """2 micro-steps of batch 1 with accumulation ~ one step of batch 2
    (mirrors tests/test_finetune_cli.py::test_grad_accumulation_matches_larger_batch)."""
    fc_out = ("action_head", "model", "fc_out", "kernel")

    def leaf(st):
        node = st.trainables
        for k in fc_out:
            node = node[k]
        return node.detach().clone()

    acc, cfg = _port_state(_port_cfg(grad_accumulation_steps=2))
    init = leaf(acc)
    acc, _ = TT.train_step(acc, _port_batch(slice(0, 1)), P_CFG, P_LIBERO, cfg)
    assert torch.equal(leaf(acc), init)          # no update after the first micro-step
    acc, _ = TT.train_step(acc, _port_batch(slice(1, 2)), P_CFG, P_LIBERO, cfg)
    full, cfg1 = _port_state(_port_cfg())
    full, _ = TT.train_step(full, _port_batch(), P_CFG, P_LIBERO, cfg1)
    # The mean of the two micro-batch means equals the batch mean, so the two
    # gradients agree to fp32 noise; Adam's first step maps each to about
    # lr * sign(g), where a near-zero entry may flip (at most 2 lr).
    diff = (leaf(acc) - leaf(full)).abs()
    assert (diff < 5e-4).float().mean() >= 0.99
    assert diff.max() <= 2 * LR + 1e-6
    assert (leaf(acc) - init).abs().max() > 0
