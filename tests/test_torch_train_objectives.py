"""Port parity for the diffusion and discrete objectives, FiLM in training
on ALOHA, and the diffusion sampling metric.

Mirrors tests/test_training.py at the TINY configs, as
tests/test_torch_train_step.py does for the L1 objective: the same numpy
weights (the JAX init, fp32, LoRA B drawn non-zero) and the same batch go
through the JAX `prismatic_forward` / `loss_and_metrics` / optax update /
`diffusion_sampling_metrics` and through the port's.

The random draws cannot match: JAX draws from its PRNG, the port from a
`torch.Generator`. So the JAX side's draws are made from its key as its own
code makes them (`jax.random.split`, `normal`, `randint`), and the port's
draw functions (`models/action_heads.py::draw_noise`, `draw_timesteps`) are
replaced for the test by ones that return those arrays.

Tolerances are test_torch_train_step.py's: hidden states to 1e-4; the loss
to 2e-4 relative (a few bf16 head inputs flip by one ulp); each gradient
leaf to 1e-2 of its largest entry with a cosine >= 0.9999; the AdamW update
as that file bounds it; the discrete metrics to 1e-6; the sampling metric
to 1e-3 (see its test).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from openvla_oft_tpu.constants import (ACTION_TOKEN_BEGIN_IDX, ALOHA, EMPTY_TOKEN_ID,
                                       IGNORE_INDEX, LIBERO, STOP_INDEX)
from openvla_oft_tpu.models import action_heads as JAH
from openvla_oft_tpu.models.prismatic import prismatic_forward as jax_forward
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.training import train_step as JT
from openvla_oft_tpu.training.lora import init_lora as jax_init_lora
from openvla_oft_tpu_torch.bridge import params_from_numpy, tree_leaves
from openvla_oft_tpu_torch.models import action_heads as AH
from openvla_oft_tpu_torch.models import llama as PL
from openvla_oft_tpu_torch.models.prismatic import prismatic_forward as port_forward
from openvla_oft_tpu_torch.training import train_step as TT
from test_torch_import import port_config, port_platform
from test_training import CFG, _batch

torch.backends.cuda.matmul.allow_tf32 = False

LR = 1e-3
T_STEPS = 100                       # TrainConfig.num_diffusion_steps of the parity runs
ALOHA_CFG = dataclasses.replace(CFG, num_images_in_input=3, use_film=True)


def _aloha_batch(b=2, s=368):
    """test_training._batch's layout at ALOHA's geometry: 3 images, a 25 x 14
    chunk (350 action tokens), a 14-dim proprio."""
    rng = np.random.default_rng(1)
    h = CFG.vision_configs[0].image_size
    input_ids = np.zeros((b, s), np.int32)
    labels = np.full((b, s), IGNORE_INDEX, np.int32)
    attn = np.zeros((b, s), np.int32)
    for i, plen in enumerate([7, 12]):
        seq = ([1] + list(rng.integers(10, 1000, plen - 2)) + [EMPTY_TOKEN_ID]
               + list(rng.integers(ACTION_TOKEN_BEGIN_IDX + 1, ACTION_TOKEN_BEGIN_IDX + 257,
                                   ALOHA.chunk_len)) + [STOP_INDEX])
        input_ids[i, :len(seq)] = seq
        attn[i, :len(seq)] = 1
        labels[i, plen:len(seq)] = seq[plen:]
    return {"input_ids": input_ids, "attention_mask": attn, "labels": labels,
            "pixel_values": rng.random((b, 3, 2, h, h, 3)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (b, ALOHA.num_actions_chunk,
                                           ALOHA.action_dim)).astype(np.float32),
            "proprio": rng.random((b, ALOHA.proprio_dim)).astype(np.float32)}


# (JAX config, platform, objective, batch) of each case.
CASES = {
    "diffusion": (CFG, LIBERO, "diffusion", {k: np.asarray(v) for k, v in _batch().items()}),
    "discrete": (CFG, LIBERO, "discrete", {k: np.asarray(v) for k, v in _batch().items()}),
    "aloha_film_l1": (ALOHA_CFG, ALOHA, "l1", _aloha_batch()),
}


def _np_setup(cfg, platform, objective):
    """(base, trainables) as numpy trees (keys in JAX's sorted order): the
    JAX init of the objective's heads, LoRA B drawn non-zero, and the
    trainable groups of vla_scripts/finetune.py:268-271."""
    head = {"l1": "l1", "diffusion": "diffusion", "discrete": None}[objective]
    full = init_openvla_params(jax.random.PRNGKey(0), cfg, platform, dtype=jnp.float32,
                               head=head, with_lm_head=objective == "discrete")
    base = {k: full[k] for k in ("llm", "vision_backbone", "projector")}
    lora = jax_init_lora(jax.random.PRNGKey(1), base, rank=4)
    rng = np.random.default_rng(5)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) + (0.02 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key == "b" else np.asarray(x), lora)
    trainables = {"lora": lora}
    for k in ("action_head", "proprio_projector", "noisy_action_projector", "film"):
        if k in full:
            trainables[k] = full[k]
    return (jax.tree_util.tree_map(np.asarray, base),
            jax.tree_util.tree_map(np.asarray, trainables))


_SETUPS = {}


def _setup(name):
    if name not in _SETUPS:
        cfg, platform, objective, _ = CASES[name]
        _SETUPS[name] = _np_setup(cfg, platform, objective)
    return _SETUPS[name]


def _jax_cfg(objective, cfg, **kw):
    return JT.TrainConfig(objective=objective, learning_rate=LR, lora_rank=4, lora_alpha=4.0,
                          use_film=cfg.use_film, num_diffusion_steps=T_STEPS, **kw)


def _port_cfg(objective, cfg, **kw):
    return TT.TrainConfig(objective=objective, learning_rate=LR, lora_rank=4, lora_alpha=4.0,
                          use_film=cfg.use_film, num_diffusion_steps=T_STEPS, **kw)


def _port_trees(name):
    np_base, np_train = _setup(name)
    base, trainables = params_from_numpy(np_base), params_from_numpy(np_train)
    for t in tree_leaves(trainables):
        t.requires_grad_(True)
    return base, trainables


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_draws(key, b, platform, num_steps):
    """What JAX's diffusion_sample_noisy_actions draws from `key`."""
    k_noise, k_t = jax.random.split(key)
    noise = jax.random.normal(k_noise, (b, platform.num_actions_chunk, platform.action_dim),
                              dtype=jnp.float32)
    return np.asarray(noise), np.asarray(jax.random.randint(k_t, (b,), 0, num_steps))


def _replay(monkeypatch, noise=None, timesteps=None):
    """The port's draw functions return the given arrays (shapes checked)."""
    if noise is not None:
        def draw_noise(generator, shape, device):
            assert tuple(shape) == noise.shape and isinstance(generator, torch.Generator)
            return torch.from_numpy(noise.copy()).to(device)

        monkeypatch.setattr(AH, "draw_noise", draw_noise)
    if timesteps is not None:
        def draw_timesteps(generator, batch, num_steps, device):
            assert batch == timesteps.shape[0] and isinstance(generator, torch.Generator)
            return torch.from_numpy(timesteps.copy()).long().to(device)

        monkeypatch.setattr(AH, "draw_timesteps", draw_timesteps)


def _cos(a, b):
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


# --- the noise draw -------------------------------------------------------------------

def test_diffusion_sample_noisy_actions_matches_jax(monkeypatch):
    """add_noise on the same draws within 1e-6, and the timestep embedding."""
    gt = np.random.default_rng(3).uniform(-1, 1, (3, 8, 7)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = JAH.diffusion_sample_noisy_actions({}, key, jnp.asarray(gt), LIBERO, llm_dim=64,
                                              num_diffusion_steps=50)
    noise, t = _jax_draws(key, 3, LIBERO, 50)
    _replay(monkeypatch, noise, t)
    got = AH.diffusion_sample_noisy_actions({}, torch.Generator(), torch.from_numpy(gt),
                                            port_platform(LIBERO), llm_dim=64,
                                            num_diffusion_steps=50)
    assert got["diffusion_timestep_embeddings"].shape == (3, 1, 64)
    for k in ("noise", "noisy_actions", "diffusion_timestep_embeddings"):
        assert got[k].dtype == torch.float32
        # The embedding is held to test_torch_diffusion.py's bound for the
        # encoding (1e-5): XLA's fp32 exp is one ulp off the correctly rounded
        # value at 3 of the 32 frequencies, and at t up to 49 one ulp of the
        # sine's argument (about 50 rad) is 3.8e-6.
        tol = 1e-5 if k == "diffusion_timestep_embeddings" else 1e-6
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=tol, atol=tol)


def test_diffusion_draws_come_from_the_generator():
    """The same seed draws the same noise and timesteps, another seed other
    ones, and the global RNG is never touched."""
    gt = torch.zeros((2, 8, 7))
    state = torch.random.get_rng_state()

    def draw(seed):
        return AH.diffusion_sample_noisy_actions(
            {}, torch.Generator().manual_seed(seed), gt, port_platform(LIBERO), llm_dim=16,
            num_diffusion_steps=10)

    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(torch.random.get_rng_state(), state)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["noise"], c["noise"])
    # gt = 0: the noisy actions are sqrt(1 - a_t) * noise, so a_t < 1 shows.
    assert a["noisy_actions"].abs().max() > 0


# --- the training forward -------------------------------------------------------------

@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("name", ["diffusion", "aloha_film_l1"])
def test_prismatic_forward_matches_jax(name, use_flash):
    """Diffusion (given noisy actions and timestep token) and ALOHA with
    FiLM: hidden states and action hidden states within 1e-4, labels and
    masks equal."""
    cfg, platform, objective, batch = CASES[name]
    np_base, np_train = _setup(name)
    kw_j, kw_t = {}, {}
    if objective == "diffusion":
        rng = np.random.default_rng(9)
        na = rng.uniform(-1, 1, batch["actions"].shape).astype(np.float32)
        t_emb = rng.standard_normal((na.shape[0], 1, cfg.llm_dim)).astype(np.float32)
        kw_j = dict(noisy_actions=jnp.asarray(na), diffusion_t_emb=jnp.asarray(t_emb))
        kw_t = dict(noisy_actions=torch.from_numpy(na), diffusion_t_emb=torch.from_numpy(t_emb))
    params_j = JT._merged_params(jax.tree_util.tree_map(jnp.asarray, np_base),
                                 jax.tree_util.tree_map(jnp.asarray, np_train),
                                 _jax_cfg(objective, cfg))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jax_forward(params_j, cfg, platform, b["input_ids"], b["attention_mask"],
                      b["pixel_values"], b["labels"], proprio=b["proprio"],
                      use_flash=use_flash, compute_logits=False, **kw_j)
    base, trainables = _port_trees(name)
    pb = _torch_batch(batch)
    with torch.no_grad():
        out = port_forward(TT._merged_params(base, trainables, _port_cfg(objective, cfg)),
                           port_config(cfg), port_platform(platform), pb["input_ids"],
                           pb["attention_mask"], pb["pixel_values"], pb["labels"],
                           proprio=pb["proprio"], use_flash=use_flash, **kw_t)
    np.testing.assert_allclose(out.hidden_states.numpy(), np.asarray(ref.hidden_states),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.actions_hidden.numpy(), np.asarray(ref.actions_hidden),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out.multimodal_labels.numpy(),
                                  np.asarray(ref.multimodal_labels))
    np.testing.assert_array_equal(out.all_actions_mask.numpy(),
                                  np.asarray(ref.all_actions_mask))


def test_training_film_uses_the_batch_language_not_the_serving_vector():
    """FiLM in training conditions on the mean of the right-padded batch's
    non-action, non-pad text embeddings: changing a prompt token moves the
    patch rows' hidden states; changing an action token (its embedding is
    zeroed) or a pad (masked as a key) leaves the action hidden states."""
    cfg, platform, _, batch = CASES["aloha_film_l1"]
    base, trainables = _port_trees("aloha_film_l1")
    params = TT._merged_params(base, trainables, _port_cfg("l1", cfg))
    pc, pp = port_config(cfg), port_platform(platform)

    def run(ids):
        pb = _torch_batch(dict(batch, input_ids=ids))
        with torch.no_grad():
            return port_forward(params, pc, pp, pb["input_ids"], pb["attention_mask"],
                                pb["pixel_values"], pb["labels"], proprio=pb["proprio"],
                                use_flash=False)
    ref = run(batch["input_ids"])
    prompt, action, pad = (batch["input_ids"].copy() for _ in range(3))
    prompt[0, 2] += 1
    action[0, 10] = ACTION_TOKEN_BEGIN_IDX + (6 if action[0, 10] == ACTION_TOKEN_BEGIN_IDX + 5
                                              else 5)
    pad[0, -1] = 17
    assert batch["attention_mask"][0, -1] == 0 and batch["labels"][0, 10] != IGNORE_INDEX
    for ids in (action, pad):
        assert torch.equal(run(ids).actions_hidden, ref.actions_hidden)
    n_patch = 3 * CFG.vision_configs[0].num_patches
    moved = run(prompt).hidden_states[0, 1:1 + n_patch] - ref.hidden_states[0, 1:1 + n_patch]
    assert moved.abs().max() > 1e-6


# --- the losses, gradients and the update ---------------------------------------------

@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_jax(name, use_flash, monkeypatch):
    """Loss, every trainable gradient, the trainables after one AdamW
    update and (discrete) every metric, against JAX's eager
    `loss_and_metrics` with remat "none" and optax (the pattern of
    test_torch_train_step.py::test_train_step_matches_jax)."""
    cfg, platform, objective, batch = CASES[name]
    if objective == "l1":
        # The L1 gradient is sign(residual): fp32 noise between the two
        # frameworks flips the sign of residuals near 0, each flip a jump in
        # the gradient (measured at ALOHA's 700 residuals: 2.8e-2 of a leaf's
        # largest entry). Targets above every prediction fix the signs, as
        # test_torch_gpu.py's training test does.
        batch = dict(batch, actions=np.full_like(batch["actions"], 10.0))
    np_base, np_train = _setup(name)
    jcfg = _jax_cfg(objective, cfg, remat_policy="none")
    key = jax.random.PRNGKey(0)
    tr_j = jax.tree_util.tree_map(jnp.asarray, np_train)
    (loss_j, metrics_j), grads_j = jax.value_and_grad(JT.loss_and_metrics, has_aux=True)(
        tr_j, jax.tree_util.tree_map(jnp.asarray, np_base),
        {k: jnp.asarray(v) for k, v in batch.items()}, cfg, platform, jcfg, key, use_flash)
    tx = JT.make_optimizer(jcfg)
    updates, _ = tx.update(grads_j, tx.init(tr_j), tr_j)
    new_j = optax.apply_updates(tr_j, updates)

    if objective == "diffusion":
        _replay(monkeypatch, *_jax_draws(key, batch["actions"].shape[0], platform, T_STEPS))
    pcfg = _port_cfg(objective, cfg)
    base, trainables = _port_trees(name)
    state = TT.create_train_state(base, trainables, pcfg)
    pc, pp = port_config(cfg), port_platform(platform)
    loss_t, metrics_t = TT.loss_and_metrics(state.trainables, state.base_params,
                                            _torch_batch(batch), pc, pp, pcfg,
                                            state.generator, use_flash=use_flash)
    grads_t = torch.autograd.grad(loss_t, tree_leaves(state.trainables))
    state, metrics = TT.train_step(state, _torch_batch(batch), pc, pp, pcfg,
                                   use_flash=use_flash)

    assert set(metrics_t) == set(metrics_j)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=2e-4)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_j), rtol=2e-4)
    # A one-ulp flip of a bf16 head input (6-11 of the 7168 a forward, from
    # fp32 noise of 1e-6) moves the global norm by up to 3e-4 of it; each
    # leaf is bounded below.
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(TT.global_norm(grads_t)), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(optax.global_norm(grads_j)), rtol=1e-2)
    if objective == "discrete":
        for k, v in metrics_j.items():
            np.testing.assert_allclose(float(metrics_t[k]), float(v), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    flat_j = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(grads_j)]
    new_flat = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(new_j)]
    port_new = [t.detach().double().numpy() for t in tree_leaves(state.trainables)]
    assert len(flat_j) == len(grads_t) == len(port_new)
    for gj, gt, pj, pt in zip(flat_j, grads_t, new_flat, port_new):
        gt = gt.double().numpy()
        assert gj.shape == gt.shape == pj.shape == pt.shape
        scale = np.abs(gj).max()
        assert scale > 0
        assert np.abs(gt - gj).max() <= 1e-2 * scale
        assert _cos(gt, gj) >= 0.9999
        sure = np.abs(gj) > 1e-2 * scale
        assert np.abs(pt - pj)[sure].max() <= 1e-2 * LR
        assert np.abs(pt - pj).max() <= 2 * LR + 1e-6


def test_discrete_metrics_decode_bin_centres_as_xla_does():
    """The bin centres come from XLA's fp32 linspace form (one ulp from
    numpy's at some bins), and a perfect prediction scores 1 and 0."""
    centers = TT._bin_centers("cpu").numpy()
    bins = np.asarray(jnp.linspace(-1.0, 1.0, 256))
    np.testing.assert_array_equal(centers, (bins[:-1] + bins[1:]) / 2.0)
    _, _, _, batch = CASES["discrete"]
    labels = torch.from_numpy(np.array(batch["labels"])).long()
    logits = torch.full(labels.shape + (CFG.llm.vocab_size,), -5.0)
    nxt = torch.roll(labels, -1, dims=1)           # logits at i predict labels at i + 1
    logits.scatter_(-1, torch.clamp(nxt, min=0)[..., None], 40.0)
    loss, m = TT.discrete_metrics(logits, labels, port_platform(LIBERO))
    assert float(loss) < 1e-3
    for k in ("token_accuracy", "curr_action_accuracy", "next_actions_accuracy"):
        assert float(m[k]) == 1.0, k
    for k in ("curr_action_l1_loss", "next_actions_l1_loss"):
        assert float(m[k]) == 0.0, k


# --- the sampling metric --------------------------------------------------------------

@pytest.mark.parametrize("use_flash", [False, True])
def test_diffusion_sampling_metrics_matches_jax(use_flash, monkeypatch):
    """4 DDIM steps of the full training-layout forward on the training
    batch, from the same noise: the three L1 metrics within 1e-3. The JAX
    scan runs op by op (`jax.disable_jit`), so its head input is rounded to
    bf16 as the port rounds it. The bound: fp32 noise of about 1e-6 between
    the frameworks flips 6-11 of the 7168 bf16 head inputs by one ulp a
    forward, and the early DDIM steps scale the noise estimate by
    sqrt(1 - a_t) / sqrt(a_t); measured 2.0e-4 (dense) and 1.0e-4 (flash)."""
    cfg, platform, _, batch = CASES["diffusion"]
    np_base, np_train = _setup("diffusion")
    key = jax.random.PRNGKey(7)
    jcfg = dataclasses.replace(_jax_cfg("diffusion", cfg), num_diffusion_steps=4)
    with jax.disable_jit():
        want = JT.diffusion_sampling_metrics(
            jax.tree_util.tree_map(jnp.asarray, np_train),
            jax.tree_util.tree_map(jnp.asarray, np_base),
            {k: jnp.asarray(v) for k, v in batch.items()}, cfg, platform, jcfg, key,
            use_flash=use_flash)
    _replay(monkeypatch, noise=np.asarray(jax.random.normal(key, batch["actions"].shape,
                                                            jnp.float32)))
    base, trainables = _port_trees("diffusion")
    got = TT.diffusion_sampling_metrics(
        trainables, base, _torch_batch(batch), port_config(cfg), port_platform(platform),
        dataclasses.replace(_port_cfg("diffusion", cfg), num_diffusion_steps=4),
        torch.Generator(), use_flash=use_flash)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.isfinite(float(v))
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-3, atol=1e-3, err_msg=k)


def test_diffusion_sampling_counts_one_forward_a_step(monkeypatch):
    """The metric runs the training forward once per DDIM step, under
    no_grad (nothing is kept for a backward)."""
    cfg, platform, _, batch = CASES["diffusion"]
    base, trainables = _port_trees("diffusion")
    calls = []
    real = TT.prismatic_forward

    def counted(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*a, **kw)

    monkeypatch.setattr(TT, "prismatic_forward", counted)
    got = TT.diffusion_sampling_metrics(
        trainables, base, _torch_batch(batch), port_config(cfg), port_platform(platform),
        dataclasses.replace(_port_cfg("diffusion", cfg), num_diffusion_steps=5),
        torch.Generator().manual_seed(0), use_flash=False)
    assert calls == [False] * 5
    assert all(not v.requires_grad and np.isfinite(float(v)) for v in got.values())


# --- the lm_head product's backward ---------------------------------------------------

@pytest.mark.parametrize("w_grad", [False, True])
def test_lm_logits_backward_matches_the_upcast_product(w_grad):
    """bf16 operands through `_LmHeadProduct` (the Function the discrete
    objective differentiates on the card): the forward and both gradients
    bitwise equal to autograd through the fp32 upcast product."""
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((2, 5, 64), generator=gen).bfloat16().requires_grad_()
    w = torch.randn((64, 300), generator=gen).bfloat16().requires_grad_(w_grad)
    g = torch.randn((2, 5, 300), generator=gen)
    out = PL.lm_logits({"lm_head": {"kernel": w}}, h)
    ref = (h.float().reshape(-1, 64) @ w.float()).reshape(2, 5, 300)
    assert out.dtype == torch.float32 and torch.equal(out, ref)
    leaves = [h, w] if w_grad else [h]
    got = torch.autograd.grad(out, leaves, g)
    want = torch.autograd.grad(ref, leaves, g)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# --- the trainable groups -------------------------------------------------------------

@pytest.mark.parametrize("head,film,groups", [
    ("l1", False, {"lora", "action_head", "proprio_projector"}),
    ("diffusion", False, {"lora", "action_head", "proprio_projector",
                          "noisy_action_projector"}),
    ("discrete", False, {"lora", "proprio_projector"}),
    ("l1", True, {"lora", "action_head", "proprio_projector", "film"}),
])
def test_split_base_trainables_groups(head, film, groups):
    """The groups of vla_scripts/finetune.py:268-271, frozen base apart; the
    discrete objective keeps the lm_head in the base and has no action head."""
    from openvla_oft_tpu_torch.bridge import init_params, split_base_trainables

    cfg = port_config(dataclasses.replace(CFG, use_film=film))
    params = init_params(cfg, port_platform(LIBERO), torch.Generator().manual_seed(0),
                         dtype=torch.float32, head=head)
    base, trainables = split_base_trainables(params, torch.Generator().manual_seed(1), 4)
    assert set(trainables) == groups and set(base) == {"llm", "vision_backbone", "projector"}
    assert ("lm_head" in base["llm"]) == (head == "discrete")
    assert all(t.requires_grad for t in tree_leaves(trainables))
    assert not any(t.requires_grad for t in tree_leaves(base))
    _, no_proprio = split_base_trainables(params, torch.Generator().manual_seed(1), 4,
                                          use_proprio=False)
    assert set(no_proprio) == groups - {"proprio_projector"}
