"""The port's Phi-2 LLM (`openvla_oft_tpu_torch/models/phi.py`) and the VLA on it.

Mirrors every case of `tests/test_phi_parity.py`, each held against both a
random tiny HF `PhiForCausalLM` built from a config (nothing is
downloaded) and the JAX `phi_model`: the causal forward, the logits with
their bias, the padding mask, the KV decode against the full forward, the
registry, the VLA's serving layout against its training layout, the AR
decode against teacher forcing, and `fuse_inference_weights` returning a
Phi tree unchanged. Then the VLA on a tiny Phi LLM (vocab 32,064, as the
JAX test has it: the action tokens are Llama-range ids) against the JAX
package on the same numpy weights, in fp32: `prismatic_forward`'s loss and
gradients for the L1, diffusion and discrete objectives, the action logits,
a diffusion chunk through the full-prefill route from the same noise, the
AR tokens, and a tiny Phi checkpoint dir through both loaders and both
`get_vla`s (bf16, and int8 and int4 with the quantization floor lowered so
that the tiny LLM's linears quantize).

Tolerances: the LLM against HF and JAX to 2e-5 (fp32, the JAX test's);
the VLA's hidden states and logits to 1e-4, the losses to 2e-4 relative and
each gradient leaf to 1e-2 of its largest entry with a cosine >= 0.9999
(tests/test_torch_train_objectives.py's); served actions to 1e-4 in fp32
(tests/test_torch_eval_api.py's) and 2e-2 where the LLM is int8 or int4
(a dynamic activation scale one ulp apart moves a quantized product by one
step of its grid).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvla_oft_tpu.config as JC
import openvla_oft_tpu.utils.hf_import as JH
from openvla_oft_tpu.constants import (ACTION_TOKEN_BEGIN_IDX, EMPTY_TOKEN_ID, IGNORE_INDEX,
                                       LIBERO, STOP_INDEX)
from openvla_oft_tpu.models import phi as JP
from openvla_oft_tpu.models import prismatic as JM
from openvla_oft_tpu.policy import OpenVLAPolicy as JaxPolicy
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.training import train_step as JT
from openvla_oft_tpu.training.lora import init_lora as jax_init_lora
from openvla_oft_tpu.utils import weights as JW
from openvla_oft_tpu_torch import config as PC
from openvla_oft_tpu_torch.bridge import params_from_numpy, param_spec, tree_leaves
from openvla_oft_tpu_torch.models import llama as PL
from openvla_oft_tpu_torch.models import phi as PP
from openvla_oft_tpu_torch.models import prismatic as PM
from openvla_oft_tpu_torch.policy import OpenVLAPolicy
from openvla_oft_tpu_torch.training import train_step as TT
from openvla_oft_tpu_torch.utils import weights as PW
from test_torch_import import port_arch, port_config, port_platform
from test_torch_train_objectives import _jax_draws, _replay
from test_training import _batch

torch.backends.cuda.matmul.allow_tf32 = False

TINY = JC.PhiConfig(vocab_size=96, hidden_size=40, intermediate_size=64, num_layers=2,
                    num_heads=4, partial_rotary_factor=0.4, max_position_embeddings=512)
P_TINY = port_arch(TINY)
LLM_TOL = 2e-5
TOL = 1e-4

# The VLA's tiny Phi: vocab above EMPTY_TOKEN_ID (29871), as the JAX test has it.
TINY_PHI_VLA = JC.PhiConfig(vocab_size=32064, hidden_size=64, intermediate_size=128,
                            num_layers=2, num_heads=4)
JC._VISION_REGISTRY.setdefault("tiny-dual", (JC.TINY_DINOV2, JC.TINY_SIGLIP))
JC._LLM_REGISTRY["tiny-phi-vla"] = TINY_PHI_VLA
CFG = JC.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-phi-vla",
                       num_images_in_input=1)
P_CFG = port_config(CFG)
P_TINY_VLA = P_CFG.llm
PLAT = port_platform(LIBERO)


@pytest.fixture(scope="module")
def hf_model():
    from transformers import PhiConfig as HFConfig
    from transformers import PhiForCausalLM

    torch.manual_seed(0)
    hf_cfg = HFConfig(
        vocab_size=TINY.vocab_size, hidden_size=TINY.hidden_size,
        intermediate_size=TINY.intermediate_size, num_hidden_layers=TINY.num_layers,
        num_attention_heads=TINY.num_heads, partial_rotary_factor=TINY.partial_rotary_factor,
        layer_norm_eps=TINY.layer_norm_eps, rope_theta=TINY.rope_theta,
        tie_word_embeddings=False, attn_implementation="eager")
    model = PhiForCausalLM(hf_cfg).eval()
    with torch.no_grad():           # HF zeroes the biases: draw them, so they count
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1)
    sd = model.state_dict()
    port = PW.port_hf_phi(PW.dict_getter(sd), P_TINY)
    ref = JW.port_hf_phi(JW.dict_getter({k: v.numpy() for k, v in sd.items()}), TINY)
    return model, port, jax.tree_util.tree_map(jnp.asarray, ref)


def _close(got, want, tol=LLM_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_rotary_dim():
    assert P_TINY.head_dim == 10 and P_TINY.rotary_dim == 4
    assert PC.PhiConfig().rotary_dim == 32            # Phi-2: 0.4 * 80


def test_port_hf_phi_matches_jax_porter(hf_model):
    _, port, ref = hf_model
    flat_p = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert flat_p.keys() == flat_j.keys()
    for k, v in flat_p.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(flat_j[k]), err_msg=str(k))


def test_causal_forward_matches_hf_and_jax(hf_model, rng):
    model, port, ref = hf_model
    x = rng.standard_normal((2, 9, TINY.hidden_size)).astype(np.float32)
    ours = PP.phi_model(port, P_TINY, torch.from_numpy(x))
    with torch.no_grad():
        theirs = model.model(inputs_embeds=torch.from_numpy(x)).last_hidden_state
    _close(ours, theirs)
    _close(ours, JP.phi_model(ref, TINY, jnp.asarray(x)))


def test_logits_match_hf_including_bias(hf_model, rng):
    model, port, ref = hf_model
    ids = rng.integers(0, TINY.vocab_size, (1, 7))
    ours = PP.lm_logits(port, PP.phi_model(port, P_TINY, PP.embed_tokens(port,
                                                                          torch.from_numpy(ids))))
    assert ours.dtype == torch.float32 and port["lm_head"]["bias"].abs().max() > 0
    with torch.no_grad():
        _close(ours, model(input_ids=torch.from_numpy(ids)).logits)
    emb = JP.embed_tokens(ref, jnp.asarray(ids))
    _close(ours, JP.lm_logits(ref, JP.phi_model(ref, TINY, emb)))


def test_padding_mask_matches_hf_and_jax(hf_model, rng):
    model, port, ref = hf_model
    x = rng.standard_normal((2, 8, TINY.hidden_size)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1, 1, 1]])
    ours = PP.phi_model(port, P_TINY, torch.from_numpy(x),
                        padding_mask=torch.from_numpy(mask)).numpy()
    with torch.no_grad():
        theirs = model.model(inputs_embeds=torch.from_numpy(x),
                             attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
    sel = mask.astype(bool)
    _close(ours[sel], theirs[sel])
    want = JP.phi_model(ref, TINY, jnp.asarray(x), padding_mask=jnp.asarray(mask))
    _close(ours, want)


def test_kv_cache_decode_matches_full_forward(hf_model, rng):
    from openvla_oft_tpu.models.llama import KVCache as JaxCache

    _, port, ref = hf_model
    ids = rng.integers(0, TINY.vocab_size, (1, 10))
    emb = PP.embed_tokens(port, torch.from_numpy(ids))
    full = PP.phi_model(port, P_TINY, emb)
    cache = PL.KVCache.create(P_TINY, 1, 16, dtype=torch.float32)
    pre, cache = PP.phi_prefill(port, P_TINY, emb[:, :6], cache)
    _close(pre, full[:, :6], 1e-5)
    outs = []
    for t in range(6, 10):
        h, cache = PP.phi_decode_step(port, P_TINY, emb[:, t:t + 1], cache)
        outs.append(h[:, 0])
    _close(torch.stack(outs, 1), full[:, 6:10], 1e-5)
    assert cache.index == 10 and cache.valid[0, :10].all() and not cache.valid[0, 10:].any()

    j_emb = JP.embed_tokens(ref, jnp.asarray(ids))
    j_cache = JaxCache.create(TINY, 1, 16, dtype=jnp.float32)
    j_pre, j_cache = JP.phi_prefill(ref, TINY, j_emb[:, :6], j_cache)
    _close(pre, j_pre)
    for i, t in enumerate(range(6, 10)):
        j_h, j_cache = JP.phi_decode_step(ref, TINY, j_emb[:, t:t + 1], j_cache)
        _close(outs[i], j_h[:, 0])
    _close(cache.k[:, :, :10], j_cache.k[:, :, :10])


def test_phi_registered_as_llm_backbone_and_registry_row():
    from openvla_oft_tpu_torch.models.registry import MODEL_REGISTRY

    cfg = PC._LLM_REGISTRY["phi-2-3b"]
    assert cfg.hidden_size == 2560 and cfg.num_layers == 32
    assert cfg.num_kv_heads == cfg.num_heads == 32 and cfg.head_dim == 80
    entry = MODEL_REGISTRY["phi-2+3b"]
    model_cfg = PC.OpenVLAConfig(vision_backbone_id=entry.vision_backbone_id,
                                 llm_backbone_id=entry.llm_backbone_id)
    assert isinstance(model_cfg.llm, PC.PhiConfig) and model_cfg.llm_dim == 2560
    spec = param_spec(model_cfg, PLAT, head="discrete")["llm"]
    n = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(
        spec, is_leaf=lambda s: hasattr(s, "shape")))
    assert 2.77e9 < n < 2.79e9                     # Phi-2's 2.78 B with its lm_head
    assert spec["layers"]["attn"]["wq"]["kernel"].shape == (32, 2560, 2560)
    assert spec["lm_head"]["bias"].shape == (51200,)


def test_fuse_inference_weights_phi_noop():
    spec = param_spec(P_CFG, PLAT)
    llm = params_from_numpy(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), spec["llm"],
        is_leaf=lambda s: hasattr(s, "shape")))
    assert PL.fuse_inference_weights(llm) is llm
    assert PL.fuse_inference_weights(llm, fold_norms=False) is llm


# === The VLA on a tiny Phi LLM ===

@functools.lru_cache(maxsize=None)
def _np_init(head, seed):
    full = init_openvla_params(jax.random.PRNGKey(seed), CFG, LIBERO, dtype=jnp.float32,
                               head=head, with_lm_head=head is None)
    return jax.tree_util.tree_map(np.asarray, full)


def _np_params(head, seed=0):
    """The JAX init as numpy (a fresh copy of each leaf)."""
    return jax.tree_util.tree_map(np.array, _np_init(head, seed))


@pytest.fixture(scope="module")
def vla_l1():
    return _np_params("l1")


def _inputs(pad=3, seed=3):
    g = np.random.default_rng(seed)
    prompt = np.array([1, 20, 30, 40, EMPTY_TOKEN_ID])
    ids = np.concatenate([np.zeros(pad, np.int64), prompt])[None]
    mask = np.concatenate([np.zeros(pad), np.ones(len(prompt))])[None].astype(np.int64)
    h = JC.TINY_DINOV2.image_size
    pixels = g.random((1, 1, 2, h, h, 3)).astype(np.float32)
    proprio = g.random((1, LIBERO.proprio_dim)).astype(np.float32)
    return prompt, ids, mask, pixels, proprio


def test_param_spec_matches_the_jax_init(vla_l1):
    spec = param_spec(P_CFG, PLAT, head="l1")
    got = jax.tree_util.tree_map(lambda s: tuple(s.shape), spec,
                                 is_leaf=lambda s: hasattr(s, "shape"))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), vla_l1)
    assert got == want
    disc = param_spec(P_CFG, PLAT, head="discrete")["llm"]["lm_head"]
    assert disc["kernel"].shape == (64, 32064) and disc["bias"].fill == 0.0


def test_vla_cross_layout_matches_jax(vla_l1):
    """The left-padded serving layout against the training layout (the JAX
    test), each side against JAX's, finite."""
    prompt, ids, mask, pixels, proprio = _inputs()
    g = np.random.default_rng(3)
    action_ids = list(g.integers(ACTION_TOKEN_BEGIN_IDX + 1, ACTION_TOKEN_BEGIN_IDX + 257,
                                 LIBERO.chunk_len))
    full = np.array(list(prompt) + action_ids + [STOP_INDEX])[None]
    labels = np.array([IGNORE_INDEX] * len(prompt) + action_ids + [STOP_INDEX])[None]
    jp = jax.tree_util.tree_map(jnp.asarray, vla_l1)
    j_train = jax.jit(lambda p, *a: JM.prismatic_forward(
        p, CFG, LIBERO, a[0], jnp.ones(full.shape, jnp.int32), *a[1:3], proprio=a[3],
        compute_logits=False))(jp, *map(jnp.asarray, (full, pixels, labels, proprio)))
    j_pred = jax.jit(lambda p, *a: JM.predict_action_hidden(p, CFG, LIBERO, *a[:3],
                                                            proprio=a[3]))(
        jp, *map(jnp.asarray, (ids, mask, pixels, proprio)))
    pp = params_from_numpy(vla_l1)
    t = torch.from_numpy
    with torch.no_grad():
        train = PM.prismatic_forward(pp, P_CFG, PLAT, t(full), torch.ones(full.shape,
                                                                          dtype=torch.int64),
                                     t(pixels), t(labels), proprio=t(proprio))
        pred = PM.predict_action_hidden(pp, P_CFG, PLAT, t(ids), t(mask), t(pixels),
                                        proprio=t(proprio), use_flash=True)
    a, b = pred.actions_hidden.numpy(), train.actions_hidden.numpy()
    assert np.isfinite(a).all() and np.isfinite(b).all()
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    _close(a, j_pred.actions_hidden, TOL)
    _close(b, j_train.actions_hidden, TOL)
    _close(train.hidden_states, j_train.hidden_states, TOL)


def test_action_logits_with_bias_match_jax():
    """The discrete head's logits over the action rows (biased lm_head)."""
    np_params = _np_params(None)
    rng = np.random.default_rng(8)
    np_params["llm"]["lm_head"]["bias"] = rng.standard_normal(32064).astype(np.float32)
    _, ids, mask, pixels, proprio = _inputs()
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    want = jax.jit(lambda p, *a: JM.predict_action_hidden(
        p, CFG, LIBERO, *a[:3], proprio=a[3], compute_logits=True).action_logits)(
        jp, *map(jnp.asarray, (ids, mask, pixels, proprio)))
    t = torch.from_numpy
    with torch.no_grad():
        got = PM.predict_action_hidden(params_from_numpy(np_params), P_CFG, PLAT, t(ids),
                                       t(mask), t(pixels), proprio=t(proprio),
                                       compute_logits=True).action_logits
    assert got.shape == (1, LIBERO.chunk_len, 32064) and got.dtype == torch.float32
    _close(got, want, TOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


def test_autoregressive_matches_jax_and_teacher_forcing():
    """Greedy KV-cached tokens equal JAX's; each step's logits equal the
    no-cache full forward's over the prompt and the tokens before it."""
    np_params = _np_params(None, seed=1)
    _, ids, mask, pixels, _ = _inputs(pad=2, seed=5)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    want = JM.predict_action_autoregressive(jp, CFG, LIBERO, jnp.asarray(ids),
                                            jnp.asarray(mask), jnp.asarray(pixels),
                                            num_new_tokens=LIBERO.action_dim)
    pp = params_from_numpy(np_params)
    t = torch.from_numpy
    with torch.no_grad():
        toks, logits = PM.predict_action_autoregressive(
            pp, P_CFG, PLAT, t(ids), t(mask), t(pixels), num_new_tokens=LIBERO.action_dim,
            return_logits=True)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
        assert (toks >= 0).all() and (toks < 32064).all()
        embeds, positions, key_valid, pad = PM.autoregressive_layout(pp, P_CFG, t(ids),
                                                                     t(mask), t(pixels))
        s = embeds.shape[1]
        seq = torch.cat([embeds, PP.embed_tokens(pp["llm"], toks[:, :-1])], dim=1)
        n = seq.shape[1]
        pos = torch.cat([positions, positions[:, -1:] + torch.arange(1, n - s + 1)], dim=1)
        valid = torch.cat([key_valid, torch.ones((1, n - s), dtype=torch.bool)], dim=1)
        hidden = PP.phi_model(pp["llm"], P_TINY_VLA, seq, padding_mask=valid, positions=pos)
        teacher = PP.lm_logits(pp["llm"], hidden[:, s - 1:])
    _close(logits, teacher, TOL)
    np.testing.assert_array_equal(teacher.argmax(-1).numpy(), toks.numpy())



def _train_setup(objective):
    """(numpy base, numpy trainables) as test_torch_train_objectives builds
    them: the JAX init, LoRA B drawn non-zero."""
    head = {"l1": "l1", "diffusion": "diffusion", "discrete": None}[objective]
    full = _np_params(head)
    base = {k: full[k] for k in ("llm", "vision_backbone", "projector")}
    lora = jax_init_lora(jax.random.PRNGKey(1), base, rank=4)
    rng = np.random.default_rng(5)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) + (0.02 * rng.standard_normal(x.shape)).astype(np.float32)
        if p[-1].key == "b" else np.asarray(x), lora)
    trainables = {"lora": lora}
    for k in ("action_head", "proprio_projector", "noisy_action_projector"):
        if k in full:
            trainables[k] = full[k]
    return base, jax.tree_util.tree_map(np.asarray, trainables)


@pytest.mark.parametrize("objective", ["l1", "diffusion", "discrete"])
def test_train_step_through_phi_matches_jax(objective, monkeypatch):
    """The loss and every trainable gradient of one step against JAX's
    `loss_and_metrics` (jitted, as JAX trains); LoRA sits on wq/wk/wv/wo only, fc1/fc2 stay
    frozen (JAX's targets)."""
    np_base, np_train = _train_setup(objective)
    assert set(np_train["lora"]["llm"]["layers"]) == {"attn"}
    assert set(np_train["lora"]["llm"]["layers"]["attn"]) == {"wq", "wk", "wv", "wo"}
    batch = {k: np.asarray(v) for k, v in _batch().items()}
    if objective == "l1":
        batch["actions"] = np.full_like(batch["actions"], 10.0)   # fixed residual signs
    kw = dict(objective=objective, learning_rate=1e-3, lora_rank=4, lora_alpha=4.0,
              num_diffusion_steps=100)
    jcfg = JT.TrainConfig(remat_policy="none", **kw)
    key = jax.random.PRNGKey(0)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda tr, base, b, k: JT.loss_and_metrics(tr, base, b, CFG, LIBERO, jcfg, k, False),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, np_train),
                       jax.tree_util.tree_map(jnp.asarray, np_base),
                       {k: jnp.asarray(v) for k, v in batch.items()}, key)
    if objective == "diffusion":
        _replay(monkeypatch, *_jax_draws(key, batch["actions"].shape[0], LIBERO, 100))
    pcfg = TT.TrainConfig(remat_policy="all", **kw)
    base, trainables = params_from_numpy(np_base), params_from_numpy(np_train)
    for leaf in tree_leaves(trainables):
        leaf.requires_grad_(True)
    state = TT.create_train_state(base, trainables, pcfg)
    loss_t, metrics_t = TT.loss_and_metrics(
        state.trainables, state.base_params,
        {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}, P_CFG, PLAT, pcfg,
        state.generator, use_flash="auto")
    grads_t = torch.autograd.grad(loss_t, tree_leaves(state.trainables))
    assert set(metrics_t) == set(metrics_j)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=2e-4)
    by_leaf = {id(t): g.numpy() for t, g in zip(tree_leaves(state.trainables), grads_t)}
    got = {jax.tree_util.keystr(p): by_leaf[id(t)]
           for p, t in jax.tree_util.tree_flatten_with_path(state.trainables)[0]}
    want = {jax.tree_util.keystr(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]}
    assert got.keys() == want.keys()
    for name, b in want.items():
        a = got[name]
        scale = max(np.abs(b).max(), 1e-12)
        assert np.abs(a - b).max() <= 1e-2 * scale
        if np.abs(b).max() > 0:
            cos = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos >= 0.9999


def test_diffusion_chunk_takes_the_full_prefill_route_and_matches_jax():
    """A Phi policy with prefix K/V reuse asked for (and split_kv) runs one
    full predict_action_hidden a step, as JAX does: the chunk from JAX's
    noise equals JAX's to 1e-4, and equals the port's with both switches off
    bit for bit."""
    np_params = _np_params("diffusion")
    _, ids, mask, pixels, proprio = _inputs()
    jax_policy = JaxPolicy(CFG, LIBERO, jax.tree_util.tree_map(jnp.asarray, np_params),
                           head="diffusion", num_diffusion_steps_inference=4)
    key = jax.random.PRNGKey(4)
    want, _ = jax_policy._diffusion_loop(jax_policy.params, jnp.asarray(ids), jnp.asarray(mask),
                                      jnp.asarray(pixels), jnp.asarray(proprio), noise_key=key)
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, (1, LIBERO.num_actions_chunk, LIBERO.action_dim), dtype=jnp.float32)))
    t = torch.from_numpy
    got = {}
    for prefix_kv in (True, False):
        policy = OpenVLAPolicy(P_CFG, PLAT, params_from_numpy(np_params), head="diffusion",
                               num_diffusion_steps_inference=4, diffusion_prefix_kv=prefix_kv,
                               split_kv=prefix_kv)
        with torch.no_grad():
            got[prefix_kv] = policy._diffusion_loop(t(ids), t(mask), t(pixels), t(proprio),
                                                    noise=noise.clone())
    assert torch.equal(got[True], got[False])
    _close(got[True], want, TOL)
    with pytest.raises(ValueError, match="Phi-2"):
        PM.build_diffusion_prefix(params_from_numpy(np_params), P_CFG, t(ids), t(mask),
                                  t(pixels))


# === A tiny Phi checkpoint dir through both loaders ===

STATS = {"libero_spatial": {
    "action": {"min": [-1.0] * 7, "max": [1.0] * 7, "q01": [-0.9] * 7, "q99": [0.9] * 7,
               "mask": [True] * 6 + [False]},
    "proprio": {"min": [-1.0] * 8, "max": [1.0] * 8, "q01": [-0.9] * 8, "q99": [0.9] * 8},
}}


@pytest.fixture(scope="module")
def phi_dir(tmp_path_factory):
    from openvla_oft_tpu.training.checkpoint import export_module_pt
    from openvla_oft_tpu_torch.utils.hf_import import export_phi, export_vision_tensors, hf_config
    from openvla_oft_tpu_torch.utils.safetensors_io import save_file
    from test_torch_eval_api import tokenizer_model

    np_params = _np_params("l1")
    rng = np.random.default_rng(2)
    np_params["llm"]["lm_head"] = {
        "kernel": rng.standard_normal((64, 32064)).astype(np.float32) / 8,
        "bias": rng.standard_normal(32064).astype(np.float32)}
    np_params["llm"]["layers"]["attn"]["wq"]["bias"] = \
        rng.standard_normal((2, 64)).astype(np.float32) * 0.1
    path = tmp_path_factory.mktemp("phi_ckpt")
    pt = params_from_numpy(np_params)
    tensors = {**export_phi(pt["llm"], P_CFG.llm), **export_vision_tensors(P_CFG, pt)}
    save_file({k: v.contiguous() for k, v in tensors.items()}, str(path / "model.safetensors"))
    import json

    (path / "config.json").write_text(json.dumps(hf_config(P_CFG, STATS)))
    (path / "tokenizer.model").write_bytes(tokenizer_model())
    export_module_pt(np_params["proprio_projector"], "proprio_projector", str(path), 10)
    export_module_pt(np_params["action_head"], "action_head", str(path), 10)
    return str(path), np_params


def test_phi_dir_loads_equal_through_both_loaders(phi_dir):
    from openvla_oft_tpu_torch.utils.hf_import import load_openvla_checkpoint

    path, np_params = phi_dir
    j_cfg, j_params, j_stats = JH.load_openvla_checkpoint(path)
    p_cfg, p_params, p_stats = load_openvla_checkpoint(path, head="discrete")
    assert isinstance(p_cfg.llm, PC.PhiConfig) and p_cfg.llm == P_CFG.llm
    assert p_stats == j_stats == STATS
    flat_j = dict(jax.tree_util.tree_flatten_with_path(j_params)[0])
    flat_p = dict(jax.tree_util.tree_flatten_with_path(p_params)[0])
    assert flat_p.keys() == flat_j.keys()
    for k, v in flat_p.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(flat_j[k]), err_msg=str(k))
    np.testing.assert_array_equal(p_params["llm"]["lm_head"]["bias"].numpy(),
                                  np_params["llm"]["lm_head"]["bias"])
    assert "lm_head" not in load_openvla_checkpoint(path, head="l1")[1]["llm"]


def _eval_cfg(path, **kw):
    return types.SimpleNamespace(**{
        "pretrained_checkpoint": path, "num_images_in_input": 1, "center_crop": True,
        "use_l1_regression": True, "use_diffusion": False, "use_film": False,
        "use_proprio": True, "unnorm_key": "libero_spatial", "num_open_loop_steps": 8,
        "model_family": "openvla", "device_preprocess": False, "device": "cpu", **kw})


@pytest.mark.parametrize("quant", [None, "load_in_8bit", "load_in_4bit"])
def test_get_vla_serves_a_phi_dir_as_jax_does(phi_dir, quant, monkeypatch, rng):
    """JAX's get_vla serves a Phi dir in each mode, so the port's does: the
    same actions (fp32; int8 and int4 with the quantization floor lowered to
    32 on both sides, so the tiny LLM's linears are quantized)."""
    import experiments.robot.openvla_utils as JU
    import openvla_oft_tpu.ops.quant as JQ
    from openvla_oft_tpu_torch.serving import deploy
    from openvla_oft_tpu_torch.serving import openvla_utils as PU

    path, _ = phi_dir
    load = JH.load_openvla_checkpoint
    monkeypatch.setattr(JH, "load_openvla_checkpoint",
                        lambda ckpt, dtype=None: load(ckpt, dtype=jnp.float32))
    for name in ("quantize_tree", "quantize_tree_lowmem"):
        fn = getattr(JQ, name)
        monkeypatch.setattr(JQ, name, functools.partial(
            lambda fn, params, min_dim=1024, bits=8: fn(params, min_dim=32, bits=bits), fn))
    monkeypatch.setattr(deploy, "QUANT_MIN_DIM", 32)
    cfg = _eval_cfg(path, **({quant: True} if quant else {}))
    j_vla, p_vla = JU.get_vla(cfg), PU.get_vla(cfg, dtype=torch.float32)
    wq = p_vla.params["llm"]["layers"]["attn"]["wq"]
    if quant == "load_in_8bit":
        assert wq["kernel"].dtype == torch.int8 and "bias" in wq
        assert np.asarray(j_vla.params["llm"]["layers"]["attn"]["wq"]["kernel"]).dtype == np.int8
    elif quant == "load_in_4bit":
        assert "kernel_q4" in wq and "bias" in wq
        assert "kernel_q4" in j_vla.params["llm"]["layers"]["attn"]["wq"]
    else:
        assert wq["kernel"].dtype == torch.float32
    obs = {"full_image": rng.integers(0, 256, (120, 160, 3), dtype=np.uint8),
           "state": rng.uniform(-1.2, 1.2, 8).astype(np.float32)}
    mods = {name: (JU, PU) for name in ("proprio_projector", "action_head")}
    want = JU.get_vla_action(cfg, j_vla, JU.get_processor(cfg), dict(obs), "put the bowl",
                             **{n: getattr(j, f"get_{n}")(cfg) for n, (j, _) in mods.items()})
    got = PU.get_vla_action(cfg, p_vla, PU.get_processor(cfg), dict(obs), "put the bowl",
                            **{n: getattr(p, f"get_{n}")(cfg) for n, (_, p) in mods.items()})
    tol = TOL if quant is None else 2e-2
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=tol, atol=tol)
