"""FiLM and the ALOHA serving slice against the JAX package on the CPU in
fp32: FiLM in the ViT (identity at zero, language dependence, parity), the
FiLM language embedding through `predict_action_hidden` with 3 images and
the ALOHA platform, `serve_action_chunk` for ALOHA with the ViTs' K4 path off
and on, and the bridge of a FiLM param tree.

Mirrors tests/test_film.py. Tolerances: 1e-5 for one ViT, 1e-4 for the whole
prefill and serving path, as tests/test_torch_serve.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from openvla_oft_tpu.config import OpenVLAConfig, TINY_DINOV2
from openvla_oft_tpu.constants import ALOHA, EMPTY_TOKEN_ID, LIBERO
from openvla_oft_tpu.models.prismatic import predict_action_hidden as jax_predict
from openvla_oft_tpu.models.vit import init_film_params, init_vit_params, vit_featurize
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.policy import serve_action_chunk as jax_serve
from openvla_oft_tpu_torch.bridge import param_spec, params_from_numpy
from openvla_oft_tpu_torch.models import vit as TV
from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden, prismatic_forward
from openvla_oft_tpu_torch.ops import vit_fused as VF
from openvla_oft_tpu_torch.policy import serve_action_chunk
from test_torch_bridge import _flatten
from test_torch_import import port_arch, port_config, port_platform

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ALOHA_CFG = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                          num_images_in_input=3, use_film=True)
P_ALOHA_CFG, P_ALOHA = port_config(ALOHA_CFG), port_platform(ALOHA)


def _vit_and_film(llm_dim=64):
    cfg = TINY_DINOV2
    params = init_vit_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    film = init_film_params(jax.random.PRNGKey(1), cfg, llm_dim=llm_dim)
    return cfg, params, film


def test_film_zero_init_is_identity(rng):
    cfg, params, film = _vit_and_film()
    film = jax.tree_util.tree_map(jnp.zeros_like, film)             # gamma = beta = 0
    x = torch.from_numpy(rng.random((2, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    le = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    tp, pcfg = params_from_numpy(params), port_arch(cfg)
    plain = TV.vit_featurize(tp, pcfg, x)
    filmed = TV.vit_featurize(tp, pcfg, x, film_params=params_from_numpy(film),
                              language_embedding=le)
    np.testing.assert_allclose(filmed.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)


def test_film_matches_jax_and_depends_on_the_language(rng):
    cfg, params, film = _vit_and_film()
    x = rng.random((1, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    tp, tf, pcfg = params_from_numpy(params), params_from_numpy(film), port_arch(cfg)
    outs = []
    for _ in range(2):
        le = rng.standard_normal((1, 64)).astype(np.float32)
        ref = np.asarray(vit_featurize(params, cfg, jnp.asarray(x), film_params=film,
                                       language_embedding=jnp.asarray(le)))
        got = TV.vit_featurize(tp, pcfg, torch.from_numpy(x), film_params=tf,
                               language_embedding=torch.from_numpy(le)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        outs.append(got)
    assert np.abs(outs[0] - outs[1]).max() > 1e-4


def test_film_in_bf16_matches_jax(rng):
    """A bf16 ViT with bf16 FiLM projectors (the flagship's serving dtypes)
    against the JAX one: gamma and beta from fp32 products, cast to bf16,
    applied in bf16; within 4 bf16 ulps at tensor scale after 2 blocks."""
    cfg, params, film = _vit_and_film()
    x = jnp.asarray(rng.random((1, cfg.image_size, cfg.image_size, 3)), jnp.bfloat16)
    le = rng.standard_normal((1, 64)).astype(np.float32)
    p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    f16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), film)
    ref = np.asarray(vit_featurize(p16, cfg, x, film_params=f16,
                                   language_embedding=jnp.asarray(le)).astype(jnp.float32))
    got = TV.vit_featurize(params_from_numpy(p16), port_arch(cfg), params_from_numpy(x),
                           film_params=params_from_numpy(f16),
                           language_embedding=torch.from_numpy(le)).float().numpy()
    assert np.abs(got - ref).max() <= 4 * 2.0 ** -8 * np.abs(ref).max()


def _prompt(rng, bucket=16, n_real=10):
    ids = np.zeros((1, bucket), np.int32)
    mask = np.zeros((1, bucket), np.int32)
    real = [1] + list(rng.integers(10, 1000, n_real - 2)) + [EMPTY_TOKEN_ID]
    ids[0, bucket - n_real:] = real
    mask[0, bucket - n_real:] = 1
    return ids, mask


def test_predict_action_hidden_aloha_film_matches_jax(rng):
    params = init_openvla_params(jax.random.PRNGKey(4), ALOHA_CFG, ALOHA,
                                 dtype=jnp.float32, head="l1")
    h = TINY_DINOV2.image_size
    pixels = rng.random((1, 3, 2, h, h, 3)).astype(np.float32)
    ids, mask = _prompt(rng)
    proprio = rng.random((1, ALOHA.proprio_dim)).astype(np.float32)
    ref = jax_predict(params, ALOHA_CFG, ALOHA, input_ids=jnp.asarray(ids),
                      prompt_mask=jnp.asarray(mask), pixels=jnp.asarray(pixels),
                      proprio=jnp.asarray(proprio))
    got = predict_action_hidden(params_from_numpy(params), P_ALOHA_CFG, P_ALOHA,
                                torch.from_numpy(ids), torch.from_numpy(mask),
                                torch.from_numpy(pixels), torch.from_numpy(proprio))
    assert got.actions_hidden.shape == (1, ALOHA.chunk_len, ALOHA_CFG.llm_dim)
    np.testing.assert_allclose(got.actions_hidden.numpy(), np.asarray(ref.actions_hidden),
                               rtol=1e-4, atol=1e-4)
    # FiLM changes the answer: the same weights without it differ.
    off = predict_action_hidden(params_from_numpy(params),
                                dataclasses.replace(P_ALOHA_CFG, use_film=False), P_ALOHA,
                                torch.from_numpy(ids), torch.from_numpy(mask),
                                torch.from_numpy(pixels), torch.from_numpy(proprio))
    assert (off.actions_hidden - got.actions_hidden).abs().max() > 1e-4


def _aloha_serve_inputs(rng):
    """Three frames at the model's size, as the ALOHA client sends 224 x 224."""
    size = TINY_DINOV2.image_size
    ids, mask = _prompt(rng)
    d, pd = ALOHA.action_dim, ALOHA.proprio_dim
    return dict(
        frames_u8=(rng.random((1, 3, size, size, 3)) * 255).astype(np.uint8),
        input_ids=ids, prompt_mask=mask,
        proprio=rng.random((1, pd)).astype(np.float32) * 3 - 1,
        action_low=np.linspace(-0.9, -0.2, d).astype(np.float32),
        action_high=np.linspace(0.2, 0.9, d).astype(np.float32),
        action_mask=np.asarray([True] * (d - 1) + [False]),
        proprio_low=np.full((pd,), -1.5, np.float32),
        proprio_high=np.full((pd,), 2.5, np.float32))


@pytest.mark.parametrize("vit_fused", [False, True], ids=["unfused", "vit_fused"])
def test_serve_action_chunk_aloha_matches_jax(rng, monkeypatch, vit_fused):
    """The port's ViTs in the serving layout (folded), through ln_matmul or
    not, against the JAX path on the unfolded weights. No center crop: its
    uint8 stage may put a pixel one LSB off the JAX one (pinned at <= 0.1%
    in test_torch_serve.py::test_device_preprocess_matches_jax), which moves
    these actions by up to 3e-4."""
    params = init_openvla_params(jax.random.PRNGKey(0), ALOHA_CFG, ALOHA,
                                 dtype=jnp.float32, head="l1")
    inputs = _aloha_serve_inputs(rng)
    size = TINY_DINOV2.image_size
    ref = np.asarray(jax_serve(params, ALOHA_CFG, ALOHA,
                               **{k: jnp.asarray(v) for k, v in inputs.items()},
                               resize_size=size, center_crop=False))
    tp = params_from_numpy(params)
    tp["vision_backbone"] = {k: TV.fuse_vit_inference_weights(v)
                             for k, v in tp["vision_backbone"].items()}
    calls = []
    fn = VF.ln_matmul
    monkeypatch.setattr(VF, "ln_matmul", lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    got = serve_action_chunk(tp, P_ALOHA_CFG, P_ALOHA,
                             **{k: torch.from_numpy(v) for k, v in inputs.items()},
                             resize_size=size, center_crop=False, vit_fused=vit_fused).numpy()
    blocks = sum(v.depth - 1 for v in ALOHA_CFG.vision_configs)
    assert len(calls) == (2 * blocks if vit_fused else 0)
    assert got.shape == (1, ALOHA.num_actions_chunk, ALOHA.action_dim) == (1, 25, 14)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_film_tree_converts_leaf_for_leaf(dtype):
    tree = init_openvla_params(jax.random.PRNGKey(0), ALOHA_CFG, ALOHA, head="l1", dtype=dtype)
    assert "film" in tree
    src, dst = _flatten(tree["film"]), _flatten(params_from_numpy(tree)["film"])
    assert set(src) == set(dst) and len(src) == 8      # 2 backbones x scale/shift x kernel/bias
    for path, leaf in src.items():
        assert tuple(dst[path].shape) == leaf.shape, path
        np.testing.assert_array_equal(dst[path].float().numpy(), np.asarray(leaf, np.float32))


def test_film_param_spec_matches_jax_at_flagship_aloha():
    """Shapes only: the FiLM projectors (L, 4096, width) of both backbones."""
    flagship = OpenVLAConfig(vision_backbone_id="dinosiglip-vit-so-224px",
                             llm_backbone_id="llama2-7b-pure", num_images_in_input=3,
                             use_film=True)
    shapes = jax.eval_shape(lambda: init_openvla_params(
        jax.random.PRNGKey(0), flagship, ALOHA, head="l1", dtype=jnp.bfloat16,
        with_lm_head=False, head_dtype=jnp.bfloat16))
    ref = {p: tuple(s.shape) for p, s in _flatten(shapes).items()}
    got = {p: tuple(i.shape) for p, i in _flatten(param_spec(port_config(flagship),
                                                              P_ALOHA)).items()}
    assert got == ref
    assert got[("film", "fused_featurizer", "scale", "kernel")] == (27, 4096, 1152)


def test_init_params_draws_film_in_head_dtype():
    from openvla_oft_tpu_torch.bridge import init_params

    params = init_params(P_ALOHA_CFG, P_ALOHA, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, head_dtype=torch.float32)
    assert params["film"]["featurizer"]["scale"]["kernel"].dtype == torch.float32
    assert params["vision_backbone"]["featurizer"]["patch_embed"]["kernel"].dtype == \
        torch.bfloat16
    k = params["film"]["featurizer"]["shift"]["kernel"]
    assert abs(k.std().item() * P_ALOHA_CFG.llm_dim ** 0.5 - 1) < 0.2
    assert torch.all(params["film"]["featurizer"]["shift"]["bias"] == 0)


def test_aloha_observation_frames_in_camera_order():
    from openvla_oft_tpu_torch.serving.deploy import observation_frames

    obs = {"instruction": "fold the towel", "full_image": np.zeros((224, 224, 3), np.uint8),
           "left_wrist_image": np.ones((224, 224, 3), np.uint8),
           "right_wrist_image": np.full((224, 224, 3), 2, np.uint8),
           "state": np.zeros(14, np.float32)}
    frames = observation_frames(obs, 3)
    assert frames.shape == (3, 224, 224, 3) and frames.dtype == np.uint8
    assert list(frames[:, 0, 0, 0]) == [0, 1, 2]


def test_flagship_policy_names_its_deployments():
    from openvla_oft_tpu_torch.serving.deploy import DEPLOYMENTS, flagship_policy

    assert DEPLOYMENTS["aloha"] == ("aloha", 3, True)
    with pytest.raises(ValueError, match="platform"):
        flagship_policy("cpu", platform="bridge")


def test_film_in_training_still_raises(rng):
    params = params_from_numpy(init_openvla_params(jax.random.PRNGKey(0), ALOHA_CFG, LIBERO,
                                                   dtype=jnp.float32, head="l1"))
    z = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="item 14"):
        prismatic_forward(params, P_ALOHA_CFG, port_platform(LIBERO), z, z, torch.zeros(1), z)
