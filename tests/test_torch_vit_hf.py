"""The port's ViT featurizer against HF transformers vision models (ROADMAP item 20).

Mirrors `tests/test_vit_parity.py` on the port's `models/vit.py::
vit_featurize`: random tiny HF `SiglipVisionModel`,
`Dinov2WithRegistersModel` and `CLIPVisionModel`, built from configs (nothing
is downloaded), get the JAX init's weights through that test's mapping, and
the port (the same weights through `bridge.py::params_from_numpy`) must
agree with them at the second-to-last-layer tap: 3e-5 for SigLIP and
DINOv2, 1e-4 for CLIP's quick-GELU (the JAX test's bounds). The JAX side
is held to the same HF outputs, so the three agree.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

pytest.importorskip("transformers")

from openvla_oft_tpu.config import ViTConfig  # noqa: E402
from openvla_oft_tpu.models.vit import init_vit_params  # noqa: E402
from openvla_oft_tpu.models.vit import vit_featurize as jax_featurize  # noqa: E402
from openvla_oft_tpu_torch.bridge import params_from_numpy  # noqa: E402
from openvla_oft_tpu_torch.models.vit import vit_featurize  # noqa: E402
from test_torch_import import port_arch  # noqa: E402
from test_vit_parity import (TINY_DINO, TINY_SIGLIP, _copy_block, _np32, _set,  # noqa: E402
                             _unpatchify_kernel)

TINY_CLIP = ViTConfig(width=32, depth=4, num_heads=4, mlp_dim=64, patch_size=8, image_size=32,
                      num_cls_tokens=1, use_pre_norm=True, act="quick_gelu")


def _port(params, cfg, x):
    with torch.no_grad():
        return vit_featurize(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)),
                             port_arch(cfg), torch.from_numpy(x)).numpy()


def _hf(model, x):
    with torch.no_grad():
        return model(pixel_values=torch.from_numpy(x.transpose(0, 3, 1, 2)),
                     output_hidden_states=True).hidden_states


def test_siglip_against_hf(rng):
    from transformers import SiglipVisionConfig, SiglipVisionModel

    cfg = TINY_SIGLIP
    params = init_vit_params(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    model = SiglipVisionModel(SiglipVisionConfig(
        hidden_size=cfg.width, intermediate_size=cfg.mlp_dim, num_hidden_layers=cfg.depth,
        num_attention_heads=cfg.num_heads, image_size=cfg.image_size,
        patch_size=cfg.patch_size, hidden_act="gelu_pytorch_tanh",
        attn_implementation="eager")).eval()
    vm = model.vision_model
    _set(vm.embeddings.patch_embedding.weight,
         _unpatchify_kernel(_np32(params["patch_embed"]["kernel"]), cfg.patch_size))
    _set(vm.embeddings.patch_embedding.bias, _np32(params["patch_embed"]["bias"]))
    _set(vm.embeddings.position_embedding.weight, _np32(params["pos_embed"]))
    for i, layer in enumerate(vm.encoder.layers):
        _copy_block(layer, params["layers"], i, cfg.width, siglip=True)

    x = rng.standard_normal((2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    theirs = _hf(model, x)[cfg.depth - 1].numpy()
    np.testing.assert_allclose(_port(params, cfg, x), theirs, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(np.asarray(jax_featurize(params, cfg, jnp.asarray(x))), theirs,
                               rtol=3e-5, atol=3e-5)


def test_dinov2_reg4_against_hf(rng):
    from transformers import Dinov2WithRegistersConfig, Dinov2WithRegistersModel

    cfg = TINY_DINO
    key = jax.random.PRNGKey(2)
    params = init_vit_params(key, cfg, dtype=jnp.float32)
    params["cls_token"] = 0.1 * jax.random.normal(key, params["cls_token"].shape)
    params["reg_token"] = 0.1 * jax.random.normal(key, params["reg_token"].shape)
    model = Dinov2WithRegistersModel(Dinov2WithRegistersConfig(
        hidden_size=cfg.width, num_hidden_layers=cfg.depth, num_attention_heads=cfg.num_heads,
        mlp_ratio=cfg.mlp_dim // cfg.width, image_size=cfg.image_size,
        patch_size=cfg.patch_size, num_register_tokens=cfg.num_reg_tokens,
        hidden_act="gelu", layerscale_value=1e-5, attn_implementation="eager")).eval()
    emb = model.embeddings
    _set(emb.patch_embeddings.projection.weight,
         _unpatchify_kernel(_np32(params["patch_embed"]["kernel"]), cfg.patch_size))
    _set(emb.patch_embeddings.projection.bias, _np32(params["patch_embed"]["bias"]))
    _set(emb.cls_token, _np32(params["cls_token"])[None])
    _set(emb.register_tokens, _np32(params["reg_token"])[None])
    # HF's position embedding covers [cls] + patches; timm's no_embed_class none on cls
    _set(emb.position_embeddings, np.concatenate(
        [np.zeros((1, 1, cfg.width), np.float32), _np32(params["pos_embed"])[None]], axis=1))
    for i, layer in enumerate(model.encoder.layer):
        _copy_block(layer, params["layers"], i, cfg.width, layerscale=True)

    x = rng.standard_normal((2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    theirs = _hf(model, x)[cfg.depth - 1].numpy()[:, 1 + cfg.num_reg_tokens:]
    np.testing.assert_allclose(_port(params, cfg, x), theirs, rtol=3e-5, atol=3e-5)


def test_clip_against_hf(rng):
    from transformers import CLIPVisionConfig, CLIPVisionModel

    cfg = TINY_CLIP
    params = init_vit_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    params["cls_token"] = 0.1 * jax.random.normal(jax.random.PRNGKey(4),
                                                  params["cls_token"].shape)
    params["patch_embed"]["bias"] = jnp.zeros_like(params["patch_embed"]["bias"])  # no bias
    model = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=cfg.width, intermediate_size=cfg.mlp_dim, num_hidden_layers=cfg.depth,
        num_attention_heads=cfg.num_heads, image_size=cfg.image_size,
        patch_size=cfg.patch_size, hidden_act="quick_gelu",
        attn_implementation="eager")).eval()
    vm = model.vision_model
    _set(vm.embeddings.patch_embedding.weight,
         _unpatchify_kernel(_np32(params["patch_embed"]["kernel"]), cfg.patch_size))
    _set(vm.embeddings.class_embedding, _np32(params["cls_token"])[0])
    _set(vm.embeddings.position_embedding.weight, _np32(params["pos_embed"]))
    _set(vm.pre_layrnorm.weight, _np32(params["norm_pre"]["scale"]))
    _set(vm.pre_layrnorm.bias, _np32(params["norm_pre"]["bias"]))
    for i, layer in enumerate(vm.encoder.layers):
        _copy_block(layer, params["layers"], i, cfg.width, siglip=True)

    x = rng.standard_normal((2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    theirs = _hf(model, x)[cfg.depth - 1].numpy()[:, 1:]          # the cls token off
    np.testing.assert_allclose(_port(params, cfg, x), theirs, rtol=1e-4, atol=1e-4)
