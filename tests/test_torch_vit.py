"""Port parity for the ViT featurizers, the vision backbone and the projector.

Weights come from the JAX init and go through the param bridge; inputs are
numpy. fp32 on the CPU, atol 1e-5 (27-block-deep reassociation of fp32 sums
stays well inside it at the tiny widths).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvla_oft_tpu.config as C
from openvla_oft_tpu.config import OpenVLAConfig, TINY_DINOV2, TINY_LLAMA, TINY_SIGLIP
from openvla_oft_tpu.models import projector as JP
from openvla_oft_tpu.models import vision_backbone as JB
from openvla_oft_tpu.models import vit as JV
from openvla_oft_tpu_torch.bridge import params_from_numpy
from openvla_oft_tpu_torch.models import projector as TP
from openvla_oft_tpu_torch.models import vision_backbone as TB
from openvla_oft_tpu_torch.models import vit as TV
from test_torch_import import port_arch, port_config

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

C._VISION_REGISTRY.setdefault("tiny-dual", (TINY_DINOV2, TINY_SIGLIP))
C._LLM_REGISTRY.setdefault("tiny-llama", TINY_LLAMA)
GOLDEN = Path(__file__).parent / "goldens" / "dinov2_tap_features.npz"
TOL = dict(rtol=1e-5, atol=1e-5)


def _perturb_norms(params, rng):
    """Non-trivial LayerNorm affines and LayerScales, so the folds matter."""
    layers = dict(params["layers"])
    for name in ("norm1", "norm2"):
        layers[name] = {k: jnp.asarray(rng.standard_normal(v.shape) * 0.3
                                       + (1.0 if k == "scale" else 0.0), jnp.float32)
                        for k, v in layers[name].items()}
    for name in ("ls1", "ls2"):
        if name in layers:
            layers[name] = {"scale_factor": jnp.asarray(
                rng.random(layers[name]["scale_factor"].shape) + 0.5, jnp.float32)}
    return {**params, "layers": layers}


@pytest.mark.parametrize("vcfg", [TINY_DINOV2, TINY_SIGLIP], ids=["dinov2", "siglip"])
@pytest.mark.parametrize("fused", [False, True], ids=["raw", "fused"])
def test_vit_featurize_matches_jax(rng, vcfg, fused):
    params = _perturb_norms(JV.init_vit_params(jax.random.PRNGKey(3), vcfg,
                                               dtype=jnp.float32), rng)
    x = rng.standard_normal((2, vcfg.image_size, vcfg.image_size, 3)).astype(np.float32)
    ref = np.asarray(JV.vit_featurize(params, vcfg, jnp.asarray(x)))
    tp = params_from_numpy(params)
    if fused:
        tp = TV.fuse_vit_inference_weights(tp)
        folded = JV.fuse_vit_inference_weights(params)
        for k in ("qkv",):
            np.testing.assert_allclose(
                tp["layers"]["attn"][k]["kernel"].numpy(),
                np.asarray(folded["layers"]["attn"][k]["kernel"]), rtol=1e-6, atol=1e-6)
        assert tp["layers"]["norm1"] == {} and "ls1" not in tp["layers"]
    got = TV.vit_featurize(tp, port_arch(vcfg), torch.from_numpy(x)).numpy()
    assert got.shape == (2, vcfg.num_patches, vcfg.width)
    np.testing.assert_allclose(got, ref, **TOL)


def test_dinov2_golden():
    """tests/goldens/dinov2_tap_features.npz from the bridged JAX weights,
    built as tests/test_goldens.py builds them."""
    params = JV.init_vit_params(jax.random.PRNGKey(21), TINY_DINOV2, dtype=jnp.float32)
    x = jax.random.uniform(jax.random.PRNGKey(22),
                           (1, TINY_DINOV2.image_size, TINY_DINOV2.image_size, 3))
    out = TV.vit_featurize(params_from_numpy(params), port_arch(TINY_DINOV2),
                           torch.from_numpy(np.array(x))).numpy()
    np.testing.assert_allclose(out[:, :3, :8], np.load(GOLDEN)["value"],
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("fast_gelu", [False, True])
def test_backbone_and_projector_match_jax(rng, fast_gelu):
    cfg = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                        num_images_in_input=2, fast_gelu=fast_gelu)
    vb = JB.init_vision_backbone(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    proj = JP.init_vision_projector(jax.random.PRNGKey(2), cfg.vision_dim, 64)
    hw = TINY_DINOV2.image_size
    pixels = rng.standard_normal((1, 2, 2, hw, hw, 3)).astype(np.float32)
    ref = JP.vision_projector(proj, JB.vision_backbone_forward(vb, cfg, jnp.asarray(pixels)),
                              fast_gelu=fast_gelu)
    feats = TB.vision_backbone_forward(params_from_numpy(vb), port_config(cfg),
                                       torch.from_numpy(pixels))
    got = TP.vision_projector(params_from_numpy(proj), feats, fast_gelu=fast_gelu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_fast_gelu_swaps_only_erf_gelu_in_bf16(rng):
    """In bf16 the fast form reaches the DINOv2 MLPs: outputs move by at most
    two bf16 ulps at tensor scale, as tests/test_fast_gelu.py bounds it."""
    cfg = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama")
    vb = params_from_numpy(JB.init_vision_backbone(jax.random.PRNGKey(0), cfg,
                                                   dtype=jnp.bfloat16))
    hw = TINY_DINOV2.image_size
    pixels = torch.from_numpy(rng.standard_normal((2, 1, 2, hw, hw, 3))).bfloat16()
    cfg = port_config(cfg)
    exact = TB.vision_backbone_forward(vb, cfg, pixels).float()
    fast = TB.vision_backbone_forward(
        vb, dataclasses.replace(cfg, fast_gelu=True), pixels).float()
    assert (exact - fast).abs().max() <= 2 * 2.0 ** -8 * exact.abs().max()
