"""Port parity for the serving path: device preprocessing, the prefill
(`predict_action_hidden`, its golden) and the whole `serve_action_chunk`,
against the JAX package on the CPU in fp32."""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvla_oft_tpu.config as C
from openvla_oft_tpu.config import OpenVLAConfig, TINY_DINOV2, TINY_LLAMA, TINY_SIGLIP
from openvla_oft_tpu.constants import EMPTY_TOKEN_ID, LIBERO
from openvla_oft_tpu.models.prismatic import predict_action_hidden as jax_predict
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.policy import serve_action_chunk as jax_serve
from openvla_oft_tpu.processing import image_processing as JI
from openvla_oft_tpu_torch.bridge import params_from_numpy
from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden
from openvla_oft_tpu_torch.policy import serve_action_chunk
from openvla_oft_tpu_torch.processing import image_processing as TI
from test_torch_import import port_config, port_platform

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

C._VISION_REGISTRY.setdefault("tiny-dual", (TINY_DINOV2, TINY_SIGLIP))
C._LLM_REGISTRY.setdefault("tiny-llama", TINY_LLAMA)
CFG = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama")
P_CFG, P_LIBERO = port_config(CFG), port_platform(LIBERO)     # the port's side
GOLDEN = Path(__file__).parent / "goldens" / "predict_action_hidden.npz"


@pytest.mark.parametrize("n", [28, 40, 224, 256])
def test_linspace_matches_jnp_fp32(n):
    """The crop coordinates feed floor(); they must equal jnp.linspace's
    fp32 values exactly, since one ulp can flip a pixel."""
    sqrt_s = float(np.sqrt(0.9))
    y1 = (1.0 - sqrt_s) / 2.0
    ref = np.asarray(jnp.linspace(y1 * (n - 1), (y1 + sqrt_s) * (n - 1), n))
    np.testing.assert_array_equal(TI._linspace_f32(y1 * (n - 1), (y1 + sqrt_s) * (n - 1), n),
                                  ref)


def test_device_preprocess_matches_jax(rng):
    """uint8 frames 40x40 -> 28: the lanczos3 resize + round, the 0.9 center
    crop with its floor(v + v/510) rule, and the normalized output. uint8
    stages must be equal but for at most 0.1% of pixels off by one LSB."""
    frames = (rng.random((3, 40, 40, 3)) * 255).astype(np.uint8)
    size = TINY_DINOV2.image_size
    ref_resized = np.asarray(jnp.clip(jnp.round(jax.image.resize(
        jnp.asarray(frames, jnp.float32), (3, size, size, 3), method="lanczos3",
        antialias=True)), 0, 255)).astype(np.uint8)
    got_resized = TI.resize_lanczos3(torch.from_numpy(frames).float(), size)
    got_resized = torch.clamp(torch.round(got_resized), 0, 255).to(torch.uint8).numpy()
    ref_crop = np.asarray(JI.center_crop_resize(jnp.asarray(ref_resized), 0.9,
                                                batched=True))
    got_crop = TI.center_crop_resize(torch.from_numpy(ref_resized), 0.9).numpy()
    for name, got, ref in (("resize", got_resized, ref_resized),
                           ("crop", got_crop, ref_crop)):
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        n_off = int((diff > 0).sum())
        print(f"{name}: {n_off} of {diff.size} uint8 values off by one LSB")
        assert diff.max() <= 1 and n_off <= 1e-3 * diff.size, name

    ref = np.asarray(JI.device_preprocess(CFG, jnp.asarray(frames), resize_size=size))
    got = TI.device_preprocess(P_CFG, torch.from_numpy(frames), resize_size=size).numpy()
    assert got.shape == ref.shape == (3, 2, size, size, 3)
    lsb = 1.0 / 255.0 / min(min(v.std) for v in CFG.vision_configs)
    off = np.abs(got - ref) > 1e-5
    assert np.abs(got - ref).max() <= lsb + 1e-5 and off.mean() <= 1e-3


def test_predict_action_hidden_golden():
    """tests/goldens/predict_action_hidden.npz from bridged JAX weights, built
    as tests/test_goldens.py builds it, through both attention paths."""
    params = init_openvla_params(jax.random.PRNGKey(31), CFG, LIBERO,
                                 dtype=jnp.float32, head="l1")
    h = TINY_DINOV2.image_size
    pixels = np.array(jax.random.uniform(jax.random.PRNGKey(32), (1, 1, 2, h, h, 3)))
    ids = np.zeros((1, 12), np.int32)
    ids[0, 3] = 1
    ids[0, 4:11] = [100, 200, 300, 400, 500, 600, 700]
    ids[0, 11] = EMPTY_TOKEN_ID
    mask = np.zeros((1, 12), np.int32)
    mask[0, 3:] = 1
    proprio = np.array(jax.random.uniform(jax.random.PRNGKey(33), (1, LIBERO.proprio_dim)))
    tp = params_from_numpy(params)
    golden = np.load(GOLDEN)["value"]
    for use_flash in ("auto", True, False):
        out = predict_action_hidden(tp, P_CFG, P_LIBERO, torch.from_numpy(ids),
                                    torch.from_numpy(mask), torch.from_numpy(pixels),
                                    proprio=torch.from_numpy(proprio),
                                    use_flash=use_flash)
        np.testing.assert_allclose(out.actions_hidden[:, :4, :8].numpy(), golden,
                                   atol=2e-5, rtol=1e-4, err_msg=str(use_flash))


def _serve_inputs(rng):
    """The inputs of tests/test_serve_fused.py."""
    size = TINY_DINOV2.image_size
    frames = (rng.random((1, 1, size + 12, size + 12, 3)) * 255).astype(np.uint8)
    proprio = rng.random((1, LIBERO.proprio_dim)).astype(np.float32) * 3 - 1
    bucket = 16
    ids = np.zeros((1, bucket), np.int32)
    mask = np.zeros((1, bucket), np.int32)
    real = [1] + list(rng.integers(10, 1000, 8)) + [29871]
    ids[0, bucket - len(real):] = real
    mask[0, bucket - len(real):] = 1
    return dict(
        frames_u8=frames, input_ids=ids, prompt_mask=mask, proprio=proprio,
        action_low=np.linspace(-0.9, -0.2, LIBERO.action_dim).astype(np.float32),
        action_high=np.linspace(0.2, 0.9, LIBERO.action_dim).astype(np.float32),
        action_mask=np.asarray([True] * (LIBERO.action_dim - 1) + [False]),
        proprio_low=np.full((LIBERO.proprio_dim,), -1.5, np.float32),
        proprio_high=np.full((LIBERO.proprio_dim,), 2.5, np.float32))


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
def test_serve_action_chunk_matches_jax(rng, use_flash):
    params = init_openvla_params(jax.random.PRNGKey(0), CFG, LIBERO,
                                 dtype=jnp.float32, head="l1")
    inputs = _serve_inputs(rng)
    size = TINY_DINOV2.image_size
    ref = np.asarray(jax_serve(params, CFG, LIBERO,
                               **{k: jnp.asarray(v) for k, v in inputs.items()},
                               use_flash=use_flash, resize_size=size))
    got = serve_action_chunk(params_from_numpy(params), P_CFG, P_LIBERO,
                             **{k: torch.from_numpy(v) for k, v in inputs.items()},
                             use_flash=use_flash, resize_size=size).numpy()
    assert got.shape == (1, LIBERO.num_actions_chunk, LIBERO.action_dim)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_predict_action_hidden_matches_jax_with_batch_padding(rng):
    """Two rows with different prompt lengths (per-row gather, per-row RoPE
    positions and key padding), K1 path against the JAX prefill."""
    cfg = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                        num_images_in_input=2)
    params = init_openvla_params(jax.random.PRNGKey(5), cfg, LIBERO,
                                 dtype=jnp.float32, head="l1")
    h = TINY_DINOV2.image_size
    pixels = rng.random((2, 2, 2, h, h, 3)).astype(np.float32)
    ids = np.zeros((2, 16), np.int32)
    mask = np.zeros((2, 16), np.int32)
    for r, n in enumerate((10, 16)):
        ids[r, 16 - n:] = [1] + list(rng.integers(10, 1000, n - 2)) + [29871]
        mask[r, 16 - n:] = 1
    proprio = rng.random((2, LIBERO.proprio_dim)).astype(np.float32)
    ref = jax_predict(params, cfg, LIBERO, input_ids=jnp.asarray(ids),
                      prompt_mask=jnp.asarray(mask), pixels=jnp.asarray(pixels),
                      proprio=jnp.asarray(proprio), use_flash=True)
    got = predict_action_hidden(params_from_numpy(params), port_config(cfg), P_LIBERO,
                                torch.from_numpy(ids), torch.from_numpy(mask),
                                torch.from_numpy(pixels), torch.from_numpy(proprio),
                                use_flash=True)
    np.testing.assert_allclose(got.actions_hidden.numpy(),
                               np.asarray(ref.actions_hidden), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("instruction,bucket", [("wipe the table", 16),
                                                ("Put the BOWL on the plate", 48),
                                                ("a " * 30 + "long one", 16)])
def test_prompt_ids_match_jax(instruction, bucket):
    """The port's copies of build_prompt / FakeLlamaTokenizer /
    prepare_prompt_ids give the JAX package's ids, bucket escalation included."""
    from openvla_oft_tpu.models.prismatic import prepare_prompt_ids as jax_prepare
    from openvla_oft_tpu.processing.processor import FakeLlamaTokenizer as JaxTok
    from openvla_oft_tpu_torch.models.prismatic import prepare_prompt_ids
    from openvla_oft_tpu_torch.processing.processor import FakeLlamaTokenizer

    ref = jax_prepare(JaxTok(), instruction, bucket)
    got = prepare_prompt_ids(FakeLlamaTokenizer(), instruction, bucket)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("norm_type", ["bounds", "bounds_q99"])
def test_unnormalize_actions_matches_jax(rng, norm_type):
    from openvla_oft_tpu.constants import NormalizationType
    from openvla_oft_tpu.models.prismatic import unnormalize_actions as jax_unnorm
    from openvla_oft_tpu_torch.constants import NormalizationType as PortNormalizationType
    from openvla_oft_tpu_torch.models.prismatic import unnormalize_actions

    d = LIBERO.action_dim
    stats = {"min": -rng.random(d), "max": rng.random(d), "q01": -rng.random(d) / 2,
             "q99": rng.random(d) / 2, "mask": [True] * (d - 1) + [False]}
    x = rng.uniform(-1, 1, (8, d))
    np.testing.assert_array_equal(
        unnormalize_actions(x, stats, PortNormalizationType(norm_type)),
        jax_unnorm(x, stats, NormalizationType(norm_type)))
