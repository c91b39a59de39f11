"""A tiny port policy behind the repo's ActionServer answers /act requests
(json-numpy wire format) with exactly what the policy computes directly."""

import socket

import numpy as np
import torch
import jax
import jax.numpy as jnp

import openvla_oft_tpu.config as C
from openvla_oft_tpu.config import OpenVLAConfig, TINY_DINOV2, TINY_LLAMA, TINY_SIGLIP
from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.serving.server import get_action_from_server
from openvla_oft_tpu_torch.bridge import params_from_numpy
from openvla_oft_tpu_torch.policy import OpenVLAPolicy
from openvla_oft_tpu_torch.serving.deploy import build_server, placeholder_norm_stats
from test_torch_import import port_config, port_platform

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

C._VISION_REGISTRY.setdefault("tiny-dual", (TINY_DINOV2, TINY_SIGLIP))
C._LLM_REGISTRY.setdefault("tiny-llama", TINY_LLAMA)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_action_server_answers_act_requests(rng):
    cfg = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                        num_images_in_input=2)
    params = params_from_numpy(init_openvla_params(
        jax.random.PRNGKey(0), cfg, LIBERO, dtype=jnp.float32, head="l1"))
    platform = port_platform(LIBERO)
    policy = OpenVLAPolicy(cfg=port_config(cfg), platform=platform, params=params,
                           norm_stats=placeholder_norm_stats(platform), prompt_bucket=16)
    server = build_server(policy)
    port = _free_port()
    server.run("127.0.0.1", port, background=True)
    try:
        for i in range(2):
            obs = {"full_image": (rng.random((36, 36, 3)) * 255).astype(np.uint8),
                   "wrist_image": (rng.random((36, 36, 3)) * 255).astype(np.uint8),
                   "state": rng.standard_normal(LIBERO.proprio_dim).astype(np.float32),
                   "instruction": f"pick up the block {i}"}
            got = get_action_from_server(obs, f"http://127.0.0.1:{port}/act")
            direct = policy.predict_action_from_frames(
                np.stack([obs["full_image"], obs["wrist_image"]]), obs["instruction"],
                proprio=obs["state"])
            assert isinstance(got, np.ndarray), got
            assert got.shape == (LIBERO.num_actions_chunk, LIBERO.action_dim)
            assert np.all(np.isfinite(got))
            np.testing.assert_array_equal(got, direct)
    finally:
        server.shutdown()
