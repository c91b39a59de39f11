"""The port's deploy CLI and HTTP server: the warm-up before the server
binds (`--no-warmup` turns it off), FastAPI's /act route, and the platform
error of the fine-tuning CLI.

A tiny port policy on the CPU; nothing binds a port except the FastAPI round
trip, which needs FastAPI and uvicorn and skips where they are missing.
"""

import socket

import numpy as np
import pytest
import torch

import openvla_oft_tpu_torch.config as C
from openvla_oft_tpu_torch.bridge import init_params
from openvla_oft_tpu_torch.constants import ALOHA, LIBERO
from openvla_oft_tpu_torch.policy import OpenVLAPolicy
from openvla_oft_tpu_torch.serving import deploy
from openvla_oft_tpu_torch.serving.server import ActionServer, get_action_from_server
from openvla_oft_tpu_torch.training import finetune as FT

C._VISION_REGISTRY.setdefault("tiny-dual", (C.TINY_DINOV2, C.TINY_SIGLIP))
C._LLM_REGISTRY.setdefault("tiny-llama", C.TINY_LLAMA)


def _tiny_policy(platform=LIBERO, n_images=2):
    cfg = C.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                          num_images_in_input=n_images)
    params = init_params(cfg, platform, torch.Generator().manual_seed(0), dtype=torch.float32)
    return OpenVLAPolicy(cfg=cfg, platform=platform, params=params,
                         norm_stats=deploy.placeholder_norm_stats(platform), prompt_bucket=16)


class _Counted:
    """Wraps a policy's predict_action_from_frames and records each call's frames."""

    def __init__(self, policy):
        self.calls = []
        inner = policy.predict_action_from_frames

        def predict(frames, instruction, **kw):
            self.calls.append((frames.shape, kw.get("proprio")))
            return inner(frames, instruction, **kw)

        policy.predict_action_from_frames = predict


def _cli_run(monkeypatch, argv):
    """deploy.main on a tiny policy, with ActionServer.run recording how many
    predicts ran before it would bind."""
    policy = _tiny_policy()
    counted = _Counted(policy)
    monkeypatch.setattr(deploy, "flagship_policy", lambda *a, **kw: policy)
    bound = []
    monkeypatch.setattr(ActionServer, "run",
                        lambda self, host, port, background=False:
                        bound.append((host, port, len(counted.calls))))
    deploy.main(["--random-weights", "--device", "cpu", "--port", "8123"] + argv)
    return counted.calls, bound


def test_deploy_cli_warms_up_once_before_binding(monkeypatch, capsys):
    calls, bound = _cli_run(monkeypatch, [])
    assert bound == [("0.0.0.0", 8123, 1)]
    # The synthetic observation has the policy's geometry: 2 LIBERO frames of
    # 256 x 256 and an 8-dim proprio state.
    (shape, proprio), = calls
    assert shape == (2, 256, 256, 3) and proprio.shape == (LIBERO.proprio_dim,)
    assert "[deploy] warmup run:" in capsys.readouterr().out


def test_deploy_cli_no_warmup_binds_at_once(monkeypatch, capsys):
    calls, bound = _cli_run(monkeypatch, ["--no-warmup"])
    assert calls == [] and bound == [("0.0.0.0", 8123, 0)]
    assert "warmup" not in capsys.readouterr().out


@pytest.mark.parametrize("platform,n_images,hw", [(LIBERO, 2, 256), (ALOHA, 3, 224)],
                         ids=["libero", "aloha"])
def test_warmup_uses_the_deployment_geometry(platform, n_images, hw):
    policy = _tiny_policy(platform, n_images)
    obs = deploy.synthetic_observation(policy)
    frames = deploy.observation_frames(obs, n_images)
    assert frames.shape == (n_images, hw, hw, 3)
    assert obs["state"].shape == (platform.proprio_dim,)
    counted = _Counted(policy)
    server = deploy.build_server(policy)
    assert counted.calls == []                       # building the server runs nothing
    assert deploy.warmup(server, policy) > 0 and len(counted.calls) == 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fastapi_act_route_answers_200():
    """ActionServer.run prefers FastAPI; its /act answers 200 with the same
    chunk as the stdlib server (it answered 422 while the file postponed
    annotations)."""
    pytest.importorskip("fastapi")
    pytest.importorskip("uvicorn")
    import urllib.request

    from openvla_oft_tpu_torch.serving import json_numpy

    chunk = np.arange(56, dtype=np.float32).reshape(8, 7) / 7.0

    def predict(observation, instruction):
        return chunk * observation["state"].sum()

    obs = {"full_image": np.zeros((4, 4, 3), np.uint8), "state": np.ones(8, np.float32),
           "instruction": "pick"}
    answers = {}
    for name in ("fastapi", "stdlib"):
        server, port = ActionServer(predict), _free_port()
        if name == "fastapi":
            server.run("127.0.0.1", port, background=True)
            assert getattr(server, "_uvicorn", None) is not None
        else:
            server._run_stdlib("127.0.0.1", port, background=True)
        try:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/act",
                                         data=json_numpy.dumps(obs).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as resp:
                assert resp.status == 200
                answers[name] = json_numpy.loads(resp.read().decode())
            np.testing.assert_array_equal(
                get_action_from_server(obs, f"http://127.0.0.1:{port}/act"), answers[name])
        finally:
            server.shutdown()
    np.testing.assert_array_equal(answers["fastapi"], answers["stdlib"])
    np.testing.assert_array_equal(answers["fastapi"], chunk * 8)


@pytest.mark.parametrize("platform", ["aloha", "bridge"])
def test_unported_training_platform_names_item_14(platform):
    with pytest.raises(NotImplementedError, match=r"queue 1, item 14\)"):
        FT.platform_of(FT.FinetuneConfig(robot_platform=platform))
    assert FT.platform_of(FT.FinetuneConfig(robot_platform="libero")) == LIBERO
