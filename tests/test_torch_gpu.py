"""Tests of the port that need the card: kernel K1 against its plain version,
and the tiny serving path through K1 against the dense path, on CUDA.

This file imports no JAX (the machine with the card has none), so it runs
there on its own:  python -m pytest tests/test_torch_gpu.py -q
Every test is marked `gpu` and skips where torch sees no CUDA device.
"""

import numpy as np
import pytest
import torch

from openvla_oft_tpu_torch.ops import flash_attention as fa
from openvla_oft_tpu_torch.ops.attention import attention

torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions in full fp32
torch.backends.cudnn.allow_tf32 = False

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _strided_qkv(gen, b, s, h, hkv, d, device):
    """q/k/v as views of one fused projection output, as the Llama path has them."""
    qkv = torch.randn((b, s, (h + 2 * hkv) * d), generator=gen, device=device,
                      dtype=torch.float32).bfloat16()
    return (qkv[..., :h * d].view(b, s, h, d),
            qkv[..., h * d:(h + hkv) * d].view(b, s, hkv, d),
            qkv[..., (h + hkv) * d:].view(b, s, hkv, d))


# (b, s, h, hkv, d, left pads, window (start, len) or None, causal)
CASES = [
    (1, 618, 32, 32, 128, 24, (561, 57), True),     # LIBERO prefill
    (1, 1168, 8, 8, 128, 24, (817, 351), True),     # ALOHA length
    (2, 618, 32, 8, 128, 24, (561, 57), True),      # GQA, batch 2
    (1, 300, 4, 2, 64, 100, (200, 90), True),       # dead rows, an all-pad key tile
    (1, 130, 4, 4, 64, 0, (20, 100), True),         # window past a tile's diagonal
    (1, 77, 4, 4, 128, 5, None, False),             # non-causal, ragged tile
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"s{c[1]}h{c[2]}kv{c[3]}d{c[4]}")
def test_kernel_matches_plain(cuda, case):
    b, s, h, hkv, d, pads, window, causal = case
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = _strided_qkv(gen, b, s, h, hkv, d, cuda)
    key_valid = torch.ones((b, s), dtype=torch.bool, device=cuda)
    key_valid[:, :pads] = False
    bidir = torch.zeros((b, s), dtype=torch.bool, device=cuda)
    if window is not None:
        bidir[:, window[0]:window[0] + window[1]] = True
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal, key_valid, bidir)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal, key_valid, bidir)
    # Live rows: the query has at least one allowed key.
    live = key_valid[0].clone()
    if not causal:
        live[:] = True
    err = (o.float() - o_ref.float())[:, live].abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3
    assert (lse - lse_ref)[..., live].abs().max().item() <= 1e-2
    assert torch.all(o[:, ~live] == 0)
    assert torch.isfinite(o).all()


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 64, 2, 128), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(q, q, q)
    qb = torch.zeros((1, 64, 2, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(qb, qb, qb)


def test_attention_auto_takes_the_kernel_on_cuda(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _strided_qkv(gen, 1, 96, 4, 4, 128, cuda)
    before = fa.flash_attention.launches
    out = attention(q, k, v, is_causal=True, use_flash="auto", bidir_block=(60, 30))
    dense = attention(q, k, v, is_causal=True, use_flash=False, bidir_block=(60, 30))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert (out.float() - dense.float()).abs().max().item() <= 2e-2


def test_tiny_serving_path_flash_matches_dense(cuda):
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy
    from openvla_oft_tpu_torch.bridge import init_params
    import openvla_oft_tpu.config as C
    from openvla_oft_tpu.constants import LIBERO

    llm = C.LlamaConfig(vocab_size=32064, hidden_size=256, intermediate_size=512,
                        num_layers=3, num_heads=2, num_kv_heads=2)
    C._LLM_REGISTRY.setdefault("gpu-test-llama", llm)
    C._VISION_REGISTRY.setdefault("tiny-dual", (C.TINY_DINOV2, C.TINY_SIGLIP))
    cfg = C.OpenVLAConfig(vision_backbone_id="tiny-dual",
                          llm_backbone_id="gpu-test-llama", num_images_in_input=2)
    params = init_params(cfg, LIBERO, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    frames = (rng.random((2, 40, 40, 3)) * 255).astype(np.uint8)
    out = {}
    for use_flash in (True, False):
        pol = OpenVLAPolicy(cfg=cfg, platform=LIBERO, params=params,
                            norm_stats=placeholder_norm_stats(LIBERO),
                            prompt_bucket=32, use_flash=use_flash)
        before = fa.flash_attention.launches
        out[use_flash] = pol.predict_action_from_frames(frames, "open the drawer")
        assert fa.flash_attention.launches - before == (2 if use_flash else 0)
    assert out[True].shape == (LIBERO.num_actions_chunk, LIBERO.action_dim)
    assert np.abs(out[True] - out[False]).max() < 0.1
