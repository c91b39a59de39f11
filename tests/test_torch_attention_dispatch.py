"""Which attention path `use_flash` takes: `ops/attention.py::resolve_use_flash`.

"auto" takes kernel K1 exactly where K1 takes the call: on CUDA, in
bfloat16, with head_dim 64 or 128, the 1-D OFT mask and S == T; anything else
(the stock TINY_LLAMA's head_dim 16, Phi-2's 80, fp32, a dense mask, split
KV) goes to the dense path. True asks for K1 and False for the dense path,
whatever the shape. The decision needs no card: it is made from the shape,
dtype and device, so the CUDA rows are checked here with a `cuda` device
argument, and nothing is allocated there. The same model through "auto"
and through the dense path on the card is in `tests/test_torch_gpu.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_oft_tpu.config import TINY_LLAMA
from openvla_oft_tpu.models import llama as JL
from openvla_oft_tpu_torch.bridge import params_from_numpy
from openvla_oft_tpu_torch.models import llama as TL
from openvla_oft_tpu_torch.ops import attention as A
from test_torch_import import port_arch

B, S, H = 2, 70, 4


def _k1_takes(device: str, dtype, d: int, dense_mask: bool, s_kv: int) -> bool:
    """The rule, written out: what "auto" must decide."""
    return (device == "cuda" and dtype == torch.bfloat16 and d in (64, 128)
            and not dense_mask and s_kv == S)


@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16],
                         ids=["bf16", "fp32", "fp16"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_auto_takes_k1_only_where_k1_takes_the_call(device, dtype, d):
    for dense_mask in (False, True):
        for s_kv in (S, S + 8):
            got = A.resolve_use_flash("auto", (B, S, H, d), dtype, torch.device(device), s_kv,
                                      dense_mask=dense_mask)
            assert got == _k1_takes(device, dtype, d, dense_mask, s_kv), \
                (device, dtype, d, dense_mask, s_kv)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("d", [16, 80, 128])
def test_true_and_false_are_what_the_caller_asked(use_flash, d):
    """True is K1 even on a shape K1 refuses (the kernel then raises on the
    card); False is the dense path even where K1 would take the call. A
    dense mask is the dense path under either: K1 cannot read it."""
    for device in ("cuda", "cpu"):
        assert A.resolve_use_flash(use_flash, (B, S, H, d), torch.bfloat16, device, S) \
            is use_flash
        assert not A.resolve_use_flash(use_flash, (B, S, H, d), torch.bfloat16, device, S,
                                       dense_mask=True)


def test_the_stock_tiny_llama_is_refused_by_k1():
    """The configs the gpu tests and `--vla_path random:tiny` run: the stock
    TINY_LLAMA has head_dim 16, which K1 does not take."""
    cfg = port_arch(TINY_LLAMA)
    assert cfg.head_dim == 16
    assert not A.resolve_use_flash("auto", (1, S, cfg.num_heads, cfg.head_dim),
                                   torch.bfloat16, "cuda", S)


@pytest.mark.parametrize("use_flash,expect_k1", [("auto", False), (True, True), (False, False)])
def test_llama_model_on_the_cpu_takes_the_resolved_path(monkeypatch, use_flash, expect_k1):
    """The Llama stack resolves once from its inputs: on CPU tensors "auto"
    is the dense path (bitwise the use_flash=False result) and True is K1's
    plain version, in every layer."""
    rng = np.random.default_rng(0)
    cfg = port_arch(TINY_LLAMA)
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, JL.init_llama_params(
            jax.random.PRNGKey(7), TINY_LLAMA, dtype=jnp.float32)))
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.hidden_size)).astype(np.float32))
    pad = torch.ones((B, S), dtype=torch.bool)
    pad[0, :5] = False
    calls = []
    real = A.flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(A, "flash_attention", spy)
    run = lambda flash: TL.llama_model(params, cfg, x, padding_mask=pad, use_flash=flash,
                                       bidir_block=(50, 9))
    got = run(use_flash)
    assert len(calls) == (cfg.num_layers if expect_k1 else 0)
    if use_flash == "auto":
        assert torch.equal(got, run(False))
