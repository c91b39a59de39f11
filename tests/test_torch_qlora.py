"""Port parity for QLoRA: LoRA over an int8 or int4 base in `ops/layers.py::
linear`, and the training loss and gradients under a base quantized by
`quantize_tree_lowmem`, against the JAX package on the CPU.

The same numpy weights and inputs go to both sides. For the linear the JAX
side runs op by op (`jax.disable_jit`), as tests/test_torch_int8.py runs
it, and its int4 kernel K5 in Pallas interpret mode at at most
FUSED_MAX_ROWS rows (its XLA dequant path above); the port's wrappers take
their plain versions on CPU tensors. Tolerances:
- the linear in fp32 (y and the gradients of x, lora_a and lora_b): rtol
  1e-5 with atol 1e-5 * max|ref| (the same fp32 products summed in another
  order; the int8 codes are equal);
- the tiny training loss: 2e-4 relative, each gradient leaf within 1e-2 of
  its largest entry with a cosine >= 0.9999 (test_torch_train_step.py's
  bounds: the bf16 rounding of the head's input flips a few ulps, and
  under `jit` JAX's activation quantize multiplies by 1/127 where the port
  divides, which moves a few int8 codes by one).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.ops import int4_matmul as JM
from openvla_oft_tpu.ops import layers as JL
from openvla_oft_tpu.ops import quant as JQ
from openvla_oft_tpu.training import train_step as JT
from openvla_oft_tpu_torch.bridge import params_from_numpy, tree_leaves
from openvla_oft_tpu_torch.ops import int4_matmul as M
from openvla_oft_tpu_torch.ops import layers as TL
from openvla_oft_tpu_torch.ops import quant as Q
from openvla_oft_tpu_torch.training import train_step as TT
from test_torch_train_step import (CFG, NP_BASE, NP_BATCH, NP_TRAIN, P_CFG, P_LIBERO,
                                   _cos, _flat, _jax_cfg, _port_cfg)

torch.backends.cuda.matmul.allow_tf32 = False

FP32 = 1e-5


def _close(got, ref, rtol=FP32):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _quantized(w: np.ndarray, bits: int):
    """(JAX dict, port dict) of the same weight quantized on each side."""
    if bits == 8:
        return JQ.quantize_weight(jnp.asarray(w)), Q.quantize_weight(torch.from_numpy(w))
    return JQ.quantize_weight_int4(jnp.asarray(w)), Q.quantize_weight_int4(torch.from_numpy(w))


@pytest.mark.parametrize("bits,rows", [(8, 40), (4, 40), (4, 1100)],
                         ids=["int8", "int4-K5", "int4-dequant"])
def test_qlora_linear_matches_jax(rng, monkeypatch, bits, rows):
    """y and the gradients of x, lora_a and lora_b of `linear` over a
    quantized base with a bias and LoRA; int4 on both sides of
    FUSED_MAX_ROWS (the port's K5 wrapper on the CPU, or the dequant path)."""
    k, n, r = 256, 96, 4
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((2, rows // 2, k)).astype(np.float32)
    g = rng.standard_normal((2, rows // 2, n)).astype(np.float32)
    a = (rng.standard_normal((r, k)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((r, n)) * 0.05).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    jq, tq = _quantized(w, bits)

    def jax_loss(xx, aa, bb):
        y = JL.linear({**jq, "bias": jnp.asarray(bias), "lora_a": aa, "lora_b": bb}, xx)
        return jnp.sum(y * jnp.asarray(g)), y

    with jax.disable_jit():
        (_, y_ref), grads_ref = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    calls = []
    for name in ("int4_matmul_fused", "int4_matmul_ref"):
        fn = getattr(M, name)
        monkeypatch.setattr(M, name, lambda *args, _fn=fn, _name=name:
                            calls.append(_name) or _fn(*args))
    before = Q.int8_mm.launches
    xt, at, bt = (torch.from_numpy(v).requires_grad_() for v in (x, a, b))
    y = TL.linear({**tq, "bias": torch.from_numpy(bias), "lora_a": at, "lora_b": bt}, xt)
    (y * torch.from_numpy(g)).sum().backward()
    if bits == 8:
        assert Q.int8_mm.launches == before + 1 and not calls
    else:
        # (on the CPU the K5 wrapper calls its plain version in turn)
        assert calls[0] == ("int4_matmul_fused" if rows <= Q.FUSED_MAX_ROWS
                            else "int4_matmul_ref")
    _close(y.detach(), y_ref)
    for got, ref in zip((xt.grad, at.grad, bt.grad), grads_ref):
        _close(got, ref)


def test_lora_with_zero_b_leaves_the_quantized_product(rng):
    """A zero B adds nothing: the QLoRA linear gives its base's product bit
    for bit (int8 and int4 alike)."""
    w = (rng.standard_normal((64, 24)) * 0.05).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    for bits in (8, 4):
        q = _quantized(w, bits)[1]
        lora = {**q, "lora_a": torch.ones(2, 64), "lora_b": torch.zeros(2, 24)}
        assert torch.equal(TL.linear(lora, x), TL.linear(q, x))


@pytest.mark.parametrize("bits", [8, 4])
def test_loss_and_grads_under_a_quantized_base_match_jax(monkeypatch, bits):
    """`loss_and_metrics` with every base kernel quantized (min_dim 1, as the
    JAX CLI's QLoRA tests run it) and LoRA drawn on the float base: the
    loss and every trainable's gradient against the JAX step. For int4 both
    sides take the dequant path everywhere: at these widths the JAX stacked
    kernel cannot tile the layers and takes it there anyway, and the K5
    wrapper's gradient is held against the JAX kernel's above."""
    if bits == 4:
        monkeypatch.setattr(JM, "int4_matmul_fused", JQ._int4_matmul_xla)
        monkeypatch.setattr(Q, "FUSED_MAX_ROWS", 0)
    jbase = {k: JQ.quantize_tree_lowmem(jax.tree_util.tree_map(jnp.asarray, v), min_dim=1,
                                        bits=bits) for k, v in NP_BASE.items()}
    (loss_j, _), grads_j = jax.value_and_grad(JT.loss_and_metrics, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, NP_TRAIN), jbase,
        {k: jnp.asarray(v) for k, v in NP_BATCH.items()}, CFG, LIBERO,
        _jax_cfg(remat_policy="none"), jax.random.PRNGKey(0), False)
    base = {k: Q.quantize_tree_lowmem(v, min_dim=1, bits=bits)
            for k, v in params_from_numpy(NP_BASE).items()}
    n_quantized = sum(1 for t in tree_leaves(base) if t.dtype == torch.int8)
    assert n_quantized == len([x for x in jax.tree_util.tree_leaves(jbase)
                               if x.dtype == jnp.int8])
    trainables = params_from_numpy(NP_TRAIN)
    leaves = tree_leaves(trainables)
    for t in leaves:
        t.requires_grad_(True)
    loss_t, _ = TT.loss_and_metrics(trainables, base, {k: torch.from_numpy(v.copy())
                                                        for k, v in NP_BATCH.items()},
                                    P_CFG, P_LIBERO, _port_cfg(), use_flash=False)
    grads_t = torch.autograd.grad(loss_t, leaves)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-4)
    for gj, gt in zip(_flat(grads_j), grads_t):
        gt = gt.double().numpy()
        scale = np.abs(gj).max()
        assert gj.shape == gt.shape and scale > 0
        assert np.abs(gt - gj).max() <= 1e-2 * scale
        assert _cos(gt, gj) >= 0.9999
