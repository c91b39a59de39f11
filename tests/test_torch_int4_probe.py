"""The K5 timing probe's module (`ops/int4_probe.py`, the plain versions on
the CPU) against the JAX probe `vla_scripts/exp_int4_probe.py`.

group-dots runs through the JAX `_probe_call` with its Pallas kernel in
interpret mode (pytest's monkeypatch wraps `pallas_call`, and undoes it
after the test; nothing in the JAX package changes). XLA on the CPU refuses
the bf16 x bf16 -> f32 dots of no-scale and no-unpack in interpret mode
("Unsupported element type for DotThunk::Execute: BF16 x BF16 = F32"), so
those two are held against the kernel body's arithmetic in jnp on f32
operands: bf16 values are exact in f32, so the products are the same.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import jax.experimental.pallas

from openvla_oft_tpu.ops.quant import quantize_weight_int4 as jax_quantize_int4
from openvla_oft_tpu_torch.ops.int4_matmul import int4_matmul_ref
from openvla_oft_tpu_torch.ops.int4_probe import MODES, int4_probe, int4_probe_ref
from openvla_oft_tpu_torch.ops.quant import dequantize_int4

torch.backends.cuda.matmul.allow_tf32 = False


def _operands(rng, t=16, k=2048, n=256):
    """Two 512-row K blocks of the JAX probe's grid, so its accumulation
    across blocks runs too."""
    w = jnp.asarray(rng.normal(size=(k, n)).astype(np.float32) * 0.02)
    x = jnp.asarray(rng.normal(size=(t, k)).astype(np.float32)).astype(jnp.bfloat16)
    q4 = jax_quantize_int4(w)
    port = [torch.from_numpy(np.array(x.astype(jnp.float32))),
            torch.from_numpy(np.array(q4["kernel_q4"])),
            torch.from_numpy(np.array(q4["scale_w4"]))]
    return (x, q4["kernel_q4"], q4["scale_w4"]), port


def test_group_dots_matches_jax_probe_in_interpret_mode(rng, monkeypatch):
    from vla_scripts import exp_int4_probe as JP

    pallas = jax.experimental.pallas
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))
    (x, packed, scales), port = _operands(rng)
    ref = np.asarray(JP._probe_call(x, packed, scales, mode="group-dots"))
    got = int4_probe(*port, "group-dots")
    assert got.dtype == torch.float32 and got.shape == (16, 256)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _jax_kernel_body(x, packed, mode):
    """`_kernel_probe`'s no-scale / no-unpack arithmetic in jnp, f32 operands."""
    xe = x[:, 0::2].astype(jnp.float32)
    xo = x[:, 1::2].astype(jnp.float32)
    w = packed.astype(jnp.int32)
    if mode == "no-unpack":
        lo_f = hi_f = packed.astype(jnp.float32)
    else:
        lo_f = jnp.right_shift(jnp.left_shift(w, 28), 28).astype(jnp.float32)
        hi_f = jnp.right_shift(w, 4).astype(jnp.float32)
    dot = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
    return dot(xe, lo_f) + dot(xo, hi_f)


@pytest.mark.parametrize("mode", ["no-scale", "no-unpack"])
def test_wrong_number_modes_match_the_jax_kernel_body(rng, mode):
    (x, packed, _), port = _operands(rng)
    ref = np.asarray(_jax_kernel_body(x, packed, mode))
    got = int4_probe(*port, mode)
    # fp32 sums in another order; no-unpack's raw bytes make outputs ~3e3.
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


def test_group_dots_is_a_correct_w4a16(rng):
    """group-dots scales each group's partial instead of each weight: on bf16
    x it is x @ (nibble x scale) in exact arithmetic, which
    `int4_matmul_ref` rounds to a bf16 weight first."""
    _, (x, packed, scales) = _operands(rng)
    exact = x @ dequantize_int4(packed, scales, torch.float32)
    got = int4_probe(x, packed, scales, "group-dots")
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-5, atol=1e-5)
    k5 = int4_matmul_ref(x.bfloat16(), packed, scales)
    assert (got - k5).abs().max() <= 1e-2 * k5.abs().max()


def test_probe_rejects_what_it_does_not_take():
    x, packed, scales = torch.zeros((4, 256)), torch.zeros((128, 8), dtype=torch.int8), \
        torch.ones((2, 8))
    with pytest.raises(ValueError, match="mode"):
        int4_probe(x, packed, scales, "fused")
    with pytest.raises(ValueError, match="mode"):
        int4_probe_ref(x, packed, scales, "int8-dyn")
    with pytest.raises(ValueError, match=r"\(T, K\)"):
        int4_probe(x[None], packed, scales, "no-scale")
    assert MODES == ("no-scale", "no-unpack", "group-dots")


def test_probe_script_needs_a_card():
    from openvla_oft_tpu_torch.scripts import exp_int4_probe

    assert [name for name, _, _ in exp_int4_probe.SHAPES] == ["qkv", "gate_up", "down"]
    assert list(exp_int4_probe.variants()) == ["fused", "no-scale", "no-unpack", "group-dots",
                                               "a8-fused"]
    with pytest.raises(RuntimeError, match="CUDA"):
        exp_int4_probe.main(["--device", "cpu"])
