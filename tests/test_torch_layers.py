"""Port parity for the layer primitives, RoPE and the OFT masks.

The same numpy inputs go through `openvla_oft_tpu.ops.*` and
`openvla_oft_tpu_torch.ops.*` on the CPU in fp32 and must agree within 1e-6
(elementwise math on both sides; fp32 ulp-level differences from each
backend's exp/erf/sin). `gelu_erf_fast` in bf16 is enumerated over every
finite bf16 input, as tests/test_fast_gelu.py does for the JAX version.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from openvla_oft_tpu.ops import layers as J
from openvla_oft_tpu.ops import masks as JM
from openvla_oft_tpu.ops import rotary as JR
from openvla_oft_tpu_torch.ops import layers as T
from openvla_oft_tpu_torch.ops import masks as TM
from openvla_oft_tpu_torch.ops import rotary as TR

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("bias", [True, False])
def test_linear(rng, bias):
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = {"kernel": rng.standard_normal((16, 24)).astype(np.float32) * 0.1}
    if bias:
        p["bias"] = rng.standard_normal(24).astype(np.float32)
    ref = np.asarray(J.linear({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = T.linear({k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_linear_rejects_unported_formats():
    x = torch.zeros(2, 4)
    # LoRA factors are ported (item 14): a zero B leaves the base product.
    lora = {"kernel": torch.ones(4, 3), "lora_a": torch.ones(2, 4),
            "lora_b": torch.zeros(2, 3)}
    assert torch.equal(T.linear(lora, x + 1), T.linear({"kernel": torch.ones(4, 3)}, x + 1))
    # int4 weights are ported (item 15, ops/quant.py); LoRA over an int4 base
    # (QLoRA) is not (item 14).
    q4 = {"kernel_q4": torch.zeros(2, 3, dtype=torch.int8), "scale_w4": torch.ones(1, 3)}
    assert torch.equal(T.linear(q4, x), torch.zeros(2, 3))
    with pytest.raises(NotImplementedError, match="item 14"):
        T.linear({**q4, "lora_a": torch.ones(2, 4), "lora_b": torch.zeros(2, 3)}, x)
    # int8 weights are ported (item 9); LoRA over an int8 base is not (item 14).
    q8 = {"kernel": torch.zeros(4, 3, dtype=torch.int8), "scale_w": torch.ones(3)}
    with pytest.raises(NotImplementedError, match="item 14"):
        T.linear({**q8, "lora_a": torch.ones(2, 4), "lora_b": torch.zeros(2, 3)}, x)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_linear_int8_goes_to_int8_linear(rng, static):
    """An int8 dict (kernel int8, scale_w, optionally scale_x and bias) goes
    to `ops/quant.py::int8_linear` and gives exactly its answer."""
    from openvla_oft_tpu_torch.ops import quant as Q

    w = rng.standard_normal((32, 24)).astype(np.float32) * 0.1
    p = {**Q.quantize_weight(_t(w)), "bias": _t(rng.standard_normal(24).astype(np.float32))}
    if static:
        p["scale_x"] = torch.tensor(0.02)
    x = _t(rng.standard_normal((2, 5, 32)).astype(np.float32))
    before = Q.int8_mm.launches
    got = T.linear(p, x)
    assert Q.int8_mm.launches == before + 1
    assert got.dtype == x.dtype and torch.equal(got, Q.int8_linear(p, x))


@pytest.mark.parametrize("with_scale", [True, False])
def test_rms_norm(rng, with_scale):
    x = rng.standard_normal((3, 7, 32)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(32).astype(np.float32)} if with_scale else {}
    ref = J.rms_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), 1e-5)
    got = T.rms_norm({k: _t(v) for k, v in p.items()}, _t(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_rms_norm_bf16_cast_order(rng):
    """HF order: standardize in fp32, cast to bf16, then multiply the scale."""
    x = rng.standard_normal((4, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    ref = J.rms_norm({"scale": jnp.asarray(s, jnp.bfloat16)},
                     jnp.asarray(x, jnp.bfloat16), 1e-5)
    got = T.rms_norm({"scale": _t(s).bfloat16()}, _t(x).bfloat16(), 1e-5)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(rng, affine):
    x = rng.standard_normal((3, 7, 32)).astype(np.float32) * 2 + 1
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)} if affine else {}
    ref = J.layer_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), 1e-6)
    got = T.layer_norm({k: _t(v) for k, v in p.items()}, _t(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "quick_gelu"])
def test_activations(rng, name):
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 4,
                        np.linspace(-12, 12, 2001, dtype=np.float32)])
    ref = np.asarray(getattr(J, name)(jnp.asarray(x)))
    got = getattr(T, name)(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_gelu_erf_fast_fp32_is_exact_gelu(rng):
    x = _t(rng.standard_normal(1000).astype(np.float32) * 4)
    assert torch.equal(T.gelu_erf_fast(x), T.gelu(x))


def _all_finite_bf16() -> np.ndarray:
    u = np.arange(0x10000, dtype=np.uint32)
    f = (u << 16).view(np.float32)
    return f[np.isfinite(f)]


def test_gelu_erf_fast_bf16_enumeration():
    """Every finite bf16 input through both versions. Equal bits are
    expected; where both backends' exp rounding differs the result may move
    by one bf16 ulp. Inputs whose GELU (about x/2) lands in fp32's subnormal
    range are excluded from the bit comparison: XLA on the CPU flushes
    subnormals to zero, torch keeps them (the JAX test pins the same
    exclusion)."""
    x32 = _all_finite_bf16()
    ref = np.asarray(jax.jit(J.gelu_erf_fast)(jnp.asarray(x32).astype(jnp.bfloat16)))
    got = T.gelu_erf_fast(_t(x32).bfloat16())
    ref_bits = ref.view(np.uint16).astype(np.int64)
    got_bits = got.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    ref_f = ref.astype(np.float32)
    got_f = got.float().numpy()
    tiny = np.float32(np.finfo(np.float32).tiny)
    normal = (((np.abs(x32) >= 4 * tiny) | (x32 == 0))
              & ((np.abs(ref_f) >= tiny) | (ref_f == 0))
              & ((np.abs(got_f) >= tiny) | (got_f == 0)))
    diff = np.abs(ref_bits - got_bits)[normal]
    n_off = int((diff > 0).sum())
    print(f"gelu_erf_fast bf16: {n_off} of {normal.sum()} normal inputs differ "
          f"by 1 ulp, {int((~normal).sum())} subnormal cases excluded")
    assert diff.max() <= 1
    assert n_off <= 1000
    # Subnormal cases: both sides stay within the input's magnitude.
    sub = ~normal
    assert np.all(np.abs(got_f[sub]) <= np.abs(x32[sub]))
    assert torch.isnan(T.gelu_erf_fast(torch.tensor([float("nan")]).bfloat16())).all()


def test_rope(rng):
    positions = np.stack([np.arange(40), np.maximum(np.arange(40) - 7, 0)]).astype(np.int32)
    js, jc = JR.rope_sin_cos(jnp.asarray(positions), 16, 10000.0)
    ts, tc = TR.rope_sin_cos(_t(positions), 16, 10000.0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    x = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    ref = JR.apply_rope(jnp.asarray(x), js, jc)
    got = TR.apply_rope(_t(x), ts, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_masks(rng):
    pad = rng.random((3, 20)) > 0.2
    bidir = np.zeros((3, 20), bool)
    bidir[:, 12:18] = True
    ref = JM.make_block_bidirectional_mask(jnp.asarray(pad), jnp.asarray(bidir))
    got = TM.make_block_bidirectional_mask(_t(pad), _t(bidir))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(TM.make_prefix_positions(_t(pad)).numpy(),
                                  np.asarray(JM.make_prefix_positions(jnp.asarray(pad))))
