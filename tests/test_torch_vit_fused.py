"""Port parity for kernel K4's module (`ops/vit_fused.py::ln_matmul`, the
plain version on the CPU) against the JAX `ln_matmul`, which runs its Pallas
kernel in interpret mode on the CPU; the ViT path through it against the JAX
ViT on unfolded weights; and the gate that decides when the ViTs take it.

Mirrors tests/test_vit_fused.py. fp32 at rtol = atol = 2e-5: the same fp32
formula, summed in another order; bf16 at 2e-2 (one bf16 rounding).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from openvla_oft_tpu.config import TINY_DINOV2, TINY_SIGLIP
from openvla_oft_tpu.models import vit as JV
from openvla_oft_tpu.ops.vit_fused import ln_matmul as jax_ln_matmul
from openvla_oft_tpu_torch.bridge import index_layer, params_from_numpy
from openvla_oft_tpu_torch.models import vit as TV
from openvla_oft_tpu_torch.ops import vit_fused as VF
from test_torch_import import port_arch
from test_torch_vit import _perturb_norms

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=2e-5, atol=2e-5)


def _operands(rng, m=37, d=64, n=96, layers=None):
    x = rng.normal(0, 1.5, (2, m, d)).astype(np.float32)
    w = rng.normal(0, 0.05, (d, n) if layers is None else (layers, d, n)).astype(np.float32)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("act", [None, "gelu", "gelu_tanh", "quick_gelu"])
def test_ln_matmul_matches_jax_all_activations(rng, act):
    """m = 37, off the TPU blocks, so the JAX wrapper pads."""
    x, w, b = _operands(rng)
    ref = np.asarray(jax_ln_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act,
                                   block_m=16, block_n=128))
    got = VF.ln_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), act=act)
    assert got.shape == (2, 37, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL, err_msg=f"act={act}")


def test_ln_matmul_no_bias_bf16_matches_jax(rng):
    x = jnp.asarray(rng.normal(0, 1, (48, 128)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(0, 0.05, (128, 128)), jnp.bfloat16)
    ref = np.asarray(jax_ln_matmul(x, w, None, block_m=16).astype(jnp.float32))
    tx, tw = params_from_numpy({"x": x, "w": w}).values()
    got = VF.ln_matmul(tx, tw, None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2, atol=2e-2)


def test_ln_matmul_on_a_layer_view_matches_jax(rng):
    """w as layer 1 of a stacked (3, D, N) kernel, as the ViT hands it over."""
    x, w, b = _operands(rng, layers=3)
    ref = np.asarray(jax_ln_matmul(jnp.asarray(x), jnp.asarray(w[1]), jnp.asarray(b),
                                   act="gelu", block_m=16, block_n=128))
    stacked = torch.from_numpy(w)
    view = index_layer({"kernel": stacked}, 1)["kernel"]
    assert view.data_ptr() != stacked.data_ptr() and view._base is stacked
    got = VF.ln_matmul(torch.from_numpy(x), view, torch.from_numpy(b), act="gelu")
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_ln_matmul_ref_is_the_kernel_formula(rng):
    """var = E[x^2] - mean^2, the standardized x rounded to x's dtype before
    an fp32 product, the activation in fp32, one rounding at the end."""
    x = torch.from_numpy(rng.normal(3.0, 2.0, (9, 40))).bfloat16()
    w = torch.from_numpy(rng.normal(0, 0.1, (40, 24))).bfloat16()
    b = torch.from_numpy(rng.normal(0, 0.1, (24,))).bfloat16()
    xf = x.double()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    normed = ((xf - mean) / torch.sqrt(var + 1e-6)).bfloat16()
    acc = normed.double() @ w.double() + b.double()
    want = (acc * torch.sigmoid(1.702 * acc)).bfloat16()
    got = VF.ln_matmul_ref(x, w, b, "quick_gelu")
    assert got.dtype == torch.bfloat16
    # fp32 against fp64 sums: a bf16 ulp (2^-7 relative) apart, and near 0 a
    # standardized element that rounds the other way (|w| <= 0.5, 2^-8 x 4).
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=2 ** -7,
                               atol=1e-2)


def test_ln_matmul_rejects_what_it_does_not_take():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="act"):
        VF.ln_matmul(x, torch.zeros((8, 4)), None, act="relu")
    with pytest.raises(ValueError, match="do not fit"):
        VF.ln_matmul(x, torch.zeros((6, 4)), None)
    with pytest.raises(ValueError, match="do not fit"):
        VF.ln_matmul(x, torch.zeros((8, 4)), torch.zeros(5))


class _Spy:
    """Counts the calls that reach `ops/vit_fused.py::ln_matmul`."""

    def __init__(self):
        self.calls, self.acts = 0, []
        self.fn = VF.ln_matmul

    def __call__(self, x, w, b=None, act=None, eps=VF.EPS):
        self.calls += 1
        self.acts.append(act)
        return self.fn(x, w, b, act, eps)


@pytest.mark.parametrize("vcfg", [TINY_DINOV2, TINY_SIGLIP], ids=["dinov2", "siglip"])
def test_vit_featurize_fused_matches_jax_unfolded(rng, monkeypatch, vcfg):
    """vit_featurize through ln_matmul (folded norms, the switch on) against
    the JAX ViT on the unfolded weights: K4's formula against the dense one,
    as test_vit_block_fused_gate_off_on_cpu holds the folds."""
    params = _perturb_norms(JV.init_vit_params(jax.random.PRNGKey(3), vcfg,
                                               dtype=jnp.float32), rng)
    x = rng.standard_normal((2, vcfg.image_size, vcfg.image_size, 3)).astype(np.float32)
    ref = np.asarray(JV.vit_featurize(params, vcfg, jnp.asarray(x)))
    folded = TV.fuse_vit_inference_weights(params_from_numpy(params))
    spy = _Spy()
    monkeypatch.setattr(VF, "ln_matmul", spy)
    with VF.vit_fused(True):
        got = TV.vit_featurize(folded, port_arch(vcfg), torch.from_numpy(x)).numpy()
    assert spy.calls == 2 * (vcfg.depth - 1)
    assert spy.acts == [None, vcfg.act] * (vcfg.depth - 1)
    np.testing.assert_allclose(got, ref, **TOL)


def test_gelu_erf_fast_takes_the_kernels_exact_gelu(monkeypatch):
    spy = _Spy()
    monkeypatch.setattr(VF, "ln_matmul", spy)
    x = torch.randn((1, 5, 8)).bfloat16()
    lin = {"kernel": torch.randn((8, 16)).bfloat16(), "bias": torch.zeros(16).bfloat16()}
    with VF.vit_fused(True):
        TV._ln_linear({}, lin, x, act_name="gelu_erf_fast")
    assert spy.acts == ["gelu"]


def _lin(kind):
    k = torch.zeros((8, 16))
    return {"plain": {"kernel": k, "bias": torch.zeros(16)},
            "int8": {"kernel": k.to(torch.int8), "scale_w": torch.ones(16)},
            "int4": {"kernel_q4": torch.zeros((4, 16), dtype=torch.int8),
                     "scale_w4": torch.ones((1, 16))},
            "lora": {"kernel": k, "lora_a": torch.zeros((2, 8)), "lora_b": torch.zeros((2, 16))},
            }[kind]


@pytest.mark.parametrize("switch,norm,kind,taken", [
    (True, {}, "plain", True),
    (False, {}, "plain", False),
    (True, {"scale": torch.ones(8), "bias": torch.zeros(8)}, "plain", False),
    (True, {}, "int8", False),
    (True, {}, "int4", False),
    (True, {}, "lora", False),
], ids=["folded", "switch_off", "unfolded_norm", "int8", "int4", "lora"])
def test_gate(switch, norm, kind, taken):
    """The JAX gate without its platform test: the switch, a folded norm,
    and a plain float kernel without LoRA."""
    with VF.vit_fused(switch):
        assert TV._use_fused_ln_matmul(norm, _lin(kind)) is taken
    assert not TV._use_fused_ln_matmul(norm, _lin(kind))      # off outside the block


def test_unfolded_vit_takes_no_ln_matmul(rng, monkeypatch):
    params = params_from_numpy(JV.init_vit_params(jax.random.PRNGKey(0), TINY_SIGLIP,
                                                  dtype=jnp.float32))
    spy = _Spy()
    monkeypatch.setattr(VF, "ln_matmul", spy)
    x = torch.from_numpy(rng.standard_normal((1, 28, 28, 3)).astype(np.float32))
    with VF.vit_fused(True):
        TV.vit_featurize(params, port_arch(TINY_SIGLIP), x)
    assert spy.calls == 0
