"""Port parity for LoRA: `training/lora.py` and the LoRA branch of `linear`.

Mirrors test_lora_identity_at_init, test_lora_layout_migration_merge_equivalence
and test_inject_lora_matches_merge (tests/test_training.py) on the port, and
holds the port's merge-free `linear` against the JAX `linear` on the same
numpy factors: fp32 to 1e-5, bf16 to one bf16 ulp (the two frameworks sum
the fp32 products in another order before the rounding to bf16).
"""

import ml_dtypes
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.ops.layers import linear as jax_linear
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu_torch.bridge import params_from_numpy, tree_leaves
from openvla_oft_tpu_torch.ops.layers import linear
from openvla_oft_tpu_torch.training import lora as L
from test_training import CFG

torch.backends.cuda.matmul.allow_tf32 = False


def _llm_base():
    full = init_openvla_params(jax.random.PRNGKey(0), CFG, LIBERO, dtype=jnp.float32,
                               head=None, with_lm_head=False)
    return params_from_numpy({"llm": full["llm"]})


BASE = _llm_base()


def _gen(seed=1):
    return torch.Generator().manual_seed(seed)


def test_lora_identity_at_init():
    """B = 0 at init: merged params equal the base exactly; the LLM's 7
    linears per layer are targeted; A is rank-major (L, r, in)."""
    lora = L.init_lora(_gen(), BASE, rank=4)
    merged = L.apply_lora(BASE, lora, rank=4, alpha=4.0)
    for a, b in zip(tree_leaves(BASE), tree_leaves(merged)):
        assert torch.equal(a, b)
    assert set(lora["llm"]["layers"]["attn"]) == {"wq", "wk", "wv", "wo"}
    assert set(lora["llm"]["layers"]["mlp"]) == {"gate", "up", "down"}
    wq = lora["llm"]["layers"]["attn"]["wq"]
    n_layers, d = CFG.llm.num_layers, CFG.llm.hidden_size
    assert wq["a"].shape == (n_layers, 4, d) and wq["b"].shape == (n_layers, 4, d)
    assert wq["a"].dtype == torch.float32 and not wq["b"].any()
    # A ~ N(0, 1) / r (peft "gaussian" init).
    a = torch.cat([t["a"].flatten() for t in lora["llm"]["layers"]["mlp"].values()])
    assert abs(a.std().item() * 4 - 1.0) < 0.05 and abs(a.mean().item()) < 0.01


def test_lora_targets_cover_vision_and_projector():
    """"all-linear": the ViT blocks and the projector carry factors too."""
    full = params_from_numpy(init_openvla_params(
        jax.random.PRNGKey(0), CFG, LIBERO, dtype=jnp.float32, head="l1",
        with_lm_head=False))
    base = {k: full[k] for k in ("llm", "vision_backbone", "projector")}
    lora = L.init_lora(_gen(), base, rank=4)
    for name in base["vision_backbone"]:
        vit = lora["vision_backbone"][name]["layers"]
        assert set(vit["attn"]) == {"qkv", "proj"} and set(vit["mlp"]) == {"fc1", "fc2"}
    assert set(lora["projector"]) == set(base["projector"])


def test_lora_layout_migration_merge_equivalence():
    """The pre-rank-major (…, in, r) layout merges bit-identically; migration
    is a no-op on current-layout trees."""
    lora = L.init_lora(_gen(), BASE, rank=4)

    def shift(tree):
        return {k: shift(v) if isinstance(v, dict) else v + 0.01 for k, v in tree.items()}

    def old(tree):
        return {k: (old(v) if isinstance(v, dict) else
                    v.transpose(-1, -2) if k == "a" else v) for k, v in tree.items()}

    lora = shift(lora)
    merged_new = L.merge_lora_into_params(BASE, lora, rank=4, alpha=4.0)
    merged_old = L.merge_lora_into_params(BASE, old(lora), rank=4, alpha=4.0)
    for a, b in zip(tree_leaves(merged_new), tree_leaves(merged_old)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(lora), tree_leaves(L.migrate_lora_layout(lora, 4))):
        assert torch.equal(a, b)


def test_inject_lora_matches_merge():
    """Merge-free evaluation equals merged evaluation (same math, no W' copy)."""
    torch.manual_seed(0)
    base = {"llm": {"layers": {"attn": {"wq": {"kernel": torch.randn(2, 32, 48) * 0.1}}}}}
    lora = L.init_lora(_gen(), base, rank=4)
    lora = {"llm": {"layers": {"attn": {"wq": {k: v + 0.05 for k, v in
                                               lora["llm"]["layers"]["attn"]["wq"].items()}}}}}
    merged = L.apply_lora(base, lora, rank=4, alpha=8.0)
    injected = L.inject_lora(base, lora, rank=4, alpha=8.0)
    x = torch.randn(5, 32)
    for layer in range(2):
        node_m = {k: v[layer] for k, v in merged["llm"]["layers"]["attn"]["wq"].items()}
        node_i = {k: v[layer] for k, v in injected["llm"]["layers"]["attn"]["wq"].items()}
        torch.testing.assert_close(linear(node_i, x), linear(node_m, x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_lora_linear_matches_jax(rng, dtype, bias):
    """inject_lora's node through both `linear`s: x and W in `dtype`, fp32
    factors, A rank-major and pre-scaled."""
    d_in, d_out, r = 48, 40, 4
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    x = rng.standard_normal((3, 5, d_in)).astype(np_dt)
    node = {"kernel": (rng.standard_normal((d_in, d_out)) * 0.1).astype(np_dt),
            "lora_a": (rng.standard_normal((r, d_in)) * 0.5).astype(np.float32),
            "lora_b": (rng.standard_normal((r, d_out)) * 0.5).astype(np.float32)}
    if bias:
        node["bias"] = rng.standard_normal(d_out).astype(np_dt)
    ref = np.asarray(jax_linear({k: jnp.asarray(v) for k, v in node.items()},
                                jnp.asarray(x)).astype(jnp.float32))
    got = linear(params_from_numpy(node), params_from_numpy(x)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        # One bf16 ulp is 2^-8 of the value's binade.
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=2 ** -7)
        assert np.mean(got == ref) >= 0.95
