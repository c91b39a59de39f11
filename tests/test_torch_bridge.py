"""The param bridge: JAX pytree -> torch, leaf for leaf, and the on-device
random init with the JAX init's structure, shapes and scales."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvla_oft_tpu.config as C
from openvla_oft_tpu.config import OpenVLAConfig, TINY_DINOV2, TINY_LLAMA, TINY_SIGLIP
from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu_torch.bridge import Init, init_params, param_spec, params_from_numpy
from test_torch_import import port_config, port_platform

C._VISION_REGISTRY.setdefault("tiny-dual", (TINY_DINOV2, TINY_SIGLIP))
C._LLM_REGISTRY.setdefault("tiny-llama", TINY_LLAMA)
TINY = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                     num_images_in_input=2)
FLAGSHIP = OpenVLAConfig(vision_backbone_id="dinosiglip-vit-so-224px",
                         llm_backbone_id="llama2-7b-pure", num_images_in_input=2)
# The same configs and platform on the port's side.
P_TINY, P_FLAGSHIP, P_LIBERO = port_config(TINY), port_config(FLAGSHIP), port_platform(LIBERO)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Init):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _jax_init(cfg, **kw):
    return init_openvla_params(jax.random.PRNGKey(0), cfg, LIBERO, head="l1", **kw)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_numpy_maps_every_leaf(dtype):
    tree = _jax_init(TINY, dtype=dtype)
    ported = params_from_numpy(tree)
    src, dst = _flatten(tree), _flatten(ported)
    assert set(src) == set(dst)            # every leaf mapped, none invented
    torch_dtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    for path, leaf in src.items():
        t = dst[path]
        assert tuple(t.shape) == leaf.shape, path
        assert t.dtype == torch_dtype or leaf.dtype != dtype, path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32), err_msg=str(path))


def test_params_from_numpy_casts_on_request():
    tree = _jax_init(TINY, dtype=jnp.float32)
    ported = params_from_numpy(tree, dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in _flatten(ported).values())


def test_param_spec_matches_jax_eval_shape_at_flagship_size():
    """Shapes only: nothing 7B-sized is built on either side."""
    shapes = jax.eval_shape(lambda: _jax_init(FLAGSHIP, dtype=jnp.bfloat16,
                                              with_lm_head=False,
                                              head_dtype=jnp.bfloat16))
    ref = {p: tuple(s.shape) for p, s in _flatten(shapes).items()}
    got = {p: tuple(i.shape) for p, i in _flatten(param_spec(P_FLAGSHIP, P_LIBERO)).items()}
    assert got == ref


def test_init_params_tiny_matches_jax_tree_and_scales():
    gen = torch.Generator().manual_seed(0)
    params = init_params(P_TINY, P_LIBERO, gen, device="cpu", dtype=torch.float32)
    ref = _flatten(_jax_init(TINY, dtype=jnp.float32, with_lm_head=False))
    got = _flatten(params)
    assert set(got) == set(ref)
    for path, leaf in ref.items():
        assert tuple(got[path].shape) == leaf.shape, path
        a, b = np.asarray(leaf), got[path].numpy()
        if np.all(a == a.flat[0]):          # constant leaves: ones, zeros, 1e-5
            np.testing.assert_array_equal(b, a, err_msg=str(path))
        elif a.size >= 256:                 # normal draws: same scale
            assert abs(b.std() / a.std() - 1) < 0.35, path
    # Same seed, same draw.
    again = init_params(P_TINY, P_LIBERO, torch.Generator().manual_seed(0),
                        device="cpu", dtype=torch.float32)
    assert torch.equal(again["llm"]["embed"]["embedding"],
                       params["llm"]["embed"]["embedding"])
