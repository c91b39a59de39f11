"""The port's joint ViT pair (`openvla_oft_tpu_torch/models/vit_joint.py`)
against the JAX package's (`openvla_oft_tpu/models/vit_joint.py`).

The mirror of `tests/test_vit_joint.py` on a heterogeneous tiny pair
(widths 48 and 32, head_dims 12 and 8: the softmax-scale fold; prefix 5 and
0 tokens: token padding and the key mask; LayerScale against none; gelu
against gelu_tanh; unequal depths: identity layers), and then the port held
to JAX on the same numpy weights (`bridge.params_from_numpy`):
  - the joint tree leaf for leaf, bitwise in fp32 (and in bf16, whose q
    fold rounds once per element on both sides);
  - the features within 2e-5 in fp32 (rtol and atol, `tests/test_vit_joint.py`'s);
  - in bf16, within 3e-2 of max|JAX| (both sides round every product and
    the bias add to bf16, in their own order);
  - the int8 codes and scales bitwise, and the int8 error to the float
    reference at most 2x the per-backbone int8 error + 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvla_oft_tpu.config as JC
import openvla_oft_tpu_torch.config as PC
from openvla_oft_tpu.config import TINY_DINOV2, TINY_SIGLIP, OpenVLAConfig
from openvla_oft_tpu.models import vision_backbone as JB
from openvla_oft_tpu.models import vit as JV
from openvla_oft_tpu.models import vit_joint as JJ
from openvla_oft_tpu.ops.quant import quantize_tree as jax_quantize_tree
from openvla_oft_tpu_torch.bridge import params_from_numpy
from openvla_oft_tpu_torch.models import vision_backbone as TB
from openvla_oft_tpu_torch.models import vit as TV
from openvla_oft_tpu_torch.models import vit_joint as TJ
from openvla_oft_tpu_torch.ops.quant import quantize_tree
from test_torch_import import port_arch, port_config

JC._VISION_REGISTRY.setdefault("tiny-dual", (TINY_DINOV2, TINY_SIGLIP))
JC._LLM_REGISTRY.setdefault("tiny-llama", JC.TINY_LLAMA)
NAMES = ("featurizer", "fused_featurizer")
TOL = dict(rtol=2e-5, atol=2e-5)
BF16_REL = 3e-2
PAIRS = {"equal-depth": ((TINY_DINOV2, TINY_SIGLIP), 0),
         "unequal-depth": ((TINY_DINOV2, dataclasses.replace(TINY_SIGLIP, depth=5)), 1)}


def raw_pair(cfgs, seed, dtype=jnp.float32):
    """The JAX init of each backbone with random norm affines and
    LayerScales (`tests/test_vit_joint.py::_make_pair`), unfolded."""
    params = {}
    for name, cfg, k in zip(NAMES, cfgs, jax.random.split(jax.random.PRNGKey(seed), 2)):
        p = JV.init_vit_params(k, cfg, dtype=dtype)
        noise = jax.random.split(k, 8)
        lay = p["layers"]
        n, d = cfg.depth, cfg.width
        lay["norm1"]["scale"] = (1.0 + 0.1 * jax.random.normal(noise[0], (n, d))).astype(dtype)
        lay["norm1"]["bias"] = (0.1 * jax.random.normal(noise[1], (n, d))).astype(dtype)
        lay["norm2"]["scale"] = (1.0 + 0.1 * jax.random.normal(noise[2], (n, d))).astype(dtype)
        lay["norm2"]["bias"] = (0.1 * jax.random.normal(noise[3], (n, d))).astype(dtype)
        if "ls1" in lay:
            lay["ls1"]["scale_factor"] = (0.5 + 0.1 * jax.random.normal(
                noise[4], (n, d))).astype(dtype)
            lay["ls2"]["scale_factor"] = (0.5 + 0.1 * jax.random.normal(
                noise[5], (n, d))).astype(dtype)
        params[name] = p
    return params


def folded_pair(cfgs, seed, dtype=jnp.float32, fold_norms=True):
    """JAX's folded per-backbone trees as numpy: the same weights go to both
    sides' joint builds."""
    return jax.tree_util.tree_map(np.asarray, {
        name: JV.fuse_vit_inference_weights(p, fold_norms=fold_norms)
        for name, p in raw_pair(cfgs, seed, dtype).items()})


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def images(cfgs, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (2, c.image_size, c.image_size, 3)).astype(np.float32)
            for c in cfgs]


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def assert_trees_bitwise(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, path
            w = w.astype(np.float32)
        np.testing.assert_array_equal(as_numpy(g), w, err_msg=path)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_joint_pair_matches_per_backbone_and_jax(pair):
    """The port's joint program equals its sequential folded pair, and its
    tree and features equal JAX's, on one set of weights."""
    cfgs, seed = PAIRS[pair]
    folded = folded_pair(cfgs, seed)
    imgs = images(cfgs, seed)
    p_cfgs = tuple(port_arch(c) for c in cfgs)
    want_tree = JJ.build_joint_vit_pair(jnp_tree(folded), cfgs, NAMES)
    got_tree = TJ.build_joint_vit_pair(params_from_numpy(folded), p_cfgs, NAMES)
    assert_trees_bitwise(got_tree, want_tree)
    want = JJ.vit_pair_featurize_joint(want_tree, cfgs, [jnp.asarray(x) for x in imgs])
    got = TJ.vit_pair_featurize_joint(got_tree, p_cfgs, [torch.from_numpy(x) for x in imgs])
    per_backbone = [TV.vit_featurize(params_from_numpy(folded[n]), c, torch.from_numpy(x))
                    for n, c, x in zip(NAMES, p_cfgs, imgs)]
    for w, g, pb, cfg in zip(want, got, per_backbone, cfgs):
        assert g.shape == pb.shape == (2, cfg.num_patches, cfg.width)
        np.testing.assert_allclose(g.numpy(), pb.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_joint_rejects_unfolded_layerscale_and_quantized():
    cfgs = (TINY_DINOV2, TINY_SIGLIP)
    p_cfgs = tuple(port_arch(c) for c in cfgs)
    raw = params_from_numpy(jax.tree_util.tree_map(np.asarray, raw_pair(cfgs, 0)))
    with pytest.raises(ValueError, match="folded"):
        TJ.build_joint_vit_pair(raw, p_cfgs, NAMES)
    q = {n: quantize_tree(TV.fuse_vit_inference_weights(raw[n]), min_dim=8) for n in NAMES}
    with pytest.raises(ValueError, match="no quantized"):
        TJ.build_joint_vit_pair(q, p_cfgs, NAMES)
    mixed = {NAMES[0]: TV.fuse_vit_inference_weights(raw[NAMES[0]]),
             NAMES[1]: TV.fuse_vit_inference_weights(raw[NAMES[1]], fold_norms=False)}
    with pytest.raises(ValueError, match="both groups folded or both unfolded"):
        TJ.build_joint_vit_pair(mixed, p_cfgs, NAMES)


def test_joint_scale_fold_unbiased_in_bf16():
    """The sqrt(hdj/hd) fold of the smaller-head group's q columns is
    computed in fp32 and rounded once per element (a bf16 scalar would bias
    every logit alike), and the whole bf16 tree is JAX's bit for bit."""
    cfgs = (TINY_DINOV2, TINY_SIGLIP)
    assert TINY_SIGLIP.head_dim < TINY_DINOV2.head_dim
    params = jax.tree_util.tree_map(np.asarray, {
        name: JV.fuse_vit_inference_weights(JV.init_vit_params(k, cfg, dtype=jnp.bfloat16))
        for name, cfg, k in zip(NAMES, cfgs, jax.random.split(jax.random.PRNGKey(3), 2))})
    p_cfgs = tuple(port_arch(c) for c in cfgs)
    joint = TJ.build_joint_vit_pair(params_from_numpy(params), p_cfgs, NAMES)
    g, cfg = 1, cfgs[1]
    nh, hd, hdj = cfg.num_heads, cfg.head_dim, max(c.head_dim for c in cfgs)
    n_run = cfg.depth - 1
    lj = joint["layers"]["qkv_k"].shape[0]
    got_q = joint["layers"]["qkv_k"][:, g].reshape(lj, -1, 3, nh, hdj)[:n_run, :cfg.width, 0,
                                                                       :, :hd]
    orig = torch.from_numpy(params[NAMES[g]]["layers"]["attn"]["qkv"]["kernel"][:n_run].astype(
        np.float32)).reshape(n_run, cfg.width, 3, nh, hd)[:, :, 0]
    want = (orig * (hdj / hd) ** 0.5).to(torch.bfloat16)
    assert torch.equal(got_q, want)
    biased = (orig * torch.tensor((hdj / hd) ** 0.5).to(torch.bfloat16).float()).to(
        torch.bfloat16)
    assert not torch.equal(got_q, biased)
    assert_trees_bitwise(joint, JJ.build_joint_vit_pair(jnp_tree(params), cfgs, NAMES))


def test_joint_bf16_features_match_jax():
    """bf16 weights and pixels: the port's joint features within BF16_REL of
    max|JAX| of JAX's, and of the port's own per-backbone pair."""
    cfgs = (TINY_DINOV2, TINY_SIGLIP)
    folded = folded_pair(cfgs, 5, jnp.bfloat16)
    imgs = [x.astype(jnp.bfloat16) for x in images(cfgs, 5)]
    p_cfgs = tuple(port_arch(c) for c in cfgs)
    want = JJ.vit_pair_featurize_joint(JJ.build_joint_vit_pair(jnp_tree(folded), cfgs, NAMES), cfgs,
                                       [jnp.asarray(x) for x in imgs])
    t_imgs = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16) for x in imgs]
    got = TJ.vit_pair_featurize_joint(TJ.build_joint_vit_pair(params_from_numpy(folded),
                                                              p_cfgs, NAMES), p_cfgs, t_imgs)
    for w, g, n, c, x in zip(want, got, NAMES, p_cfgs, t_imgs):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        scale = np.abs(w).max()
        assert np.abs(g.float().numpy() - w).max() <= BF16_REL * scale
        pb = TV.vit_featurize(params_from_numpy(folded[n]), c, x).float().numpy()
        assert np.abs(g.float().numpy() - pb).max() <= BF16_REL * np.abs(pb).max()


def _tiny_dual(**kw):
    return OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama", **kw)


def test_joint_film_and_single_backbone_rejected():
    """A joint tree with FiLM, or a joint tree for one backbone, raises
    rather than fall through (the per-backbone path cannot run on it)."""
    cfg = _tiny_dual(use_film=True)
    folded = folded_pair(cfg.vision_configs, 4)
    p_cfg = port_config(cfg)
    joint = {"joint": TJ.build_joint_vit_pair(params_from_numpy(folded), p_cfg.vision_configs)}
    h = TINY_DINOV2.image_size
    pixels = torch.zeros((1, 1, 2, h, h, 3))
    with pytest.raises(ValueError, match="FiLM"):
        TB.vision_backbone_forward(joint, p_cfg, pixels, film_params={}, language_embedding=
                                   torch.zeros((1, p_cfg.llm_dim)))
    PC._VISION_REGISTRY.setdefault("tiny-dinov2", (PC.TINY_DINOV2,))
    single = dataclasses.replace(p_cfg, vision_backbone_id="tiny-dinov2")
    with pytest.raises(ValueError, match="dual-backbone"):
        TB.vision_backbone_forward(joint, single, pixels[:, :, :1])


def test_joint_through_vision_backbone_forward():
    """A "joint" entry dispatches to the joint program: the same
    concatenated features as the per-backbone path and as JAX's dispatch."""
    cfg = _tiny_dual(num_images_in_input=2)
    folded = folded_pair(cfg.vision_configs, 2)
    h = TINY_DINOV2.image_size
    pixels = np.random.default_rng(2).normal(0, 1, (1, 2, 2, h, h, 3)).astype(np.float32)
    want = JB.vision_backbone_forward(
        {**jnp_tree(folded), "joint": JJ.build_joint_vit_pair(jnp_tree(folded),
                                                               cfg.vision_configs)}, cfg,
        jnp.asarray(pixels))
    p_cfg = port_config(cfg)
    p_folded = params_from_numpy(folded)
    joint = {"joint": TJ.build_joint_vit_pair(p_folded, p_cfg.vision_configs)}
    got = TB.vision_backbone_forward(joint, p_cfg, torch.from_numpy(pixels))
    per_backbone = TB.vision_backbone_forward(p_folded, p_cfg, torch.from_numpy(pixels))
    np.testing.assert_allclose(got.numpy(), per_backbone.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_joint_int8_matches_per_backbone_int8_and_jax():
    """int8 through the joint program: (1) its grids are the per-backbone
    int8 path's bit for bit (group 0, no dim padding) and JAX's joint codes
    and scales bit for bit; (2) its error to the float reference is the
    per-backbone int8 error's magnitude (`tests/test_vit_joint.py`'s bound),
    on both sides."""
    cfgs = (TINY_DINOV2, TINY_SIGLIP)
    p_cfgs = tuple(port_arch(c) for c in cfgs)
    raw = raw_pair(cfgs, 3)
    unfolded = jax.tree_util.tree_map(np.asarray, {
        n: JV.fuse_vit_inference_weights(p, fold_norms=False) for n, p in raw.items()})
    want_joint = JJ.quantize_joint_vit(JJ.build_joint_vit_pair(jnp_tree(unfolded), cfgs, NAMES))
    joint = TJ.quantize_joint_vit(TJ.build_joint_vit_pair(params_from_numpy(unfolded), p_cfgs,
                                                          NAMES))
    assert_trees_bitwise(joint, want_joint)
    assert joint["layers"]["qkv_k"].dtype == torch.int8 and "qkv_s" in joint["layers"]

    per_backbone = {n: quantize_tree(params_from_numpy(unfolded[n]), min_dim=8) for n in NAMES}
    cfg0, n_run = cfgs[0], cfgs[0].depth - 1
    nh, hd = cfg0.num_heads, cfg0.head_dim
    hdj, dj = max(c.head_dim for c in cfgs), max(c.width for c in cfgs)
    jq = joint["layers"]["qkv_k"][:, 0].numpy()
    pq = per_backbone[NAMES[0]]["layers"]["attn"]["qkv"]["kernel"][:n_run].numpy()
    pqr = np.pad(pq.reshape(n_run, cfg0.width, 3, nh, hd),
                 ((0, jq.shape[0] - n_run), (0, dj - cfg0.width), (0, 0), (0, 0),
                  (0, hdj - hd))).reshape(jq.shape)
    np.testing.assert_array_equal(jq, pqr)

    folded = {n: TV.fuse_vit_inference_weights(params_from_numpy(unfolded[n])) for n in NAMES}
    imgs = images(cfgs, 3)
    ref = [TV.vit_featurize(folded[n], c, torch.from_numpy(x))
           for n, c, x in zip(NAMES, p_cfgs, imgs)]
    pb = [TV.vit_featurize(per_backbone[n], c, torch.from_numpy(x))
          for n, c, x in zip(NAMES, p_cfgs, imgs)]
    got = TJ.vit_pair_featurize_joint(joint, p_cfgs, [torch.from_numpy(x) for x in imgs])
    j_pb = [JV.vit_featurize(jax_quantize_tree(jnp_tree(unfolded[n]), min_dim=8), c,
                             jnp.asarray(x))
            for n, c, x in zip(NAMES, cfgs, imgs)]
    j_got = JJ.vit_pair_featurize_joint(want_joint, cfgs, [jnp.asarray(x) for x in imgs])
    for r, p_, g, jp, jg in zip(ref, pb, got, j_pb, j_got):
        assert r.shape == g.shape
        r = r.numpy()
        err_pb, err_joint = np.abs(p_.numpy() - r).mean(), np.abs(g.numpy() - r).mean()
        assert err_joint < 2.0 * err_pb + 1e-4, (err_joint, err_pb)
        j_err_pb = np.abs(np.asarray(jp) - r).mean()
        j_err_joint = np.abs(np.asarray(jg) - r).mean()
        assert j_err_joint < 2.0 * j_err_pb + 1e-4, (j_err_joint, j_err_pb)
        assert err_joint < 2.0 * j_err_joint + 1e-4, (err_joint, j_err_joint)


def test_joint_builds_on_meta_tensors():
    """Every step of the bf16 and the int8 builds runs on `device="meta"`
    (the bench's zero tree), with the shapes and dtypes of a real build."""
    cfgs = (TINY_DINOV2, TINY_SIGLIP)
    p_cfgs = tuple(port_arch(c) for c in cfgs)
    folded = params_from_numpy(folded_pair(cfgs, 0, fold_norms=False))

    def to_meta(tree):
        if isinstance(tree, dict):
            return {k: to_meta(v) for k, v in tree.items()}
        return torch.empty_like(tree, device="meta")

    built = TJ.quantize_joint_vit(TJ.build_joint_vit_pair(to_meta(folded), p_cfgs))
    real = TJ.quantize_joint_vit(TJ.build_joint_vit_pair(folded, p_cfgs))
    want, got = flat(real), flat(built)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].device.type == "meta"
        assert (got[path].shape, got[path].dtype, got[path].stride()) == \
            (w.shape, w.dtype, w.stride()), path
