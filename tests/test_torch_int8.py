"""Port parity for int8 serving: `quantize_weight`, the W8A8 linear (dynamic
and static activation scales) and its straight-through gradient, the tree
quantizers, the loader (`serving_params`), the tiny int8 serving path, the
static-scale calibration and the deploy CLI's flags, against the JAX package
on the CPU.

Inputs are numpy arrays from a seed; each side gets its own config
(`port_config`). The product is `torch._int_mm` on the port's side and
XLA's int32 `dot_general` on the JAX side, both exact. Tolerances:
- weight codes and scales, activation codes, int32 products, quantized
  trees: exact;
- `int8_linear` in fp32: max|d| <= 1e-6 * max|ref| (the same fp32 epilogue
  on equal int32 sums); in bf16: within one bf16 ulp of the reference;
- gradients: relative 1e-5 (the same bf16 products summed in fp32 in
  another order);
- calibrated scale_x: relative 1e-6; the tiny model in fp32: max|d| <=
  1e-4 * max|ref|, as the int4 slice's tests hold it.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvla_oft_tpu.config as C
from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.models.llama import fuse_inference_weights as jax_fuse
from openvla_oft_tpu.models.prismatic import predict_action_hidden as jax_predict
from openvla_oft_tpu.models.vit import fuse_vit_inference_weights as jax_fuse_vit
from openvla_oft_tpu.ops import int4_matmul as JM
from openvla_oft_tpu.ops import quant as JQ
from openvla_oft_tpu.ops import quant_calibrate as JC
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.policy import serve_action_chunk as jax_serve
from openvla_oft_tpu_torch.bridge import index_layer, params_from_numpy
from openvla_oft_tpu_torch.models.llama import fuse_inference_weights
from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden
from openvla_oft_tpu_torch.ops import quant as Q
from openvla_oft_tpu_torch.ops import quant_calibrate as QC
from openvla_oft_tpu_torch.ops.layers import linear
from openvla_oft_tpu_torch.policy import serve_action_chunk
from openvla_oft_tpu_torch.serving import deploy
from test_torch_import import port_config, port_platform
from test_torch_int4 import _flat, _model_inputs, _serve_inputs

torch.backends.cuda.matmul.allow_tf32 = False

PLATFORM = port_platform(LIBERO)
# Every tiny linear is at least this wide on its input side, so min_dim
# quantizes all of them (the ViTs' patch embeddings included).
TINY_MIN_DIM = 32


def _assert_trees_equal(got, ref):
    """Leaf for leaf: the same key paths, dtypes and values."""
    got_leaves, ref_leaves = dict(_flat(got)), dict(_flat(ref))
    assert sorted(got_leaves, key=str) == sorted(ref_leaves, key=str)
    for path, r in ref_leaves.items():
        g, r_t = got_leaves[path], params_from_numpy(r)
        assert g.dtype == r_t.dtype, path
        assert torch.equal(g, r_t), path


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _weights(rng, shape):
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w.flat[::17] = 0.0                     # exact zeros, and ties of |w|
    return w


# --- quantize_weight ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(256, 96), (3, 256, 64), (2, 2, 64, 40)],
                         ids=["flat", "stacked", "two-leading-dims"])
def test_quantize_weight_bit_equal(rng, shape):
    w = _weights(rng, shape)
    w[..., 5] = 0.0                        # a zero column: scale 0, codes 0
    ref = JQ.quantize_weight(jnp.asarray(w))
    got = Q.quantize_weight(torch.from_numpy(w))
    assert got["kernel"].dtype == torch.int8 and got["scale_w"].dtype == torch.float32
    assert got["kernel"].shape == shape and got["scale_w"].shape == shape[:-2] + shape[-1:]
    np.testing.assert_array_equal(got["kernel"].numpy(), np.asarray(ref["kernel"]))
    np.testing.assert_array_equal(got["scale_w"].numpy(), np.asarray(ref["scale_w"]))
    # The serving layout: (..., out, in) in memory.
    assert got["kernel"].transpose(-1, -2).is_contiguous()


def test_quantize_weight_bf16_source(rng):
    w = jnp.asarray(_weights(rng, (128, 48)), jnp.bfloat16)
    ref = JQ.quantize_weight(w)
    got = Q.quantize_weight(params_from_numpy(w))
    np.testing.assert_array_equal(got["kernel"].numpy(), np.asarray(ref["kernel"]))
    np.testing.assert_array_equal(got["scale_w"].numpy(), np.asarray(ref["scale_w"]))


# --- int8_linear, dynamic and static ------------------------------------------

STATIC_SCALE = 0.021


def _jax_codes(x2, static):
    """The JAX path's int8 codes of x (`_int8_matmul` / the static scalar
    branch of `_int8_matmul_static`)."""
    if not static:
        return JM._quantize_act_rows(x2)[0]
    inv = 1.0 / jnp.maximum(jnp.float32(STATIC_SCALE), 1e-12)
    return jnp.clip(jnp.round(x2.astype(jnp.float32) * inv), -127, 127).astype(jnp.int8)


def _port_codes(x2, static):
    if not static:
        return Q.quantize_act_rows(x2)[0]
    inv = 1.0 / torch.clamp(torch.tensor(STATIC_SCALE), min=1e-12)
    return torch.clamp(torch.round(x2.float() * inv), -127, 127).to(torch.int8)


def _bf16_ulps(got: torch.Tensor, ref: np.ndarray) -> int:
    """The largest distance in bf16 steps between two bf16 arrays."""
    a = got.view(torch.int16).numpy().astype(np.int32)
    b = np.asarray(ref).view(np.int16).astype(np.int32)
    a = np.where(a < 0, -(a & 0x7FFF), a)           # sign-magnitude -> ordered
    b = np.where(b < 0, -(b & 0x7FFF), b)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("lead", [(2, 8), (1,), (16,), (17,)], ids=["2x8", "T1", "T16", "T17"])
@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_linear_matches_jax(rng, lead, bias, dtype, static):
    k, n = 256, 96
    w = _weights(rng, (k, n))
    x = (rng.standard_normal(lead + (k,)) * 2).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    jq = JQ.quantize_weight(jnp.asarray(w))
    tq = Q.quantize_weight(torch.from_numpy(w))
    jp, tp = dict(jq), dict(tq)
    if static:
        jp["scale_x"] = jnp.asarray(STATIC_SCALE, jnp.float32)
        tp["scale_x"] = torch.tensor(STATIC_SCALE)
    if bias:
        jp["bias"], tp["bias"] = jnp.asarray(b), torch.from_numpy(b)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))

    codes_ref = _jax_codes(jx.reshape(-1, k), static)
    codes = _port_codes(tx.reshape(-1, k), static)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_ref))
    acc_ref = jax.lax.dot_general(codes_ref, jq["kernel"], (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(Q.int8_mm(codes, tq["kernel"]).numpy(), np.asarray(acc_ref))

    ref = JQ.int8_linear(jp, jx)
    got = Q.int8_linear(tp, tx)
    assert got.dtype == tx.dtype and got.shape == lead + (n,)
    if dtype == "float32":
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    else:
        assert _bf16_ulps(got, np.asarray(ref)) <= 1


def test_int8_mm_pads_few_rows_and_equals_the_plain_product(rng):
    """Fewer than INT_MM_MIN_ROWS rows are padded with zero rows (CUDA
    `_int_mm` refuses them): the result has the caller's rows and equals the
    float64 product; a product counts one launch."""
    k8 = torch.from_numpy(rng.integers(-127, 128, (64, 40), dtype=np.int8))
    for t in (0, 1, 16, 17, 40):
        x8 = torch.from_numpy(rng.integers(-127, 128, (t, 64), dtype=np.int8))
        before = Q.int8_mm.launches
        out = Q.int8_mm(x8, k8)
        assert Q.int8_mm.launches == before + 1
        assert out.dtype == torch.int32 and out.shape == (t, 40)
        assert torch.equal(out, Q.int8_mm_ref(x8, k8))
        assert torch.equal(out, (x8.long() @ k8.long()).int())


def test_int8_linear_takes_one_layer():
    q = Q.quantize_weight(torch.ones((2, 64, 32)))
    with pytest.raises(ValueError, match="index_layer"):
        Q.int8_linear(q, torch.zeros((3, 64)))
    layer = index_layer(q, 1)
    with pytest.raises(ValueError, match="0-d scale_x"):
        Q.int8_linear({**layer, "scale_x": torch.ones(2)}, torch.zeros((3, 64)))


@pytest.mark.parametrize("sx_dtype", [None, "float32", "bfloat16"],
                         ids=["dynamic", "static-fp32", "static-bf16"])
def test_straight_through_gradient_matches_jax(sx_dtype):
    """d/dx of sum(y^2) through the straight-through backward against
    jax.grad (mirrors tests/test_quant.py's gradient tests); scale_x keeps
    its dtype, and its gradient is zero in that dtype."""
    rng = np.random.default_rng(1)
    k, n, t = 128, 64, 4
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((t, k)).astype(np.float32)
    jp = dict(JQ.quantize_weight(jnp.asarray(w)))
    tp = dict(Q.quantize_weight(torch.from_numpy(w)))
    if sx_dtype:
        jp["scale_x"] = jnp.asarray(0.02, getattr(jnp, sx_dtype))
        tp["scale_x"] = torch.tensor(0.02, dtype=getattr(torch, sx_dtype),
                                     requires_grad=True)
    ref = jax.grad(lambda xx: jnp.sum(jnp.square(JQ.int8_linear(jp, xx))))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    torch.square(linear(tp, tx)).sum().backward()
    assert tx.grad.dtype == torch.float32
    assert _rel(tx.grad.numpy(), ref) <= 1e-5
    assert tp["kernel"].grad is None and tp["scale_w"].grad is None
    if sx_dtype:
        assert tp["scale_x"].grad.dtype == tp["scale_x"].dtype
        assert float(tp["scale_x"].grad) == 0.0


def test_stacked_static_scales_through_layer_views(rng):
    """The JAX static path's stacked branch ((L,) scale_x, (L, in, out)
    kernel, output (..., L, out)) against the port's layer views: the port
    indexes layers (`bridge.index_layer`) and passes 0-d scale_x."""
    L, k, n, t = 3, 128, 64, 4
    w = _weights(rng, (L, k, n))
    x = rng.standard_normal((t, k)).astype(np.float32)
    scales = np.asarray([0.01, 0.02, 0.05], np.float32)
    jq = JQ.quantize_weight(jnp.asarray(w))
    ref = np.asarray(JQ._int8_matmul_static(jnp.asarray(x), jq["kernel"], jq["scale_w"],
                                            jnp.asarray(scales)))
    stacked = {**Q.quantize_weight(torch.from_numpy(w)), "scale_x": torch.from_numpy(scales)}
    for layer in range(L):
        got = Q.int8_linear(index_layer(stacked, layer), torch.from_numpy(x))
        assert np.abs(got.numpy() - ref[:, layer]).max() <= 1e-6 * np.abs(ref).max()


def test_views_reach_int_mm_without_a_copy(rng):
    """Layer views and the out_window layer's column views of a quantized
    kernel stay column-major views of its storage, and give what the JAX
    package's slices give."""
    w = _weights(rng, (2, 128, 192))
    x = rng.standard_normal((5, 128)).astype(np.float32)
    jq = JQ.quantize_weight(jnp.asarray(w))
    tq = Q.quantize_weight(torch.from_numpy(w))
    base = tq["kernel"].untyped_storage().data_ptr()
    for layer in range(2):
        lp = index_layer(tq, layer)
        for lo, hi in ((0, 64), (64, 128), (128, 192)):
            view = {name: leaf[..., lo:hi] for name, leaf in lp.items()}
            assert view["kernel"].untyped_storage().data_ptr() == base
            assert view["kernel"].stride() == (1, 128)
            ref = JQ.int8_linear({"kernel": jq["kernel"][layer][:, lo:hi],
                                  "scale_w": jq["scale_w"][layer][lo:hi]}, jnp.asarray(x))
            got = linear(view, torch.from_numpy(x))
            assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6 * np.abs(ref).max()


# --- the tree quantizers --------------------------------------------------------

def _tiny_cfg():
    return C.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                           num_images_in_input=2)


def _tiny_params(seed=3, with_lm_head=False):
    return dict(init_openvla_params(jax.random.PRNGKey(seed), _tiny_cfg(), LIBERO,
                                    dtype=jnp.float32, head="l1",
                                    with_lm_head=with_lm_head))


def test_quantize_tree_bits8_rules(rng):
    """min_dim, lm_head left out, norms, biases and embeddings untouched;
    the same tree as the JAX package's."""
    tree = {"big": {"kernel": rng.standard_normal((2048, 64)).astype(np.float32),
                    "bias": np.zeros(64, np.float32)},
            "small": {"kernel": rng.standard_normal((64, 64)).astype(np.float32)},
            "lm_head": {"kernel": rng.standard_normal((2048, 64)).astype(np.float32)},
            "norm": {"scale": np.ones(64, np.float32)},
            "embed": {"embedding": rng.standard_normal((10, 2048)).astype(np.float32)}}
    ref = JQ.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree), min_dim=1024)
    got = Q.quantize_tree(params_from_numpy(tree), min_dim=1024)
    assert got["big"]["kernel"].dtype == torch.int8 and "scale_w" in got["big"]
    assert got["small"]["kernel"].dtype == torch.float32 and "scale_w" not in got["small"]
    assert got["lm_head"]["kernel"].dtype == torch.float32
    _assert_trees_equal(got, ref)


def test_quantize_tree_bits8_tiny_llm_matches_jax():
    llm = jax_fuse(_tiny_params(with_lm_head=True)["llm"], fold_norms=False)
    ref = JQ.quantize_tree(llm, min_dim=TINY_MIN_DIM, bits=8)
    got = Q.quantize_tree(params_from_numpy(llm), min_dim=TINY_MIN_DIM, bits=8)
    assert sum(p[-1] == "scale_w" for p, _ in _flat(got)) == 4     # wqkv wo gate_up down
    _assert_trees_equal(got, ref)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_lowmem_equals_quantize_tree(bits):
    """The low-memory quantizer gives quantize_tree's leaves bit for bit and
    consumes its input: the source kernels are gone from the input tree."""
    params = params_from_numpy(_tiny_params())
    src = {m: params[m] for m in ("llm", "vision_backbone", "projector")}
    ref = {m: Q.quantize_tree(src[m], min_dim=TINY_MIN_DIM, bits=bits) for m in src}
    got = {m: Q.quantize_tree_lowmem(src[m], min_dim=TINY_MIN_DIM, bits=bits) for m in src}

    def by_path(tree):
        return {p: t for p, t in _flat(tree)}

    g, r = by_path(got), by_path(ref)
    assert sorted(g) == sorted(r)
    for path, t in r.items():
        assert g[path].dtype == t.dtype and torch.equal(g[path], t), path
    # The input is consumed: where a quantized leaf now is, no float kernel is left.
    quantized = [p[:-1] for p, _ in _flat(src) if p[-1] in ("scale_w", "scale_w4")]
    assert len(quantized) > 10
    for path in quantized:
        node = src
        for key in path:
            node = node[key]
        assert node.get("kernel", torch.zeros((), dtype=torch.int8)).dtype == torch.int8, path


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_then_fuse_equals_fuse_then_quantize(bits):
    """fuse_inference_weights on quantized projections gives the tree that
    quantizing the fused float tree gives: the same bytes, scales and strides
    (int8's kernel column-major for torch._int_mm, int4's packed kernel_q4
    row-major for K5 and K6)."""
    llm = params_from_numpy(_tiny_params()["llm"])
    ref = Q.quantize_tree(fuse_inference_weights(llm, fold_norms=False),
                          min_dim=TINY_MIN_DIM, bits=bits)
    got = fuse_inference_weights(Q.quantize_tree(llm, min_dim=TINY_MIN_DIM, bits=bits),
                                 fold_norms=False)
    g, r = dict(_flat(got)), dict(_flat(ref))
    assert sorted(g, key=str) == sorted(r, key=str)
    for path, t in r.items():
        assert g[path].dtype == t.dtype and torch.equal(g[path], t), path
        assert g[path].stride() == t.stride(), path
    layers = got["layers"]
    for node in (layers["attn"]["wqkv"], layers["mlp"]["gate_up"]):
        if bits == 8:
            k = node["kernel"]
            assert k.transpose(-1, -2).is_contiguous() and not k.is_contiguous()
        else:
            assert node["kernel_q4"].is_contiguous() and "kernel" not in node


def test_bridge_keeps_int8_scales_fp32():
    q = JQ.quantize_tree({"w": {"kernel": jnp.ones((1024, 8)), "bias": jnp.ones(8)}},
                         min_dim=1024, bits=8)
    q["w"]["scale_x"] = jnp.asarray(0.5, jnp.float32)
    got = params_from_numpy(q, dtype=torch.bfloat16)["w"]
    assert got["kernel"].dtype == torch.int8 and got["bias"].dtype == torch.bfloat16
    assert got["scale_w"].dtype == torch.float32 and got["scale_x"].dtype == torch.float32


# --- the loader -----------------------------------------------------------------

def _jax_loader(params, load_in_8bit, load_vision_in_8bit):
    """The JAX loader's sequence (`experiments/robot/openvla_utils.py:181-194,
    230-249`) on a float tree, with the tiny model's min_dim.

    It runs op by op (`jax.disable_jit`): under `jit`, which its
    `quantize_tree_lowmem` uses, XLA's CPU compiler turns `absmax / 127.0`
    into `absmax * fl(1/127)`, one ulp off in some scales, so the JAX
    package's two quantizers disagree with each other there. The port
    follows `quantize_weight` as written (a division), which is what the
    JAX package computes op by op."""
    with jax.disable_jit():
        return _jax_loader_ops(dict(params), load_in_8bit, load_vision_in_8bit)


def _jax_loader_ops(params, load_in_8bit, load_vision_in_8bit):
    params["llm"] = jax_fuse(params["llm"], fold_norms=not load_in_8bit)
    vit_int8 = load_in_8bit or load_vision_in_8bit
    params["vision_backbone"] = {name: jax_fuse_vit(v, fold_norms=not vit_int8)
                                 for name, v in params["vision_backbone"].items()}
    mods = ("llm", "vision_backbone", "projector") if load_in_8bit else \
        ("vision_backbone", "projector")
    for mod in mods:
        params[mod] = JQ.quantize_tree_lowmem(params[mod], min_dim=TINY_MIN_DIM)
    return params


@pytest.mark.parametrize("flag", ["load_in_8bit", "load_vision_in_8bit"])
def test_serving_params_matches_the_jax_loader(monkeypatch, flag):
    monkeypatch.setattr(deploy, "QUANT_MIN_DIM", TINY_MIN_DIM)
    raw = _tiny_params()
    got = deploy.serving_params(params_from_numpy(raw), **{flag: True})
    ref = _jax_loader(raw, flag == "load_in_8bit", flag == "load_vision_in_8bit")
    _assert_trees_equal(got, ref)
    vit = got["vision_backbone"]["featurizer"]["layers"]
    assert "scale" in vit["norm1"] and vit["attn"]["qkv"]["kernel"].dtype == torch.int8
    llm = got["llm"]["layers"]
    assert (llm["attn"]["wqkv"]["kernel"].dtype == torch.int8) == (flag == "load_in_8bit")
    assert ("scale" in llm["attn_norm"]) == (flag == "load_in_8bit")


def test_serving_params_quant_flags_exclude_each_other():
    with pytest.raises(ValueError, match="exclude"):
        deploy.serving_params(params_from_numpy(_tiny_params()), load_in_4bit=True,
                              load_in_8bit=True)


# --- the tiny int8 serving path ---------------------------------------------------

def _int8_model():
    """The tiny L1 model through the JAX loader with load_in_8bit: every
    linear of the LLM, the ViTs and the projector in int8."""
    cfg = _tiny_cfg()
    return cfg, _jax_loader(_tiny_params(seed=11), True, False)


def _int8_products_per_request(cfg) -> int:
    """LLM: 4 linears a layer, 6 in the out_window layer; ViTs: the patch
    embedding and 4 linears in each block that runs; the projector: 3."""
    llm = 4 * (cfg.llm.num_layers - 1) + 6
    vit = sum(1 + 4 * (v.depth - 1) for v in cfg.vision_configs)
    return llm + vit + 3


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
def test_tiny_int8_predict_action_hidden_matches_jax(rng, use_flash):
    cfg, params = _int8_model()
    inputs = _model_inputs(rng, cfg)
    ref = jax_predict(params, cfg, LIBERO, **{k: jnp.asarray(v) for k, v in inputs.items()},
                      use_flash=use_flash).actions_hidden
    before = Q.int8_mm.launches
    got = predict_action_hidden(params_from_numpy(params), port_config(cfg), PLATFORM,
                                **{k: torch.from_numpy(v) for k, v in inputs.items()},
                                use_flash=use_flash).actions_hidden
    assert Q.int8_mm.launches - before == _int8_products_per_request(cfg)
    assert _rel(got.numpy(), ref) <= 1e-4


def test_tiny_int8_serve_action_chunk_matches_jax(rng):
    cfg, params = _int8_model()
    inputs = _serve_inputs(rng, cfg)
    size = cfg.vision_configs[0].image_size
    ref = jax_serve(params, cfg, LIBERO, **{k: jnp.asarray(v) for k, v in inputs.items()},
                    use_flash=True, resize_size=size)
    before = Q.int8_mm.launches
    got = serve_action_chunk(params_from_numpy(params), port_config(cfg), PLATFORM,
                             **{k: torch.from_numpy(v) for k, v in inputs.items()},
                             use_flash=True, resize_size=size)
    assert Q.int8_mm.launches - before == _int8_products_per_request(cfg)
    assert got.shape == (1, LIBERO.num_actions_chunk, LIBERO.action_dim)
    assert _rel(got.numpy(), ref) <= 1e-4


def test_port_built_int8_policy_serves(rng, monkeypatch):
    """flagship_policy's path at the tiny size: `serving_params` in the port
    (its column-major int8 kernels) inside OpenVLAPolicy; the answer equals
    the JAX-built tree's through the same policy."""
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy

    monkeypatch.setattr(deploy, "QUANT_MIN_DIM", TINY_MIN_DIM)
    cfg = port_config(_tiny_cfg())
    frames = (rng.random((2, 36, 36, 3)) * 255).astype(np.uint8)
    raw = params_from_numpy(_tiny_params(seed=5))
    answers = []
    for params in (deploy.serving_params(raw, load_in_8bit=True),
                   params_from_numpy(_jax_loader(_tiny_params(seed=5), True, False))):
        policy = OpenVLAPolicy(cfg=cfg, platform=PLATFORM, params=params,
                               norm_stats=deploy.placeholder_norm_stats(PLATFORM),
                               prompt_bucket=16)
        answers.append(policy.predict_action_from_frames(frames, "open the drawer"))
    assert answers[0].shape == (LIBERO.num_actions_chunk, LIBERO.action_dim)
    np.testing.assert_array_equal(answers[0], answers[1])


# --- static activation scales ------------------------------------------------------

def _jax_observations(cfg, n=2, seed=3):
    return JC.random_observations(cfg, LIBERO, n=n, seed=seed)


def _port_observations(obs):
    return [{k: params_from_numpy(v) for k, v in o.items()} for o in obs]


def test_random_observations_match_jax():
    cfg = _tiny_cfg()
    ref = _jax_observations(cfg, n=3, seed=7)
    got = QC.random_observations(port_config(cfg), PLATFORM, n=3, seed=7, device="cpu")
    for r, g in zip(ref, got):
        assert list(r) == list(g)
        for key in r:
            assert g[key].dtype == params_from_numpy(r[key]).dtype, key
            assert torch.equal(g[key], params_from_numpy(r[key])), key


def _unfused_int8(seed=0):
    """The tiny model with only its LLM quantized, unfused (as
    tests/test_quant.py::test_attach_static_act_scales_end_to_end)."""
    params = _tiny_params(seed=seed)
    params["llm"] = JQ.quantize_tree(params["llm"], min_dim=TINY_MIN_DIM)
    return params


def test_attach_static_act_scales_matches_jax():
    cfg = _tiny_cfg()
    params = _unfused_int8()
    obs = _jax_observations(cfg)
    ref = JC.attach_static_act_scales(params, cfg, LIBERO, obs)
    got = QC.attach_static_act_scales(params_from_numpy(params), port_config(cfg), PLATFORM,
                                      _port_observations(obs))
    n = 0
    for group in ("attn", "mlp"):
        for key, node in ref["llm"]["layers"][group].items():
            r = np.asarray(node["scale_x"])
            g = got["llm"]["layers"][group][key]["scale_x"]
            assert g.dtype == torch.float32 and g.shape == r.shape == (cfg.llm.num_layers,)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=0)
            n += 1
    assert n == 7                                     # wq wk wv wo gate up down
    o = obs[0]
    ref_h = jax_predict(ref, cfg, LIBERO, input_ids=o["input_ids"],
                        prompt_mask=o["prompt_mask"], pixels=o["pixels"],
                        proprio=o["proprio"]).actions_hidden
    po = _port_observations(obs)[0]
    got_h = predict_action_hidden(got, port_config(cfg), PLATFORM, po["input_ids"],
                                  po["prompt_mask"], po["pixels"],
                                  proprio=po["proprio"]).actions_hidden
    assert _rel(got_h.numpy(), ref_h) <= 1e-4


def test_fused_static_scales_through_the_out_window_layer():
    """The reference's fault, repaired in the port: with static scales on a
    fused tree (wqkv), the out_window layer's column slices cut the 0-d
    scale_x and the JAX package raises. The port passes it unsliced, and the
    fused tree's answer is the unfused tree's."""
    cfg = _tiny_cfg()
    pcfg = port_config(cfg)
    raw = _tiny_params(seed=0)
    fused = dict(raw)
    fused["llm"] = JQ.quantize_tree(jax_fuse(raw["llm"], fold_norms=False),
                                    min_dim=TINY_MIN_DIM)
    o = _jax_observations(cfg)[0]
    jax_fused = dict(fused)
    jax_fused["llm"] = JC.attach_placeholder_act_scales(fused["llm"])
    with pytest.raises(IndexError):
        jax_predict(jax_fused, cfg, LIBERO, input_ids=o["input_ids"],
                    prompt_mask=o["prompt_mask"], pixels=o["pixels"], proprio=o["proprio"])

    obs = _port_observations(_jax_observations(cfg))
    hidden = {}
    for name, tree in (("unfused", _unfused_int8()), ("fused", fused)):
        calibrated = QC.attach_static_act_scales(params_from_numpy(tree), pcfg, PLATFORM, obs)
        hidden[name] = predict_action_hidden(calibrated, pcfg, PLATFORM, obs[0]["input_ids"],
                                             obs[0]["prompt_mask"], obs[0]["pixels"],
                                             proprio=obs[0]["proprio"]).actions_hidden
    assert calibrated["llm"]["layers"]["attn"]["wqkv"]["scale_x"].shape == \
        (cfg.llm.num_layers,)
    assert torch.isfinite(hidden["fused"]).all()
    assert _rel(hidden["fused"].numpy(), hidden["unfused"].numpy()) <= 1e-5


def test_placeholder_scales_match_jax():
    llm = _unfused_int8()["llm"]
    ref = JC.attach_placeholder_act_scales(llm, value=0.03)
    got = QC.attach_placeholder_act_scales(params_from_numpy(llm), value=0.03)
    _assert_trees_equal(got, ref)


def test_collect_act_stats_needs_the_full_forward():
    from openvla_oft_tpu_torch.models.llama import llama_model

    params = params_from_numpy(_unfused_int8())
    cfg = port_config(_tiny_cfg()).llm
    x = torch.zeros((1, 6, cfg.hidden_size))
    with pytest.raises(ValueError, match="calibration-only"):
        llama_model(params["llm"], cfg, x, out_window=(2, 3), collect_act_stats=True)


# --- calibration reports ---------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_weight_quant_errors_match_jax(bits):
    llm = _tiny_params()["llm"]
    ref = JC.weight_quant_errors(llm, min_dim=TINY_MIN_DIM, bits=bits)
    got = QC.weight_quant_errors(params_from_numpy(llm), min_dim=TINY_MIN_DIM, bits=bits)
    assert sorted(got) == sorted(ref) and len(got) == 7
    for path, errs in ref.items():
        np.testing.assert_allclose(got[path], errs, rtol=1e-5)


def test_calibrate_report():
    """The report's two modes agree exactly (quantize beside the float tree,
    or in place after the float pass), and its weight errors are
    `weight_quant_errors`' (held against the JAX package above). The
    activation and action statistics are not held against the JAX
    package's: on random tiny weights the two frameworks' float ops differ
    by an ulp, which flips an int8 code wherever x / sx lies within about
    1e-5 of a half, and one flipped code moves these statistics by about 1%
    (seen in SigLIP's second block on one of these observations); the
    stages themselves are held against JAX by the tiny serving tests."""
    cfg = port_config(_tiny_cfg())
    params = _tiny_params(seed=2)
    obs = _port_observations(_jax_observations(_tiny_cfg()))
    reports = [QC.calibrate(cfg, PLATFORM, params_from_numpy(params), obs,
                            min_dim=TINY_MIN_DIM, low_memory=low_memory)
               for low_memory in (False, True)]
    assert reports[0] == reports[1]
    report = reports[0]
    errs = [e for mod in ("llm", "vision_backbone", "projector")
            for es in QC.weight_quant_errors(params_from_numpy(params)[mod],
                                             min_dim=TINY_MIN_DIM).values() for e in es]
    assert report["weight_error"]["max"] == max(errs)
    assert report["n_observations"] == 2 and report["bits"] == 8
    for group in ("activation_rel_error", "action_l1"):
        assert all(0 < v < 0.5 for v in report[group].values()), report[group]
    assert set(report["verdict"]) == {"below_discrete_floor", "below_train_floor"}


def test_calibrate_script_runs_tiny(tmp_path, capsys):
    import json

    from openvla_oft_tpu_torch.scripts import calibrate_quant

    out = tmp_path / "report.json"
    report = calibrate_quant.main(["--vla_path", "random:tiny", "--device", "cpu",
                                   "--n_observations", "1", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert report["bits"] == 8 and np.isfinite(report["action_l1"]["mean"])
    # a checkpoint dir loads (tests/test_torch_checkpoint.py); a hub id is refused
    with pytest.raises(FileNotFoundError, match="local checkpoint directory"):
        calibrate_quant.main(["--vla_path", "some/checkpoint", "--device", "cpu"])


# --- the deploy CLI ---------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--load-in-8bit", "--load-in-4bit"],
                                   ["--load-in-8bit", "--load-vision-in-8bit"],
                                   ["--load-vision-in-8bit", "--load-in-4bit"],
                                   ["--load-in-8bit", "--int4-a8"]],
                         ids=["8bit+4bit", "8bit+vision8bit", "vision8bit+4bit", "8bit+a8"])
def test_deploy_cli_quant_flag_rules(flags, capsys):
    with pytest.raises(SystemExit):
        deploy.main(["--random-weights", "--device", "cpu", *flags])
    assert "--" in capsys.readouterr().err


def test_deploy_cli_passes_the_int8_flags(monkeypatch):
    """--load-in-8bit and --load-vision-in-8bit reach flagship_policy; the
    device defaults to the card."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_policy(device, **kwargs):
        seen.update(kwargs, device=device)
        raise Stop

    monkeypatch.setattr(deploy, "flagship_policy", fake_policy)
    for flag, key in (("--load-in-8bit", "load_in_8bit"),
                      ("--load-vision-in-8bit", "load_vision_in_8bit")):
        seen.clear()
        with pytest.raises(Stop):
            deploy.main(["--random-weights", flag])
        assert seen["device"] == "cuda" and seen[key] is True
        other = ({"load_in_8bit", "load_vision_in_8bit", "load_in_4bit"} - {key})
        assert not any(seen[k] for k in other)
