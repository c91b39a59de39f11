"""Port parity for int4 serving: quantization, the plain versions of K5 and
K6, their gradient, the dispatch rule, `quantize_tree` and the tiny int4
serving path, against the JAX package on the CPU.

Inputs are numpy arrays from a seed. The JAX side's fused kernels run in
Pallas interpret mode, as `tests/test_int4_fused.py` runs them; the port's
wrappers take their plain versions on CPU tensors. Tolerances:
- packed bytes, scales, groups and unpacked nibbles: exact;
- W4A16 in fp32: rtol 1e-5 with atol 1e-5 * max|ref| (the same fp32
  products summed in another order, over up to 600 terms);
- W4A8: rtol 1e-6 with atol 1e-6 * max|ref| (each group's integer product is
  exact in fp32, since 127 * 7 * 128 < 2**24; only the fp32 sum over groups
  can differ);
- the tiny model in fp32: max|d| <= 1e-4 * max|ref|.
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
from openvla_oft_tpu.ops import int4_matmul as JM
from openvla_oft_tpu.ops import quant as JQ
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.policy import serve_action_chunk as jax_serve
from openvla_oft_tpu_torch.bridge import index_layer, params_from_numpy, tree_leaves
from openvla_oft_tpu_torch.models.llama import fuse_inference_weights
from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden
from openvla_oft_tpu_torch.ops import int4_matmul as M
from openvla_oft_tpu_torch.ops import quant as Q
from openvla_oft_tpu_torch.ops.layers import linear
from openvla_oft_tpu_torch.policy import serve_action_chunk
from test_torch_import import port_config, port_platform

torch.backends.cuda.matmul.allow_tf32 = False

FP32 = dict(rtol=1e-5)
A8 = dict(rtol=1e-6)


def _close(got, ref, rtol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _both(w):
    """quantize_weight_int4 on both sides: (JAX dict, port dict)."""
    return (JQ.quantize_weight_int4(jnp.asarray(w)),
            Q.quantize_weight_int4(torch.from_numpy(w)))


# --- quantization -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(256, 96), (3, 256, 64), (4304, 8), (200, 24), (96, 40)],
                         ids=["flat", "stacked", "d4304-group16", "d200", "d96"])
def test_quantize_weight_int4_bit_equal(rng, shape):
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w.flat[::17] = 0.0                                 # exact zeros and ties of |w|
    ref, got = _both(w)
    assert got["kernel_q4"].dtype == torch.int8 and got["scale_w4"].dtype == torch.float32
    np.testing.assert_array_equal(got["kernel_q4"].numpy(), np.asarray(ref["kernel_q4"]))
    np.testing.assert_array_equal(got["scale_w4"].numpy(), np.asarray(ref["scale_w4"]))


def test_group_for_every_d_in():
    assert Q._int4_group_for(4304) == 16
    assert [Q._int4_group_for(d) for d in range(2, 5001)] == \
        [JQ._int4_group_for(d) for d in range(2, 5001)]


def test_unpack_int4_exact(rng):
    packed = rng.integers(-128, 128, (3, 40, 24), dtype=np.int8)
    np.testing.assert_array_equal(Q._unpack_int4(torch.from_numpy(packed)).numpy(),
                                  np.asarray(JQ._unpack_int4(jnp.asarray(packed))))


def test_odd_d_in_is_refused():
    with pytest.raises(ValueError, match="even"):
        Q.quantize_weight_int4(torch.zeros((7, 4)))


# --- K5 and K6, plain versions against the JAX kernels in interpret mode ----

MATMUL_CASES = [(112, 256, 384), (5, 130, 64), (16, 4304 % 512 + 256, 128), (600, 256, 128)]


@pytest.mark.parametrize("t,k,n", MATMUL_CASES)
def test_w4a16_matches_jax_fused(rng, t, k, n):
    """The (t, k, n) cases of tests/test_int4_fused.py, fp32."""
    k += k % 2
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((t, k)).astype(np.float32)
    ref_q, q = _both(w)
    ref = JM.int4_matmul_fused(jnp.asarray(x), ref_q["kernel_q4"], ref_q["scale_w4"])
    xt = torch.from_numpy(x)
    for fn in (M.int4_matmul_ref, M.int4_matmul_fused):
        got = fn(xt, q["kernel_q4"], q["scale_w4"])
        assert got.dtype == torch.float32 and got.shape == (t, n)
        _close(got, ref, **FP32)


def test_w4a16_layer_views_match_jax_stacked(rng):
    L, k, n, t = 3, 512, 256, 7
    w = (rng.standard_normal((L, k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((t, k)).astype(np.float32)
    ref_q, q = _both(w)
    for layer in range(L):
        ref = JM.int4_matmul_fused_stacked(jnp.asarray(x), ref_q["kernel_q4"],
                                           ref_q["scale_w4"], jnp.asarray(layer))
        got = M.int4_matmul_fused(torch.from_numpy(x), q["kernel_q4"][layer],
                                  q["scale_w4"][layer])
        _close(got, ref, **FP32)


@pytest.mark.parametrize("t,k,n", [(112, 256, 384), (5, 128, 128), (600, 256, 128),
                                   (8, 2048, 128)])
def test_w4a8_matches_jax_fused(rng, t, k, n):
    """The cases of tests/test_int4_fused.py's W4A8 tests (16 groups in the last)."""
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((t, k)).astype(np.float32)
    ref_q, q = _both(w)
    ref = JM.int4_matmul_fused_a8(jnp.asarray(x), ref_q["kernel_q4"], ref_q["scale_w4"])
    xt = torch.from_numpy(x)
    for fn in (M.int4_matmul_a8_ref, M.int4_matmul_fused_a8):
        got = fn(xt, q["kernel_q4"], q["scale_w4"])
        assert got.dtype == torch.float32 and got.shape == (t, n)
        _close(got, ref, **A8)


def test_w4a8_layer_views_match_jax_stacked(rng):
    L, k, n = 3, 256, 128
    w = (rng.standard_normal((L, k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((7, k)).astype(np.float32)
    ref_q, q = _both(w)
    for layer in range(L):
        ref = JM.int4_matmul_fused_stacked_a8(jnp.asarray(x), ref_q["kernel_q4"],
                                              ref_q["scale_w4"], jnp.asarray(layer))
        got = M.int4_matmul_fused_a8(torch.from_numpy(x), q["kernel_q4"][layer],
                                     q["scale_w4"][layer])
        _close(got, ref, **A8)


def test_batch_dims_flatten(rng):
    w = (rng.standard_normal((128, 64)) * 0.05).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((2, 3, 128)).astype(np.float32))
    q = Q.quantize_weight_int4(torch.from_numpy(w))
    for fn in (M.int4_matmul_fused, M.int4_matmul_fused_a8):
        out = fn(x, q["kernel_q4"], q["scale_w4"])
        assert out.shape == (2, 3, 64)
        torch.testing.assert_close(out.reshape(6, 64),
                                   fn(x.reshape(6, 128), q["kernel_q4"], q["scale_w4"]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("a8", [False, True], ids=["w4a16", "w4a8"])
def test_input_gradient_matches_jax_fused_bwd(rng, a8):
    """d/dx of sum(y * G) through the straight-through backward (the JAX
    `_fused_bwd`): G (bf16-rounded) times the bf16 dequantized weight."""
    k, n, t = 256, 96, 6
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((t, k)).astype(np.float32)
    g = rng.standard_normal((t, n)).astype(np.float32)
    ref_q, q = _both(w)
    jfn = JM.int4_matmul_fused_a8 if a8 else JM.int4_matmul_fused
    ref = jax.grad(lambda xx: jnp.sum(jfn(xx, ref_q["kernel_q4"], ref_q["scale_w4"])
                                      * jnp.asarray(g)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    fn = M.int4_matmul_fused_a8 if a8 else M.int4_matmul_fused
    (fn(xt, q["kernel_q4"], q["scale_w4"]) * torch.from_numpy(g)).sum().backward()
    _close(xt.grad, ref, **FP32)


# --- the dispatch rule and the linear ---------------------------------------

def _spy(monkeypatch):
    """Records which of the three functions int4_linear called (the fused
    wrappers call their plain version on the CPU; that inner call is not
    recorded)."""
    calls, depth = [], [0]

    def wrap(fn, name):
        def spy(*args):
            if not depth[0]:
                calls.append(name)
            depth[0] += 1
            try:
                return fn(*args)
            finally:
                depth[0] -= 1
        return spy

    for name in ("int4_matmul_fused", "int4_matmul_fused_a8", "int4_matmul_ref",
                 "int4_matmul_a8_ref"):
        monkeypatch.setattr(M, name, wrap(getattr(M, name), name))
    return calls


@pytest.mark.parametrize("rows,d_in,expect", [
    (4, 64, "int4_matmul_fused"),            # small batch: the fused kernel
    (1024, 64, "int4_matmul_fused"),         # the row limit itself
    (1030, 64, "int4_matmul_ref"),           # above it: dequant first
    (4, 4304, "int4_matmul_fused"),          # group 16 -> g2 = 8
    (4, 200, "int4_matmul_ref"),             # group 100 -> g2 = 50, not a multiple of 8
])
def test_linear_dispatch_thresholds(rng, monkeypatch, rows, d_in, expect):
    """Mirrors tests/test_int4_fused.py::test_linear_dispatch_thresholds: the
    port takes the branch the JAX package takes, and the numbers agree."""
    w = (rng.standard_normal((d_in, 32)) * 0.05).astype(np.float32)
    x = rng.standard_normal((rows, d_in)).astype(np.float32)
    ref_q, q = _both(w)
    ref = JQ.int4_linear(ref_q, jnp.asarray(x))
    calls = _spy(monkeypatch)
    got = linear(q, torch.from_numpy(x))
    assert calls == [expect]
    _close(got, ref, **FP32)


def test_linear_w4a8_inside_the_context(rng, monkeypatch):
    """int4_a8() routes the fused branch to K6, as OPENVLA_INT4_A8=1 does in
    the JAX package; the dequant branch stays W4A16 in both."""
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    ref_q, q = _both(w)
    monkeypatch.setenv("OPENVLA_INT4_A8", "1")
    ref = JQ.int4_linear(ref_q, jnp.asarray(x))
    calls = _spy(monkeypatch)
    with Q.int4_a8():
        got = linear(q, torch.from_numpy(x))
        big = linear(q, torch.from_numpy(np.tile(x, (130, 1))))
    assert calls == ["int4_matmul_fused_a8", "int4_matmul_ref"]
    _close(got, ref, **A8)
    assert not Q._INT4_A8.get()                      # the context is left as found
    _close(big[:8], JQ.int4_linear(ref_q, jnp.asarray(np.tile(x, (130, 1))))[:8], **FP32)


def test_linear_bias_and_dtype(rng):
    """The bias adds in fp32 and the result takes x's dtype. With bf16 x the
    weight is rounded to bf16 before the product, as on the TPU and in the
    JAX dequant path (`_int4_matmul_xla`); the JAX kernel's interpret mode
    keeps it fp32, so bf16 is held against the dequant path."""
    w = (rng.standard_normal((128, 64)) * 0.05).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    ref_q, q = _both(w)
    jp, tp = {**ref_q, "bias": jnp.asarray(bias)}, {**q, "bias": torch.from_numpy(bias)}
    got = linear(tp, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, JQ.int4_linear(jp, jnp.asarray(x)), **FP32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = (JQ._int4_matmul_xla(xb, ref_q["kernel_q4"], ref_q["scale_w4"])
           + jnp.asarray(bias)).astype(jnp.bfloat16)
    got = linear(tp, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_stacked_weight_must_be_indexed():
    q = Q.quantize_weight_int4(torch.zeros((2, 64, 32)))
    with pytest.raises(ValueError, match="index_layer"):
        Q.int4_linear(q, torch.zeros((3, 64)))


# --- trees, layer views, the bridge ------------------------------------------

def _tiny_llm():
    cfg = C.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama")
    return init_openvla_params(jax.random.PRNGKey(3), cfg, LIBERO, dtype=jnp.float32,
                               head="l1")["llm"]


def _flat(tree, prefix=()):
    """[(key path, leaf)] of a nested dict (and list) tree, in insertion order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flat(v, prefix + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _flat(v, prefix + (i,))]
    return [(prefix, tree)]


def test_quantize_tree_matches_jax():
    """Same keys, same bytes and scales; the embedding, norms and lm_head stay."""
    llm = jax_fuse(_tiny_llm(), fold_norms=False)
    ref = JQ.quantize_tree(llm, min_dim=64, bits=4)
    got = Q.quantize_tree(params_from_numpy(llm), min_dim=64, bits=4)
    ref_leaves, got_leaves = _flat(ref), _flat(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    assert sum("kernel_q4" in p for p, _ in got_leaves) == 4      # wqkv wo gate_up down
    for (path, r), (_, g) in zip(ref_leaves, got_leaves):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=str(path))
    assert "lm_head" in got and "kernel" in got["lm_head"]


def test_quantize_tree_bits8_matches_jax():
    """bits=8 (ported since item 9): the same keys, int8 codes and fp32
    scales as the JAX package's int8 tree; lm_head, the embedding and the
    norms stay float."""
    llm = jax_fuse(_tiny_llm(), fold_norms=False)
    ref = JQ.quantize_tree(llm, min_dim=64, bits=8)
    got = Q.quantize_tree(params_from_numpy(llm), min_dim=64, bits=8)
    ref_leaves, got_leaves = _flat(ref), _flat(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    assert sum(p[-1] == "scale_w" for p, _ in got_leaves) == 4     # wqkv wo gate_up down
    for (path, r), (_, g) in zip(ref_leaves, got_leaves):
        assert g.dtype == params_from_numpy(r).dtype, path
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=str(path))
    assert got["lm_head"]["kernel"].is_floating_point()


def test_index_layer_gives_int4_views(rng):
    """The JAX `_has_int4` / `_index_layer` pair collapses into index_layer:
    layer l of an int4 tree is a view of the stacked leaves (no copy), it
    recurses into nested dicts beside a packed kernel, and the linear on it
    equals the JAX stacked kernel at layer l."""
    L, k, n = 3, 256, 128
    w = (rng.standard_normal((L, k, n)) * 0.05).astype(np.float32)
    ref_q, q = _both(w)
    layers = {"attn": {"wq": {**q, "extra": {"sub": torch.arange(L * 2.0).reshape(L, 2)}}},
              "plain": {"kernel": torch.arange(L * 4.0).reshape(L, 4)}}
    x = rng.standard_normal((5, k)).astype(np.float32)
    for layer in range(L):
        lp = index_layer(layers, layer)
        wq = lp["attn"]["wq"]
        for name in ("kernel_q4", "scale_w4"):
            stacked = layers["attn"]["wq"][name]
            assert wq[name].untyped_storage().data_ptr() == \
                stacked.untyped_storage().data_ptr()
            assert torch.equal(wq[name], stacked[layer])
        assert wq["extra"]["sub"].tolist() == [2.0 * layer, 2.0 * layer + 1]
        assert lp["plain"]["kernel"].tolist() == [4.0 * layer + i for i in range(4)]
        ref = JM.int4_matmul_fused_stacked(jnp.asarray(x), ref_q["kernel_q4"],
                                           ref_q["scale_w4"], jnp.asarray(layer))
        _close(linear({k_: wq[k_] for k_ in ("kernel_q4", "scale_w4")}, torch.from_numpy(x)),
               ref, **FP32)


def test_column_views_match_slices(rng):
    """The out_window layer's q/k/v column views of an int4 wqkv give what
    the JAX package's column slices give."""
    w = (rng.standard_normal((128, 192)) * 0.05).astype(np.float32)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    ref_q, q = _both(w)
    for lo, hi in ((0, 64), (64, 128), (128, 192)):
        view = {name: leaf[..., lo:hi] for name, leaf in q.items()}
        assert view["kernel_q4"].stride(0) == 192
        ref = JQ.int4_linear({name: leaf[..., lo:hi] for name, leaf in ref_q.items()},
                             jnp.asarray(x))
        _close(linear(view, torch.from_numpy(x)), ref, **FP32)


def test_bridge_keeps_group_scales_fp32():
    q = JQ.quantize_tree({"w": {"kernel": jnp.ones((1024, 8)), "bias": jnp.ones(8)}},
                         min_dim=1024, bits=4)
    got = params_from_numpy(q, dtype=torch.bfloat16)["w"]
    assert got["scale_w4"].dtype == torch.float32 and got["kernel_q4"].dtype == torch.int8
    assert got["bias"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["scale_w4"].numpy(), np.asarray(q["w"]["scale_w4"]))


# --- the tiny int4 serving path -----------------------------------------------

# A 2-layer Llama whose int4 shapes the JAX package's stacked kernels take
# (`supports_stacked_fused`: its TPU tiling rules need K/2 and N in whole
# 128-lane tiles). Narrower layers would send the JAX side's stacked layers to
# its dequant path, which is W4A16 even under OPENVLA_INT4_A8, while the port
# takes its 2-D rule on every layer view.
C._LLM_REGISTRY.setdefault("int4-test-llama", C.LlamaConfig(
    vocab_size=32064, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=2,
    num_kv_heads=2))


def _int4_model():
    """Tiny L1 model, LLM fused without the norm folds and packed to int4 by
    the JAX package (min_dim 64: every LLM linear)."""
    cfg = C.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="int4-test-llama",
                          num_images_in_input=2)
    params = dict(init_openvla_params(jax.random.PRNGKey(11), cfg, LIBERO,
                                      dtype=jnp.float32, head="l1"))
    params["llm"] = JQ.quantize_tree(jax_fuse(params["llm"], fold_norms=False),
                                     min_dim=64, bits=4)
    return cfg, params


def _model_inputs(rng, cfg):
    h = cfg.vision_configs[0].image_size
    ids = np.zeros((2, 16), np.int32)
    mask = np.zeros((2, 16), np.int32)
    for r, n in enumerate((10, 16)):
        ids[r, 16 - n:] = [1] + list(rng.integers(10, 1000, n - 2)) + [29871]
        mask[r, 16 - n:] = 1
    return dict(input_ids=ids, prompt_mask=mask,
                pixels=rng.random((2, 2, 2, h, h, 3)).astype(np.float32),
                proprio=rng.random((2, LIBERO.proprio_dim)).astype(np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
def test_tiny_int4_predict_action_hidden_matches_jax(rng, use_flash):
    cfg, params = _int4_model()
    inputs = _model_inputs(rng, cfg)
    ref = jax_predict(params, cfg, LIBERO, **{k: jnp.asarray(v) for k, v in inputs.items()},
                      use_flash=use_flash).actions_hidden
    tp = params_from_numpy(params)
    assert tp["llm"]["layers"]["mlp"]["down"]["scale_w4"].dtype == torch.float32
    got = predict_action_hidden(tp, port_config(cfg), port_platform(LIBERO),
                                **{k: torch.from_numpy(v) for k, v in inputs.items()},
                                use_flash=use_flash).actions_hidden
    assert _rel(got.numpy(), ref) <= 1e-4


def _serve_inputs(rng, cfg):
    """Frames of one colour each: the lanczos resize of a constant image is
    that constant on both sides, so the two preprocessings agree exactly
    (on textured frames they may differ by one uint8 step in 0.1% of the
    pixels, tests/test_torch_serve.py, which the tiny model amplifies)."""
    size = cfg.vision_configs[0].image_size
    d, pd = LIBERO.action_dim, LIBERO.proprio_dim
    colours = rng.integers(0, 256, (1, 2, 1, 1, 3))
    bucket, real = 16, [1] + list(rng.integers(10, 1000, 8)) + [29871]
    ids = np.zeros((1, bucket), np.int32)
    mask = np.zeros((1, bucket), np.int32)
    ids[0, bucket - len(real):] = real
    mask[0, bucket - len(real):] = 1
    return dict(frames_u8=np.broadcast_to(colours, (1, 2, size + 12, size + 12, 3)
                                          ).astype(np.uint8),
                input_ids=ids, prompt_mask=mask,
                proprio=(rng.random((1, pd)) * 3 - 1).astype(np.float32),
                action_low=np.linspace(-0.9, -0.2, d).astype(np.float32),
                action_high=np.linspace(0.2, 0.9, d).astype(np.float32),
                action_mask=np.asarray([True] * (d - 1) + [False]),
                proprio_low=np.full((pd,), -1.5, np.float32),
                proprio_high=np.full((pd,), 2.5, np.float32))


@pytest.mark.parametrize("a8", [False, True], ids=["w4a16", "w4a8"])
def test_tiny_int4_serve_action_chunk_matches_jax(rng, monkeypatch, a8):
    """The whole serving hot path on the JAX-quantized tree. W4A8 on the JAX
    side is its environment switch, on the port's the `int4_a8` argument."""
    cfg, params = _int4_model()
    inputs = _serve_inputs(rng, cfg)
    size = cfg.vision_configs[0].image_size
    monkeypatch.setenv("OPENVLA_INT4_A8", "1" if a8 else "0")
    ref = jax_serve(params, cfg, LIBERO, **{k: jnp.asarray(v) for k, v in inputs.items()},
                    use_flash=True, resize_size=size)
    calls = _spy(monkeypatch)
    got = serve_action_chunk(params_from_numpy(params), port_config(cfg), port_platform(LIBERO),
                             **{k: torch.from_numpy(v) for k, v in inputs.items()},
                             use_flash=True, resize_size=size, int4_a8=a8)
    n_layers = cfg.llm.num_layers
    expect = "int4_matmul_fused_a8" if a8 else "int4_matmul_fused"
    assert calls == [expect] * (4 * (n_layers - 1) + 6)   # 4 per layer, 6 in the window layer
    assert got.shape == (1, LIBERO.num_actions_chunk, LIBERO.action_dim)
    assert _rel(got.numpy(), ref) <= 1e-4


def test_quantizing_in_the_port_gives_the_same_tree():
    cfg, params = _int4_model()
    raw = dict(init_openvla_params(jax.random.PRNGKey(11), cfg, LIBERO, dtype=jnp.float32,
                                   head="l1"))["llm"]
    ported = Q.quantize_tree(fuse_inference_weights(params_from_numpy(raw), fold_norms=False),
                             min_dim=64, bits=4)
    ref = params_from_numpy(params["llm"])
    assert len(tree_leaves(ported)) == len(tree_leaves(ref))
    for a, b in zip(tree_leaves(ported), tree_leaves(ref)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_policy_int4_a8_reaches_the_kernels(rng, monkeypatch):
    """OpenVLAPolicy(int4_a8=True) serves W4A8; the default serves W4A16."""
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats

    cfg, params = _int4_model()
    platform = port_platform(LIBERO)
    frames = (rng.random((2, 36, 36, 3)) * 255).astype(np.uint8)
    out = {}
    for a8 in (False, True):
        policy = OpenVLAPolicy(cfg=port_config(cfg), platform=platform,
                               params=params_from_numpy(params),
                               norm_stats=placeholder_norm_stats(platform), prompt_bucket=16,
                               int4_a8=a8)
        calls = _spy(monkeypatch)
        out[a8] = policy.predict_action_from_frames(frames, "open the drawer")
        assert set(calls) == {"int4_matmul_fused_a8" if a8 else "int4_matmul_fused"}
        monkeypatch.undo()
    assert np.abs(out[True] - out[False]).max() < 0.1


def test_deploy_cli_int4_flags():
    from openvla_oft_tpu_torch.serving import deploy

    with pytest.raises(SystemExit):
        deploy.main(["--random-weights", "--int4-a8", "--device", "cpu"])
    with pytest.raises(ValueError, match="load_in_4bit"):
        deploy.flagship_policy("cpu", int4_a8=True)
