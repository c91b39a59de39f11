"""Port parity for discrete action decoding: `lm_logits`, the KV cache's
decode step, the autoregressive greedy decode, `detokenize_discrete_actions`,
the discrete policy's parallel decode, the logits of the serving prefill and
of the training forward, the param tree, the serving quantization's lm_head
and the AR bench script, against the JAX package on the CPU.

Inputs are numpy arrays from a seed and bridged JAX weights, in fp32, at the
TINY configs (int8 and int4 at a 2-layer Llama whose int4 shapes the JAX
package's kernels take); each side gets its own config (`port_config`).
Tolerances:
- `lm_logits`, fp32 and bf16 operands (fp32 out): atol 1e-5;
- `detokenize_discrete_actions`: exact;
- the prefill and each decode step against the full forward and against
  JAX's decode on the same cache: atol 1e-5, as tests/test_llama_parity.py;
- `predict_action_autoregressive`: tokens equal to JAX's and to a no-cache
  greedy loop's, each step's logits within atol 1e-4 of the no-cache loop's
  (fp32), or max|d| <= 1e-4 * max|ref| on int8 and int4 trees, as the
  port's int8 and int4 slices hold their tiny models. Each run prints its
  smallest top-2 logit gap, so that a flip can be told from a tie;
- the discrete policy: normalized actions equal, un-normalized within 1e-6;
- the logits of `predict_action_hidden` and `prismatic_forward`: atol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvla_oft_tpu.config as C
from openvla_oft_tpu.config import OpenVLAConfig
from openvla_oft_tpu.constants import EMPTY_TOKEN_ID, LIBERO
from openvla_oft_tpu.models import llama as JL
from openvla_oft_tpu.models import prismatic as JP
from openvla_oft_tpu.ops import quant as JQ
from openvla_oft_tpu.policy import OpenVLAPolicy as JaxPolicy
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu_torch import bridge
from openvla_oft_tpu_torch.bridge import params_from_numpy
from openvla_oft_tpu_torch.models import llama as L
from openvla_oft_tpu_torch.models import prismatic as P
from openvla_oft_tpu_torch.ops import int4_matmul as M
from openvla_oft_tpu_torch.ops import quant as Q
from openvla_oft_tpu_torch.policy import OpenVLAPolicy
from openvla_oft_tpu_torch.serving import deploy
from test_torch_import import port_config, port_platform
from test_training import CFG as TRAIN_CFG
from test_training import _batch

torch.backends.cuda.matmul.allow_tf32 = False

CFG = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                    num_images_in_input=1)
TIGHT = dict(atol=1e-5, rtol=1e-5)
# A 2-layer Llama whose int4 shapes the JAX package's stacked kernels take
# (as tests/test_torch_diffusion.py's).
C._LLM_REGISTRY.setdefault("int4-test-llama", C.LlamaConfig(
    vocab_size=32064, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=2,
    num_kv_heads=2))
QUANT_CFG = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="int4-test-llama",
                          num_images_in_input=1)


def _discrete_tree(cfg, seed=0) -> dict:
    """The JAX discrete tree: head=None, with the lm_head, fp32 (jitted: one
    compile instead of one per op)."""
    init = jax.jit(lambda key: init_openvla_params(key, cfg, LIBERO, dtype=jnp.float32,
                                                   head=None, with_lm_head=True))
    return dict(init(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def discrete_params():
    return _discrete_tree(CFG)


@pytest.fixture(scope="module")
def quant_float_params():
    return _discrete_tree(QUANT_CFG, seed=12)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _top2_gap(logits) -> float:
    """The smallest gap between the largest and second-largest logit over
    every row and step."""
    top = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return float((top[..., 1] - top[..., 0]).min())


# --- lm_logits and the de-tokenizer -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_logits_matches_jax(discrete_params, dtype):
    """fp32 logits from fp32 or bf16 operands (JAX
    `preferred_element_type=float32`; on the CPU the port upcasts both); a
    biased lm_head (Phi-2's) adds its bias in fp32, as JAX's
    `prismatic.lm_logits` does."""
    rng = np.random.default_rng(1)
    kernel = discrete_params["llm"]["lm_head"]["kernel"]
    hidden = rng.standard_normal((2, 5, CFG.llm_dim)).astype(np.float32)
    j_llm = {"lm_head": {"kernel": jnp.asarray(kernel, dtype)}}
    want = JL.lm_logits(j_llm, jnp.asarray(hidden, dtype))
    p_llm = params_from_numpy(j_llm)
    assert p_llm["lm_head"]["kernel"].dtype == getattr(torch, dtype)
    got = P.lm_logits(p_llm, torch.from_numpy(hidden).to(getattr(torch, dtype)))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert got.shape == (2, 5, CFG.llm.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    bias = rng.standard_normal(CFG.llm.vocab_size).astype(np.float32)
    want = JP.lm_logits({"lm_head": {**j_llm["lm_head"], "bias": jnp.asarray(bias, dtype)}},
                        jnp.asarray(hidden, dtype))
    got = P.lm_logits({"lm_head": {**p_llm["lm_head"],
                                   "bias": torch.from_numpy(bias).to(getattr(torch, dtype))}},
                      torch.from_numpy(hidden).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_detokenize_discrete_actions_matches_jax():
    """Every id from below the 256 action bins through the pad rows past the
    true vocab and beyond the vocab (both clip), in two batch layouts."""
    chunk = LIBERO.chunk_len
    ids = np.arange(CFG.true_vocab_size - CFG.n_action_bins - 16, CFG.llm.vocab_size + 16)
    ids = np.resize(ids, (-(-ids.size // chunk) * chunk,))
    for batch in (ids.reshape(-1, chunk), ids.reshape(1, -1, chunk)):
        want = JP.detokenize_discrete_actions(batch, CFG, LIBERO)
        got = P.detokenize_discrete_actions(batch, port_config(CFG), port_platform(LIBERO))
        assert got.shape == batch.shape[:-1] + (LIBERO.num_actions_chunk, LIBERO.action_dim)
        np.testing.assert_array_equal(got, want)
    assert got.min() == -got.max() and np.unique(got).size == CFG.n_action_bins - 1


# --- the cache and the decode step --------------------------------------------------

@pytest.mark.parametrize("pad", [0, 4])
def test_llama_decode_step_matches_full_forward_and_jax(discrete_params, pad):
    """A prefill of two rows (0 and `pad` left pads) and 4 decode steps at
    the default positions (the valid keys' count): each step's hidden
    state against the port's full causal forward over the same rows and
    against JAX's decode on the same cache; the cache's index, valid mask
    and K/V against JAX's."""
    rng = np.random.default_rng(3 + pad)
    lp = discrete_params["llm"]
    jcfg, pcfg = CFG.llm, port_config(CFG).llm
    b, s, n = 2, 10, 4
    x = rng.standard_normal((b, s + n, jcfg.hidden_size)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[1, :pad] = False
    pads = (~valid).sum(1)
    pos = np.maximum(np.arange(s)[None] - pads[:, None], 0).astype(np.int32)
    jc = JL.KVCache.create(jcfg, b, s + n, dtype=jnp.float32)
    _, jc = JL.llama_prefill(lp, jcfg, jnp.asarray(x[:, :s]), jc, positions=jnp.asarray(pos),
                             key_valid=jnp.asarray(valid))
    tp = params_from_numpy(lp)
    pc = L.KVCache.create(pcfg, b, s + n, dtype=torch.float32)
    _, pc = L.llama_prefill(tp, pcfg, torch.from_numpy(x[:, :s]), pc,
                            positions=torch.from_numpy(pos).long(),
                            key_valid=torch.from_numpy(valid), use_flash=False)
    assert pc.index == int(jc.index) == s
    np.testing.assert_array_equal(pc.valid.numpy(), np.asarray(jc.valid))
    full_valid = np.concatenate([valid, np.ones((b, n), bool)], axis=1)
    full_pos = np.maximum(np.arange(s + n)[None] - pads[:, None], 0)
    full = L.llama_model(tp, pcfg, torch.from_numpy(x),
                         padding_mask=torch.from_numpy(full_valid),
                         positions=torch.from_numpy(full_pos).long()).numpy()
    for t in range(n):
        row = x[:, s + t:s + t + 1]
        jd, jc = JL.llama_decode_step(lp, jcfg, jnp.asarray(row), jc)
        pd, pc = L.llama_decode_step(tp, pcfg, torch.from_numpy(row), pc)
        assert pd.shape == (b, 1, jcfg.hidden_size)
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), **TIGHT)
        np.testing.assert_allclose(pd.numpy()[:, 0], full[:, s + t], **TIGHT)
    assert pc.index == int(jc.index) == s + n
    np.testing.assert_array_equal(pc.valid.numpy(), np.asarray(jc.valid))
    for got, want in ((pc.k, jc.k), (pc.v, jc.v)):
        np.testing.assert_allclose(got.numpy()[:, full_valid], np.asarray(want)[:, full_valid],
                                   **TIGHT)
    with pytest.raises(ValueError, match="full"):
        L.llama_decode_step(tp, pcfg, torch.from_numpy(x[:, :1]), pc)


# --- the autoregressive decode --------------------------------------------------------

def _prompts(rng, pads=(0, 4), n_real=8):
    """Two left-padded prompts ([BOS] tokens [29871]) in one bucket, with
    `pads` left pads: (ids, mask) (2, n_real + max(pads)) and each row's
    real tokens."""
    bucket = n_real + max(pads)
    ids = np.zeros((len(pads), bucket), np.int32)
    mask = np.zeros((len(pads), bucket), np.int32)
    rows = []
    for r, p in enumerate(pads):
        real = [1] + list(rng.integers(10, 1000, bucket - p - 2)) + [EMPTY_TOKEN_ID]
        ids[r, p:], mask[r, p:] = real, 1
        rows.append(real)
    return ids, mask, rows


def _port_greedy_no_cache(tp, cfg, prompt, pixels, n_new):
    """No-cache greedy loop on one unpadded row: [BOS][patches][prompt rest +
    generated] through the full `llama_model` every step (the reference's
    effective computation through HF generate, as tests/test_autoregressive.py
    builds it). (tokens (n_new,), logits (n_new, V))."""
    patches = P.compute_patch_features(tp, cfg, torch.tensor([prompt]),
                                       torch.ones((1, len(prompt))), pixels)
    ids, tokens, logits = list(prompt), [], []
    for _ in range(n_new):
        text = L.embed_tokens(tp["llm"], torch.tensor([ids]))
        mm = torch.cat([text[:, :1], patches, text[:, 1:]], dim=1)
        step = P.lm_logits(tp["llm"], L.llama_model(tp["llm"], cfg.llm, mm)[:, -1])[0]
        tokens.append(int(step.argmax()))
        logits.append(step.numpy())
        ids.append(tokens[-1])
    return np.asarray(tokens), np.stack(logits)


def _check_autoregressive(params, cfg, n_new, seed, rel=None):
    """JAX's `predict_action_autoregressive` and the port's on the same
    weights, a batch of two rows with 0 and 4 left pads; the port's tokens
    against JAX's and against the no-cache loop on each unpadded row, and
    its logits against the loop's (atol 1e-4, or `rel` of max|ref|)."""
    rng = np.random.default_rng(seed)
    ids, mask, rows = _prompts(rng)
    h = cfg.vision_configs[0].image_size
    pixels = rng.random((2, 1, 2, h, h, 3)).astype(np.float32)
    want = np.asarray(JP.predict_action_autoregressive(
        params, cfg, LIBERO, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
        num_new_tokens=n_new))
    tp, pcfg = params_from_numpy(params), port_config(cfg)
    tokens, logits = P.predict_action_autoregressive(
        tp, pcfg, port_platform(LIBERO), torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(pixels), num_new_tokens=n_new, return_logits=True)
    assert tokens.shape == (2, n_new) and logits.shape == (2, n_new, cfg.llm.vocab_size)
    assert logits.dtype == torch.float32
    print(f"smallest top-2 logit gap over {n_new} steps x 2 rows: {_top2_gap(logits):.4e}")
    np.testing.assert_array_equal(tokens.numpy(), want)
    for r, prompt in enumerate(rows):
        ref_tokens, ref_logits = _port_greedy_no_cache(tp, pcfg, prompt,
                                                       torch.from_numpy(pixels[r:r + 1]), n_new)
        np.testing.assert_array_equal(tokens[r].numpy(), ref_tokens)
        if rel is None:
            np.testing.assert_allclose(logits[r].numpy(), ref_logits, atol=1e-4, rtol=0)
        else:
            assert _rel(logits[r].numpy(), ref_logits) <= rel
    return tokens, (tp, pcfg, *[torch.from_numpy(a) for a in (ids, mask, pixels)])


def test_predict_action_autoregressive_matches_jax_and_no_cache_loop(discrete_params):
    tokens, (tp, pcfg, ids, mask, pixels) = _check_autoregressive(
        discrete_params, CFG, LIBERO.action_dim, seed=0)
    assert tokens.dtype == torch.int64
    first = P.predict_action_autoregressive(tp, pcfg, port_platform(LIBERO), ids, mask, pixels,
                                            num_new_tokens=1)
    np.testing.assert_array_equal(first.numpy(), tokens[:, :1].numpy())
    with pytest.raises(ValueError, match="at least 1"):
        P.predict_action_autoregressive(tp, pcfg, port_platform(LIBERO), ids, mask, pixels, 0)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quantized_autoregressive_matches_jax(monkeypatch, quant_float_params, bits):
    """The LLM fused without the norm folds and quantized by the JAX
    package's `quantize_tree` (lm_head excepted), the port reading JAX's
    codes and scales; the port's int8 linear and K5's plain version against
    JAX's. Every decode step runs one row through each quantized linear."""
    params = dict(quant_float_params)
    params["llm"] = jax.jit(lambda llm: JQ.quantize_tree(
        JL.fuse_inference_weights(llm, fold_norms=False), min_dim=64, bits=bits))(
        params["llm"])
    assert params["llm"]["lm_head"]["kernel"].dtype == jnp.float32
    n_new = 3
    _, (tp, pcfg, ids, mask, pixels) = _check_autoregressive(params, QUANT_CFG, n_new, seed=5,
                                                             rel=1e-4)
    # One AR call: the prefill, then n_new - 1 steps of one row each (B = 2),
    # 4 quantized linears a layer in each.
    rows = []
    fused = M.int4_matmul_fused
    monkeypatch.setattr(M, "int4_matmul_fused",
                        lambda *a: rows.append(a[0].numel() // a[0].shape[-1]) or fused(*a))
    before = Q.int8_mm.launches
    P.predict_action_autoregressive(tp, pcfg, port_platform(LIBERO), ids, mask, pixels, n_new)
    linears = 4 * QUANT_CFG.llm.num_layers
    if bits == 8:
        assert Q.int8_mm.launches - before == linears * n_new and rows == []
    else:
        assert rows[linears:] == [2] * (linears * (n_new - 1)) and len(rows) == linears * n_new


# --- the discrete policy and the logits of the forwards ----------------------------

def test_discrete_policy_predict_action_matches_jax(discrete_params):
    """The staged `predict_action` with head="discrete" at 2 images: the
    parallel decode's argmax tokens de-tokenized, then un-normalized."""
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats

    cfg = dataclasses.replace(CFG, num_images_in_input=2)
    stats = placeholder_norm_stats(port_platform(LIBERO))
    rng = np.random.default_rng(6)
    h = cfg.vision_configs[0].image_size
    pixels = rng.random((2, 2, h, h, 3)).astype(np.float32)
    proprio = rng.random(LIBERO.proprio_dim).astype(np.float32)
    jax_policy = JaxPolicy(cfg=cfg, platform=LIBERO, params=discrete_params, norm_stats=stats,
                           head="discrete", prompt_bucket=24)
    port_policy = OpenVLAPolicy(cfg=port_config(cfg), platform=port_platform(LIBERO),
                                params=params_from_numpy(discrete_params), norm_stats=stats,
                                head="discrete", prompt_bucket=24)
    got, want = {}, {}
    for key in ("un", "normalized"):
        if key == "normalized":
            jax_policy.norm_stats = port_policy.norm_stats = None
        want[key] = np.asarray(jax_policy.predict_action(pixels, "open the drawer",
                                                         proprio=proprio))
        got[key] = port_policy.predict_action(pixels, "open the drawer", proprio=proprio)
        assert got[key].shape == (LIBERO.num_actions_chunk, LIBERO.action_dim)
    np.testing.assert_array_equal(got["normalized"], want["normalized"])
    np.testing.assert_allclose(got["un"], want["un"], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="L1 head"):
        port_policy.predict_action_from_frames(np.zeros((2, 32, 32, 3), np.uint8), "x")


def test_predict_action_hidden_logits_match_jax(discrete_params):
    rng = np.random.default_rng(7)
    ids, mask, _ = _prompts(rng)
    h = CFG.vision_configs[0].image_size
    pixels = rng.random((2, 1, 2, h, h, 3)).astype(np.float32)
    proprio = rng.random((2, LIBERO.proprio_dim)).astype(np.float32)
    want = jax.jit(lambda p, *a: JP.predict_action_hidden(
        p, CFG, LIBERO, *a, use_flash=False, compute_logits=True))(
        discrete_params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
        jnp.asarray(proprio))
    tp = params_from_numpy(discrete_params)
    args = (tp, port_config(CFG), port_platform(LIBERO), torch.from_numpy(ids),
            torch.from_numpy(mask), torch.from_numpy(pixels))
    got = P.predict_action_hidden(*args, proprio=torch.from_numpy(proprio), use_flash=False,
                                  compute_logits=True)
    assert got.action_logits.shape == (2, LIBERO.chunk_len, CFG.llm.vocab_size)
    np.testing.assert_allclose(got.action_logits.numpy(), np.asarray(want.action_logits),
                               atol=1e-4, rtol=0)
    assert P.predict_action_hidden(*args, proprio=torch.from_numpy(proprio),
                                   use_flash=False).action_logits is None


def test_prismatic_forward_logits_match_jax():
    """The training forward's logits over every row (the discrete
    objective's input), on the training tests' batch."""
    params = _discrete_tree(TRAIN_CFG, seed=2)
    b = {k: np.array(v) for k, v in _batch().items()}
    want = jax.jit(lambda p, *a: JP.prismatic_forward(p, TRAIN_CFG, LIBERO, *a[:4],
                                                      proprio=a[4], compute_logits=True))(
        params, *[jnp.asarray(b[k]) for k in ("input_ids", "attention_mask", "pixel_values",
                                              "labels", "proprio")])
    got = P.prismatic_forward(params_from_numpy(params), port_config(TRAIN_CFG),
                              port_platform(LIBERO), *[torch.from_numpy(b[k]) for k in (
                                  "input_ids", "attention_mask", "pixel_values", "labels")],
                              proprio=torch.from_numpy(b["proprio"]), use_flash=False,
                              compute_logits=True)
    assert got.logits.shape == got.hidden_states.shape[:2] + (TRAIN_CFG.llm.vocab_size,)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=1e-4, rtol=0)


# --- the param tree and the serving quantization -------------------------------------

def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _paths(sub, prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, bridge.Init):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _paths(sub, prefix + (i,)).items()}
    return {prefix: tree}


def test_discrete_param_spec_matches_jax_at_flagship_size():
    """Shapes only, at the flagship's widths: JAX `init_openvla_params(head=
    None, with_lm_head=True)`, leaf for leaf."""
    flagship = OpenVLAConfig(vision_backbone_id="dinosiglip-vit-so-224px",
                             llm_backbone_id="llama2-7b-pure", num_images_in_input=1)
    shapes = jax.eval_shape(lambda: init_openvla_params(
        jax.random.PRNGKey(0), flagship, LIBERO, dtype=jnp.bfloat16, head=None,
        with_lm_head=True, head_dtype=jnp.bfloat16))
    got = {p: tuple(i.shape) for p, i in
           _paths(bridge.param_spec(port_config(flagship), port_platform(LIBERO),
                                    head="discrete")).items()}
    assert got == {p: tuple(s.shape) for p, s in _paths(shapes).items()}
    assert got[("llm", "lm_head", "kernel")] == (4096, 32064)
    assert not any(p[0] == "action_head" for p in got)


def test_discrete_params_bridge_and_init_leaf_for_leaf(discrete_params):
    ported = params_from_numpy(discrete_params)
    ref = _paths(discrete_params)
    assert set(_paths(ported)) == set(ref) and ("llm", "lm_head", "kernel") in ref
    for path, leaf in _paths(ported).items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref[path]), err_msg=str(path))
    drawn = bridge.init_params(port_config(CFG), port_platform(LIBERO),
                               torch.Generator().manual_seed(0), dtype=torch.float32,
                               head="discrete")
    assert {p: tuple(t.shape) for p, t in _paths(drawn).items()} == \
        {p: tuple(np.shape(a)) for p, a in ref.items()}
    with pytest.raises(ValueError, match="lm_head"):
        OpenVLAPolicy(cfg=port_config(CFG), platform=port_platform(LIBERO),
                      params=bridge.init_params(port_config(CFG), port_platform(LIBERO),
                                                torch.Generator().manual_seed(0),
                                                dtype=torch.float32),
                      head="discrete")


@pytest.mark.parametrize("flag", ["load_in_4bit", "load_in_8bit"])
def test_serving_params_leave_lm_head_bf16(monkeypatch, flag):
    """Under both quant flags, with a QUANT_MIN_DIM that the lm_head's d_in
    passes, the lm_head stays the bf16 kernel it was (JAX `_QUANT_EXCLUDE`)
    while the LLM's layers are quantized."""
    monkeypatch.setattr(deploy, "QUANT_MIN_DIM", 32)
    params = bridge.init_params(port_config(CFG), port_platform(LIBERO),
                                torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                                head="discrete")
    before = params["llm"]["lm_head"]["kernel"].clone()
    out = deploy.serving_params(params, **{flag: True})
    lm_head = out["llm"]["lm_head"]
    assert set(lm_head) == {"kernel"} and lm_head["kernel"].dtype == torch.bfloat16
    assert torch.equal(lm_head["kernel"], before)
    quantized = out["llm"]["layers"]["attn"]["wqkv"]
    assert ("kernel_q4" in quantized) == (flag == "load_in_4bit")
    assert (quantized.get("kernel", torch.empty(0)).dtype == torch.int8) == \
        (flag == "load_in_8bit")


# --- the bench script ---------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--quant", "int4"], ["--quant", "int8"]],
                         ids=["bf16", "int4", "int8"])
def test_bench_ar_main_at_tiny_size(monkeypatch, capsys, flags):
    """The bench's main on the CPU with the TINY configs in place of the
    flagship, 1 timed call per row: its rows, the AR / parallel ratio, and
    the 7 tokens the first 7 of the 56 (greedy decode of one prefill)."""
    from openvla_oft_tpu_torch.scripts import bench_ar

    monkeypatch.setattr(deploy, "FLAGSHIP_IDS", ("tiny-dual", "tiny-llama"))
    monkeypatch.setattr(deploy, "QUANT_MIN_DIM", 32)
    result = bench_ar.main(["--device", "cpu", "--k", "1", *flags])
    lines = capsys.readouterr().out.strip().splitlines()
    tag = flags[1] if flags else "bf16"
    assert [line.split("[")[0] for line in lines[:3]] == \
        [label for label, _ in bench_ar.ROWS] + [bench_ar.PARALLEL_LABEL]
    assert all(f"[{tag}]: " in line and line.endswith(" ms/token)") for line in lines[:3])
    assert lines[3].startswith("AR 56 tokens / parallel decode: ") and result["ratio"] > 0
    assert result["tokens"][7].shape == (1, 7) and result["tokens"][56].shape == (1, 56)
    np.testing.assert_array_equal(result["tokens"][56][:, :7], result["tokens"][7])
    assert all(ms > 0 for ms in result["ms"].values()) and result["tag"] == tag
