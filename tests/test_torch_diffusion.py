"""Port parity for the diffusion head: the DDIM scheduler (and the golden
`ddim_trajectory.npz`), the time encoding, the noisy-action projector and
the noise predictor, the param tree, the prefix K/V cache
(`llama_prefill`, `build_diffusion_prefix`), `attention_split_kv`, the
suffix step at LIBERO, at ALOHA geometry and with FiLM, the whole denoising
loop, the staged `predict_action`, int8 and int4 suffix steps and the
bench script, against the JAX package on the CPU.

Inputs are numpy arrays from a seed and bridged JAX weights, in fp32, at the
TINY configs; each side gets its own config (`port_config`). The starting
noise of a loop is JAX's, handed to the port. Tolerances:
- DDIM tables, timesteps, `step` and `add_noise`: atol 1e-6 (the same fp32
  arithmetic; XLA may contract a multiply-add);
- the golden trajectory: atol 2e-5, rtol 1e-4, as tests/test_goldens.py;
- time encoding, projector, noise predictor, the prefill and its cache,
  the prefix, split-KV attention: atol 1e-5 (fp32 sums in another order);
- the suffix step and the loop: rtol/atol 1e-4, as
  tests/test_policy_diffusion.py holds the JAX package's own paths;
- the int8 and int4 suffix steps: max|d| <= 1e-4 * max|ref|, as the port's
  int8 and int4 slices hold their tiny models.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvla_oft_tpu.config as C
from openvla_oft_tpu.config import OpenVLAConfig
from openvla_oft_tpu.constants import ALOHA, LIBERO
from openvla_oft_tpu.models import action_heads as JH
from openvla_oft_tpu.models import llama as JL
from openvla_oft_tpu.models import prismatic as JP
from openvla_oft_tpu.models.projector import noisy_action_projector as jax_noisy_proj
from openvla_oft_tpu.ops import quant as JQ
from openvla_oft_tpu.ops.attention import attention_split_kv as jax_split_kv
from openvla_oft_tpu.ops.ddim import DDIMScheduler as JaxDDIM
from openvla_oft_tpu.policy import OpenVLAPolicy as JaxPolicy
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu_torch import bridge
from openvla_oft_tpu_torch.bridge import params_from_numpy
from openvla_oft_tpu_torch.models import action_heads as H
from openvla_oft_tpu_torch.models import llama as L
from openvla_oft_tpu_torch.models import prismatic as P
from openvla_oft_tpu_torch.models.projector import noisy_action_projector
from openvla_oft_tpu_torch.ops import int4_matmul as M
from openvla_oft_tpu_torch.ops import quant as Q
from openvla_oft_tpu_torch.ops.attention import attention_dense, attention_split_kv
from openvla_oft_tpu_torch.ops.ddim import DDIMScheduler
from openvla_oft_tpu_torch.policy import OpenVLAPolicy
from test_torch_import import port_config, port_platform

torch.backends.cuda.matmul.allow_tf32 = False

CFG = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                    num_images_in_input=1)
ALOHA_CFG = dataclasses.replace(CFG, num_images_in_input=3)
FILM_CFG = dataclasses.replace(ALOHA_CFG, use_film=True)
TIGHT = dict(atol=1e-5, rtol=1e-5)
STEP = dict(atol=1e-4, rtol=1e-4)
GOLDEN = Path(__file__).parent / "goldens" / "ddim_trajectory.npz"


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --- the DDIM scheduler ------------------------------------------------------------

@pytest.mark.parametrize("T", [50, 100])
def test_ddim_tables_and_timesteps_match_jax(T):
    ref, got = JaxDDIM(num_train_timesteps=T), DDIMScheduler(num_train_timesteps=T)
    np.testing.assert_array_equal(got.alphas_cumprod, ref.alphas_cumprod)
    assert got.final_alpha_cumprod == ref.final_alpha_cumprod == 1.0
    for n in (5, 10, 50):
        np.testing.assert_array_equal(got.timesteps(n), ref.timesteps(n))
    assert got.ac.dtype == torch.float32 and got.ac.device.type == "cpu"
    np.testing.assert_array_equal(got.ac.numpy(),
                                  np.asarray(jnp.asarray(ref.alphas_cumprod, jnp.float32)))


@pytest.mark.parametrize("n", [5, 10, 50])
@pytest.mark.parametrize("T", [50, 100])
def test_ddim_step_matches_jax(rng, T, n):
    """Every step of the n-step walk, on samples and model outputs large
    enough that x0 clips, and the last step (prev_t < 0: the final alpha)."""
    ref, got = JaxDDIM(num_train_timesteps=T), DDIMScheduler(num_train_timesteps=T)
    x = (rng.standard_normal((2, 8, 7)) * 1.5).astype(np.float32)
    eps = (rng.standard_normal((2, 8, 7)) * 2.0).astype(np.float32)
    for t in ref.timesteps(n):
        want = np.asarray(ref.step(jnp.asarray(eps), jnp.asarray(t), jnp.asarray(x), n))
        have = got.step(torch.from_numpy(eps), int(t), torch.from_numpy(x), n)
        assert have.dtype == torch.float32
        np.testing.assert_allclose(have.numpy(), want, atol=1e-6, rtol=0)
    bf = got.step(torch.from_numpy(eps), int(ref.timesteps(n)[0]),
                  torch.from_numpy(x).bfloat16(), n)
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("T", [50, 100])
def test_ddim_add_noise_matches_jax(rng, T):
    ref, got = JaxDDIM(num_train_timesteps=T), DDIMScheduler(num_train_timesteps=T)
    x = rng.standard_normal((4, 8, 7)).astype(np.float32)
    noise = rng.standard_normal((4, 8, 7)).astype(np.float32)
    t = rng.integers(0, T, 4)
    want = np.asarray(ref.add_noise(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t)))
    have = got.add_noise(torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(have.numpy(), want, atol=1e-6, rtol=0)


def test_golden_ddim_trajectory():
    """tests/goldens/ddim_trajectory.npz, built as tests/test_goldens.py
    builds it: 10 steps of T = 100 with the pseudo-model eps = 0.1 x."""
    sched = DDIMScheduler(num_train_timesteps=100)
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(41), (1, 4, 3))))
    for t in sched.timesteps(10):
        x = sched.step(0.1 * x, int(t), x, num_inference_steps=10)
    np.testing.assert_allclose(x.numpy(), np.load(GOLDEN)["value"], atol=2e-5, rtol=1e-4)


# --- the head's pieces -------------------------------------------------------------

@pytest.mark.parametrize("dim", [64, 256, 4096])
def test_sinusoidal_time_encoding_matches_jax(dim):
    t = np.asarray([0, 1, 7, 42, 99], np.int64)
    want = np.asarray(JH.sinusoidal_time_encoding(jnp.asarray(t), dim))
    have = H.sinusoidal_time_encoding(torch.from_numpy(t), dim)
    assert have.dtype == torch.float32 and have.shape == (5, dim)
    np.testing.assert_allclose(have.numpy(), want, **TIGHT)


@pytest.fixture(scope="module")
def libero_params():
    return dict(init_openvla_params(jax.random.PRNGKey(0), CFG, LIBERO, dtype=jnp.float32,
                                    head="diffusion"))


def test_noisy_action_projector_and_noise_predictor_match_jax(libero_params):
    rng = np.random.default_rng(1)
    tp = params_from_numpy(libero_params)
    na = rng.standard_normal((2, LIBERO.chunk_len, 1)).astype(np.float32)
    np.testing.assert_allclose(
        noisy_action_projector(tp["noisy_action_projector"], torch.from_numpy(na)).numpy(),
        np.asarray(jax_noisy_proj(libero_params["noisy_action_projector"], jnp.asarray(na))),
        **TIGHT)
    hidden = rng.standard_normal((2, LIBERO.chunk_len, CFG.llm_dim)).astype(np.float32)
    want = np.asarray(JH.diffusion_predict_noise(libero_params["action_head"],
                                                 jnp.asarray(hidden), LIBERO))
    have = H.diffusion_predict_noise(tp["action_head"], torch.from_numpy(hidden),
                                     port_platform(LIBERO))
    assert have.shape == (2, LIBERO.num_actions_chunk, LIBERO.action_dim)
    np.testing.assert_allclose(have.numpy(), want, **TIGHT)
    assert H.diffusion_scheduler(50) == DDIMScheduler(num_train_timesteps=50)


def _paths(tree, prefix=()):
    if isinstance(tree, bridge.Init):
        return {prefix: tree}
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _paths(sub, prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _paths(sub, prefix + (i,)).items()}
    return {prefix: tree}


def test_diffusion_param_spec_matches_jax_at_flagship_size():
    """Shapes only, at the flagship's widths: nothing 7B-sized is built."""
    flagship = OpenVLAConfig(vision_backbone_id="dinosiglip-vit-so-224px",
                             llm_backbone_id="llama2-7b-pure", num_images_in_input=2)
    shapes = jax.eval_shape(lambda: init_openvla_params(
        jax.random.PRNGKey(0), flagship, LIBERO, dtype=jnp.bfloat16, head="diffusion",
        with_lm_head=False, head_dtype=jnp.bfloat16))
    got = {p: tuple(i.shape) for p, i in
           _paths(bridge.param_spec(port_config(flagship), port_platform(LIBERO),
                                    head="diffusion")).items()}
    assert got == {p: tuple(s.shape) for p, s in _paths(shapes).items()}
    assert ("noisy_action_projector", "fc1", "kernel") in got
    assert ("llm", "lm_head", "kernel") not in got
    discrete = _paths(bridge.param_spec(port_config(flagship), port_platform(LIBERO),
                                        head="discrete"))
    assert ("llm", "lm_head", "kernel") in discrete and ("action_head",) not in {
        p[:1] for p in discrete}


def test_diffusion_params_bridge_and_init_leaf_for_leaf(libero_params):
    """params_from_numpy carries the JAX diffusion tree leaf for leaf, and
    init_params draws the same tree (keys and shapes; constants equal)."""
    ported = params_from_numpy(libero_params)
    ref = _paths(libero_params)
    assert set(_paths(ported)) == set(ref)
    for path, leaf in _paths(ported).items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref[path]), err_msg=str(path))
    drawn = bridge.init_params(port_config(CFG), port_platform(LIBERO),
                               torch.Generator().manual_seed(0), dtype=torch.float32,
                               head="diffusion")
    ref = {p: v for p, v in ref.items() if p[:2] != ("llm", "lm_head")}
    got = _paths(drawn)
    assert set(got) == set(ref)
    for path, leaf in ref.items():
        assert tuple(got[path].shape) == leaf.shape, path
        a = np.asarray(leaf)
        if np.all(a == a.flat[0]):
            np.testing.assert_array_equal(got[path].numpy(), a, err_msg=str(path))


# --- the prefix K/V cache --------------------------------------------------------

@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
def test_llama_prefill_and_kv_cache_match_jax(use_flash):
    """Two rows with 0 and 3 left pads: the hidden states and the cache at
    every valid position (a pad query row has no allowed key: K1's plain
    version gives it 0, the dense path the mean of V, and neither is read)."""
    rng = np.random.default_rng(2)
    llm_cfg = CFG.llm
    lp = init_openvla_params(jax.random.PRNGKey(4), CFG, LIBERO, dtype=jnp.float32)["llm"]
    b, s, t_max = 2, 10, 12
    x = rng.standard_normal((b, s, llm_cfg.hidden_size)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[1, :3] = False
    pos = np.maximum(np.arange(s)[None] - (~valid).sum(1, keepdims=True), 0).astype(np.int32)
    cache = JL.KVCache.create(llm_cfg, b, t_max, dtype=jnp.float32)
    want_h, want_c = JL.llama_prefill(lp, llm_cfg, jnp.asarray(x), cache,
                                      positions=jnp.asarray(pos), key_valid=jnp.asarray(valid))
    p_cfg = port_config(CFG).llm
    cache = L.KVCache.create(p_cfg, b, t_max, dtype=torch.float32)
    got_h, got_c = L.llama_prefill(params_from_numpy(lp), p_cfg, torch.from_numpy(x), cache,
                                   positions=torch.from_numpy(pos).long(),
                                   key_valid=torch.from_numpy(valid), use_flash=use_flash)
    assert got_c is cache and got_c.index == int(want_c.index) == s
    np.testing.assert_array_equal(got_c.valid.numpy(), np.asarray(want_c.valid))
    np.testing.assert_allclose(got_h.numpy()[valid], np.asarray(want_h)[valid], **TIGHT)
    kv_rows = np.zeros((b, t_max), bool)
    kv_rows[:, :s] = valid
    for got, want in ((got_c.k, want_c.k), (got_c.v, want_c.v)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy()[:, kv_rows], np.asarray(want)[:, kv_rows],
                                   **TIGHT)
        assert not got[:, :, s:].any()


def _prompt(rng, bucket, n_real, batch=1):
    """A left-padded prompt: BOS, tokens, 29871; row r has n_real[r] tokens."""
    ids = np.zeros((batch, bucket), np.int32)
    mask = np.zeros((batch, bucket), np.int32)
    for r, n in enumerate(n_real):
        ids[r, bucket - n:] = [1] + list(rng.integers(3, 100, n - 2)) + [29871]
        mask[r, bucket - n:] = 1
    return ids, mask


GEOMETRIES = {
    # (config, platform, prompt bucket, real tokens per row, proprio)
    "libero": (CFG, LIBERO, 24, (19, 11), True),
    "aloha": (ALOHA_CFG, ALOHA, 16, (11,), False),
    "film": (FILM_CFG, ALOHA, 16, (11,), False),
}


@pytest.fixture(scope="module")
def geometry_cases():
    """Per geometry: JAX params, the inputs as numpy, and the JAX prefix and
    one suffix step at t = 7 (computed once for the module)."""
    out = {}
    for i, (name, (cfg, platform, bucket, n_real, use_proprio)) in enumerate(GEOMETRIES.items()):
        rng = np.random.default_rng(10 + i)
        params = dict(init_openvla_params(jax.random.PRNGKey(20 + i), cfg, platform,
                                          dtype=jnp.float32, head="diffusion",
                                          use_proprio=use_proprio))
        b = len(n_real)
        ids, mask = _prompt(rng, bucket, n_real, b)
        h = cfg.vision_configs[0].image_size
        inputs = dict(input_ids=ids, prompt_mask=mask,
                      pixels=rng.random((b, cfg.num_images_in_input, 2, h, h, 3)
                                        ).astype(np.float32),
                      proprio=rng.random((b, platform.proprio_dim)).astype(np.float32)
                      if use_proprio else None)
        x_t = rng.standard_normal((b, platform.num_actions_chunk, platform.action_dim)
                                  ).astype(np.float32)
        j = {k: None if v is None else jnp.asarray(v) for k, v in inputs.items()}
        prefix = JP.build_diffusion_prefix(params, cfg, j["input_ids"], j["prompt_mask"],
                                           j["pixels"], j["proprio"])
        t_emb = JH.sinusoidal_time_encoding(jnp.full((b,), 7), cfg.llm_dim)[:, None, :]
        step = JP.diffusion_suffix_step(params, cfg, platform, prefix, t_emb, jnp.asarray(x_t))
        out[name] = dict(cfg=cfg, platform=platform, params=params, inputs=inputs, x_t=x_t,
                         prefix=prefix, step=np.asarray(step))
    return out


def _port_inputs(case):
    return {k: None if v is None else torch.from_numpy(v) for k, v in case["inputs"].items()}


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
def test_build_diffusion_prefix_matches_jax(geometry_cases, use_flash):
    """Every field, at LIBERO with two rows of different pad counts."""
    case = geometry_cases["libero"]
    x = _port_inputs(case)
    got = P.build_diffusion_prefix(params_from_numpy(case["params"]), port_config(case["cfg"]),
                                   x["input_ids"], x["prompt_mask"], x["pixels"], x["proprio"],
                                   use_flash=use_flash)
    want = case["prefix"]
    assert got.prefix_k.shape == want.prefix_k.shape
    assert got.prefix_k.shape[2] == 1 + case["cfg"].vision_configs[0].num_patches + 1
    for field in ("prefix_k", "prefix_v", "text_rest", "stop_embed"):
        np.testing.assert_allclose(_np(getattr(got, field)), np.asarray(getattr(want, field)),
                                   err_msg=field, **TIGHT)
    for field in ("text_valid", "pad_counts"):
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)


# --- split-KV attention -------------------------------------------------------------

def test_attention_split_kv_matches_jax_and_dense(rng):
    """GQA (4 query heads over 2 kv heads), a query row whose every prefix
    key is masked (its prefix block is dead), a row with every suffix key
    masked, and a row with every key masked (its output is 0)."""
    b, s, h, hkv, d, tp = 2, 6, 4, 2, 16, 9
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pk, pv = (rng.standard_normal((b, tp, hkv, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32) for _ in range(2))
    mask_pre = rng.random((b, 1, s, tp)) > 0.3
    mask_suf = np.tril(np.ones((s, s), bool))[None, None].repeat(b, 0)
    mask_pre[0, 0, 1] = False                       # dead prefix block
    mask_suf[1, 0, 2] = False                       # dead suffix block
    mask_pre[1, 0, 4], mask_suf[1, 0, 4] = False, False   # nothing to attend
    want = np.asarray(jax_split_kv(*(jnp.asarray(a) for a in (q, pk, pv, k, v)),
                                   mask_pre=jnp.asarray(mask_pre),
                                   mask_suf=jnp.asarray(mask_suf)))
    t = [torch.from_numpy(a) for a in (q, pk, pv, k, v)]
    got = attention_split_kv(*t, mask_pre=torch.from_numpy(mask_pre),
                             mask_suf=torch.from_numpy(mask_suf))
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    assert not got[1, 4].any()
    dense = attention_dense(t[0], torch.cat([t[1], t[3]], 1), torch.cat([t[2], t[4]], 1),
                            mask=torch.from_numpy(np.concatenate([mask_pre, mask_suf], -1)))
    live = np.ones((b, s), bool)
    live[1, 4] = False
    np.testing.assert_allclose(got.numpy()[live], dense.numpy()[live], **TIGHT)


# --- the suffix step -----------------------------------------------------------------

@pytest.mark.parametrize("split_kv", [False, True], ids=["concat", "split-kv"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_diffusion_suffix_step_matches_jax_and_full_prefill(geometry_cases, geometry,
                                                            split_kv):
    """One step's actions_hidden at t = 7 against JAX's
    `diffusion_suffix_step`, and against the port's own full
    `predict_action_hidden` with the same noisy actions and time token."""
    case = geometry_cases[geometry]
    cfg, platform = port_config(case["cfg"]), port_platform(case["platform"])
    tp = params_from_numpy(case["params"])
    x = _port_inputs(case)
    b = x["input_ids"].shape[0]
    x_t = torch.from_numpy(case["x_t"])
    t_emb = H.sinusoidal_time_encoding(torch.full((b,), 7), cfg.llm_dim)[:, None]
    prefix = P.build_diffusion_prefix(tp, cfg, x["input_ids"], x["prompt_mask"], x["pixels"],
                                      x["proprio"])
    got = P.diffusion_suffix_step(tp, cfg, platform, prefix, t_emb, x_t, split_kv=split_kv)
    assert got.shape == (b, platform.chunk_len, cfg.llm_dim)
    np.testing.assert_allclose(got.numpy(), case["step"], **STEP)
    full = P.predict_action_hidden(tp, cfg, platform, x["input_ids"], x["prompt_mask"],
                                   x["pixels"], proprio=x["proprio"], use_flash=False,
                                   noisy_actions=x_t, diffusion_t_emb=t_emb).actions_hidden
    np.testing.assert_allclose(got.numpy(), full.numpy(), **STEP)


# --- the loop and the policy -----------------------------------------------------------

LOOPS = {"prefix-kv": (True, False), "prefix-kv-split": (True, True),
         "full-prefill": (False, False)}


@pytest.fixture(scope="module")
def jax_loops():
    """JAX's `_predict_jit` at LIBERO, 4 of 50 steps, from PRNGKey(3)'s
    noise: one per prefix-KV / split-KV setting (OPENVLA_SPLIT_KV is read
    while the loop traces)."""
    cfg, platform, bucket = CFG, LIBERO, 24
    rng = np.random.default_rng(5)
    params = dict(init_openvla_params(jax.random.PRNGKey(0), cfg, platform, dtype=jnp.float32,
                                      head="diffusion"))
    ids, mask = _prompt(rng, bucket, (18,))
    h = cfg.vision_configs[0].image_size
    pixels = rng.random((1, 1, 2, h, h, 3)).astype(np.float32)
    proprio = rng.random((1, platform.proprio_dim)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(
        key, (1, platform.num_actions_chunk, platform.action_dim), dtype=jnp.float32))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (prefix_kv, split) in LOOPS.items():
            mp.setenv("OPENVLA_SPLIT_KV", "1" if split else "0")
            pol = JaxPolicy(cfg=cfg, platform=platform, params=params, head="diffusion",
                            prompt_bucket=bucket, num_diffusion_steps_inference=4,
                            diffusion_prefix_kv=prefix_kv)
            actions, _ = pol._predict_jit(params, jnp.asarray(ids), jnp.asarray(mask),
                                          jnp.asarray(pixels), jnp.asarray(proprio),
                                          noise_key=key)
            out[name] = np.asarray(actions)
    return dict(params=params, ids=ids, mask=mask, pixels=pixels, proprio=proprio,
                noise=noise, bucket=bucket, actions=out)


@pytest.mark.parametrize("loop", list(LOOPS))
def test_diffusion_loop_matches_jax(jax_loops, loop):
    prefix_kv, split = LOOPS[loop]
    j = jax_loops
    pol = OpenVLAPolicy(cfg=port_config(CFG), platform=port_platform(LIBERO),
                        params=params_from_numpy(j["params"]), head="diffusion",
                        prompt_bucket=j["bucket"], num_diffusion_steps_inference=4,
                        diffusion_prefix_kv=prefix_kv, split_kv=split)
    with torch.inference_mode():
        got = pol._diffusion_loop(*(torch.from_numpy(j[k]) for k in
                                    ("ids", "mask", "pixels", "proprio")),
                                  noise=torch.from_numpy(j["noise"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), j["actions"][loop], **STEP)
    # Denoising moved the noise.
    assert np.abs(got.numpy() - j["noise"]).max() > 1e-2


def _tiny_policy(params, **kw):
    return OpenVLAPolicy(cfg=port_config(CFG), platform=port_platform(LIBERO),
                         params=params_from_numpy(params), head="diffusion",
                         prompt_bucket=24, num_diffusion_steps_inference=3, **kw)


def test_predict_action_end_to_end(libero_params):
    """Shape and finite values; a fresh draw of noise per call, so two calls
    differ; a re-seeded generator repeats its answer; the given starting
    noise reproduces the loop; with stats, the host un-normalization."""
    from openvla_oft_tpu_torch.models.prismatic import unnormalize_actions
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats

    rng = np.random.default_rng(6)
    pol = _tiny_policy(libero_params)
    assert pol.generator is not None and pol.generator.device.type == "cpu"
    h = CFG.vision_configs[0].image_size
    pixels = rng.random((1, 2, h, h, 3)).astype(np.float32)
    proprio = rng.random(LIBERO.proprio_dim).astype(np.float32)
    a1 = pol.predict_action(pixels, "shake the bottle", proprio=proprio)
    assert a1.shape == (LIBERO.num_actions_chunk, LIBERO.action_dim)
    assert np.isfinite(a1).all() and np.abs(a1).max() <= 1.0
    a2 = pol.predict_action(pixels, "shake the bottle", proprio=proprio)
    assert np.abs(a1 - a2).max() > 1e-6
    pol.generator.manual_seed(123)
    a3 = pol.predict_action(pixels, "shake the bottle", proprio=proprio)
    pol.generator.manual_seed(123)
    np.testing.assert_array_equal(pol.predict_action(pixels, "shake the bottle",
                                                     proprio=proprio), a3)
    pol.generator.manual_seed(123)
    noise = torch.randn((1, LIBERO.num_actions_chunk, LIBERO.action_dim),
                        generator=pol.generator)
    np.testing.assert_array_equal(pol.predict_action(pixels, "shake the bottle",
                                                     proprio=proprio, noise=noise), a3)
    stats = placeholder_norm_stats(port_platform(LIBERO))
    stats["random"]["action"]["q01"] = [-0.5] * LIBERO.action_dim
    pol.norm_stats = stats
    pol.generator.manual_seed(123)
    un = pol.predict_action(pixels, "shake the bottle", proprio=proprio)
    np.testing.assert_array_equal(un, unnormalize_actions(a3, stats["random"]["action"],
                                                          LIBERO.norm_type))
    with pytest.raises(ValueError, match="predict_action"):
        pol.predict_action_from_frames(np.zeros((2, 8, 8, 3), np.uint8), "x")


def test_predict_action_l1_matches_jax(rng):
    """The staged path of the L1 head against JAX's `predict_action`, with
    the host un-normalization."""
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats

    params = dict(init_openvla_params(jax.random.PRNGKey(8), CFG, LIBERO, dtype=jnp.float32,
                                      head="l1"))
    stats = placeholder_norm_stats(port_platform(LIBERO))
    h = CFG.vision_configs[0].image_size
    pixels = rng.random((1, 2, h, h, 3)).astype(np.float32)
    proprio = rng.random(LIBERO.proprio_dim).astype(np.float32)
    want = JaxPolicy(cfg=CFG, platform=LIBERO, params=params, norm_stats=stats,
                     prompt_bucket=24).predict_action(pixels, "open the drawer", proprio=proprio)
    got = OpenVLAPolicy(cfg=port_config(CFG), platform=port_platform(LIBERO),
                        params=params_from_numpy(params), norm_stats=stats,
                        prompt_bucket=24).predict_action(pixels, "open the drawer",
                                                         proprio=proprio)
    np.testing.assert_allclose(got, np.asarray(want), **STEP)


def test_discrete_head_raises_and_cites_item_12(libero_params):
    """The discrete head is ported: on this diffusion tree without its
    lm_head it refuses, naming the leaf it needs, and an unknown head is
    refused."""
    params = params_from_numpy(libero_params)
    del params["llm"]["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        OpenVLAPolicy(cfg=port_config(CFG), platform=port_platform(LIBERO), params=params,
                      head="discrete")
    with pytest.raises(ValueError, match="head must be"):
        OpenVLAPolicy(cfg=port_config(CFG), platform=port_platform(LIBERO),
                      params=params_from_numpy(libero_params), head="mixture")


# --- int8 and int4 suffix steps -----------------------------------------------------

# A 2-layer Llama whose int4 shapes the JAX package's stacked kernels take
# (as tests/test_torch_int4.py's): every LLM linear quantized with min_dim 64.
C._LLM_REGISTRY.setdefault("int4-test-llama", C.LlamaConfig(
    vocab_size=32064, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=2,
    num_kv_heads=2))
QUANT_CFG = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="int4-test-llama",
                          num_images_in_input=1)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quantized_suffix_step_matches_jax(monkeypatch, bits):
    """The LLM fused without the norm folds and quantized by the JAX
    package's `quantize_tree`; the port's int8 linear and K5's plain
    version (its wrapper on CPU tensors) against JAX's, one step at t = 3.
    The JAX side runs op by op for int8 (its jitted quantizer rounds scales
    one ulp off, see tests/test_torch_int8.py), and its int4 kernels in
    interpret mode (its CPU path)."""
    rng = np.random.default_rng(7)
    params = dict(init_openvla_params(jax.random.PRNGKey(12), QUANT_CFG, LIBERO,
                                      dtype=jnp.float32, head="diffusion"))
    with jax.disable_jit():
        params["llm"] = JQ.quantize_tree(JL.fuse_inference_weights(params["llm"],
                                                                   fold_norms=False),
                                         min_dim=64, bits=bits)
    ids, mask = _prompt(rng, 16, (12,))
    h = QUANT_CFG.vision_configs[0].image_size
    pixels = rng.random((1, 1, 2, h, h, 3)).astype(np.float32)
    proprio = rng.random((1, LIBERO.proprio_dim)).astype(np.float32)
    x_t = rng.standard_normal((1, LIBERO.num_actions_chunk, LIBERO.action_dim)
                              ).astype(np.float32)
    t_emb = JH.sinusoidal_time_encoding(jnp.asarray([3]), QUANT_CFG.llm_dim)[:, None, :]
    prefix = JP.build_diffusion_prefix(params, QUANT_CFG, jnp.asarray(ids), jnp.asarray(mask),
                                       jnp.asarray(pixels), jnp.asarray(proprio))
    want = np.asarray(JP.diffusion_suffix_step(params, QUANT_CFG, LIBERO, prefix, t_emb,
                                               jnp.asarray(x_t)))
    calls = []
    for name in ("int4_matmul_fused", "int4_matmul_fused_a8"):
        fn = getattr(M, name)
        monkeypatch.setattr(M, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    tp = params_from_numpy(params)
    cfg = port_config(QUANT_CFG)
    before = Q.int8_mm.launches
    pre = P.build_diffusion_prefix(tp, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                                   torch.from_numpy(pixels), torch.from_numpy(proprio))
    got = P.diffusion_suffix_step(tp, cfg, port_platform(LIBERO), pre,
                                  H.sinusoidal_time_encoding(torch.tensor([3]),
                                                             cfg.llm_dim)[:, None],
                                  torch.from_numpy(x_t))
    n_linears = 2 * 4 * cfg.llm.num_layers      # prefix and suffix, 4 a layer
    if bits == 8:
        assert Q.int8_mm.launches - before == n_linears and calls == []
    else:
        assert calls == ["int4_matmul_fused"] * n_linears
    assert _rel(got.numpy(), want) <= 1e-4


# --- the bench script ---------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--old"], ["--split-kv"],
                                   ["--quant", "int8", "--static"],
                                   ["--quant", "int4a8", "--platform", "aloha"],
                                   ["--film", "on"]],
                         ids=["prefix-kv", "old", "split-kv", "int8-static", "int4a8-aloha",
                              "film-libero"])
def test_bench_diffusion_main_at_tiny_size(monkeypatch, capsys, flags):
    """The bench's main on the CPU with the TINY configs in place of the
    flagship, 2 steps, 1 timed call; its output line, its mode and the
    policy's switches."""
    from openvla_oft_tpu_torch.scripts import bench_diffusion
    from openvla_oft_tpu_torch.serving import deploy

    monkeypatch.setattr(deploy, "FLAGSHIP_IDS", ("tiny-dual", "tiny-llama"))
    built = []
    build = bench_diffusion.build_policy
    monkeypatch.setattr(bench_diffusion, "build_policy",
                        lambda args: built.append(build(args)) or built[-1])
    monkeypatch.setattr(deploy, "QUANT_MIN_DIM", 32)
    result = bench_diffusion.main(["--device", "cpu", "--steps", "2", "--k", "1", *flags])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"diffusion[{result['mode']}] steps=2: ")
    assert line.endswith(" ms/step)") and "ms/chunk" in line
    assert result["ms_per_chunk"] > 0 and np.isfinite(result["actions"]).all()
    mode = result["mode"]
    assert mode.startswith("full-prefill" if "--old" in flags else "prefix-kv")
    assert ("+int8" in mode) == ("int8" in flags) and ("+static" in mode) == ("--static" in flags)
    film = "aloha" in flags or "--film" in flags
    assert ("+int4a8" in mode) == ("int4a8" in flags) and ("+film" in mode) == film
    assert ("+split-kv" in mode) == ("--split-kv" in flags)
    policy, = built
    assert policy.cfg.use_film == film and policy.split_kv == ("--split-kv" in flags)
    assert policy.diffusion_prefix_kv == ("--old" not in flags)
    assert policy.num_diffusion_steps == 2 and policy.scheduler.num_train_timesteps == 2
