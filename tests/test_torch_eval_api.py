"""The port's eval and serving API against the JAX package's, on one exported checkpoint.

The mirror of `tests/test_eval_api.py`: a tiny checkpoint dir written by
JAX's exporter (with a SentencePiece `tokenizer.model` and the per-module
`.pt` files) goes through JAX's `get_vla` / `get_vla_action` and the port's,
for the l1, diffusion and discrete heads, on the staged path (the JAX side's
TF JPEG round trip against the port's own codec) and the `device_preprocess`
path. Both sides run in fp32 (JAX's `get_vla` loads in bf16, so its loader
is pinned to fp32 here);
the actions agree within rtol = atol = 1e-4, the bound of
`tests/test_torch_serve.py`. The diffusion head starts both loops from JAX's
first noise draw. The `device_preprocess` case sends frames at the model's
image size: there the lanczos3 resize is the identity on both sides, so the
uint8 rounding after it, where the two sides' fp32 sums put up to 0.1% of
pixels one LSB apart (held in `tests/test_torch_serve.py::
test_device_preprocess_matches_jax`), does not enter the action bound.

Also: the resize strategies of the processor transform ("resize-crop",
"letterbox", and the bicubic "resize-naive") on non-square frames against
JAX's `make_device_transform` (atol 1e-5 on normalized pixels: the same
fp32 weights, summed in another order), the staged image pipeline, the
loud failures (a missing tokenizer, a missing lm_head, a hub id, a wrong
unnorm_key), the joint ViT pair (`joint_vit`, `joint_vit_int8`) leaf for
leaf JAX's loader's under its conditions, the JPEG round trip with TF and PIL
hidden, the FiLM backbone from its `.pt`, and the deploy CLI serving a
checkpoint dir over the stdlib server.
"""

import builtins
import dataclasses
import functools
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvla_oft_tpu.config as JC
import openvla_oft_tpu.utils.hf_import as JH
from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.training.checkpoint import export_module_pt
from openvla_oft_tpu_torch.serving import deploy
from openvla_oft_tpu_torch.serving import openvla_utils as PU
from test_sentencepiece import _llama_like_pieces, _model
from test_torch_import import port_config

CFG = JC.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama")
P_CFG = port_config(CFG)
STATS = {"libero_spatial": {
    "action": {"min": [-1.0] * 7, "max": [1.0] * 7, "q01": [-0.9] * 7, "q99": [0.9] * 7,
               "mask": [True] * 6 + [False]},
    "proprio": {"min": [-1.0] * 8, "max": [1.0] * 8, "q01": [-0.9] * 8, "q99": [0.9] * 8},
}}
DIFFUSION_STEPS = 8
RTOL = ATOL = 1e-4

_WS = "▁"
_WORDS = ["in", "what", "action", "should", "the", "robot", "take", "to", "put", "bowl",
          "on", "stove", "out", "close", "drawer"]


def tokenizer_model() -> bytes:
    """A Llama-like BPE model: byte fallback, the prompt's words reachable by
    merges (every prefix of "▁word" is a piece)."""
    extra = [(_WS, -2.0)] + [(c, -5.0) for c in "abcdefghijklmnopqrstuvwxyz:?"]
    seen = {p for p, _ in extra}
    for w in _WORDS:
        for k in range(1, len(w) + 1):
            piece = _WS + w[:k]
            if piece not in seen:
                seen.add(piece)
                extra.append((piece, -4.0 + k / 2))
    return _model(_llama_like_pieces(extra))


def _export_dir(path, head):
    params = init_openvla_params(jax.random.PRNGKey(0), CFG, LIBERO, dtype=jnp.float32,
                                 head=head, with_lm_head=True)
    base = {k: params[k] for k in ("llm", "vision_backbone", "projector")}
    d = JH.export_openvla_checkpoint(CFG, base, str(path), norm_stats=STATS)
    (path / "tokenizer.model").write_bytes(tokenizer_model())
    export_module_pt(params["proprio_projector"], "proprio_projector", d, 10)
    if head is not None:
        export_module_pt(params["action_head"], "action_head", d, 10)
    if head == "diffusion":
        export_module_pt(params["noisy_action_projector"], "noisy_action_projector", d, 10)
    return d


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_api")
    return {"l1": _export_dir(root / "l1", "l1"),
            "diffusion": _export_dir(root / "diffusion", "diffusion")}


def eval_cfg(ckpt, head="l1", device_preprocess=False, **kw):
    return types.SimpleNamespace(**{
        "pretrained_checkpoint": ckpt, "num_images_in_input": 2, "center_crop": True,
        "use_l1_regression": head == "l1", "use_diffusion": head == "diffusion",
        "use_film": False, "use_proprio": True, "unnorm_key": "libero_spatial",
        "num_open_loop_steps": 8, "model_family": "openvla",
        "device_preprocess": device_preprocess, "num_diffusion_steps": DIFFUSION_STEPS,
        "device": "cpu", **kw})


@pytest.fixture
def jax_fp32(monkeypatch):
    """JAX's get_vla with its loader pinned to fp32, and no tokenizer switch
    from the environment."""
    load = JH.load_openvla_checkpoint
    monkeypatch.setattr(JH, "load_openvla_checkpoint",
                        lambda ckpt, dtype=None: load(ckpt, dtype=jnp.float32))
    monkeypatch.delenv("OPENVLA_HF_TOKENIZER", raising=False)
    monkeypatch.delenv("OPENVLA_ALLOW_FAKE_TOKENIZER", raising=False)


def observation(rng, hw=(120, 160)):
    return {"full_image": rng.integers(0, 256, (*hw, 3), dtype=np.uint8),
            "wrist_image": rng.integers(0, 256, (*hw, 3), dtype=np.uint8),
            "state": rng.uniform(-1.2, 1.2, 8).astype(np.float32)}


def _modules(load, cfg, head):
    mods = {"proprio_projector": load.get_proprio_projector(cfg)}
    if head != "discrete":
        mods["action_head"] = load.get_action_head(cfg)
    if head == "diffusion":
        mods["noisy_action_projector"] = load.get_noisy_action_projector(cfg)
    return mods


@pytest.mark.parametrize("head,device_preprocess",
                         [("l1", False), ("l1", True), ("diffusion", False),
                          ("diffusion", True), ("discrete", False)],
                         ids=["l1-staged", "l1-device", "diffusion-staged",
                              "diffusion-device-falls-back", "discrete-staged"])
def test_get_vla_action_matches_jax(ckpts, jax_fp32, rng, head, device_preprocess):
    import experiments.robot.openvla_utils as JU

    ckpt = ckpts["diffusion" if head == "diffusion" else "l1"]
    cfg = eval_cfg(ckpt, head, device_preprocess)
    j_vla, p_vla = JU.get_vla(cfg), PU.get_vla(cfg, dtype=torch.float32)
    assert p_vla.head == j_vla.head == head
    assert p_vla.norm_stats == j_vla.norm_stats == STATS
    assert p_vla.device == torch.device("cpu")
    assert ("lm_head" in p_vla.params["llm"]) == (head == "discrete")
    if head == "diffusion":
        noise = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (
            1, LIBERO.num_actions_chunk, LIBERO.action_dim), dtype=jnp.float32))
        p_vla.predict_action = functools.partial(p_vla.predict_action,
                                                 noise=torch.from_numpy(noise))
    size = CFG.vision_configs[0].image_size
    obs = observation(rng, (size, size) if head == "l1" and device_preprocess else (120, 160))
    j_obs, p_obs = dict(obs), dict(obs)
    want = JU.get_vla_action(cfg, j_vla, JU.get_processor(cfg), j_obs, "put the bowl on the stove",
                             **_modules(JU, cfg, head))
    got = PU.get_vla_action(cfg, p_vla, PU.get_processor(cfg), p_obs, "put the bowl on the stove",
                            **_modules(PU, cfg, head))
    assert len(got) == len(want) == 8 and got[0].shape == (7,)
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p_obs["state"], j_obs["state"], rtol=0, atol=1e-7)
    if head == "l1" and device_preprocess:
        assert p_obs["state"] is obs["state"]          # the device path leaves it raw
    else:
        assert np.abs(p_obs["state"]).max() <= 1.0     # normalized and clipped on the host


def test_device_preprocess_path_slices_the_open_loop_steps(ckpts, rng):
    cfg = eval_cfg(ckpts["l1"], "l1", device_preprocess=True, num_open_loop_steps=3)
    vla = PU.get_vla(cfg, dtype=torch.float32)
    acts = PU.get_vla_action(cfg, vla, None, observation(rng), "close the drawer",
                             **_modules(PU, cfg, "l1"))
    assert len(acts) == 3 and all(a.shape == (7,) and np.isfinite(a).all() for a in acts)
    # the masked gripper dim passes through; the others within the q01/q99 bounds
    assert np.abs(np.stack(acts)[:, :6]).max() <= 0.9 + 1e-5


def test_get_vla_quantization_flags_and_switches(ckpts, rng):
    from openvla_oft_tpu_torch.ops.quant import quantize_tree

    cfg = eval_cfg(ckpts["l1"], load_vision_in_8bit=True, vit_fused=True)
    vla = PU.get_vla(cfg, dtype=torch.float32)
    assert vla.vit_fused and not vla.int4_a8
    # the LLM keeps its folds; an int8 ViT keeps its LN affines, its
    # LayerScales folded (tiny widths are below the 1024 quantization floor)
    assert vla.params["llm"]["layers"]["attn"]["wqkv"]["kernel"].dtype == torch.float32
    for vb in vla.params["vision_backbone"].values():
        assert "ls1" not in vb["layers"] and "scale" in vb["layers"]["norm1"]
    q8 = quantize_tree(vla.params["llm"], min_dim=32, bits=8)
    assert q8["layers"]["attn"]["wqkv"]["kernel"].dtype == torch.int8
    vla4 = PU.get_vla(eval_cfg(ckpts["l1"], load_in_4bit=True, int4_a8=True), dtype=torch.float32)
    assert vla4.int4_a8 and "scale" in vla4.params["llm"]["layers"]["attn_norm"]
    acts = PU.get_vla_action(cfg, vla, None, observation(rng), "put the bowl on the stove",
                             **_modules(PU, cfg, "l1"))
    assert np.isfinite(np.stack(acts)).all()


def test_random_checkpoints_and_their_switches():
    cfg = eval_cfg("random:tiny", fake_norm_stats=True, zero_init=True)
    vla = PU.get_vla(cfg, dtype=torch.float32)
    assert vla.cfg.llm_backbone_id == "tiny-llama" and vla.cfg.num_images_in_input == 2
    assert list(vla.norm_stats) == ["libero_bench"]
    assert all(float(t.abs().max()) == 0.0 for t in
               [vla.params["llm"]["embed"]["embedding"], vla.params["projector"]["fc1"]["kernel"]])
    drawn = PU.get_vla(eval_cfg("random:tiny"), dtype=torch.float32)
    assert drawn.norm_stats is None and float(drawn.params["llm"]["embed"]["embedding"].std()) > 0
    from openvla_oft_tpu_torch.processing.processor import FakeLlamaTokenizer
    assert isinstance(drawn.tokenizer, FakeLlamaTokenizer)
    assert PU.random_model_config("random:7b", 2, False).llm_backbone_id == "llama2-7b-pure"


def test_film_backbone_comes_from_its_pt(tmp_path, ckpts):
    from openvla_oft_tpu.models.vision_backbone import init_film, init_vision_backbone
    from openvla_oft_tpu.training.checkpoint import export_film_vision_backbone_pt
    from openvla_oft_tpu_torch.training.checkpoint import import_film_vision_backbone_pt

    cfg = eval_cfg(ckpts["l1"])
    cfg.use_film = True
    with pytest.raises(FileNotFoundError, match="vision_backbone"):
        PU.get_vla(cfg, dtype=torch.float32)
    film_cfg = dataclasses.replace(CFG, use_film=True)
    path = export_film_vision_backbone_pt(
        init_vision_backbone(jax.random.PRNGKey(1), film_cfg, dtype=jnp.float32),
        init_film(jax.random.PRNGKey(2), film_cfg, dtype=jnp.float32), film_cfg,
        ckpts["l1"], 10)
    try:
        vla = PU.get_vla(cfg, dtype=torch.float32)
        _, film = import_film_vision_backbone_pt(path, P_CFG)
        assert vla.cfg.use_film
        for name in film:
            for proj in ("scale", "shift"):
                for leaf in ("kernel", "bias"):
                    assert torch.equal(vla.params["film"][name][proj][leaf], film[name][proj][leaf])
    finally:
        import os
        os.remove(path)


# === loud failures ===
def test_missing_tokenizer_fails_loudly(tmp_path, ckpts):
    import shutil

    d = tmp_path / "no_tok"
    shutil.copytree(ckpts["l1"], d)
    (d / "tokenizer.model").unlink()
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        PU._try_tokenizer(str(d))
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        PU.get_vla(eval_cfg(str(d)), dtype=torch.float32)
    from openvla_oft_tpu_torch.processing.processor import FakeLlamaTokenizer
    assert isinstance(PU._try_tokenizer("random:tiny"), FakeLlamaTokenizer)
    assert isinstance(PU._try_tokenizer(str(d), allow_fake=True), FakeLlamaTokenizer)


def test_discrete_head_needs_the_lm_head(tmp_path):
    params = init_openvla_params(jax.random.PRNGKey(0), CFG, LIBERO, dtype=jnp.float32,
                                 head=None, with_lm_head=False)
    d = JH.export_openvla_checkpoint(CFG, {k: params[k] for k in ("llm", "vision_backbone",
                                                                 "projector")},
                                     str(tmp_path / "c"), norm_stats=STATS)
    (tmp_path / "c" / "tokenizer.model").write_bytes(tokenizer_model())
    with pytest.raises(KeyError, match="language_model.lm_head.weight"):
        PU.get_vla(eval_cfg(d, "discrete"), dtype=torch.float32)
    assert "lm_head" not in PU.get_vla(eval_cfg(d, "l1"), dtype=torch.float32).params["llm"]


def test_hub_ids_raise(ckpts):
    assert PU.model_is_on_hf_hub("moojink/openvla-7b-oft-finetuned-libero-spatial")
    assert not PU.model_is_on_hf_hub(ckpts["l1"])
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        PU.get_vla(eval_cfg("moojink/openvla-7b-oft-finetuned-libero-spatial"))
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        PU.get_action_head(eval_cfg("moojink/openvla-7b-oft-finetuned-libero-spatial"))


def _vision_trees_match(got: dict, want: dict, atol: float) -> None:
    """The port's vision tree against JAX's leaf for leaf: paths, shapes and
    dtypes equal; int8 codes and fp32 scales bitwise; floats within atol
    (the two sides' LayerNorm folds sum in their own order)."""
    got = {p: t for p, t in _flat(got).items()}
    want = {p: np.asarray(w) for p, w in _flat(want).items()}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape and str(g.dtype).replace("torch.", "") == str(w.dtype), \
            path
        if g.dtype == torch.int8 or path.endswith("_s"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=path)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("flags", [{"joint_vit": True},
                                   {"load_vision_in_8bit": True, "joint_vit_int8": True},
                                   {"load_in_8bit": True, "joint_vit_int8": True}],
                         ids=["joint_vit", "vision8-joint_vit_int8", "int8-joint_vit_int8"])
def test_get_vla_joint_vit_is_jaxs(ckpts, jax_fp32, rng, flags):
    """`joint_vit` and `joint_vit_int8` (`tests/test_eval_api.py:68-75,
    189-202`): the vision tree is {"joint"}, JAX's loader's leaf for leaf;
    int8 builds it from the unfolded trees (its LN affines n1_g ... n2_b
    stacked) and quantizes it after (qkv_k int8 beside qkv_s), the projector
    quantized as before; the joint policy's actions within the eval
    parity's bound of JAX's."""
    import experiments.robot.openvla_utils as JU

    cfg = eval_cfg(ckpts["l1"], device_preprocess=True, **flags)
    j_vla, p_vla = JU.get_vla(cfg), PU.get_vla(cfg, dtype=torch.float32)
    vision = p_vla.params["vision_backbone"]
    assert set(vision) == set(j_vla.params["vision_backbone"]) == {"joint"}
    _vision_trees_match(vision, j_vla.params["vision_backbone"], atol=1e-6)
    layers = vision["joint"]["layers"]
    if "joint_vit_int8" in flags:
        assert layers["qkv_k"].dtype == torch.int8
        assert {"qkv_s", "n1_g", "n2_b"} <= set(layers)
    else:
        assert layers["qkv_k"].dtype == torch.float32 and "n1_g" not in layers
    size = CFG.vision_configs[0].image_size
    obs = observation(rng, (size, size))
    want = JU.get_vla_action(cfg, j_vla, None, dict(obs), "put the bowl on the stove",
                             **_modules(JU, cfg, "l1"))
    got = PU.get_vla_action(cfg, p_vla, None, dict(obs), "put the bowl on the stove",
                            **_modules(PU, cfg, "l1"))
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=RTOL, atol=ATOL)


def test_joint_vit_conditions_are_jaxs(ckpts):
    """As JAX's loader (`experiments/robot/openvla_utils.py:205-220`): no
    joint pair under `load_in_4bit`, with FiLM, for the flag of the other
    precision (`joint_vit` under an int8 vision, `joint_vit_int8` under a
    bf16 one), or for one backbone."""
    names = {"featurizer", "fused_featurizer"}
    for flags in ({"load_in_4bit": True, "joint_vit": True, "joint_vit_int8": True},
                  {"load_vision_in_8bit": True, "joint_vit": True},
                  {"joint_vit_int8": True}):
        vla = PU.get_vla(eval_cfg(ckpts["l1"], **flags), dtype=torch.float32)
        assert set(vla.params["vision_backbone"]) == names, flags
    film = PU.get_vla(eval_cfg("random:tiny", use_film=True, joint_vit=True),
                      dtype=torch.float32)
    assert set(film.params["vision_backbone"]) == names and "film" in film.params
    from openvla_oft_tpu_torch.bridge import param_spec
    from openvla_oft_tpu_torch.config import OpenVLAConfig
    from openvla_oft_tpu_torch.constants import LIBERO as P_LIBERO
    from openvla_oft_tpu_torch.scripts.bench_entry import _meta

    one = OpenVLAConfig(vision_backbone_id="dinov2-vit-l", llm_backbone_id="llama2-7b-pure")
    single = deploy.serving_params(_meta(param_spec(one, P_LIBERO)), joint_vit=True,
                                   vision_configs=one.vision_configs)
    assert set(single["vision_backbone"]) == {"featurizer"}


def test_jpeg_roundtrip_raises_without_tf_and_pil(monkeypatch, rng):
    """The name is older than the port's codec: with `tensorflow` and `PIL`
    hidden from `__import__` (importing either raises, as on the card), the
    port's round trip gives JAX's TF answer, and its staged pipeline the
    same pixels as on TF's round-tripped frames."""
    import openvla_oft_tpu.processing.image_processing as JI
    from openvla_oft_tpu_torch.processing import image_processing as PI

    pytest.importorskip("tensorflow")
    frames = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8),
              rng.integers(0, 256, (24, 40, 3), dtype=np.uint8),
              rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)]
    want = [JI.jpeg_roundtrip(f) for f in frames]                      # TF
    want_pixels = PI.prepare_images_for_policy(want, P_CFG, use_jpeg_roundtrip=False,
                                               resize_size=28)
    real_import = builtins.__import__

    def hide(name, *args, **kw):
        if name.split(".")[0] in ("tensorflow", "PIL"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", hide)
    for name in ("tensorflow", "PIL"):
        with pytest.raises(ImportError):
            __import__(name)
    for f, w in zip(frames, want):
        np.testing.assert_array_equal(PI.jpeg_roundtrip(f), w)
    got = PI.prepare_images_for_policy(frames, P_CFG, resize_size=28)
    torch.testing.assert_close(got, want_pixels, rtol=0, atol=0)


# === the processor transform and the staged pipeline against JAX ===
@pytest.mark.parametrize("strategy", ["resize-naive", "resize-crop", "letterbox"])
@pytest.mark.parametrize("hw", [(40, 64), (64, 40), (33, 80), (28, 28)])
def test_resize_strategies_match_jax(rng, strategy, hw):
    from openvla_oft_tpu.processing.image_processing import make_device_transform as j_mdt
    from openvla_oft_tpu_torch.processing.image_processing import make_device_transform as p_mdt

    cfg = dataclasses.replace(CFG, image_resize_strategy=strategy)
    frames = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = np.asarray(j_mdt(cfg)(jnp.asarray(frames)))
    got = p_mdt(port_config(cfg))(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (2, 2, 28, 28, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_unknown_resize_strategy_raises():
    from openvla_oft_tpu_torch.processing.image_processing import make_device_transform

    with pytest.raises(ValueError, match="not supported"):
        make_device_transform(dataclasses.replace(P_CFG, image_resize_strategy="pad"))


def test_prepare_images_for_policy_matches_jax(rng):
    """Stage by stage, each on the same input: the JPEG round trip (TF on
    both sides) exact; the lanczos3 resize to 224 with its rounding and the
    0.9 crop with its floor(v + v/510) rule at most one LSB apart on at most
    0.1% of pixels (the bound of tests/test_torch_serve.py, where fp32 sums
    in another order cross a rounding boundary); the processor transform
    within 1e-5. End to end on frames already at 224 without the crop (no
    uint8 rounding but the JPEG's), within 1e-5."""
    import openvla_oft_tpu.processing.image_processing as JI
    import openvla_oft_tpu_torch.processing.image_processing as PI

    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    jpeg = PI.jpeg_roundtrip(img)
    np.testing.assert_array_equal(jpeg, JI.jpeg_roundtrip(img))
    want = np.asarray(JI.resize_lanczos3(jnp.asarray(jpeg), 224))
    got = torch.clamp(torch.round(PI.resize_lanczos3(torch.from_numpy(jpeg).float()[None], 224)),
                      0, 255).to(torch.uint8)[0].numpy()
    want_crop = np.asarray(JI.center_crop_resize(jnp.asarray(want), 0.9))
    got_crop = PI.center_crop_resize(torch.from_numpy(want.copy())[None], 0.9)[0].numpy()
    for name, a, b in (("resize", got, want), ("crop", got_crop, want_crop)):
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
    np.testing.assert_allclose(
        PI.make_device_transform(P_CFG)(torch.from_numpy(want_crop.copy())[None]).numpy(),
        np.asarray(JI.make_device_transform(CFG)(jnp.asarray(want_crop)[None])),
        rtol=0, atol=1e-5)
    frames = [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8) for _ in range(2)]
    np.testing.assert_allclose(
        PI.prepare_images_for_policy(frames, P_CFG, center_crop=False).numpy(),
        JI.prepare_images_for_policy(frames, CFG, center_crop=False), rtol=0, atol=1e-5)


def test_normalize_proprio_matches_jax(rng):
    from experiments.robot.openvla_utils import normalize_proprio as j_norm
    from openvla_oft_tpu.data.transforms import normalize as j_normalize
    from openvla_oft_tpu_torch.constants import NormalizationType as PN
    from openvla_oft_tpu_torch.data.transforms import normalize

    from openvla_oft_tpu.constants import NormalizationType as JN
    stats = {"min": [-1.0, 0.0, 2.0, -3.0], "max": [1.0, 0.0, 5.0, 3.0],
             "q01": [-0.5, 0.0, 2.5, -2.0], "q99": [0.5, 0.0, 4.5, 2.0],
             "mean": [0.0, 0.0, 3.0, 0.0], "std": [1.0, 0.5, 1.0, 2.0],
             "mask": [True, True, True, False]}
    x = rng.uniform(-4, 6, (5, 4)).astype(np.float32)
    for p_nt, j_nt in zip(PN, JN):
        np.testing.assert_array_equal(normalize(x, stats, p_nt), j_normalize(x, stats, j_nt))
    partial = {"q01": [-0.5, 0.0, 2.5, -2.0], "q99": [0.5, 0.0, 4.5, 2.0]}
    np.testing.assert_array_equal(PU.normalize_proprio(x, partial), j_norm(x, partial))


# === the deploy CLI ===
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("device_preprocess", [True, False], ids=["device", "staged"])
def test_deploy_cli_serves_a_checkpoint(ckpts, monkeypatch, rng, capsys, device_preprocess):
    from openvla_oft_tpu_torch.serving.server import ActionServer, get_action_from_server

    servers = []

    def run_stdlib(self, host, port, background=False):
        servers.append(self)
        return self._run_stdlib(host, port, background=True)

    monkeypatch.setattr(ActionServer, "run", run_stdlib)
    monkeypatch.setattr(PU, "get_vla", functools.partial(PU.get_vla, dtype=torch.float32))
    port = _free_port()
    argv = ["--pretrained-checkpoint", ckpts["l1"], "--device", "cpu", "--host", "127.0.0.1",
            "--port", str(port), "--unnorm-key", "libero_spatial", "--num-images-in-input",
            "2", "--num-open-loop-steps", "8", "--warmup-image-hw", "64,80"]
    deploy.main(argv + (["--device-preprocess"] if device_preprocess else []))
    out = capsys.readouterr().out
    assert "[deploy] warmup run:" in out and f"serving /act on 127.0.0.1:{port}" in out
    obs = observation(rng)
    try:
        served = get_action_from_server({**obs, "instruction": "put the bowl on the stove"},
                                        f"http://127.0.0.1:{port}/act")
    finally:
        servers[0].shutdown()
    cfg = deploy.DeployConfig(pretrained_checkpoint=ckpts["l1"], device="cpu",
                              unnorm_key="libero_spatial", num_images_in_input=2,
                              num_open_loop_steps=8, device_preprocess=device_preprocess)
    vla = PU.get_vla(cfg)
    want = PU.get_vla_action(cfg, vla, None, dict(obs), "put the bowl on the stove",
                             **_modules(PU, cfg, "l1"))
    assert isinstance(served, np.ndarray) and served.shape == (8, 7)
    np.testing.assert_allclose(served, np.stack(want), rtol=0, atol=1e-6)


def test_openvla_server_checks_the_unnorm_key(ckpts):
    for key, match in (("", "must be set"), ("bridge", "not found")):
        cfg = deploy.DeployConfig(pretrained_checkpoint=ckpts["l1"], device="cpu",
                                  unnorm_key=key, num_images_in_input=2, warmup=False)
        with pytest.raises(ValueError, match=match):
            deploy.OpenVLAServer(cfg)


@pytest.mark.parametrize("argv,match", [
    ([], "exactly one"),
    (["--random-weights", "--pretrained-checkpoint", "x"], "exactly one"),
    (["--random-weights", "--int4-a8"], "needs --load-in-4bit"),
    (["--random-weights", "--load-in-4bit", "--load-in-8bit"], "at most one"),
    (["--random-weights", "--platform", "bridge"], "must be one of")])
def test_deploy_cli_refuses_bad_flags(argv, match, capsys):
    with pytest.raises(SystemExit):
        deploy.main(argv)
    assert match in capsys.readouterr().err
