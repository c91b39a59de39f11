"""The port's checkpoint I/O against the JAX package's and the `safetensors` package.

- `utils/safetensors_io.py`: the port's reader on files `safetensors.numpy`
  and `safetensors.torch` write, and `safetensors.safe_open` on the files
  the port writes (bf16, fp32, int8 and the other dtypes; one shard, and
  two with an index). Exact.
- `utils/hf_import.py`: a tiny checkpoint written by JAX's exporter loads
  into equal trees through JAX's loader and the port's, bit for bit; the
  port's bf16 export, read by JAX's loader, equals the port's tree upcast to
  fp32, bit for bit, in one file and in shards. The lm_head rule per head.
- `training/checkpoint.py`: the per-module `.pt` importers on state dicts
  with DDP "module." prefixes (the L1 and diffusion heads, both projectors,
  the FiLMed vision backbone, plain and with peft LoRA factors), against
  JAX's importers: equal, and within 1e-6 where LoRA merges in fp32.
  The exporters against JAX's on the same numpy trees: the same keys and
  bitwise equal tensors, each side's importer reading the other's file back
  to the tree. The LoRA merge against JAX's within one ulp of W's dtype.
  The background save (a host snapshot first, the write on a thread, its
  error raised on wait) and the prune of all but the newest step.
- `scripts/convert_weights.py`: import then export gives the same tensors.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvla_oft_tpu.config as JC
import openvla_oft_tpu.training.checkpoint as JCK
import openvla_oft_tpu.utils.hf_import as JH
import openvla_oft_tpu_torch.training.checkpoint as PCK
import openvla_oft_tpu_torch.utils.hf_import as PH
from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu_torch.bridge import params_from_numpy
from openvla_oft_tpu_torch.utils import safetensors_io as S
from test_torch_import import port_config

CFG = JC.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama")
P_CFG = port_config(CFG)


def flat(tree, prefix=""):
    """{path: numpy array} of a JAX or port tree."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items() for k, v in flat(sub, f"{prefix}/{name}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy()}
    return {prefix: np.asarray(tree)}


def assert_trees_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_params():
    params = init_openvla_params(jax.random.PRNGKey(0), CFG, LIBERO, dtype=jnp.float32,
                                 head=None)
    return {k: params[k] for k in ("llm", "vision_backbone", "projector")}


STATS = {"libero_spatial": {"action": {"q01": [-0.9] * 7, "q99": [0.9] * 7,
                                       "min": [-1.0] * 7, "max": [1.0] * 7},
                            "proprio": {"q01": [-0.9] * 8, "q99": [0.9] * 8}}}


# === safetensors ===
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32,
          "f64": torch.float64, "i8": torch.int8, "u8": torch.uint8, "i32": torch.int32,
          "i64": torch.int64, "bool": torch.bool}


def _sample(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000) + 1, shape, generator=g,
                         dtype=torch.int64).to(dtype)


def _tensors(names):
    shapes = [(3, 5), (7,), (), (2, 0, 4), (4, 3, 2)]
    return {f"t.{n}.{i}": _sample(DTYPES[n], s, 17 * i + j)
            for j, n in enumerate(names) for i, s in enumerate(shapes)}


@pytest.mark.parametrize("writer", ["torch", "numpy"])
def test_port_reader_reads_the_safetensors_writers(tmp_path, writer):
    names = list(DTYPES) if writer == "torch" else [n for n in DTYPES if n != "bf16"]
    want = _tensors(names)
    path = str(tmp_path / "a.safetensors")
    if writer == "torch":
        from safetensors.torch import save_file
        save_file(want, path, metadata={"format": "pt"})
    else:
        from safetensors.numpy import save_file
        save_file({k: v.numpy() for k, v in want.items()}, path, metadata={"format": "np"})
    index = S.SafetensorsIndex(path)
    assert sorted(index.keys()) == sorted(want)
    assert index.metadata == {"format": "pt" if writer == "torch" else "np"}
    for k, v in want.items():
        got = index(k)
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert index.dtype(k) == v.dtype and index.shape(k) == tuple(v.shape)
        assert torch.equal(got, v), k
    with pytest.raises(KeyError):
        index("missing")


def test_safe_open_reads_the_port_writer(tmp_path):
    from safetensors import safe_open

    want = _tensors(list(DTYPES))
    # a transposed view and a tensor needing no copy go through as written
    want["view.T"] = torch.arange(12, dtype=torch.float32).reshape(3, 4).T
    path = S.save_file(want, str(tmp_path / "b.safetensors"), metadata={"k": "v"})
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(want)
        assert f.metadata() == {"k": "v"}
        for k, v in want.items():
            got = f.get_tensor(k)
            assert got.dtype == v.dtype and torch.equal(got, v), k
    header, start = S.read_header(path)
    assert start % 8 == 0
    # every tensor starts aligned to its own element size
    for name, info in header.items():
        if name != "__metadata__":
            itemsize = torch.empty((), dtype=S.DTYPES[info["dtype"]]).element_size()
            assert (start + info["data_offsets"][0]) % itemsize == 0, name


def test_two_shards_with_an_index(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file

    want = _tensors(["bf16", "f32", "i8"])
    names = sorted(want)
    shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    hf = tmp_path / "hf"
    hf.mkdir()
    for file, keys in shards.items():
        save_file({k: want[k] for k in keys}, str(hf / file))
    (hf / S.INDEX_FILE).write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: f for f, ks in shards.items() for k in ks}}))
    index = S.SafetensorsIndex(str(hf))
    assert len(index.files) == 2 and sorted(index.keys()) == names
    for k in names:
        assert torch.equal(index(k), want[k]), k
    # The port's sharded writer, read back by safe_open shard by shard.
    out = tmp_path / "port"
    out.mkdir()
    paths = S.save_sharded(want, str(out), max_shard_bytes=200)
    assert len(paths) > 1
    weight_map = json.loads((out / S.INDEX_FILE).read_text())["weight_map"]
    assert sorted(weight_map) == names
    for k in names:
        with safe_open(str(out / weight_map[k]), framework="pt") as f:
            assert torch.equal(f.get_tensor(k), want[k]), k
    assert all(torch.equal(S.SafetensorsIndex(str(out))(k), want[k]) for k in names)


def test_reader_refuses_a_bad_header(tmp_path):
    path = tmp_path / "bad.safetensors"
    path.write_bytes((10 ** 9).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="header length"):
        S.SafetensorsIndex(str(path))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no \\*.safetensors"):
        S.SafetensorsIndex(str(tmp_path / "empty"))


# === HF checkpoint dirs ===
def test_jax_export_loads_equal_through_both_loaders(tmp_path, jax_params):
    d = JH.export_openvla_checkpoint(CFG, jax_params, str(tmp_path / "ckpt"),
                                     norm_stats=STATS)
    j_cfg, j_params, j_stats = JH.load_openvla_checkpoint(d)
    p_cfg, p_params, p_stats = PH.load_openvla_checkpoint(d, dtype=torch.float32)
    assert_trees_equal(j_params, p_params)
    assert j_stats == p_stats == STATS
    assert (p_cfg.vision_backbone_id, p_cfg.llm_backbone_id) == \
        (j_cfg.vision_backbone_id, j_cfg.llm_backbone_id)
    assert p_cfg.llm == P_CFG.llm and p_cfg.vision_configs == P_CFG.vision_configs
    # in the stored dtype, and on a "device" given by name
    _, stored, _ = PH.load_openvla_checkpoint(d, dtype=None, device="cpu")
    assert_trees_equal(j_params, stored)


def test_an_empty_config_norm_stats_reads_the_sidecar(tmp_path, jax_params):
    """JAX's exporter writes `"norm_stats": {}` when it has none; a
    `dataset_statistics.json` beside it is the checkpoint's statistics. The
    port reads the sidecar (`utils/hf_import.py::_read_norm_stats`); the JAX
    loader reads it only when the key is missing, and keeps the `{}`."""
    d = JH.export_openvla_checkpoint(CFG, jax_params, str(tmp_path / "ckpt"))
    with open(os.path.join(d, "config.json")) as f:
        assert json.load(f)["norm_stats"] == {}
    with open(os.path.join(d, "dataset_statistics.json"), "w") as f:
        json.dump(STATS, f)
    assert PH.load_openvla_checkpoint(d, dtype=torch.float32)[2] == STATS
    assert JH.load_openvla_checkpoint(d)[2] == {}


@pytest.mark.parametrize("max_shard_bytes", [None, 64 * 1024], ids=["one-file", "sharded"])
def test_port_bf16_export_reads_back_in_jax(tmp_path, jax_params, max_shard_bytes):
    tree = params_from_numpy(jax_params, dtype=torch.bfloat16)
    d = PH.export_openvla_checkpoint(P_CFG, tree, str(tmp_path / "ckpt"), norm_stats=STATS,
                                     max_shard_bytes=max_shard_bytes)
    files = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))
    assert (len(files) > 1) == (max_shard_bytes is not None)
    assert all(S.SafetensorsIndex(os.path.join(d, f)).dtype(k) == torch.bfloat16
               for f in files for k in S.SafetensorsIndex(os.path.join(d, f)).keys())
    _, j_params, j_stats = JH.load_openvla_checkpoint(d)
    assert_trees_equal(j_params, jax.tree_util.tree_map(
        lambda t: t.float().numpy(), tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert j_stats == STATS
    # and back into the port, bf16 as written, bit for bit
    _, back, stats = PH.load_openvla_checkpoint(d, dtype=None)
    assert_trees_equal(tree, back)
    assert all(t.dtype == torch.bfloat16 for t in flat_tensors(back))
    assert stats == STATS


def flat_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in flat_tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in flat_tensors(v)]
    return [tree]


def test_the_lm_head_rule_per_head(tmp_path, jax_params):
    with_head = JH.export_openvla_checkpoint(CFG, jax_params, str(tmp_path / "with"))
    no_lm = {**jax_params, "llm": {k: v for k, v in jax_params["llm"].items()
                                   if k != "lm_head"}}
    without = JH.export_openvla_checkpoint(CFG, no_lm, str(tmp_path / "without"))
    assert "lm_head" in PH.load_openvla_checkpoint(with_head)[1]["llm"]
    assert "lm_head" in PH.load_openvla_checkpoint(with_head, head="discrete")[1]["llm"]
    for head in ("l1", "diffusion"):
        assert "lm_head" not in PH.load_openvla_checkpoint(with_head, head=head)[1]["llm"]
        assert "lm_head" not in PH.load_openvla_checkpoint(without, head=head)[1]["llm"]
    # JAX skips a missing lm_head silently; so does the port without a head
    assert "lm_head" not in JH.load_openvla_checkpoint(without)[1]["llm"]
    assert "lm_head" not in PH.load_openvla_checkpoint(without)[1]["llm"]
    with pytest.raises(KeyError, match="language_model.lm_head.weight"):
        PH.load_openvla_checkpoint(without, head="discrete")


def test_extras_from_copies_the_unported_tensors(tmp_path, jax_params):
    src = tmp_path / "src"
    JH.export_openvla_checkpoint(CFG, jax_params, str(src))
    extra = {"vision_backbone.featurizer.norm.weight": np.arange(48, dtype=np.float32)}
    from safetensors.numpy import save_file
    save_file(extra, str(src / "extra.safetensors"))
    out = PH.export_openvla_checkpoint(P_CFG, params_from_numpy(jax_params), str(tmp_path / "o"),
                                       extras_from=str(src))
    index = S.SafetensorsIndex(out)
    np.testing.assert_array_equal(index("vision_backbone.featurizer.norm.weight").numpy(),
                                  extra["vision_backbone.featurizer.norm.weight"])
    assert sorted(index.keys()) == sorted(S.SafetensorsIndex(str(src)).keys())


# === per-module .pt files ===
def _ddp(sd):
    return {f"module.{k}": v for k, v in sd.items()}


def _save_pt(sd, path):
    torch.save(_ddp({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}), str(path))
    return str(path)


def _head_sd(prefix, d_in, hidden, d_out, rng):
    sd = {}

    def lin(name, i, o):
        sd[f"{prefix}{name}.weight"] = rng.standard_normal((o, i)).astype(np.float32)
        sd[f"{prefix}{name}.bias"] = rng.standard_normal(o).astype(np.float32)

    def ln(name, n):
        sd[f"{prefix}{name}.weight"] = rng.standard_normal(n).astype(np.float32)
        sd[f"{prefix}{name}.bias"] = rng.standard_normal(n).astype(np.float32)

    ln("layer_norm1", d_in)
    lin("fc1", d_in, hidden)
    for i in range(2):
        ln(f"mlp_resnet_blocks.{i}.ffn.0", hidden)
        lin(f"mlp_resnet_blocks.{i}.ffn.1", hidden, hidden)
    ln("layer_norm2", hidden)
    lin("fc2", hidden, d_out)
    return sd


@pytest.mark.parametrize("head,prefix", [("l1", "model."),
                                         ("diffusion", "noise_predictor.mlp_resnet.")])
def test_action_head_pt_matches_jax(tmp_path, rng, head, prefix):
    path = _save_pt(_head_sd(prefix, 7 * 64, 64, 7, rng),
                    tmp_path / "action_head--50_checkpoint.pt")
    assert PCK.find_checkpoint_file(str(tmp_path), "action_head") == path
    assert_trees_equal(JCK.import_action_head_pt(path, head=head),
                       PCK.import_action_head_pt(path, head=head))
    bf16 = PCK.import_action_head_pt(path, head=head, dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in flat_tensors(bf16))


@pytest.mark.parametrize("kind,d_in", [("proprio", 8), ("noisy_action", 1)])
def test_projector_pt_matches_jax(tmp_path, rng, kind, d_in):
    sd = {"fc1.weight": rng.standard_normal((64, d_in)).astype(np.float32),
          "fc1.bias": rng.standard_normal(64).astype(np.float32),
          "fc2.weight": rng.standard_normal((64, 64)).astype(np.float32),
          "fc2.bias": rng.standard_normal(64).astype(np.float32)}
    path = _save_pt(sd, tmp_path / f"{kind}_projector--3_checkpoint.pt")
    assert_trees_equal(JCK.import_projector_pt(path, kind=kind),
                       PCK.import_projector_pt(path, kind=kind))


def test_find_checkpoint_file_needs_exactly_one(tmp_path):
    with pytest.raises(FileNotFoundError, match="exactly 1 'action_head'"):
        PCK.find_checkpoint_file(str(tmp_path), "action_head")
    for step in (1, 2):
        (tmp_path / f"action_head--{step}_checkpoint.pt").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="found 2"):
        PCK.find_checkpoint_file(str(tmp_path), "action_head")


@pytest.mark.parametrize("lora", [False, True], ids=["plain", "peft-lora"])
def test_film_vision_backbone_pt_matches_jax(tmp_path, lora):
    from openvla_oft_tpu.models.vision_backbone import init_film, init_vision_backbone

    backbone = init_vision_backbone(jax.random.PRNGKey(1), CFG, dtype=jnp.float32)
    film = init_film(jax.random.PRNGKey(2), CFG, dtype=jnp.float32)
    path = JCK.export_film_vision_backbone_pt(backbone, film, CFG, str(tmp_path / "e"), 9)
    sd = torch.load(path, weights_only=True)
    if lora:
        # peft names: the base weight under base_layer, with rank-4 factors
        g = torch.Generator().manual_seed(3)
        for key in [k for k in sd if k.endswith("attn.qkv.weight") or k.endswith("mlp.fc2.weight")]:
            w = sd.pop(key)
            stem = key[: -len(".weight")]
            sd[f"{stem}.base_layer.weight"] = w
            sd[f"{stem}.lora_A.default.weight"] = torch.randn((4, w.shape[1]), generator=g)
            sd[f"{stem}.lora_B.default.weight"] = torch.randn((w.shape[0], 4), generator=g)
            bias = sd.pop(f"{stem}.bias")
            sd[f"{stem}.base_layer.bias"] = bias
    ddp = str(tmp_path / "vision_backbone--9_checkpoint.pt")
    torch.save(_ddp(sd), ddp)
    jb, jf = JCK.import_film_vision_backbone_pt(ddp, CFG)
    pb, pf = PCK.import_film_vision_backbone_pt(ddp, P_CFG)
    assert_trees_equal(jf, pf)
    if not lora:
        assert_trees_equal(jb, pb)
        assert_trees_equal(backbone, pb)
        return
    fj, fp = flat(jb), flat(pb)
    assert sorted(fj) == sorted(fp)
    for k in fj:        # W + B @ A in fp32, the sums in another order
        np.testing.assert_allclose(fp[k], fj[k], rtol=1e-6, atol=1e-6, err_msg=k)


# === the exporters, the merge and run management ===
def _same_state_dicts(a_path, b_path):
    a = torch.load(a_path, weights_only=True)
    b = torch.load(b_path, weights_only=True)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32, k
        assert a[k].shape == b[k].shape and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("head,module", [("l1", "action_head"), ("diffusion", "action_head"),
                                         ("l1", "proprio_projector"),
                                         ("diffusion", "noisy_action_projector")])
def test_module_pt_export_matches_jax(tmp_path, head, module):
    """`export_module_pt` against JAX's on the same numpy tree: the same keys
    and bitwise equal fp32 (out, in) tensors; the port's importer reads the
    JAX file back to the tree and JAX's importer the port's."""
    full = init_openvla_params(jax.random.PRNGKey(4), CFG, LIBERO, dtype=jnp.float32,
                               head=head)
    tree = jax.tree_util.tree_map(np.asarray, full[module])
    jpath = JCK.export_module_pt(tree, module, str(tmp_path / "jax"), 7)
    ppath = PCK.export_module_pt(params_from_numpy(tree), module, str(tmp_path / "port"),
                                 "latest")
    assert os.path.basename(ppath) == f"{module}--latest_checkpoint.pt"
    _same_state_dicts(jpath, ppath)
    if module == "action_head":
        back_p = PCK.import_action_head_pt(jpath, head=head)
        back_j = JCK.import_action_head_pt(ppath, head=head)
    else:
        kind = module.rsplit("_", 1)[0]
        back_p = PCK.import_projector_pt(jpath, kind=kind)
        back_j = JCK.import_projector_pt(ppath, kind=kind)
    assert_trees_equal(tree, back_p)
    assert_trees_equal(tree, back_j)


def test_film_vision_backbone_export_matches_jax(tmp_path):
    from openvla_oft_tpu.models.vision_backbone import init_film, init_vision_backbone

    backbone = jax.tree_util.tree_map(np.asarray, init_vision_backbone(
        jax.random.PRNGKey(1), CFG, dtype=jnp.float32))
    film = jax.tree_util.tree_map(np.asarray, init_film(jax.random.PRNGKey(2), CFG,
                                                        dtype=jnp.float32))
    jpath = JCK.export_film_vision_backbone_pt(backbone, film, CFG, str(tmp_path / "jax"), 3)
    ppath = PCK.export_film_vision_backbone_pt(params_from_numpy(backbone),
                                               params_from_numpy(film), P_CFG,
                                               str(tmp_path / "port"), 3)
    _same_state_dicts(jpath, ppath)
    pb, pf = PCK.import_film_vision_backbone_pt(jpath, P_CFG)
    jb, jf = JCK.import_film_vision_backbone_pt(ppath, CFG)
    for got in (pb, jb):
        assert_trees_equal(backbone, got)
    for got in (pf, jf):
        assert_trees_equal(film, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_jax_within_one_ulp(jax_params, dtype):
    """`merge_lora_into_params` (leaf by leaf, one stacked layer at a time,
    into a host tree) against JAX's on the same numpy base and LoRA: every
    merged kernel within one ulp of W's dtype, every other leaf equal."""
    from openvla_oft_tpu.training import lora as JL
    from openvla_oft_tpu_torch.training import lora as PL

    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    base = jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jdt)), jax_params)
    rng = np.random.default_rng(8)
    lora = jax.tree_util.tree_map(
        lambda x: (0.05 * rng.standard_normal(x.shape)).astype(np.float32),
        JL.init_lora(jax.random.PRNGKey(1), jax_params, rank=4))
    ref = JL.merge_lora_into_params(jax.tree_util.tree_map(jnp.asarray, base),
                                    jax.tree_util.tree_map(jnp.asarray, lora), rank=4,
                                    alpha=4.0)
    got = PL.merge_lora_into_params(params_from_numpy(base), params_from_numpy(lora), rank=4,
                                    alpha=4.0, out_device="cpu")
    fr, fg = flat(ref), flat(got)
    assert sorted(fr) == sorted(fg)
    for k in fr:
        r = fr[k].astype(np.float32)
        g = fg[k].astype(np.float32)
        ulp = np.spacing(np.abs(r).astype(np.float32))
        if dtype == "bfloat16":
            ulp = ulp * 2.0 ** 16          # bf16 keeps 8 of fp32's 24 significand bits
        assert (np.abs(g - r) <= ulp).all(), k


def test_async_save_snapshots_then_writes(tmp_path):
    """save_checkpoint(block=False) copies the state before it returns (an
    in-place update afterwards does not reach the file), writes in the
    background under a temporary name, and restore waits for it."""
    state = {"trainables": {"w": torch.arange(6.0)}, "optimizer": {"micro": 2, "accum": None}}
    paths = [PCK.save_checkpoint(str(tmp_path), step, state, block=False)
             for step in (1, 2)]
    state["trainables"]["w"].add_(100.0)
    got = PCK.restore_checkpoint(str(tmp_path))
    assert torch.equal(got["trainables"]["w"], torch.arange(6.0))
    assert got["optimizer"] == {"micro": 2, "accum": None}
    assert [os.path.basename(p) for p in paths] == ["000001.pt", "000002.pt"]
    assert sorted(os.listdir(tmp_path)) == ["000001.pt", "000002.pt"]
    assert all(r["write_s"] >= 0 and r["bytes"] == 24 for r in list(PCK.SAVE_LOG)[-2:])


def test_a_failed_background_write_raises_on_wait(tmp_path, monkeypatch):
    def broken(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(PCK.torch, "save", broken)
    PCK.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)}, block=False)
    with pytest.raises(OSError, match="disk full"):
        PCK.wait_for_checkpoints()
    PCK.wait_for_checkpoints()           # nothing left in flight


def test_prune_keeps_the_newest_step_by_number(tmp_path):
    """Steps compare as integers (000010 after 000009), and a temporary file
    left by a killed write is neither kept as the newest nor deleted."""
    for step in (2, 9, 10):
        PCK.save_checkpoint(str(tmp_path), step, {"w": torch.zeros(1)}, block=False)
    (tmp_path / "000011.pt.tmp.123").write_bytes(b"partial")
    PCK.prune_old_steps(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["000010.pt", "000011.pt.tmp.123"]
    assert PCK.latest_step(str(tmp_path)) == 10


# === the converter ===
def test_convert_weights_round_trip(tmp_path, jax_params):
    from openvla_oft_tpu_torch.scripts import convert_weights as CW

    src = PH.export_openvla_checkpoint(P_CFG, params_from_numpy(jax_params, dtype=torch.bfloat16),
                                       str(tmp_path / "hf"), norm_stats=STATS)
    step_file = CW.main(["--direction", "import", "--source", src,
                         "--output", str(tmp_path / "native"), "--step", "3"])
    assert os.path.basename(step_file) == "000003.pt"
    meta = json.loads((tmp_path / "native" / "meta.json").read_text())
    assert meta["llm_backbone_id"] == "tiny-llama" and "tpu_llm_config" in meta
    assert json.loads((tmp_path / "native" / "dataset_statistics.json").read_text()) == STATS
    out = CW.main(["--direction", "export", "--source", str(tmp_path / "native"),
                   "--output", str(tmp_path / "hf2"), "--step", "3"])
    a, b = S.SafetensorsIndex(src), S.SafetensorsIndex(out)
    assert sorted(a.keys()) == sorted(b.keys())
    for k in a.keys():
        assert a(k).dtype == torch.bfloat16 and torch.equal(a(k), b(k)), k
    assert json.loads(open(os.path.join(out, "config.json")).read())["norm_stats"] == STATS


def test_calibrate_script_reads_a_checkpoint_dir(tmp_path, jax_params):
    """`--vla_path DIR`: the LLM, ViTs and projector from the dir (the rest
    drawn from the seed, as the JAX script does)."""
    from openvla_oft_tpu_torch.scripts import calibrate_quant

    d = PH.export_openvla_checkpoint(P_CFG, params_from_numpy(jax_params, dtype=torch.bfloat16),
                                     str(tmp_path / "ckpt"))
    report = calibrate_quant.main(["--vla_path", d, "--device", "cpu", "--min_dim", "32",
                                   "--n_observations", "1", "--weight_errors", "False"])
    assert report["bits"] == 8 and np.isfinite(report["action_l1"]["mean"])
