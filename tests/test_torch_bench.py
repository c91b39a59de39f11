"""The port's bench contract against the JAX package's: the zero tree
(`scripts/bench_entry.py::cheap_params` against `__graft_entry__.py::
_cheap_params`, leaf for leaf, in every quant mode, and with the joint-ViT
arguments against OPENVLA_VIT_JOINT / _INT8), the timed call's inputs
(against `__graft_entry__.entry`'s), the timed call itself (against JAX's
`serve_action_chunk`), `scripts/bench.py`'s one stdout line and its
failures, and `scripts/bench_timing.py::measure`.

The trees are compared at the flagship's widths (so `min_dim=1024`
quantizes what it quantizes at 7B) with the Llama cut to one layer and each
ViT to two blocks; the rest runs at the TINY configs on the CPU."""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
import openvla_oft_tpu.config as JC
import openvla_oft_tpu_torch.config as PC
from openvla_oft_tpu.constants import ALOHA, LIBERO
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu_torch.bridge import param_spec, params_from_numpy
from openvla_oft_tpu_torch.scripts import bench, bench_entry as BE, bench_timing
from test_torch_import import port_config, port_platform

CUT_VISION, CUT_LLM = "bench-cut-dinosiglip", "bench-cut-llama2"
for _mod in (JC, PC):
    _mod._LLM_REGISTRY.setdefault(CUT_LLM, dataclasses.replace(
        _mod._LLM_REGISTRY["llama2-7b-pure"], num_layers=1))
    _mod._VISION_REGISTRY.setdefault(CUT_VISION, tuple(
        dataclasses.replace(v, depth=2)
        for v in _mod._VISION_REGISTRY["dinosiglip-vit-so-224px"]))
CUT = JC.OpenVLAConfig(vision_backbone_id=CUT_VISION, llm_backbone_id=CUT_LLM,
                       num_images_in_input=2)
TINY = JC.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                        num_images_in_input=2)
QUANTS = [None, "int8", "int8_vit", "int4"]
# The arrays of the timed call besides the params, by their names in the JAX
# entry (its args, then the constants its fn closes over).
INPUT_NAMES = ("input_ids", "prompt_mask", "frames", "proprio")
BOUND_NAMES = ("action_low", "action_high", "action_mask", "proprio_low", "proprio_high")


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def torch_dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("quant", QUANTS, ids=lambda q: q or "bf16")
def test_bench_tree_is_jax_cheap_params(quant):
    """Every leaf: the same path, shape and dtype, and all zeros."""
    ref = flat(G._cheap_params(CUT, LIBERO, quant=quant))
    got = flat(BE.cheap_params(port_config(CUT), port_platform(LIBERO), quant=quant,
                               device="cpu"))
    assert sorted(got) == sorted(ref)
    quantized = 0
    for path, r in ref.items():
        g = got[path]
        assert tuple(g.shape) == tuple(r.shape), path
        assert torch_dtype_name(g) == str(r.dtype), path
        assert not bool(g.any()), path      # the JAX leaves are jnp.zeros by construction
        quantized += path.endswith(("scale_w", "scale_w4"))
    # the LLM's 4 stacked linears, the projector's 3, each ViT's 4 stacked ones
    assert quantized == {None: 0, "int8": 4 + 3 + 2 * 4, "int8_vit": 3 + 2 * 4,
                         "int4": 4 + 3 + 2 * 4}[quant]


JOINT_CASES = [(None, "OPENVLA_VIT_JOINT", {"joint_vit": True}, True),
               ("int8", "OPENVLA_VIT_JOINT_INT8", {"joint_vit_int8": True}, True),
               ("int8_vit", "OPENVLA_VIT_JOINT_INT8", {"joint_vit_int8": True}, True),
               ("int4", "OPENVLA_VIT_JOINT_INT8", {"joint_vit_int8": True}, True),
               (None, "OPENVLA_VIT_JOINT_INT8", {"joint_vit_int8": True}, False),
               ("int8", "OPENVLA_VIT_JOINT", {"joint_vit": True}, False)]


@pytest.mark.parametrize("quant,env,flags,joint", JOINT_CASES,
                         ids=["bf16-joint", "int8-joint8", "int8_vit-joint8", "int4-joint8",
                              "bf16-joint8-unused", "int8-joint-unused"])
def test_bench_joint_tree_is_jax_cheap_params(monkeypatch, quant, env, flags, joint):
    """The joint-ViT arguments against `_cheap_params` under the environment
    switch they replace: every leaf the same path, shape and dtype, all
    zeros; the joint tree only where JAX builds it (bf16 for
    OPENVLA_VIT_JOINT, the int8 quants for OPENVLA_VIT_JOINT_INT8)."""
    for name in ("OPENVLA_VIT_JOINT", "OPENVLA_VIT_JOINT_INT8"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(env, "1")
    ref = flat(G._cheap_params(CUT, LIBERO, quant=quant))
    got = flat(BE.cheap_params(port_config(CUT), port_platform(LIBERO), quant=quant,
                               device="cpu", **flags))
    assert sorted(got) == sorted(ref)
    assert any(p.startswith("/vision_backbone/joint/") for p in got) == joint
    for path, r in ref.items():
        g = got[path]
        assert tuple(g.shape) == tuple(r.shape), path
        assert torch_dtype_name(g) == str(r.dtype), path
        assert not bool(g.any()), path


def test_bench_joint_flags(capsys, few_calls):
    """`--vit-joint` times the bf16 joint tree and says so on its line; the
    geometry with FiLM refuses the joint pair; `bench_components` adds the
    joint row in bf16."""
    from openvla_oft_tpu_torch.scripts import bench_components

    bench.main(["--device", "cpu", "--bf16-headline", "--vit-joint"], cfg=port_config(TINY))
    err = capsys.readouterr().err
    assert "# bf16:" in err and "(joint ViT pair)" in err
    with pytest.raises(ValueError, match="FiLM"):
        BE.entry(geometry="aloha", device="cpu", cfg=port_config(TINY), joint_vit=True)
    rows = bench_components.main(["--device", "cpu", "--k", "1", "--skip_full"],
                                 cfg=port_config(TINY))
    assert "vit JOINT pair (G=2 batched)" in rows and len(rows) == 7
    rows = bench_components.main(["--device", "cpu", "--k", "1", "--skip_full", "--quant",
                                  "int8"], cfg=port_config(TINY))
    assert not any("JOINT" in label for label in rows)


@pytest.mark.parametrize("quant,flags", [(None, {}), ("int8", {"load_in_8bit": True}),
                                         ("int8_vit", {"load_vision_in_8bit": True})],
                         ids=["bf16", "int8", "int8_vit"])
def test_bench_recipes_are_the_loaders(quant, flags):
    """bf16, int8 and int8_vit are `serving_params`'s trees, down to the
    strides (the int8 kernels column-major); int4 is not `load_in_4bit`:
    its ViTs are int8, the loader's bf16."""
    from openvla_oft_tpu_torch.serving.deploy import serving_params

    cfg, platform = port_config(CUT), port_platform(LIBERO)
    got = flat(BE.bench_recipe(BE._meta(param_spec(cfg, platform)), quant))
    ref = flat(serving_params(BE._meta(param_spec(cfg, platform)), **flags))
    assert sorted(got) == sorted(ref)
    for path, r in ref.items():
        assert (got[path].shape, got[path].dtype, got[path].stride()) == \
            (r.shape, r.dtype, r.stride()), path
    int4 = flat(BE.bench_recipe(BE._meta(param_spec(cfg, platform)), "int4"))
    loader = flat(serving_params(BE._meta(param_spec(cfg, platform)), load_in_4bit=True))
    vit = [p for p in int4 if p.startswith("/vision_backbone") and p.endswith("scale_w")]
    assert vit and not any(p in loader for p in vit)


def jax_entry(monkeypatch, geometry: str, bucket: int):
    """`__graft_entry__.entry()` at TINY: (fn, args)."""
    monkeypatch.setattr(G, "_flagship_cfg", lambda: TINY)
    monkeypatch.setenv("OPENVLA_BENCH_GEOMETRY", geometry)
    monkeypatch.setenv("OPENVLA_BENCH_BUCKET", str(bucket))
    for name in ("OPENVLA_QUANT", "OPENVLA_USE_FLASH", "OPENVLA_VIT_JOINT"):
        monkeypatch.delenv(name, raising=False)
    return G.entry()


def seeded_params(cfg, platform, seed: int = 0) -> dict:
    """The JAX init's tree (`jax.eval_shape`) filled from a seeded numpy
    generator in fp32: normal(0, 0.02), norm scales 1 + normal(0, 0.02)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_openvla_params(jax.random.PRNGKey(0), cfg, platform,
                                                        dtype=jnp.float32, head="l1"))

    def fill(path, leaf):
        x = rng.normal(0.0, 0.02, leaf.shape).astype(np.float32)
        return x + 1.0 if getattr(path[-1], "key", None) == "scale" else x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


@pytest.mark.parametrize("bucket", [48, 64])
@pytest.mark.parametrize("geometry", ["libero", "aloha"])
def test_entry_inputs_are_jax_entrys(monkeypatch, geometry, bucket):
    fn, args = jax_entry(monkeypatch, geometry, bucket)
    consts = closure(fn)
    ref = {**dict(zip(INPUT_NAMES, args[1:])), **{n: consts[n] for n in BOUND_NAMES}}
    cfg, platform = BE.geometry_of(geometry, port_config(TINY))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(consts["cfg"])
    assert platform is port_platform(consts["platform"])
    got = BE.bench_inputs(cfg, platform, bucket, device="cpu")
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        r = np.asarray(r)
        assert torch_dtype_name(got[name]) == str(r.dtype), name
        np.testing.assert_array_equal(got[name].numpy(), r, err_msg=name)
    assert got["frames"].shape[1] == (3 if geometry == "aloha" else 2)


def test_bucket_below_the_prompt_raises():
    cfg = port_config(TINY)
    with pytest.raises(ValueError, match="bucket must be >= 24"):
        BE.bench_inputs(cfg, port_platform(LIBERO), 23, device="cpu")
    with pytest.raises(ValueError, match="bucket must be >= 24"):
        BE.entry(bucket=16, device="cpu", cfg=cfg)
    with pytest.raises(ValueError, match="geometry"):
        BE.entry(geometry="bridge", device="cpu", cfg=cfg)


@pytest.mark.parametrize("geometry", ["libero", "aloha"])
def test_entry_fn_matches_jax_serve(monkeypatch, geometry):
    """The timed call with seeded random fp32 weights carried across by the
    bridge, against the JAX entry's fn on the same weights and inputs, within
    the serving parity tests' tolerance (tests/test_torch_serve.py)."""
    fn, args = jax_entry(monkeypatch, geometry, 48)
    consts = closure(fn)
    params = seeded_params(consts["cfg"], consts["platform"])
    ref = np.asarray(jax.jit(fn)(params, *args[1:]))
    pfn, pargs = BE.entry(geometry=geometry, device="cpu", cfg=port_config(TINY))
    got = pfn(params_from_numpy(params), *pargs[1:]).numpy()
    platform = ALOHA if geometry == "aloha" else LIBERO
    assert got.shape == (1, platform.num_actions_chunk, platform.action_dim)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.fixture
def few_calls(monkeypatch):
    """3 timed calls a config instead of 20: these tests read the lines, not
    the times."""
    monkeypatch.setattr(bench, "K", 3)


@pytest.mark.parametrize("argv,lines", [([], ["# bf16:", "# int8:"]),
                                        (["--bf16-headline"], ["# bf16:"]),
                                        (["--quant", "int4", "--int4-a8", "--geometry", "aloha",
                                          "--use-flash", "1", "--vit-fused"],
                                         ["# int4 W4A8 [aloha]:"])],
                         ids=["contract", "bf16-headline", "int4-a8-aloha"])
def test_bench_prints_one_json_line(capsys, few_calls, argv, lines):
    out = bench.main(["--device", "cpu"] + argv, cfg=port_config(TINY))
    captured = capsys.readouterr()
    stdout = captured.out.strip().splitlines()
    assert len(stdout) == 1
    line = json.loads(stdout[0])
    assert line == out and sorted(line) == ["metric", "unit", "value", "vs_baseline"]
    assert line["metric"] == "action_chunk_latency" and line["unit"] == "s"
    assert line["value"] > 0 and line["vs_baseline"] == round(0.109 / line["value"], 3)
    timed = [ln for ln in captured.err.splitlines() if ln.startswith("# ") and "ms " in ln]
    assert [ln.split(":")[0] + ":" for ln in timed] == lines
    assert all("device=cpu" in ln for ln in timed)
    assert "A100 denominator 0.109 s/chunk" in captured.err


def test_int8_failure_propagates(monkeypatch, capsys, few_calls):
    """No fallback to the bf16 headline: the int8 failure raises and no JSON
    line is printed."""
    entry = BE.entry

    def failing(**kw):
        if kw["quant"] == "int8":
            raise RuntimeError("int8 build failed")
        return entry(**kw)

    monkeypatch.setattr(BE, "entry", failing)
    with pytest.raises(RuntimeError, match="int8 build failed"):
        bench.main(["--device", "cpu"], cfg=port_config(TINY))
    assert capsys.readouterr().out == ""


def test_a_failing_extra_row_raises(monkeypatch, capsys):
    calls = []

    class Done:
        returncode, stdout, stderr = 1, "", "Traceback: out of memory"

    def run(cmd, **kw):
        calls.append(cmd)
        return Done()

    monkeypatch.setattr(bench.subprocess, "run", run)
    with pytest.raises(RuntimeError, match="aloha_bf16, aloha_int8, diffusion_int8"):
        bench.extra_rows("cpu")
    assert len(calls) == 4 and all(c[-2:] == ["--device", "cpu"] for c in calls)
    assert [c[2].rsplit(".", 1)[1] for c in calls] == ["bench", "bench", "bench_diffusion",
                                                      "bench_diffusion"]
    assert "exit=1" in capsys.readouterr().err


def test_measure_keeps_the_minimum_over_repeats(capsys):
    """Two untimed calls, then `repeats` loops of k calls: the fastest loop's
    ms per call; the first call's seconds come back beside it."""
    delays = iter([0.05, 0.0] + [0.03] * 2 + [0.01] * 2 + [0.02] * 2)

    def fn(x):
        time.sleep(next(delays))
        return x + 1

    ms, first_s = bench_timing.measure(fn, (torch.zeros(2),), k=2, repeats=3, label="row")
    assert 10.0 <= ms < 15.0 and first_s >= 0.05
    assert capsys.readouterr().out.startswith("row")
    assert bench_timing.sync_cost_s(torch.zeros(1)) >= 0.0
