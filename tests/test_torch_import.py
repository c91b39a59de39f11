"""The port imports neither JAX nor the JAX package, and its copies of the
JAX package's configs and platforms do not drift from the originals. No
port module imports `experiments`, `tensorflow` or `PIL` anywhere, or at its
top `safetensors` or `transformers`, which the card's machine lacks (the
functions that may use those two import them inside, and raise a clear
error where they are missing).

`port_config` and `port_platform` are how the other parity tests hand the
same model and platform to both sides: each side's objects go only to its
own functions.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import openvla_oft_tpu.config as JC
import openvla_oft_tpu.constants as JK
import openvla_oft_tpu_torch.config as PC
import openvla_oft_tpu_torch.constants as PK

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "openvla_oft_tpu_torch"

_TINY = {"vision": {"tiny-dual": ("TINY_DINOV2", "TINY_SIGLIP")},
         "llm": {"tiny-llama": "TINY_LLAMA"}}


def register_tiny(mod) -> None:
    """The tiny registry entries the tests use, in one side's config module."""
    for key, names in _TINY["vision"].items():
        mod._VISION_REGISTRY.setdefault(key, tuple(getattr(mod, n) for n in names))
    for key, name in _TINY["llm"].items():
        mod._LLM_REGISTRY.setdefault(key, getattr(mod, name))


for _mod in (JC, PC):
    register_tiny(_mod)


def port_config(cfg: JC.OpenVLAConfig) -> PC.OpenVLAConfig:
    """The port's OpenVLAConfig with the same fields as a JAX one. A registry
    id that only the JAX side knows (a test's own geometry) is copied into
    the port's registry first."""
    if cfg.vision_backbone_id not in PC._VISION_REGISTRY:
        PC._VISION_REGISTRY[cfg.vision_backbone_id] = tuple(
            port_arch(v) for v in cfg.vision_configs)
    if cfg.llm_backbone_id not in PC._LLM_REGISTRY:
        PC._LLM_REGISTRY[cfg.llm_backbone_id] = port_arch(cfg.llm)
    return PC.OpenVLAConfig(**dataclasses.asdict(cfg))


def port_arch(cfg):
    """The port's ViTConfig, LlamaConfig or PhiConfig equal to a JAX one."""
    return getattr(PC, type(cfg).__name__)(**dataclasses.asdict(cfg))


def port_platform(platform: JK.PlatformSpec) -> PK.PlatformSpec:
    return PK.get_platform(platform.name)


_BANNED = ("jax", "openvla_oft_tpu", "vla_scripts", "experiments", "safetensors",
           "transformers", "tensorflow", "PIL")
_IMPORT_ALL_WITHOUT_JAX = """
import importlib, pkgutil, sys
banned = %r
# any `import jax`, `import openvla_oft_tpu...`, `import safetensors`, ... now raises
for name in banned:
    sys.modules[name] = None
import openvla_oft_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m.split(".")[0] in banned for m in loaded)
print(" ".join(names))
""" % (_BANNED,)

# Modules that must be among those imported under the ban.
_MUST_IMPORT = ("ops.vit_fused", "ops.int4_probe", "scripts.exp_int4_probe", "utils.timing",
                "ops.int4_matmul", "ops.flash_attention", "serving.deploy", "training.finetune",
                "scripts.exp_k5_overlap", "scripts.exp_probe_parts", "ops.quant_calibrate",
                "scripts.calibrate_quant", "ops.ddim", "scripts.bench_diffusion",
                "scripts.bench_ar", "utils.safetensors_io", "utils.weights", "utils.hf_import",
                "processing.sentencepiece", "processing.prompting", "serving.openvla_utils",
                "scripts.convert_weights", "processing.jpeg", "serving.robot_utils",
                "processing.jpeg_decode", "data.rlds.pipeline", "data.rlds.tfrecord",
                "data.rlds.augment", "data.rlds.goal_task_aug", "data.rlds.oxe.configs",
                "data.rlds.oxe.transforms", "data.rlds.oxe.droid_utils",
                "data.rlds.oxe.materialize", "data.rlds.oxe.mixtures", "data.npz_dataset",
                "data.prefetch", "_host_build", "utils.overwatch", "utils.native",
                "data.batching", "data.vlm_datasets", "models.registry", "scripts.train",
                "scripts.pretrain", "scripts.generate", "scripts.build_instruct_mixtures",
                "scripts.quickstart", "experiments.robot.libero.libero_utils",
                "experiments.robot.libero.run_libero_eval", "experiments.robot.aloha.constants",
                "experiments.robot.aloha.robot_utils", "experiments.robot.aloha.real_env",
                "experiments.robot.aloha.aloha_utils", "experiments.robot.aloha.run_aloha_eval",
                "experiments.robot.aloha.preprocess_split_aloha_data",
                "experiments.robot.bridge.widowx_env", "experiments.robot.bridge.bridgev2_utils",
                "experiments.robot.bridge.run_bridgev2_eval",
                "experiments.robot.robosuite.robosuite_utils",
                "experiments.robot.robosuite.run_robosuite_eval",
                "experiments.robot.robosuite.create_video",
                "experiments.robot.robosuite.collect_data.collect_task",
                "experiments.robot.robosuite.collect_data.rollout_trajectory",
                "parallel.mesh", "parallel.sharding", "scripts.dryrun_multiprocess",
                "processing.png_decode", "processing.image_io", "processing.jpeg_encode",
                "scripts.make_synthetic_rlds", "scripts.make_quickstart_fixture",
                "scripts.exp_roundtrip_7b", "scripts.time_jpeg_host", "scripts.bench_timing",
                "scripts.bench_entry", "scripts.bench", "scripts.bench_components",
                "scripts.bench_deploy", "scripts.bench_data", "models.vit_joint",
                "scripts.dryrun_multichip", "scripts._ranks")


def test_every_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL_WITHOUT_JAX], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 65
    assert {f"openvla_oft_tpu_torch.{m}" for m in _MUST_IMPORT} <= set(names)


def test_no_jax_import_in_the_source():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|openvla_oft_tpu(?!_torch)|vla_scripts)\b",
                         re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())
    # anywhere: the eval scripts, and TF and PIL (the JPEG round trip is the
    # port's own); at the top of a module: the other packages the card's
    # machine lacks
    anywhere = re.compile(r"^\s*(import|from)\s+(experiments|tensorflow|PIL)\b", re.M)
    top = re.compile(r"^(import|from)\s+(safetensors|transformers)\b", re.M)
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        text = path.read_text()
        assert not anywhere.search(text) and not top.search(text), path


def test_host_library_sources_are_the_ports_own():
    """The host library (the JPEG decoder and encoder, augmentation and CRC-32C of the data path,
    and the collator's and tokenizer's loops) is built from sources under
    the port's own directory, nothing else: not the JAX package's `native/`
    sources."""
    from openvla_oft_tpu_torch import _host_build as H

    sources = H.sources()
    assert {p.name for p in sources} == {"augment.cc", "crc32c.cc", "data_ops.cc",
                                         "jpeg_decode.cc", "jpeg_encode.cc"}
    for path in sources:
        assert not path.is_symlink() and path.resolve().is_relative_to(PKG / "hostsrc")
        assert "#include \"" not in path.read_text()      # no header from elsewhere
    lib = H.build()
    assert lib.resolve().is_relative_to(PKG / "_build")
    log = (lib.parent / "build.log").read_text()
    assert all(str(p) in log for p in sources) and "native" not in log.split("\n")[0]


# Run in a fresh interpreter: other test files of the same worker register
# geometries of their own in the JAX registries.
_DRIFT = """
import dataclasses
import openvla_oft_tpu.config as JC, openvla_oft_tpu.constants as JK
import openvla_oft_tpu_torch.config as PC, openvla_oft_tpu_torch.constants as PK
from test_torch_import import register_tiny


def d(value):
    if isinstance(value, tuple):
        return [d(v) for v in value]
    return (type(value).__name__, dataclasses.asdict(value)) \\
        if dataclasses.is_dataclass(value) else value


for mod in (JC, PC):
    register_tiny(mod)
for reg in ("_VISION_REGISTRY", "_LLM_REGISTRY"):
    j, p = getattr(JC, reg), getattr(PC, reg)
    assert sorted(j) == sorted(p), reg
    for key in j:
        assert d(j[key]) == d(p[key]), (reg, key)
names = [n for n in dir(JC) if n.isupper() and not n.startswith("_")]
assert names == [n for n in dir(PC) if n.isupper() and not n.startswith("_")]
for name in names:
    assert d(getattr(JC, name)) == d(getattr(PC, name)), name
assert d(JC.OpenVLAConfig()) == d(PC.OpenVLAConfig())
assert sorted(JK.PLATFORMS) == sorted(PK.PLATFORMS)
for key, spec in JK.PLATFORMS.items():
    assert d(spec) == d(PK.PLATFORMS[key]), key
for name in dir(JK):
    if name.isupper() and not name.startswith("_") and name != "PLATFORMS":
        assert d(getattr(JK, name)) == d(getattr(PK, name)), name
assert [e.value for e in JK.NormalizationType] == [e.value for e in PK.NormalizationType]
print(len(names), sum(len(getattr(JC, r)) for r in ("_VISION_REGISTRY", "_LLM_REGISTRY")))
"""


def test_configs_and_platforms_do_not_drift():
    """Every registry entry (the tiny ones included), every module-level
    config (TINY_* and the named ones), the OpenVLAConfig defaults, every
    PlatformSpec and the token constants are equal field for field."""
    proc = subprocess.run([sys.executable, "-c", _DRIFT], cwd=ROOT / "tests",
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}"
                               + os.environ.get("PYTHONPATH", "")})
    assert proc.returncode == 0, proc.stderr
    n_configs, n_entries = map(int, proc.stdout.split())
    assert n_configs >= 18 and n_entries >= 20


def test_port_platform_is_the_ports_own():
    for key, spec in JK.PLATFORMS.items():
        assert port_platform(spec) is PK.PLATFORMS[key]


def test_port_config_carries_across():
    cfg = JC.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                           num_images_in_input=2)
    ported = port_config(cfg)
    assert isinstance(ported, PC.OpenVLAConfig) and isinstance(ported.llm, PC.LlamaConfig)
    assert dataclasses.asdict(ported.llm) == dataclasses.asdict(cfg.llm)
    assert [dataclasses.asdict(v) for v in ported.vision_configs] == \
        [dataclasses.asdict(v) for v in cfg.vision_configs]
