"""A quantized base and K4 under tensor and fully sharded parallelism, on the CPU.

The port's int8 (W8A8) and int4 (W4A16, W4A8) linears and K4's gate run on
each tp rank's own block of the weight (`ops/layers.py::_linear_tp`,
`models/vit.py::_ln_linear`), and quantized leaves gather over fsdp before
the product. Three launches of two gloo processes (`torch_parallel_worker.py`)
hold them to the port on one process, and the policy-level and training
cases also to the JAX package on the same numpy weights (`quantize_tree` and
`predict_action_hidden`, or `loss_and_metrics`), computed here: the children
import no JAX. Tolerances:
- W8A8 products at tp = 2, column- and row-parallel, dynamic and static:
  bitwise the unsharded product (the row-parallel route takes the whole
  rows' per-token scale by an all-reduce MAX and sums exact int32
  accumulators); x's gradient within 1e-5 of the largest;
- W4A16 at tp = 2: rtol 1e-5 with atol 1e-5 * max|ref| (fp32 partial sums
  over the ranks); W4A8: rtol 1e-6 with atol 1e-6 * max|ref|, as
  `test_torch_int4.py`'s kernels against JAX;
- the policies at tp = 2: actions and hidden states within 5e-4 of one
  process (fp32 tiny models), the hidden states within 1e-4 * max|ref| of
  JAX's, as `test_torch_int4.py` / `test_torch_int8.py`; W4A8 within 5e-2 *
  max|ref| and a cosine of 0.999 (see W4A8_REL);
- the QLoRA step: `test_torch_parallel_train.py`'s bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.models.prismatic import predict_action_hidden as jax_predict
from openvla_oft_tpu.models.vit import fuse_vit_inference_weights as jax_fuse_vit
from openvla_oft_tpu.ops import int4_matmul as JM
from openvla_oft_tpu.ops import quant as JQ
from openvla_oft_tpu.ops import quant_calibrate as JC
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.training import train_step as JT
from openvla_oft_tpu_torch.bridge import params_from_numpy, tree_leaves
from openvla_oft_tpu_torch.ops import quant as Q
from openvla_oft_tpu_torch.ops.quant import quantize_tree_lowmem
from openvla_oft_tpu_torch.parallel.sharding import kept_whole, param_placements
from openvla_oft_tpu_torch.training import train_step as TT
from test_torch_import import port_platform
from test_torch_int4 import _int4_model, _model_inputs
from test_torch_int8 import _int8_model, _jax_observations, _rel, _tiny_cfg, _unfused_int8
from test_torch_parallel_train import CFG, LR, P_CFG, TRAIN_CFG, _np, _train_setup
from torch_parallel_worker import launch

FP32 = dict(rtol=1e-5)
A8 = dict(rtol=1e-6)


def _close(got, ref, rtol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


# --- placements: the tp blocks the quantized kernels take -------------------

def _meta_int8(k, n):
    return {"kernel": torch.empty((2, k, n), dtype=torch.int8, device="meta"),
            "scale_w": torch.empty((2, n), device="meta")}


def _meta_int4(k, n, group):
    return {"kernel_q4": torch.empty((2, k // 2, n), dtype=torch.int8, device="meta"),
            "scale_w4": torch.empty((2, k // group, n), device="meta")}


# The flagship's leaves whose tp blocks the kernels cannot take (trouble
# spots): SigLIP so400m's proj (9 scale groups of 128) and fc2 (269 of 16)
# at tp = 2 under int4 QLoRA, Llama-2's down (86 groups) at tp = 4, and
# SigLIP's 4,304-wide fc1 / fc2 at tp = 4 in int8 (1,076 columns or rows:
# not a multiple of 8). The rest of each pair fits.
FIT_CASES = [
    ("siglip proj int4", "attn/proj", _meta_int4(1152, 1152, 128), 2, False),
    ("siglip fc2 int4", "mlp/fc2", _meta_int4(4304, 1152, 16), 2, False),
    ("siglip fc1 int4", "mlp/fc1", _meta_int4(1152, 4304, 128), 2, True),
    ("llama down int4 tp2", "mlp/down", _meta_int4(11008, 4096, 128), 2, True),
    ("llama down int4 tp4", "mlp/down", _meta_int4(11008, 4096, 128), 4, False),
    ("llama wo int4 tp4", "attn/wo", _meta_int4(4096, 4096, 128), 4, True),
    ("siglip fc1 int8 tp4", "mlp/fc1", _meta_int8(1152, 4304), 4, False),
    ("siglip fc2 int8 tp4", "mlp/fc2", _meta_int8(4304, 1152), 4, False),
    ("siglip fc1 int8 tp2", "mlp/fc1", _meta_int8(1152, 4304), 2, True),
    ("llama gate_up int8 tp4", "mlp/gate_up", _meta_int8(4096, 22016), 4, True),
]


@pytest.mark.parametrize("name,path,node,tp,fits", FIT_CASES, ids=[c[0] for c in FIT_CASES])
def test_quantized_tp_blocks_fit_their_kernels(name, path, node, tp, fits):
    """A leaf whose tp block fits keeps the JAX rule's split; one that does
    not is kept whole over tp (a departure from JAX, listed by
    `kept_whole`), its fsdp split and its scales as the rules give them."""
    group, leaf = path.split("/")
    tree = {"layers": {group: {leaf: node}}}
    shape = {"dp": 1, "fsdp": 2, "tp": tp}
    got = param_placements(tree, shape)["layers"][group][leaf]
    name_k = "kernel_q4" if "kernel_q4" in node else "kernel"
    rows = leaf in ("proj", "fc2", "down", "wo")
    split = Shard(1) if rows else Shard(2)
    assert (got[name_k][2] == split) == fits and (got[name_k][2] == Replicate()) != fits
    fsdp_dim = Shard(2) if rows else Shard(1)
    assert got[name_k][1] == fsdp_dim
    for k in ("scale_w", "scale_w4"):
        if k in node:
            assert got[k] == [Replicate()] * 3
    whole = kept_whole(tree, shape)
    assert whole == ([] if fits else [f"layers/{path}/{name_k}"])


# --- (i) the products on each rank's block ----------------------------------

@pytest.fixture(scope="module")
def products(tmp_path_factory):
    rng = np.random.default_rng(0)
    inp = {"mesh": (1, 1, 2), "x": rng.standard_normal((2, 5, 64)).astype(np.float32),
           "x_mid": rng.standard_normal((2, 5, 96)).astype(np.float32),
           "w_up": (rng.standard_normal((64, 96)) * 0.05).astype(np.float32),
           "w_down": (rng.standard_normal((96, 64)) * 0.05).astype(np.float32),
           "w_odd": (rng.standard_normal((48, 64)) * 0.05).astype(np.float32),
           "w_qkv": (rng.standard_normal((64, 96)) * 0.05).astype(np.float32),
           "b_qkv": (rng.standard_normal(96) * 0.05).astype(np.float32)}
    return launch("quant_products", 2, inp, tmp_path_factory.mktemp("products"))


W8A8 = ["int8-up", "int8-down", "int8-chain", "static-up", "static-down", "static-chain"]


@pytest.mark.parametrize("case", W8A8)
def test_w8a8_at_tp2_is_bitwise_the_unsharded_product(products, case):
    """Column-parallel (up), row-parallel (down) and the pair, dynamic and
    static scales: each rank's product, gathered or summed, bitwise equal to
    the one-process product; x's gradient (straight through) within 1e-5."""
    for rank in products:
        r = rank[case]
        np.testing.assert_array_equal(r["tp"], r["single"])
        if r["dx_tp"] is not None:
            _close(r["dx_tp"], r["dx_single"], 1e-5)


def test_w8a8_row_parallel_takes_the_whole_rows_scale(products):
    """Each rank quantizing its own columns with its own absmax gives
    another product: the all-reduce MAX of the absmaxes is what makes the
    row-parallel route bitwise. The dynamic route takes two all-reduces
    (MAX, then the int32 SUM), the static one only the SUM."""
    for rank in products:
        d = np.abs(rank["int8-down-local-scale"] - rank["int8-down"]["single"]).max()
        assert d > 1e-4
        assert rank["int8-down"]["collectives"] == {"all_gather": 0, "all_reduce": 2}
        assert rank["static-down"]["collectives"] == {"all_gather": 0, "all_reduce": 1}


INT4 = ["int4-up", "int4-down", "int4-chain", "a8-up", "a8-down", "a8-chain"]


@pytest.mark.parametrize("case", INT4)
def test_int4_at_tp2_matches_the_unsharded_product(products, case):
    """W4A16 (K5's plain version here) and W4A8 (K6's, with the whole rows'
    per-token scale) on each rank's column or row block: within fp32's
    reordering of the partial sums; x's gradient likewise."""
    tol = A8["rtol"] if case.startswith("a8") else FP32["rtol"]
    for rank in products:
        r = rank[case]
        _close(r["tp"], r["single"], tol)
        if r["dx_tp"] is not None:
            _close(r["dx_tp"], r["dx_single"], 1e-5)
    if case == "a8-down":
        assert products[0][case]["collectives"] == {"all_gather": 0, "all_reduce": 2}


def test_a_row_block_that_cuts_a_scale_group_is_kept_whole(products):
    """A packed down of 3 scale groups at tp = 2: kept whole over tp, its
    input (the column-parallel up's output) gathered once and counted, the
    whole product run on each rank."""
    for rank in products:
        r = rank["split-group"]
        assert r["kept_whole"] == ["layers/mlp/down/kernel_q4"]
        assert r["collectives"] == {"all_gather": 1, "all_reduce": 0}
        _close(r["tp"], r["single"], FP32["rtol"])


def test_k4_gate_on_a_tp_sharded_kernel(products):
    """Under `vit_fused`, a folded qkv sharded by columns takes `ln_matmul`
    (its plain version `ln_matmul_ref` here) on the whole x and the rank's
    48 of 96 columns, and returns a DTensor Shard(-1) whose gather equals
    the unsharded call within 1e-6."""
    for rank in products:
        r = rank["k4"]
        assert r["gate"] and r["dtensor"] and r["local_cols"] == 48
        _close(r["tp"], r["single"], 1e-6)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_leaves_gather_over_fsdp(products, kind):
    """An int8 and a packed int4 kernel sharded over fsdp = 2 hold half of
    their rows a rank, gather whole before the product (DTensor's
    redistribute of an int8 DTensor under gloo) and give the unsharded
    product bitwise."""
    for rank in products:
        r = rank[f"fsdp-{kind}"]
        assert r["local_rows"] == {"int8": 32, "int4": 16}[kind] and r["gathered_equal"]
        np.testing.assert_array_equal(r["tp"], r["single"])


# --- (ii) quantized policies at tp = 2 --------------------------------------

def _vit_fused_model():
    """The tiny model with its ViTs' LayerNorm affines folded (K4's gate
    open), fp32."""
    cfg = _tiny_cfg()
    params = dict(init_openvla_params(jax.random.PRNGKey(5), cfg, LIBERO, dtype=jnp.float32,
                                      head="l1"))
    params["vision_backbone"] = {name: jax_fuse_vit(v, fold_norms=True)
                                 for name, v in params["vision_backbone"].items()}
    return cfg, params


@functools.lru_cache(maxsize=1)
def _policy_variants():
    """Each variant's config, JAX tree and switches: int4 W4A16 and W4A8
    (`test_torch_int4.py`'s model, 2 heads of 128), int8 with dynamic and
    static scales (`test_torch_int8.py`'s, every linear in int8; the static
    scales on its unfused int8 LLM, calibrated by JAX on two observations),
    and the folded tree under `vit_fused`."""
    cfg4, p4 = _int4_model()
    cfg8, p8 = _int8_model()
    # Static scales on the unfused int8 LLM: the JAX version slices a fused
    # wqkv's scalar scale_x in its out_window layer and raises there.
    static = JC.attach_static_act_scales(_unfused_int8(), cfg8, LIBERO, _jax_observations(cfg8))
    cfgk, pk = _vit_fused_model()
    return {
        "w4a16": (cfg4, p4, False, False),
        "w4a8": (cfg4, p4, True, False),
        "int8": (cfg8, p8, False, False),
        "static": (cfg8, static, False, False),
        "vit_fused": (cfgk, pk, False, True),
    }


@pytest.fixture(scope="module")
def policies(tmp_path_factory):
    rng = np.random.default_rng(4)
    variants = _policy_variants()
    cfg = variants["int8"][0]
    batch = _model_inputs(rng, cfg)
    h = cfg.vision_configs[0].image_size
    request = {"pixels": rng.standard_normal((2, 2, h, h, 3)).astype(np.float32),
               "proprio": rng.standard_normal(LIBERO.proprio_dim).astype(np.float32),
               "instruction": "put the bowl on the plate"}
    inp = {"mesh": (1, 1, 2), "request": request,
           "batch": {k: np.asarray(v, np.int64) if v.dtype == np.int32 else v
                     for k, v in batch.items()},
           "variants": {name: {"llm": c.llm_backbone_id, "params": _np(p), "int4_a8": a8,
                               "vit_fused": vf}
                        for name, (c, p, a8, vf) in variants.items()}}
    out = launch("quant_policy", 2, inp, tmp_path_factory.mktemp("policies"))
    return out, batch


# W4A8 quantizes every LLM linear's input per token. The ViTs' and the
# projector's row-parallel fp32 sums reach the LLM an ulp or so off the
# one-process values (1.8e-6 of 3.9 measured), which moves an int8 code
# across a rounding boundary now and then; one code is 1/127 of the row's
# absmax, and the 2 layers carry it on. So W4A8 is held by max|d| <= 5e-2 *
# max|ref| and a cosine >= 0.999 (the products themselves are held to 1e-6
# above); the other variants' inputs take no int8 rounding of an activation
# that differs.
W4A8_REL, W4A8_COS = 5e-2, 0.999


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("variant", ["w4a16", "w4a8", "int8", "static", "vit_fused"])
def test_tp_quantized_policy_matches_one_process_and_jax(policies, variant, monkeypatch):
    """`OpenVLAPolicy(tp_mesh)` at tp = 2 on each variant's tree: its staged
    actions and the action rows' hidden states within 5e-4 of the same
    policy on one process, the hidden states within 1e-4 * max|ref| of
    JAX's `predict_action_hidden` on the JAX-quantized tree (W4A8 through
    its OPENVLA_INT4_A8 switch), both ranks alike, and collectives taken."""
    out, batch = policies
    cfg, params, a8, _ = _policy_variants()[variant]
    monkeypatch.setenv("OPENVLA_INT4_A8", "1" if a8 else "0")
    ref = jax_predict(params, cfg, LIBERO, **{k: jnp.asarray(v) for k, v in batch.items()},
                      use_flash=True).actions_hidden
    for rank in out:
        r = rank[variant]
        if variant == "w4a8":
            for got, want in ((r["hidden-tp"], r["hidden-single"]), (r["hidden-tp"], ref),
                              (r["actions-tp"], r["actions-single"])):
                assert _rel(got, want) <= W4A8_REL and _cos(got, want) >= W4A8_COS
        else:
            np.testing.assert_allclose(r["actions-tp"], r["actions-single"], rtol=5e-4,
                                       atol=5e-4)
            np.testing.assert_allclose(r["hidden-tp"], r["hidden-single"], rtol=5e-4, atol=5e-4)
            assert _rel(r["hidden-tp"], ref) <= 1e-4
        assert r["kept_whole"] == [] and r["collectives-tp"]["all_reduce"] > 0
    np.testing.assert_array_equal(out[0][variant]["actions-tp"], out[1][variant]["actions-tp"])


# --- (iii) a QLoRA step at fsdp = 2 and tp = 2 ------------------------------

@functools.lru_cache(maxsize=2)
def _qlora_refs(bits: int):
    """The port's QLoRA step on one process and JAX's loss, gradients and
    update on the same weights, base quantized with min_dim 1. For int4 both
    sides take the dequant product, as `test_torch_qlora.py` runs them (at
    these widths JAX's stacked kernel cannot tile the layers; the port's
    FUSED_MAX_ROWS 0 here and in the children): its fp32 backward, where
    the fused route's rounds to bf16 (held against JAX's kernel in
    `test_torch_int4.py`, and on the tp blocks above)."""
    base, trainables, batch = _train_setup()
    tb = {k: quantize_tree_lowmem(v, min_dim=1, bits=bits)
          for k, v in params_from_numpy(base).items()}
    tt = params_from_numpy(trainables)
    for t in tree_leaves(tt):
        t.requires_grad_(True)
    state = TT.create_train_state(tb, tt, TT.TrainConfig(**TRAIN_CFG))
    with pytest.MonkeyPatch.context() as mp:
        if bits == 4:
            mp.setattr(Q, "FUSED_MAX_ROWS", 0)
        state, metrics = TT.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                       P_CFG, port_platform(LIBERO),
                                       TT.TrainConfig(**TRAIN_CFG), use_flash=True)
    jcfg = JT.TrainConfig(objective="l1", learning_rate=LR, lora_rank=4, lora_alpha=4.0,
                          remat_policy="none")
    with pytest.MonkeyPatch.context() as mp:
        if bits == 4:
            mp.setattr(JM, "int4_matmul_fused", JQ._int4_matmul_xla)
        jbase = {k: JQ.quantize_tree_lowmem(jax.tree_util.tree_map(jnp.asarray, v), min_dim=1,
                                            bits=bits) for k, v in base.items()}
        tr_j = jax.tree_util.tree_map(jnp.asarray, trainables)
        (loss_j, _), grads_j = jax.value_and_grad(JT.loss_and_metrics, has_aux=True)(
            tr_j, jbase, {k: jnp.asarray(v) for k, v in batch.items()}, CFG, LIBERO,
            jcfg, jax.random.PRNGKey(0), True)
    tx = JT.make_optimizer(jcfg)
    updates, _ = tx.update(grads_j, tx.init(tr_j), tr_j)
    new_j = [np.asarray(x) for x in jax.tree_util.tree_leaves(optax.apply_updates(tr_j, updates))]
    return {"base": base, "trainables": trainables, "batch": batch,
            "single": [t.detach().numpy() for t in tree_leaves(state.trainables)],
            "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "loss_j": float(loss_j), "new_j": new_j,
            "grads_j": [np.asarray(x) for x in jax.tree_util.tree_leaves(grads_j)]}


@pytest.fixture(scope="module")
def qlora(tmp_path_factory):
    ref = _qlora_refs(8)
    return launch("qlora_step", 2, {"mesh": (1, 1, 2), "base": ref["base"],
                                    "trainables": ref["trainables"], "batch": ref["batch"],
                                    "train_config": TRAIN_CFG, "num_images": 1,
                                    "int4_fused_max_rows": 0},
                  tmp_path_factory.mktemp("qlora"))


@pytest.mark.parametrize("mesh", ["1x2x1", "1x1x2"], ids=["fsdp2", "tp2"])
@pytest.mark.parametrize("bits", [8, 4])
def test_qlora_step_on_a_mesh_matches_one_process_and_jax(qlora, bits, mesh):
    """One step of LoRA on a quantized base (every kernel int8 or int4) at
    fsdp = 2 and at tp = 2: the loss and the gradient norm within 1e-3 of
    the port's step on one process (fp32 partial sums over the ranks, which
    the tiny model's norms amplify: 5.5e-5 and 5.6e-4 measured for int4 at
    tp = 2; int8 is bitwise in both) and the loss within 2e-4 of JAX's; the
    trainables after AdamW within 1% of lr of both where the gradient's
    sign is well determined, and within 2 lr anywhere. Well determined:
    |g| above 5% of the leaf's largest (QLoRA's gradient agrees with JAX's
    to 1% of its largest, `test_torch_qlora.py`) and above 1e-6, 100 times
    AdamW's eps (below that the first update g / (|g| + eps) moves with the
    last digits of g)."""
    ref = _qlora_refs(bits)
    for rank in qlora:
        o = rank[f"bits{bits}-{mesh}"]
        m = o["metrics"]
        np.testing.assert_allclose(m["loss"], ref["loss"], rtol=1e-3)
        np.testing.assert_allclose(m["grad_norm"], ref["grad_norm"], rtol=1e-3)
        np.testing.assert_allclose(m["loss"], ref["loss_j"], rtol=2e-4)
        got = tree_leaves(o["trainables"])
        assert len(got) == len(ref["single"]) == len(ref["new_j"])
        for g, s, pj, gj in zip(got, ref["single"], ref["new_j"], ref["grads_j"]):
            assert g.shape == s.shape == pj.shape
            sure = np.abs(gj) > max(5e-2 * np.abs(gj).max(), 1e-6)
            assert np.abs(g - s)[sure].max(initial=0) <= 1e-2 * LR
            assert np.abs(g - pj)[sure].max(initial=0) <= 1e-2 * LR
            assert np.abs(g - pj).max() <= 2 * LR + 1e-6


def test_qlora_cli_on_a_tp_mesh_saves_exports_and_resumes(tmp_path):
    """The fine-tuning CLI with `--quantize_base True --quantize_base_bits 4`
    and `--mesh_tp 2` on two processes, from a tiny checkpoint dir (TINY's
    one-group wo and down stay whole over tp): the first step's loss within
    1e-5 of the one-process run's and the second's within 1e-3
    (`test_torch_parallel_cli.py`'s bounds); the merged export, which
    reloads the dir's float base, bitwise the offline merge script's output
    from the same resume file; that file resumed on one process."""
    from openvla_oft_tpu_torch.scripts.merge_lora_weights_and_save import MergeConfig, merge
    from openvla_oft_tpu_torch.utils.hf_import import load_openvla_checkpoint
    from test_torch_finetune_cli import _assert_bitwise, _tiny_checkpoint
    from test_torch_parallel_cli import RUN, _losses

    ckpt, _ = _tiny_checkpoint(tmp_path, "l1")
    argv = RUN + ["--vla_path", ckpt, "--quantize_base", "True", "--quantize_base_bits", "4",
                  "--quantize_base_min_dim", "1", "--merge_lora_during_training", "True"]
    ref = _losses(argv + ["--run_root_dir", str(tmp_path / "ref")])
    out = launch("finetune", 2, {"mesh": (1, 1, 2), "argv": argv + [
        "--mesh_tp", "2", "--multihost", "True", "--run_root_dir", str(tmp_path / "run")]},
        tmp_path / "ranks")
    for o in out:
        losses = [loss for _, loss in o["steps"]]
        np.testing.assert_allclose(losses[0], ref[0], rtol=1e-5)
        np.testing.assert_allclose(losses[1], ref[1], rtol=1e-3)
    run_dir = out[0]["run_dir"]
    offline = merge(MergeConfig(base_checkpoint=ckpt, finetune_run_dir=run_dir, lora_rank=4,
                                device="cpu"))
    _assert_bitwise(load_openvla_checkpoint(f"{run_dir}--2_chkpt", dtype=None)[1],
                    load_openvla_checkpoint(offline, dtype=None)[1])
    resumed = _losses(argv + ["--run_root_dir", str(tmp_path / "run"), "--resume", "True",
                              "--max_steps", "3"])
    assert len(resumed) == 1 and np.isfinite(resumed).all()
