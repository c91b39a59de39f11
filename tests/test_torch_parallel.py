"""The port's multi-GPU execution (`openvla_oft_tpu_torch/parallel/`) on the CPU.

(i) `param_placements` against JAX's `param_pspecs`, leaf for leaf, on the
8-device virtual mesh (no process group). (ii), (iii) and the tp-sharded
policy run the port on 2 or 4 gloo processes (`torch_parallel_worker.py`;
a `file://` store, every child joined within a time limit and killed after
it) and hold it to the port on one process and to JAX, whose references
are computed here: children import no JAX. Tolerances are fp32's: 5e-4 for the sharded outputs (the partial sums
of the row-parallel products add in another order). The sharded train step
(iv) is in `test_torch_parallel_train.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from openvla_oft_tpu.config import OpenVLAConfig, TINY_DINOV2
from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.models.llama import fuse_inference_weights as jax_fuse
from openvla_oft_tpu.models.prismatic import predict_action_hidden as jax_predict
from openvla_oft_tpu.ops.flash_attention import flash_attention_tp as jax_flash_tp
from openvla_oft_tpu.ops.quant import quantize_tree
from openvla_oft_tpu.parallel.mesh import make_mesh as jax_mesh
from openvla_oft_tpu.parallel.sharding import param_pspecs, shard_params as jax_shard
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.training.lora import init_lora as jax_init_lora
from openvla_oft_tpu_torch.bridge import params_from_numpy
from openvla_oft_tpu_torch.ops.flash_attention import flash_attention
from openvla_oft_tpu_torch.parallel import mesh as PM
from openvla_oft_tpu_torch.parallel.sharding import kept_whole, param_placements
from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden as port_predict
from test_torch_import import port_config, port_platform
from torch_parallel_worker import launch

CFG = OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama")
P_CFG = port_config(CFG)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=1)
def _trees():
    """The trees the rules see: the VLA (unfused), the serving-fused LLM,
    LoRA factors, a packed-int4 LLM and the action head (numpy)."""
    full = init_openvla_params(jax.random.PRNGKey(0), CFG, LIBERO, dtype=jnp.float32,
                               head="l1")
    base = {k: full[k] for k in ("llm", "vision_backbone", "projector")}
    return {name: _np(tree) for name, tree in {
        "vla": full,
        "fused": {"llm": jax_fuse(full["llm"])},
        "lora": {"lora": jax_init_lora(jax.random.PRNGKey(1), base, rank=4)},
        "int4": {"llm": quantize_tree(full["llm"], min_dim=1, bits=4)},
    }.items()}


TREES = ("fused", "int4", "lora", "vla")
MESHES = [(1, 2, 4), (2, 2, 2), (1, 2, 2)]


def _placements_of(spec: P, ndim: int) -> list:
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return [Shard(spec.index(ax)) if ax in spec else Replicate()
            for ax in ("dp", "fsdp", "tp")]


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
@pytest.mark.parametrize("tree", TREES)
def test_param_placements_match_jax_pspecs(tree, mesh):
    """Every leaf's placements are JAX's PartitionSpec, axis for axis: the
    fused wqkv/gate_up, kernel_q4 like its kernel, the LoRA factors after
    their base layer, the action head on fsdp only, and a dim the axis does
    not divide (TINY's widths against tp = 4) replicated."""
    params = _trees()[tree]
    jspecs = param_pspecs(params, jax_mesh(*mesh))
    shape = dict(zip(PM.AXES, mesh))
    got = param_placements(params, shape)
    # The port's one departure: a packed leaf whose row split over tp would
    # cut its scale groups stays whole over tp (`quant_block_fits`): TINY's
    # wo and down are 64 and 128 deep, one scale group each.
    whole = set(kept_whole(params, shape))
    assert whole == ({f"llm/layers/{n}/kernel_q4" for n in ("attn/wo", "mlp/down")}
                     if tree == "int4" else set())
    paths = []

    def walk(path, leaf, spec, placements):
        if isinstance(leaf, dict):
            for k in leaf:
                walk(path + (k,), leaf[k], spec[k], placements[k])
        elif isinstance(leaf, (list, tuple)):
            for i, v in enumerate(leaf):
                walk(path + (str(i),), v, spec[i], placements[i])
        else:
            want = _placements_of(spec, leaf.ndim)
            if "/".join(path) in whole:
                want[2] = Replicate()
            assert placements == want, ("/".join(path), spec)
            paths.append("/".join(path))

    walk((), params, jspecs, got)
    assert paths
    sharded = [p for p in paths if any(pl.is_shard() for pl in _leaf(got, p))]
    assert sharded, "the rules split nothing"


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def test_placement_specifics():
    """The cases the rules exist for, spelled out on (1, 2, 2)."""
    shape = {"dp": 1, "fsdp": 2, "tp": 2}
    fused = param_placements(_trees()["fused"], shape)["llm"]["layers"]
    assert fused["attn"]["wqkv"]["kernel"] == [Replicate(), Shard(1), Shard(2)]
    assert fused["mlp"]["gate_up"]["kernel"] == [Replicate(), Shard(1), Shard(2)]
    assert fused["attn"]["wo"]["kernel"] == [Replicate(), Shard(2), Shard(1)]
    int4 = param_placements(_trees()["int4"], shape)["llm"]["layers"]
    assert int4["attn"]["wq"]["kernel_q4"] == [Replicate(), Shard(1), Shard(2)]
    assert int4["attn"]["wq"]["scale_w4"] == [Replicate()] * 3
    lora = param_placements(_trees()["lora"], shape)["lora"]["llm"]["layers"]
    assert lora["attn"]["wq"]["a"] == [Replicate(), Shard(2), Replicate()]
    assert lora["attn"]["wq"]["b"] == [Replicate(), Replicate(), Shard(2)]
    assert lora["attn"]["wo"]["a"] == [Replicate(), Replicate(), Shard(2)]
    head = param_placements(_trees()["vla"], shape)["action_head"]["model"]
    assert head["fc_in"]["kernel"] == [Replicate(), Shard(0), Replicate()]
    assert head["blocks"][1]["fc"]["kernel"] == [Replicate(), Shard(0), Replicate()]
    # TINY_LLAMA's 64 output columns of wq over tp = 3: not divided, replicated.
    odd = param_placements(_trees()["vla"], {"dp": 1, "fsdp": 1, "tp": 3})
    assert odd["llm"]["layers"]["attn"]["wq"]["kernel"] == [Replicate()] * 3


def test_mesh_needs_a_process_group_and_the_world_size(tmp_path):
    """A mesh with no process group raises and names torchrun; one whose
    product is not the world size raises (one gloo rank here)."""
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        PM.make_mesh(1, 2, 1, device_type="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        PM.make_mesh(1, 1, 1, device_type="cpu")
    out = launch("mesh_checks", 1, {"mesh": (1, 1, 1)}, tmp_path)[0]
    assert out["wrong_product"] and "needs 2 ranks" in out["wrong_product"]
    assert out["mesh"] == [1, 1, 1]


# --- (ii) flash_attention_tp ----------------------------------------------

def _attn_inputs(b, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)))
    key_valid = np.ones((b, s), bool)
    key_valid[:, s - 10:] = False
    key_valid[0, :3] = False
    bidir = np.zeros((b, s), bool)
    bidir[:, 40:52] = True
    return dict(q=q, k=k, v=v, do=do, key_valid=key_valid, bidir=bidir)


@pytest.mark.parametrize("tp,h,hkv", [(2, 4, 4), (4, 8, 4)], ids=["tp2", "tp4-gqa"])
def test_flash_attention_tp_matches_unsharded_and_jax(tmp_path, tp, h, hkv):
    """Each rank's K1 (its plain version here) over H/tp query and Hkv/tp kv
    heads, gathered, against the port's unsharded call and JAX's
    `flash_attention_tp` on the same mesh shape; the gradients of dO through
    the per-shard plain backward against the unsharded ones. fp32, 5e-4."""
    inp = _attn_inputs(2, 70, h, hkv, 64, seed=tp)
    out = launch("flash_tp", tp, {**inp, "mesh": (1, 1, tp)}, tmp_path)
    assert {o["local_heads"] for o in out} == {h // tp}

    t = {n: torch.from_numpy(inp[n]).requires_grad_(n in "qkv") for n in ("q", "k", "v")}
    ref = flash_attention(t["q"], t["k"], t["v"], is_causal=True,
                          key_valid=torch.from_numpy(inp["key_valid"]),
                          bidir_mask=torch.from_numpy(inp["bidir"]))
    grads = torch.autograd.grad(ref, (t["q"], t["k"], t["v"]), torch.from_numpy(inp["do"]))
    jout = jax_flash_tp(jnp.asarray(inp["q"]), jnp.asarray(inp["k"]), jnp.asarray(inp["v"]),
                        jax_mesh(1, 1, tp), is_causal=True,
                        key_valid=jnp.asarray(inp["key_valid"]),
                        bidir_mask=jnp.asarray(inp["bidir"]))
    for o in out:
        np.testing.assert_allclose(o["o"], ref.detach().numpy(), rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(o["o"], np.asarray(jout), rtol=5e-4, atol=5e-4)
        for name, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(o[name], g.numpy(), rtol=5e-4, atol=5e-4,
                                       err_msg=name)


# --- (iii) sharded prediction ---------------------------------------------

def _predict_inputs():
    """test_sharded_inference.py::test_flash_tp_mesh_shard_map_route_matches's
    inputs: two rows of the same 10-token prompt, one image pair each."""
    rng = np.random.default_rng(0)
    h = TINY_DINOV2.image_size
    pixels = rng.random((2, 1, 2, h, h, 3)).astype(np.float32)
    ids = np.zeros((2, 12), np.int64)
    mask = np.zeros((2, 12), np.int64)
    ids[:, 2] = 1
    ids[:, 3:12] = 7
    mask[:, 2:] = 1
    return {"input_ids": ids, "prompt_mask": mask, "pixels": pixels}


def test_sharded_prediction_matches_single_device_and_jax(tmp_path):
    """predict_action_hidden on a (1, 2, 2) mesh (fsdp splits the two rows,
    tp the heads through flash_attention_tp) against the port on one process
    and JAX's tp-mesh route on the same mesh and numpy weights: 5e-4."""
    params = _np(init_openvla_params(jax.random.PRNGKey(0), CFG, LIBERO,
                                     dtype=jnp.float32, head="l1"))
    b = _predict_inputs()
    out = launch("predict", 4, {"mesh": (1, 2, 2), "params": params, "batch": b,
                                "platform": "libero", "use_flash": True, "num_images": 1},
                 tmp_path)
    got = np.zeros((2,) + out[0]["actions_hidden"].shape[1:], np.float32)
    for o in out:
        got[slice(*o["rows"])] = o["actions_hidden"]

    with torch.no_grad():
        single = port_predict(params_from_numpy(params), P_CFG, port_platform(LIBERO),
                              torch.from_numpy(b["input_ids"]),
                              torch.from_numpy(b["prompt_mask"]),
                              torch.from_numpy(b["pixels"]), use_flash=True).actions_hidden
    np.testing.assert_allclose(got, single.numpy(), rtol=5e-4, atol=5e-4)

    mesh = jax_mesh(1, 2, 2)
    with mesh:
        sp = jax_shard(jax.tree_util.tree_map(jnp.asarray, params), mesh)
        ref = jax.jit(lambda p, px, i, m: jax_predict(
            p, CFG, LIBERO, input_ids=i, prompt_mask=m, pixels=px, use_flash=True,
            tp_mesh=mesh).actions_hidden)(
            sp, jnp.asarray(b["pixels"]), jnp.asarray(b["input_ids"], jnp.int32),
            jnp.asarray(b["prompt_mask"], jnp.int32))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=5e-4, atol=5e-4)


def test_tp_policy_serves_every_head(tmp_path):
    """`OpenVLAPolicy(tp_mesh=...)` on two ranks (tp = 2: each rank 2 of the
    4 heads) against the same policy on one rank, for the L1, diffusion and
    discrete heads and the L1 head's frames route. fp32, 5e-4 on the
    actions; the discrete head's decoded bins exactly."""
    rng = np.random.default_rng(3)
    h = TINY_DINOV2.image_size
    request = {"pixels": rng.standard_normal((1, 2, h, h, 3)).astype(np.float32),
               "frames": rng.integers(0, 256, (1, 40, 40, 3), dtype=np.uint8),
               "proprio": rng.standard_normal(8).astype(np.float32),
               "noise": rng.standard_normal((1, 8, 7)).astype(np.float32),
               "instruction": "put the bowl on the plate"}
    out = launch("policy", 2, {"mesh": (1, 1, 2), "platform": "libero", "num_images": 1,
                               "heads": ["l1", "diffusion", "discrete"],
                               "request": request}, tmp_path)
    for o in out:
        for key in ("l1", "diffusion", "frames"):
            np.testing.assert_allclose(o[f"{key}-tp"], o[f"{key}-single"], rtol=5e-4,
                                       atol=5e-4, err_msg=key)
        np.testing.assert_array_equal(o["discrete-tp"], o["discrete-single"])
    np.testing.assert_array_equal(out[0]["l1-tp"], out[1]["l1-tp"])


def test_collectives_a_layer_takes(tmp_path):
    """What phase 18 reports per request, per Llama layer at tp = 2: the
    unfused projections, head-aligned, take one all-reduce after wo and one
    after down and no gather; the fused wqkv and gate_up add one all-gather
    each (their columns are not head-aligned: ROADMAP item 30)."""
    out = launch("collectives", 2, {"mesh": (1, 1, 2)}, tmp_path)
    for o in out:
        assert o["unfused"] == {"all_gather": 0, "all_reduce": 2}
        assert o["fused"] == {"all_gather": 2, "all_reduce": 2}
