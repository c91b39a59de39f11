"""The port's multi-device dryrun and 7B memory audit
(`openvla_oft_tpu_torch/scripts/dryrun_multichip.py`) against
`__graft_entry__.py`'s.

The audit: the flagship LoRA train state built on meta tensors, its bytes a
device under `parallel/sharding.py::param_placements` for each n = 8
factorization, against `__graft_entry__.py::_tree_device_bytes` on JAX's
`jax.eval_shape` of the same state on the 8-device CPU mesh: the base and
the trainables byte for byte; the optimizer's state 8 bytes apart, the one
leaf difference (optax's two int32 step counts on the device, which the
port's optimizer keeps on the host); the share of big arrays split, and
the verdicts against the JAX audit's 15.75 GB budget. Then one whole dryrun
at n = 4 over gloo, mesh (1, 2, 2): (a) a finite sharded step, (b) a
10-step trajectory within 2e-2 of one process and descending (the CLI's
default is 24 steps; 10 keep the file's time down, and the last cycle's
mean is 0.87 of the first's there), (c) tp = 2 and tp = 4 serving within
2e-4 (about 20 s alone on the CPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as G
from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.parallel.mesh import make_mesh
from openvla_oft_tpu.parallel.sharding import param_pspecs
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.training.lora import init_lora
from openvla_oft_tpu.training.train_step import TrainConfig, create_train_state
from openvla_oft_tpu_torch.parallel import sharding as S
from openvla_oft_tpu_torch.scripts import dryrun_multichip as D

# `__graft_entry__.audit_7b_memory`'s default budget (GB a device).
JAX_BUDGET_GB = 15.75
# optax.adamw's state holds two int32 step counts (scale_by_adam's and
# scale_by_schedule's), replicated on every device; the port's optimizer
# keeps its counts on the host (torch AdamW's per-parameter `step`,
# Bf16AdamW's int).
OPTAX_COUNT_BYTES = 2 * 4
# (b)'s steps in the gloo dryrun here.
TEST_STEPS = 10


@functools.lru_cache(maxsize=1)
def port_state():
    return D.flagship_train_state()


@functools.lru_cache(maxsize=1)
def jax_state():
    """`audit_7b_memory`'s `build_state` under `jax.eval_shape`."""
    cfg = G._flagship_cfg()
    tcfg = TrainConfig(objective="l1", lora_rank=32, lora_alpha=16.0)

    def build_state():
        full = init_openvla_params(jax.random.PRNGKey(0), cfg, LIBERO, dtype=jnp.bfloat16,
                                   head="l1")
        base = {k: full[k] for k in ("llm", "vision_backbone", "projector")}
        trainables = {"lora": init_lora(jax.random.PRNGKey(1), base, rank=32),
                      "action_head": full["action_head"],
                      "proprio_projector": full["proprio_projector"]}
        return create_train_state(base, trainables, tcfg, jax.random.PRNGKey(2))

    return jax.eval_shape(build_state)


def jax_split_share(state, mesh) -> tuple:
    """`audit_7b_memory`'s count (`:323-331`): of the state's arrays of at
    least 2**21 elements, how many their specs split."""
    leaves = jax.tree_util.tree_leaves(state)
    specs = jax.tree_util.tree_leaves(param_pspecs(state, mesh),
                                      is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    big = [spec for leaf, spec in zip(leaves, specs)
           if int(np.prod(leaf.shape or (1,))) >= D.BIG_ELEMENTS]
    return sum(G._spec_divisor(spec, mesh) > 1 for spec in big), len(big)


@pytest.mark.parametrize("factors", D.AUDIT_CONFIGS, ids=lambda f: "x".join(map(str, f)))
def test_audit_bytes_are_jaxs(factors):
    js, ps = jax_state(), port_state()
    mesh = make_mesh(*factors)
    shape = dict(zip(("dp", "fsdp", "tp"), factors))
    want = {"base": G._tree_device_bytes(js.base_params, mesh),
            "trainables": G._tree_device_bytes(js.trainables, mesh),
            "opt": G._tree_device_bytes(js.opt_state, mesh)}
    got = {k: D.device_bytes(ps[k], shape) for k in want}
    assert got["base"] == want["base"]
    assert got["trainables"] == want["trainables"]
    assert got["opt"] + OPTAX_COUNT_BYTES == want["opt"]
    assert ps["host"] and all(t.device.type == "cpu" and t.numel() == 1 for t in ps["host"])
    n_split, n_big = D.split_share([ps[k] for k in ("base", "trainables", "opt")], shape)
    assert (n_split, n_big) == jax_split_share(js, mesh)


def test_audit_verdicts_are_jaxs(capsys):
    """At n = 8 every factorization fits JAX's budget on both sides, with the
    same GB a device; at n = 1 the state does not fit it (17.246 GB), and the
    port's audit raises as JAX's assert does."""
    js = jax_state()
    results = D.audit_7b_memory(8, JAX_BUDGET_GB, port_state())
    assert [(r["dp"], r["fsdp"], r["tp"]) for r in results] == list(D.AUDIT_CONFIGS)
    for r in results:
        mesh = make_mesh(r["dp"], r["fsdp"], r["tp"])
        total = sum(G._tree_device_bytes(t, mesh)
                    for t in (js.base_params, js.trainables, js.opt_state)) / 2**30
        assert r["gb_per_device"] == round(total, 3) and total < JAX_BUDGET_GB
    out = capsys.readouterr().out
    assert out.count(" OK\n") == 4 and "92/92 big arrays split" in out
    with pytest.raises(AssertionError, match="does not fit the budget"):
        D.audit_7b_memory(1, JAX_BUDGET_GB, port_state())
    assert D.audit_7b_memory(1, 80.0, port_state())[0]["gb_per_device"] == 17.246


def test_audit_fails_where_the_rules_split_nothing(monkeypatch):
    """Without the rules nothing is split: under a budget the whole state
    fits (80 GB), the split check fails."""
    monkeypatch.setattr(S, "_RULES", [])
    with pytest.raises(AssertionError, match="leave big arrays replicated: 0/92"):
        D.audit_7b_memory(8, 80.0, port_state())


def test_mesh_factors_are_jaxs():
    for n in range(1, 17):
        assert D.mesh_factors(n) == G._mesh_factors(n)


def test_dryrun_four_ranks_over_gloo(capsys):
    """(a)-(d) at n = 4 over gloo on the CPU, the mesh (1, 2, 2)."""
    report = D.dryrun_multichip(4, "cpu", budget_gb=JAX_BUDGET_GB, timeout=400,
                                steps=TEST_STEPS, state=port_state())
    assert report["mesh"] == (1, 2, 2)
    assert np.isfinite(report["loss"])
    assert len(report["trajectory"]) == TEST_STEPS
    assert report["max_gap"] < D.TRAJECTORY_RTOL
    assert np.mean(report["trajectory"][-2:]) < 0.9 * np.mean(report["trajectory"][:2])
    assert sorted(report["serving"]) == [2, 4]
    assert all(d <= D.SERVING_TOL for d in report["serving"].values())
    assert report["audit"][0]["gb_per_device"] == 5.044
    assert "dryrun_multichip(4) on cpu: mesh dp=1 fsdp=2 tp=2 OK" in capsys.readouterr().out
