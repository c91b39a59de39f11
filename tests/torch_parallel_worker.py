"""One rank of the port's multi-process CPU tests (`test_torch_parallel*.py`).

    python tests/torch_parallel_worker.py CASE RANK WORLD DIR

joins a gloo group of WORLD processes through a `file://` store in DIR, reads
`DIR/in.pkl` (numpy inputs the test wrote, with the mesh and the case's
settings), runs CASE on the ("dp", "fsdp", "tp") mesh and writes
`DIR/out_<RANK>.pkl`. It imports torch and the port, never JAX: the tests
compute every JAX reference in their own process.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, v) for v in tree)
    return fn(tree)


def _torch(tree):
    return _tree(lambda x: torch.from_numpy(np.array(x)), tree)


def _numpy(tree):
    return _tree(lambda t: t.detach().float().numpy() if t.is_floating_point()
                 else t.detach().numpy(), tree)


def _data_slice(mesh, n_rows: int) -> slice:
    """This rank's rows of a global batch split over ("dp", "fsdp")."""
    c = mesh.get_coordinate()
    n = mesh.size(0) * mesh.size(1)
    i = c[0] * mesh.size(1) + c[1]
    return slice(i * n_rows // n, (i + 1) * n_rows // n)


def _tiny_cfg(inp):
    import openvla_oft_tpu_torch.config as C

    C._VISION_REGISTRY.setdefault("tiny-dual", (C.TINY_DINOV2, C.TINY_SIGLIP))
    C._LLM_REGISTRY.setdefault("tiny-llama", C.TINY_LLAMA)
    return C.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                           num_images_in_input=inp.get("num_images", 2))


def case_mesh_checks(inp, mesh):
    from openvla_oft_tpu_torch.parallel.mesh import make_mesh

    try:
        make_mesh(1, 2, 1, device_type="cpu")
        wrong = None
    except ValueError as e:
        wrong = str(e)
    return {"wrong_product": wrong, "mesh": list(mesh.mesh.shape)}


def case_flash_tp(inp, mesh):
    from openvla_oft_tpu_torch.ops.flash_attention import flash_attention_tp

    q, k, v, do = (torch.from_numpy(inp[n]).requires_grad_(n != "do")
                   for n in ("q", "k", "v", "do"))
    kv, bd = torch.from_numpy(inp["key_valid"]), torch.from_numpy(inp["bidir"])
    o = flash_attention_tp(q, k, v, mesh, is_causal=True, key_valid=kv, bidir_mask=bd)
    full = o.full_tensor()
    dq, dk, dv = torch.autograd.grad(full, (q, k, v), do)
    return {"o": full, "dq": dq, "dk": dk, "dv": dv, "local_heads": o.to_local().shape[2]}


def case_predict(inp, mesh):
    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden
    from openvla_oft_tpu_torch.parallel.sharding import (compute_view, dtensor_context,
                                                         shard_params)

    cfg = _tiny_cfg(inp)
    params = shard_params(_torch(inp["params"]), mesh)
    b = inp["batch"]
    sl = _data_slice(mesh, b["input_ids"].shape[0])
    with torch.no_grad(), dtensor_context(params):
        out = predict_action_hidden(
            compute_view(params), cfg, get_platform(inp["platform"]),
            torch.from_numpy(b["input_ids"][sl]), torch.from_numpy(b["prompt_mask"][sl]),
            torch.from_numpy(b["pixels"][sl]), use_flash=inp["use_flash"]).actions_hidden
    return {"rows": (sl.start, sl.stop), "actions_hidden": out}


def case_collectives(inp, mesh):
    """The collectives one `llama_model` forward takes on the tp mesh, per
    layer, with the unfused (training) and the fused (serving) projections."""
    from openvla_oft_tpu_torch import bridge
    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.models.llama import fuse_inference_weights, llama_model
    from openvla_oft_tpu_torch.parallel.sharding import (compute_view, dtensor_context,
                                                         replicate, shard_params)

    cfg = _tiny_cfg(inp)
    llm = bridge.init_params(cfg, get_platform("libero"), torch.Generator().manual_seed(0),
                             dtype=torch.float32, keys=("llm",))["llm"]
    x = torch.randn((1, 12, cfg.llm.hidden_size), generator=torch.Generator().manual_seed(1))
    out = {}
    for name, tree in (("unfused", llm), ("fused", fuse_inference_weights(llm))):
        params = shard_params({"llm": tree}, mesh)
        replicate.counts.update({k: 0 for k in replicate.counts})
        with torch.no_grad(), dtensor_context(params):
            llama_model(compute_view(params)["llm"], cfg.llm, x, use_flash=True)
        out[name] = {k: v / cfg.llm.num_layers for k, v in replicate.counts.items()
                     if not k.endswith("bytes")}
    return out


def case_policy(inp, mesh):
    """Each head's `OpenVLAPolicy.predict_action` with `tp_mesh` and without,
    on the same random fp32 weights and request; the L1 head also through
    `predict_action_from_frames`."""
    from openvla_oft_tpu_torch import bridge
    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy

    cfg = _tiny_cfg(inp)
    platform = get_platform(inp["platform"])
    r = inp["request"]
    stats = {"libero": {"action": {k: [-1.0 + (k == "max" or k == "q99") * 2.0] * 7
                                   for k in ("min", "max", "q01", "q99")}}}
    out = {}
    for head in inp["heads"]:
        params = bridge.init_params(cfg, platform, torch.Generator().manual_seed(0),
                                    dtype=torch.float32, head=head)
        kw = dict(head=head, norm_stats=stats, fast_gelu=False, prompt_bucket=16,
                  num_diffusion_steps=4)
        noise = torch.from_numpy(r["noise"])
        for name, m in (("single", None), ("tp", mesh)):
            pol = OpenVLAPolicy(cfg, platform, params, tp_mesh=m, **kw)
            out[f"{head}-{name}"] = pol.predict_action(
                r["pixels"], r["instruction"], r["proprio"],
                noise=noise if head == "diffusion" else None)
            if head == "l1":
                out[f"frames-{name}"] = pol.predict_action_from_frames(
                    r["frames"], r["instruction"], r["proprio"])
    return out


def case_train_step(inp, mesh):
    import dataclasses

    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.parallel.sharding import gather_params, shard_params
    from openvla_oft_tpu_torch.training import train_step as TT

    cfg = _tiny_cfg(inp)
    tcfg = TT.TrainConfig(**inp["train_config"])
    base = shard_params(_torch(inp["base"]), mesh)
    trainables = _torch(inp["trainables"])
    for t in _flat(trainables):
        t.requires_grad_(True)
    trainables = shard_params(trainables, mesh)
    state = TT.create_train_state(base, trainables, dataclasses.replace(tcfg))
    b = inp["batch"]
    sl = _data_slice(mesh, b["input_ids"].shape[0])
    batch = {k: torch.from_numpy(v[sl]) for k, v in b.items()}
    state, metrics = TT.train_step(state, batch, cfg, get_platform(inp["platform"]), tcfg,
                                   use_flash=inp["use_flash"])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "trainables": gather_params(state.trainables)}


def case_finetune(inp, mesh):
    """The fine-tuning CLI on this rank: `inp["argv"]`, then, with
    `inp["resume_argv"]`, a second run that resumes from the first's files."""
    from openvla_oft_tpu_torch.training import finetune as FT

    steps = []
    out = FT.main(inp["argv"], on_step=lambda i, m, s: steps.append((i, m["loss"])))
    res = {"final_step": out["final_step"], "run_dir": out["run_dir"], "steps": steps}
    if inp.get("resume_argv"):
        again = []
        out2 = FT.main(inp["resume_argv"], on_step=lambda i, m, s: again.append((i, m["loss"])))
        res.update(resumed_final_step=out2["final_step"], resumed_steps=again)
    return res


def case_train_script(inp, mesh):
    """scripts/train.py or scripts/pretrain.py on this rank with `inp["cfg"]`;
    the trainables at its end, gathered whole."""
    import dataclasses

    from openvla_oft_tpu_torch.parallel.sharding import gather_params
    from openvla_oft_tpu_torch.scripts import pretrain as PP
    from openvla_oft_tpu_torch.scripts import train as PT

    cls = PT.TrainConfig if inp["script"] == "train" else PP.PretrainConfig
    run = PT.train if inp["script"] == "train" else PP.pretrain
    losses = []
    out = run(dataclasses.replace(cls(), **inp["cfg"]),
              on_step=lambda i, m, s: losses.append(m["loss"]))
    return {"final_step": out["final_step"], "ckpt": out["ckpt"], "losses": losses,
            "trainables": gather_params(out["state"].trainables)}


def _stacked(node):
    """A 2-D weight dict as a one-layer stacked one (L = 1)."""
    return {k: v[None] for k, v in node.items()}


def _quant_node(w: torch.Tensor, kind: str) -> dict:
    """The (1, K, N) float weight w as a quantized one-layer leaf dict:
    "int8" (dynamic), "static" (int8 with a calibrated scale_x) or "int4"
    (groups of 16)."""
    from openvla_oft_tpu_torch.ops import quant as Q

    if kind == "int4":
        return Q.quantize_weight_int4(w, group=16)
    node = Q.quantize_weight(w)
    if kind == "static":
        node["scale_x"] = torch.full((1,), 0.02)
    return node


def case_quant_products(inp, mesh):
    """The quantized linears on the tp = 2 mesh against the same call on one
    device (computed here, on the same weights): a column-parallel "up" and
    a row-parallel "down" for W8A8 (dynamic and static scales), W4A16 and
    W4A8, x's gradient through each, the row-parallel W8A8 with each rank's
    own activation scale (the variant the MAX all-reduce replaces), a packed
    leaf whose row split would cut a scale group, K4's gate on the column
    block of a folded qkv, and an int8 / int4 tree sharded over fsdp."""
    from torch.distributed.tensor import DTensor, Shard

    from openvla_oft_tpu_torch.bridge import index_layer
    from openvla_oft_tpu_torch.models import vit as V
    from openvla_oft_tpu_torch.ops import quant as Q
    from openvla_oft_tpu_torch.ops import vit_fused as VF
    from openvla_oft_tpu_torch.ops.layers import linear
    from openvla_oft_tpu_torch.parallel.mesh import make_mesh
    from openvla_oft_tpu_torch.parallel.sharding import (all_reduce, dtensor_context,
                                                         layer_params, replicate, shard_params)

    x, x_mid = torch.from_numpy(inp["x"]), torch.from_numpy(inp["x_mid"])
    w_up, w_down = (torch.from_numpy(inp[k])[None] for k in ("w_up", "w_down"))
    out = {}

    def run(tree, fn, x_in, grad=False):
        """fn(layer dict, x_in) on the tp mesh and on one device: the
        sharded and the single outputs, x_in's gradients, the collectives
        the sharded call took."""
        sharded = shard_params(tree, mesh)
        res = []
        for t in (sharded, tree):
            xi = x_in.clone().requires_grad_(grad)
            before = dict(replicate.counts)
            with torch.set_grad_enabled(grad), dtensor_context(t):
                layer = layer_params(t["layers"], 0)["mlp"]
                y = replicate(fn(layer, xi))
                g = torch.autograd.grad(y, xi, torch.ones_like(y))[0] if grad else None
            res.append((y.detach(), g, {k: replicate.counts[k] - before[k]
                                        for k in ("all_gather", "all_reduce")}))
        (y, g, n), (y1, g1, _) = res
        return {"tp": y, "single": y1, "dx_tp": g, "dx_single": g1, "collectives": n}

    def up(m, xi):
        return linear(m["up"], xi)

    def down(m, xi):
        return linear(m["down"], xi)

    def chain(m, xi):
        return down(m, up(m, xi))

    for kind in ("int8", "static", "int4"):
        tree = {"layers": {"mlp": {"up": _quant_node(w_up, kind),
                                   "down": _quant_node(w_down, kind)}}}
        out[f"{kind}-up"] = run(tree, up, x, grad=kind != "static")
        out[f"{kind}-down"] = run(tree, down, x_mid, grad=kind != "static")
        out[f"{kind}-chain"] = run(tree, chain, x)
        if kind == "int4":
            with Q.int4_a8():
                out["a8-up"] = run(tree, up, x)
                out["a8-down"] = run(tree, down, x_mid)
                out["a8-chain"] = run(tree, chain, x)

    # Row-parallel W8A8 with each rank's own per-token scale: the fp32
    # partials (acc * own sx) * sw summed over the ranks.
    tree = {"layers": {"mlp": {"down": _quant_node(w_down, "int8")}}}
    with torch.no_grad():
        lp = layer_params(shard_params(tree, mesh)["layers"], 0)["mlp"]["down"]
        k = lp["kernel"].to_local()
        r = mesh.get_local_rank("tp")
        xl = x_mid[..., r * k.shape[0]:(r + 1) * k.shape[0]]
        part = Q._int8_forward(xl, k, lp["scale_w"], None)
        out["int8-down-local-scale"] = all_reduce(part, mesh["tp"].get_group()).to(x.dtype)

    # A packed leaf whose rows cut a scale group at tp = 2 (3 groups of 16):
    # kept whole, its input (the column-parallel up's output) gathered.
    w_odd = torch.from_numpy(inp["w_odd"])[None]
    tree = {"layers": {"mlp": {"up": _quant_node(w_up[..., :w_odd.shape[1]], "int4"),
                               "down": _quant_node(w_odd, "int4")}}}
    out["split-group"] = run(tree, chain, x)
    shard_params(tree, mesh)
    out["split-group"]["kept_whole"] = list(shard_params.kept_whole)

    # K4's gate on a tp-sharded folded qkv: ln_matmul on the whole x and the
    # rank's column block (its plain version on the CPU).
    qkv = {"kernel": torch.from_numpy(inp["w_qkv"])[None],
           "bias": torch.from_numpy(inp["b_qkv"])[None]}
    tree = {"layers": {"mlp": {"up": qkv}}}
    sharded = shard_params(tree, mesh)
    with torch.no_grad(), VF.vit_fused(), dtensor_context(sharded):
        lp = layer_params(sharded["layers"], 0)["mlp"]["up"]
        gate = V._use_fused_ln_matmul({}, lp)
        y = V._ln_linear({}, lp, x, act_name="gelu")
        out["k4"] = {"gate": gate, "dtensor": isinstance(y, DTensor) and
                     y.placements == (Shard(y.ndim - 1),),
                     "local_cols": y.to_local().shape[-1], "tp": replicate(y),
                     "single": V._ln_linear({}, index_layer(tree["layers"], 0)["mlp"]["up"],
                                            x, act_name="gelu")}

    # int8 and packed int4 leaves over fsdp = 2: each gathered whole before
    # the product (DTensor's redistribute of an int8 DTensor under gloo).
    fsdp = make_mesh(1, 2, 1, device_type="cpu")
    for kind in ("int8", "int4"):
        tree = {"layers": {"mlp": {"up": _quant_node(w_up, kind)}}}
        sharded = shard_params(tree, fsdp)
        name = "kernel_q4" if kind == "int4" else "kernel"
        with torch.no_grad(), dtensor_context(sharded):
            lp = layer_params(sharded["layers"], 0)["mlp"]["up"]
            whole = index_layer(tree["layers"], 0)["mlp"]["up"]
            out[f"fsdp-{kind}"] = {
                "local_rows": sharded["layers"]["mlp"]["up"][name].to_local().shape[1],
                "gathered_equal": torch.equal(lp[name], whole[name]),
                "tp": linear(lp, x), "single": linear(whole, x)}
    return out


def case_quant_policy(inp, mesh):
    """`OpenVLAPolicy` on the tp = 2 mesh and on one device, for each of
    inp["variants"]: its numpy tree (quantized by the test), its config and
    switches; the staged actions and the action rows' hidden states."""
    import openvla_oft_tpu_torch.config as C
    from openvla_oft_tpu_torch.bridge import params_from_numpy
    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden
    from openvla_oft_tpu_torch.parallel.sharding import replicate, shard_params
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy

    _tiny_cfg(inp)
    C._LLM_REGISTRY.setdefault("int4-test-llama", C.LlamaConfig(
        vocab_size=32064, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=2,
        num_kv_heads=2))
    platform = get_platform("libero")
    r = inp["request"]
    b = inp["batch"]
    out = {}
    for name, v in inp["variants"].items():
        cfg = C.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id=v["llm"],
                              num_images_in_input=2)
        res = {}
        for where, m in (("single", None), ("tp", mesh)):
            pol = OpenVLAPolicy(cfg, platform, params_from_numpy(v["params"]), tp_mesh=m,
                                fast_gelu=False, prompt_bucket=16, int4_a8=v["int4_a8"],
                                vit_fused=v["vit_fused"])
            if m is not None:
                res["kept_whole"] = list(shard_params.kept_whole)
            before = dict(replicate.counts)
            res[f"actions-{where}"] = pol.predict_action(r["pixels"], r["instruction"],
                                                         r["proprio"])
            res[f"collectives-{where}"] = {k: replicate.counts[k] - before[k]
                                           for k in ("all_gather", "all_reduce")}
            params, ctx = pol._sharded()
            with torch.no_grad(), ctx, Q_modes(v):
                res[f"hidden-{where}"] = predict_action_hidden(
                    params, pol.cfg, platform, torch.from_numpy(b["input_ids"]),
                    torch.from_numpy(b["prompt_mask"]), torch.from_numpy(b["pixels"]),
                    proprio=torch.from_numpy(b["proprio"]), use_flash=True).actions_hidden
        out[name] = res
    return out


def Q_modes(v):
    """The int4_a8 and vit_fused switches of a policy variant, as a context."""
    import contextlib

    from openvla_oft_tpu_torch.ops.quant import int4_a8
    from openvla_oft_tpu_torch.ops.vit_fused import vit_fused

    stack = contextlib.ExitStack()
    stack.enter_context(int4_a8(v["int4_a8"]))
    stack.enter_context(vit_fused(v["vit_fused"]))
    return stack


def case_qlora_step(inp, mesh):
    """One QLoRA train step (the base quantized here, bits 8 and 4, every
    kernel with min_dim 1; int4 with `FUSED_MAX_ROWS` set to
    inp["int4_fused_max_rows"]) at fsdp = 2 and at tp = 2 on the same two
    ranks; the metrics and the trainables after the update, gathered whole."""
    import dataclasses

    from openvla_oft_tpu_torch.bridge import params_from_numpy
    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.ops import quant as Q
    from openvla_oft_tpu_torch.ops.quant import quantize_tree_lowmem
    from openvla_oft_tpu_torch.parallel.mesh import make_mesh
    from openvla_oft_tpu_torch.parallel.sharding import gather_params, shard_params
    from openvla_oft_tpu_torch.training import train_step as TT

    cfg = _tiny_cfg(inp)
    tcfg = TT.TrainConfig(**inp["train_config"])
    b = inp["batch"]
    fused_max = Q.FUSED_MAX_ROWS
    out = {}
    for shape in ((1, 2, 1), (1, 1, 2)):
        m = make_mesh(*shape, device_type="cpu")
        sl = _data_slice(m, b["input_ids"].shape[0])
        batch = {k: torch.from_numpy(v[sl]) for k, v in b.items()}
        for bits in (8, 4):
            Q.FUSED_MAX_ROWS = inp["int4_fused_max_rows"] if bits == 4 else fused_max
            base = {k: quantize_tree_lowmem(v, min_dim=1, bits=bits)
                    for k, v in params_from_numpy(inp["base"]).items()}
            trainables = params_from_numpy(inp["trainables"])
            for t in _flat(trainables):
                t.requires_grad_(True)
            state = TT.create_train_state(shard_params(base, m), shard_params(trainables, m),
                                          dataclasses.replace(tcfg))
            state, metrics = TT.train_step(state, batch, cfg, get_platform("libero"), tcfg,
                                           use_flash=True)
            out[f"bits{bits}-{'x'.join(map(str, shape))}"] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "trainables": gather_params(state.trainables)}
    return out

def _flat(tree):
    from openvla_oft_tpu_torch.bridge import tree_leaves

    return tree_leaves(tree)


def launch(case: str, world: int, inp: dict, workdir, timeout: float = 120.0) -> list:
    """Run CASE on WORLD processes (the parent side, in a test): writes
    `in.pkl`, starts the ranks, joins each within `timeout` seconds in all,
    kills every rank that is left and fails with their output. Returns each
    rank's `out_<rank>.pkl`."""
    import subprocess
    import time

    import pytest

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    logs = [open(workdir / f"log_{r}.txt", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, case, str(r), str(world),
                               str(workdir)], stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(p.returncode != 0 for p in procs):
        text = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n"
                         + (workdir / f"log_{r}.txt").read_text()[-4000:]
                         for r, p in enumerate(procs))
        pytest.fail(f"{case} on {world} processes failed or timed out:\n{text}")
    out = []
    for r in range(world):
        with open(workdir / f"out_{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def main(case: str, rank: int, world: int, workdir: str) -> None:
    from openvla_oft_tpu_torch.parallel.mesh import init_distributed, make_mesh

    with open(os.path.join(workdir, "in.pkl"), "rb") as f:
        inp = pickle.load(f)
    init_distributed("cpu", f"file://{os.path.join(workdir, 'store')}", world, rank,
                     timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(*inp["mesh"], device_type="cpu")
        out = globals()[f"case_{case}"](inp, mesh)
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump(_tree(lambda x: _numpy({"x": x})["x"] if torch.is_tensor(x) else x,
                              out), f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

