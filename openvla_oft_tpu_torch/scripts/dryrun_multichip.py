"""Multi-device dryrun of the whole system, and the 7B memory audit.

Port of `__graft_entry__.py:191-618` (`dryrun_multichip`,
`_convergence_dryrun`, `_serving_dryrun`, `audit_7b_memory`). The JAX
version runs on n virtual CPU devices in one process; here n processes join
one process group (NCCL, one card a rank, where n cards are visible; gloo
with `--device cpu`, through a `file://` store, as
`scripts/dryrun_multiprocess.py` does), on a ("dp", "fsdp", "tp") mesh of
`mesh_factors(n)`, at the TINY configs:

  (a) one sharded LoRA step (L1 head, proprio) with a finite loss;
  (b) 24 steps (`dryrun_multichip`'s `steps`) on two cycled batches,
      sharded, held to the same steps on one process: the largest relative
      loss gap under 2e-2, and the last cycle's mean loss under 0.9 of the
      first's;
  (c) `predict_action_hidden` and the L1 head served tp-sharded at tp = 2
      and tp = 4 (a (n / tp, 1, tp) mesh: each data rank serves the same
      request), wherever n allows, each within 2e-4 of one process; no tp at
      all fails;
  (d) `audit_7b_memory`: the flagship train state's bytes a device under
      `parallel/sharding.py`'s placements, for each (dp, fsdp, tp)
      factorization of the mesh, against a memory budget.

The one-process references run in this process while the ranks run. Two
parts of the JAX version have no counterpart: its guard that fails on XLA's
SPMD replicate-then-reshard fallback in the compile's stderr
(`_capture_cc_stderr`, `:351-382`; DTensor inserts no such fallback), and its
abstract lowering of the 7B train step (`:289-347`; PyTorch has no program to
lower without running it).

    python -m openvla_oft_tpu_torch.scripts.dryrun_multichip [n] [--device cuda|cpu]
        [--budget_gb G] [--timeout S]

It runs on n cards (NCCL) unless `--device cpu` is given; on the CPU it is n
gloo processes, as the JAX version runs on virtual CPU devices. Exit code 0
= (a)-(d) all held. `audit_7b_memory` alone needs no process group: the
placements are a function of the mesh's shape.
"""

from __future__ import annotations

import argparse
import datetime
import os
import pickle
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# The factorizations the audit takes at 8 devices; any other count takes its
# `mesh_factors` split, so that the audit never checks nothing.
AUDIT_CONFIGS = ((2, 2, 2), (1, 4, 2), (1, 2, 4), (1, 8, 1))
# Arrays of at least this many elements count as big in the split check.
BIG_ELEMENTS = 1 << 21
# The port's card's nominal memory (an NVIDIA H100 80GB), the audit's budget
# where no card is visible to read it from.
H100_MEMORY_GB = 80.0
TRAJECTORY_STEPS = 24
TRAJECTORY_RTOL = 2e-2
SERVING_TOL = 2e-4
SERVING_BUCKET = 16


def mesh_factors(n: int) -> tuple:
    """(dp, fsdp, tp) of n devices, every axis exercised where n allows
    (`__graft_entry__.py::_mesh_factors`)."""
    if n == 1:
        return 1, 1, 1
    if n % 4 == 0:
        return n // 4, 2, 2
    if n % 2 == 0:
        return n // 2, 1, 2
    return n, 1, 1


# --- (d) the 7B memory audit -------------------------------------------------

def flagship_train_state() -> dict:
    """The flagship's LoRA train state on `device="meta"` (shapes, dtypes, no
    data), as the JAX audit builds it: the bf16 base (the LLM with its
    lm_head, the ViT pair, the fp32 projector), the trainables (LoRA r = 32
    in fp32, the fp32 L1 head and proprio projector) and the optimizer's
    state after one update of `create_train_state`'s optimizer. Returns
    {"base", "trainables", "opt": {"mu", "nu"} shaped as the trainables,
    "host": the optimizer's leaves that live on the host}."""
    from openvla_oft_tpu_torch.bridge import _HEAD_KEYS, param_spec, tree_leaves
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.scripts.bench_entry import _meta, flagship_cfg
    from openvla_oft_tpu_torch.training.lora import init_lora
    from openvla_oft_tpu_torch.training.train_step import TrainConfig, create_train_state

    cfg = flagship_cfg()
    spec = param_spec(cfg, LIBERO, "l1")
    # The JAX audit's init keeps the lm_head (`with_lm_head` at its default).
    spec["llm"]["lm_head"] = param_spec(cfg, LIBERO, "discrete")["llm"]["lm_head"]
    full = {k: _meta(v, torch.float32 if k in _HEAD_KEYS else torch.bfloat16)
            for k, v in spec.items()}
    base = {k: full[k] for k in ("llm", "vision_backbone", "projector")}
    trainables = {"lora": init_lora(torch.Generator(), base, rank=32, device="meta"),
                  "action_head": full["action_head"],
                  "proprio_projector": full["proprio_projector"]}
    for t in tree_leaves(trainables):
        t.requires_grad_(True)
    state = create_train_state(base, trainables, TrainConfig(lora_rank=32, lora_alpha=16.0),
                               generator=torch.Generator())
    opt = state.optimizer
    opt.update([torch.empty_like(p) for p in opt.params])
    moments = {"mu": [], "nu": []}
    host = []
    for i, p in enumerate(opt.params):
        if p.dtype == torch.bfloat16:
            j = opt.bf16.index(i)
            st = {"mu": opt.low.mu[j], "nu": opt.low.nu[j]}
        else:
            a = opt.adamw.state[p]
            st = {"mu": a["exp_avg"], "nu": a["exp_avg_sq"]}
            host.append(a["step"])          # torch AdamW keeps its step count on the host
        for k in moments:
            moments[k].append(st[k])

    def like(tree, it):
        if isinstance(tree, dict):
            return {k: like(v, it) for k, v in tree.items()}
        if isinstance(tree, list):
            return [like(v, it) for v in tree]
        return next(it)

    opt_tree = {k: like(trainables, iter(v)) for k, v in moments.items()}
    return {"base": base, "trainables": trainables, "opt": opt_tree, "host": host}


def _leaf_placements(tree, placements):
    """(leaf, its placements) of a tree and its `param_placements`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_placements(v, placements[k])
    elif isinstance(tree, list):
        for v, pl in zip(tree, placements):
            yield from _leaf_placements(v, pl)
    else:
        yield tree, placements


def _split(placements, mesh_shape: dict) -> int:
    """The number of devices a leaf of these placements is split over."""
    from openvla_oft_tpu_torch.parallel.mesh import AXES

    return int(np.prod([mesh_shape[ax] for ax, p in zip(AXES, placements) if p.is_shard()]))


def device_bytes(tree, mesh_shape: dict) -> float:
    """Bytes a device holds of `tree` under `param_placements` on a mesh of
    `mesh_shape`: each leaf's bytes over the devices its placement splits it
    across (`__graft_entry__.py::_tree_device_bytes`)."""
    from openvla_oft_tpu_torch.parallel.sharding import param_placements

    return sum(t.numel() * t.element_size() / _split(pl, mesh_shape)
               for t, pl in _leaf_placements(tree, param_placements(tree, mesh_shape)))


def split_share(trees, mesh_shape: dict) -> tuple:
    """(split, big): of the leaves of `trees` with at least BIG_ELEMENTS
    elements, how many the placements split over more than one device."""
    from openvla_oft_tpu_torch.parallel.sharding import param_placements

    big = [pl for tree in trees
           for t, pl in _leaf_placements(tree, param_placements(tree, mesh_shape))
           if t.numel() >= BIG_ELEMENTS]
    return sum(_split(pl, mesh_shape) > 1 for pl in big), len(big)


def card_memory_gb() -> float:
    """The visible card's memory in GB (2**30 bytes), else the port's card's
    nominal 80."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory / 2**30
    return H100_MEMORY_GB


def audit_7b_memory(n_devices: int = 8, budget_gb=None, state=None) -> list:
    """For each (dp, fsdp, tp) factorization of n devices (`AUDIT_CONFIGS` at
    8, else `mesh_factors(n)`): the flagship train state's GB (2**30 bytes) a
    device (base, LoRA + heads, optimizer), asserted under `budget_gb` (the
    card's memory by default, `card_memory_gb`). On a mesh of more than one
    device, at least 80 % of the state's big arrays must be split (the
    check of `__graft_entry__.py:323-331`, at the first factorization).
    `state`: `flagship_train_state()`'s, built once by the caller."""
    budget_gb = card_memory_gb() if budget_gb is None else budget_gb
    state = flagship_train_state() if state is None else state
    configs = [c for c in AUDIT_CONFIGS if int(np.prod(c)) == n_devices] \
        or [mesh_factors(n_devices)]
    results = []
    for dp, fsdp, tp in configs:
        shape = {"dp": dp, "fsdp": fsdp, "tp": tp}
        parts = {k: device_bytes(state[k], shape) for k in ("base", "trainables", "opt")}
        gb = {k: v / 2**30 for k, v in parts.items()}
        total = sum(gb.values())
        ok = total < budget_gb
        print(f"7b-audit dp={dp} fsdp={fsdp} tp={tp}: base={gb['base']:.2f} "
              f"lora+heads={gb['trainables']:.3f} opt={gb['opt']:.3f} total={total:.2f} "
              f"GB/device (budget {budget_gb:.2f}) {'OK' if ok else 'OVER BUDGET'}",
              flush=True)
        if not ok:
            raise AssertionError(f"the 7B state does not fit the budget at dp={dp} fsdp={fsdp} "
                                 f"tp={tp}: {total:.2f} GB/device >= {budget_gb}")
        results.append({"dp": dp, "fsdp": fsdp, "tp": tp, "bytes": parts,
                        "gb_per_device": round(total, 3)})
    if n_devices > 1:
        dp, fsdp, tp = configs[0]
        n_split, n_big = split_share([state[k] for k in ("base", "trainables", "opt")],
                                     {"dp": dp, "fsdp": fsdp, "tp": tp})
        print(f"7b-audit dp={dp} fsdp={fsdp} tp={tp}: {n_split}/{n_big} big arrays split",
              flush=True)
        if not (n_big and n_split >= 0.8 * n_big):
            raise AssertionError(f"the sharding rules leave big arrays replicated: "
                                 f"{n_split}/{n_big} split")
    return results


# --- (a)-(c) on the ranks ----------------------------------------------------

def tiny_cfg():
    import openvla_oft_tpu_torch.config as C

    C._VISION_REGISTRY.setdefault("tiny-dual", (C.TINY_DINOV2, C.TINY_SIGLIP))
    C._LLM_REGISTRY.setdefault("tiny-llama", C.TINY_LLAMA)
    return C.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama")


def tiny_params(device) -> dict:
    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.constants import LIBERO

    return init_params(tiny_cfg(), LIBERO, torch.Generator(device=device).manual_seed(0),
                       device=device, dtype=torch.float32, head="l1")


def make_batch(seed: int, b: int, device, s: int = 80) -> dict:
    """`dryrun_multichip`'s batch (`__graft_entry__.py:567-592`): b rows of
    a BOS, a prompt, the empty token, one action chunk of action tokens and
    STOP, labels on the chunk; random pixels, actions and proprio."""
    from openvla_oft_tpu_torch.config import TINY_DINOV2
    from openvla_oft_tpu_torch.constants import (ACTION_TOKEN_BEGIN_IDX, EMPTY_TOKEN_ID,
                                                 IGNORE_INDEX, LIBERO, STOP_INDEX)

    rng = np.random.default_rng(seed)
    chunk = LIBERO.chunk_len
    input_ids = np.zeros((b, s), np.int32)
    labels = np.full((b, s), IGNORE_INDEX, np.int32)
    attn = np.zeros((b, s), np.int32)
    for i in range(b):
        plen = 7 + i % 3
        seq = ([1] + list(rng.integers(10, 1000, plen - 2)) + [EMPTY_TOKEN_ID]
               + list(rng.integers(ACTION_TOKEN_BEGIN_IDX + 1, ACTION_TOKEN_BEGIN_IDX + 257,
                                   chunk)) + [STOP_INDEX])
        input_ids[i, :len(seq)] = seq
        attn[i, :len(seq)] = 1
        labels[i, plen:len(seq)] = seq[plen:]
    h = TINY_DINOV2.image_size
    arrays = {"input_ids": input_ids, "attention_mask": attn, "labels": labels,
              "pixel_values": rng.random((b, 1, 2, h, h, 3)).astype(np.float32),
              "actions": rng.uniform(-1, 1, (b, LIBERO.num_actions_chunk,
                                             LIBERO.action_dim)).astype(np.float32),
              "proprio": rng.random((b, LIBERO.proprio_dim)).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _data_rows(mesh, n_rows: int) -> slice:
    """This rank's rows of a batch split over ("dp", "fsdp")."""
    if mesh is None:
        return slice(0, n_rows)
    c = mesh.get_coordinate()
    n = mesh.size(0) * mesh.size(1)
    i = c[0] * mesh.size(1) + c[1]
    return slice(i * n_rows // n, (i + 1) * n_rows // n)


def train_config(learning_rate: float = 5e-4):
    from openvla_oft_tpu_torch.training.train_step import TrainConfig

    return TrainConfig(objective="l1", lora_rank=4, lora_alpha=4.0,
                       learning_rate=learning_rate, remat_policy="none")


def train_losses(mesh, batches: list, steps: int, tcfg, device) -> list:
    """The losses of `steps` LoRA steps on the cycled `batches`, on `mesh`
    (sharded; each rank takes its rows) or, with mesh None, on one process."""
    from openvla_oft_tpu_torch.bridge import split_base_trainables
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.parallel.sharding import shard_params
    from openvla_oft_tpu_torch.training.train_step import create_train_state, train_step

    base, trainables = split_base_trainables(
        tiny_params(device), torch.Generator(device=device).manual_seed(1), lora_rank=4)
    if mesh is not None:
        base, trainables = shard_params(base, mesh), shard_params(trainables, mesh)
    state = create_train_state(base, trainables, tcfg)
    losses = []
    for i in range(steps):
        batch = batches[i % len(batches)]
        rows = _data_rows(mesh, batch["input_ids"].shape[0])
        state, metrics = train_step(state, {k: v[rows] for k, v in batch.items()},
                                    tiny_cfg(), LIBERO, tcfg, use_flash=True)
        losses.append(float(metrics["loss"]))
    return losses


def serving_inputs(device) -> tuple:
    """(ids, mask, pixels, proprio) of the serving check's one request
    (`__graft_entry__.py:404-416`)."""
    from openvla_oft_tpu_torch.config import TINY_DINOV2
    from openvla_oft_tpu_torch.constants import LIBERO

    rng = np.random.default_rng(0)
    ids = np.zeros((1, SERVING_BUCKET), np.int32)
    mask = np.zeros((1, SERVING_BUCKET), np.int32)
    real = [1] + list(rng.integers(10, 1000, 10)) + [29871]
    ids[0, SERVING_BUCKET - len(real):] = real
    mask[0, SERVING_BUCKET - len(real):] = 1
    h = TINY_DINOV2.image_size
    pixels = rng.random((1, 1, 2, h, h, 3)).astype(np.float32)
    proprio = rng.random((1, LIBERO.proprio_dim)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (ids, mask, pixels, proprio))


def serve_actions(mesh, device) -> np.ndarray:
    """`predict_action_hidden` and the L1 head on the request, with the tree
    sharded on `mesh` (tp over heads and columns) or, mesh None, whole."""
    from torch.distributed.tensor import DTensor

    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.models.action_heads import l1_head_predict
    from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden
    from openvla_oft_tpu_torch.parallel.sharding import (compute_view, dtensor_context,
                                                         shard_params)

    params = tiny_params(device)
    if mesh is not None:
        params = shard_params(params, mesh)
    ids, mask, pixels, proprio = serving_inputs(device)
    with torch.no_grad(), dtensor_context(params):
        view = compute_view(params)
        hidden = predict_action_hidden(view, tiny_cfg(), LIBERO, ids, mask, pixels,
                                       proprio=proprio, use_flash=False).actions_hidden
        if isinstance(hidden, DTensor):
            hidden = hidden.full_tensor()
        out = l1_head_predict(view["action_head"], hidden.float(), LIBERO)
    return out.cpu().numpy()


def serving_tps(n: int) -> list:
    return [tp for tp in (2, 4) if n % tp == 0]


def child(rank: int, world: int, workdir: str, device_type: str,
          steps: int = TRAJECTORY_STEPS) -> None:
    """One rank: (a), (b) and (c), its results pickled to workdir."""
    import torch.distributed as dist

    from openvla_oft_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(device_type, f"file://{os.path.join(workdir, 'store')}", world, rank,
                     timeout=datetime.timedelta(minutes=5))
    device = torch.device(device_type, torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    t0 = time.perf_counter()

    def done(what):
        print(f"[rank {rank}] {what} at {time.perf_counter() - t0:.1f} s", flush=True)

    try:
        dp, fsdp, tp = mesh_factors(world)
        mesh = make_mesh(dp, fsdp, tp, device_type=device_type)
        b = max(dp * fsdp, 2)
        step = train_losses(mesh, [make_batch(0, b, device)], 1, train_config(), device)
        done("(a)")
        trajectory = train_losses(mesh, [make_batch(s, b, device) for s in range(2)],
                                  steps, train_config(3e-3), device)
        done("(b)")
        served = {t: serve_actions(make_mesh(world // t, 1, t, device_type=device_type), device)
                  for t in serving_tps(world)}
        done("(c)")
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump({"step": step, "trajectory": trajectory, "served": served}, f)
    finally:
        dist.destroy_process_group()


def launch(n: int, workdir: str, device_type: str, steps: int) -> list:
    """The n ranks started (`_ranks.py`), each with its log in workdir."""
    from openvla_oft_tpu_torch.scripts import _ranks

    cmds = [[sys.executable, "-m", "openvla_oft_tpu_torch.scripts.dryrun_multichip", str(n),
             "--child", str(rank), "--workdir", workdir, "--device", device_type,
             "--steps", str(steps)] for rank in range(n)]
    return _ranks.start(cmds, [Path(workdir, f"rank_{rank}.log") for rank in range(n)])


def join(procs, workdir: str, timeout: float) -> list:
    """The ranks' results, each rank joined within `timeout` seconds in all."""
    from openvla_oft_tpu_torch.scripts import _ranks

    _ranks.join(procs, timeout, "ranks")
    out = []
    for rank in range(len(procs)):
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def check_trajectory(sharded: list, single: list) -> float:
    """The largest relative loss gap (each over max(|single|, 1)); raises
    past TRAJECTORY_RTOL or where the last cycle's mean is not under 0.9 of
    the first's (the batches alternate, so cycles are compared)."""
    gaps = [abs(a - c) / max(abs(c), 1.0) for a, c in zip(sharded, single)]
    if not max(gaps) < TRAJECTORY_RTOL:
        raise AssertionError(f"the sharded loss trajectory left the one-process one: max "
                             f"relative gap {max(gaps):.2e}\n sharded={sharded}\n single={single}")
    first, last = np.mean(sharded[:2]), np.mean(sharded[-2:])
    if not last < 0.9 * first:
        raise AssertionError(f"no descent over {len(sharded)} sharded steps: cycle mean "
                             f"{first:.4f} -> {last:.4f}; {sharded}")
    return max(gaps)


def dryrun_multichip(n: int, device_type: str = "cuda", budget_gb=None,
                     timeout: float = 600.0, steps: int = TRAJECTORY_STEPS,
                     state=None) -> dict:
    """(a)-(d) on n ranks (n cards, or with device_type "cpu" n gloo
    processes), (b) over `steps` steps; returns what each part measured.
    `state`: the audit's `flagship_train_state()`, built once by the
    caller."""
    if device_type == "cuda" and torch.cuda.device_count() < n:
        raise SystemExit(f"--device cuda needs {n} visible cards, found "
                         f"{torch.cuda.device_count()}")
    dp, fsdp, tp = mesh_factors(n)
    if not serving_tps(n):
        raise AssertionError(f"the serving check takes no tp at n = {n} (it needs an even "
                             "device count)")
    device = torch.device(device_type)
    b = max(dp * fsdp, 2)
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as workdir:
        procs = launch(n, workdir, device_type, steps)
        try:
            single = train_losses(None, [make_batch(s, b, device) for s in range(2)],
                                  steps, train_config(3e-3), device)
            served_ref = serve_actions(None, device)
        finally:
            ranks = join(procs, workdir, timeout)
    report = {"mesh": (dp, fsdp, tp)}
    for rank, out in enumerate(ranks):
        loss = out["step"][0]
        if not np.isfinite(loss):
            raise AssertionError(f"rank {rank}: non-finite sharded loss {loss}")
        gap = check_trajectory(out["trajectory"], single)
        diffs = {}
        for t, got in out["served"].items():
            diffs[t] = float(np.abs(got - served_ref).max())
            np.testing.assert_allclose(got, served_ref, rtol=SERVING_TOL, atol=SERVING_TOL,
                                       err_msg=f"rank {rank} serving at tp = {t}")
        if rank == 0:
            print(f"(a) sharded LoRA step on mesh dp={dp} fsdp={fsdp} tp={tp}: loss "
                  f"{loss:.4f} OK", flush=True)
            print(f"(b) {steps} steps: sharded == one process (max relative gap "
                  f"{gap:.1e}), loss {out['trajectory'][0]:.4f} -> "
                  f"{out['trajectory'][-1]:.4f} OK", flush=True)
            for t, d in diffs.items():
                print(f"(c) serving tp={t}: predict_action_hidden + L1 head sharded == one "
                      f"process (max |d| = {d:.2e}) OK", flush=True)
            report.update(loss=loss, trajectory=out["trajectory"], single=single,
                          max_gap=gap, serving=diffs)
    report["audit"] = audit_7b_memory(n, budget_gb, state)
    print(f"dryrun_multichip({n}) on {device_type}: mesh dp={dp} fsdp={fsdp} tp={tp} OK",
          flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=4, help="ranks (devices)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: n cards in an NCCL group; cpu: n gloo processes")
    ap.add_argument("--steps", type=int, default=TRAJECTORY_STEPS, help=argparse.SUPPRESS)
    ap.add_argument("--budget_gb", type=float, default=None,
                    help="the audit's memory budget a device, GB (2**30 bytes); default: the "
                         "card's memory")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the ranks may take in all")
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child, args.n, args.workdir, args.device, args.steps)
        return 0
    dryrun_multichip(args.n, args.device, args.budget_gb, args.timeout, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
