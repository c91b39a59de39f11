"""Path-based parameter sharding rules, as DTensor placements.

Port of `openvla_oft_tpu/parallel/sharding.py`. The same rules match a
"/"-joined param path and give a spec for the trailing dims: the mesh axis
("fsdp", "tp" or None) each dim shards over. A dim the axis does not divide
is replicated (`_fit_spec`), so the same rules serve the 7B and the tiny
test configs; leading (stacked-layer) dims replicate. Where JAX's GSPMD
turns a spec into a NamedSharding and inserts the collectives, here it
becomes one placement per mesh dim ("dp", "fsdp", "tp"): `Shard(d)` where
the spec puts that axis on dim d, else `Replicate()`, and DTensor's
sharding propagation inserts the collectives.

Megatron-style layout: column-parallel into attention and the MLP (the
contracting dim on "fsdp", the output on "tp"), row-parallel out of them.

A quantized linear shards like its float kernel (int8 `kernel`, packed
`kernel_q4`; their scales stay replicated), except where a tp rank's block
would be one its kernels cannot take (`quant_block_fits`): such a leaf is
kept whole over tp, a departure from the JAX rules, and each rank runs the
whole product (`ops/layers.py::_linear_tp`).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from openvla_oft_tpu_torch.bridge import tree_leaves

Params = Dict[str, Any]

# (path regex, spec of the trailing dims). First match wins.
_RULES = [
    (r"layers/attn/(wq|wk|wv)/kernel$", ("fsdp", "tp")),
    # serving-fused layouts (models/llama.py::fuse_inference_weights)
    (r"layers/attn/wqkv/kernel$", ("fsdp", "tp")),
    (r"layers/mlp/gate_up/kernel$", ("fsdp", "tp")),
    (r"layers/attn/wo/kernel$", ("tp", "fsdp")),
    (r"layers/attn/qkv/kernel$", ("fsdp", "tp")),
    (r"layers/attn/proj/kernel$", ("tp", "fsdp")),
    (r"layers/mlp/(gate|up|fc1)/kernel$", ("fsdp", "tp")),
    (r"layers/mlp/(down|fc2)/kernel$", ("tp", "fsdp")),
    (r"embed/embedding$", ("fsdp", "tp")),
    (r"lm_head/kernel$", ("fsdp", "tp")),
    (r"projector/fc1/kernel$", ("fsdp", "tp")),
    (r"projector/fc2/kernel$", ("tp", "fsdp")),
    (r"projector/fc3/kernel$", ("fsdp", "tp")),
    # The action head's trunk: fsdp only (ReLU, LayerNorm and residuals sit
    # between its square products, so no column/row pairing holds).
    (r"fc_in/kernel$", ("fsdp", None)),
    (r"blocks/\d+/fc/kernel$", ("fsdp", None)),
    (r"fc_out/kernel$", ("fsdp", None)),
    # LoRA factors follow the base layer's output axis; A is rank-major
    # (r, in) (training/lora.py::init_lora).
    (r"lora/.*/(wq|wk|wv|gate|up|fc1|qkv)/a$", (None, "fsdp")),
    (r"lora/.*/(wq|wk|wv|gate|up|fc1|qkv)/b$", (None, "tp")),
    (r"lora/.*/(wo|down|fc2|proj)/a$", (None, "tp")),
    (r"lora/.*/(wo|down|fc2|proj)/b$", (None, "fsdp")),
]


def _fit_spec(spec_tail, shape, mesh_shape: dict) -> tuple:
    """The rule's trailing-dim spec fitted to the leaf's rank; a dim its
    axis does not divide (or an axis of size 1) becomes None."""
    ndim, tail = len(shape), len(spec_tail)
    full = [None] * (ndim - tail) + list(spec_tail) if ndim >= tail \
        else list(spec_tail)[-ndim:]
    return tuple(ax if ax is not None and mesh_shape.get(ax, 1) > 1
                 and dim % mesh_shape[ax] == 0 else None
                 for dim, ax in zip(shape, full))


def _spec_of(path: str, shape, mesh_shape: dict) -> tuple:
    # Packed-int4 kernels ("kernel_q4", (.., in/2, out)) shard like the kernel
    # they replace; their group scales stay replicated, as int8's scale_w.
    path = re.sub(r"kernel_q4$", "kernel", path)
    for pattern, spec in _RULES:
        if re.search(pattern, path):
            return _fit_spec(spec, shape, mesh_shape)
    return (None,) * len(shape)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def placements_of(spec: tuple, axes=("dp", "fsdp", "tp")) -> list:
    """One placement per mesh dim: Shard(d) where `spec` puts that axis on
    dim d, else Replicate()."""
    return [Shard(spec.index(ax)) if ax in spec else Replicate() for ax in axes]


def quant_block_fits(node: dict, spec: tuple, mesh_shape: dict) -> bool:
    """Whether each tp rank's block of the quantized weight in `node` (its
    rule's fitted `spec`) is one the quantized kernels take. A packed int4
    leaf split by rows must keep whole scale groups: its group scales stay
    replicated, and K5 and K6 read a rank's rows against its own scale
    rows. An int8 kernel's block must keep K and N multiples of 8, which
    CUDA `torch._int_mm` needs (SigLIP's 4,304-wide MLP at tp = 4). A
    column split of a packed leaf, and a split over fsdp (gathered before
    the product), always fit."""
    tp = mesh_shape.get("tp", 1)
    if "tp" not in spec[-2:]:
        return True
    rows = spec[-2] == "tp"
    if "kernel_q4" in node:
        return not rows or node["scale_w4"].shape[-2] % tp == 0
    k, n = node["kernel"].shape[-2:]
    k, n = (k // tp, n) if rows else (k, n // tp)
    return k % 8 == 0 and n % 8 == 0


def _quantized_kernel(node: dict) -> Optional[str]:
    if "kernel_q4" in node:
        return "kernel_q4"
    k = node.get("kernel")
    return "kernel" if torch.is_tensor(k) and k.dtype == torch.int8 else None


def _map_specs(fn, params: Params, mesh_shape: dict, kept: Optional[list] = None) -> Params:
    """fn(path, leaf, spec) over every leaf of `params`, spec its rule's
    (`_spec_of`), where a quantized weight whose tp block does not fit
    (`quant_block_fits`) keeps its tp axis whole (its path appended to
    `kept`)."""
    def walk(node, path):
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),)) for i, v in enumerate(node))
        if not isinstance(node, dict):
            p = "/".join(path)
            return fn(p, node, _spec_of(p, tuple(node.shape), mesh_shape))
        name = _quantized_kernel(node)
        out = {}
        for k, v in node.items():
            if k != name:
                out[k] = walk(v, path + (str(k),))
                continue
            p = "/".join(path + (k,))
            spec = _spec_of(p, tuple(v.shape), mesh_shape)
            if not quant_block_fits(node, spec, mesh_shape):
                spec = tuple(None if ax == "tp" else ax for ax in spec)
                if kept is not None:
                    kept.append(p)
            out[k] = fn(p, v, spec)
        return out

    return walk(params, ())


def kept_whole(params: Params, mesh_shape: dict) -> list:
    """The paths of the quantized weights that `_map_specs` keeps whole
    over tp where the JAX rules split them."""
    kept = []
    _map_specs(lambda p, leaf, spec: None, params, mesh_shape, kept)
    return kept


def param_placements(params: Params, mesh_shape: dict) -> Params:
    """The placements of every leaf of `params` on a ("dp", "fsdp", "tp")
    mesh of `mesh_shape`. A pure function of shapes and sizes: no process
    group is needed."""
    return _map_specs(lambda p, leaf, spec: placements_of(spec), params, mesh_shape)


def _local_slice(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(i)
            size = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, coord[i] * size, size)
    return t


def distribute(t: torch.Tensor, mesh, placements):
    """A DTensor of `t`, which every rank holds whole and alike, made of each
    rank's own slice (no communication: the analog of JAX's `put_global`).
    A leaf that shards keeps its slice alone (a copy); `requires_grad` is
    kept."""
    local = _local_slice(t.detach(), mesh, placements)
    if any(pl.is_shard() for pl in placements):
        local = _own_copy(local)
    out = DTensor.from_local(local, mesh, placements, run_check=False)
    return out.requires_grad_(t.requires_grad) if t.is_floating_point() else out


def _own_copy(t: torch.Tensor) -> torch.Tensor:
    """A slice copied into its own storage, in its layout: an int8 W8A8
    kernel's column-major (`ops/quant.py::empty_int8_kernel`) stays so."""
    if t.ndim >= 2 and t.stride(-2) == 1 and t.stride(-1) != 1:
        return t.transpose(-1, -2).clone(memory_format=torch.contiguous_format
                                         ).transpose(-1, -2)
    return t.clone(memory_format=torch.contiguous_format)


def shard_params(params: Params, mesh) -> Params:
    """`params` as DTensors under the rules on `mesh` (each rank keeps its
    slices). Leaves that are already DTensors are returned as they are. The
    quantized weights kept whole over tp (`kept_whole`) are logged and
    left in `shard_params.kept_whole`."""
    import torch.distributed as dist

    from openvla_oft_tpu_torch.parallel.mesh import mesh_shape

    shape = mesh_shape(mesh)
    shard_params.kept_whole = []

    def put(path, leaf, spec):
        if isinstance(leaf, DTensor):
            return leaf
        return distribute(leaf, mesh, placements_of(spec, mesh.mesh_dim_names))

    out = _map_specs(put, params, shape, shard_params.kept_whole)
    if shard_params.kept_whole and (not dist.is_initialized() or dist.get_rank() == 0):
        print(f"[sharding] kept whole over tp = {shape['tp']} (a rank's block would cut "
              f"int4 scale groups, or give an int8 product a K or N that is not a multiple "
              f"of 8; its input is gathered and each rank runs the whole product): "
              + ", ".join(shard_params.kept_whole), flush=True)
    return out


shard_params.kept_whole = []


def gather_params(params: Params, to_host: bool = False) -> Params:
    """Every DTensor leaf as its full tensor (a collective: every rank calls
    it), plain tensors as they are; for saves and exports. `to_host`: rank 0
    moves each leaf to the host as soon as it is gathered, so that a whole
    tree (a full-parameter run's weights and moments) never sits on a card,
    and the other ranks keep None."""
    import torch.distributed as dist

    keep = not to_host or not dist.is_initialized() or dist.get_rank() == 0

    def full(_, leaf):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor().detach()
        if not torch.is_tensor(leaf) or not to_host:
            return leaf
        return leaf.cpu() if keep else None

    return _map_with_path(full, params)


# ---------------------------------------------------------------------------
# The compute form. The model's code runs on each rank's own batch rows with
# plain tensors; tensor parallelism alone rides on DTensors, over the 1-D tp
# mesh. A sharded parameter enters the compute one layer (one leaf) at a
# time: gathered over fsdp (FSDP's just-in-time all-gather; the gradient goes
# back by reduce-scatter), taken local over the data axes with its gradient
# marked a partial sum there (each rank's rows give a part of it), and kept
# sharded over tp. Nothing is gathered over tp.
# ---------------------------------------------------------------------------

def compute_leaf(t):
    """One leaf in its compute form: a DTensor over the tp mesh where the
    leaf shards over tp, else a plain tensor. A replicated leaf's gradient
    is then whole on every tp rank; `ops/layers.py::_linear_tp` marks the
    partial ones. Plain tensors pass unchanged."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    gathered = [pl if ax == "tp" else Replicate() for ax, pl in zip(names, t.placements)]
    if gathered != list(t.placements):
        t = t.redistribute(mesh, gathered)
    grad = [pl if ax == "tp" else Partial() for ax, pl in zip(names, gathered)]
    local = t.to_local(grad_placements=grad) if t.requires_grad else t.to_local()
    if "tp" not in names or not gathered[names.index("tp")].is_shard():
        return local
    return DTensor.from_local(local, _tp_mesh(mesh), [gathered[names.index("tp")]],
                              run_check=False)


def layer_params(tree: Params, i: int) -> Params:
    """Layer i of a stacked (L, ...) param tree in its compute form: every
    leaf's slice (`bridge.index_layer`'s view) through `compute_leaf`. The
    models walk their layers through it, so that a sharded tree is gathered
    over fsdp one layer at a time; a plain tree's leaves stay views."""
    return {name: layer_params(v, i) if isinstance(v, dict) else compute_leaf(v[i])
            for name, v in tree.items()}


def _tp_mesh(mesh):
    """The tp sub-mesh of `mesh`, kept on the mesh: every layer's leaves ask
    for it, and slicing a DeviceMesh takes about 0.2 ms."""
    sub = getattr(mesh, "_tp_submesh", None)
    if sub is None:
        sub = mesh._tp_submesh = mesh["tp"]
    return sub


def compute_view(params: Params) -> Params:
    """`params` with every leaf outside a stacked layer tree in its compute
    form. Leaves under a "layers" key stay as they are: `layer_params`
    takes one layer's slice and then its compute form, so that fsdp gathers
    one layer at a time. A tree without DTensors comes back as it is."""
    def view(path, leaf):
        return leaf if "layers" in path.split("/") else compute_leaf(leaf)

    return _map_with_path(view, params)


def replicate(x):
    """A DTensor activation on a 1-D (tp) mesh as the plain tensor every
    rank holds: the all-gather of a Shard, the all-reduce of a Partial,
    through c10d's collectives on the mesh's group (DTensor's functional
    all-gather crashes a gloo group on CUDA tensors, which the one-card tp
    run uses); a plain tensor as it is. Differentiable: the gradient of a
    gathered shard is its slice of the output's, that of a partial sum the
    output's. `replicate.counts` counts the collectives and the bytes of
    their outputs ("all_gather", "all_reduce", "*_bytes")."""
    if not isinstance(x, DTensor):
        return x
    (pl,) = x.placements
    group = x.device_mesh.get_group()
    if pl.is_shard():
        out = _GatherShards.apply(x.to_local(), pl.dim, group)
        kind = "all_gather"
    elif pl.is_partial():
        out = _SumPartials.apply(x.to_local(), group)
        kind = "all_reduce"
    else:
        return x.to_local()
    replicate.counts[kind] += 1
    replicate.counts[kind + "_bytes"] += out.nbytes
    return out


replicate.counts = {"all_gather": 0, "all_gather_bytes": 0, "all_reduce": 0,
                    "all_reduce_bytes": 0}


def like_replicated(tensors, like):
    """`tensors` as DTensors replicated on `like`'s (tp) mesh where `like` is
    a DTensor, else as they are: the q, k and v split from a gathered fused
    projection, so that attention still takes each rank's own heads."""
    if not isinstance(like, DTensor):
        return tuple(tensors)
    return tuple(DTensor.from_local(t, like.device_mesh, [Replicate()], run_check=False)
                 for t in tensors)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The all-reduce of `t` over `group` through c10d, counted in
    `replicate.counts`: "sum" (differentiable: the output's gradient goes to
    every rank's part as it is) or "max" (of a tensor that takes no
    gradient: a per-token absmax)."""
    import torch.distributed as dist

    if op == "sum":
        out = _SumPartials.apply(t, group)
    elif op == "max":
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    else:
        raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
    replicate.counts["all_reduce"] += 1
    replicate.counts["all_reduce_bytes"] += out.nbytes
    return out


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, dim, group):
        import torch.distributed as dist

        n = dist.get_world_size(group)
        ctx.dim, ctx.n, ctx.rank = dim, n, dist.get_rank(group)
        front = local.movedim(dim, 0).contiguous()
        out = torch.empty((n * front.shape[0],) + tuple(front.shape[1:]), dtype=front.dtype,
                          device=front.device)
        dist.all_gather_into_tensor(out, front, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        k = g.shape[ctx.dim] // ctx.n
        return g.narrow(ctx.dim, ctx.rank * k, k), None, None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group):
        import torch.distributed as dist

        out = local.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def has_dtensor(tree) -> bool:
    return any(isinstance(t, DTensor) for t in tree_leaves(tree))


def dtensor_context(tree):
    """The context a compute over `tree` runs in: where the tree holds
    DTensors, plain tensors made inside the model (masks, positions, RoPE
    tables) count as replicated when they meet a tp DTensor
    (`implicit_replication`); else nothing."""
    import contextlib

    if not has_dtensor(tree):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def copy_into(dst, src: torch.Tensor) -> None:
    """Copy the whole tensor `src` into `dst`: a DTensor takes its own slice
    (a resume re-sharding a single-file checkpoint), a plain tensor all."""
    if isinstance(dst, DTensor):
        dst.to_local().copy_(_local_slice(src, dst.device_mesh, dst.placements))
    else:
        dst.copy_(src)
