"""Device mesh and process group for data/fsdp/tensor parallel execution.

Port of `openvla_oft_tpu/parallel/mesh.py`. The axes are the JAX package's,
in mesh order ("dp", "fsdp", "tp"): batches shard over ("dp", "fsdp"),
parameters over ("fsdp", "tp") (`parallel/sharding.py`). JAX drives every
local device from one process; here every rank is one process with one
device, started by `torchrun --nproc-per-node N` (or by hand with
`init_distributed(coordinator_address, num_processes, process_id)`), and a
mesh is a `torch.distributed.device_mesh.DeviceMesh` over the process group.
The collectives are NCCL's on CUDA and gloo's on the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")
DATA_AXES = ("dp", "fsdp")

_TORCHRUN = ("start one process per rank: torchrun --nproc-per-node N -m <module> ... "
             "with N the product of the mesh")


def backend_for(device_type: str) -> str:
    """NCCL on CUDA, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def init_distributed(device_type: str = "cuda", coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: datetime.timedelta = datetime.timedelta(minutes=10)) -> None:
    """The process group of a multi-process run (JAX `vla_scripts/finetune.py`
    :161-175's `jax.distributed.initialize`). With `coordinator_address`
    ("host:port", or a `file://` or `tcp://` URL) it takes `num_processes`
    and `process_id`; without, torchrun's environment (`env://`: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT). A group already up is kept. On
    CUDA the rank's device is `LOCAL_RANK` (else the rank) modulo the
    visible devices."""
    if dist.is_initialized():
        return
    backend = backend or backend_for(device_type)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id, timeout=timeout)
    else:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("no process group: " + _TORCHRUN +
                               ", or pass coordinator_address, num_processes and "
                               "process_id")
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, device_type: str = "cuda"):
    """A ("dp", "fsdp", "tp") DeviceMesh over the process group. A product
    other than the world size raises, as JAX's `make_mesh` does for too few
    devices; with no process group it raises and names torchrun (a run
    without a mesh passes plain tensors and needs none)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dp * fsdp * tp
    if min(dp, fsdp, tp) < 1:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp}: every axis needs at least 1 rank")
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {dp}x{fsdp}x{tp} needs {n} processes and there "
                           f"is no process group: " + _TORCHRUN)
    if n != dist.get_world_size():
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} needs {n} ranks, the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, (dp, fsdp, tp), mesh_dim_names=AXES)


def mesh_shape(mesh) -> dict:
    """{"dp": n, "fsdp": n, "tp": n} of a mesh (1 for an axis it lacks)."""
    names = mesh.mesh_dim_names or ()
    return {ax: (mesh.size(names.index(ax)) if ax in names else 1) for ax in AXES}
