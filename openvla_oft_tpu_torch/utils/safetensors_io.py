"""safetensors files read and written without the `safetensors` package.

The format: an 8-byte little-endian header length n, then n bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, and an optional
"__metadata__" of str -> str}), then the raw little-endian bytes, offsets
counted from the end of the header. A sharded checkpoint adds
`model.safetensors.index.json`, whose "weight_map" names each tensor's
shard.

`SafetensorsIndex` maps the bytes of one tensor at a time from its file and
returns a `torch.Tensor` in the stored dtype; the mapping lives as long as
that tensor, so a loader that copies each tensor into its destination and
drops it holds one tensor's pages at a time. `save_file` writes tensors (on
any device, in any layout) one at a time.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

INDEX_FILE = "model.safetensors.index.json"

DTYPES: Dict[str, torch.dtype] = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16,
    "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def read_header(path: str) -> Tuple[dict, int]:
    """(header, byte offset of the data) of one safetensors file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > os.path.getsize(path) - 8:
            raise ValueError(f"{path}: header length {n} runs past the end of the file")
        header = json.loads(f.read(n))
    return header, 8 + n


class SafetensorsIndex:
    """Lazy reader over one `.safetensors` file or a checkpoint directory
    (its index's shards, else every `*.safetensors` in it, sorted).

    `index(name)` returns the tensor in its stored dtype on the CPU, backed
    by a copy-on-write mapping of its bytes; KeyError for an unknown name.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            index = os.path.join(path, INDEX_FILE)
            if os.path.exists(index):
                with open(index) as f:
                    weight_map = json.load(f)["weight_map"]
                files = [os.path.join(path, s) for s in sorted(set(weight_map.values()))]
            else:
                files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        else:
            files = [path]
        if not files:
            raise FileNotFoundError(f"no *.safetensors in {path}")
        self.files = files
        self.metadata: Dict[str, str] = {}
        # name -> (file, dtype name, shape, absolute begin, absolute end)
        self._entries: Dict[str, Tuple[str, str, Tuple[int, ...], int, int]] = {}
        for file in files:
            header, start = read_header(file)
            self.metadata.update(header.pop("__metadata__", None) or {})
            size = os.path.getsize(file)
            for name, info in header.items():
                if info["dtype"] not in DTYPES:
                    raise ValueError(f"{file}: {name} has dtype {info['dtype']}, which "
                                     f"this reader does not take ({sorted(DTYPES)})")
                begin, end = info["data_offsets"]
                shape = tuple(int(s) for s in info["shape"])
                if end - begin != _nbytes(shape, DTYPES[info["dtype"]]) \
                        or start + end > size:
                    raise ValueError(f"{file}: {name} has data_offsets {begin, end} "
                                     f"for {info['dtype']} {list(shape)}")
                if name in self._entries:
                    raise ValueError(f"{name} is in two shards: {self._entries[name][0]} "
                                     f"and {file}")
                self._entries[name] = (file, info["dtype"], shape, start + begin, start + end)

    def keys(self) -> Iterable[str]:
        return self._entries.keys()

    def dtype(self, name: str) -> torch.dtype:
        return DTYPES[self._entries[name][1]]

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._entries[name][2]

    @property
    def nbytes(self) -> int:
        return sum(e[4] - e[3] for e in self._entries.values())

    def __call__(self, name: str) -> torch.Tensor:
        if name not in self._entries:
            raise KeyError(name)
        file, dtype_name, shape, begin, end = self._entries[name]
        dtype = DTYPES[dtype_name]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        raw = torch.from_numpy(np.memmap(file, dtype=np.uint8, mode="c", offset=begin,
                                         shape=(end - begin,)))
        if raw.data_ptr() % _itemsize(dtype):
            raw = raw.clone()            # an unaligned tensor: copy to aligned memory
        return raw.view(dtype).reshape(shape)


def _host_bytes(t) -> np.ndarray:
    """One tensor's bytes as a uint8 numpy array (row-major, on the host)."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    t = t.detach().contiguous().cpu().reshape(-1)
    return t.view(torch.uint8).numpy() if t.dtype != torch.uint8 else t.numpy()


def _dtype_of(t) -> torch.dtype:
    return torch.from_numpy(np.empty(0, t.dtype)).dtype if isinstance(t, np.ndarray) \
        else t.dtype


def _nbytes(shape, dtype: torch.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * _itemsize(dtype)


def save_file(tensors: Mapping[str, "torch.Tensor | np.ndarray"], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> str:
    """Write `tensors` as one safetensors file, largest dtypes first (so
    every tensor starts aligned), the header padded to 8 bytes. Each tensor
    is made contiguous and copied to the host one at a time. The file
    appears under its name only once complete."""
    order = sorted(tensors, key=lambda k: (-_itemsize(_dtype_of(tensors[k])), k))
    header: Dict[str, dict] = {}
    offset = 0
    for name in order:
        t = tensors[name]
        dtype = _dtype_of(t)
        if dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {dtype} has no safetensors name")
        n = _nbytes(t.shape, dtype)
        header[name] = {"dtype": _NAMES[dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header = {"__metadata__": {str(k): str(v) for k, v in metadata.items()}, **header}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            f.write(_host_bytes(tensors[name]))
    os.replace(tmp, path)
    return path


def save_sharded(tensors: Mapping[str, "torch.Tensor | np.ndarray"], out_dir: str,
                 max_shard_bytes: int) -> list:
    """Write `tensors` in name order as `model-0000i-of-0000n.safetensors`
    shards of at most `max_shard_bytes` (a larger tensor gets a shard of
    its own) and `model.safetensors.index.json`, as HF's sharded save
    names them. Returns the shard paths."""
    shards, size = [[]], 0
    for name in sorted(tensors):
        t = tensors[name]
        n = _nbytes(t.shape, _dtype_of(t))
        if shards[-1] and size + n > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += n
    paths, weight_map = [], {}
    for i, names in enumerate(shards):
        file = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        paths.append(save_file({k: tensors[k] for k in names}, os.path.join(out_dir, file)))
        weight_map.update({k: file for k in names})
    total = sum(os.path.getsize(p) for p in paths)
    with open(os.path.join(out_dir, INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return paths
