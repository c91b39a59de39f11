"""Build the port's hand-written CUDA kernels and load them through ctypes.

Every `csrc/*.cu` file of this package compiles with its own `nvcc`, all of
them at once, and the objects link into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The library lands
in `_build/<hash>/libopenvla_kernels.so`, keyed by a hash of the sources and
flags: a rebuild happens only when they change. There is no fallback: a
missing `nvcc` or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libopenvla_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        nvcc = str(candidate) if candidate.exists() else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "openvla_oft_tpu_torch are built from csrc/ at first use")
    return nvcc


def build() -> Path:
    """Compile csrc/*.cu for sm_90a unless a library for these sources exists.

    Returns the library's path. The compilers' output (with `-Xptxas -v`
    register and shared-memory counts) is kept beside it as `build.log`.
    """
    out_dir = BUILD_DIR / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    # Objects go to a private directory and the library to a temporary name,
    # then a rename: a concurrent build never loads a half-written library.
    obj_dir = Path(tempfile.mkdtemp(dir=out_dir))
    jobs = []
    for src in _sources():
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj_dir / (src.stem + ".o")),
               str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    log, failed = [], False
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        failed |= proc.returncode != 0
    if not failed:
        link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp,
                *map(str, sorted(obj_dir.glob("*.o")))]
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        failed = proc.returncode != 0
    (out_dir / "build.log").write_text("".join(log))
    shutil.rmtree(obj_dir, ignore_errors=True)
    if failed:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + "".join(log))
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with argtypes declared for every entry."""
    lib = ctypes.CDLL(str(build()))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.openvla_flash_attention_fwd
    fn.argtypes = [p, p, p, p, p, p, p,          # q k v key_valid bidir o lse
                   i, i, i, i, i,                # B S H Hkv D
                   i64, i64, i64,                # q strides (b, s, h)
                   i64, i64, i64,                # k strides
                   i64, i64, i64,                # v strides
                   i, ctypes.c_float, p]         # causal scale stream
    fn.restype = ctypes.c_int
    strides = [i64] * 12                         # q, k, v, dO strides (b, s, h)
    fn = lib.openvla_flash_attention_bwd_dq      # q k v o lse dO valid bidir dq stats
    fn.argtypes = [p] * 10 + [i] * 6 + strides + [i, ctypes.c_float, p]
    fn.restype = ctypes.c_int                    # B S H Hkv D s_pad ... causal scale
    fn = lib.openvla_flash_attention_bwd_dkv     # q k v stats dO valid bidir dk dv, then as K2
    fn.argtypes = [p] * 9 + [i] * 6 + strides + [i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    fn = lib.openvla_flash_attention_bwd_stats   # o lse dO stats B S H D s_pad dO strides
    fn.argtypes = [p] * 4 + [i] * 5 + [i64] * 3 + [p]
    fn.restype = ctypes.c_int
    fn = lib.openvla_int4_matmul_w4a16           # K5: x packed scales out work counters
    fn.argtypes = [p] * 6 + [i] * 4 + [i64, i64, i, i, p]   # T K N group ldp lds t_tile splits
    fn.restype = ctypes.c_int
    fn = lib.openvla_int4_matmul_w4a8            # K6: x8 sx packed scales out work counters
    fn.argtypes = [p] * 7 + [i] * 4 + [i64, i64, i, i, p]   # T K N group ldp lds t_tile splits
    fn.restype = ctypes.c_int
    fn = lib.openvla_ln_matmul                   # K4: x w b out M D N ldx ldw act eps bm bn
    fn.argtypes = [p] * 4 + [i] * 3 + [i64, i64, i, ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    fn = lib.openvla_int4_probe                  # K5 probe: as K5, then mode
    fn.argtypes = [p] * 6 + [i] * 4 + [i64, i64, i, i, i, p]
    fn.restype = ctypes.c_int
    lib.openvla_cuda_error_string.argtypes = [ctypes.c_int]
    lib.openvla_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise on the cudaError_t that a launch entry of the library returned
    (a negative code: minus the CUresult of the tensor-map encoder)."""
    if err < 0:
        raise RuntimeError(f"{what} kernel launch failed: the tensor-map encoder "
                           f"(cuTensorMapEncodeTiled) returned CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{library().openvla_cuda_error_string(err).decode()} ({err})")
