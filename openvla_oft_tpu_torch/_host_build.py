"""Build the port's host (CPU) library and load it through ctypes.

`hostsrc/*.cc` (the JPEG decoder and encoder, the frame augmentation and the
CRC-32C of the training data path, and the collator's and the action
tokenizer's loops) compile with the host's C++ compiler
(`$CXX`, else `g++`) into ONE shared library with a plain C interface,
`_build/host-<hash>/libopenvla_host.so`, keyed by a hash of the sources and
flags: a rebuild happens only when they change. There is no fallback: a
missing compiler or a failed build raises with the compiler's output.
ctypes releases the GIL around every call, so threads decode and augment
in parallel.
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
HOST_SRC_DIR = PKG_DIR / "hostsrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libopenvla_host.so"
# -ffp-contract=off: no fused multiply-adds, so the float32 augmentation
# rounds where its numpy plain version does.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-ffp-contract=off")


def sources() -> list:
    return sorted(HOST_SRC_DIR.glob("*.cc"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx or shutil.which(cxx) is None:
        raise RuntimeError(
            "no C++ compiler ($CXX or g++ on PATH): the host library of "
            "openvla_oft_tpu_torch (hostsrc/*.cc) is built at first use")
    return cxx


def build() -> Path:
    """Compile hostsrc/*.cc unless a library for these sources exists.
    Returns the library's path; the compiler's output is kept beside it as
    `build.log`."""
    out_dir = BUILD_DIR / f"host-{_source_hash()}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # A temporary name, then a rename: a concurrent build never loads a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_find_cxx(), *CXX_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded host library, with argtypes declared for every entry."""
    lib = ctypes.CDLL(str(build()))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.openvla_jpeg_info                   # data n height width err err_len
    fn.argtypes = [p, i64, ctypes.POINTER(i), ctypes.POINTER(i), ctypes.c_char_p, i]
    fn.restype = i
    fn = lib.openvla_jpeg_decode                 # data n out out_len islow err err_len
    fn.argtypes = [p, i64, p, i64, i, ctypes.c_char_p, i]
    fn.restype = i
    fn = lib.openvla_jpeg_encode_bound           # height width
    fn.argtypes = [i, i]
    fn.restype = i64
    fn = lib.openvla_jpeg_encode                 # frame h w channels quality out cap n err err_len
    fn.argtypes = [p, i, i, i, i, p, i64, ctypes.POINTER(i64), ctypes.c_char_p, i]
    fn.restype = i
    f = ctypes.c_float
    fn = lib.openvla_augment_image               # img h w oy ox ch cw, 4 draws,
    fn.argtypes = [p, i, i, i, i, i, i, f, f, f, f,   # column spans, row spans, out
                   p, p, i, p, p, i, p]
    fn.restype = i
    fn = lib.openvla_crc32c                      # data n crc
    fn.argtypes = [p, i64, ctypes.c_uint32]
    fn.restype = ctypes.c_uint32
    fn = lib.openvla_pad_stack_i32               # flat lengths n target fill out
    fn.argtypes = [p, p, i, i, ctypes.c_int32, p]
    fn.restype = i
    fn = lib.openvla_attention_mask_i32          # lengths n target out
    fn.argtypes = [p, i, i, p]
    fn.restype = None
    fn = lib.openvla_encode_actions_i32          # actions n bins min max vocab out
    fn.argtypes = [p, i64, i, f, f, i, p]
    fn.restype = None
    fn = lib.openvla_decode_actions_f32          # ids n bins min max vocab out
    fn.argtypes = [p, i64, i, f, f, i, p]
    fn.restype = None
    fn = lib.openvla_normalize_image_f32         # img pixels mean std out
    fn.argtypes = [p, i64, p, p, p]
    fn.restype = None
    return lib
