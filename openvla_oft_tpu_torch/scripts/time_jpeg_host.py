"""Time the host library's JPEG decoder and encoder on 256 x 256 frames of
the synthetic episode set (`make_synthetic_rlds.task_image`, encoded at
quality 90 by `processing/jpeg_encode.py::encode_jpeg`), one thread, host
clock.

Each `--decoder_src` (default: the package's `hostsrc/jpeg_decode.cc`) is
compiled alone with `_host_build.py`'s compiler and flags and timed with
ISLOW (PIL's pixels) and IFAST (TF's); the sources take turns within every
repeat, so two versions of the decoder are compared on the same host in one
run, and their pixels must agree bitwise. Prints one JSON object.

    python -m openvla_oft_tpu_torch.scripts.time_jpeg_host \\
        [--decoder_src OLD/jpeg_decode.cc --decoder_src NEW/jpeg_decode.cc] \\
        [--frames 32] [--repeats 7]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import platform
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from openvla_oft_tpu_torch import _host_build


def synthetic_frames(n: int, size: int = 256, seed: int = 0) -> list:
    """`n` frames as make_synthetic_rlds draws them (task k = i % 8, step i
    of 64), each PIL's JPEG bytes at quality 90."""
    from openvla_oft_tpu_torch.processing.jpeg_encode import encode_jpeg
    from openvla_oft_tpu_torch.scripts.make_synthetic_rlds import task_image

    rng = np.random.default_rng(seed)
    return [encode_jpeg(task_image(rng, i % 8, i % 64, 64, size, 8), 90) for i in range(n)]


def load_decoder(src: Path, out_dir: Path) -> ctypes.CDLL:
    """One `jpeg_decode.cc` compiled alone into `out_dir`."""
    lib = out_dir / f"dec{len(list(out_dir.iterdir()))}.so"
    cmd = [_host_build._find_cxx(), *_host_build.CXX_FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    dll.openvla_jpeg_decode.argtypes = [p, i64, p, i64, i, ctypes.c_char_p, i]
    dll.openvla_jpeg_decode.restype = i
    return dll


def decode_all(dll, frames: list, islow: bool, outs: np.ndarray) -> float:
    """Seconds to decode every frame into `outs` (frames, 256, 256, 3)."""
    err = ctypes.create_string_buffer(256)
    t0 = time.perf_counter()
    for data, out in zip(frames, outs):
        if dll.openvla_jpeg_decode(data, len(data), out.ctypes.data, out.size, int(islow),
                                   err, 256) != 0:
            raise RuntimeError(err.value.decode())
    return time.perf_counter() - t0


def host_line() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next(line.split(":", 1)[1].strip() for line in f if line.startswith("model name"))
    except (OSError, StopIteration):
        cpu = platform.machine() or "unknown CPU"
    cpu += f", {os.cpu_count()} CPUs"
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        card = "no card"
    return f"{cpu} ({card})"


def run(sources: List[Path], n_frames: int = 32, repeats: int = 7) -> dict:
    from openvla_oft_tpu_torch.processing.jpeg_encode import encode_jpeg
    from openvla_oft_tpu_torch.scripts.make_synthetic_rlds import task_image

    frames = synthetic_frames(n_frames)
    rng = np.random.default_rng(1)
    pixels = [task_image(rng, i % 8, i % 64, 64, 256, 8) for i in range(n_frames)]
    encode_jpeg(pixels[0], 90)                                     # builds the library
    enc = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for img in pixels:
            encode_jpeg(img, 90)
        enc.append((time.perf_counter() - t0) * 1e3 / n_frames)
    result = {"host": host_line(), "frames": n_frames, "repeats": repeats,
              "bytes_a_frame": float(np.mean([len(f) for f in frames])),
              "encode_ms": {"median": float(np.median(enc)), "min": float(np.min(enc))},
              "decoders": []}
    with tempfile.TemporaryDirectory() as tmp:
        dlls = [load_decoder(src, Path(tmp)) for src in sources]
        for islow in (True, False):
            times = [[] for _ in dlls]
            outs = np.zeros((len(dlls), n_frames, 256, 256, 3), np.uint8)
            for k, dll in enumerate(dlls):                         # warm-up
                decode_all(dll, frames, islow, outs[k])
            for k in range(1, len(dlls)):
                if not np.array_equal(outs[k], outs[0]):
                    raise AssertionError(f"{sources[k]} and {sources[0]} decode differently")
            for _ in range(repeats):
                for k, dll in enumerate(dlls):
                    times[k].append(decode_all(dll, frames, islow, outs[k]) * 1e3 / n_frames)
            for k, src in enumerate(sources):
                result["decoders"].append({
                    "src": str(src), "idct": "islow" if islow else "ifast",
                    "ms_median": float(np.median(times[k])), "ms_min": float(np.min(times[k])),
                    "ms_each_repeat": [float(t) for t in times[k]]})
    return result


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--decoder_src", action="append", type=Path)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=7)
    a = ap.parse_args(argv)
    sources = a.decoder_src or [_host_build.HOST_SRC_DIR / "jpeg_decode.cc"]
    out = run(sources, a.frames, a.repeats)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
