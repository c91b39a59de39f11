"""Why K2's and K3's entries make the operands' device current before they
encode their tensor maps (`csrc/hopper_ptx.cuh::bind_device_of`).

The CUDA driver keeps a current context per host thread, and a thread that
has made no runtime call that needs one holds none. This script shows, on
the card:

  encoder     cuTensorMapEncodeTiled, called as K2 and K3 call it (a 4-D bf16
              map, 64 x 1 x 64 x 1 boxes, the 128-byte swizzle), on the main
              thread, on a new host thread that has run nothing, and on that
              thread again after the device's primary context was made
              current: the context each saw and the CUresult each got.
  autograd    in `--runs` fresh processes, the first backward of the flash
              attention op (the shape of the card tests' GQA case), with the
              context current on autograd's device thread at the start of the
              op's backward, just before K2's entry and just after it.
  entry       K2's entry called on a new host thread that has run nothing:
              its return code and the thread's context after it.

Run it from the repo's root on a machine with a CUDA card and nvcc:

    python -m openvla_oft_tpu_torch.scripts.exp_tmap_context [--runs 6]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import threading

import torch

# cuda.h's enums for the map that K2 and K3 encode.
BF16, INTERLEAVE_NONE, SWIZZLE_128B, L2_256B, OOB_NONE = 9, 0, 3, 3, 0
GQA_CASE = (2, 300, 8, 2, 128)   # B, S, H, Hkv, D


def _driver():
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuInit(0)
    return cu


def current_context(cu) -> int:
    """This thread's current context handle (0: none)."""
    ctx = ctypes.c_void_p()
    cu.cuCtxGetCurrent(ctypes.byref(ctx))
    return ctx.value or 0


def encode(cu, t: torch.Tensor) -> int:
    """The CUresult of cuTensorMapEncodeTiled on t (B, S, H, D) bf16, as
    csrc/flash_attention_bwd.cu::encode_maps calls it."""
    buf = (ctypes.c_uint8 * 256)()
    cmap = ctypes.c_void_p((ctypes.addressof(buf) + 63) & ~63)   # CUtensorMap: 64-byte aligned
    b, s, h, d = t.shape
    dims = (ctypes.c_uint64 * 4)(d, h, s, b)
    strides = (ctypes.c_uint64 * 3)(*(2 * st for st in (t.stride(2), t.stride(1), t.stride(0))))
    box = (ctypes.c_uint32 * 4)(64, 1, 64, 1)
    elem = (ctypes.c_uint32 * 4)(1, 1, 1, 1)
    return cu.cuTensorMapEncodeTiled(cmap, BF16, 4, ctypes.c_void_p(t.data_ptr()), dims,
                                     strides, box, elem, INTERLEAVE_NONE, SWIZZLE_128B,
                                     L2_256B, OOB_NONE)


def encoder_threads() -> dict:
    cu = _driver()
    t = torch.zeros((2, 300, 8, 128), dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    out = {"main": {"context": current_context(cu), "cuResult": encode(cu, t)}}

    def fresh():
        out["new thread"] = {"context": current_context(cu), "cuResult": encode(cu, t)}
        primary = ctypes.c_void_p()
        cu.cuDevicePrimaryCtxRetain(ctypes.byref(primary), t.device.index or 0)
        cu.cuCtxSetCurrent(primary)
        out["new thread, primary context current"] = {"context": current_context(cu),
                                                      "cuResult": encode(cu, t)}
        cu.cuDevicePrimaryCtxRelease(t.device.index or 0)

    worker = threading.Thread(target=fresh)
    worker.start()
    worker.join()
    return out


def _inputs():
    b, s, h, hkv, d = GQA_CASE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda").bfloat16()
               for n in (h, hkv, hkv))
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
    key_valid = torch.ones((b, s), dtype=torch.bool, device="cuda")
    key_valid[1, 270:] = False
    bidir = torch.zeros((b, s), dtype=torch.bool, device="cuda")
    bidir[0, 200:257] = True
    bidir[1, 150:240] = True
    return q, k, v, do, key_valid, bidir


def first_backward() -> dict:
    """One fresh process's first backward of the op, with the contexts seen
    on autograd's device thread."""
    from openvla_oft_tpu_torch import _build
    from openvla_oft_tpu_torch.ops import flash_attention as fa

    cu = _driver()
    _build.library()
    seen = {}
    launch_bwd, launch_dq = fa._launch_bwd, fa._launch_dq

    def at_backward(*args):
        seen["thread is main"] = threading.current_thread() is threading.main_thread()
        seen["at backward"] = current_context(cu)
        return launch_bwd(*args)

    def at_k2(*args):
        seen["before K2"] = current_context(cu)
        try:
            return launch_dq(*args)
        finally:
            seen["after K2"] = current_context(cu)

    fa._launch_bwd, fa._launch_dq = at_backward, at_k2
    q, k, v, do, key_valid, bidir = _inputs()
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, is_causal=True, key_valid=key_valid, bidir_mask=bidir)
    try:
        torch.autograd.grad(out, leaves, do)
        seen["backward"] = "ok"
    except RuntimeError as e:
        seen["backward"] = str(e)
    seen["main"] = current_context(cu)
    return seen


def entry_on_fresh_thread() -> dict:
    """K2's entry, through its wrapper's checks, on a thread that has run nothing."""
    from openvla_oft_tpu_torch.ops import flash_attention as fa

    cu = _driver()
    q, k, v, do, key_valid, bidir = _inputs()
    o, lse = fa.flash_attention_fwd(q, k, v, True, key_valid, bidir)
    masks = fa._mask_u8(q.shape[0], q.shape[1], key_valid, bidir, q.device)
    torch.cuda.synchronize()
    out = {}

    def fresh():
        out["before"] = current_context(cu)
        try:
            fa._launch_dq(q, k, v, o, lse, do, True, *masks, fa._plan_of(q, k))
            out["entry"] = "ok"
        except RuntimeError as e:
            out["entry"] = str(e)
        out["after"] = current_context(cu)

    worker = threading.Thread(target=fresh)
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=6, help="fresh processes for `autograd`")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_tmap_context needs a CUDA device")
    if args.child:
        print(json.dumps(first_backward()), flush=True)
        return {}
    result = {"encoder": encoder_threads(), "autograd": [], "entry": entry_on_fresh_thread()}
    for _ in range(args.runs):
        proc = subprocess.run([sys.executable, "-m", __spec__.name, "--child"],
                              capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        result["autograd"].append(json.loads(lines[-1]) if proc.returncode == 0 and lines
                                  else {"rc": proc.returncode, "stderr": proc.stderr[-500:]})
    for part in ("encoder", "entry"):
        print(f"{part}: {json.dumps(result[part])}", flush=True)
    for i, run in enumerate(result["autograd"]):
        print(f"autograd run {i}: {json.dumps(run)}", flush=True)
    return result


if __name__ == "__main__":
    main()
