"""Flash attention with the OFT block-bidirectional mask: kernel K1 on Hopper.

Port of `openvla_oft_tpu/ops/flash_attention.py::flash_attention` (the TPU
kernel `_kernel`, launched by `_fwd_pallas`). Masking comes from 1-D vectors,
never an (S, S) array:

    allow[i, j] = (j <= i AND key_valid[j]) OR (bidir[i] AND bidir[j] AND key_valid[j])

A CUDA tensor goes to the hand-written kernel `csrc/flash_attention_fwd.cu`
(built on first use by `_build.py`) or raises; a CPU tensor goes to the plain
version `flash_attention_ref` below. There is no fallback between the two.
`flash_attention.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30


def _mask_vectors(q: torch.Tensor, key_valid: Optional[torch.Tensor],
                  bidir_mask: Optional[torch.Tensor],
                  bidir_block: Optional[Tuple[int, int]]):
    """(B, S) bool key_valid and bidir vectors, defaults filled in."""
    b, s = q.shape[:2]
    if bidir_mask is None:
        bidir_mask = torch.zeros((b, s), dtype=torch.bool, device=q.device)
        if bidir_block is not None:
            w0, wl = bidir_block
            bidir_mask[:, w0:w0 + wl] = True
    if key_valid is None:
        key_valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
    return key_valid.bool(), bidir_mask.bool()


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        is_causal: bool, key_valid: torch.Tensor,
                        bidir: torch.Tensor):
    """Plain-torch K1: the same 1-D mask rule, fp32 scores and softmax,
    probabilities rounded to v's dtype before P.V, zeros for rows with no
    allowed key. Returns (O (B,S,H,D) in q's dtype, LSE (B,H,S) fp32)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (d ** -0.5)
    key_valid, bidir = key_valid.bool(), bidir.bool()
    allow = key_valid[:, None, :].expand(b, s, s)
    if is_causal:
        allow = allow & torch.ones((s, s), dtype=torch.bool,
                                   device=q.device).tril()[None]
    allow = allow | (bidir[:, :, None] & bidir[:, None, :] & key_valid[:, None, :])
    allow = allow[:, None]                                   # (B, 1, S, S)
    scores = torch.where(allow, scores, _NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(allow, torch.exp(scores - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhst,bthd->bhsd", p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def _check_operand(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention kernel takes bfloat16, {name} is {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"flash_attention: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(
            f"flash_attention kernel needs {name} with a contiguous last dim, "
            f"other strides multiples of 8 and a 16-byte aligned start; got "
            f"strides {t.stride()}")


def _launch(q, k, v, is_causal, key_valid, bidir):
    from openvla_oft_tpu_torch import _build

    b, s, h, d = q.shape
    hkv = k.shape[2]
    if d not in (64, 128):
        raise ValueError(f"flash_attention kernel takes head_dim 64 or 128, got {d}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: {h} query heads over {hkv} kv heads")
    _check_operand("q", q, (b, s, h, d), q.device)
    _check_operand("k", k, (b, s, hkv, d), q.device)
    _check_operand("v", v, (b, s, hkv, d), q.device)
    for name, t in (("key_valid", key_valid), ("bidir", bidir)):
        if tuple(t.shape) != (b, s):
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {(b, s)}")
    valid_u8 = key_valid.to(device=q.device, dtype=torch.uint8).contiguous()
    bidir_u8 = bidir.to(device=q.device, dtype=torch.uint8).contiguous()
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.openvla_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_u8.data_ptr(),
            bidir_u8.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, s, h, hkv, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(bool(is_causal)), ctypes.c_float(d ** -0.5),
            stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{lib.openvla_cuda_error_string(err).decode()} ({err})")
    flash_attention.launches += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        is_causal: bool = True,
                        key_valid: Optional[torch.Tensor] = None,
                        bidir_mask: Optional[torch.Tensor] = None,
                        bidir_block: Optional[Tuple[int, int]] = None):
    """(O, LSE) of self-attention (S == T): the kernel for CUDA tensors, the
    plain version for CPU tensors. q (B,S,H,D), k/v (B,S,Hkv,D)."""
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash attention is for self-attention prefill (S == T)")
    key_valid, bidir = _mask_vectors(q, key_valid, bidir_mask, bidir_block)
    if q.is_cuda:
        return _launch(q, k, v, is_causal, key_valid, bidir)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    return flash_attention_ref(q, k, v, is_causal, key_valid, bidir)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    is_causal: bool = True,
                    key_valid: Optional[torch.Tensor] = None,
                    bidir_mask: Optional[torch.Tensor] = None,
                    bidir_block: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Flash attention for self-attention (S == T). Returns (B, S, H, D)."""
    return flash_attention_fwd(q, k, v, is_causal, key_valid, bidir_mask,
                               bidir_block)[0]


flash_attention.launches = 0
