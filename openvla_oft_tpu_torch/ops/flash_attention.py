"""Flash attention with the OFT block-bidirectional mask: kernels K1, K2, K3.

Port of `openvla_oft_tpu/ops/flash_attention.py::flash_attention` with its
backward: the TPU kernels `_kernel` (forward, K1), `_kernel_dq` (K2) and
`_kernel_dkv` (K3), wired there as a `custom_vjp` and here as a
`torch.autograd.Function`. Masking comes from 1-D vectors, never an (S, S)
array:

    allow[i, j] = (j <= i AND key_valid[j]) OR (bidir[i] AND bidir[j] AND key_valid[j])

A CUDA tensor goes to the hand-written kernels `csrc/flash_attention_fwd.cu`
and `csrc/flash_attention_bwd.cu` (built on first use by `_build.py`) or
raises; a CPU tensor goes to the plain versions `flash_attention_ref`,
`flash_attention_dq_ref` and `flash_attention_dkv_ref` below (together
`flash_attention_bwd_ref`). There is no fallback between the two.
`flash_attention.launches`, `flash_attention_dq.launches` and
`flash_attention_dkv.launches` count kernel launches;
`flash_attention_dkv.stats_launches` counts the stats pass that a K3 called
without K2 runs first (`_launch_stats`).

All three kernels read q, k and v through their strides by TMA tensor maps.
K1 streams 64-row (K, V) tiles past 128 resident query rows with an online
softmax (`_fwd_plan`). The backward of the autograd op runs K2 first: it
computes delta once per query row and writes (LSE, delta) as stats rows,
which K3 then reads instead of O and LSE. `_bwd_plan` gives both kernels'
tiles and grids and `_tile_class` the three kernels' rule for a (query
tile, key tile) pair.
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


def _allow(q: torch.Tensor, is_causal: bool, key_valid: torch.Tensor,
           bidir: torch.Tensor) -> torch.Tensor:
    """The (B, 1, S, S) boolean mask of the 1-D rule."""
    b, s = q.shape[:2]
    key_valid, bidir = key_valid.bool(), bidir.bool()
    allow = key_valid[:, None, :].expand(b, s, s)
    if is_causal:
        allow = allow & torch.ones((s, s), dtype=torch.bool,
                                   device=q.device).tril()[None]
    allow = allow | (bidir[:, :, None] & bidir[:, None, :] & key_valid[:, None, :])
    return allow[:, None]


def _repeat_kv(t: torch.Tensor, h: int) -> torch.Tensor:
    hkv = t.shape[2]
    return t if hkv == h else t.repeat_interleave(h // hkv, dim=2)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        is_causal: bool, key_valid: torch.Tensor,
                        bidir: torch.Tensor):
    """Plain-torch K1: the same 1-D mask rule, fp32 scores and softmax,
    probabilities rounded to v's dtype before P.V, zeros for rows with no
    allowed key. Returns (O (B,S,H,D) in q's dtype, LSE (B,H,S) fp32)."""
    d, h = q.shape[-1], q.shape[2]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (d ** -0.5)
    allow = _allow(q, is_causal, key_valid, bidir)
    scores = torch.where(allow, scores, _NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(allow, torch.exp(scores - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhst,bthd->bhsd", p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def _bwd_ref_scores(q, k, v, o, lse, do, is_causal, key_valid, bidir):
    """P and dS (B,H,S,S) fp32 of the plain backward, from K1's residuals.
    P is taken by a select, so the overflow of exp at dead rows (LSE = -1e30)
    never reaches a product."""
    d, h = q.shape[-1], q.shape[2]
    scale = d ** -0.5
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          _repeat_kv(k, h).float()) * scale
    p = torch.where(_allow(q, is_causal, key_valid, bidir),
                    torch.exp(scores - lse[..., None]), 0.0)
    dp = torch.einsum("bshd,bthd->bhst", do.float(), _repeat_kv(v, h).float())
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)      # (B, H, S)
    return p, p * (dp - delta[..., None]) * scale


def _dq_from(ds, q, k):
    return torch.einsum("bhst,bthd->bshd", ds.to(q.dtype).float(),
                        _repeat_kv(k, q.shape[2]).float()).to(q.dtype)


def _dkv_from(p, ds, q, k, v, do):
    """dk, dv per query head, summed over each GQA group in fp32, then one
    rounding (the JAX version sums bf16 per-head results outside its kernel)."""
    b, s, hkv, d = k.shape
    rep = q.shape[2] // hkv
    dk = torch.einsum("bhst,bshd->bthd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhst,bshd->bthd", p.to(v.dtype).float(), do.float())
    return (dk.reshape(b, s, hkv, rep, d).sum(3).to(k.dtype),
            dv.reshape(b, s, hkv, rep, d).sum(3).to(v.dtype))


def flash_attention_dq_ref(q, k, v, o, lse, do, is_causal, key_valid, bidir):
    """Plain-torch K2: dq (B,S,H,D) in q's dtype."""
    _, ds = _bwd_ref_scores(q, k, v, o, lse, do, is_causal, key_valid, bidir)
    return _dq_from(ds, q, k)


def flash_attention_dkv_ref(q, k, v, o, lse, do, is_causal, key_valid, bidir):
    """Plain-torch K3: (dk, dv), each (B,S,Hkv,D) in k's / v's dtype."""
    p, ds = _bwd_ref_scores(q, k, v, o, lse, do, is_causal, key_valid, bidir)
    return _dkv_from(p, ds, q, k, v, do)


def flash_attention_bwd_ref(q, k, v, o, lse, do, is_causal, key_valid, bidir):
    """Plain-torch backward of K1: (dq, dk, dv) from q/k/v, the forward's O
    and LSE, and dO. Scores and products in fp32 on the given values; P and
    dS round to v's / q's dtype before their products, as the TPU kernels do."""
    args = (q, k, v, o, lse, do, is_causal, key_valid, bidir)
    return (flash_attention_dq_ref(*args),) + flash_attention_dkv_ref(*args)


# K2's and K3's tiles (csrc/flash_attention_bwd.cu): a CTA holds two consumer
# warpgroups of BWD_TILE rows each (K2: query rows, K3: key rows) and walks
# the other side in ring tiles of BWD_TILE rows, BWD_STAGES of them in flight.
BWD_TILE, BWD_ROWS, BWD_STAGES = 64, 128, 4


def _bwd_plan(b: int, s: int, h: int, hkv: int, d: int) -> dict:
    """K2's and K3's launch plan for q (b, s, h, d) and k, v (b, s, hkv, d):
    the CTA's rows, the ring's tile rows and stages, each kernel's grid
    (K2: one CTA per 128 query rows of a head, K3: per 128 key rows of a kv
    head) and `s_pad`, the row count of the stats rows (b, h, s_pad): a
    multiple of the CTA's rows, so that every K2 CTA writes whole rows and
    every ring tile of K3 copies 64 rows at a 512-byte offset. The tiles do
    not depend on d; `_check_qkv` says which shapes the kernels take."""
    ctas = -(-s // BWD_ROWS)
    return {"rows": BWD_ROWS, "tile": BWD_TILE, "stages": BWD_STAGES,
            "s_pad": ctas * BWD_ROWS, "dq_grid": (ctas, h, b), "dkv_grid": (ctas, hkv, b)}


def _tile_class(is_causal: bool, q0: int, k0: int, key_valid, bidir,
                tile: int = BWD_TILE) -> str:
    """"empty", "interior" or "partial": what K2 and K3 make of the pair of
    query rows q0 .. q0 + tile - 1 and keys k0 .. k0 + tile - 1 of one batch
    row (key_valid, bidir: its (S,) bool vectors). The rules of
    csrc/oft_mask.cuh: an empty pair (`tile_pair_live` false) is skipped; an
    interior pair (`tile_pair_interior`: every key exists and is valid and,
    under causal, the last key is at or below the first query row) computes
    P without `allow`; a partial pair evaluates `allow` per element."""
    s = len(key_valid)
    q_hi = min(q0 + tile, s) - 1
    valid = [bool(key_valid[j]) for j in range(k0, min(k0 + tile, s))]
    k_any_bid = any(bool(bidir[j]) and valid[j - k0] for j in range(k0, k0 + len(valid)))
    q_bid_any = any(bool(bidir[i]) for i in range(q0, q_hi + 1))
    if not (any(valid) and (not is_causal or k0 <= q_hi or (q_bid_any and k_any_bid))):
        return "empty"
    if len(valid) == tile and all(valid) and (not is_causal or k0 + tile - 1 <= q0):
        return "interior"
    return "partial"


def _live_pairs(is_causal: bool, key_valid: torch.Tensor, bidir: torch.Tensor,
                tile: int = BWD_TILE) -> int:
    """The (query tile, key tile) pairs that `_tile_class` does not call
    empty, summed over the batch rows of key_valid and bidir (B, S): the
    pairs K1, K2 and K3 compute, per head."""
    kv, bd = key_valid.tolist(), bidir.tolist()
    s = len(kv[0])
    return sum(_tile_class(is_causal, q0, k0, kv[i], bd[i], tile) != "empty"
               for i in range(len(kv)) for q0 in range(0, s, tile) for k0 in range(0, s, tile))


def _kernel_readable(t: torch.Tensor) -> bool:
    """Contiguous last dim, other strides multiples of 8 elements and a
    16-byte aligned start: the kernels load 16-byte chunks of each row."""
    return (t.stride(-1) == 1 and all(st % 8 == 0 for st in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _check_operand(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention kernel takes bfloat16, {name} is {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"flash_attention: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not _kernel_readable(t):
        raise ValueError(
            f"flash_attention kernel needs {name} with a contiguous last dim, "
            f"other strides multiples of 8 and a 16-byte aligned start; got "
            f"strides {t.stride()}")


# The head widths K1, K2 and K3 are compiled for.
HEAD_DIMS = (64, 128)


def _check_qkv(q, k, v) -> None:
    """What every kernel needs of q (B,S,H,D) and k/v (B,S,Hkv,D)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim 64 or 128, got {d}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: {h} query heads over {hkv} kv heads")
    _check_operand("q", q, (b, s, h, d), q.device)
    _check_operand("k", k, (b, s, hkv, d), q.device)
    _check_operand("v", v, (b, s, hkv, d), q.device)


# K1's tiles (csrc/flash_attention_fwd.cu): a CTA holds FWD_ROWS query rows as
# two consumer warpgroups of FWD_TILE rows and walks the key tiles in ring
# tiles of FWD_TILE rows, FWD_STAGES (K, V) pairs in flight.
FWD_TILE, FWD_ROWS, FWD_STAGES = 64, 128, 4


def _fwd_plan(b: int, s: int, h: int) -> dict:
    """K1's launch plan for B = b, S = s and H = h query heads: the CTA's
    query rows, the ring's tile rows and stages, the grid (one CTA per 128
    query rows of a head) and `q0_order`, the first query row of the CTAs
    in the order blockIdx.x starts them: the last rows first, which under
    `causal` have the most key tiles to walk. The kernel works out the same
    grid itself; `_check_qkv` says which head dims and kv heads it takes."""
    ctas = -(-s // FWD_ROWS)
    return {"rows": FWD_ROWS, "tile": FWD_TILE, "stages": FWD_STAGES, "grid": (ctas, h, b),
            "q0_order": tuple(FWD_ROWS * (ctas - 1 - x) for x in range(ctas))}


def _launch(q, k, v, is_causal, key_valid, bidir):
    from openvla_oft_tpu_torch import _build

    _check_qkv(q, k, v)
    q, k, v = (t if _tma_readable(t) else t.contiguous() for t in (q, k, v))
    b, s, h, d = q.shape
    hkv = k.shape[2]
    valid_u8, bidir_u8 = _mask_u8(b, s, key_valid, bidir, q.device)
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.openvla_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_u8.data_ptr(),
            bidir_u8.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, s, h, hkv, d, *_strides(q, k, v), int(bool(is_causal)),
            ctypes.c_float(d ** -0.5), stream)
    _build.check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return o, lse


def _mask_u8(b, s, key_valid, bidir, device):
    for name, t in (("key_valid", key_valid), ("bidir", bidir)):
        if tuple(t.shape) != (b, s):
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {(b, s)}")
    return (key_valid.to(device=device, dtype=torch.uint8).contiguous(),
            bidir.to(device=device, dtype=torch.uint8).contiguous())


def _tma_readable(t: torch.Tensor) -> bool:
    """K1, K2 and K3 read q, k, v (and dO) through TMA tensor maps, which take
    no zero stride on a dimension of extent > 1 (a broadcast)."""
    return all(st > 0 or n == 1 for st, n in zip(t.stride()[:-1], t.shape[:-1]))


def _bwd_operands(q, k, v, o, lse, do):
    """Check the backward's operands once; returns (q, k, v, dO) as the
    kernels read them. Each is read through its strides; only a layout the
    kernels cannot read (dO's last dim not contiguous or misaligned, a
    broadcast dimension) is copied."""
    _check_qkv(q, k, v)
    b, s, h, d = q.shape
    if not _kernel_readable(do):
        do = do.contiguous()
    _check_operand("dO", do, (b, s, h, d), q.device)
    _check_operand("O", o, (b, s, h, d), q.device)
    if not o.is_contiguous():
        raise ValueError("flash_attention backward needs O as K1 wrote it (contiguous)")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention backward needs LSE (B, H, S) fp32 "
                         "contiguous, as K1 wrote it")
    return tuple(t if _tma_readable(t) else t.contiguous() for t in (q, k, v, do))


def _strides(*ts):
    return [st for t in ts for st in t.stride()[:3]]


def _plan_of(q, k) -> dict:
    return _bwd_plan(q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3])


def _stats_rows(q, plan) -> torch.Tensor:
    """The (B, H, s_pad, 2) fp32 stats rows: (LSE, delta) of each query row."""
    return torch.empty((q.shape[0], q.shape[2], plan["s_pad"], 2), dtype=torch.float32,
                       device=q.device)


def _launch_dq(q, k, v, o, lse, do, is_causal, valid_u8, bidir_u8, plan, stats=None):
    """K2 on checked operands; with `stats`, it also writes the stats rows."""
    from openvla_oft_tpu_torch import _build

    b, s, h, d = q.shape
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.openvla_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), valid_u8.data_ptr(),
            bidir_u8.data_ptr(), dq.data_ptr(), 0 if stats is None else stats.data_ptr(),
            b, s, h, k.shape[2], d, plan["s_pad"],
            *_strides(q, k, v, do), int(bool(is_causal)),
            ctypes.c_float(d ** -0.5), stream)
    _build.check_launch(err, "flash_attention dq (K2)")
    flash_attention_dq.launches += 1
    return dq


def _launch_stats(o, lse, do, plan):
    """The stats pass: the stats rows from O, LSE and dO, for a K3 called
    without K2 (counted in `flash_attention_dkv.stats_launches`)."""
    from openvla_oft_tpu_torch import _build

    b, s, h, d = o.shape
    stats = _stats_rows(o, plan)
    lib = _build.library()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = lib.openvla_flash_attention_bwd_stats(
            o.data_ptr(), lse.data_ptr(), do.data_ptr(), stats.data_ptr(), b, s, h, d,
            plan["s_pad"], *do.stride()[:3], stream)
    _build.check_launch(err, "flash_attention stats pass")
    flash_attention_dkv.stats_launches += 1
    return stats


def _launch_dkv(q, k, v, do, is_causal, valid_u8, bidir_u8, plan, stats):
    """K3 on checked operands and the stats rows."""
    from openvla_oft_tpu_torch import _build

    b, s, h, d = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.openvla_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), stats.data_ptr(), do.data_ptr(),
            valid_u8.data_ptr(), bidir_u8.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, k.shape[2], d, plan["s_pad"],
            *_strides(q, k, v, do), int(bool(is_causal)),
            ctypes.c_float(d ** -0.5), stream)
    _build.check_launch(err, "flash_attention dk/dv (K3)")
    flash_attention_dkv.launches += 1
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do, is_causal, valid_u8, bidir_u8):
    """The autograd op's backward on the card: one check of the operands,
    K2 (dq and the stats rows), then K3 (dk, dv) on those rows."""
    q, k, v, do = _bwd_operands(q, k, v, o, lse, do)
    plan = _plan_of(q, k)
    stats = _stats_rows(q, plan)
    dq = _launch_dq(q, k, v, o, lse, do, is_causal, valid_u8, bidir_u8, plan, stats)
    return (dq,) + _launch_dkv(q, k, v, do, is_causal, valid_u8, bidir_u8, plan, stats)


def _on_cpu(q: torch.Tensor) -> bool:
    if q.is_cuda:
        return False
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    return True


def _forward(q, k, v, is_causal, key_valid, bidir):
    if _on_cpu(q):
        return flash_attention_ref(q, k, v, is_causal, key_valid, bidir)
    return _launch(q, k, v, is_causal, key_valid, bidir)


def flash_attention_dq(q, k, v, o, lse, do, is_causal, key_valid, bidir):
    """dq of K1's attention: kernel K2 for CUDA tensors, the plain version
    for CPU tensors. o, lse are K1's outputs; do is the gradient of o."""
    if _on_cpu(q):
        return flash_attention_dq_ref(q, k, v, o, lse, do, is_causal, key_valid, bidir)
    masks = _mask_u8(q.shape[0], q.shape[1], key_valid, bidir, q.device)
    q, k, v, do = _bwd_operands(q, k, v, o, lse, do)
    return _launch_dq(q, k, v, o, lse, do, is_causal, *masks, _plan_of(q, k))


def flash_attention_dkv(q, k, v, o, lse, do, is_causal, key_valid, bidir):
    """(dk, dv) of K1's attention, GQA groups summed: kernel K3 for CUDA
    tensors (after the stats pass, which gives it delta), the plain version
    for CPU tensors."""
    if _on_cpu(q):
        return flash_attention_dkv_ref(q, k, v, o, lse, do, is_causal, key_valid, bidir)
    masks = _mask_u8(q.shape[0], q.shape[1], key_valid, bidir, q.device)
    q, k, v, do = _bwd_operands(q, k, v, o, lse, do)
    plan = _plan_of(q, k)
    stats = _launch_stats(o, lse, do, plan)
    return _launch_dkv(q, k, v, do, is_causal, *masks, plan, stats)


class _FlashAttention(torch.autograd.Function):
    """K1 forward saving (q, k, v, O, LSE, masks); K2 then K3 backward. On
    the card the masks are converted to uint8 once, in the forward, and the
    backward checks its operands once for both kernels."""

    @staticmethod
    def forward(ctx, q, k, v, is_causal, key_valid, bidir):
        if not _on_cpu(q):
            key_valid, bidir = _mask_u8(q.shape[0], q.shape[1], key_valid, bidir, q.device)
        o, lse = _forward(q, k, v, is_causal, key_valid, bidir)
        ctx.is_causal = is_causal
        ctx.save_for_backward(q, k, v, o, lse, key_valid, bidir)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, key_valid, bidir = ctx.saved_tensors
        args = (q, k, v, o, lse, do, ctx.is_causal, key_valid, bidir)
        grads = flash_attention_bwd_ref(*args) if _on_cpu(q) else _launch_bwd(*args)
        return grads + (None, None, None)


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
    return _forward(q, k, v, is_causal, key_valid, bidir)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    is_causal: bool = True,
                    key_valid: Optional[torch.Tensor] = None,
                    bidir_mask: Optional[torch.Tensor] = None,
                    bidir_block: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Flash attention for self-attention (S == T). Returns (B, S, H, D).

    Differentiable: with grad enabled and any of q/k/v requiring grad it
    runs as an autograd op whose backward is K2 and K3 (their plain versions
    on the CPU). Otherwise (e.g. under `inference_mode`) it saves nothing.
    """
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash attention is for self-attention prefill (S == T)")
    key_valid, bidir = _mask_vectors(q, key_valid, bidir_mask, bidir_block)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(is_causal), key_valid, bidir)
    return _forward(q, k, v, is_causal, key_valid, bidir)[0]


flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
flash_attention_dkv.stats_launches = 0

# Port of the JAX `flash_attention_allheads` (the TPU kernel
# `_kernel_allheads`): K1's forward read as (B, S, H, D) blocks with all heads
# per program, a TPU layout choice. K1 already reads q/k/v of shape
# (B, S, H, D) through their strides, so on Hopper it is K1 itself.
flash_attention_allheads = flash_attention


def tp_mesh_of(mesh, axis: str = "tp"):
    """The 1-D mesh of `axis`: `mesh` itself when it is that mesh, else its
    sub-mesh."""
    return mesh if mesh.mesh_dim_names == (axis,) else mesh[axis]


def heads_local_map(fn, q, k, v, mesh, *replicated, axis: str = "tp"):
    """`fn(q, k, v, *replicated)` per head shard: `local_map` over the head
    dim (2) of q, k and v on the tp mesh, the other tensors replicated;
    returns a DTensor Shard(2). Heads are independent in attention, so each
    rank computes its H/tp query heads over its Hkv/tp kv heads and no
    collective runs inside; plain q, k, v count as replicated (their head
    slice is free)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    tp = tp_mesh_of(mesh, axis)
    ntp = tp.size()
    h, hkv = q.shape[2], k.shape[2]
    if h % ntp or hkv % ntp:
        raise ValueError(f"{h} query and {hkv} kv heads over tp = {ntp}")

    def dt(t):
        return t if isinstance(t, DTensor) else \
            DTensor.from_local(t, tp, [Replicate()], run_check=False)

    heads, rep = [Shard(2)], [Replicate()]
    wrapped = local_map(fn, out_placements=heads,
                        in_placements=(heads, heads, heads) + (rep,) * len(replicated),
                        device_mesh=tp, redistribute_inputs=True)
    return wrapped(dt(q), dt(k), dt(v), *(dt(t) for t in replicated))


def flash_attention_tp(q, k, v, mesh, axis: str = "tp", is_causal: bool = True,
                       key_valid: Optional[torch.Tensor] = None,
                       bidir_mask: Optional[torch.Tensor] = None,
                       bidir_block: Optional[Tuple[int, int]] = None):
    """Tensor-parallel flash attention (JAX `flash_attention_tp`): K1 (and
    K2/K3 in the backward) on each rank's H/tp query heads and Hkv/tp kv
    heads, through `local_map` over the head dim of q, k, v (B, S, H, D)
    on the `axis` mesh of `mesh`. The 1-D masks are built once, outside,
    and replicated, so no rank can build them otherwise. Returns a DTensor
    Shard(2) over the tp mesh."""
    tp = tp_mesh_of(mesh, axis)
    assert q.shape[2] % tp.size() == 0 and k.shape[2] % tp.size() == 0, \
        (q.shape[2], k.shape[2], tp.size())
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash attention is for self-attention prefill (S == T)")
    key_valid, bidir = _mask_vectors(q, key_valid, bidir_mask, bidir_block)

    def per_shard(q_, k_, v_, kv_, bd_):
        # A shard's layout is what the redistribution left (seen on the card:
        # d not innermost); the kernels read a contiguous last dim.
        q_, k_, v_ = (t.contiguous() for t in (q_, k_, v_))
        return flash_attention(q_, k_, v_, is_causal=is_causal, key_valid=kv_,
                               bidir_mask=bd_)

    return heads_local_map(per_shard, q, k, v, tp, key_valid, bidir)
