"""Attention entry point: the dense oracle and the dispatch to kernel K1.

Port of `openvla_oft_tpu/ops/attention.py::attention_xla` (here
`attention_dense`), `attention` and `attention_split_kv`. The dense path is
the semantic reference: fp32 scores and softmax, an arbitrary boolean mask,
GQA by repeating kv heads.
"""

from __future__ import annotations

from typing import Optional

import torch

from torch.distributed.tensor import DTensor

from openvla_oft_tpu_torch.ops.flash_attention import (HEAD_DIMS, flash_attention,
                                                      flash_attention_tp, heads_local_map)
from openvla_oft_tpu_torch.parallel.sharding import replicate

_NEG_INF = -0.7 * torch.finfo(torch.float32).max


def resolve_use_flash(use_flash, q_shape, dtype: torch.dtype, device, s_kv: int,
                      dense_mask: bool = False) -> bool:
    """Whether an attention with queries q (B, S, H, D) of `dtype` on `device`
    over `s_kv` keys goes to kernel K1.

    A dense mask (`dense_mask`) always takes the dense path: K1 reads only
    the 1-D mask vectors (key_valid and the bidirectional block). Otherwise
    use_flash True asks for K1, which then raises on a shape it does not
    take, and False for the dense path. "auto" takes K1 exactly where K1
    takes the call: on CUDA, in bfloat16, with head_dim 64 or 128 and
    self-attention (S == s_kv); anything else goes to the dense path. K1 has
    no length threshold on the card: it is 0.41-0.63x SDPA's forward at the
    serving and training shapes (PERF.md section 6). The JAX package's
    threshold (FLASH_SEQ_THRESHOLD = 1024 rows) is a crossover measured on a
    TPU v5e and is not carried over.
    """
    if dense_mask:
        return False
    if use_flash != "auto":
        return bool(use_flash)
    return (torch.device(device).type == "cuda" and dtype == torch.bfloat16
            and q_shape[-1] in HEAD_DIMS and q_shape[1] == s_kv)


def attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    is_causal: bool = False) -> torch.Tensor:
    """Multi-head attention with fp32 softmax and optional GQA.

    q (B, S, H, D); k/v (B, T, Hkv, D); mask broadcastable to (B, H, S, T),
    True = attend. Returns (B, S, H, D) in q's dtype. Products run on fp32
    copies of the inputs, so scores keep the fp32 accumulation that
    `preferred_element_type=float32` gives the JAX version.
    """
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    scale = d ** -0.5

    if mask is None and not is_causal:
        # Maskless bidirectional form (the ViT featurizers): batch and heads
        # collapse into one batched-GEMM dim.
        qm = q.transpose(1, 2).reshape(b * h, s, d).float()
        km = k.transpose(1, 2).reshape(b * h, t, d).float()
        vm = v.transpose(1, 2).reshape(b * h, t, d)
        probs = torch.softmax(torch.bmm(qm, km.transpose(1, 2)) * scale, dim=-1)
        o = torch.bmm(probs.to(vm.dtype).float(), vm.float())
        return o.reshape(b, h, s, d).transpose(1, 2).to(q.dtype)

    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if is_causal:
        causal = torch.ones((s, t), dtype=torch.bool, device=q.device).tril(t - s)
        mask = causal[None, None] if mask is None else (mask & causal[None, None])
    if mask is not None:
        logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None, is_causal: bool = False,
              use_flash=False, key_valid: Optional[torch.Tensor] = None,
              bidir_mask: Optional[torch.Tensor] = None,
              bidir_block: Optional[tuple] = None) -> torch.Tensor:
    """Dispatch between the dense oracle (arbitrary `mask`) and kernel K1
    (masking from the 1-D `key_valid` / `bidir_mask` vectors).

    use_flash: True -> K1 (its plain version on CPU); False -> dense;
    "auto" -> K1 where K1 takes the call, else dense; a dense `mask` is
    always dense (`resolve_use_flash`).

    q as a DTensor over the tp mesh (a tp-sharded model, `parallel/`) takes
    the tp route, `_attention_tp`; the mesh rides on q, so no `tp_mesh`
    argument is threaded down as in the JAX version.
    """
    if isinstance(q, DTensor):
        return _attention_tp(q, k, v, mask, is_causal, use_flash, key_valid,
                             bidir_mask, bidir_block)
    if resolve_use_flash(use_flash, q.shape, q.dtype, q.device, k.shape[1],
                         dense_mask=mask is not None):
        return flash_attention(q, k, v, is_causal=is_causal, key_valid=key_valid,
                               bidir_mask=bidir_mask, bidir_block=bidir_block)
    if bidir_mask is None and bidir_block is not None:
        # The dense path honours the static window exactly as K1 does.
        w0, wl = bidir_block
        bidir_mask = torch.zeros((q.shape[0], k.shape[1]), dtype=torch.bool,
                                 device=q.device)
        bidir_mask[:, w0:w0 + wl] = True
    if mask is None and (key_valid is not None or bidir_mask is not None):
        b, s, t = q.shape[0], q.shape[1], k.shape[1]
        kv = key_valid.bool() if key_valid is not None else \
            torch.ones((b, t), dtype=torch.bool, device=q.device)
        allow = kv[:, None, :].expand(b, s, t)
        if is_causal:
            allow = allow & torch.ones((s, t), dtype=torch.bool,
                                       device=q.device).tril(t - s)[None]
            is_causal = False
        if bidir_mask is not None:
            bm = bidir_mask.bool()
            allow = allow | (bm[:, :, None] & bm[:, None, :] & kv[:, None, :])
        mask = allow[:, None]
    return attention_dense(q, k, v, mask=mask, is_causal=is_causal)


def _attention_tp(q, k, v, mask, is_causal, use_flash, key_valid, bidir_mask,
                  bidir_block):
    """`attention` of tp DTensors: where the heads divide the tp axis, each
    rank attends over its own heads (`flash_attention_tp` on the K1 route,
    else the dense path under `heads_local_map`) and the output stays a
    DTensor Shard(2); where they do not, every rank computes all heads
    (JAX leaves that case to GSPMD, which gathers them too)."""
    mesh = q.device_mesh
    ntp = mesh.size()
    if q.shape[2] % ntp or k.shape[2] % ntp:
        return attention(replicate(q), replicate(k), replicate(v), mask=mask,
                         is_causal=is_causal, use_flash=use_flash, key_valid=key_valid,
                         bidir_mask=bidir_mask, bidir_block=bidir_block)
    if resolve_use_flash(use_flash, q.shape, q.dtype, q.device, k.shape[1],
                         dense_mask=mask is not None):
        return flash_attention_tp(q, k, v, mesh, is_causal=is_causal, key_valid=key_valid,
                                  bidir_mask=bidir_mask, bidir_block=bidir_block)
    masks = [t for t in (mask, key_valid, bidir_mask) if t is not None]

    def per_shard(q_, k_, v_, *m):
        it = iter(m)
        return attention(q_, k_, v_, mask=next(it) if mask is not None else None,
                         is_causal=is_causal, use_flash=False,
                         key_valid=next(it) if key_valid is not None else None,
                         bidir_mask=next(it) if bidir_mask is not None else None,
                         bidir_block=bidir_block)

    return heads_local_map(per_shard, q, k, v, mesh, *masks)


def attention_split_kv(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor,
                       mask_pre: Optional[torch.Tensor] = None,
                       mask_suf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q (B, S, H, D) over the cached prefix keys pk/pv (B, Tp,
    Hkv, D) and the suffix's own k/v (B, Ss, Hkv, D) as two online-softmax
    blocks, without the concatenated K/V; masks broadcast to (B, H, S, Tp)
    and (B, H, S, Ss), True = attend. Returns (B, S, H, D) in q's dtype.

    Each block gives its row max m, sum s and weighted values o; then
    m = max(m_p, m_s) and out = (o_p e^(m_p-m) + o_s e^(m_s-m)) /
    (s_p e^(m_p-m) + s_s e^(m_s-m)). A block with every key of a row masked
    (a dead row) has weight 0 and its max is replaced by the other block's,
    so that it cannot win the max. Scores and softmax in fp32, as in
    `attention_dense`; the probabilities round to v's dtype before the
    product, as the JAX version's do.
    """
    h, d = q.shape[2], q.shape[3]
    hkv = pk.shape[2]
    if hkv != h:
        pk, pv, k, v = (t.repeat_interleave(h // hkv, dim=2) for t in (pk, pv, k, v))
    scale = d ** -0.5
    qf = q.float()

    def block(keys, vals, mask):
        logits = torch.einsum("bshd,bthd->bhst", qf, keys.float()) * scale
        if mask is not None:
            logits = torch.where(mask, logits, _NEG_INF)
        m = logits.amax(dim=-1, keepdim=True)
        dead = m <= _NEG_INF * 0.5
        m = torch.where(dead, 0.0, m)
        p = torch.where(dead, 0.0, torch.exp(logits - m))
        o = torch.einsum("bhst,bthd->bhsd", p.to(vals.dtype).float(), vals.float())
        return m[..., 0], p.sum(dim=-1), o, dead[..., 0]

    m_p, s_p, o_p, dead_p = block(pk, pv, mask_pre)
    m_s, s_s, o_s, dead_s = block(k, v, mask_suf)
    m_p = torch.where(dead_p, m_s, m_p)
    m_s = torch.where(dead_s, m_p, m_s)
    m = torch.maximum(m_p, m_s)
    a_p = torch.where(dead_p, 0.0, torch.exp(m_p - m))
    a_s = torch.where(dead_s, 0.0, torch.exp(m_s - m))
    denom = torch.clamp(s_p * a_p + s_s * a_s, min=1e-30)
    out = (o_p * a_p[..., None] + o_s * a_s[..., None]) / denom[..., None]
    return out.transpose(1, 2).to(q.dtype)
