"""Port parity for kernel K1 (flash attention with the OFT 1-D mask rule).

Mirrors tests/test_flash_attention.py. The same numpy inputs go through the
JAX `flash_attention` (the Pallas kernel in interpret mode on the CPU, as the
JAX package's own tests run it) and the port's plain version
`flash_attention_ref`, which is what the port's wrapper runs for CPU tensors.
fp32 throughout, atol = rtol = 2e-5 (the JAX test's tolerance). The CUDA kernel
itself runs only on the card: the `gpu`-marked test compares it with the plain
version there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from openvla_oft_tpu.ops.attention import attention_xla
from openvla_oft_tpu.ops.flash_attention import _fwd_pallas, _round_up
from openvla_oft_tpu.ops.flash_attention import flash_attention as jax_flash
from openvla_oft_tpu_torch.ops import flash_attention as port_fa
from openvla_oft_tpu_torch.ops.attention import attention as port_attention

torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(rng, b=2, s=70, h=4, d=128, hkv=None):
    hkv = hkv or h
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def _dense_mask(key_valid, bidir, s, causal=True):
    allow = key_valid[:, None, :] & np.ones((key_valid.shape[0], s, s), bool)
    if causal:
        allow = allow & np.tril(np.ones((s, s), bool))[None]
    if bidir is not None:
        allow = allow | (bidir[:, :, None] & bidir[:, None, :] & key_valid[:, None, :])
    return allow[:, None]


def _port(q, k, v, **kw):
    kw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for n, a in kw.items()}
    o, lse = port_fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), **kw)
    return o.numpy(), lse.numpy()


def _jax_lse(q, k, v, key_valid, bidir):
    """LSE of the JAX kernel (lane 0 of its 128-lane broadcast), prepared as
    the JAX wrapper prepares its inputs."""
    b, s, h, d = q.shape
    bq = min(256, _round_up(s, 128))
    s_pad = _round_up(s, bq)
    pad4 = ((0, 0), (0, s_pad - s), (0, 0), (0, 0))
    pad2 = ((0, 0), (0, s_pad - s))
    qt, kt, vt = (jnp.asarray(np.pad(a, pad4)).transpose(0, 2, 1, 3) for a in (q, k, v))
    valid8 = jnp.broadcast_to(jnp.asarray(np.pad(key_valid, pad2), jnp.int32)[:, None],
                              (b, 8, s_pad))
    bidir8 = jnp.broadcast_to(jnp.asarray(np.pad(bidir, pad2), jnp.int32)[:, None],
                              (b, 8, s_pad))
    _, lse = _fwd_pallas(True, bq, qt, kt, vt, valid8, bidir8)
    return np.asarray(lse)[:, :, :s, 0]


def _tiled_emulation(q, k, v, causal, key_valid, bidir, bq=64, bk=64):
    """The CUDA kernel's algorithm in numpy: 64-row query tiles, 64-row key
    tiles, online softmax, the same tile-skip rule. Returns (O, LSE, skipped)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    o = np.zeros_like(q)
    lse = np.zeros((b, h, s), np.float32)
    skipped = 0
    for bi in range(b):
        for hi in range(h):
            for q0 in range(0, s, bq):
                rows = np.arange(q0, min(q0 + bq, s))
                m = np.full(len(rows), -1e30, np.float32)
                l = np.zeros(len(rows), np.float32)
                acc = np.zeros((len(rows), d), np.float32)
                q_bid_any = bidir[bi, rows].any()
                for k0 in range(0, s, bk):
                    cols = np.arange(k0, min(k0 + bk, s))
                    valid = key_valid[bi, cols]
                    reach = (not causal or k0 <= rows[-1]
                             or (q_bid_any and (bidir[bi, cols] & valid).any()))
                    if not valid.any() or not reach:
                        skipped += 1
                        continue
                    sc = q[bi, rows, hi] @ k[bi, cols, hi // rep].T * d ** -0.5
                    allow = valid[None, :] & ((not causal) | (cols[None] <= rows[:, None])
                                              | (bidir[bi, rows][:, None]
                                                 & bidir[bi, cols][None]))
                    t_max = np.where(allow, sc, -1e30).max(1)
                    m_new = np.maximum(m, t_max)
                    alpha = np.exp(m - m_new)
                    p = np.where(allow, np.exp(np.where(allow, sc - m_new[:, None],
                                                        0.0)), 0.0)
                    l = alpha * l + p.sum(1)
                    acc = acc * alpha[:, None] + p @ v[bi, cols, hi // rep]
                    m = m_new
                den = np.maximum(l, 1e-30)
                o[bi, rows, hi] = acc / den[:, None]
                lse[bi, hi, rows] = m + np.log(den)
    return o, lse, skipped


def test_flash_causal_matches_jax(rng):
    q, k, v = _qkv(rng)
    out, _ = _port(q, k, v, is_causal=True)
    np.testing.assert_allclose(out, np.asarray(jax_flash(q, k, v, is_causal=True)), **TOL)
    np.testing.assert_allclose(out, np.asarray(attention_xla(q, k, v, is_causal=True)),
                               **TOL)


def test_flash_padding_and_window_dead_rows_and_lse(rng):
    b, s = 2, 70
    q, k, v = _qkv(rng, b=b, s=s)
    key_valid = np.ones((b, s), bool)
    key_valid[0, :9] = False
    bidir = np.zeros((b, s), bool)
    bidir[:, 50:60] = True
    out, lse = _port(q, k, v, is_causal=True, key_valid=key_valid, bidir_mask=bidir)
    ref = np.asarray(jax_flash(q, k, v, is_causal=True, key_valid=key_valid,
                               bidir_mask=bidir))
    np.testing.assert_allclose(out, ref, **TOL)
    dense = np.asarray(attention_xla(q, k, v, mask=_dense_mask(key_valid, bidir, s)))
    np.testing.assert_allclose(out[key_valid], dense[key_valid], **TOL)
    # Left-pad query rows see no valid key: exactly zero, as in the JAX kernel.
    assert np.all(out[0, :9] == 0.0)
    live = np.broadcast_to(key_valid[:, None, :], lse.shape)
    np.testing.assert_allclose(lse[live], _jax_lse(q, k, v, key_valid, bidir)[live],
                               rtol=1e-5, atol=1e-5)
    # The window must matter.
    nowin = np.asarray(attention_xla(q, k, v, mask=_dense_mask(key_valid, None, s)))
    assert np.abs(out - nowin)[key_valid].max() > 1e-3


def test_flash_static_window_equals_mask_window(rng):
    q, k, v = _qkv(rng, s=64)
    bidir = np.zeros((2, 64), bool)
    bidir[:, 40:52] = True
    out_block, _ = _port(q, k, v, is_causal=True, bidir_block=(40, 12))
    out_mask, _ = _port(q, k, v, is_causal=True, bidir_mask=bidir)
    np.testing.assert_allclose(out_block, out_mask, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        out_block, np.asarray(jax_flash(q, k, v, is_causal=True, bidir_block=(40, 12))),
        **TOL)
    dense = attention_xla(q, k, v, mask=_dense_mask(np.ones((2, 64), bool), bidir, 64))
    np.testing.assert_allclose(out_block, np.asarray(dense), **TOL)


def test_flash_gqa(rng):
    q, k, v = _qkv(rng, h=4, hkv=2)
    out, _ = _port(q, k, v, is_causal=True)
    np.testing.assert_allclose(out, np.asarray(jax_flash(q, k, v, is_causal=True)), **TOL)
    np.testing.assert_allclose(out, np.asarray(attention_xla(q, k, v, is_causal=True)),
                               **TOL)


def test_flash_window_past_the_causal_diagonal_of_a_tile(rng):
    """Rows 40..63 of query tile 0 sit in a window reaching keys 64..139,
    i.e. into key tiles 1 and 2, wholly above tile 0's diagonal: the tile
    skip rule must keep them, and the kernel's tiled algorithm must agree
    with the plain version and with JAX."""
    b, s, d = 1, 200, 64
    q, k, v = _qkv(rng, b=b, s=s, h=2, d=d)
    key_valid = np.ones((b, s), bool)
    key_valid[:, :5] = False
    bidir = np.zeros((b, s), bool)
    bidir[:, 40:140] = True
    out, lse = _port(q, k, v, is_causal=True, key_valid=key_valid, bidir_mask=bidir)
    np.testing.assert_allclose(
        out, np.asarray(jax_flash(q, k, v, is_causal=True, key_valid=key_valid,
                                  bidir_mask=bidir)), **TOL)
    dense = np.asarray(attention_xla(q, k, v, mask=_dense_mask(key_valid, bidir, s)))
    np.testing.assert_allclose(out[key_valid], dense[key_valid], **TOL)
    tiled_o, tiled_lse, skipped = _tiled_emulation(q, k, v, True, key_valid, bidir)
    np.testing.assert_allclose(tiled_o, out, **TOL)
    np.testing.assert_allclose(tiled_lse[:, :, 5:], lse[:, :, 5:], rtol=1e-5, atol=1e-5)
    # Tiles 0-2 of each row tile are reachable; only the tile (0, 3) pair and
    # the like (above the diagonal, no window key) are skipped.
    assert skipped > 0
    # A plain causal skip would have dropped the forward window keys.
    nowin = np.asarray(attention_xla(q, k, v, mask=_dense_mask(key_valid, None, s)))
    assert np.abs(out[0, 40:64] - nowin[0, 40:64]).max() > 1e-3


def test_attention_dispatch_1d_masks_consistent(rng):
    """attention(use_flash=False) with 1-D masks equals the K1 path."""
    b, s = 2, 40
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, b=b, s=s))
    key_valid = torch.ones((b, s), dtype=torch.bool)
    key_valid[0, :5] = False
    bidir = torch.zeros((b, s), dtype=torch.bool)
    bidir[:, 30:38] = True
    dense = port_attention(q, k, v, is_causal=True, key_valid=key_valid,
                           bidir_mask=bidir, use_flash=False)
    fla = port_attention(q, k, v, is_causal=True, key_valid=key_valid,
                         bidir_mask=bidir, use_flash=True)
    auto = port_attention(q, k, v, is_causal=True, key_valid=key_valid,
                          bidir_mask=bidir, use_flash="auto")
    np.testing.assert_allclose(fla[key_valid].numpy(), dense[key_valid].numpy(), **TOL)
    assert torch.equal(auto, dense)   # "auto" on CPU tensors is the dense oracle


def test_cpu_path_never_counts_a_launch(rng):
    before = port_fa.flash_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, s=16))
    port_fa.flash_attention(q, k, v, is_causal=True)
    assert port_fa.flash_attention.launches == before == 0


@pytest.mark.gpu
def test_kernel_matches_plain_on_cuda(rng):
    """K1 against its plain version on the card, bf16 inputs, at a shape
    with left padding, a window, GQA and a ragged last tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, s, h, hkv, d = 1, 150, 8, 4, 128
    q, k, v = (torch.from_numpy(a).cuda().bfloat16()
               for a in _qkv(rng, b=b, s=s, h=h, d=d, hkv=hkv))
    key_valid = torch.ones((b, s), dtype=torch.bool, device="cuda")
    key_valid[:, :7] = False
    before = port_fa.flash_attention.launches
    o, lse = port_fa.flash_attention_fwd(q, k, v, True, key_valid,
                                         bidir_block=(90, 57))
    torch.cuda.synchronize()
    assert port_fa.flash_attention.launches == before + 1
    bidir = torch.zeros((b, s), dtype=torch.bool, device="cuda")
    bidir[:, 90:147] = True
    o_ref, lse_ref = port_fa.flash_attention_ref(q, k, v, True, key_valid, bidir)
    live = key_valid[0]
    err = (o.float() - o_ref.float())[:, live].abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3
    assert (lse - lse_ref)[..., live].abs().max().item() <= 1e-2
    assert torch.all(o[:, :7] == 0)
