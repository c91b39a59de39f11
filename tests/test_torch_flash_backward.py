"""Port parity for the flash-attention backward (kernels K2 and K3).

The port's `flash_attention` is a torch.autograd.Function whose backward is
K2 (dq) and K3 (dk, dv); on CPU tensors it runs their plain version
`flash_attention_bwd_ref`. Its gradients are held against:
  - `jax.grad` of the JAX `flash_attention` (its Pallas forward and backward
    kernels in interpret mode, as tests/test_flash_attention.py runs them),
    with that file's `_assert_grads_close` (max |Δ| / max |ref| < 2e-3);
  - torch autograd through the dense oracle `attention_dense`;
  - itself under `torch.utils.checkpoint` (bitwise).
A numpy emulation of the CUDA kernels' tiling (`_bwd_plan`) and pair classes
(`_tile_class`: empty, interior, partial) shows that every pair K2 or K3
skips has P == 0, that no interior pair holds a masked entry, and that the
tile-wise sums give the plain version's dq, dk, dv (fp32, 1e-5).
Inputs are fp32, B = 2 with per-row pads and windows, GQA, and dead rows.
"""

import numpy as np
import pytest
import torch
import torch.utils.checkpoint
import jax
import jax.numpy as jnp

from openvla_oft_tpu.ops.flash_attention import flash_attention as jax_flash
from openvla_oft_tpu.ops.flash_attention import flash_attention_allheads as jax_allheads
from openvla_oft_tpu_torch.ops import flash_attention as fa
from openvla_oft_tpu_torch.ops.attention import attention_dense
from test_flash_attention import _assert_grads_close
from test_torch_flash_attention import _dense_mask, _qkv, _tiled_emulation

# (b, s, h, hkv, d, [(first valid key, last valid + 1, window start, window len)] per row)
CASES = {
    "per_row_pads_windows": (2, 100, 4, 4, 64, [(0, 100, 70, 12), (0, 86, 60, 16)]),
    "gqa": (2, 90, 4, 2, 64, [(0, 90, 40, 30), (0, 75, 20, 9)]),
    "dead_rows_pad_tile": (2, 150, 2, 2, 32, [(70, 150, 120, 20), (3, 150, 100, 40)]),
}


def _masks(case):
    b, s = case[0], case[1]
    key_valid = np.zeros((b, s), bool)
    bidir = np.zeros((b, s), bool)
    for i, (lo, hi, w0, wl) in enumerate(case[5]):
        key_valid[i, lo:hi] = True
        bidir[i, w0:w0 + wl] = True
    return key_valid, bidir


def _inputs(rng, case):
    b, s, h, hkv, d, _ = case
    q, k, v = _qkv(rng, b=b, s=s, h=h, d=d, hkv=hkv)
    do = rng.standard_normal(q.shape).astype(np.float32)
    return (q, k, v, do) + _masks(case)


def _port_grads(q, k, v, do, key_valid, bidir, wrap=None):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    kv, bd = torch.from_numpy(key_valid), torch.from_numpy(bidir)

    def f(q_, k_, v_):
        return fa.flash_attention(q_, k_, v_, is_causal=True, key_valid=kv, bidir_mask=bd)

    o = wrap(f, *leaves) if wrap else f(*leaves)
    (o * torch.from_numpy(do)).sum().backward()
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax_grad(rng, name):
    q, k, v, do, key_valid, bidir = _inputs(rng, CASES[name])

    def loss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, is_causal=True, key_valid=jnp.asarray(key_valid),
                      bidir_mask=jnp.asarray(bidir))
        return jnp.sum(o * do)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(q, k, v, do, key_valid, bidir)
    _assert_grads_close(got, [np.asarray(g) for g in ref])
    # Rows with no allowed key and invalid key rows get exactly zero.
    allow = _dense_mask(key_valid, bidir, q.shape[1])[:, 0]
    dead = ~allow.any(-1)
    assert np.all(got[0][dead] == 0)
    assert np.all(got[1][~key_valid] == 0) and np.all(got[2][~key_valid] == 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_dense_autograd(rng, name):
    """Against torch autograd through the dense oracle, with dO zero on the
    dead rows (the dense softmax spreads them over every key)."""
    q, k, v, do, key_valid, bidir = _inputs(rng, CASES[name])
    allow = _dense_mask(key_valid, bidir, q.shape[1])
    do = do * allow[:, 0].any(-1)[..., None, None]
    got = _port_grads(q, k, v, do, key_valid, bidir)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = attention_dense(*leaves, mask=torch.from_numpy(allow))
    (o * torch.from_numpy(do)).sum().backward()
    for g, t in zip(got, leaves):
        np.testing.assert_allclose(g, t.grad.numpy(), rtol=1e-4, atol=1e-5)


def test_backward_under_checkpoint(rng):
    """Remat recomputes the forward (K1) and gives the same gradients."""
    args = _inputs(rng, CASES["gqa"])
    plain = _port_grads(*args)
    remat = _port_grads(*args, wrap=lambda f, *t: torch.utils.checkpoint.checkpoint(
        f, *t, use_reentrant=False))
    for a, b in zip(plain, remat):
        np.testing.assert_array_equal(a, b)


def _tiled_backward_emulation(q, k, v, do, causal, key_valid, bidir, plan=None):
    """K2's and K3's algorithms in numpy at the plan's tiles (`fa._bwd_plan`):
    a CTA of `rows` rows as two warpgroups of `tile` rows, the other side
    walked in `tile`-row ring tiles; each warpgroup's pair classed by
    `fa._tile_class` (csrc/oft_mask.cuh): an empty pair is skipped and
    asserted to hold no allowed entry, an interior pair computes P without
    the mask and is asserted to hold no masked entry, a partial pair selects
    on the mask. delta once per query row, fp32 sums, K3's GQA group summed
    inside the key tile (query tiles outer, heads inner). Returns (dq, dk,
    dv, pairs skipped by K2, pairs skipped by K3)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = d ** -0.5
    plan = plan or fa._bwd_plan(b, s, h, hkv, d)
    rows, tile = plan["rows"], plan["tile"]
    o, lse, _ = _tiled_emulation(q, k, v, causal, key_valid, bidir, 64, 64)
    allow = _dense_mask(key_valid, bidir, s, causal)[:, 0]          # (B, S, S)
    delta = (do * o).sum(-1)                                          # (B, S, H)

    def p_ds(bi, hi, qr, kc, cls):
        al = allow[bi][np.ix_(qr, kc)]
        sc = q[bi, qr, hi] @ k[bi, kc, hi // rep].T * scale - lse[bi, hi, qr][:, None]
        if cls == "interior":
            assert al.all()
            p = np.exp(sc)
        else:
            p = np.where(al, np.exp(np.where(al, sc, 0.0)), 0.0)
        dp = do[bi, qr, hi] @ v[bi, kc, hi // rep].T
        return p, p * (dp - delta[bi, qr, hi][:, None]) * scale

    def halves(c0):
        return [np.arange(r0, min(r0 + tile, s)) for r0 in range(c0, min(c0 + rows, s), tile)]

    def cls_of(bi, qr, kc):
        c = fa._tile_class(causal, int(qr[0]), int(kc[0]), key_valid[bi], bidir[bi], tile)
        if c == "empty":
            assert not allow[bi][np.ix_(qr, kc)].any()
        return c

    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    skipped_dq = skipped_dkv = 0
    ring = [np.arange(t0, min(t0 + tile, s)) for t0 in range(0, s, tile)]
    for bi in range(b):
        for hi in range(h):                       # K2: a CTA per 128 query rows
            for c0 in range(0, s, rows):
                for kc in ring:
                    for qr in halves(c0):
                        cls = cls_of(bi, qr, kc)
                        if cls == "empty":
                            skipped_dq += 1
                            continue
                        _, ds = p_ds(bi, hi, qr, kc, cls)
                        dq[bi, qr, hi] += ds @ k[bi, kc, hi // rep]
        for hk in range(hkv):                     # K3: a CTA per 128 key rows
            for c0 in range(0, s, rows):
                if not key_valid[bi, c0:c0 + rows].any():
                    continue                      # written as zeros
                for qr in ring:
                    for hi in range(hk * rep, (hk + 1) * rep):
                        for kc in halves(c0):
                            cls = cls_of(bi, qr, kc)
                            if cls == "empty":
                                skipped_dkv += 1
                                continue
                            p, ds = p_ds(bi, hi, qr, kc, cls)
                            dv[bi, kc, hk] += p.T @ do[bi, qr, hi]
                            dk[bi, kc, hk] += ds.T @ q[bi, qr, hi]
    return dq, dk, dv, skipped_dq, skipped_dkv


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiled_backward_emulation_skips_only_zero_tiles(rng, name):
    q, k, v, do, key_valid, bidir = _inputs(rng, CASES[name])
    dq, dk, dv, n_dq, n_dkv = _tiled_backward_emulation(q, k, v, do, True, key_valid, bidir)
    assert n_dq > 0 and n_dkv > 0
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = fa.flash_attention_ref(*t, True, torch.from_numpy(key_valid),
                                    torch.from_numpy(bidir))
    ref = fa.flash_attention_bwd_ref(*t, o, lse, torch.from_numpy(do), True,
                                     torch.from_numpy(key_valid), torch.from_numpy(bidir))
    for got, want in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


def test_window_reaching_past_the_diagonal_is_not_skipped(rng):
    """A window from row 20 to 120 reaches key tile 1 from query tile 0:
    the transposed rule must keep that pair for K3 (dk/dv of keys 64..119)."""
    case = (1, 130, 2, 2, 32, [(0, 130, 20, 100)])
    q, k, v, do, key_valid, bidir = _inputs(rng, case)
    dq, dk, dv, _, _ = _tiled_backward_emulation(q, k, v, do, True, key_valid, bidir)
    causal_only = _tiled_backward_emulation(q, k, v, do, True, key_valid,
                                            np.zeros_like(bidir))
    assert np.abs(dk[0, 64:120] - causal_only[1][0, 64:120]).max() > 1e-3
    got = _port_grads(q, k, v, do, key_valid, bidir)
    for a, b in zip((dq, dk, dv), got):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_allheads_is_k1(rng):
    """`flash_attention_allheads` (the TPU's all-heads-per-block variant) is
    K1 in the port: it matches the JAX variant in interpret mode."""
    q, k, v, _, key_valid, bidir = _inputs(rng, CASES["gqa"])
    ref = jax_allheads(*map(jnp.asarray, (q, k, v)), is_causal=True,
                       key_valid=jnp.asarray(key_valid), bidir_mask=jnp.asarray(bidir))
    got = fa.flash_attention_allheads(*(torch.from_numpy(a) for a in (q, k, v)),
                                      is_causal=True, key_valid=torch.from_numpy(key_valid),
                                      bidir_mask=torch.from_numpy(bidir))
    np.testing.assert_allclose(got.numpy()[key_valid], np.asarray(ref)[key_valid],
                               rtol=2e-5, atol=2e-5)
