"""The launch plan and the algorithm of the flash-attention forward kernel K1
(`csrc/flash_attention_fwd.cu`), on the CPU.

`_fwd_plan` gives the tiles, grid and walk order of K1's launch; its tiles
are the kernel's compile-time constants, which the source's static_assert
states. `_tiled_forward_emulation` follows the kernel's algorithm in numpy
at those tiles: a CTA of 128 query rows as two warpgroups of 64, the key
tiles walked in 64-row ring tiles, each (warpgroup, key tile) pair classed
by `_tile_class` (empty: skipped, asserted to hold no allowed entry;
interior: no mask evaluated, asserted to hold no masked entry; partial:
refused entries set to -1e30), and an online softmax in the log2 domain
(running max, rescale of O and of the row sums by 2^(m_old - m_new), P as
2^(s - m), rounded to v's dtype before P.V; O times one reciprocal of the
row sum per row). It is held against the JAX
`flash_attention` (the Pallas kernel in interpret mode on the CPU, as
tests/test_torch_flash_attention.py runs it) at rtol = atol = 2e-5 and
against the port's plain `flash_attention_ref` at 1e-5, in fp32, over
seeded layouts: right pads, left pads with a window across a diagonal, dead
rows, non-causal, GQA, interior pairs, S = 40 / 130 / 585. At fp32, P's
rounding to v's dtype does nothing; the bf16 cases round q, k, v and P to
bf16 as the kernel does and hold the emulation against `flash_attention_ref`
on bf16 inputs at the kernel's bounds on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_oft_tpu.ops.flash_attention import flash_attention as jax_flash
from openvla_oft_tpu_torch.ops import flash_attention as fa
from test_torch_bwd_plan import _layout
from test_torch_flash_attention import _dense_mask, _qkv

LOG2E, LN2 = np.float32(1.4426950408889634), np.float32(0.6931471805599453)
MASKED = np.float32(-1e30)             # a refused entry's score
NO_MAX = MASKED * LOG2E                # the running max of a row with no allowed key yet

# (b, s, h, hkv, d): the training batch, the LIBERO and ALOHA lengths, GQA,
# short and ragged.
PLAN_SHAPES = [(8, 585, 32, 32, 128), (1, 618, 32, 32, 128), (1, 1168, 32, 32, 128),
               (2, 618, 32, 8, 128), (1, 40, 4, 4, 64), (2, 77, 4, 2, 128), (1, 129, 2, 1, 64)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda c: "b{}s{}h{}kv{}d{}".format(*c))
def test_fwd_plan_tiles_grid_and_walk_order(shape):
    b, s, h, hkv, d = shape
    plan = fa._fwd_plan(b, s, h)
    assert (plan["rows"], plan["tile"], plan["stages"]) == (128, 64, 4)
    ctas = -(-s // 128)
    assert plan["grid"] == (ctas, h, b)           # a CTA per 128 query rows of a head
    # Every CTA's rows once, the last (under causal the longest walk) first.
    order = list(plan["q0_order"])
    assert sorted(order) == list(range(0, s, 128))
    assert order == sorted(order, reverse=True)


def test_fwd_plan_matches_kernel_constants():
    """The plan's tiles are the ones csrc/flash_attention_fwd.cu compiles
    with: its static_assert names ROWS, CTA_ROWS and STAGES."""
    src = (Path(fa.__file__).resolve().parents[1] / "csrc" / "flash_attention_fwd.cu").read_text()
    found = re.search(r"static_assert\(ROWS == (\d+) && CTA_ROWS == (\d+) && STAGES == (\d+),",
                      src)
    assert found is not None
    assert tuple(map(int, found.groups())) == (fa.FWD_TILE, fa.FWD_ROWS, fa.FWD_STAGES)
    assert re.search(rf"constexpr int ROWS = {fa.FWD_TILE};", src)
    assert re.search(r"constexpr int CTA_ROWS = 2 \* ROWS;", src)


def _round_bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


def _tiled_forward_emulation(q, k, v, causal, key_valid, bidir, plan=None, round_p=None):
    """K1's algorithm in numpy at the plan's tiles (see the module docstring),
    P rounded by `round_p` (by default to v's dtype) before P.V. Returns
    (O, LSE, pairs skipped, interior pairs)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    sl2 = np.float32(d ** -0.5) * LOG2E
    plan = plan or fa._fwd_plan(b, s, h)
    rows, tile = plan["rows"], plan["tile"]
    allow = _dense_mask(key_valid, bidir, s, causal)[:, 0]          # (B, S, S)
    o = np.zeros_like(q)
    lse = np.zeros((b, h, s), np.float32)
    skipped = interior = 0
    for bi in range(b):
        for hi in range(h):
            vh, kh = v[bi, :, hi // rep], k[bi, :, hi // rep]
            for q0 in plan["q0_order"]:
                for r0 in range(q0, min(q0 + rows, s), tile):      # the CTA's warpgroups
                    qr = np.arange(r0, min(r0 + tile, s))
                    m = np.full(len(qr), NO_MAX, np.float32)
                    l = np.zeros(len(qr), np.float32)
                    acc = np.zeros((len(qr), d), np.float32)
                    for k0 in range(0, s, tile):                   # the ring, in walk order
                        kc = np.arange(k0, min(k0 + tile, s))
                        al = allow[bi][np.ix_(qr, kc)]
                        cls = fa._tile_class(causal, r0, k0, key_valid[bi], bidir[bi], tile)
                        if cls == "empty":
                            assert not al.any()
                            skipped += 1
                            continue
                        sc = q[bi, qr, hi] @ kh[kc].T
                        if cls == "interior":                      # no mask evaluated
                            assert al.all()
                            interior += 1
                        else:
                            sc = np.where(al, sc, MASKED)
                        t = sc.max(1)
                        m_new = np.maximum(m, np.where(t == MASKED, NO_MAX, t * sl2))
                        alpha = np.exp2(m - m_new)
                        mu = np.where(m_new == NO_MAX, np.float32(0), m_new)
                        p = np.exp2(sc * sl2 - mu[:, None])
                        l = alpha * l + p.sum(1)
                        pv = round_p(p) if round_p else p.astype(v.dtype)
                        acc = acc * alpha[:, None] + pv @ vh[kc]
                        m = m_new
                    den = np.maximum(l, np.float32(1e-30))
                    o[bi, qr, hi] = acc * (np.float32(1) / den)[:, None]
                    lse[bi, hi, qr] = m * LN2 + np.log(den)
    return o, lse, skipped, interior


# (name, b, s, h, hkv, d, causal, layout kinds per batch row; see test_torch_bwd_plan)
EMULATION_CASES = [
    ("short", 1, 40, 2, 2, 32, True, ["right_pads"]),
    ("ragged_gqa_left_pads", 2, 150, 4, 2, 32, True, ["left_pads", "window_cross"]),
    ("dead_rows", 1, 200, 2, 1, 32, True, ["dead_rows"]),
    ("full_attention", 1, 100, 2, 1, 32, False, ["random"]),
    ("interior_pairs", 1, 260, 2, 2, 32, True, ["no_window"]),
    ("window_past_diagonal", 1, 130, 2, 2, 64, True, ["window_cross"]),
    ("training_length", 2, 585, 2, 1, 32, True, ["right_pads", "window_cross"]),
]


@pytest.mark.parametrize("case", EMULATION_CASES, ids=lambda c: c[0])
def test_tiled_forward_emulation_matches_jax_and_plain(rng, case):
    name, b, s, h, hkv, d, causal, kinds = case
    q, k, v = _qkv(rng, b=b, s=s, h=h, d=d, hkv=hkv)
    rows = [_layout(kind, s, i + s) for i, kind in enumerate(kinds)]
    key_valid = np.stack([r[0] for r in rows])
    bidir = np.stack([r[1] for r in rows])
    o, lse, skipped, interior = _tiled_forward_emulation(q, k, v, causal, key_valid, bidir)
    want = jax_flash(q, k, v, is_causal=causal, key_valid=key_valid, bidir_mask=bidir)
    np.testing.assert_allclose(o, np.asarray(want), rtol=2e-5, atol=2e-5)
    t = [torch.from_numpy(a) for a in (q, k, v, key_valid, bidir)]
    o_ref, lse_ref = fa.flash_attention_ref(t[0], t[1], t[2], causal, t[3], t[4])
    np.testing.assert_allclose(o, o_ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse, lse_ref.numpy(), rtol=1e-5, atol=1e-5)
    # Dead rows (no allowed key) are exactly zero, and the cases reach what
    # they are named for: skipped pairs under causal, interior pairs.
    dead = ~_dense_mask(key_valid, bidir, s, causal)[:, 0].any(-1)
    assert np.all(o[dead] == 0)
    if causal and s > 64:
        assert skipped > 0
    if name in ("interior_pairs", "training_length"):
        assert interior > 0
    if name == "dead_rows":
        assert dead.any()


# The kernel's bounds on the card (tests/test_torch_gpu.py): max |dO|, mean
# |dO| over rows with an allowed key, max |dLSE|.
BF16_MAX_O, BF16_MEAN_O, BF16_MAX_LSE = 2e-2, 2e-3, 1e-2


@pytest.mark.parametrize("case", [c for c in EMULATION_CASES
                                  if c[0] in ("ragged_gqa_left_pads", "training_length")],
                         ids=lambda c: c[0])
def test_tiled_forward_emulation_bf16_p_matches_plain(rng, case):
    """bf16 q, k, v and P rounded to bf16 before P.V, O rounded to bf16 as
    the kernel writes it, against `flash_attention_ref` on the same bf16
    operands."""
    name, b, s, h, hkv, d, causal, kinds = case
    q, k, v = (_round_bf16(a) for a in _qkv(rng, b=b, s=s, h=h, d=d, hkv=hkv))
    rows = [_layout(kind, s, i + s) for i, kind in enumerate(kinds)]
    key_valid = np.stack([r[0] for r in rows])
    bidir = np.stack([r[1] for r in rows])
    o, lse, _, _ = _tiled_forward_emulation(q, k, v, causal, key_valid, bidir,
                                            round_p=_round_bf16)
    o = _round_bf16(o)
    t = [torch.from_numpy(a) for a in (q, k, v, key_valid, bidir)]
    o_ref, lse_ref = fa.flash_attention_ref(*(x.bfloat16() for x in t[:3]), causal, t[3], t[4])
    live = _dense_mask(key_valid, bidir, s, causal)[:, 0].any(-1)
    err = np.abs(o - o_ref.float().numpy())[live]
    assert err.max() <= BF16_MAX_O and err.mean() <= BF16_MEAN_O
    assert np.abs(lse - lse_ref.numpy()).transpose(0, 2, 1)[live].max() <= BF16_MAX_LSE
    assert np.all(o[~live] == 0)
