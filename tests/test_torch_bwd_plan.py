"""The launch plan and pair classes of the flash-attention backward kernels
K2 and K3 (`csrc/flash_attention_bwd.cu`), on the CPU.

`_bwd_plan` gives the tiles and grids of the kernels' launches (its tiles
are the kernels' compile-time constants, which the source's static_assert
states); `_tile_class` mirrors the kernels' rule for a (query tile, key
tile) pair: empty (skipped), interior (no entry masked: P without the mask)
or partial. Both are held against the dense `_allow` mask over seeded random
layouts (right and left pads, dead rows, windows that cross a diagonal, S
below one tile and not a multiple of 64, causal and not), and the kernels'
algorithm at those tiles (`_tiled_backward_emulation`, GQA included)
against the plain backward in fp32 to 1e-5. `_bwd_operands`, the one check
of the backward's operands, is exercised on CPU bf16 tensors.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_oft_tpu_torch.ops import flash_attention as fa
from test_torch_flash_attention import _dense_mask, _qkv
from test_torch_flash_backward import _tiled_backward_emulation

# (b, s, h, hkv, d): the training batch, the ALOHA length, GQA, short and ragged.
PLAN_SHAPES = [(8, 585, 32, 32, 128), (1, 1168, 32, 32, 128), (2, 585, 32, 8, 128),
               (1, 40, 4, 4, 64), (2, 77, 4, 2, 128), (1, 128, 2, 2, 64), (1, 129, 2, 1, 64)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda c: "b{}s{}h{}kv{}d{}".format(*c))
def test_bwd_plan_tiles_and_grids(shape):
    b, s, h, hkv, d = shape
    plan = fa._bwd_plan(b, s, h, hkv, d)
    assert (plan["rows"], plan["tile"], plan["stages"]) == (128, 64, 4)
    ctas = -(-s // 128)
    assert plan["dq_grid"] == (ctas, h, b)        # a CTA per 128 query rows of a head
    assert plan["dkv_grid"] == (ctas, hkv, b)     # a CTA per 128 key rows of a kv head
    # The stats rows: every K2 CTA writes whole rows, every K3 ring tile
    # copies 64 rows that exist in the buffer, at a multiple of 512 bytes.
    assert plan["s_pad"] == ctas * 128 and plan["s_pad"] >= -(-s // 64) * 64
    assert all(q0 * 8 % 512 == 0 for q0 in range(0, s, plan["tile"]))


def test_bwd_plan_matches_kernel_constants():
    """The plan's tiles are the ones csrc/flash_attention_bwd.cu compiles
    with: its static_assert names ROWS, CTA_ROWS and STAGES."""
    src = (Path(fa.__file__).resolve().parents[1] / "csrc" / "flash_attention_bwd.cu").read_text()
    found = re.search(r"static_assert\(ROWS == (\d+) && CTA_ROWS == (\d+) && STAGES == (\d+),",
                      src)
    assert found is not None
    assert tuple(map(int, found.groups())) == (fa.BWD_TILE, fa.BWD_ROWS, fa.BWD_STAGES)
    assert re.search(rf"constexpr int ROWS = {fa.BWD_TILE};", src)


def _layout(kind: str, s: int, seed: int):
    """(key_valid, bidir) (S,) bool of one batch row, drawn from the seed."""
    rng = np.random.default_rng(seed)
    valid = np.zeros(s, bool)
    bidir = np.zeros(s, bool)
    if kind == "random":
        valid = rng.random(s) < 0.8
        bidir = rng.random(s) < 0.2
        return valid, bidir
    lo, hi = 0, s
    if kind in ("right_pads", "window_cross"):
        hi = s - int(rng.integers(0, min(70, s)))
    if kind in ("left_pads", "dead_rows"):
        lo = int(rng.integers(1, max(2, s // 2)))
    valid[lo:hi] = True
    if kind != "no_window" and hi - lo > 2:
        wl = int(rng.integers(1, min(100, hi - lo)))
        if kind == "window_cross":   # a window from inside one tile deep into the next
            w0 = max(lo, min(64 * int(rng.integers(0, max(1, s // 64))) + 20, hi - wl))
        else:
            w0 = int(rng.integers(lo, hi - wl + 1))
        bidir[w0:w0 + wl] = True
    if kind == "dead_rows":          # rows before the first valid key allow nothing
        bidir[:lo] = rng.random(lo) < 0.5
    return valid, bidir


KINDS = ["right_pads", "left_pads", "dead_rows", "window_cross", "no_window", "random"]
LENGTHS = [40, 64, 100, 200, 585]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_tile_class_matches_dense_mask(kind, s, causal):
    """Over every (query tile, key tile) pair: an empty pair holds no allowed
    entry, an interior pair no masked one (among rows and keys that exist)."""
    seen = set()
    for seed in range(3):
        valid, bidir = _layout(kind, s, seed * 101 + s)
        allow = _dense_mask(valid[None], bidir[None], s, causal)[0, 0]   # (S, S)
        for q0 in range(0, s, 64):
            for k0 in range(0, s, 64):
                cls = fa._tile_class(causal, q0, k0, valid, bidir)
                block = allow[q0:q0 + 64, k0:k0 + 64]
                seen.add(cls)
                if cls == "empty":
                    assert not block.any(), (seed, q0, k0)
                elif cls == "interior":
                    assert block.shape[1] == 64 and block.all(), (seed, q0, k0)
                else:
                    assert cls == "partial"
    assert seen <= {"empty", "interior", "partial"}


def test_every_tile_class_occurs():
    """The layouts above reach all three classes, so none of the checks is
    vacuous; a causal pair on the diagonal is partial."""
    classes = set()
    for kind in KINDS:
        for s in LENGTHS:
            for causal in (True, False):
                valid, bidir = _layout(kind, s, s)
                classes |= {fa._tile_class(causal, q0, k0, valid, bidir)
                            for q0 in range(0, s, 64) for k0 in range(0, s, 64)}
    assert classes == {"empty", "interior", "partial"}
    ones = np.ones(200, bool)
    assert fa._tile_class(True, 64, 64, ones, ~ones) == "partial"
    assert fa._tile_class(True, 64, 0, ones, ~ones) == "interior"
    assert fa._tile_class(True, 0, 64, ones, ~ones) == "empty"


def _skip_rule_pairs(causal, key_valid, bidir, tile=64):
    """The skip rule of csrc/oft_mask.cuh written out over numpy slices."""
    b, s = key_valid.shape
    pairs = 0
    for bi in range(b):
        for q0 in range(0, s, tile):
            q_hi = min(q0 + tile, s) - 1
            q_bid = bidir[bi, q0:q_hi + 1].any()
            for k0 in range(0, s, tile):
                valid = key_valid[bi, k0:k0 + tile]
                k_bid = (valid & bidir[bi, k0:k0 + tile]).any()
                pairs += bool(valid.any() and (not causal or k0 <= q_hi or (q_bid and k_bid)))
    return pairs


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_live_pairs_count_the_skip_rule(causal):
    """`_live_pairs` (the FLOP count of chip_smoke.py and the parts script)
    against the rule written out, over the layouts above, and at least the
    pairs that hold an allowed entry; the training batch of chip_smoke.py
    has 440 live pairs per head."""
    for kind in KINDS:
        for s in LENGTHS:
            rows = [_layout(kind, s, s + i) for i in range(3)]
            valid, bidir = np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])
            got = fa._live_pairs(causal, torch.from_numpy(valid), torch.from_numpy(bidir))
            assert got == _skip_rule_pairs(causal, valid, bidir), (kind, s)
            allow = _dense_mask(valid, bidir, s, causal)[:, 0]
            holding = sum(allow[i, q0:q0 + 64, k0:k0 + 64].any() for i in range(3)
                          for q0 in range(0, s, 64) for k0 in range(0, s, 64))
            assert got >= holding
    if causal:
        s = 585
        valid, bidir = np.zeros((8, s), bool), np.zeros((8, s), bool)
        for i in range(8):
            valid[i, :s - 5 * i] = True
            bidir[i, s - 5 * i - 57:s - 5 * i] = True
        assert fa._live_pairs(True, torch.from_numpy(valid), torch.from_numpy(bidir)) == 440


# (name, b, s, h, hkv, d, causal, layout kinds per batch row)
EMULATION_CASES = [
    ("short", 1, 40, 2, 2, 32, True, ["right_pads"]),
    ("ragged_gqa_left_pads", 2, 150, 4, 2, 32, True, ["left_pads", "window_cross"]),
    ("dead_rows", 1, 200, 2, 1, 32, True, ["dead_rows"]),
    ("full_attention", 1, 100, 2, 1, 32, False, ["random"]),
    ("interior_pairs", 1, 260, 2, 2, 32, True, ["no_window"]),
]


@pytest.mark.parametrize("case", EMULATION_CASES, ids=lambda c: c[0])
def test_tiled_backward_emulation_at_plan_tiles(rng, case):
    _, b, s, h, hkv, d, causal, kinds = case
    q, k, v = _qkv(rng, b=b, s=s, h=h, d=d, hkv=hkv)
    do = rng.standard_normal(q.shape).astype(np.float32)
    rows = [_layout(kind, s, i + s) for i, kind in enumerate(kinds)]
    key_valid = np.stack([r[0] for r in rows])
    bidir = np.stack([r[1] for r in rows])
    dq, dk, dv, _, _ = _tiled_backward_emulation(q, k, v, do, causal, key_valid, bidir)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    kv_t, bd_t = torch.from_numpy(key_valid), torch.from_numpy(bidir)
    o, lse = fa.flash_attention_ref(*t, causal, kv_t, bd_t)
    ref = fa.flash_attention_bwd_ref(*t, o, lse, torch.from_numpy(do), causal, kv_t, bd_t)
    for got, want in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)
    if case[0] == "interior_pairs":
        classes = {fa._tile_class(causal, q0, k0, key_valid[0], bidir[0])
                   for q0 in range(0, s, 64) for k0 in range(0, s, 64)}
        assert "interior" in classes


def _bf16(*shape):
    return torch.randn(shape).bfloat16()


def test_bwd_operands_reads_views_and_copies_what_tma_cannot_read():
    """q/k/v as views of one fused projection pass through as they are; a
    broadcast dO (a zero stride, which a TMA tensor map cannot take) and a dO
    with a non-contiguous last dim are copied; O and LSE are checked."""
    b, s, h, hkv, d = 2, 70, 4, 2, 64
    qkv = _bf16(b, s, (h + 2 * hkv) * d)
    q = qkv[..., :h * d].view(b, s, h, d)
    k = qkv[..., h * d:(h + hkv) * d].view(b, s, hkv, d)
    v = qkv[..., (h + hkv) * d:].view(b, s, hkv, d)
    o, lse = _bf16(b, s, h, d), torch.zeros((b, h, s))
    do_view = _bf16(b, s, h * d + 8)[..., :h * d].view(b, s, h, d)
    got = fa._bwd_operands(q, k, v, o, lse, do_view)
    assert all(g.data_ptr() == t.data_ptr() for g, t in zip(got, (q, k, v, do_view)))
    broadcast = _bf16(d).expand(b, s, h, d)
    do = fa._bwd_operands(q, k, v, o, lse, broadcast)[3]
    assert do.is_contiguous() and torch.equal(do, broadcast)
    transposed = _bf16(b, s, d, h).transpose(2, 3)
    do = fa._bwd_operands(q, k, v, o, lse, transposed)[3]
    assert do.stride(-1) == 1 and torch.equal(do, transposed)
    with pytest.raises(ValueError, match="LSE"):
        fa._bwd_operands(q, k, v, o, lse[..., :-1], do_view)
    with pytest.raises(ValueError, match="contiguous"):
        fa._bwd_operands(q, k, v, o.transpose(1, 2).contiguous().transpose(1, 2), lse, do_view)
    with pytest.raises(TypeError, match="bfloat16"):
        fa._bwd_operands(q.float(), k, v, o, lse, do_view)
