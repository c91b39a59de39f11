"""K4's launch plan and its TMA rule, on the CPU (the kernel itself is in
`tests/test_torch_gpu.py`).

`_k4_plan(M, D, N)` gives (BM, BN, grid CTAs): the kernel covers y's rows in
blocks of BM and its columns in tiles of BN, one CTA per (row block, column
tile), each over all of D; CTA i takes row block i % row_blocks and column
tile i // row_blocks (`csrc/ln_matmul.cu`). Checked here at the 8 ViT
serving shapes, the gpu tests' ragged shapes and M = 1. `_tma_ready` decides
whether the kernel's TMA copies read an operand as it is or a padded copy
(`_padded`).
"""

import numpy as np
import pytest
import torch

from openvla_oft_tpu_torch.ops import vit_fused as VF

# (name, M, D, N): the ViTs' LN + matmul launches at ALOHA (3 images) and
# LIBERO (2): DINOv2 rows 3 x 261 and 2 x 261, SigLIP 3 x 256 and 2 x 256.
VIT_SHAPES = [
    (f"{vit}_{proj}_{deploy}", m, d, n)
    for deploy, rows in (("aloha", (783, 768)), ("libero", (522, 512)))
    for vit, m, d, ns in (("dinov2", rows[0], 1024, (3072, 4096)),
                          ("siglip", rows[1], 1152, (3456, 4304)))
    for proj, n in zip(("qkv", "fc1"), ns)]
EDGE_SHAPES = [("m37_n200", 37, 1024, 200), ("d52_n198", 37, 52, 198),
               ("m1_n200", 1, 1024, 200), ("m1_fc1", 1, 1024, 4096),
               ("m129_n257", 129, 64, 257)]
SHAPES = VIT_SHAPES + EDGE_SHAPES


def _spans(size: int, step: int, count: int):
    return [(i * step, min(size, (i + 1) * step)) for i in range(count)]


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_k4_plan_covers_the_output_once(shape):
    _, m, d, n = shape
    bm, bn, grid = VF._k4_plan(m, d, n)
    assert (bm, bn) in VF.K4_TILES
    row_blocks, col_tiles = -(-m // bm), -(-n // bn)
    assert grid == row_blocks * col_tiles
    # Rows and columns are each cut into disjoint, non-empty ranges that
    # cover them.
    for size, step, count in ((m, bm, row_blocks), (n, bn, col_tiles)):
        spans = _spans(size, step, count)
        assert spans[0][0] == 0 and spans[-1][1] == size
        assert all(lo < hi for lo, hi in spans)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # The kernel's CTA -> tile map hits every output element exactly once.
    hits = np.zeros((m, n), dtype=np.int32)
    for cta in range(grid):
        m0, n0 = (cta % row_blocks) * bm, (cta // row_blocks) * bn
        hits[m0:m0 + bm, n0:n0 + bn] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("shape", VIT_SHAPES, ids=[s[0] for s in VIT_SHAPES])
def test_k4_plan_fills_the_card_at_the_vit_shapes(shape):
    """At every ViT serving shape the grid holds at least 3/4 of a wave of
    the card's 132 SMs."""
    _, m, d, n = shape
    assert VF._k4_plan(m, d, n)[2] >= 0.75 * VF.K4_SMS


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_k4_plan_takes_the_least_estimate_among_filling_tiles(shape):
    """No tile that fills 3/4 of a wave is passed over for one that does not,
    and among those the plan's tile has the least estimated time."""
    _, m, d, n = shape
    bm, bn, grid = VF._k4_plan(m, d, n)

    def est(tile):
        ctas = -(-m // tile[0]) * -(-n // tile[1])
        return (-(-ctas // VF.K4_SMS) * tile[0] * tile[1] / VF._K4_RATE[tile],
                ctas >= 0.75 * VF.K4_SMS)

    filling = [t for t in VF.K4_TILES if est(t)[1]]
    if filling:
        assert (bm, bn) in filling
        assert est((bm, bn))[0] == min(est(t)[0] for t in filling)
    else:
        assert est((bm, bn))[0] == min(est(t)[0] for t in VF.K4_TILES)


def _view(base: torch.Tensor, offset: int, rows: int, cols: int, stride: int):
    return base.as_strided((rows, cols), (stride, 1), offset)


@pytest.mark.parametrize("case,ready", [
    ("x_dinov2", True), ("w_fc1", True), ("w_layer_view", True), ("w_column_view", True),
    ("x_d52", False), ("w_n198", False), ("x_odd_base", False), ("w_odd_column_view", False),
])
def test_tma_rule_follows_strides_and_alignment(case, ready):
    """TMA reads an operand as it is only with contiguous rows, a 16-byte
    base and a row stride of a multiple of 16 bytes: the gpu tests' d52_n198
    (rows of 104 and 396 bytes) takes a padded copy."""
    bf = torch.bfloat16
    t = {
        "x_dinov2": lambda: torch.zeros((783, 1024), dtype=bf),
        "w_fc1": lambda: torch.zeros((1024, 4096), dtype=bf),
        "w_layer_view": lambda: torch.zeros((2, 1024, 3072), dtype=bf)[1],
        "w_column_view": lambda: torch.zeros((1024, 3 * 1024), dtype=bf)[:, 1024:2048],
        "x_d52": lambda: torch.zeros((37, 52), dtype=bf),
        "w_n198": lambda: torch.zeros((52, 198), dtype=bf),
        "x_odd_base": lambda: _view(torch.zeros(1 + 37 * 64, dtype=bf), 1, 37, 64, 64),
        "w_odd_column_view": lambda: torch.zeros((64, 256), dtype=bf)[:, 3:131],
    }[case]()
    assert VF._tma_ready(t) is ready
    if not ready:
        p = VF._padded(t)
        assert VF._tma_ready(p)
        assert p.shape[0] == t.shape[0] and p.shape[1] % 8 == 0 and p.shape[1] - t.shape[1] < 8
        assert torch.equal(p[:, :t.shape[1]], t) and not p[:, t.shape[1]:].any()


@pytest.mark.parametrize("m,d,n,act", [(37, 52, 198, "quick_gelu"), (5, 64, 40, "gelu"),
                                       (1, 128, 96, None)])
def test_cpu_path_is_the_plain_version(m, d, n, act):
    rng = np.random.default_rng(m + d + n)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((d, n)).astype(np.float32) * d ** -0.5)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1)
    before, plan = VF.ln_matmul.launches, VF.ln_matmul.last_plan
    got = VF.ln_matmul(x, w, b, act)
    assert VF.ln_matmul.launches == before and VF.ln_matmul.last_plan == plan
    assert torch.equal(got, VF.ln_matmul_ref(x, w, b, act))
