"""K5's and K6's launch plans and group rule, on the CPU (the kernels
themselves are in `tests/test_torch_gpu.py`).

`_k5_plan(T, K, N, group)` and `_k6_plan` give (t_tile, splits, grid CTAs):
the kernel covers x's rows in chunks of t_tile, the output columns in tiles
of 128, and the depth in `splits` ranges of whole groups, each a whole
number of the kernel's stages. Checked here at the 7B's int4 shapes and the
gpu tests' small shapes, at the row counts the serving path and the dispatch
edge give.
"""

import numpy as np
import pytest
import torch

from openvla_oft_tpu_torch.ops import int4_matmul as M
from openvla_oft_tpu_torch.ops.quant import quantize_weight_int4

# (name, K, N, group): the 7B's int4 linears (group 128), then the gpu tests'
# shapes, group 16 among them (d_in 4304).
SHAPES_7B = [("wqkv", 4096, 12288, 128), ("wo", 4096, 4096, 128),
             ("gate_up", 4096, 22016, 128), ("down", 11008, 4096, 128)]
SHAPES_SMALL = [("k512_n384", 512, 384, 128), ("k256_n200", 256, 200, 128),
                ("k256_n198", 256, 198, 128), ("k4304_n136", 4304, 136, 16),
                ("k1024_n512", 1024, 512, 128), ("k512_n200", 512, 200, 128)]
ROWS = [1, 57, 112, 256, 257, 618, 1024, 2048]


def _intervals(size: int, step: int, count: int):
    return [(i * step, min(size, (i + 1) * step)) for i in range(count)]


# kernel -> (plan, compiled t_tiles, output columns per CTA, stage depth)
PLANS = {"k5": (M._k5_plan, M.K5_T_TILES, M.K5_BN, M.K5_BK),
         "k6": (M._k6_plan, M.K6_T_TILES, M.K6_BN, M.K6_BK)}


@pytest.mark.parametrize("kernel", ["k5", "k6"])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("shape", SHAPES_7B + SHAPES_SMALL, ids=[s[0] for s in SHAPES_7B + SHAPES_SMALL])
def test_k5_plan_covers_the_output_once(shape, rows, kernel):
    _, k, n, group = shape
    plan, t_tiles, bn, bk = PLANS[kernel]
    t_tile, splits, grid = plan(rows, k, n, group)
    assert t_tile in t_tiles
    groups = k // group
    assert groups % splits == 0
    if splits > 1:                      # each split is whole stages
        assert (k // splits) % bk == 0
    chunks, ntiles = -(-rows // t_tile), -(-n // bn)
    assert grid == chunks * ntiles * splits
    # Rows, columns and depth are each cut into disjoint, non-empty ranges
    # that cover them, so every (t, n) is one tile's, over all of K once.
    for size, step, count in ((rows, t_tile, chunks), (n, bn, ntiles),
                              (k, k // splits, splits)):
        spans = _intervals(size, step, count)
        assert spans[0][0] == 0 and spans[-1][1] == size
        assert all(lo < hi for lo, hi in spans)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("kernel", ["k5", "k6"])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("shape", SHAPES_7B + SHAPES_SMALL, ids=[s[0] for s in SHAPES_7B + SHAPES_SMALL])
def test_plan_splits_only_below_one_wave(shape, rows, kernel):
    """A plan splits K only where its unsplit grid is under one wave of the
    card's SMs, and then into the fewest splits that fill the wave (or the
    most it can make, where none does)."""
    _, k, n, group = shape
    plan, _, bn, bk = PLANS[kernel]
    t_tile, splits, grid = plan(rows, k, n, group)
    unsplit = -(-rows // t_tile) * -(-n // bn)
    if unsplit >= M.K5_SMS:
        assert splits == 1
        return
    groups = k // group
    valid = [d for d in range(1, groups + 1)
             if groups % d == 0 and (d == 1 or (k // d) % bk == 0)]
    fill = [d for d in valid if unsplit * d >= M.K5_SMS]
    assert splits == (fill[0] if fill else valid[-1])


@pytest.mark.parametrize("kernel", ["k5", "k6"])
@pytest.mark.parametrize("shape", SHAPES_7B, ids=[s[0] for s in SHAPES_7B])
def test_k5_plan_fills_the_card_at_the_action_rows(shape, kernel):
    """At T = 57 (the out_window layer's rows) every 7B shape launches at
    least one wave of the card's 132 SMs."""
    _, k, n, group = shape
    assert PLANS[kernel][0](57, k, n, group)[2] >= M.K5_SMS


@pytest.mark.parametrize("d_in,group,ok", [(200, 100, False), (4304, 16, True),
                                           (256, 128, True)])
def test_group_rule_on_cpu_tensors(d_in, group, ok):
    """K5 and K6 take groups that are multiples of 16; the check the CUDA
    wrappers make, on CPU tensors."""
    q = quantize_weight_int4(torch.zeros((d_in, 32)))
    x = torch.zeros((3, d_in))
    found = M._check_weight("K5", x, q["kernel_q4"], q["scale_w4"])[2]
    assert found == group
    if ok:
        M._check_group("K5", found)
    else:
        with pytest.raises(ValueError, match="multiples of 16"):
            M._check_group("K5", found)


@pytest.mark.parametrize("t,k,n", [(57, 512, 384), (1, 256, 200), (33, 4304, 136)])
def test_cpu_path_is_the_plain_version(t, k, n):
    rng = np.random.default_rng(t + k + n)
    q = quantize_weight_int4(torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32))
    before = M.int4_matmul_fused.launches
    got = M.int4_matmul_fused(x, q["kernel_q4"], q["scale_w4"])
    assert M.int4_matmul_fused.launches == before      # no kernel on the CPU
    assert torch.equal(got, M.int4_matmul_ref(x, q["kernel_q4"], q["scale_w4"]))


# The K5 timing probe's plan (`ops/int4_probe.py::_probe_plan`): K5's machine,
# so K5's plan in no-scale and no-unpack; group-dots keeps a second
# accumulator set and compiles tiles of at most 128 rows.
PROBE_SHAPES = [("qkv", 4096, 12288, 128), ("gate_up", 4096, 22016, 128),
                ("down", 11008, 4096, 128), ("k4304_n136", 4304, 136, 16)]


@pytest.mark.parametrize("mode", ["no-scale", "no-unpack", "group-dots"])
@pytest.mark.parametrize("rows", [1, 33, 57, 112, 618])
@pytest.mark.parametrize("shape", PROBE_SHAPES, ids=[s[0] for s in PROBE_SHAPES])
def test_probe_plan(shape, rows, mode):
    """Tiles of at most 128 rows in group-dots (the same rule over them),
    K5's plan in the other modes, and whole groups in every split, each a
    whole number of 64-deep stages."""
    from openvla_oft_tpu_torch.ops.int4_probe import GROUP_DOTS_T_TILES, _probe_plan

    _, k, n, group = shape
    t_tile, splits, grid = _probe_plan(rows, k, n, group, mode)
    if mode == "group-dots":
        assert t_tile in GROUP_DOTS_T_TILES and max(GROUP_DOTS_T_TILES) == 128
        assert (t_tile, splits, grid) == M._k5_plan(rows, k, n, group, GROUP_DOTS_T_TILES)
    else:
        assert (t_tile, splits, grid) == M._k5_plan(rows, k, n, group)
    groups = k // group
    assert groups % splits == 0
    if splits > 1:
        assert (k // splits) % M.K5_BK == 0 and (k // splits) % group == 0
    assert grid == -(-rows // t_tile) * -(-n // M.K5_BN) * splits
