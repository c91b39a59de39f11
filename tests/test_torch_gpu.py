"""Tests of the port that need the card: kernels K1-K6 and the K5 timing
probe against their plain versions, and the tiny serving and training paths
through them against the dense or plain path, on CUDA.

This file imports nothing of JAX or the JAX package (the machine with the
card has no JAX), so it runs there on its own:
    python -m pytest --noconftest tests/test_torch_gpu.py -q
Every test is marked `gpu` and skips where torch sees no CUDA device.
"""

import numpy as np
import pytest
import torch

from openvla_oft_tpu_torch.ops import flash_attention as fa
from openvla_oft_tpu_torch.ops.attention import attention

torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions in full fp32
torch.backends.cudnn.allow_tf32 = False

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _strided_qkv(gen, b, s, h, hkv, d, device):
    """q/k/v as views of one fused projection output, as the Llama path has them."""
    qkv = torch.randn((b, s, (h + 2 * hkv) * d), generator=gen, device=device,
                      dtype=torch.float32).bfloat16()
    return (qkv[..., :h * d].view(b, s, h, d),
            qkv[..., h * d:(h + hkv) * d].view(b, s, hkv, d),
            qkv[..., (h + hkv) * d:].view(b, s, hkv, d))


# (b, s, h, hkv, d, left pads, window (start, len) or None, causal)
CASES = [
    (1, 618, 32, 32, 128, 24, (561, 57), True),     # LIBERO prefill
    (1, 1168, 8, 8, 128, 24, (817, 351), True),     # ALOHA length
    (2, 618, 32, 8, 128, 24, (561, 57), True),      # GQA, batch 2
    (1, 300, 4, 2, 64, 100, (200, 90), True),       # dead rows, an all-pad key tile
    (1, 130, 4, 4, 64, 0, (20, 100), True),         # window past a tile's diagonal
    (1, 77, 4, 4, 128, 5, None, False),             # non-causal, ragged tile
]


def _fwd_masks(b, s, rows, device):
    """key_valid, bidir (B, S) from one (first valid, last valid + 1, window
    start, len) per batch row."""
    key_valid = torch.zeros((b, s), dtype=torch.bool, device=device)
    bidir = torch.zeros((b, s), dtype=torch.bool, device=device)
    for i, (lo, hi, w0, wl) in enumerate(rows):
        key_valid[i, lo:hi] = True
        bidir[i, w0:w0 + wl] = True
    return key_valid, bidir


def _check_forward(q, k, v, causal, key_valid, bidir):
    """K1 (launched once) against its plain version: O within 2e-2 max and
    2e-3 mean, LSE within 1e-2 on rows with an allowed key; rows with none
    exactly 0."""
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal, key_valid, bidir)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal, key_valid, bidir)
    # Live rows: the query has at least one allowed key.
    live = fa._allow(q, causal, key_valid, bidir)[:, 0].any(-1)
    err = (o.float() - o_ref.float())[live].abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3
    assert (lse - lse_ref).transpose(1, 2)[live].abs().max().item() <= 1e-2
    assert torch.all(o[~live] == 0)
    assert torch.isfinite(o).all()
    return o, lse


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"s{c[1]}h{c[2]}kv{c[3]}d{c[4]}")
def test_kernel_matches_plain(cuda, case):
    b, s, h, hkv, d, pads, window, causal = case
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = _strided_qkv(gen, b, s, h, hkv, d, cuda)
    key_valid = torch.ones((b, s), dtype=torch.bool, device=cuda)
    key_valid[:, :pads] = False
    bidir = torch.zeros((b, s), dtype=torch.bool, device=cuda)
    if window is not None:
        bidir[:, window[0]:window[0] + window[1]] = True
    _check_forward(q, k, v, causal, key_valid, bidir)


# (b, s, h, hkv, d, [(first valid, last valid + 1, window start, len)] per row):
# the training batch's per-row right pads and windows at both head dims, and
# S = 40, below one 64-row tile (the CTA's second warpgroup has no rows).
FWD_CASES = [
    (8, 585, 32, 32, 128, [(0, 585 - 5 * i, 528 - 5 * i, 57) for i in range(8)]),
    (8, 585, 32, 8, 64, [(0, 585 - 5 * i, 528 - 5 * i, 57) for i in range(8)]),
    (2, 40, 4, 2, 128, [(0, 40, 30, 10), (3, 37, 27, 10)]),
]


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: "b{}s{}h{}kv{}d{}".format(*c[:5]))
def test_kernel_matches_plain_at_training_and_short_lengths(cuda, case):
    b, s, h, hkv, d, rows = case
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = _strided_qkv(gen, b, s, h, hkv, d, cuda)
    _check_forward(q, k, v, True, *_fwd_masks(b, s, rows, cuda))


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[5]],
                         ids=lambda c: f"s{c[1]}h{c[2]}kv{c[3]}d{c[4]}")
def test_kernel_is_deterministic(cuda, case):
    """Two K1 calls give bitwise-equal O and LSE: every sum runs in a fixed
    order, with no atomics."""
    b, s, h, hkv, d, pads, window, causal = case
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = _strided_qkv(gen, b, s, h, hkv, d, cuda)
    rows = [(pads, s) + (window or (0, 0))] * b
    key_valid, bidir = _fwd_masks(b, s, rows, cuda)
    first = fa.flash_attention_fwd(q, k, v, causal, key_valid, bidir)
    second = fa.flash_attention_fwd(q, k, v, causal, key_valid, bidir)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_kernel_first_called_on_a_fresh_thread(cuda):
    """K1 launched from a new host thread, as autograd's device thread runs
    it when remat recomputes the forward inside the backward: the entry binds
    the operands' device before it encodes its tensor maps."""
    import threading

    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = _strided_qkv(gen, 1, 130, 4, 4, 128, cuda)
    key_valid, bidir = _fwd_masks(1, 130, [(0, 130, 20, 100)], cuda)
    want = fa.flash_attention_fwd(q, k, v, True, key_valid, bidir)
    got, errors = [], []

    def run():
        try:
            got.append(fa.flash_attention_fwd(q, k, v, True, key_valid, bidir))
            torch.cuda.synchronize()
        except Exception as e:   # surfaced below, on the test's thread
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert not errors, errors
    assert torch.equal(got[0][0], want[0]) and torch.equal(got[0][1], want[1])


def test_kernel_copies_a_broadcast_operand(cuda):
    """A k broadcast over the sequence (a zero stride, which a TMA tensor map
    cannot take) is copied by the wrapper, and K1 gives the plain version's
    answer on it."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    q, _, v = _strided_qkv(gen, 1, 96, 4, 2, 64, cuda)
    k = torch.randn((1, 1, 2, 64), generator=gen, device=cuda).bfloat16().expand(1, 96, 2, 64)
    assert k.stride(1) == 0
    _check_forward(q, k, v, True, *_fwd_masks(1, 96, [(0, 96, 60, 30)], cuda))


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 64, 2, 128), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(q, q, q)
    qb = torch.zeros((1, 64, 2, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(qb, qb, qb)


def test_attention_auto_takes_the_kernel_on_cuda(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _strided_qkv(gen, 1, 96, 4, 4, 128, cuda)
    before = fa.flash_attention.launches
    out = attention(q, k, v, is_causal=True, use_flash="auto", bidir_block=(60, 30))
    dense = attention(q, k, v, is_causal=True, use_flash=False, bidir_block=(60, 30))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert (out.float() - dense.float()).abs().max().item() <= 2e-2


def _tiny_cfg():
    """TINY vision towers and a 3-layer Llama with head_dim 128 (K1 takes 64 or 128)."""
    import openvla_oft_tpu_torch.config as C

    llm = C.LlamaConfig(vocab_size=32064, hidden_size=256, intermediate_size=512,
                        num_layers=3, num_heads=2, num_kv_heads=2)
    C._LLM_REGISTRY.setdefault("gpu-test-llama", llm)
    C._VISION_REGISTRY.setdefault("tiny-dual", (C.TINY_DINOV2, C.TINY_SIGLIP))
    return C.OpenVLAConfig(vision_backbone_id="tiny-dual",
                           llm_backbone_id="gpu-test-llama", num_images_in_input=2)


def test_tiny_serving_path_flash_matches_dense(cuda):
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy
    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.constants import LIBERO

    cfg = _tiny_cfg()
    params = init_params(cfg, LIBERO, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    frames = (rng.random((2, 40, 40, 3)) * 255).astype(np.uint8)
    out = {}
    for use_flash in (True, False):
        pol = OpenVLAPolicy(cfg=cfg, platform=LIBERO, params=params,
                            norm_stats=placeholder_norm_stats(LIBERO),
                            prompt_bucket=32, use_flash=use_flash)
        before = fa.flash_attention.launches
        out[use_flash] = pol.predict_action_from_frames(frames, "open the drawer")
        assert fa.flash_attention.launches - before == (2 if use_flash else 0)
    assert out[True].shape == (LIBERO.num_actions_chunk, LIBERO.action_dim)
    assert np.abs(out[True] - out[False]).max() < 0.1


def _cosine(a, b):
    return torch.nn.functional.cosine_similarity(a.float().flatten(),
                                                 b.float().flatten(), dim=0).item()


def _rel_err(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


# (b, s, h, hkv, d, causal, [(first valid, last valid + 1, window start, len)] per row)
BWD_CASES = [
    (2, 585, 8, 8, 128, True, [(0, 585, 528, 57), (0, 560, 503, 57)]),   # training, right pads
    (1, 1168, 4, 4, 128, True, [(0, 1168, 817, 351)]),                   # ALOHA length
    (2, 300, 8, 2, 128, True, [(0, 300, 200, 57), (0, 270, 150, 90)]),   # GQA
    (1, 300, 4, 4, 64, True, [(100, 300, 200, 90)]),                     # dead rows, pad key tile
    (1, 130, 4, 4, 64, True, [(0, 130, 20, 100)]),                       # window past a diagonal
    (1, 77, 4, 2, 128, False, [(5, 77, 0, 0)]),                          # non-causal, ragged
]


def _bwd_inputs(case, device):
    b, s, h, hkv, d, causal, rows = case
    gen = torch.Generator(device=device).manual_seed(s + h)
    q, k, v = _strided_qkv(gen, b, s, h, hkv, d, device)
    # dO as a strided view too: autograd may hand the kernels either layout.
    big = torch.randn((b, s, h * d + 8), generator=gen, device=device).bfloat16()
    do = big[..., :h * d].view(b, s, h, d)
    key_valid = torch.zeros((b, s), dtype=torch.bool, device=device)
    bidir = torch.zeros((b, s), dtype=torch.bool, device=device)
    for i, (lo, hi, w0, wl) in enumerate(rows):
        key_valid[i, lo:hi] = True
        bidir[i, w0:w0 + wl] = True
    return q, k, v, do, causal, key_valid, bidir


def _check_backward_kernels(q, k, v, do, causal, key_valid, bidir):
    """K2 then K3 (each launched once) against the plain backward."""
    o, lse = fa.flash_attention_fwd(q, k, v, causal, key_valid, bidir)
    args = (q, k, v, o, lse, do, causal, key_valid, bidir)
    n_dq, n_dkv = fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches
    dq = fa.flash_attention_dq(*args)
    dk, dv = fa.flash_attention_dkv(*args)
    torch.cuda.synchronize()
    assert fa.flash_attention_dq.launches == n_dq + 1
    assert fa.flash_attention_dkv.launches == n_dkv + 1
    refs = fa.flash_attention_bwd_ref(*args)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert torch.isfinite(got).all(), name
        assert _rel_err(got, ref) <= 2e-2, (name, _rel_err(got, ref))
        assert _cosine(got, ref) >= 0.999, (name, _cosine(got, ref))
    # Dead query rows (no allowed key) and invalid key rows are exactly 0.
    allow = fa._allow(q, causal, key_valid, bidir)[:, 0]
    dead = ~allow.any(-1)
    assert torch.all(dq[dead] == 0)
    assert torch.all(dk[~key_valid] == 0) and torch.all(dv[~key_valid] == 0)


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: f"b{c[0]}s{c[1]}h{c[2]}kv{c[3]}d{c[4]}")
def test_backward_kernels_match_plain(cuda, case):
    _check_backward_kernels(*_bwd_inputs(case, cuda))


# (b, s, h, hkv, d): below one 64-row tile and the training length, at both
# head dims, with per-row right pads and a window of the last slots.
BWD_LENGTHS = [(2, 40, 4, 2, 64), (2, 40, 4, 4, 128), (1, 585, 8, 8, 64), (1, 585, 8, 2, 128)]


def _length_case(shape):
    b, s, h, hkv, d = shape
    wl = min(57, s // 4)
    rows = [(0, s - 3 * i, s - 3 * i - wl, wl) for i in range(b)]
    return (b, s, h, hkv, d, True, rows)


@pytest.mark.parametrize("shape", BWD_LENGTHS, ids=lambda c: "b{}s{}h{}kv{}d{}".format(*c))
def test_backward_kernels_match_plain_at_short_and_training_lengths(cuda, shape):
    _check_backward_kernels(*_bwd_inputs(_length_case(shape), cuda))


@pytest.mark.parametrize("case", [BWD_CASES[0], BWD_CASES[2], BWD_CASES[3], BWD_CASES[5]],
                         ids=lambda c: f"b{c[0]}s{c[1]}h{c[2]}kv{c[3]}d{c[4]}")
def test_backward_kernels_are_deterministic(cuda, case):
    """Two calls of K2 and of K3 give bitwise-equal dq, dk and dv: every sum
    runs in a fixed order, with no atomics."""
    q, k, v, do, causal, key_valid, bidir = _bwd_inputs(case, cuda)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, key_valid, bidir)
    args = (q, k, v, o, lse, do, causal, key_valid, bidir)
    first = (fa.flash_attention_dq(*args),) + fa.flash_attention_dkv(*args)
    second = (fa.flash_attention_dq(*args),) + fa.flash_attention_dkv(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def _bwd_counts():
    return (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches,
            fa.flash_attention_dkv.stats_launches)


def test_autograd_backward_launches_k2_then_k3_once(cuda):
    """The op's backward launches K2 once (dq and the stats rows) and K3 once
    on those rows, with no stats pass; its gradients are bitwise those of
    the standalone calls, which run in either order (K3 alone runs the stats
    pass first). The first autograd test of the file: its backward is the
    first work of autograd's device thread, where the tensor-map encoder
    refused K2's operands until the entries bound the tensors' device."""
    q, k, v, do, causal, key_valid, bidir = _bwd_inputs(BWD_CASES[2], cuda)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, is_causal=causal, key_valid=key_valid, bidir_mask=bidir)
    before = _bwd_counts()
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_bwd_counts(), before)] == [1, 1, 0]
    o, lse = fa.flash_attention_fwd(q, k, v, causal, key_valid, bidir)
    args = (q, k, v, o, lse, do, causal, key_valid, bidir)
    for name, g, r in zip("qkv", grads, fa.flash_attention_bwd_ref(*args)):
        assert _rel_err(g, r) <= 2e-2 and _cosine(g, r) >= 0.999, name
    for order in ("dkv first", "dq first"):
        before = _bwd_counts()
        if order == "dkv first":
            dk, dv = fa.flash_attention_dkv(*args)
            dq = fa.flash_attention_dq(*args)
        else:
            dq = fa.flash_attention_dq(*args)
            dk, dv = fa.flash_attention_dkv(*args)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_bwd_counts(), before)] == [1, 1, 1], order
        for name, a, b in zip("qkv", (dq, dk, dv), grads):
            assert torch.equal(a, b), (order, name)


def test_autograd_backward_reads_a_transposed_grad(cuda):
    """dO as autograd hands it through a transpose (strides of a (B, H, S, D)
    tensor) is read through its strides and gives the plain backward's
    gradients."""
    q, k, v, _, causal, key_valid, bidir = _bwd_inputs(BWD_CASES[0], cuda)
    b, s, h, d = q.shape
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn((b, h, s, d), generator=gen, device=cuda).bfloat16()
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, is_causal=causal, key_valid=key_valid, bidir_mask=bidir)
    (out.transpose(1, 2) * w).sum().backward()
    do = w.transpose(1, 2)
    assert not do.is_contiguous()
    o, lse = fa.flash_attention_fwd(q, k, v, causal, key_valid, bidir)
    refs = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, key_valid, bidir)
    for name, t, r in zip("qkv", leaves, refs):
        assert _rel_err(t.grad, r) <= 2e-2 and _cosine(t.grad, r) >= 0.999, name


def test_autograd_op_matches_dense_on_cuda(cuda):
    """The op's gradients through K1/K2/K3 against torch autograd through the
    dense path, with the loss read only on rows that have an allowed key."""
    q, k, v, do, causal, key_valid, bidir = _bwd_inputs(BWD_CASES[2], cuda)
    live = fa._allow(q, causal, key_valid, bidir)[:, 0].any(-1)
    grads = {}
    for use_flash in (True, False):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = attention(*leaves, is_causal=causal, use_flash=use_flash,
                        key_valid=key_valid, bidir_mask=bidir)
        (out.float() * do.float() * live[..., None, None]).sum().backward()
        grads[use_flash] = [t.grad for t in leaves]
    for name, a, b in zip("qkv", grads[True], grads[False]):
        assert _cosine(a, b) >= 0.999, (name, _cosine(a, b))


def _launch_counts():
    return (fa.flash_attention.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches)


def test_tiny_train_step_flash_matches_dense(cuda):
    """The L1 loss of a tiny model in bf16 through K1/K2/K3 and through the
    dense path agrees within 1e-2 relative; its backward launches K1 twice
    per layer under remat "all" (the forward and its recompute), K2 and K3
    once, and each trainable group's gradient reaches cosine >= 0.99.

    The gradients are taken with every target action set to 10, above the
    head's outputs: the L1 gradient is sign(residual), and at these widths
    bf16 noise between the two paths can flip the sign of a residual near 0,
    which alone moves the cosine by 2/112 (measured: 0.983)."""
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.data.collator import PaddedCollatorForActionPrediction
    from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer
    from openvla_oft_tpu_torch.bridge import init_params, split_base_trainables, tree_leaves
    from openvla_oft_tpu_torch.data.datasets import DummyDataset, RLDSBatchTransform
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor
    from openvla_oft_tpu_torch.training import train_step as TT

    cfg = _tiny_cfg()
    params = init_params(cfg, LIBERO, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda, dtype=torch.bfloat16, head_dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(1)
    base, trainables = split_base_trainables(params, gen, lora_rank=4)
    with torch.no_grad():          # a non-zero B, so every gradient is non-zero
        for b in _lora_b(trainables["lora"]):
            b.normal_(0.0, 0.02, generator=gen)
    data = DummyDataset(RLDSBatchTransform(PrismaticProcessor(cfg), ActionTokenizer(), LIBERO),
                        image_size=cfg.vision_configs[0].image_size, num_samples=2,
                        num_images=2)
    batch = PaddedCollatorForActionPrediction(pad_token_id=cfg.pad_token_id)(list(data))
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in batch.items()
             if isinstance(v, np.ndarray)}
    far = dict(batch, actions=torch.full_like(batch["actions"], 10.0))
    tcfg = TT.TrainConfig(lora_rank=4, lora_alpha=4.0)
    n = cfg.llm.num_layers
    loss, grads = {}, {}
    for use_flash in (True, False):
        with torch.no_grad():
            loss[use_flash] = TT.loss_and_metrics(trainables, base, batch, cfg, LIBERO, tcfg,
                                                  use_flash=use_flash)[0].item()
        before = _launch_counts()
        far_loss, _ = TT.loss_and_metrics(trainables, base, far, cfg, LIBERO, tcfg,
                                          use_flash=use_flash)
        grads[use_flash] = torch.autograd.grad(far_loss, tree_leaves(trainables))
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(_launch_counts(), before)]
        assert launched == ([2 * n, n, n] if use_flash else [0, 0, 0])
    assert np.isfinite(loss[True])
    assert abs(loss[True] - loss[False]) <= 1e-2 * abs(loss[False])
    start = 0
    for group in trainables.values():
        stop = start + len(tree_leaves(group))
        flat = [torch.cat([g.flatten() for g in grads[f][start:stop]]) for f in (True, False)]
        assert _cosine(*flat) >= 0.99
        start = stop


def _lora_b(tree):
    for key, node in tree.items():
        if key == "b":
            yield node
        elif isinstance(node, dict):
            yield from _lora_b(node)


def test_allheads_is_k1_on_cuda(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = _strided_qkv(gen, 2, 200, 4, 2, 128, cuda)
    before = fa.flash_attention.launches
    out = fa.flash_attention_allheads(q, k, v, is_causal=True, bidir_block=(140, 57))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    bidir = torch.zeros((2, 200), dtype=torch.bool, device=cuda)
    bidir[:, 140:197] = True
    ref, _ = fa.flash_attention_ref(q, k, v, True, torch.ones_like(bidir), bidir)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


# --- K5 (W4A16) and K6 (W4A8) --------------------------------------------------

def _int4_weight(gen, k, n, device, layers=None, group=128):
    from openvla_oft_tpu_torch.ops.quant import quantize_weight_int4

    shape = (k, n) if layers is None else (layers, k, n)
    w = torch.randn(shape, generator=gen, device=device) * 0.02
    return quantize_weight_int4(w, group=group)


# (name, T, K, N, group, how the weight is handed over)
INT4_CASES = [
    ("T37", 37, 512, 384, 128, "whole"),
    ("T1", 1, 512, 256, 128, "whole"),
    ("N200", 64, 256, 200, 128, "whole"),        # ragged column tile, 4-byte words
    ("N198", 70, 256, 198, 128, "whole"),        # odd words: byte loads
    ("group16", 33, 4304, 136, 128, "whole"),    # d_in 4304 -> group 16
    ("layer_view", 57, 1024, 512, 128, "layer"),
    ("column_view", 57, 1024, 384, 128, "column"),
    ("T1024", 1024, 256, 256, 128, "whole"),
    ("T57_K4096_N4096", 57, 4096, 4096, 128, "whole"),   # K5 splits K (8 ways)
    ("T256", 256, 512, 384, 128, "whole"),                # one chunk of x's rows
    ("T257", 257, 512, 384, 128, "whole"),                # the chunk edge
    ("T618_K1024", 618, 1024, 1024, 128, "whole"),
    ("column_view_200_400", 70, 512, 200, 128, "column200"),   # base not 16-byte aligned
    ("N198_T300", 300, 256, 198, 128, "whole"),           # byte copies of the packed rows
]


def _int4_operands(cuda, case):
    name, t, k, n, group, how = case
    gen = torch.Generator(device=cuda).manual_seed(t + k + n)
    x = torch.randn((t, k), generator=gen, device=cuda).bfloat16()
    if how == "layer":
        q = _int4_weight(gen, k, n, cuda, layers=2, group=group)
        return x, q["kernel_q4"][1], q["scale_w4"][1]
    if how == "column":                            # the q slice of a q|k|v weight
        q = _int4_weight(gen, k, 3 * n, cuda, group=group)
        return x, q["kernel_q4"][:, n:2 * n], q["scale_w4"][:, n:2 * n]
    if how == "column200":                         # packed[:, 200:400] of a 600-wide weight
        q = _int4_weight(gen, k, 600, cuda, group=group)
        return x, q["kernel_q4"][:, 200:400], q["scale_w4"][:, 200:400]
    q = _int4_weight(gen, k, n, cuda, group=group)
    return x, q["kernel_q4"], q["scale_w4"]


@pytest.mark.parametrize("case", INT4_CASES, ids=[c[0] for c in INT4_CASES])
def test_int4_kernels_match_plain(cuda, case):
    """K5 within 1e-3 of max|ref| (the same bf16 products, summed in another
    order) and K6 within 1e-4 (exact int32 group products), at the view
    layouts the LLM hands them."""
    from openvla_oft_tpu_torch.ops import int4_matmul as M

    x, packed, scales = _int4_operands(cuda, case)
    for fn, ref_fn, bound in ((M.int4_matmul_fused, M.int4_matmul_ref, 1e-3),
                              (M.int4_matmul_fused_a8, M.int4_matmul_a8_ref, 1e-4)):
        before = fn.launches
        got = fn(x, packed, scales)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref = ref_fn(x, packed, scales)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert torch.isfinite(got).all()
        assert _rel_err(got, ref) <= bound, (fn.__name__, _rel_err(got, ref))


def test_int4_kernels_reject_what_they_do_not_take(cuda):
    from openvla_oft_tpu_torch.ops import int4_matmul as M

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _int4_weight(gen, 256, 128, cuda)
    x = torch.randn((4, 256), device=cuda)
    with pytest.raises(ValueError, match="do not fit"):
        M.int4_matmul_fused(x[:, :128], q["kernel_q4"], q["scale_w4"])
    with pytest.raises(ValueError, match="contiguous rows"):
        M.int4_matmul_fused(x, q["kernel_q4"].t().contiguous().t(), q["scale_w4"])
    w = _int4_weight(gen, 200, 64, cuda)                 # group 100
    for fn in (M.int4_matmul_fused, M.int4_matmul_fused_a8):
        before = fn.launches
        with pytest.raises(ValueError, match="multiples of 16"):
            fn(torch.randn((4, 200), device=cuda), w["kernel_q4"], w["scale_w4"])
        assert fn.launches == before


# K5 and K6 at a split-K shape (wo at the out_window layer's 57 rows) and at
# wqkv's shape at T = 618 (chunks of x's rows, no split).
@pytest.mark.parametrize("kernel", ["k5", "k6"])
@pytest.mark.parametrize("t,k,n", [(57, 4096, 4096), (618, 4096, 12288)],
                         ids=["wo_T57_split", "wqkv_T618"])
def test_int4_k5_is_deterministic(cuda, t, k, n, kernel):
    from openvla_oft_tpu_torch.ops import int4_matmul as M

    x, packed, scales = _int4_operands(cuda, ("det", t, k, n, 128, "whole"))
    plan, fn = ((M._k5_plan, M.int4_matmul_fused) if kernel == "k5"
                else (M._k6_plan, M.int4_matmul_fused_a8))
    t_tile, splits, grid = plan(t, k, n, 128)
    assert (splits > 1) == (t == 57)
    first = fn(x, packed, scales)
    second = fn(x, packed, scales)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_tiny_int4_serving_path_kernel_matches_plain(cuda):
    """A tiny model with an int4 LLM through the kernels, against the same
    model through the plain versions (the kernels' wrappers on CPU tensors
    would take them; here they are swapped in on the card): W4A16 and W4A8,
    4 launches per layer and 6 in the window layer."""
    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.ops import int4_matmul as M
    from openvla_oft_tpu_torch.ops.quant import quantize_tree
    from openvla_oft_tpu_torch.models.llama import fuse_inference_weights
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats

    cfg = _tiny_cfg()
    params = init_params(cfg, LIBERO, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda, dtype=torch.bfloat16)
    params["llm"] = quantize_tree(fuse_inference_weights(params["llm"], fold_norms=False),
                                  min_dim=256, bits=4)
    rng = np.random.default_rng(0)
    frames = (rng.random((2, 40, 40, 3)) * 255).astype(np.uint8)
    n = cfg.llm.num_layers
    for a8, fn, ref_fn in ((False, "int4_matmul_fused", "int4_matmul_ref"),
                           (True, "int4_matmul_fused_a8", "int4_matmul_a8_ref")):
        pol = OpenVLAPolicy(cfg=cfg, platform=LIBERO, params=params,
                            norm_stats=placeholder_norm_stats(LIBERO), prompt_bucket=32,
                            int4_a8=a8)
        kernel = getattr(M, fn)
        before = kernel.launches
        got = pol.predict_action_from_frames(frames, "open the drawer")
        assert kernel.launches - before == 4 * (n - 1) + 6
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(M, fn, getattr(M, ref_fn))
            plain = pol.predict_action_from_frames(frames, "open the drawer")
        assert np.isfinite(got).all() and np.abs(got - plain).max() < 0.05, (fn, got - plain)


# --- K4 (ln_matmul) -----------------------------------------------------------

# (name, M, D, N, act): the 8 ViT serving shapes (DINOv2 rows 783 / 522,
# SigLIP 768 / 512 at ALOHA / LIBERO) with the activations the ViTs use,
# then a ragged M and N with each activation, and a D and N off the 8-wide
# vector loads.
LN_CASES = [
    (f"{vit}_{proj}_{deploy}", m, d, n, act)
    for deploy, rows in (("aloha", (783, 768)), ("libero", (522, 512)))
    for vit, m, d, projs in (("dinov2", rows[0], 1024, ((3072, None), (4096, "gelu"))),
                             ("siglip", rows[1], 1152, ((3456, None), (4304, "gelu_tanh"))))
    for proj, (n, act) in zip(("qkv", "fc1"), projs)
] + [(f"m37_n200_{act}", 37, 1024, 200, act) for act in (None, "gelu", "gelu_tanh", "quick_gelu")
     ] + [("d52_n198", 37, 52, 198, "quick_gelu")]


def _ln_operands(gen, m, d, n, device, layers=None, large_mean=False):
    """x, w, b in bf16. large_mean: rows with mean / std about 20, and every
    97th row a high-norm token with three channels at +-100, as DINOv2's
    residual stream has them."""
    if large_mean:
        x = torch.randn((m, d), generator=gen, device=device) + 20.0
        rows = torch.arange(5, m, 97, device=device)
        for ch, v in ((3, 100.0), (250, -100.0), (700, 100.0)):
            x[rows, ch] = v
        x = x.bfloat16()
    else:
        x = (torch.randn((m, d), generator=gen, device=device) * 1.5 + 0.3).bfloat16()
    w = torch.randn((d, n) if layers is None else (layers, d, n), generator=gen, device=device)
    b = torch.randn((n,), generator=gen, device=device) * 0.1
    return x, (w * d ** -0.5).bfloat16(), b.bfloat16()


def _check_ln(got, ref):
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert torch.isfinite(got).all()
    # One bf16 rounding; the fp32 sums differ in order.
    assert _rel_err(got, ref) <= 1e-2 and _cosine(got, ref) >= 0.9999, \
        (_rel_err(got, ref), _cosine(got, ref))


@pytest.mark.parametrize("case", LN_CASES, ids=[c[0] for c in LN_CASES])
def test_ln_matmul_kernel_matches_plain(cuda, case):
    from openvla_oft_tpu_torch.ops import vit_fused as VF

    _, m, d, n, act = case
    x, w, b = _ln_operands(torch.Generator(device=cuda).manual_seed(m + d + n), m, d, n, cuda)
    before = VF.ln_matmul.launches
    got = VF.ln_matmul(x, w, b, act)
    torch.cuda.synchronize()
    assert VF.ln_matmul.launches == before + 1
    _check_ln(got, VF.ln_matmul_ref(x, w, b, act))


def test_ln_matmul_kernel_on_a_layer_view_without_bias(cuda):
    """w = layer 1 of a stacked (2, D, N) kernel, x batched (3, 261, D), as a
    ViT block hands them over."""
    from openvla_oft_tpu_torch.ops import vit_fused as VF

    x, w, _ = _ln_operands(torch.Generator(device=cuda).manual_seed(5), 783, 1024, 3072,
                           cuda, layers=2)
    x = x.view(3, 261, 1024)
    got = VF.ln_matmul(x, w[1], None, "gelu")
    torch.cuda.synchronize()
    assert got.shape == (3, 261, 3072)
    _check_ln(got, VF.ln_matmul_ref(x, w[1], None, "gelu"))


def test_ln_matmul_kernel_on_large_mean_rows(cuda):
    """DINOv2's fc1 at ALOHA on rows whose mean is about 20 standard
    deviations, with high-norm tokens: the statistics' E[x^2] - mean^2
    cancels most of its digits, under the same bounds."""
    from openvla_oft_tpu_torch.ops import vit_fused as VF

    x, w, b = _ln_operands(torch.Generator(device=cuda).manual_seed(8), 783, 1024, 4096, cuda,
                           large_mean=True)
    got = VF.ln_matmul(x, w, b, "gelu")
    torch.cuda.synchronize()
    _check_ln(got, VF.ln_matmul_ref(x, w, b, "gelu"))


@pytest.mark.parametrize("case", [c for c in LN_CASES if c[0] in
                                  ("dinov2_fc1_aloha", "siglip_fc1_libero", "m37_n200_gelu")],
                         ids=lambda c: c[0])
def test_ln_matmul_kernel_is_deterministic(cuda, case):
    """Two calls give bitwise-equal outputs (no atomics, fixed sum order)."""
    from openvla_oft_tpu_torch.ops import vit_fused as VF

    _, m, d, n, act = case
    x, w, b = _ln_operands(torch.Generator(device=cuda).manual_seed(m + d + n), m, d, n, cuda)
    first = VF.ln_matmul(x, w, b, act)
    again = VF.ln_matmul(x, w, b, act)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.parametrize("case", LN_CASES, ids=[c[0] for c in LN_CASES])
def test_ln_matmul_launch_takes_the_plan(cuda, case):
    """The launch runs the tile and grid that `_k4_plan` gives its shape."""
    from openvla_oft_tpu_torch.ops import vit_fused as VF

    _, m, d, n, act = case
    x, w, b = _ln_operands(torch.Generator(device=cuda).manual_seed(m + d + n), m, d, n, cuda)
    VF.ln_matmul(x, w, b, act)
    torch.cuda.synchronize()
    assert VF.ln_matmul.last_plan == VF._k4_plan(m, d, n)
    bm, bn, ctas = VF.ln_matmul.last_plan
    assert (bm, bn) in VF.K4_TILES and ctas == -(-m // bm) * -(-n // bn)


def test_ln_matmul_kernel_rejects_what_it_does_not_take(cuda):
    from openvla_oft_tpu_torch.ops import vit_fused as VF

    w = torch.zeros((64, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        VF.ln_matmul(torch.zeros((4, 64), device=cuda), w, None)
    with pytest.raises(ValueError, match="contiguous rows"):
        VF.ln_matmul(torch.zeros((4, 64), device=cuda, dtype=torch.bfloat16),
                     w.t().contiguous().t(), None)


# --- the K5 timing probe ------------------------------------------------------

# (name, T, K, N): the probe's T, a ragged T and N, group 16 with K not a
# multiple of 64 (d_in 4304), and qkv's width at T = 57, where the plan splits
# K (2 ways).
PROBE_CASES = [("T112", 112, 1024, 384), ("T37_N200", 37, 512, 200), ("group16", 33, 4304, 136),
               ("T57_qkv_split", 57, 4096, 12288)]


@pytest.mark.parametrize("mode", ["no-scale", "no-unpack", "group-dots"])
@pytest.mark.parametrize("case", PROBE_CASES, ids=[c[0] for c in PROBE_CASES])
def test_probe_kernel_matches_plain(cuda, case, mode):
    from openvla_oft_tpu_torch.ops.int4_probe import int4_probe, int4_probe_ref

    _, t, k, n = case
    gen = torch.Generator(device=cuda).manual_seed(t + k + n)
    x = torch.randn((t, k), generator=gen, device=cuda).bfloat16()
    q = _int4_weight(gen, k, n, cuda)
    before = int4_probe.launches
    got = int4_probe(x, q["kernel_q4"], q["scale_w4"], mode)
    torch.cuda.synchronize()
    assert int4_probe.launches == before + 1
    ref = int4_probe_ref(x, q["kernel_q4"], q["scale_w4"], mode)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.isfinite(got).all()
    assert _rel_err(got, ref) <= 1e-3, (mode, _rel_err(got, ref))


def test_probe_rejects_groups_that_are_not_multiples_of_16(cuda):
    """Every mode runs K5's machine, which takes groups of whole k16 steps."""
    from openvla_oft_tpu_torch.ops.int4_probe import MODES, int4_probe

    w = _int4_weight(torch.Generator(device=cuda).manual_seed(0), 200, 64, cuda)   # group 100
    for mode in MODES:
        before = int4_probe.launches
        with pytest.raises(ValueError, match="multiples of 16"):
            int4_probe(torch.randn((4, 200), device=cuda), w["kernel_q4"], w["scale_w4"], mode)
        assert int4_probe.launches == before


# K5 at the 7B's int4 shapes and the probe's T, through the dequant policy
# that K5 now shares with the probe (`csrc/int4_w4a16.cuh`, Dequant<SCALED>).
@pytest.mark.parametrize("t", [57, 112])
@pytest.mark.parametrize("k,n", [(4096, 12288), (11008, 4096)], ids=["qkv", "down"])
def test_k5_scaled_policy_matches_plain_and_repeats(cuda, t, k, n):
    from openvla_oft_tpu_torch.ops import int4_matmul as M

    x, packed, scales = _int4_operands(cuda, ("k5", t, k, n, 128, "whole"))
    first = M.int4_matmul_fused(x, packed, scales)
    again = M.int4_matmul_fused(x, packed, scales)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.isfinite(first).all()
    assert _rel_err(first, M.int4_matmul_ref(x, packed, scales)) <= 1e-3


# --- "auto" where K1 does not take the call -----------------------------------

def _stock_tiny_cfg():
    """The configuration of `--vla_path random:tiny`: the stock TINY_LLAMA,
    head_dim 16, which K1 does not take."""
    from openvla_oft_tpu_torch.training.finetune import model_config, parse_config

    return model_config(parse_config(["--vla_path", "random:tiny"]))


def test_auto_serves_a_head_dim_16_policy_through_the_dense_path(cuda):
    """A TINY_LLAMA policy on the card under "auto" launches no K1 and gives
    the use_flash=False actions; use_flash=True asks for K1, which raises."""
    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats

    cfg = _stock_tiny_cfg()
    assert cfg.llm.head_dim == 16
    params = init_params(cfg, LIBERO, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda, dtype=torch.bfloat16)
    frames = (np.random.default_rng(0).random((2, 40, 40, 3)) * 255).astype(np.uint8)
    out = {}
    for use_flash in ("auto", False, True):
        pol = OpenVLAPolicy(cfg=cfg, platform=LIBERO, params=params,
                            norm_stats=placeholder_norm_stats(LIBERO), prompt_bucket=32,
                            use_flash=use_flash)
        before = fa.flash_attention.launches
        if use_flash is True:
            with pytest.raises(ValueError, match="head_dim"):
                pol.predict_action_from_frames(frames, "open the drawer")
            continue
        out[use_flash] = pol.predict_action_from_frames(frames, "open the drawer")
        assert fa.flash_attention.launches == before
    assert np.isfinite(out["auto"]).all()
    np.testing.assert_allclose(out["auto"], out[False], rtol=0, atol=1e-5)


def test_auto_trains_a_random_tiny_step_through_the_dense_path(cuda, tmp_path):
    """One step of the fine-tuning CLI at `--vla_path random:tiny` on the card:
    under "auto" no K1, K2 or K3 launches, and the loss is use_flash=False's."""
    from openvla_oft_tpu_torch.training import finetune as FT

    losses = {}
    for flag in ("auto", "false"):
        seen = []
        before = _launch_counts()
        FT.main(["--vla_path", "random:tiny", "--data_root_dir", "dummy",
                 "--robot_platform", "libero", "--use_l1_regression", "True",
                 "--use_proprio", "True", "--num_images_in_input", "2", "--lora_rank", "4",
                 "--batch_size", "2", "--max_steps", "1", "--merge_lora_during_training",
                 "False", "--device", "cuda", "--use_flash_attention", flag,
                 "--run_root_dir", str(tmp_path / flag)],
                on_step=lambda step, m, state: seen.append(m["loss"]))
        torch.cuda.synchronize()
        assert _launch_counts() == before
        losses[flag] = seen
    assert len(losses["auto"]) == 1 and np.isfinite(losses["auto"][0])
    assert losses["auto"][0] == pytest.approx(losses["false"][0], rel=1e-6)


# --- ALOHA serving (3 images, FiLM) with K4 on the ViTs ------------------------

def test_tiny_aloha_serving_vit_fused_matches_unfused(cuda):
    """A tiny ALOHA model (3 images, FiLM, 25 x 14 chunk) with folded ViTs:
    through K4 (two launches per ViT block that runs) against the separate
    LN, linear and activation."""
    import dataclasses

    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.constants import ALOHA
    from openvla_oft_tpu_torch.ops import vit_fused as VF
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats, serving_params

    cfg = dataclasses.replace(_tiny_cfg(), num_images_in_input=3, use_film=True)
    params = serving_params(init_params(cfg, ALOHA, torch.Generator(device=cuda).manual_seed(0),
                                        device=cuda, dtype=torch.bfloat16))
    rng = np.random.default_rng(0)
    frames = (rng.random((3, 28, 28, 3)) * 255).astype(np.uint8)
    blocks = sum(v.depth - 1 for v in cfg.vision_configs)
    out = {}
    for vit_fused in (True, False):
        pol = OpenVLAPolicy(cfg=cfg, platform=ALOHA, params=params,
                            norm_stats=placeholder_norm_stats(ALOHA), prompt_bucket=32,
                            vit_fused=vit_fused)
        before = VF.ln_matmul.launches
        out[vit_fused] = pol.predict_action_from_frames(frames, "fold the towel",
                                                        proprio=np.zeros(14, np.float32))
        assert VF.ln_matmul.launches - before == (2 * blocks if vit_fused else 0)
    assert out[True].shape == (ALOHA.num_actions_chunk, ALOHA.action_dim) == (25, 14)
    assert np.isfinite(out[True]).all() and np.abs(out[True] - out[False]).max() < 0.1


# --- int8 W8A8 (torch._int_mm) ------------------------------------------------

# (name, K, N): every int8 linear of the flagship under load_in_8bit.
INT8_SHAPES = [("llm wqkv", 4096, 12288), ("llm wo", 4096, 4096), ("llm gate_up", 4096, 22016),
               ("llm down", 11008, 4096), ("dinov2 qkv", 1024, 3072), ("dinov2 fc1", 1024, 4096),
               ("dinov2 fc2", 4096, 1024), ("siglip qkv", 1152, 3456),
               ("siglip fc1", 1152, 4304), ("siglip fc2", 4304, 1152),
               ("projector fc1", 2176, 8704), ("projector fc2", 8704, 4096),
               ("projector fc3", 4096, 4096)]


@pytest.mark.parametrize("t", [618, 57, 5], ids=["T618", "T57", "T5-padded"])
@pytest.mark.parametrize("name,k,n", INT8_SHAPES, ids=[s[0] for s in INT8_SHAPES])
def test_int8_linear_card_matches_cpu(cuda, name, k, n, t):
    """The same weights and bf16 inputs through int8_linear on the card and
    on the CPU: the weight codes and scales quantized on the card equal the
    CPU's, the int32 products are equal (exact on both), and the outputs
    agree within 1e-6 relative (one fp32 epilogue on equal sums)."""
    from openvla_oft_tpu_torch.ops import quant as Q

    gen = torch.Generator().manual_seed(k + n + t)
    w = torch.randn((k, n), generator=gen) * 0.02
    x = torch.randn((t, k), generator=gen).bfloat16()
    q_cpu = Q.quantize_weight(w)
    q_card = Q.quantize_weight(w.to(cuda))
    assert q_card["kernel"].stride() == (1, k)
    assert torch.equal(q_card["kernel"].cpu(), q_cpu["kernel"])
    assert torch.equal(q_card["scale_w"].cpu(), q_cpu["scale_w"])
    x8, _ = Q.quantize_act_rows(x)
    x8_card, _ = Q.quantize_act_rows(x.to(cuda))
    assert torch.equal(x8_card.cpu(), x8)
    before = Q.int8_mm.launches
    acc = Q.int8_mm(x8_card, q_card["kernel"])
    torch.cuda.synchronize()
    assert Q.int8_mm.launches == before + 1
    assert torch.equal(acc.cpu(), Q.int8_mm(x8, q_cpu["kernel"]))
    got, ref = Q.int8_linear(q_card, x.to(cuda)), Q.int8_linear(q_cpu, x)
    assert got.dtype == torch.bfloat16 and got.shape == (t, n)
    d = (got.float().cpu() - ref.float()).abs().max()
    assert d <= 1e-6 * ref.float().abs().max()


def test_int8_layer_and_column_views_on_card(cuda):
    """A layer view of a stacked int8 weight and the out_window layer's
    column views of wqkv (row stride 12288 in the logical layout, width
    4096) reach torch._int_mm as views, without a copy, and give the CPU's
    products; a static 0-d scale_x passes the column slices unsliced."""
    from openvla_oft_tpu_torch.bridge import index_layer
    from openvla_oft_tpu_torch.ops import quant as Q

    gen = torch.Generator().manual_seed(0)
    stacked = Q.quantize_weight(torch.randn((2, 4096, 12288), generator=gen) * 0.02)
    x = torch.randn((57, 4096), generator=gen).bfloat16()
    card = {k: v.to(cuda) for k, v in stacked.items()}
    for key in ("kernel", "scale_w"):
        assert card[key].stride() == stacked[key].stride()
    for layer in range(2):
        lp_cpu, lp_card = index_layer(stacked, layer), index_layer(card, layer)
        for static in (False, True):
            extra = {"scale_x": torch.tensor(0.03)} if static else {}
            for lo in (0, 4096, 8192):
                view_cpu = {n_: v[..., lo:lo + 4096] for n_, v in lp_cpu.items()}
                view_card = {n_: v[..., lo:lo + 4096] for n_, v in lp_card.items()}
                assert view_card["kernel"].data_ptr() == \
                    card["kernel"].data_ptr() + layer * 4096 * 12288 + lo * 4096
                ref = Q.int8_linear({**view_cpu, **extra}, x)
                got = Q.int8_linear({**view_card, **{k: v.to(cuda) for k, v in extra.items()}},
                                    x.to(cuda))
                d = (got.float().cpu() - ref.float()).abs().max()
                assert d <= 1e-6 * ref.float().abs().max(), (layer, lo, static)


def test_int8_mm_refuses_widths_off_8(cuda):
    from openvla_oft_tpu_torch.ops import quant as Q

    x8 = torch.zeros((32, 588), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        Q.int8_mm(x8, torch.zeros((588, 64), dtype=torch.int8, device=cuda))


def _int8_tiny_cfg():
    """`_tiny_cfg` with 8-pixel patches on 32-pixel images, so that every
    int8 width, the patch embeddings' 192 included, is a multiple of 8 (CUDA
    torch._int_mm's rule; the stock TINY patch embedding is 588 wide)."""
    import dataclasses

    import openvla_oft_tpu_torch.config as C

    cfg = _tiny_cfg()
    C._VISION_REGISTRY.setdefault("gpu-int8-dual", tuple(
        dataclasses.replace(v, patch_size=8, image_size=32) for v in cfg.vision_configs))
    return dataclasses.replace(cfg, vision_backbone_id="gpu-int8-dual")


@pytest.mark.parametrize("flag", ["load_in_8bit", "load_vision_in_8bit"])
def test_tiny_int8_policy_card_matches_plain_product(cuda, flag, monkeypatch):
    """The tiny policy quantized by `serving_params` on the card, served
    through torch._int_mm, against the same policy with the product swapped
    for its plain version (float64, exact): equal within 1e-6 relative; the
    products launched per request are those the code gives."""
    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.ops import quant as Q
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy
    from openvla_oft_tpu_torch.serving import deploy

    monkeypatch.setattr(deploy, "QUANT_MIN_DIM", 32)            # every tiny linear
    cfg = _int8_tiny_cfg()
    params = deploy.serving_params(
        init_params(cfg, LIBERO, torch.Generator(device=cuda).manual_seed(0), device=cuda,
                    dtype=torch.bfloat16), **{flag: True})
    pol = OpenVLAPolicy(cfg=cfg, platform=LIBERO, params=params,
                        norm_stats=deploy.placeholder_norm_stats(LIBERO), prompt_bucket=32)
    frames = (np.random.default_rng(0).random((2, 40, 40, 3)) * 255).astype(np.uint8)
    vit = sum(1 + 4 * (v.depth - 1) for v in cfg.vision_configs) + 3
    expect = vit + (4 * (cfg.llm.num_layers - 1) + 6 if flag == "load_in_8bit" else 0)
    before = Q.int8_mm.launches
    got = pol.predict_action_from_frames(frames, "open the drawer")
    assert Q.int8_mm.launches - before == expect
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Q, "int8_mm", Q.int8_mm_ref)
        plain = pol.predict_action_from_frames(frames, "open the drawer")
    assert np.isfinite(got).all()
    assert np.abs(got - plain).max() <= 1e-6 * np.abs(plain).max()


# --- the diffusion head ---------------------------------------------------------

def _tiny_diffusion_inputs(cfg, device):
    """A left-padded prompt, normalized pixels and proprio for the tiny LIBERO model."""
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.models.prismatic import prepare_prompt_ids
    from openvla_oft_tpu_torch.processing.processor import FakeLlamaTokenizer

    ids, mask = prepare_prompt_ids(FakeLlamaTokenizer(), "open the drawer", 32)
    gen = torch.Generator(device=device).manual_seed(1)
    h = cfg.vision_configs[0].image_size
    pixels = torch.rand((1, cfg.num_images_in_input, 2, h, h, 3), generator=gen, device=device)
    proprio = torch.rand((1, LIBERO.proprio_dim), generator=gen, device=device) * 2 - 1
    return (torch.as_tensor(ids, device=device)[None], torch.as_tensor(mask, device=device)[None],
            pixels, proprio)


def test_tiny_diffusion_prefix_k1_matches_dense(cuda):
    """The prefix prefill through K1 (one launch per layer under "auto")
    against the dense path: the cached K/V, cosine >= 0.99; then the whole
    loop from the same noise, K1 once per layer per request, cosine >= 0.99
    against the dense policy's actions."""
    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.models.prismatic import build_diffusion_prefix
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy

    cfg = _tiny_cfg()
    params = init_params(cfg, LIBERO, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda, dtype=torch.bfloat16, head="diffusion")
    ids, mask, pixels, proprio = _tiny_diffusion_inputs(cfg, cuda)
    n = cfg.llm.num_layers
    with torch.inference_mode():
        before = fa.flash_attention.launches
        k1 = build_diffusion_prefix(params, cfg, ids, mask, pixels, proprio, use_flash="auto")
        torch.cuda.synchronize()
        assert fa.flash_attention.launches - before == n
        dense = build_diffusion_prefix(params, cfg, ids, mask, pixels, proprio, use_flash=False)
    for got, ref in ((k1.prefix_k, dense.prefix_k), (k1.prefix_v, dense.prefix_v)):
        assert torch.isfinite(got).all() and _cosine(got, ref) >= 0.99
    actions = {}
    noise = torch.randn((1, LIBERO.num_actions_chunk, LIBERO.action_dim), device=cuda)
    for use_flash in ("auto", False):
        pol = OpenVLAPolicy(cfg=cfg, platform=LIBERO, params=params, head="diffusion",
                            prompt_bucket=32, num_diffusion_steps_inference=5,
                            use_flash=use_flash)
        before = fa.flash_attention.launches
        actions[use_flash] = pol.predict_action(pixels[0], "open the drawer",
                                                proprio=proprio[0], noise=noise)
        assert fa.flash_attention.launches - before == (n if use_flash else 0)
    assert np.isfinite(actions["auto"]).all()
    assert _cosine(torch.from_numpy(actions["auto"]), torch.from_numpy(actions[False])) >= 0.99


def test_tiny_diffusion_suffix_step_k5_matches_plain(cuda):
    """The prefix and one suffix step on an int4 LLM through K5 (4 launches
    per layer each) against the same calls with K5's plain version swapped
    in: the prefix K/V, then the step on each side's own prefix."""
    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.models.action_heads import sinusoidal_time_encoding
    from openvla_oft_tpu_torch.models.llama import fuse_inference_weights
    from openvla_oft_tpu_torch.models.prismatic import (build_diffusion_prefix,
                                                       diffusion_suffix_step)
    from openvla_oft_tpu_torch.ops import int4_matmul as M
    from openvla_oft_tpu_torch.ops.quant import quantize_tree

    cfg = _tiny_cfg()
    params = init_params(cfg, LIBERO, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda, dtype=torch.bfloat16, head="diffusion")
    params["llm"] = quantize_tree(fuse_inference_weights(params["llm"], fold_norms=False),
                                  min_dim=256, bits=4)
    ids, mask, pixels, proprio = _tiny_diffusion_inputs(cfg, cuda)
    x_t = torch.randn((1, LIBERO.num_actions_chunk, LIBERO.action_dim), device=cuda)
    t_emb = sinusoidal_time_encoding(torch.tensor([17], device=cuda), cfg.llm_dim)[:, None]
    linears = 4 * cfg.llm.num_layers
    with torch.inference_mode():
        before = M.int4_matmul_fused.launches
        prefix = build_diffusion_prefix(params, cfg, ids, mask, pixels, proprio)
        torch.cuda.synchronize()
        assert M.int4_matmul_fused.launches - before == linears
        got = diffusion_suffix_step(params, cfg, LIBERO, prefix, t_emb, x_t)
        torch.cuda.synchronize()
        assert M.int4_matmul_fused.launches - before == 2 * linears
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(M, "int4_matmul_fused", M.int4_matmul_ref)
            plain_prefix = build_diffusion_prefix(params, cfg, ids, mask, pixels, proprio)
            plain = diffusion_suffix_step(params, cfg, LIBERO, plain_prefix, t_emb, x_t)
    for a, b in ((prefix.prefix_k, plain_prefix.prefix_k),
                 (prefix.prefix_v, plain_prefix.prefix_v)):
        assert torch.isfinite(a).all() and _cosine(a, b) >= 0.99 and _rel_err(a, b) <= 2e-2
    assert torch.isfinite(got).all()
    assert _cosine(got, plain) >= 0.99 and _rel_err(got, plain) <= 2e-2
