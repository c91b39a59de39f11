"""Port parity for the Llama decoder: unfused and fused trees, the K1 path
(plain version on the CPU) and the dense path, with and without the sliced
`out_window` last layer, against the JAX `llama_model`, plus the golden
`llama_bidir_forward`. fp32 on the CPU, atol 1e-5."""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from openvla_oft_tpu.config import TINY_LLAMA
from openvla_oft_tpu.models import llama as JL
from openvla_oft_tpu_torch.bridge import params_from_numpy
from openvla_oft_tpu_torch.models import llama as TL
from test_torch_import import port_arch

P_LLAMA = port_arch(TINY_LLAMA)       # the port's copy of the same config

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GOLDEN = Path(__file__).parent / "goldens" / "llama_bidir_forward.npz"
TOL = dict(rtol=1e-5, atol=1e-5)


def _params(rng):
    p = JL.init_llama_params(jax.random.PRNGKey(7), TINY_LLAMA, dtype=jnp.float32)
    layers = dict(p["layers"])
    for name in ("attn_norm", "mlp_norm"):     # non-trivial scales for the fold
        layers[name] = {"scale": jnp.asarray(
            rng.random(layers[name]["scale"].shape) + 0.5, jnp.float32)}
    return {**p, "layers": layers}


@pytest.mark.parametrize("tree", ["unfused", "fused_folded", "fused_concat_only"])
@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
@pytest.mark.parametrize("window", [True, False], ids=["out_window", "all_rows"])
def test_llama_model_matches_jax(rng, tree, use_flash, window):
    params = _params(rng)
    if tree != "unfused":
        params = JL.fuse_inference_weights(params, fold_norms=(tree == "fused_folded"))
    b, s = 2, 40
    x = rng.standard_normal((b, s, TINY_LLAMA.hidden_size)).astype(np.float32)
    pad = np.ones((b, s), bool)
    pad[0, :6] = False
    positions = np.maximum(np.arange(s)[None] - (~pad).sum(1)[:, None], 0).astype(np.int32)
    bidir = np.zeros((b, s), bool)
    bidir[:, 28:38] = True
    out_window = (27, 9) if window else None
    kw = dict(bidir_block=(28, 10), out_window=out_window)
    ref = np.asarray(JL.llama_model(
        params, TINY_LLAMA, jnp.asarray(x), padding_mask=jnp.asarray(pad),
        bidir_mask=jnp.asarray(bidir), positions=jnp.asarray(positions),
        use_flash=use_flash, **kw))
    got = TL.llama_model(params_from_numpy(params), P_LLAMA, torch.from_numpy(x),
                         padding_mask=torch.from_numpy(pad),
                         bidir_mask=torch.from_numpy(bidir),
                         positions=torch.from_numpy(positions),
                         use_flash=use_flash, **kw).numpy()
    # Pad rows differ between the paths by design (K1: zeros, dense: mean of
    # V); compare the rows the model reads.
    rows = pad[:, 27:36] if window else pad
    np.testing.assert_allclose(got[rows], ref[rows], **TOL)


def test_fuse_inference_weights_matches_jax(rng):
    params = _params(rng)
    for fold in (True, False):
        ref = JL.fuse_inference_weights(params, fold_norms=fold)["layers"]
        got = TL.fuse_inference_weights(params_from_numpy(params),
                                        fold_norms=fold)["layers"]
        for grp, name in (("attn", "wqkv"), ("mlp", "gate_up")):
            np.testing.assert_allclose(got[grp][name]["kernel"].numpy(),
                                       np.asarray(ref[grp][name]["kernel"]),
                                       rtol=1e-6, atol=1e-7)
        assert (got["attn_norm"] == {}) == fold


def test_llama_golden():
    """tests/goldens/llama_bidir_forward.npz, built as tests/test_goldens.py
    builds it (dense path: the JAX default use_flash=False)."""
    params = JL.init_llama_params(jax.random.PRNGKey(11), TINY_LLAMA, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(12), (1, 9, TINY_LLAMA.hidden_size))
    bidir = np.zeros((1, 9), bool)
    bidir[:, 5:8] = True
    out = TL.llama_model(params_from_numpy(params), P_LLAMA,
                         torch.from_numpy(np.array(x)),
                         bidir_mask=torch.from_numpy(bidir)).numpy()
    np.testing.assert_allclose(out[:, -4:, :8], np.load(GOLDEN)["value"],
                               atol=2e-5, rtol=1e-4)
