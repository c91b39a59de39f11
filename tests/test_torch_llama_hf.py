"""Parity of the port's Llama against HF transformers (random tiny weights).

Mirror of tests/test_llama_parity.py for the port: random HF
`LlamaForCausalLM` / `MistralForCausalLM` models built from configs (nothing
is downloaded), their weights converted into the stacked param tree (the
JAX package's `port_hf_llama`, then `bridge.params_from_numpy`), and the
port's `llama_model`, `lm_logits`, `llama_prefill` and `llama_decode_step`
held to HF in fp32: the causal forward, the logits, a padding mask, the OFT
block-bidirectional mask as an explicit 4-D additive mask, the cached
decode, GQA. Tolerances are those of tests/test_llama_parity.py: 2e-5
(3e-5 for GQA) against HF, 1e-5 for the cache against the full forward.
"""

import dataclasses

import numpy as np
import pytest
import torch

from openvla_oft_tpu_torch.bridge import params_from_numpy
from openvla_oft_tpu_torch.config import LlamaConfig
from openvla_oft_tpu_torch.models.llama import (KVCache, embed_tokens, llama_decode_step,
                                               llama_model, llama_prefill)
from openvla_oft_tpu_torch.models.prismatic import lm_logits

transformers = pytest.importorskip("transformers")

TINY = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=4,
                   max_position_embeddings=512, pad_token_id=0)
HF_TOL = dict(rtol=2e-5, atol=2e-5)


def _port_tree(model, cfg: LlamaConfig) -> dict:
    """An HF model's weights as the port's stacked Llama tree."""
    from openvla_oft_tpu.config import LlamaConfig as JaxLlamaConfig
    from openvla_oft_tpu.utils.weights import dict_getter, port_hf_llama

    jcfg = JaxLlamaConfig(**dataclasses.asdict(cfg))
    return params_from_numpy(port_hf_llama(dict_getter(model.state_dict()), jcfg))


@pytest.fixture(scope="module")
def hf_and_port():
    torch.manual_seed(0)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=TINY.vocab_size, hidden_size=TINY.hidden_size,
        intermediate_size=TINY.intermediate_size,
        num_hidden_layers=TINY.num_layers, num_attention_heads=TINY.num_heads,
        num_key_value_heads=TINY.num_kv_heads, rms_norm_eps=TINY.rms_norm_eps,
        rope_theta=TINY.rope_theta, attention_bias=False, tie_word_embeddings=False,
        attn_implementation="eager")
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    return model, _port_tree(model, TINY)


def _hf_hidden(model, embeds, attention_mask=None) -> np.ndarray:
    with torch.no_grad():
        out = model.model(inputs_embeds=embeds, attention_mask=attention_mask)
    return out.last_hidden_state.numpy()


def test_causal_forward_matches_hf(hf_and_port, rng):
    model, llm = hf_and_port
    x = torch.from_numpy(rng.standard_normal((2, 9, TINY.hidden_size)).astype(np.float32))
    with torch.no_grad():
        ours = llama_model(llm, TINY, x)
    np.testing.assert_allclose(ours.numpy(), _hf_hidden(model, x), **HF_TOL)


def test_logits_match_hf(hf_and_port, rng):
    model, llm = hf_and_port
    ids = torch.from_numpy(rng.integers(0, TINY.vocab_size, (1, 7)))
    with torch.no_grad():
        ours = lm_logits(llm, llama_model(llm, TINY, embed_tokens(llm, ids)))
        theirs = model(input_ids=ids).logits
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), **HF_TOL)


def test_padding_mask_matches_hf(hf_and_port, rng):
    model, llm = hf_and_port
    x = torch.from_numpy(rng.standard_normal((2, 8, TINY.hidden_size)).astype(np.float32))
    mask = torch.tensor([[1, 1, 1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1, 1, 1]])
    with torch.no_grad():
        ours = llama_model(llm, TINY, x, padding_mask=mask)
    sel = mask.bool().numpy()                          # non-pad positions only
    np.testing.assert_allclose(ours.numpy()[sel], _hf_hidden(model, x, mask)[sel], **HF_TOL)


def test_block_bidirectional_matches_hf_4d_mask(hf_and_port, rng):
    """The OFT mask: a causal prefix and a bidirectional action block,
    against HF given the same rule as an additive 4-D mask."""
    model, llm = hf_and_port
    b, s, chunk_start, chunk = 1, 12, 6, 4
    x = torch.from_numpy(rng.standard_normal((b, s, TINY.hidden_size)).astype(np.float32))
    bidir = torch.zeros((b, s), dtype=torch.bool)
    bidir[:, chunk_start:chunk_start + chunk] = True
    with torch.no_grad():
        ours = llama_model(llm, TINY, x, bidir_mask=bidir)
        plain = llama_model(llm, TINY, x)
    allowed = torch.ones((s, s), dtype=torch.bool).tril() | (bidir[0][:, None] & bidir[0][None])
    mask4d = torch.where(allowed, 0.0, torch.finfo(torch.float32).min)[None, None]
    np.testing.assert_allclose(ours.numpy(), _hf_hidden(model, x, mask4d), **HF_TOL)
    assert (ours - plain).abs().max().item() > 1e-4      # the window changes the result


def test_kv_cache_decode_matches_full_forward(hf_and_port, rng):
    """A prefill of 6 tokens and 4 decode steps against the full forward,
    and each step's logits against HF's full forward."""
    model, llm = hf_and_port
    ids = torch.from_numpy(rng.integers(0, TINY.vocab_size, (1, 10)))
    emb = embed_tokens(llm, ids)
    with torch.no_grad():
        full = llama_model(llm, TINY, emb)
        theirs = model(input_ids=ids).logits.numpy()
        cache = KVCache.create(TINY, 1, 16, dtype=torch.float32)
        pre, cache = llama_prefill(llm, TINY, emb[:, :6], cache, use_flash=False)
        steps = []
        for t in range(6, 10):
            h, cache = llama_decode_step(llm, TINY, emb[:, t:t + 1], cache)
            steps.append(h[:, 0])
    np.testing.assert_allclose(pre.numpy(), full[:, :6].numpy(), rtol=1e-5, atol=1e-5)
    hidden = torch.stack(steps, 1)
    np.testing.assert_allclose(hidden.numpy(), full[:, 6:10].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lm_logits(llm, hidden).numpy(), theirs[:, 6:10], **HF_TOL)
    assert cache.index == 10 and cache.valid[0, :10].all() and not cache.valid[0, 10:].any()


def test_gqa_mistral_style_matches_hf(rng):
    """GQA (the Mistral backbone family): kv heads < heads, against HF
    Mistral; the cached decode too."""
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=160,
                      num_layers=2, num_heads=8, num_kv_heads=2,
                      rope_theta=10000.0, max_position_embeddings=512)
    torch.manual_seed(1)
    hf = transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, rope_theta=cfg.rope_theta,
        sliding_window=None, tie_word_embeddings=False,
        attn_implementation="eager")).eval()
    llm = _port_tree(hf, cfg)
    x = torch.from_numpy(rng.standard_normal((2, 11, cfg.hidden_size)).astype(np.float32))
    with torch.no_grad():
        ours = llama_model(llm, cfg, x)
        theirs = hf.model(inputs_embeds=x).last_hidden_state
        cache = KVCache.create(cfg, 2, 11, dtype=torch.float32)
        _, cache = llama_prefill(llm, cfg, x[:, :8], cache, use_flash=False)
        steps = [llama_decode_step(llm, cfg, x[:, t:t + 1], cache)[0][:, 0] for t in (8, 9, 10)]
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), theirs[:, 8:].numpy(),
                               rtol=3e-5, atol=3e-5)
