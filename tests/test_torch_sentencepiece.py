"""The port's SentencePiece tokenizer, prompt builders and tokenizer loading.

The mirror of `tests/test_sentencepiece.py` on `openvla_oft_tpu_torch.
processing.sentencepiece` (hand-serialized model protos, hand-computed BPE
merges and unigram segmentations), then the port against the JAX package on
the same models: a hypothesis test over text strings (BPE and unigram, with
and without the dummy prefix: encode ids and decoded text equal), each
prompt builder's strings, `derive_prompt_bucket` and `prepare_prompt_ids`.
Exact throughout.
"""

import builtins

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import openvla_oft_tpu.processing.prompting as JP
import openvla_oft_tpu.processing.sentencepiece as JS
import openvla_oft_tpu_torch.processing.prompting as PP
import openvla_oft_tpu_torch.processing.sentencepiece as PS
from openvla_oft_tpu_torch.processing.sentencepiece import (BYTE, CONTROL, NORMAL, UNKNOWN,
                                                            SentencePieceTokenizer,
                                                            load_sentencepiece,
                                                            parse_model_proto)
from test_sentencepiece import _llama_like_pieces, _model
from test_torch_import import register_tiny  # noqa: F401  (registers the TINY ids)

WS = "▁"


def test_parse_model_proto_roundtrip():
    pieces = _llama_like_pieces([(WS + "a", -1.0), ("ab", -2.5)])
    m = parse_model_proto(_model(pieces, model_type=2, byte_fallback=True,
                                 add_dummy_prefix=True))
    assert len(m.pieces) == len(pieces)
    assert m.pieces[0] == "<unk>" and m.types[0] == UNKNOWN
    assert m.pieces[1] == "<s>" and m.types[1] == CONTROL
    assert m.pieces[3] == "<0x00>" and m.types[3] == BYTE
    assert m.pieces[-2] == WS + "a"
    assert abs(m.scores[-1] + 2.5) < 1e-6
    assert m.model_type == 2 and m.byte_fallback and m.add_dummy_prefix
    assert m.unk_id == 0


def test_bpe_merge_order_by_score_not_position():
    # "abc": ab=-2, bc=-1 -> bc merges first: [a, bc], not [ab, c].
    pieces = _llama_like_pieces([("a", -10.0), ("b", -10.0), ("c", -10.0),
                                 ("ab", -2.0), ("bc", -1.0)])
    tok = SentencePieceTokenizer(parse_model_proto(_model(pieces, add_dummy_prefix=False)))
    assert [tok.model.pieces[i] for i in tok.encode("abc", add_bos=False)] == ["a", "bc"]


def test_bpe_cascading_merges_and_dummy_prefix():
    pieces = _llama_like_pieces(
        [(WS, -10.0), ("h", -11.0), ("i", -11.0), ("hi", -1.0), (WS + "hi", -0.5),
         (WS + "there", -0.7), ("t", -11.0), ("h", -11.0), ("e", -11.0), ("r", -11.0),
         ("th", -3.0), ("er", -3.1), ("the", -2.0), ("ther", -1.9), ("there", -1.5)])
    tok = SentencePieceTokenizer(parse_model_proto(_model(pieces)))
    ids = tok.encode("hi there", add_bos=False)
    assert [tok.model.pieces[i] for i in ids] == [WS + "hi", WS + "there"]
    ids2 = tok.encode("hi there")
    assert ids2[0] == tok.bos_token_id and ids2[1:] == ids


def test_byte_fallback_for_oov_chars():
    tok = SentencePieceTokenizer(parse_model_proto(_model(
        _llama_like_pieces([(WS, -10.0), ("x", -11.0)]))))
    ids = tok.encode("xé", add_bos=False)         # é = 0xC3 0xA9
    assert [tok.model.pieces[i] for i in ids] == [WS, "x", "<0xC3>", "<0xA9>"]
    assert tok.decode(ids) == "xé"


def test_control_pieces_never_match_text():
    pieces = _llama_like_pieces([(WS, -10.0), ("<", -11.0), ("s", -11.0), (">", -11.0),
                                 ("<s", -3.0), ("<s>", -1.0)])
    tok = SentencePieceTokenizer(parse_model_proto(_model(pieces)))
    ids = tok.encode("<s>", add_bos=False)
    assert tok.bos_token_id not in ids
    assert [tok.model.pieces[i] for i in ids] == [WS, "<s>"]


def test_unigram_viterbi_prefers_total_score():
    # [ab]+[c] = -3 beats [abc] = -4.
    pieces = _llama_like_pieces([(WS, -1.0), ("a", -5.0), ("b", -5.0), ("c", -2.0),
                                 ("ab", -1.0), ("abc", -4.0)])
    tok = SentencePieceTokenizer(parse_model_proto(_model(pieces, model_type=1,
                                                          add_dummy_prefix=False)))
    assert [tok.model.pieces[i] for i in tok.encode("abc", add_bos=False)] == ["ab", "c"]


def _prompt_tokenizer():
    words = ["in", ":", "what", "action", "should", "the", "robot", "take", "to", "do",
             "it", "?", "out"]
    extra = [(WS, -2.0)] + [(WS + w, -1.0) for w in words] + \
        [(w, -5.0) for w in "inwhatcsoudlrbkt?:ed"] + [("\n", -3.0)]
    return _model(_llama_like_pieces(extra))


def test_hf_interface_and_processor_integration():
    import openvla_oft_tpu_torch.config as C
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor

    tok = SentencePieceTokenizer(parse_model_proto(_prompt_tokenizer()))
    out = tok("in: what action", add_special_tokens=True)
    assert out["input_ids"][0] == tok.bos_token_id
    assert len(out["input_ids"]) == len(out["attention_mask"]) and all(out["attention_mask"])
    assert len(tok(["do it", "take to"], add_special_tokens=True)["input_ids"]) == 2
    cfg = C.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama")
    proc = PrismaticProcessor(cfg, tokenizer=tok)
    h = C.TINY_DINOV2.image_size
    img = (np.random.default_rng(0).random((1, h, h, 3)) * 255).astype(np.uint8)
    assert proc.tokenizer is tok
    assert tuple(proc.transform(img).shape) == (1, 2, h, h, 3)


def test_load_sentencepiece_from_dir(tmp_path):
    assert load_sentencepiece(tmp_path) is None
    (tmp_path / "tokenizer.model").write_bytes(_model(_llama_like_pieces(
        [(WS + "hi", -1.0), ("hi", -2.0), ("h", -9.0), ("i", -9.0), (WS, -9.0)])))
    tok = load_sentencepiece(tmp_path)
    assert tok.encode("hi", add_bos=False) == [tok.vocab[WS + "hi"]]


def test_truncated_proto_raises():
    with pytest.raises(ValueError):
        parse_model_proto(_model(_llama_like_pieces([(WS + "a", -1.0)]))[:-2])


def test_garbage_and_empty_models_rejected(tmp_path):
    import warnings

    with pytest.raises(ValueError):
        parse_model_proto(_model([]))
    with pytest.raises(ValueError):
        parse_model_proto(_model([("<unk>", 0.0, UNKNOWN), ("a", -1.0, NORMAL)],
                                 byte_fallback=True))
    (tmp_path / "tokenizer.model").write_bytes(b"IQ==\nRA==\n" * 200)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert load_sentencepiece(tmp_path) is None
        assert any("not a usable sentencepiece" in str(x.message) for x in w)


def test_decode_preserves_space_without_dummy_prefix():
    pieces = _llama_like_pieces([(WS, -10.0), ("h", -10.0), ("i", -10.0),
                                 (WS + "h", -2.0), (WS + "hi", -1.0)])
    with_prefix = SentencePieceTokenizer(parse_model_proto(_model(pieces)))
    without = SentencePieceTokenizer(parse_model_proto(_model(pieces, add_dummy_prefix=False)))
    assert with_prefix.decode(with_prefix.encode("hi", add_bos=False)) == "hi"
    assert without.decode([with_prefix.vocab[WS + "hi"]]) == " hi"


# === against the JAX package ===
# A model with pieces for a small alphabet, their pairs and a few words, so
# that text drawn from the alphabet (and beyond it, through byte fallback)
# exercises merges, ties in score and the fallback.
_ALPHABET = "abcde é?\n"
_EXTRA = ([(WS, -4.0)] + [(c, -5.0 - i / 8) for i, c in enumerate("abcde?")]
          + [(a + b, -2.0 - ((ord(a) * 7 + ord(b)) % 5) / 4) for a in "abcde" for b in "abcde"]
          + [(WS + c, -1.5) for c in "abcde"] + [(WS + "bad", -0.5), ("cab", -1.0),
                                                 ("dead", -0.75), (WS + "a" + "e", -1.25)])


@pytest.fixture(scope="module")
def model_bytes():
    return {(mt, prefix): _model(_llama_like_pieces(_EXTRA), model_type=mt,
                                 add_dummy_prefix=prefix)
            for mt in (1, 2) for prefix in (True, False)}


@settings(max_examples=60, deadline=None, database=None)
@given(text=st.text(alphabet=_ALPHABET + "xyz中", max_size=24),
       model_type=st.sampled_from([1, 2]), prefix=st.booleans())
def test_encode_decode_match_jax(model_bytes, text, model_type, prefix):
    data = model_bytes[(model_type, prefix)]
    port = SentencePieceTokenizer(PS.parse_model_proto(data))
    ref = JS.SentencePieceTokenizer(JS.parse_model_proto(data))
    ids = port.encode(text, add_bos=True, add_eos=True)
    assert ids == ref.encode(text, add_bos=True, add_eos=True)
    assert port(text)["input_ids"] == ref(text)["input_ids"]
    assert port.decode(ids) == ref.decode(ids)
    assert port.decode(ids, skip_special_tokens=False) == \
        ref.decode(ids, skip_special_tokens=False)


def test_parsed_models_match_jax(model_bytes):
    import dataclasses

    for data in model_bytes.values():
        assert dataclasses.asdict(PS.parse_model_proto(data)) == \
            dataclasses.asdict(JS.parse_model_proto(data))


_TURNS = [("human", "What action should the robot take to <image> pick up the cup?"),
          ("gpt", "sure"), ("human", "and then?"), ("gpt", "")]


@pytest.mark.parametrize("backbone", ["llama2-7b-pure", "llama2-7b-chat", "vicuna-v15-7b",
                                      "mistral-v0.1-7b-instruct", "mistral-v0.1-7b-pure",
                                      "phi-2-3b", "openvla", "other"])
@pytest.mark.parametrize("system", [None, "Be brief."])
def test_prompt_builders_match_jax(backbone, system):
    port, ref = PP.get_prompt_builder(backbone), JP.get_prompt_builder(backbone)
    assert type(port).__name__ == type(ref).__name__
    port = type(port)(backbone, system_prompt=system)
    ref = type(ref)(backbone, system_prompt=system)
    for role, message in _TURNS:
        assert port.add_turn(role, message) == ref.add_turn(role, message)
        assert port.get_prompt() == ref.get_prompt()
    if hasattr(ref, "get_potential_prompt"):
        assert port.get_potential_prompt("next <image>") == ref.get_potential_prompt("next <image>")
    with pytest.raises(AssertionError):
        port.add_turn("gpt", "out of turn")


def test_prompt_bucket_and_ids_match_jax(model_bytes):
    from openvla_oft_tpu.models.prismatic import prepare_prompt_ids as j_prepare
    from openvla_oft_tpu.processing.processor import derive_prompt_bucket as j_bucket
    from openvla_oft_tpu_torch.models.prismatic import prepare_prompt_ids as p_prepare
    from openvla_oft_tpu_torch.processing.processor import derive_prompt_bucket as p_bucket

    data = _prompt_tokenizer()
    port = SentencePieceTokenizer(PS.parse_model_proto(data))
    ref = JS.SentencePieceTokenizer(JS.parse_model_proto(data))
    corpus = ["do it", "take the robot to do it", "what action should the robot take " * 4]
    for multiple in (8, 16):
        bucket = p_bucket(port, corpus, multiple=multiple)
        assert bucket == j_bucket(ref, corpus, multiple=multiple) and bucket % multiple == 0
        for ins in corpus:
            ids, mask = p_prepare(port, ins, bucket)
            j_ids, j_mask = j_prepare(ref, ins, bucket)
            assert len(ids) == bucket
            np.testing.assert_array_equal(ids, j_ids)
            np.testing.assert_array_equal(mask, j_mask)


def test_load_tokenizer_paths(tmp_path, monkeypatch):
    from openvla_oft_tpu_torch.processing.processor import load_tokenizer

    (tmp_path / "tokenizer.model").write_bytes(_prompt_tokenizer())
    assert isinstance(load_tokenizer(str(tmp_path)), SentencePieceTokenizer)
    real_import = builtins.__import__

    def no_transformers(name, *args, **kw):
        if name.split(".")[0] == "transformers":
            raise ImportError("No module named 'transformers'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(ImportError, match="transformers"):
        load_tokenizer(str(tmp_path), hf=True)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ImportError, match="no usable tokenizer.model"):
        load_tokenizer(str(empty))
