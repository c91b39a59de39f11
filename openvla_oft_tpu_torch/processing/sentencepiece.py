"""A SentencePiece tokenizer: `tokenizer.model` parsed and encoded in pure Python.

The port's copy of `openvla_oft_tpu/processing/sentencepiece.py`. The
reference serves through HF `LlamaTokenizer` (the sentencepiece C++ library
underneath, `processing_prismatic.py:175-252`); this module needs neither.
It holds the two pieces Llama-2 needs:

- a small reader of the protobuf wire format for the SentencePiece
  `ModelProto` (pieces, scores and types, `trainer_spec.model_type`,
  `byte_fallback`, `normalizer_spec.add_dummy_prefix`);
- the SP-BPE encoder (greedy merging of the highest-score bigram, the
  semantics of sentencepiece's `bpe_model.cc`; Llama-2's model is BPE with
  byte_fallback) and the unigram Viterbi encoder.

Llama-2's conventions: add_dummy_prefix (a leading "▁"), " " escaped as
"▁" (U+2581), byte-fallback pieces `<0xNN>` for characters outside the
vocab, and the BOS=1 / EOS=2 / UNK=0 pieces.
"""

from __future__ import annotations

import dataclasses
import heapq
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

WHITESPACE = "\u2581"  # "▁"

# SentencePiece.Type enum values
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# === Protobuf wire-format primitives ===
def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) triples; value is int for
    varint/fixed, bytes for length-delimited."""
    i = 0
    n = len(data)
    while i < n:
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, i = _read_varint(data, i)
        elif wire == 1:  # 64-bit
            if i + 8 > n:
                raise ValueError("truncated protobuf (64-bit field past EOF)")
            val = int.from_bytes(data[i:i + 8], "little")
            i += 8
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(data, i)
            if i + ln > n:
                raise ValueError("truncated protobuf (length-delimited field "
                                 f"of {ln} bytes past EOF)")
            val = data[i:i + ln]
            i += ln
        elif wire == 5:  # 32-bit
            if i + 4 > n:
                raise ValueError("truncated protobuf (32-bit field past EOF)")
            val = int.from_bytes(data[i:i + 4], "little")
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, val


def _f32(bits: int) -> float:
    import struct

    return struct.unpack("<f", bits.to_bytes(4, "little"))[0]


@dataclasses.dataclass
class SPModel:
    pieces: List[str]
    scores: List[float]
    types: List[int]
    model_type: int = 1          # TrainerSpec.ModelType [default=UNIGRAM]
    byte_fallback: bool = True
    add_dummy_prefix: bool = True
    unk_id: int = 0


def parse_model_proto(data: bytes) -> SPModel:
    """Parse the serialized `ModelProto` (sentencepiece_model.proto):
    pieces=1{piece=1, score=2, type=3}, trainer_spec=2{model_type=3,
    byte_fallback=35}, normalizer_spec=3{add_dummy_prefix=3}."""
    pieces: List[str] = []
    scores: List[float] = []
    types: List[int] = []
    # proto2 defaults: model_type UNIGRAM(1) — an omitted field means unigram
    # (Llama's BPE models serialize model_type: BPE explicitly since it is
    # non-default); byte_fallback false; add_dummy_prefix true.
    model_type, byte_fallback, add_dummy_prefix = 1, False, True
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:  # SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = _f32(v2)
                elif f2 == 3:
                    ptype = v2
            pieces.append(piece)
            scores.append(score)
            types.append(ptype)
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 3 and w2 == 0:
                    model_type = v2
                elif f2 == 35 and w2 == 0:
                    byte_fallback = bool(v2)
        elif field == 3 and wire == 2:  # NormalizerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 3 and w2 == 0:
                    add_dummy_prefix = bool(v2)
    # Sanity gate: a tiktoken-format (Llama-3) or otherwise non-ModelProto
    # file can parse "successfully" into garbage — reject anything that
    # doesn't look like a SentencePiece model rather than tokenizing wrong.
    if not pieces:
        raise ValueError("no SentencePiece pieces parsed — not a "
                         "sentencepiece ModelProto?")
    if model_type not in (1, 2):  # UNIGRAM | BPE
        raise ValueError(f"unsupported sentencepiece model_type={model_type} "
                         "(only unigram/BPE)")
    if byte_fallback and not any(
            t == BYTE and len(p) == 6 and p.startswith("<0x")
            for p, t in zip(pieces, types)):
        raise ValueError("byte_fallback set but no <0xNN> byte pieces found")
    unk_id = next((i for i, t in enumerate(types) if t == UNKNOWN), 0)
    return SPModel(pieces, scores, types, model_type, byte_fallback,
                   add_dummy_prefix, unk_id)


# === Encoding ===
class SentencePieceTokenizer:
    """Llama-compatible tokenizer over a parsed `tokenizer.model`.

    API mirrors the HF tokenizer surface the repo uses ( __call__ ->
    {input_ids, attention_mask}, decode, vocab_size, bos/eos ids).
    """

    def __init__(self, model: Union[SPModel, str, Path]):
        if not isinstance(model, SPModel):
            model = parse_model_proto(Path(model).read_bytes())
        self.model = model
        # Encoding vocab: CONTROL/UNKNOWN/UNUSED/BYTE pieces never match raw
        # text (sentencepiece matches "<s>" in input as plain chars, not as
        # the control piece); decode indexes by id so it needs no map.
        self.vocab: Dict[str, int] = {}
        for i, (p, t) in enumerate(zip(model.pieces, model.types)):
            if t in (NORMAL, USER_DEFINED):
                self.vocab.setdefault(p, i)
        self.vocab_size = len(model.pieces)

        def _special(text, default):
            for i, (p, t) in enumerate(zip(model.pieces, model.types)):
                if p == text and t == CONTROL:
                    return i
            return default

        self.bos_token_id = _special("<s>", 1)
        self.eos_token_id = _special("</s>", 2)
        self.unk_token_id = model.unk_id
        self.pad_token_id = None
        self._byte_ids = {}
        for i, (p, t) in enumerate(zip(model.pieces, model.types)):
            if t == BYTE and len(p) == 6 and p.startswith("<0x"):
                self._byte_ids[int(p[3:5], 16)] = i

    # --- public API ---
    def __call__(self, text, add_special_tokens: bool = True, **kw):
        if isinstance(text, list):
            out = [self(t, add_special_tokens)["input_ids"] for t in text]
            return {"input_ids": out,
                    "attention_mask": [[1] * len(x) for x in out]}
        ids = self.encode(text, add_bos=add_special_tokens)
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> List[int]:
        norm = text.replace(" ", WHITESPACE)
        if self.model.add_dummy_prefix and norm:
            norm = WHITESPACE + norm
        if self.model.model_type == 1:
            ids = self._encode_unigram(norm)
        else:
            ids = self._encode_bpe(norm)
        if add_bos:
            ids = [self.bos_token_id] + ids
        if add_eos:
            ids = ids + [self.eos_token_id]
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        import numpy as np

        out: List[bytes] = []
        for i in np.atleast_1d(np.asarray(ids)).tolist():
            if i < 0 or i >= self.vocab_size:
                continue
            t = self.model.types[i]
            if t in (CONTROL, UNKNOWN) and skip_special_tokens:
                continue
            p = self.model.pieces[i]
            if t == BYTE:
                out.append(bytes([int(p[3:5], 16)]))
            else:
                out.append(p.replace(WHITESPACE, " ").encode("utf-8"))
        text = b"".join(out).decode("utf-8", errors="replace")
        # Only the dummy prefix the *encoder* added is stripped; a model
        # without add_dummy_prefix round-trips genuine leading spaces.
        if self.model.add_dummy_prefix and text.startswith(" "):
            return text[1:]
        return text

    # --- byte fallback for symbols outside the vocab ---
    def _fallback(self, sym: str) -> List[int]:
        if self.model.byte_fallback and self._byte_ids:
            return [self._byte_ids.get(b, self.unk_token_id)
                    for b in sym.encode("utf-8")]
        return [self.unk_token_id]

    # --- SP-BPE: greedy highest-score bigram merging (bpe_model.cc) ---
    def _encode_bpe(self, norm: str) -> List[int]:
        if not norm:
            return []
        # symbol linked list: (text, prev, next, alive)
        syms: List[List] = [[ch, i - 1, i + 1, True]
                            for i, ch in enumerate(norm)]
        syms[-1][2] = -1
        heap: List[Tuple[float, int, int, str]] = []

        def push(left: int, right: int):
            merged = syms[left][0] + syms[right][0]
            idx = self.vocab.get(merged)
            if idx is not None:
                # priority: highest score, then leftmost
                heapq.heappush(heap, (-self.model.scores[idx], left,
                                      len(syms[left][0]) + len(syms[right][0]),
                                      merged))

        for i in range(len(syms) - 1):
            push(i, i + 1)
        while heap:
            _, left, size, merged = heapq.heappop(heap)
            s = syms[left]
            if not s[3] or s[2] == -1:
                continue
            right = s[2]
            if not syms[right][3] or len(s[0]) + len(syms[right][0]) != size \
                    or s[0] + syms[right][0] != merged:
                continue  # stale entry
            s[0] = merged
            syms[right][3] = False
            s[2] = syms[right][2]
            if s[2] != -1:
                syms[s[2]][1] = left
            if s[1] != -1:
                push(s[1], left)
            if s[2] != -1:
                push(left, s[2])

        ids: List[int] = []
        i = 0
        while i != -1:
            if syms[i][3]:
                idx = self.vocab.get(syms[i][0])
                if idx is None:
                    ids.extend(self._fallback(syms[i][0]))
                else:
                    ids.append(idx)
            i = syms[i][2]
        return ids

    # --- Unigram: Viterbi best segmentation ---
    def _encode_unigram(self, norm: str) -> List[int]:
        n = len(norm)
        if n == 0:
            return []
        max_len = max((len(p) for p in self.vocab), default=1)
        unk_penalty = min(self.model.scores) - 10.0 if self.model.scores else -20.0
        best = [(-1e30, -1, -1)] * (n + 1)  # (score, start, piece_id)
        best[0] = (0.0, 0, -1)
        for end in range(1, n + 1):
            for start in range(max(0, end - max_len), end):
                if best[start][0] <= -1e29:
                    continue
                sub = norm[start:end]
                idx = self.vocab.get(sub)
                # self.vocab already restricts to NORMAL/USER_DEFINED pieces
                if idx is not None:
                    sc = best[start][0] + self.model.scores[idx]
                    if sc > best[end][0]:
                        best[end] = (sc, start, idx)
            if best[end][0] <= -1e29:  # unknown single char
                start = end - 1
                sc = best[start][0] + unk_penalty
                best[end] = (sc, start, -2)
        ids_rev: List[int] = []
        end = n
        while end > 0:
            _, start, idx = best[end]
            if idx == -2:
                ids_rev.extend(reversed(self._fallback(norm[start:end])))
            else:
                ids_rev.append(idx)
            end = start
        return list(reversed(ids_rev))


def load_sentencepiece(path_or_dir: Union[str, Path]
                       ) -> Optional[SentencePieceTokenizer]:
    """Load `tokenizer.model` from a file or checkpoint dir; None if absent."""
    p = Path(path_or_dir)
    if p.is_dir():
        p = p / "tokenizer.model"
    if not p.is_file():
        return None
    try:
        return SentencePieceTokenizer(p)
    except (ValueError, IndexError, UnicodeDecodeError) as e:
        # Corrupt / non-SP tokenizer.model (e.g. Llama-3's tiktoken format):
        # be loud, then let the caller fall back to the HF stack rather than
        # serving a silently wrong tokenizer.
        import warnings

        warnings.warn(f"{p} is not a usable sentencepiece model ({e}); "
                      "falling back to the HF tokenizer path")
        return None
