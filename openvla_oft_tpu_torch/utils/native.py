"""The collator's and the action tokenizer's host loops in C++.

The port's copy of `openvla_oft_tpu/utils/native.py`: the same five entry
points over `hostsrc/data_ops.cc`, which `_host_build.py` compiles into the
host library with the other host sources. There is no NumPy fallback: a
missing compiler or a failed build raises. ctypes releases the GIL around
every call, so batch assembly overlaps the launching thread.
"""

from __future__ import annotations

import numpy as np


def _lib():
    from openvla_oft_tpu_torch._host_build import library

    return library()


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def pad_stack(seqs, target: int, fill: int) -> np.ndarray:
    """Variable-length int sequences -> (n, target) int32, right-padded with
    `fill`; a sequence longer than `target` raises."""
    lengths = np.asarray([len(s) for s in seqs], np.int32)
    flat = np.ascontiguousarray(np.concatenate([np.asarray(s, np.int32) for s in seqs])
                                if len(seqs) else np.zeros(0, np.int32))
    out = np.empty((len(seqs), target), np.int32)
    if _lib().openvla_pad_stack_i32(_ptr(flat), _ptr(lengths), len(seqs), target,
                                    int(fill), _ptr(out)) != 0:
        raise ValueError(f"a sequence exceeds target {target}")
    return out


def attention_mask(lengths, target: int) -> np.ndarray:
    """(n, target) int32: 1 for j < lengths[i], else 0."""
    lengths = np.ascontiguousarray(lengths, np.int32)
    out = np.empty((len(lengths), target), np.int32)
    _lib().openvla_attention_mask_i32(_ptr(lengths), len(lengths), target, _ptr(out))
    return out


def encode_actions(actions: np.ndarray, bins: int = 256, min_action: float = -1.0,
                   max_action: float = 1.0, vocab_size: int = 32000) -> np.ndarray:
    """Actions -> token ids: clipped, digitized over `bins` uniform edges,
    vocab_size - bin (int32, the actions' shape)."""
    a = np.ascontiguousarray(actions, np.float32)
    out = np.empty(a.shape, np.int32)
    _lib().openvla_encode_actions_i32(_ptr(a), a.size, bins, min_action, max_action,
                                      vocab_size, _ptr(out))
    return out


def decode_actions(ids: np.ndarray, bins: int = 256, min_action: float = -1.0,
                   max_action: float = 1.0, vocab_size: int = 32000) -> np.ndarray:
    """Token ids -> the centres of their bins (float32, the ids' shape)."""
    i = np.ascontiguousarray(ids, np.int32)
    out = np.empty(i.shape, np.float32)
    _lib().openvla_decode_actions_f32(_ptr(i), i.size, bins, min_action, max_action,
                                      vocab_size, _ptr(out))
    return out


def normalize_image(img: np.ndarray, mean, std) -> np.ndarray:
    """uint8 (..., 3) -> float32 (x / 255 - mean) / std, per channel (a
    scalar mean or std applies to all three)."""
    u8 = np.ascontiguousarray(img, np.uint8)
    if u8.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) uint8 pixels, got {u8.shape}")
    out = np.empty(u8.shape, np.float32)
    m = np.ascontiguousarray(np.broadcast_to(np.asarray(mean, np.float32), (3,)))
    s = np.ascontiguousarray(np.broadcast_to(np.asarray(std, np.float32), (3,)))
    _lib().openvla_normalize_image_f32(_ptr(u8), u8.size // 3, _ptr(m), _ptr(s), _ptr(out))
    return out
