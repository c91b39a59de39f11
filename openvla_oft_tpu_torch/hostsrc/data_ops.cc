// Host data-path loops of the collator and the action tokenizer: the port's
// copy of the JAX package's native library (`native/data_ops.cc`), with the
// entry points named `openvla_*` beside the host library's others.
//
//   openvla_pad_stack_i32        variable-length int32 sequences -> (n, target),
//                                right-padded with `fill`
//   openvla_attention_mask_i32   1 for j < length, else 0
//   openvla_encode_actions_i32   uniform-bin action tokenization
//                                (reference action_tokenizer.py:38-46)
//   openvla_decode_actions_f32   token ids -> bin centres (action_tokenizer.py:56-72)
//   openvla_normalize_image_f32  uint8 HWC -> (x / 255 - mean) / std per channel
//
// Plain C interface (ctypes, which releases the GIL around each call), no
// state between calls.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// 0 on success, -1 if a sequence is longer than `target`.
int openvla_pad_stack_i32(const int32_t* flat, const int32_t* lengths, int n, int target,
                          int32_t fill, int32_t* out) {
  int64_t offset = 0;
  for (int i = 0; i < n; ++i) {
    const int len = lengths[i];
    if (len > target) return -1;
    int32_t* row = out + static_cast<int64_t>(i) * target;
    std::memcpy(row, flat + offset, sizeof(int32_t) * len);
    for (int j = len; j < target; ++j) row[j] = fill;
    offset += len;
  }
  return 0;
}

void openvla_attention_mask_i32(const int32_t* lengths, int n, int target, int32_t* out) {
  for (int i = 0; i < n; ++i) {
    int32_t* row = out + static_cast<int64_t>(i) * target;
    const int len = lengths[i];
    for (int j = 0; j < target; ++j) row[j] = j < len ? 1 : 0;
  }
}

// Clip to [min, max], np.digitize over `bins` uniform edges (the index of the
// first edge above the value, in [1, bins]), id = vocab - bin.
void openvla_encode_actions_i32(const float* actions, int64_t n, int bins, float min_action,
                                float max_action, int vocab_size, int32_t* out) {
  const float scale = (bins - 1) / (max_action - min_action);
  for (int64_t i = 0; i < n; ++i) {
    float a = actions[i];
    if (a < min_action) a = min_action;
    if (a > max_action) a = max_action;
    int idx = static_cast<int>(std::floor((a - min_action) * scale)) + 1;
    if (a >= max_action) idx = bins;
    if (idx > bins) idx = bins;
    out[i] = vocab_size - idx;
  }
}

void openvla_decode_actions_f32(const int32_t* ids, int64_t n, int bins, float min_action,
                                float max_action, int vocab_size, float* out) {
  const float step = (max_action - min_action) / (bins - 1);
  for (int64_t i = 0; i < n; ++i) {
    int d = vocab_size - ids[i] - 1;
    if (d < 0) d = 0;
    if (d > bins - 2) d = bins - 2;
    out[i] = min_action + step * d + step * 0.5f;
  }
}

void openvla_normalize_image_f32(const uint8_t* img, int64_t pixels, const float* mean,
                                 const float* stddev, float* out) {
  const float inv255 = 1.0f / 255.0f;
  for (int64_t p = 0; p < pixels; ++p) {
    const int64_t base = p * 3;
    for (int c = 0; c < 3; ++c) out[base + c] = (img[base + c] * inv255 - mean[c]) / stddev[c];
  }
}

}  // extern "C"
