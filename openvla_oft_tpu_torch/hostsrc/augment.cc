// Training-frame augmentation on the host: `data/rlds/augment.py`'s stages
// (TF's `_augment_image` given its draws) in float32, the same operations in
// the same order as its numpy plain version, so the two agree bit for bit
// (built with -ffp-contract=off: no fused multiply-adds).
//
//   crop at (oy, ox), (ch, cw)
//   lanczos3 resize to (h, w): ScaleAndTranslate's gather along the columns,
//     then the rows, each output the float32 sum in span order of weight *
//     input (the spans and weights come from the caller), rounded half to
//     even and clamped to uint8
//   brightness, contrast (the mean by TF's halving folds), saturation and
//     hue, each from uint8 to float32 (x * float32(1/255)) and back
//     (x * 255.5, truncated; brightness and contrast clamp first)
//
// Plain C interface (ctypes releases the GIL around the call).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

const float kInv255 = static_cast<float>(1.0 / 255);

inline uint8_t to_u8(float x, bool saturate) {
  x = x * 255.5f;
  if (saturate) x = x < 0.f ? 0.f : x > 255.f ? 255.f : x;
  return static_cast<uint8_t>(x);
}

// out (n_out, inner) = sum over k of weights[o][k] * in[min(start[o] + k, n_in - 1)]
void gather(const float* in, int n_in, int64_t inner, const int64_t* starts, const float* weights,
            int span, int n_out, int64_t in_stride, int64_t out_stride, int64_t elem_stride,
            float* out) {
  // in[i * in_stride + j * elem_stride], out[o * out_stride + j * elem_stride]
  for (int o = 0; o < n_out; ++o) {
    float* dst = out + o * out_stride;
    for (int64_t j = 0; j < inner; ++j) dst[j * elem_stride] = 0.f;
    for (int k = 0; k < span; ++k) {
      int64_t src = starts[o] + k;
      if (src > n_in - 1) src = n_in - 1;
      float wk = weights[o * span + k];
      const float* s = in + src * in_stride;
      for (int64_t j = 0; j < inner; ++j) {
        float prod = wk * s[j * elem_stride];
        dst[j * elem_stride] = dst[j * elem_stride] + prod;
      }
    }
  }
}

void channel_mean(const float* f, int64_t n, float mean[3]) {
  int64_t right = n / 2, left = n - right;
  std::vector<float> s(3 * (left > 0 ? left : 1));
  for (int64_t i = 0; i < right; ++i)
    for (int c = 0; c < 3; ++c) s[3 * i + c] = f[3 * (left + i) + c] + f[3 * i + c];
  if (left > right)
    for (int c = 0; c < 3; ++c) s[3 * right + c] = f[3 * right + c];
  int64_t m = left;
  while (m > 1) {
    right = m / 2;
    left = m - right;
    for (int64_t i = 0; i < right; ++i)
      for (int c = 0; c < 3; ++c) s[3 * i + c] = s[3 * i + c] + s[3 * (left + i) + c];
    m = left;
  }
  float scale = 1.f / static_cast<float>(n);
  for (int c = 0; c < 3; ++c) mean[c] = s[c] * scale;
}

inline void saturation(float r, float g, float b, float scale, float* o) {
  float v = std::fmax(r, std::fmax(g, b));
  float span = v - std::fmin(r, std::fmin(g, b));
  float s = v > 0 ? span / v : 0.f;
  float h;
  if (span <= 0) {
    h = 0.f;
  } else {
    float norm = 1.f / (6.f * span);
    if (r == v)
      h = norm * (g - b);
    else if (g == v)
      h = static_cast<float>(static_cast<double>(norm * (b - r)) + 2.0 / 6.0);
    else
      h = static_cast<float>(static_cast<double>(norm * (r - g)) + 4.0 / 6.0);
  }
  if (h < 0) h = h + 1.f;
  s = std::fmin(1.f, std::fmax(0.f, s * scale));
  float c = s * v, m = v - c, dh = h * 6.f;
  int cat = static_cast<int>(dh);
  float fmodu = std::fmod(dh, 2.f);
  float x = c * (1.f - std::fabs(fmodu - 1.f));
  float rr = 0.f, gg = 0.f, bb = 0.f;
  switch (cat) {
    case 0: rr = c; gg = x; break;
    case 1: rr = x; gg = c; break;
    case 2: gg = c; bb = x; break;
    case 3: gg = x; bb = c; break;
    case 4: rr = x; bb = c; break;
    case 5: rr = c; bb = x; break;
    default: break;
  }
  o[0] = rr + m;
  o[1] = gg + m;
  o[2] = bb + m;
}

inline void hue(float r, float g, float b, float delta, float* o) {
  float vmax, vmid, vmin;
  int cat;
  if (r < g) {
    if (b < r) { vmax = g; vmid = r; vmin = b; cat = 1; }
    else if (b > g) { vmax = b; vmid = g; vmin = r; cat = 3; }
    else { vmax = g; vmid = b; vmin = r; cat = 2; }
  } else {
    if (b < g) { vmax = r; vmid = g; vmin = b; cat = 0; }
    else if (b > r) { vmax = b; vmid = r; vmin = g; cat = 4; }
    else { vmax = r; vmid = b; vmin = g; cat = 5; }
  }
  float h;
  if (vmax == vmin) {
    h = 0.f;
  } else {
    float ratio = (vmid - vmin) / (vmax - vmin);
    h = static_cast<float>(cat) + (cat % 2 == 0 ? ratio : 1.f - ratio);
  }
  h = h + delta * 6.f;
  if (h < 0) h = h + 6.f;
  if (h >= 6) h = h - 6.f;
  cat = static_cast<int>(h);
  float ratio = h - static_cast<float>(cat);
  if (cat % 2 != 0) ratio = 1.f - ratio;
  vmid = vmin + ratio * (vmax - vmin);
  switch (cat) {
    case 0: o[0] = vmax; o[1] = vmid; o[2] = vmin; break;
    case 1: o[0] = vmid; o[1] = vmax; o[2] = vmin; break;
    case 2: o[0] = vmin; o[1] = vmax; o[2] = vmid; break;
    case 3: o[0] = vmin; o[1] = vmid; o[2] = vmax; break;
    case 4: o[0] = vmid; o[1] = vmin; o[2] = vmax; break;
    default: o[0] = vmax; o[1] = vmin; o[2] = vmid; break;
  }
}

}  // namespace

extern "C" {

// img uint8 (h, w, 3) -> out uint8 (h, w, 3). The column spans (w outputs
// over cw inputs) and row spans (h outputs over ch inputs) are
// `augment.py::_spans`. Returns 0.
int openvla_augment_image(const uint8_t* img, int h, int w, int oy, int ox, int ch, int cw,
                          float brightness, float contrast, float sat, float hue_delta,
                          const int64_t* col_starts, const float* col_weights, int col_span,
                          const int64_t* row_starts, const float* row_weights, int row_span,
                          uint8_t* out) {
  const int64_t n = int64_t(h) * w;
  std::vector<float> crop(size_t(ch) * cw * 3), mid(size_t(ch) * w * 3), big(size_t(n) * 3);
  for (int y = 0; y < ch; ++y)
    for (int x = 0; x < cw * 3; ++x)
      crop[size_t(y) * cw * 3 + x] = static_cast<float>(img[(size_t(oy + y) * w + ox) * 3 + x]);
  for (int y = 0; y < ch; ++y)  // columns: (cw, 3) -> (w, 3) on each row
    gather(crop.data() + size_t(y) * cw * 3, cw, 3, col_starts, col_weights, col_span, w, 3, 3, 1,
           mid.data() + size_t(y) * w * 3);
  gather(mid.data(), ch, int64_t(w) * 3, row_starts, row_weights, row_span, h, int64_t(w) * 3,
         int64_t(w) * 3, 1, big.data());
  std::vector<uint8_t> u8(size_t(n) * 3);
  for (int64_t i = 0; i < n * 3; ++i) {
    float r = std::nearbyint(big[i]);
    u8[i] = static_cast<uint8_t>(r < 0.f ? 0.f : r > 255.f ? 255.f : r);
  }
  std::vector<float> f(size_t(n) * 3);
  for (int64_t i = 0; i < n * 3; ++i)  // brightness
    u8[i] = to_u8(static_cast<float>(u8[i]) * kInv255 + brightness, true);
  for (int64_t i = 0; i < n * 3; ++i) f[i] = static_cast<float>(u8[i]) * kInv255;
  float mean[3];
  channel_mean(f.data(), n, mean);
  for (int64_t i = 0; i < n * 3; ++i)  // contrast
    u8[i] = to_u8(mean[i % 3] + contrast * (f[i] - mean[i % 3]), true);
  float o[3];
  for (int64_t p = 0; p < n; ++p) {  // saturation
    const uint8_t* q = &u8[size_t(p) * 3];
    saturation(q[0] * kInv255, q[1] * kInv255, q[2] * kInv255, sat, o);
    for (int c = 0; c < 3; ++c) u8[size_t(p) * 3 + c] = to_u8(o[c], false);
  }
  for (int64_t p = 0; p < n; ++p) {  // hue
    const uint8_t* q = &u8[size_t(p) * 3];
    hue(q[0] * kInv255, q[1] * kInv255, q[2] * kInv255, hue_delta, o);
    for (int c = 0; c < 3; ++c) out[size_t(p) * 3 + c] = to_u8(o[c], false);
  }
  return 0;
}

}  // extern "C"
