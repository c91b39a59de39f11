// Baseline JPEG encoder that writes PIL's bytes:
// `PIL.Image.fromarray(frame).save(buf, "JPEG", quality=q)` under
// libjpeg-turbo, for an RGB frame (YCbCr 4:2:0) or a grey one. The data
// scripts call it; `processing/jpeg_encode.py`'s plain version is the same
// coder over `processing/jpeg.py`'s torch stages, and tests hold this one to
// it and to PIL, byte for byte.
//
// The stages, each a copy of the libjpeg source it names:
//   quant tables  jcparam.c   jpeg_quality_scaling, jpeg_add_quant_table with
//                             force_baseline (entries clipped to [1, 255])
//   colour        jccolor.c   rgb_ycc_convert (SCALEBITS 16)
//   edges         jcsample.c  expand_right_edge, jcprepct.c expand_bottom_edge
//   downsample    jcsample.c  h2v2_downsample, bias 1, 2, 1, 2... along the row
//   forward DCT   jfdctint.c  jpeg_fdct_islow on samples - 128
//   quantize      jcdctmgr.c  sign(c) ((|c| + 4 q) / (8 q))
//   blocks        jccoefct.c  compress_data: dummy blocks at the MCU grid's
//                             right and bottom edges, AC zero and DC the
//                             block before
//   entropy       jchuff.c    encode_one_block with the standard tables
//                             (jstdhuff.c), 0xFF stuffed with 0x00, the last
//                             byte padded with 1 bits
//   markers       jcmarker.c  SOI, JFIF APP0, DQT a table, SOF0, DHT a
//                             table, SOS, the scan, EOI
//
// Plain C interface (ctypes), no state between calls.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct EncodeError {
  std::string what;
};

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kStdLuminance[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChrominance[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: the code-length counts and symbols of the standard tables.
const uint8_t kDcLumCounts[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromCounts[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcSymbols[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumCounts[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumSymbols[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromCounts[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromSymbols[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  const uint8_t* counts;
  const uint8_t* symbols;
  int n;
  uint16_t code[256] = {};
  uint8_t size[256] = {};
  HuffTable(const uint8_t* c, const uint8_t* s, int count) : counts(c), symbols(s), n(count) {
    // jchuff.c jpeg_make_c_derived_tbl
    int k = 0;
    uint32_t next = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < counts[len - 1]; ++i, ++k) {
        code[symbols[k]] = static_cast<uint16_t>(next++);
        size[symbols[k]] = static_cast<uint8_t>(len);
      }
      next <<= 1;
    }
  }
};

class Writer {
 public:
  explicit Writer(std::vector<uint8_t>& out) : out_(out) {}
  void bytes(const uint8_t* p, size_t n) { out_.insert(out_.end(), p, p + n); }
  void byte(int b) { out_.push_back(static_cast<uint8_t>(b)); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  // jchuff.c emit_bits: MSB first, every 0xFF followed by a 0x00.
  void bits(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    n_ += size;
    while (n_ >= 8) {
      n_ -= 8;
      int b = static_cast<int>((acc_ >> n_) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
    }
    acc_ &= (uint64_t(1) << n_) - 1;
  }
  // jchuff.c flush_bits: the partial byte filled with 1 bits.
  void flush() {
    if (n_) bits(0x7F, 8 - n_);
  }

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int n_ = 0;
};

inline int32_t fix16(double x) { return static_cast<int32_t>(x * 65536 + 0.5); }

// jdct.h DESCALE.
inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// jfdctint.c, one pass of jpeg_fdct_islow over 8 values at stride `s`.
void fdct_1d(int32_t* d, int s, bool first) {
  int32_t tmp0 = d[0] + d[7 * s], tmp7 = d[0] - d[7 * s];
  int32_t tmp1 = d[s] + d[6 * s], tmp6 = d[s] - d[6 * s];
  int32_t tmp2 = d[2 * s] + d[5 * s], tmp5 = d[2 * s] - d[5 * s];
  int32_t tmp3 = d[3 * s] + d[4 * s], tmp4 = d[3 * s] - d[4 * s];
  int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int n;
  if (first) {
    d[0] = (tmp10 + tmp11) * 4;  // << PASS1_BITS
    d[4 * s] = (tmp10 - tmp11) * 4;
    n = 13 - 2;
  } else {
    d[0] = descale(tmp10 + tmp11, 2);
    d[4 * s] = descale(tmp10 - tmp11, 2);
    n = 13 + 2;
  }
  int32_t z1 = (tmp12 + tmp13) * 4433;     // FIX_0_541196100
  d[2 * s] = descale(z1 + tmp13 * 6270, n);  // FIX_0_765366865
  d[6 * s] = descale(z1 + tmp12 * -15137, n);  // FIX_1_847759065
  z1 = tmp4 + tmp7;
  int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  int32_t z5 = (z3 + z4) * 9633;  // FIX_1_175875602
  tmp4 *= 2446;                   // FIX_0_298631336
  tmp5 *= 16819;                  // FIX_2_053119869
  tmp6 *= 25172;                  // FIX_3_072711026
  tmp7 *= 12299;                  // FIX_1_501321110
  z1 *= -7373;                    // FIX_0_899976223
  z2 *= -20995;                   // FIX_2_562915447
  z3 = z3 * -16069 + z5;          // FIX_1_961570560
  z4 = z4 * -3196 + z5;           // FIX_0_390180644
  d[7 * s] = descale(tmp4 + z1 + z3, n);
  d[5 * s] = descale(tmp5 + z2 + z4, n);
  d[3 * s] = descale(tmp6 + z2 + z3, n);
  d[s] = descale(tmp7 + z1 + z4, n);
}

struct Plane {
  int w = 0, h = 0;  // padded size
  std::vector<int32_t> s;
  int32_t at(int y, int x) const { return s[size_t(y) * w + x]; }
};

// The samples (rows x cols, row stride `stride`) replicated at the right and
// bottom edges to (h, w).
Plane pad(const int32_t* p, int rows, int cols, int stride, int h, int w) {
  Plane out;
  out.w = w;
  out.h = h;
  out.s.resize(size_t(w) * h);
  for (int y = 0; y < h; ++y) {
    const int32_t* src = p + size_t(std::min(y, rows - 1)) * stride;
    for (int x = 0; x < w; ++x) out.s[size_t(y) * w + x] = src[std::min(x, cols - 1)];
  }
  return out;
}

struct Comp {
  int id, h, v, table, huff;
  int bw, bh;
  std::vector<int16_t> coef;  // bh * bw * 64, zig-zag order, quantized
};

// Every block of the plane's top-left bh x bw through forward_DCT and the
// quantizer `q` (natural order).
void blocks(const Plane& p, const int* q, Comp& c) {
  c.coef.resize(size_t(c.bh) * c.bw * 64);
  int32_t d[64];
  for (int by = 0; by < c.bh; ++by) {
    for (int bx = 0; bx < c.bw; ++bx) {
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x) d[8 * y + x] = p.at(8 * by + y, 8 * bx + x) - 128;
      for (int r = 0; r < 8; ++r) fdct_1d(d + 8 * r, 1, true);
      for (int col = 0; col < 8; ++col) fdct_1d(d + col, 8, false);
      int16_t* out = c.coef.data() + (size_t(by) * c.bw + bx) * 64;
      for (int k = 0; k < 64; ++k) {
        int i = kZigzag[k];
        int32_t div = 8 * q[i], v = d[i];
        int32_t m = ((v < 0 ? -v : v) + div / 2) / div;
        out[k] = static_cast<int16_t>(v < 0 ? -m : m);
      }
    }
  }
}

// jchuff.c encode_one_block.
void encode_block(Writer& w, const int16_t* zz, int& last_dc, const HuffTable& dc,
                  const HuffTable& ac) {
  int diff = zz[0] - last_dc;
  last_dc = zz[0];
  int mag = diff < 0 ? -diff : diff, nbits = 0;
  while (mag >> nbits) ++nbits;
  w.bits(dc.code[nbits], dc.size[nbits]);
  if (nbits) w.bits(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nbits);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = zz[k];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    mag = v < 0 ? -v : v;
    nbits = 0;
    while (mag >> nbits) ++nbits;
    int sym = (run << 4) + nbits;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits(static_cast<uint32_t>(v < 0 ? v - 1 : v), nbits);
    run = 0;
  }
  if (run) w.bits(ac.code[0], ac.size[0]);
}

void segment(Writer& w, int marker, const std::vector<uint8_t>& body) {
  w.byte(0xFF);
  w.byte(marker);
  w.word(static_cast<int>(body.size()) + 2);
  w.bytes(body.data(), body.size());
}

void encode(const uint8_t* frame, int height, int width, int channels, int quality,
            std::vector<uint8_t>& out) {
  // jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
  int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  int q[2][64];
  for (int i = 0; i < 64; ++i) {
    q[0][i] = std::min(std::max((kStdLuminance[i] * scale + 50) / 100, 1), 255);
    q[1][i] = std::min(std::max((kStdChrominance[i] * scale + 50) / 100, 1), 255);
  }
  std::vector<Comp> comps;
  int hmax = channels == 3 ? 2 : 1;
  int bw_y = (width + 7) / 8, bh_y = (height + 7) / 8;
  size_t npix = size_t(width) * height;
  if (channels == 1) {
    std::vector<int32_t> y(npix);
    for (size_t i = 0; i < npix; ++i) y[i] = frame[i];
    comps.push_back({1, 1, 1, 0, 0, bw_y, bh_y, {}});
    blocks(pad(y.data(), height, width, width, 8 * bh_y, 8 * bw_y), q[0], comps[0]);
  } else {
    // jccolor.c rgb_ycc_convert
    const int32_t half = 1 << 15, cbcr = 128 << 16;
    const int32_t yr = fix16(0.299), yg = fix16(0.587), yb = fix16(0.114);
    const int32_t cbr = fix16(0.16874), cbg = fix16(0.33126), c5 = fix16(0.5);
    const int32_t crg = fix16(0.41869), crb = fix16(0.08131);
    std::vector<int32_t> ycc[3];
    for (auto& p : ycc) p.resize(npix);
    for (size_t i = 0; i < npix; ++i) {
      int32_t r = frame[3 * i], g = frame[3 * i + 1], b = frame[3 * i + 2];
      ycc[0][i] = (yr * r + yg * g + yb * b + half) >> 16;
      ycc[1][i] = (-cbr * r - cbg * g + c5 * b + cbcr + half - 1) >> 16;
      ycc[2][i] = (c5 * r - crg * g - crb * b + cbcr + half - 1) >> 16;
    }
    comps.push_back({1, 2, 2, 0, 0, bw_y, bh_y, {}});
    blocks(pad(ycc[0].data(), height, width, width, 8 * bh_y, 8 * bw_y), q[0], comps[0]);
    int cw = (width + 1) / 2, ch = (height + 1) / 2;
    int bw_c = (cw + 7) / 8, bh_c = (ch + 7) / 8;
    for (int k = 1; k < 3; ++k) {
      // jcsample.c h2v2_downsample over the edge-replicated plane, then
      // the subsampled rows replicated to the blocks' height
      Plane full = pad(ycc[k].data(), height, width, width, 2 * ch, 16 * bw_c);
      std::vector<int32_t> sub(size_t(8 * bw_c) * ch);
      for (int y = 0; y < ch; ++y)
        for (int x = 0; x < 8 * bw_c; ++x)
          sub[size_t(y) * 8 * bw_c + x] =
              (full.at(2 * y, 2 * x) + full.at(2 * y, 2 * x + 1) + full.at(2 * y + 1, 2 * x) +
               full.at(2 * y + 1, 2 * x + 1) + (x % 2 + 1)) >> 2;
      comps.push_back({k + 1, 1, 1, 1, 1, bw_c, bh_c, {}});
      blocks(pad(sub.data(), ch, 8 * bw_c, 8 * bw_c, 8 * bh_c, 8 * bw_c), q[1], comps.back());
    }
  }

  Writer w(out);
  static const uint8_t kJfif[18] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J',  'F',  'I',
                                    'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01};
  w.bytes(kJfif, sizeof(kJfif));
  w.word(0);  // no thumbnail
  int ntables = channels == 3 ? 2 : 1;
  for (int t = 0; t < ntables; ++t) {
    std::vector<uint8_t> body{static_cast<uint8_t>(t)};
    for (int k = 0; k < 64; ++k) body.push_back(static_cast<uint8_t>(q[t][kZigzag[k]]));
    segment(w, 0xDB, body);
  }
  std::vector<uint8_t> sof{8, static_cast<uint8_t>(height >> 8), static_cast<uint8_t>(height),
                           static_cast<uint8_t>(width >> 8), static_cast<uint8_t>(width),
                           static_cast<uint8_t>(comps.size())};
  for (const auto& c : comps) {
    sof.push_back(static_cast<uint8_t>(c.id));
    sof.push_back(static_cast<uint8_t>((c.h << 4) | c.v));
    sof.push_back(static_cast<uint8_t>(c.table));
  }
  segment(w, 0xC0, sof);
  const HuffTable dc[2] = {HuffTable(kDcLumCounts, kDcSymbols, 12),
                           HuffTable(kDcChromCounts, kDcSymbols, 12)};
  const HuffTable ac[2] = {HuffTable(kAcLumCounts, kAcLumSymbols, 162),
                           HuffTable(kAcChromCounts, kAcChromSymbols, 162)};
  for (int t = 0; t < ntables; ++t) {
    for (int cls = 0; cls < 2; ++cls) {
      const HuffTable& ht = cls ? ac[t] : dc[t];
      std::vector<uint8_t> body{static_cast<uint8_t>((cls << 4) | t)};
      body.insert(body.end(), ht.counts, ht.counts + 16);
      body.insert(body.end(), ht.symbols, ht.symbols + ht.n);
      segment(w, 0xC4, body);
    }
  }
  std::vector<uint8_t> sos{static_cast<uint8_t>(comps.size())};
  for (const auto& c : comps) {
    sos.push_back(static_cast<uint8_t>(c.id));
    sos.push_back(static_cast<uint8_t>((c.huff << 4) | c.huff));
  }
  sos.insert(sos.end(), {0, 63, 0});
  segment(w, 0xDA, sos);

  std::vector<int> last(comps.size(), 0);
  if (comps.size() == 1) {
    const Comp& c = comps[0];
    for (size_t b = 0; b < size_t(c.bw) * c.bh; ++b)
      encode_block(w, c.coef.data() + 64 * b, last[0], dc[0], ac[0]);
  } else {
    int mx = (width + 8 * hmax - 1) / (8 * hmax), my = (height + 8 * hmax - 1) / (8 * hmax);
    int16_t dummy[64];
    for (int my_i = 0; my_i < my; ++my_i) {
      for (int mx_i = 0; mx_i < mx; ++mx_i) {
        for (size_t ci = 0; ci < comps.size(); ++ci) {
          const Comp& c = comps[ci];
          // jccoefct.c compress_data: the last MCU column's real blocks,
          // the last MCU row's real block rows; dummy blocks after them
          int cnt = mx_i < mx - 1 ? c.h : (c.bw % c.h ? c.bw % c.h : c.h);
          int rows = my_i < my - 1 ? c.v : (c.bh % c.v ? c.bh % c.v : c.v);
          int prev_dc = 0;
          for (int yi = 0; yi < c.v; ++yi) {
            for (int xi = 0; xi < c.h; ++xi) {
              const int16_t* blk;
              if (yi < rows && xi < cnt) {
                blk = c.coef.data() +
                      (size_t(my_i * c.v + yi) * c.bw + mx_i * c.h + xi) * 64;
              } else {
                std::memset(dummy, 0, sizeof(dummy));
                dummy[0] = static_cast<int16_t>(prev_dc);
                blk = dummy;
              }
              prev_dc = blk[0];
              encode_block(w, blk, last[ci], dc[c.huff], ac[c.huff]);
            }
          }
        }
      }
    }
  }
  w.flush();
  w.byte(0xFF);
  w.byte(0xD9);
}

void set_encode_error(char* err, int err_len, const std::string& what) {
  if (err != nullptr && err_len > 0) std::snprintf(err, err_len, "%s", what.c_str());
}

}  // namespace

extern "C" {

// An upper bound on the stream's size: the markers, and per 8 x 8 block
// (at most 6 for every 16 x 16 pixels, dummy blocks included) at most 64
// codes of 16 + 11 bits, every byte possibly stuffed: 432 bytes.
int64_t openvla_jpeg_encode_bound(int height, int width) {
  return 2048 + (int64_t(width + 15) / 16) * ((height + 15) / 16) * 6 * 432;
}

// uint8 (height, width, channels) frame, channels 3 (RGB) or 1 (grey) ->
// PIL's JPEG bytes at `quality` (1..100) in `out` (`cap` bytes), their count
// in `n`. 0 on success, else -1 with a message in `err`.
int openvla_jpeg_encode(const uint8_t* frame, int height, int width, int channels, int quality,
                        uint8_t* out, int64_t cap, int64_t* n, char* err, int err_len) {
  try {
    if (height < 1 || width < 1 || height > 65535 || width > 65535)
      throw EncodeError{"frame size out of range"};
    if (channels != 1 && channels != 3) throw EncodeError{"channels must be 1 or 3"};
    if (quality < 1 || quality > 100) throw EncodeError{"quality not in [1, 100]"};
    std::vector<uint8_t> buf;
    encode(frame, height, width, channels, quality, buf);
    if (static_cast<int64_t>(buf.size()) > cap) throw EncodeError{"output buffer too small"};
    std::memcpy(out, buf.data(), buf.size());
    *n = static_cast<int64_t>(buf.size());
    return 0;
  } catch (const EncodeError& e) {
    set_encode_error(err, err_len, e.what);
  } catch (const std::exception& e) {
    set_encode_error(err, err_len, e.what());
  }
  return -1;
}

}  // extern "C"
