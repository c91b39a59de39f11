// Baseline JPEG decoder: what libjpeg(-turbo) gives under
// `tf.io.decode_jpeg(data, channels=3)` (the IFAST inverse DCT, fancy
// upsampling) or, with the ISLOW inverse DCT, under PIL's
// `Image.open(...).convert("RGB")`, for the host side of the data paths.
//
// The integer stages are those of `processing/jpeg.py`, each a copy of the
// libjpeg source it names there:
//   dequantize   jddctmgr.c  the IFAST multipliers (q * aanscale + 2^11) >> 12,
//                            or the table itself (ISLOW)
//   inverse_dct  jidctfst.c  jpeg_idct_ifast, (x >> 5) + 128 saturated; or
//                jidctint.c  jpeg_idct_islow in 64-bit sums, DESCALE by 11
//                            then 18 bits, + 128 saturated
//   upsample     jdsample.c  h2v2_fancy_upsample (h2v2_upsample below 3 columns)
//   ycbcr_to_rgb jdcolor.c   ycc_rgb_convert; a grey plane is replicated
// and the byte stream is jdmarker.c's and jdhuff.c's: SOI, APPn and COM
// skipped, DQT (8- and 16-bit), SOF0 and SOF1, DHT, SOS, DRI, RSTn, EOI;
// Huffman decoding with 0xFF00 stuffing, DC prediction reset at every
// restart marker, EOB and ZRL runs, zig-zag order, and zeros read past the
// end of the data (jdhuff.c fills the bit buffer with zeros at a marker).
// Progressive, lossless, hierarchical, arithmetic-coded and 12-bit streams
// are refused, naming their SOF marker; so is any sampling layout other
// than 4:4:4, 4:2:0 and one grey component.
//
// Plain C interface (ctypes, which releases the GIL around each call), no
// state between calls: a pool of threads decodes in parallel.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

// jutils.c jpeg_natural_order, with 16 extra entries: a corrupt run past
// coefficient 63 writes coefficient 63 (as libjpeg does).
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jddctmgr.c: the AA&N scale factors, scaled by 2^14, natural order.
const int32_t kAanScales[64] = {
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,
    19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,
    8867,  12299, 11585, 10426, 8867,  6967,  4799,  2446,
    4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};

struct Error {
  std::string what;
};

struct Huffman {
  // Indexed by the next 16 bits of the stream: (code length << 8) | symbol,
  // 0 where no code is a prefix of those bits.
  std::vector<uint16_t> lookup;
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc = 0, ac = 0;      // Huffman table slots of the current scan
  int pred = 0;            // DC predictor
  int width = 0, height = 0;       // samples (downsampled size)
  int blocks_w = 0, blocks_h = 0;  // blocks of the padded plane
  std::vector<uint8_t> plane;      // blocks_h * 8 rows of blocks_w * 8
};

class BitReader {
 public:
  BitReader(const uint8_t* p, size_t n) : p_(p), n_(n) {}
  int peek16() {
    if (cnt_ < 16) fill();
    return static_cast<int>(buf_ >> 48);
  }
  void skip(int k) {
    buf_ <<= k;
    cnt_ -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    if (cnt_ < k) fill();
    int v = static_cast<int>(buf_ >> (64 - k));
    skip(k);
    return v;
  }

 private:
  void fill() {
    while (cnt_ <= 56) {
      uint64_t b = i_ < n_ ? p_[i_] : 0;  // zeros past the end
      ++i_;
      buf_ |= b << (56 - cnt_);
      cnt_ += 8;
    }
  }
  const uint8_t* p_;
  size_t n_, i_ = 0;
  uint64_t buf_ = 0;
  int cnt_ = 0;
};

inline int extend(int v, int s) {  // jdhuff.c HUFF_EXTEND
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

inline int decode_symbol(BitReader& bits, const Huffman& t) {
  uint16_t e = t.lookup[bits.peek16()];
  if (e == 0) throw Error{"corrupt JPEG data: bad Huffman code"};
  bits.skip(e >> 8);
  return e & 0xFF;
}

inline int32_t ifast_mul(int32_t v, int32_t c) { return (v * c) >> 8; }

// jidctfst.c, one pass of the AA&N butterfly over 8 values at stride `s`.
inline void idct_1d(int32_t* t, int s) {
  int32_t c0 = t[0], c1 = t[s], c2 = t[2 * s], c3 = t[3 * s];
  int32_t c4 = t[4 * s], c5 = t[5 * s], c6 = t[6 * s], c7 = t[7 * s];
  int32_t tmp10 = c0 + c4, tmp11 = c0 - c4;  // even part
  int32_t tmp13 = c2 + c6;
  int32_t tmp12 = ifast_mul(c2 - c6, 362) - tmp13;  // FIX_1_414213562
  int32_t tmp0 = tmp10 + tmp13, tmp3 = tmp10 - tmp13;
  int32_t tmp1 = tmp11 + tmp12, tmp2 = tmp11 - tmp12;
  int32_t z13 = c5 + c3, z10 = c5 - c3;  // odd part
  int32_t z11 = c1 + c7, z12 = c1 - c7;
  int32_t tmp7 = z11 + z13;
  tmp11 = ifast_mul(z11 - z13, 362);  // FIX_1_414213562
  int32_t z5 = ifast_mul(z10 + z12, 473);  // FIX_1_847759065
  tmp10 = ifast_mul(z12, 277) - z5;   // FIX_1_082392200
  tmp12 = ifast_mul(z10, -669) + z5;  // FIX_2_613125930
  int32_t tmp6 = tmp12 - tmp7;
  int32_t tmp5 = tmp11 - tmp6;
  int32_t tmp4 = tmp10 + tmp5;
  t[0] = tmp0 + tmp7;
  t[s] = tmp1 + tmp6;
  t[2 * s] = tmp2 + tmp5;
  t[3 * s] = tmp3 - tmp4;
  t[4 * s] = tmp3 + tmp4;
  t[5 * s] = tmp2 - tmp5;
  t[6 * s] = tmp1 - tmp6;
  t[7 * s] = tmp0 - tmp7;
}

inline uint8_t clamp255(int32_t x) {
  return static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x);
}

// Dequantized coefficients (natural order, [u][v]) -> samples, written to
// `out` with row stride `stride`: columns, then rows, then
// (x >> 5) + 128, saturated.
void inverse_dct(int32_t* blk, uint8_t* out, int stride) {
  for (int col = 0; col < 8; ++col) idct_1d(blk + col, 8);
  for (int row = 0; row < 8; ++row) {
    int32_t* r = blk + 8 * row;
    idct_1d(r, 1);
    for (int c = 0; c < 8; ++c) out[row * stride + c] = clamp255((r[c] >> 5) + 128);
  }
}

// jdct.h DESCALE: a right shift that rounds half up.
inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jidctint.c, one pass of the LL&M butterfly over 8 values at stride `s`,
// each output DESCALEd by `n` bits.
inline void islow_1d(int64_t* t, int s, int n) {
  int64_t c0 = t[0], c1 = t[s], c2 = t[2 * s], c3 = t[3 * s];
  int64_t c4 = t[4 * s], c5 = t[5 * s], c6 = t[6 * s], c7 = t[7 * s];
  int64_t z1 = (c2 + c6) * 4433;            // FIX_0_541196100
  int64_t tmp2 = z1 + c6 * -15137;          // FIX_1_847759065
  int64_t tmp3 = z1 + c2 * 6270;            // FIX_0_765366865
  int64_t tmp0 = (c0 + c4) * 8192, tmp1 = (c0 - c4) * 8192;  // << CONST_BITS
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = c7;  // odd part
  tmp1 = c5;
  tmp2 = c3;
  tmp3 = c1;
  z1 = tmp0 + tmp3;
  int64_t z2 = tmp1 + tmp2, z3 = tmp0 + tmp2, z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * 9633;            // FIX_1_175875602
  tmp0 *= 2446;                             // FIX_0_298631336
  tmp1 *= 16819;                            // FIX_2_053119869
  tmp2 *= 25172;                            // FIX_3_072711026
  tmp3 *= 12299;                            // FIX_1_501321110
  z1 *= -7373;                              // FIX_0_899976223
  z2 *= -20995;                             // FIX_2_562915447
  z3 = z3 * -16069 + z5;                    // FIX_1_961570560
  z4 = z4 * -3196 + z5;                     // FIX_0_390180644
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  t[0] = descale(tmp10 + tmp3, n);
  t[7 * s] = descale(tmp10 - tmp3, n);
  t[s] = descale(tmp11 + tmp2, n);
  t[6 * s] = descale(tmp11 - tmp2, n);
  t[2 * s] = descale(tmp12 + tmp1, n);
  t[5 * s] = descale(tmp12 - tmp1, n);
  t[3 * s] = descale(tmp13 + tmp0, n);
  t[4 * s] = descale(tmp13 - tmp0, n);
}

inline uint8_t clamp255_64(int64_t x) {
  return static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x);
}

// As inverse_dct, by jpeg_idct_islow: columns (DESCALE by CONST_BITS -
// PASS1_BITS = 11), then rows (by CONST_BITS + PASS1_BITS + 3 = 18), + 128.
void inverse_dct_islow(const int32_t* blk, uint8_t* out, int stride) {
  int64_t w[64];
  for (int i = 0; i < 64; ++i) w[i] = blk[i];
  for (int col = 0; col < 8; ++col) islow_1d(w + col, 8, 11);
  for (int row = 0; row < 8; ++row) {
    int64_t* r = w + 8 * row;
    islow_1d(r, 1, 18);
    for (int c = 0; c < 8; ++c) out[row * stride + c] = clamp255_64(r[c] + 128);
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n, bool islow = false)
      : d_(data), n_(n), islow_(islow) {}

  // Parses the markers up to the first SOF (the frame header).
  void header() {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) throw Error{"not a JPEG stream (no SOI)"};
    pos_ = 2;
    while (!frame_) {
      int m = next_marker();
      if (m == 0xD9) throw Error{"EOI before a frame header"};
      segment(m);
    }
  }

  void decode(uint8_t* out) {
    header();
    bool scanned = false;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        scan();
        scanned = true;
      } else {
        segment(m);
      }
    }
    if (!scanned) throw Error{"no scan (SOS) before EOI"};
    emit(out);
  }

  int width = 0, height = 0;

 private:
  int byte() {
    if (pos_ >= n_) throw Error{"premature end of JPEG data"};
    return d_[pos_++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker() {
    int b = byte();
    if (b != 0xFF) throw Error{"expected a marker, found byte " + std::to_string(b)};
    while (b == 0xFF) b = byte();  // fill bytes
    return b;
  }
  size_t segment_end() {
    size_t start = pos_;
    int len = word();
    if (len < 2 || start + len > n_) throw Error{"bad marker segment length"};
    return start + len;
  }

  void segment(int m) {
    static const char* kRefused[16] = {
        nullptr, nullptr, "progressive DCT (SOF2)", "lossless (SOF3)", nullptr,
        "differential sequential (SOF5)", "differential progressive (SOF6)",
        "differential lossless (SOF7)", nullptr, "arithmetic-coded sequential (SOF9)",
        "arithmetic-coded progressive (SOF10)", "arithmetic-coded lossless (SOF11)",
        "arithmetic coding conditioning (DAC)", "arithmetic-coded differential sequential (SOF13)",
        "arithmetic-coded differential progressive (SOF14)",
        "arithmetic-coded differential lossless (SOF15)"};
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && kRefused[m - 0xC0])
      throw Error{std::string("unsupported JPEG: ") + kRefused[m - 0xC0]};
    size_t end = segment_end();
    switch (m) {
      case 0xC0:
      case 0xC1:
        sof(end);
        break;
      case 0xC4:
        dht(end);
        break;
      case 0xDB:
        dqt(end);
        break;
      case 0xDD:
        restart_interval_ = word();
        break;
      case 0xDC:
        throw Error{"unsupported JPEG: DNL marker"};
      case 0xEE:  // APP14 (Adobe): its colour transform
        if (end - pos_ >= 12 && std::memcmp(d_ + pos_, "Adobe", 5) == 0)
          adobe_transform_ = d_[pos_ + 11];
        break;
      default:  // APPn, COM and anything else with a length
        break;
    }
    pos_ = end;
  }

  void sof(size_t end) {
    if (frame_) throw Error{"a second frame header"};
    int precision = byte();
    if (precision != 8)
      throw Error{"unsupported JPEG: " + std::to_string(precision) +
                  "-bit samples (SOF precision)"};
    height = word();
    width = word();
    int nc = byte();
    if (height <= 0 || width <= 0) throw Error{"unsupported JPEG: zero image size (DNL)"};
    if (static_cast<int64_t>(height) * width > (int64_t(1) << 28))
      throw Error{"JPEG image too large"};
    if (nc != 1 && nc != 3)
      throw Error{"unsupported JPEG: " + std::to_string(nc) + " components"};
    comps_.resize(nc);
    for (auto& c : comps_) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw Error{"bad component in the frame header"};
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    if (pos_ != end) throw Error{"bad frame header length"};
    if (nc == 1) {
      hmax_ = vmax_ = comps_[0].h = comps_[0].v = 1;  // one block an MCU
    } else {
      bool ok = comps_[1].h == 1 && comps_[1].v == 1 && comps_[2].h == 1 && comps_[2].v == 1 &&
                ((comps_[0].h == 1 && comps_[0].v == 1) || (comps_[0].h == 2 && comps_[0].v == 2));
      if (!ok)
        throw Error{"unsupported JPEG sampling (Y " + std::to_string(comps_[0].h) + "x" +
                    std::to_string(comps_[0].v) + ", Cb " + std::to_string(comps_[1].h) + "x" +
                    std::to_string(comps_[1].v) + ", Cr " + std::to_string(comps_[2].h) + "x" +
                    std::to_string(comps_[2].v) + "): only 4:4:4, 4:2:0 and grey"};
    }
    mcus_x_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcus_y_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      c.width = (width * c.h + hmax_ - 1) / hmax_;
      c.height = (height * c.v + vmax_ - 1) / vmax_;
      c.blocks_w = mcus_x_ * c.h;
      c.blocks_h = mcus_y_ * c.v;
    }
    frame_ = true;
  }

  void dqt(size_t end) {
    while (pos_ < end) {
      int pq = byte();
      int tq = pq & 15;
      if (tq > 3) throw Error{"bad DQT table id"};
      for (int k = 0; k < 64; ++k) {
        int q = (pq >> 4) ? word() : byte();
        // jddctmgr.c keeps the multiplier in a short (IFAST_MULT_TYPE,
        // ISLOW_MULT_TYPE): the ISLOW one is the table entry itself.
        int32_t mult = islow_ ? static_cast<int16_t>(q)
                              : static_cast<int16_t>((static_cast<int64_t>(q) *
                                                          kAanScales[kNatural[k]] +
                                                      (1 << 11)) >> 12);
        mult_[tq][kNatural[k]] = mult;
      }
      qdef_[tq] = true;
    }
  }

  void dht(size_t end) {
    while (pos_ < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error{"bad DHT table id"};
      int counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = byte();
      if (total > 256 || pos_ + total > end) throw Error{"bad DHT table"};
      Huffman& t = (tc ? ac_ : dc_)[th];
      t.lookup.assign(65536, 0);
      uint32_t code = 0;
      for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < counts[l]; ++i) {
          int sym = byte();
          if (code >= (1u << l)) throw Error{"bad Huffman table (code space)"};
          uint32_t lo = code << (16 - l), hi = (code + 1) << (16 - l);
          for (uint32_t x = lo; x < hi; ++x) t.lookup[x] = static_cast<uint16_t>((l << 8) | sym);
          ++code;
        }
        code <<= 1;
      }
    }
  }

  // The entropy-coded data from pos_ to the next marker other than RSTn, as
  // one unstuffed byte string per restart interval.
  std::vector<std::vector<uint8_t>> intervals() {
    std::vector<std::vector<uint8_t>> out(1);
    while (pos_ < n_) {
      uint8_t b = d_[pos_];
      if (b != 0xFF) {
        out.back().push_back(b);
        ++pos_;
        continue;
      }
      size_t j = pos_ + 1;
      while (j < n_ && d_[j] == 0xFF) ++j;
      if (j >= n_) break;
      if (d_[j] == 0x00) {
        out.back().push_back(0xFF);
        pos_ = j + 1;
      } else if (d_[j] >= 0xD0 && d_[j] <= 0xD7) {
        out.emplace_back();
        pos_ = j + 1;
      } else {
        break;  // the next marker; next_marker() reads it
      }
    }
    return out;
  }

  void scan() {
    if (!frame_) throw Error{"SOS before a frame header"};
    size_t end = segment_end();
    int ns = byte();
    if (ns < 1 || ns > static_cast<int>(comps_.size())) throw Error{"bad scan header"};
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int cs = byte(), t = byte();
      Component* c = nullptr;
      for (auto& k : comps_)
        if (k.id == cs) c = &k;
      if (c == nullptr) throw Error{"scan names an unknown component"};
      c->dc = t >> 4;
      c->ac = t & 15;
      if (c->dc > 3 || c->ac > 3 || dc_[c->dc].lookup.empty() || ac_[c->ac].lookup.empty())
        throw Error{"scan uses an undefined Huffman table"};
      if (!qdef_[c->tq]) throw Error{"component uses an undefined quantization table"};
      c->pred = 0;
      if (c->plane.empty()) c->plane.assign(size_t(c->blocks_w) * 8 * c->blocks_h * 8, 0);
      sc.push_back(c);
    }
    int ss = byte(), se = byte(), a = byte();
    if (ss != 0 || se != 63 || a != 0) throw Error{"unsupported JPEG: a progressive scan"};
    pos_ = end;

    // MCUs of the scan: interleaved, h x v blocks of each component; one
    // component alone, its blocks covering its real size.
    int units_x, units_y;
    if (ns == 1) {
      units_x = (sc[0]->width + 7) / 8;
      units_y = (sc[0]->height + 7) / 8;
    } else {
      units_x = mcus_x_;
      units_y = mcus_y_;
    }
    auto data = intervals();
    int64_t total = int64_t(units_x) * units_y;
    int64_t per = restart_interval_ > 0 ? restart_interval_ : total;
    size_t seg = 0;
    BitReader bits(data[0].data(), data[0].size());
    int32_t blk[64];
    for (int64_t m = 0; m < total; ++m) {
      if (m > 0 && m % per == 0) {
        ++seg;  // a restart: byte-aligned new data, predictors reset
        bits = seg < data.size() ? BitReader(data[seg].data(), data[seg].size())
                                 : BitReader(nullptr, 0);
        for (Component* c : sc) c->pred = 0;
      }
      int mx = static_cast<int>(m % units_x), my = static_cast<int>(m / units_x);
      for (Component* c : sc) {
        int bh = ns == 1 ? 1 : c->h, bv = ns == 1 ? 1 : c->v;
        for (int by = 0; by < bv; ++by) {
          for (int bx = 0; bx < bh; ++bx) {
            decode_block(bits, *c, blk);
            size_t row = size_t(my * bv + by) * 8, col = size_t(mx * bh + bx) * 8;
            int stride = c->blocks_w * 8;
            if (islow_)
              inverse_dct_islow(blk, c->plane.data() + row * stride + col, stride);
            else
              inverse_dct(blk, c->plane.data() + row * stride + col, stride);
          }
        }
      }
    }
  }

  void decode_block(BitReader& bits, Component& c, int32_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int32_t));
    int s = decode_symbol(bits, dc_[c.dc]);
    if (s > 15) throw Error{"corrupt JPEG data: bad DC magnitude"};
    c.pred += s ? extend(bits.get(s), s) : 0;
    blk[0] = c.pred;
    for (int k = 1; k < 64;) {
      int rs = decode_symbol(bits, ac_[c.ac]);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = extend(bits.get(s), s);
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;  // EOB
      }
    }
    const int32_t* mult = mult_[c.tq];
    for (int i = 0; i < 64; ++i) blk[i] *= mult[i];
  }

  // jdsample.c: the chroma plane at its real size (h, w) -> (2h, 2w).
  static std::vector<int32_t> upsample_h2v2(const Component& c) {
    int h = c.height, w = c.width, stride = c.blocks_w * 8;
    std::vector<int32_t> out(size_t(2 * h) * 2 * w);
    std::vector<int32_t> cols(w);
    for (int oy = 0; oy < 2 * h; ++oy) {
      int y = oy / 2;
      int ny = oy % 2 == 0 ? (y > 0 ? y - 1 : 0) : (y + 1 < h ? y + 1 : h - 1);
      const uint8_t* p = c.plane.data() + size_t(y) * stride;
      const uint8_t* q = c.plane.data() + size_t(ny) * stride;
      int32_t* o = out.data() + size_t(oy) * 2 * w;
      if (w <= 2) {  // h2v2_upsample: each sample 2 x 2
        for (int x = 0; x < w; ++x) o[2 * x] = o[2 * x + 1] = p[x];
        continue;
      }
      for (int x = 0; x < w; ++x) cols[x] = 3 * p[x] + q[x];
      for (int x = 0; x < w; ++x) {
        int32_t left = cols[x > 0 ? x - 1 : 0], right = cols[x + 1 < w ? x + 1 : w - 1];
        o[2 * x] = (3 * cols[x] + left + 8) >> 4;
        o[2 * x + 1] = (3 * cols[x] + right + 7) >> 4;
      }
    }
    return out;
  }

  void emit(uint8_t* out) {
    for (const auto& c : comps_)
      if (c.plane.empty()) throw Error{"a component has no scan"};
    const Component& y = comps_[0];
    int ys = y.blocks_w * 8;
    if (comps_.size() == 1) {
      for (int r = 0; r < height; ++r)
        for (int x = 0; x < width; ++x) {
          uint8_t v = y.plane[size_t(r) * ys + x];
          uint8_t* o = out + (size_t(r) * width + x) * 3;
          o[0] = o[1] = o[2] = v;
        }
      return;
    }
    if (adobe_transform_ == 0) throw Error{"unsupported JPEG: RGB components (Adobe transform 0)"};
    const int kHalf = 1 << 15;
    auto fix = [](double x) { return static_cast<int32_t>(x * 65536 + 0.5); };
    const int32_t cr_r = fix(1.40200), cb_g = fix(0.34414), cr_g = fix(0.71414),
                  cb_b = fix(1.77200);
    bool up = hmax_ == 2;
    std::vector<int32_t> cb, cr;
    int cw = 0;
    if (up) {
      cb = upsample_h2v2(comps_[1]);
      cr = upsample_h2v2(comps_[2]);
      cw = 2 * comps_[1].width;
    }
    int cs = comps_[1].blocks_w * 8;
    for (int r = 0; r < height; ++r) {
      for (int x = 0; x < width; ++x) {
        int32_t Y = y.plane[size_t(r) * ys + x];
        int32_t B, R;
        if (up) {
          B = cb[size_t(r) * cw + x];
          R = cr[size_t(r) * cw + x];
        } else {
          B = comps_[1].plane[size_t(r) * cs + x];
          R = comps_[2].plane[size_t(r) * cs + x];
        }
        B -= 128;
        R -= 128;
        uint8_t* o = out + (size_t(r) * width + x) * 3;
        o[0] = clamp255(Y + ((cr_r * R + kHalf) >> 16));
        o[1] = clamp255(Y + ((-cb_g * B + kHalf - cr_g * R) >> 16));
        o[2] = clamp255(Y + ((cb_b * B + kHalf) >> 16));
      }
    }
  }

  const uint8_t* d_;
  size_t n_, pos_ = 0;
  bool islow_ = false;
  bool frame_ = false;
  int hmax_ = 1, vmax_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  int restart_interval_ = 0, adobe_transform_ = -1;
  int32_t mult_[4][64] = {};
  bool qdef_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  std::vector<Component> comps_;
};

void set_error(char* err, int err_len, const std::string& what) {
  if (err != nullptr && err_len > 0) std::snprintf(err, err_len, "%s", what.c_str());
}

}  // namespace

extern "C" {

// The frame header's size. 0 on success, else -1 with a message in `err`.
int openvla_jpeg_info(const uint8_t* data, int64_t n, int* height, int* width, char* err,
                      int err_len) {
  try {
    Decoder d(data, static_cast<size_t>(n));
    d.header();
    *height = d.height;
    *width = d.width;
    return 0;
  } catch (const Error& e) {
    set_error(err, err_len, e.what);
  } catch (const std::exception& e) {
    set_error(err, err_len, e.what());
  }
  return -1;
}

// Decodes into `out`, uint8 (height, width, 3) RGB of `out_len` bytes, by
// the IFAST inverse DCT (TF's), or the ISLOW one (PIL's) where `islow` is
// not 0. 0 on success, else -1 with a message in `err`.
int openvla_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_len, int islow,
                        char* err, int err_len) {
  try {
    Decoder d(data, static_cast<size_t>(n));
    d.header();
    if (int64_t(d.height) * d.width * 3 != out_len) throw Error{"output buffer of the wrong size"};
    Decoder full(data, static_cast<size_t>(n), islow != 0);
    full.decode(out);
    return 0;
  } catch (const Error& e) {
    set_error(err, err_len, e.what);
  } catch (const std::exception& e) {
    set_error(err, err_len, e.what());
  }
  return -1;
}

}  // extern "C"
