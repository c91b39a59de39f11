// JPEG decoder: what libjpeg(-turbo) gives under
// `tf.io.decode_jpeg(data, channels=3)` (the IFAST inverse DCT, fancy
// upsampling, TF's libjpeg-turbo 2.1.4) or, with the ISLOW inverse DCT,
// under PIL's `Image.open(...).convert("RGB")` (libjpeg-turbo 3.x), for the
// host side of the data paths. `processing/jpeg_decode.py`'s plain version
// is the same decoder in Python and torch; tests hold this one to it, bit
// for bit.
//
// The byte stream is jdmarker.c's: SOI, APPn (JFIF APP0 and Adobe APP14
// read, the rest skipped) and COM, DQT (8- and 16-bit), SOF0, SOF1 and SOF2,
// DHT, SOS, DRI, RSTn, EOI. Entropy decoding is jdhuff.c's for sequential
// scans, each block dequantized and inverse-transformed into its
// component's sample plane as it is decoded, and jdphuff.c's four
// progressive scan kinds (DC first and refine, AC first with EOB runs and
// AC refine with correction bits), into a coefficient buffer over the
// padded MCU grid kept across scans and transformed after the last; DC
// predictors and EOB runs reset at every restart marker; a non-interleaved
// scan walks its component's own ceil(w/8) x ceil(h/8) blocks; zeros are
// read past the end of the data (jdhuff.c fills the bit buffer with zeros
// at a marker). Then, per component:
//   smoothing    jdcoefct.c decompress_smooth_data, for a progressive frame
//                whose first AC coefficients are not all refined to Al = 0
//                (smoothing_ok): the 5 x 5 DC estimate, with libjpeg-turbo
//                2.1.4's row and column walk for IFAST (TF's) and 3.x's for
//                ISLOW (PIL's)
//   dequantize   jddctmgr.c  the IFAST multipliers (q * aanscale + 2^11) >> 12,
//                            or the table itself (ISLOW), latched at the
//                            component's first scan
//   inverse_dct  jidctfst.c  jpeg_idct_ifast, (x >> 5) + 128 saturated; or
//                jidctint.c  jpeg_idct_islow in 64-bit sums, DESCALE by 11
//                            then 18 bits, + 128 saturated
//   upsample     jdsample.c  jinit_upsampler's choice: h2v1, h1v2 and h2v2
//                            fancy (h2v1 and h2v2 plain at 2 columns or
//                            fewer), int_upsample for other integral ratios
//   colour       jdcolor.c   ycc_rgb_convert (YCbCr), null (Adobe RGB),
//                            ycck_cmyk_convert, then PIL's CMYK;I + cmyk2rgb
//                            (ISLOW) or TF's CMYK -> RGB (IFAST); a grey
//                            plane is replicated
// The colour space is jdapimin.c default_decompress_parms': 3 components
// YCbCr under JFIF, else Adobe transform 0 RGB, else the component ids;
// 4 components CMYK under Adobe transform 0 or no Adobe marker, else YCCK.
// Lossless, hierarchical, arithmetic-coded and 12-bit streams and DNL are
// refused, naming their marker.
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


struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc = 0, ac = 0;              // Huffman table slots of the current scan
  int pred = 0;                    // DC predictor
  int width = 0, height = 0;       // samples (downsampled size)
  int bw = 0, bh = 0;              // its real blocks
  int cols = 0, rows = 0;          // blocks of the padded MCU grid
  std::vector<int16_t> coef;       // progressive: rows * cols * 64, natural order (JCOEF)
  std::vector<uint8_t> plane;      // samples, rows * 8 lines of cols * 8
  int bits[64];                    // jdphuff.c coef_bits: Al of the last scan, -1 before
  bool latched = false;            // quantization table latched (first scan)
  int32_t q[64] = {};              // the latched table, natural order
  int32_t mult[64] = {};           // its dequantization multipliers (jddctmgr.c)
  int16_t* block(int r, int c) { return coef.data() + (size_t(r) * cols + c) * 64; }
  const int16_t* block(int r, int c) const { return coef.data() + (size_t(r) * cols + c) * 64; }
  int stride() const { return cols * 8; }
  uint8_t* at(int r, int c) { return plane.data() + size_t(r) * 8 * stride() + size_t(c) * 8; }
};

// jdcoefct.c: natural positions of zig-zag coefficients 1..9, which block
// smoothing estimates.
const int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// decompress_smooth_data's kernels over the 5 x 5 DC neighbourhood (rows
// two up to two down, each two left to two right): with DC interpolation
// (no AC scan yet) for coefficients 1..9 and the DC, without for 1..5.
const int kSmoothDc[10][25] = {
    {-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8, -6, 6, 42, 6, -6, -2, -6, -8, -6, -2},
    {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
    {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
    {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
    {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
    {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0}};
const int kSmoothAc[6][25] = {
    {0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
    {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
    {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};

// PIL Convert.c MULDIV255.
inline int muldiv255(int a, int b) {
  int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
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
      if (m == 0xDA) throw Error{"SOS before a frame header"};
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
        nullptr, nullptr, nullptr, "lossless (SOF3)", nullptr,
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
      case 0xC2:
        sof(end, m == 0xC2);
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
      case 0xE0:  // APP0: a JFIF header says YCbCr
        if (end - pos_ >= 14 && std::memcmp(d_ + pos_, "JFIF\0", 5) == 0) jfif_ = true;
        break;
      case 0xEE:  // APP14 (Adobe): its colour transform
        if (end - pos_ >= 12 && std::memcmp(d_ + pos_, "Adobe", 5) == 0)
          adobe_transform_ = d_[pos_ + 11];
        break;
      default:  // APPn, COM and anything else with a length
        break;
    }
    pos_ = end;
  }

  void sof(size_t end, bool progressive) {
    if (frame_) throw Error{"a second frame header"};
    progressive_ = progressive;
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
    if (nc != 1 && nc != 3 && nc != 4)
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
    mcus_x_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcus_y_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v)
        throw Error{"unsupported JPEG sampling: fractional upsampling " + std::to_string(c.h) +
                    "x" + std::to_string(c.v) + " of " + std::to_string(hmax_) + "x" +
                    std::to_string(vmax_)};
      c.width = (width * c.h + hmax_ - 1) / hmax_;
      c.height = (height * c.v + vmax_ - 1) / vmax_;
      c.bw = (c.width + 7) / 8;
      c.bh = (c.height + 7) / 8;
      c.cols = mcus_x_ * c.h;
      c.rows = mcus_y_ * c.v;
      if (progressive_) c.coef.assign(size_t(c.cols) * c.rows * 64, 0);
      c.plane.assign(size_t(c.cols) * 8 * c.rows * 8, 0);
      std::fill(c.bits, c.bits + 64, -1);
    }
    frame_ = true;
  }

  void dqt(size_t end) {
    while (pos_ < end) {
      int pq = byte();
      int tq = pq & 15;
      if (tq > 3) throw Error{"bad DQT table id"};
      for (int k = 0; k < 64; ++k) qraw_[tq][kNatural[k]] = (pq >> 4) ? word() : byte();
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

  enum Kind { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

  void scan() {
    size_t end = segment_end();
    int ns = byte();
    if (ns < 1 || ns > static_cast<int>(comps_.size())) throw Error{"bad scan header"};
    std::vector<Component*> sc;
    std::vector<int> tables;
    for (int i = 0; i < ns; ++i) {
      int cs = byte(), t = byte();
      Component* c = nullptr;
      for (auto& k : comps_)
        if (k.id == cs) c = &k;
      if (c == nullptr) throw Error{"scan names an unknown component"};
      if (!qdef_[c->tq]) throw Error{"a component uses an undefined quantization table"};
      if (!c->latched) {  // jdinput.c latch_quant_tables
        std::memcpy(c->q, qraw_[c->tq], sizeof(c->q));
        for (int i = 0; i < 64; ++i)
          // jddctmgr.c keeps the multiplier in a short (IFAST_MULT_TYPE,
          // ISLOW_MULT_TYPE): the ISLOW one is the table entry itself.
          c->mult[i] = islow_ ? static_cast<int16_t>(c->q[i])
                              : static_cast<int16_t>((static_cast<int64_t>(c->q[i]) *
                                                          kAanScales[i] + (1 << 11)) >> 12);
        c->latched = true;
      }
      sc.push_back(c);
      tables.push_back(t);
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    pos_ = end;
    Kind kind;
    if (!progressive_) {
      if (ss != 0 || se != 63 || a != 0) throw Error{"unsupported JPEG: a progressive scan"};
      kind = kSequential;
    } else if (ss == 0) {
      if (se != 0) throw Error{"bad progression (a DC scan with AC)"};
      kind = ah == 0 ? kDcFirst : kDcRefine;
    } else {
      if (ns != 1 || se < ss || se > 63) throw Error{"bad progression (an AC scan)"};
      kind = ah == 0 ? kAcFirst : kAcRefine;
    }
    for (int i = 0; i < ns; ++i) {
      Component* c = sc[i];
      c->dc = tables[i] >> 4;
      c->ac = tables[i] & 15;
      bool need_dc = kind == kSequential || kind == kDcFirst;
      bool need_ac = kind == kSequential || kind == kAcFirst || kind == kAcRefine;
      if ((need_dc && (c->dc > 3 || dc_[c->dc].lookup.empty())) ||
          (need_ac && (c->ac > 3 || ac_[c->ac].lookup.empty())))
        throw Error{"scan uses an undefined Huffman table"};
      c->pred = 0;
    }

    // MCUs of the scan: interleaved, h x v blocks of each component; one
    // component alone, its blocks covering its real size.
    int units_x = ns == 1 ? sc[0]->bw : mcus_x_;
    int units_y = ns == 1 ? sc[0]->bh : mcus_y_;
    auto data = intervals();
    int64_t total = int64_t(units_x) * units_y;
    int64_t per = restart_interval_ > 0 ? restart_interval_ : total;
    size_t seg = 0;
    BitReader bits(data[0].data(), data[0].size());
    int eobrun = 0;
    int16_t seq[64];
    int32_t ws[64];
    for (int64_t m = 0; m < total; ++m) {
      if (m > 0 && m % per == 0) {
        ++seg;  // a restart: byte-aligned new data, predictors and EOB run reset
        bits = seg < data.size() ? BitReader(data[seg].data(), data[seg].size())
                                 : BitReader(nullptr, 0);
        for (Component* c : sc) c->pred = 0;
        eobrun = 0;
      }
      int mx = static_cast<int>(m % units_x), my = static_cast<int>(m / units_x);
      for (Component* c : sc) {
        int bh = ns == 1 ? 1 : c->h, bv = ns == 1 ? 1 : c->v;
        for (int by = 0; by < bv; ++by) {
          for (int bx = 0; bx < bh; ++bx) {
            int row = my * bv + by, col = mx * bh + bx;
            if (kind == kSequential) {  // straight to samples: no smoothing
              decode_sequential(bits, *c, seq);
              for (int i = 0; i < 64; ++i) ws[i] = seq[i];
              transform(*c, ws, c->at(row, col));
              continue;
            }
            int16_t* blk = c->block(row, col);
            switch (kind) {
              case kDcFirst: {
                int s = decode_symbol(bits, dc_[c->dc]);
                if (s > 15) throw Error{"corrupt JPEG data: bad DC magnitude"};
                if (s) c->pred += extend(bits.get(s), s);
                blk[0] = static_cast<int16_t>(static_cast<unsigned>(c->pred) << al);
                break;
              }
              case kDcRefine:
                if (bits.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
                break;
              case kAcFirst:
                decode_ac_first(bits, ac_[c->ac], blk, ss, se, al, eobrun);
                break;
              case kAcRefine:
                decode_ac_refine(bits, ac_[c->ac], blk, ss, se, al, eobrun);
                break;
              default:
                break;
            }
          }
        }
      }
    }
    for (Component* c : sc)
      for (int k = ss; k <= se; ++k) c->bits[k] = al;
  }

  // jdhuff.c decode_mcu: one block, the DC difference then the AC runs.
  void decode_sequential(BitReader& bits, Component& c, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int s = decode_symbol(bits, dc_[c.dc]);
    if (s > 15) throw Error{"corrupt JPEG data: bad DC magnitude"};
    c.pred += s ? extend(bits.get(s), s) : 0;
    blk[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64;) {
      int rs = decode_symbol(bits, ac_[c.ac]);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(bits.get(s), s));
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;  // EOB
      }
    }
  }

  // jdphuff.c decode_mcu_AC_first: the band's first pass, EOB runs spanning
  // blocks.
  static void decode_ac_first(BitReader& bits, const Huffman& t, int16_t* blk, int ss, int se,
                              int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = decode_symbol(bits, t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(extend(bits.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += bits.get(r);
        --eobrun;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine: one more bit of the band; a correction
  // bit for every nonzero coefficient the run passes, newly nonzero
  // coefficients of +-1 << Al.
  static void decode_ac_refine(BitReader& bits, const Huffman& t, int16_t* blk, int ss, int se,
                               int al, int& eobrun) {
    const int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    auto correct = [&](int pos) {
      if (bits.get(1) && (blk[pos] & p1) == 0)
        blk[pos] = static_cast<int16_t>(blk[pos] + (blk[pos] >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode_symbol(bits, t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bits.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits.get(r);
          break;
        }
        do {
          int pos = kNatural[k];
          if (blk[pos] != 0) {
            correct(pos);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int pos = kNatural[k];
        if (blk[pos] != 0) correct(pos);
      }
      --eobrun;
    }
  }

  // jdcoefct.c smoothing_ok.
  bool smoothing_ok() const {
    if (!progressive_) return false;
    bool useful = false;
    for (const auto& c : comps_) {
      for (int i = 0; i < 10; ++i)
        if (c.q[kSmoothPos[i]] == 0) return false;
      if (c.bits[0] < 0) return false;
      for (int i = 1; i < 10; ++i) useful |= c.bits[i] != 0;
    }
    return useful;
  }

  // processing/jpeg_decode.py smoothing_rows: the rows block row a reads,
  // two up to two down, walked one iMCU row at a time as libjpeg-turbo
  // 3.x (islow_) or 2.1.4 walks them.
  std::vector<int> smoothing_rows(const Component& c) const {
    std::vector<int> rows;
    int last = mcus_y_ - 1, v = c.v;
    for (int r = 0; r < mcus_y_ && static_cast<int>(rows.size()) < 5 * c.bh; ++r) {
      int n = r < last ? v : (c.bh % v ? c.bh % v : v);
      for (int b = 0; b < n; ++b) {
        int a = r * v + b;
        bool up, up2, down, down2;
        if (islow_) {
          int i = r * n + b, total = n * mcus_y_;
          up = i > 0;
          up2 = i > 1;
          down = i < total - 1;
          down2 = i < total - 2;
        } else {
          up = b > 0 || r > 0;
          up2 = b > 1 || r > 1;
          down = b < n - 1 || r < last;
          down2 = b < n - 2 || r + 1 < last;
        }
        int prev = up ? a - 1 : a, nxt = down ? a + 1 : a;
        int row[5] = {up2 ? a - 2 : prev, prev, a, nxt, down2 ? a + 2 : nxt};
        rows.insert(rows.end(), row, row + 5);
      }
    }
    rows.resize(size_t(5) * c.bh);
    return rows;
  }

  // jdcoefct.c decompress_smooth_data's estimates for block (r, x) into
  // `ws` (its quantized coefficients on entry).
  void smooth(Component& c, const std::vector<int>& rows, int r, int x, int32_t* ws) const {
    int64_t dcs[25];
    for (int i = 0; i < 5; ++i) {
      for (int j = 0; j < 5; ++j) {
        int col;
        if (!islow_ && c.bw == 2) {  // 2.1.4's window for a picture two blocks wide
          static const int k2[2][5] = {{0, 0, 0, 1, 0}, {0, 0, 1, 0, 0}};
          col = k2[x][j];
        } else {
          col = std::min(std::max(x + j - 2, 0), c.bw - 1);
        }
        dcs[5 * i + j] = c.block(rows[5 * r + i], col)[0];
      }
    }
    bool change_dc = true;
    for (int i = 1; i < 10; ++i) change_dc &= c.bits[i] == -1;
    const int64_t q00 = c.q[0];
    auto estimate = [&](const int* kernel, int64_t qk, int al) {
      int64_t num = 0;
      for (int i = 0; i < 25; ++i) num += kernel[i] * dcs[i];
      num *= q00;
      int64_t pred = ((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8);
      if (al > 0 && pred >= (int64_t(1) << al)) pred = (int64_t(1) << al) - 1;
      return static_cast<int32_t>(num >= 0 ? pred : -pred);
    };
    for (int i = 1; i < (change_dc ? 10 : 6); ++i) {
      int al = c.bits[i], pos = kSmoothPos[i];
      if (al != 0 && ws[pos] == 0)
        ws[pos] = estimate(change_dc ? kSmoothDc[i] : kSmoothAc[i], c.q[pos], al);
    }
    if (change_dc) ws[0] = estimate(kSmoothDc[0], q00, -1);
  }

  // One block's quantized coefficients (natural order) dequantized in
  // place and through the inverse DCT into `out`, the component's plane.
  void transform(const Component& c, int32_t* blk, uint8_t* out) const {
    for (int i = 0; i < 64; ++i) blk[i] *= c.mult[i];
    if (islow_)
      inverse_dct_islow(blk, out, c.stride());
    else
      inverse_dct(blk, out, c.stride());
  }

  // A progressive frame's real blocks through the inverse DCT (smoothed
  // first where `smooth_on`) into the component's plane.
  void samples(Component& c, bool smooth_on) const {
    std::vector<int> rows;
    if (smooth_on) rows = smoothing_rows(c);
    int32_t blk[64];
    for (int r = 0; r < c.bh; ++r) {
      for (int x = 0; x < c.bw; ++x) {
        const int16_t* src = c.block(r, x);
        for (int i = 0; i < 64; ++i) blk[i] = src[i];
        if (smooth_on) smooth(c, rows, r, x, blk);
        transform(c, blk, c.at(r, x));
      }
    }
  }

  // jdsample.c, jinit_upsampler's choice: the component's plane at its real
  // size (c.height x c.width) -> (c.height * vmax / v) x (c.width * hmax / h),
  // rows of `out_w` samples.
  std::vector<uint8_t> upsample(const Component& c, int& out_w) const {
    int h = c.height, w = c.width, hx = hmax_ / c.h, vx = vmax_ / c.v;
    const int stride = c.stride();
    out_w = w * hx;
    std::vector<uint8_t> out(size_t(h) * vx * out_w);
    auto line = [&](int y) { return c.plane.data() + size_t(y) * stride; };
    if (hx == 2 && vx == 1 && w > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < h; ++y) {
        const uint8_t* p = line(y);
        uint8_t* o = out.data() + size_t(y) * out_w;
        for (int x = 0; x < w; ++x) {
          int t = 3 * p[x];
          o[2 * x] = static_cast<uint8_t>((t + p[x > 0 ? x - 1 : 0] + 1) >> 2);
          o[2 * x + 1] = static_cast<uint8_t>((t + p[x + 1 < w ? x + 1 : w - 1] + 2) >> 2);
        }
      }
    } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < h; ++y) {
        const uint8_t *p = line(y), *up = line(y > 0 ? y - 1 : 0),
                      *dn = line(y + 1 < h ? y + 1 : h - 1);
        uint8_t* o0 = out.data() + size_t(2 * y) * out_w;
        uint8_t* o1 = o0 + out_w;
        for (int x = 0; x < w; ++x) {
          int t = 3 * p[x];
          o0[x] = static_cast<uint8_t>((t + up[x] + 1) >> 2);
          o1[x] = static_cast<uint8_t>((t + dn[x] + 2) >> 2);
        }
      }
    } else if (hx == 2 && vx == 2 && w > 2) {  // h2v2_fancy_upsample
      std::vector<int> cols(w);
      for (int oy = 0; oy < 2 * h; ++oy) {
        int y = oy / 2;
        int ny = oy % 2 == 0 ? (y > 0 ? y - 1 : 0) : (y + 1 < h ? y + 1 : h - 1);
        const uint8_t *p = line(y), *q = line(ny);
        uint8_t* o = out.data() + size_t(oy) * out_w;
        for (int x = 0; x < w; ++x) cols[x] = 3 * p[x] + q[x];
        for (int x = 0; x < w; ++x) {
          int left = cols[x > 0 ? x - 1 : 0], right = cols[x + 1 < w ? x + 1 : w - 1];
          o[2 * x] = static_cast<uint8_t>((3 * cols[x] + left + 8) >> 4);
          o[2 * x + 1] = static_cast<uint8_t>((3 * cols[x] + right + 7) >> 4);
        }
      }
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample
      for (int y = 0; y < h * vx; ++y) {
        const uint8_t* p = line(y / vx);
        uint8_t* o = out.data() + size_t(y) * out_w;
        for (int x = 0; x < out_w; ++x) o[x] = p[x / hx];
      }
    }
    return out;
  }

  void emit(uint8_t* out) {
    for (const auto& c : comps_)
      if (!c.latched) throw Error{"a component has no scan"};
    bool smooth_on = smoothing_ok();
    int nc = static_cast<int>(comps_.size());
    // Each component's samples at full size: its own plane where it is not
    // subsampled (fullsize_upsample), else an upsampled copy.
    std::vector<std::vector<uint8_t>> up(nc);
    const uint8_t* planes[4];
    int strides[4];
    for (int i = 0; i < nc; ++i) {
      Component& c = comps_[i];
      if (progressive_) samples(c, smooth_on);
      if (c.h == hmax_ && c.v == vmax_) {
        planes[i] = c.plane.data();
        strides[i] = c.stride();
      } else {
        up[i] = upsample(c, strides[i]);
        planes[i] = up[i].data();
      }
    }
    // jdapimin.c default_decompress_parms
    enum { kGrey, kRgb, kYcc, kCmyk, kYcck } space = kGrey;
    if (nc == 3) {
      if (jfif_) space = kYcc;
      else if (adobe_transform_ >= 0) space = adobe_transform_ == 0 ? kRgb : kYcc;
      else space = (comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66) ? kRgb : kYcc;
    } else if (nc == 4) {
      space = adobe_transform_ >= 0 && adobe_transform_ != 0 ? kYcck : kCmyk;
    }
    const int kHalf = 1 << 15;
    auto fix = [](double x) { return static_cast<int32_t>(x * 65536 + 0.5); };
    const int32_t cr_r = fix(1.40200), cb_g = fix(0.34414), cr_g = fix(0.71414),
                  cb_b = fix(1.77200);
    for (int r = 0; r < height; ++r) {
      const uint8_t* p[4] = {};
      for (int i = 0; i < nc; ++i) p[i] = planes[i] + size_t(r) * strides[i];
      uint8_t* o = out + size_t(r) * width * 3;
      if (space == kGrey) {
        for (int x = 0; x < width; ++x, o += 3) o[0] = o[1] = o[2] = p[0][x];
        continue;
      }
      if (space == kRgb) {
        for (int x = 0; x < width; ++x, o += 3) o[0] = p[0][x], o[1] = p[1][x], o[2] = p[2][x];
        continue;
      }
      if (space == kYcc) {  // ycc_rgb_convert
        for (int x = 0; x < width; ++x, o += 3) {
          int Y = p[0][x], B = p[1][x] - 128, R = p[2][x] - 128;
          o[0] = clamp255(Y + ((cr_r * R + kHalf) >> 16));
          o[1] = clamp255(Y + ((-cb_g * B + kHalf - cr_g * R) >> 16));
          o[2] = clamp255(Y + ((cb_b * B + kHalf) >> 16));
        }
        continue;
      }
      for (int x = 0; x < width; ++x, o += 3) {
        int s[4] = {p[0][x], p[1][x], p[2][x], p[3][x]};
        int rgb[3] = {s[0], s[1], s[2]};
        if (space == kYcck) {
          int Y = s[0], B = s[1] - 128, R = s[2] - 128;
          rgb[0] = clamp255(Y + ((cr_r * R + kHalf) >> 16));
          rgb[1] = clamp255(Y + ((-cb_g * B + kHalf - cr_g * R) >> 16));
          rgb[2] = clamp255(Y + ((cb_b * B + kHalf) >> 16));
        }
        int cmyk[4] = {rgb[0], rgb[1], rgb[2], s[3]};
        if (space == kYcck)  // ycck_cmyk_convert
          for (int i = 0; i < 3; ++i) cmyk[i] = 255 - rgb[i];
        for (int i = 0; i < 3; ++i) {
          int v;
          if (islow_) {  // PIL: CMYK;I (inverted), then cmyk2rgb
            int nk = cmyk[3];
            v = nk - muldiv255(255 - cmyk[i], nk);
          } else if (adobe_transform_ >= 0) {  // TF, Adobe polarity
            v = cmyk[3] * cmyk[i] / 255;
          } else {
            v = (255 - cmyk[3]) * (255 - cmyk[i]) / 255;
          }
          o[i] = clamp255(v);
        }
      }
    }
  }

  const uint8_t* d_;
  size_t n_, pos_ = 0;
  bool islow_ = false;
  bool frame_ = false, progressive_ = false, jfif_ = false;
  int hmax_ = 1, vmax_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  int restart_interval_ = 0, adobe_transform_ = -1;
  int32_t qraw_[4][64] = {};
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

// Decodes into `out`, uint8 (height, width, 3) RGB of `out_len` bytes: TF's
// pixels (the IFAST inverse DCT), or PIL's (ISLOW) where `islow` is not 0.
// 0 on success, else -1 with a message in `err`.
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
