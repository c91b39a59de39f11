// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), the checksum of
// TFRecord framing, by slicing-by-8 tables built once.

#include <cstdint>

namespace {

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Tables kTables;

}  // namespace

extern "C" {

// The CRC-32C of `n` bytes, continuing from `crc` (0 to start).
uint32_t openvla_crc32c(const uint8_t* p, int64_t n, uint32_t crc) {
  const auto& t = kTables.t;
  uint32_t c = ~crc;
  while (n >= 8) {
    uint32_t lo = c ^ (uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
                       uint32_t(p[3]) << 24);
    uint32_t hi = uint32_t(p[4]) | uint32_t(p[5]) << 8 | uint32_t(p[6]) << 16 |
                  uint32_t(p[7]) << 24;
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
        t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) c = (c >> 8) ^ t[0][(c ^ *p++) & 0xFF];
  return ~c;
}

}  // extern "C"
