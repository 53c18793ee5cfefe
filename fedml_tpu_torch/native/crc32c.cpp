// CRC-32C (Castagnoli) of a byte buffer: the wire frames' integrity trailer
// (comm/serialization.py). The same table-driven, byte-at-a-time algorithm
// as the JAX package's native tier, so a frame's trailer is the same value
// in both packages.
//
// Built by fedml_tpu_torch/native/__init__.py with g++ -O3 -shared -fPIC
// and bound with ctypes (plain C interface).

#include <cstdint>

extern "C" {

static uint32_t crc_table[256];

// Fills the table; the loader calls it once, before any thread computes a
// CRC, so crc32c() itself only reads the table.
void crc32c_init() {
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k)
            c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
}

uint32_t crc32c(const uint8_t* data, int64_t n) {
    uint32_t c = 0xFFFFFFFFu;
    for (int64_t i = 0; i < n; ++i)
        c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
