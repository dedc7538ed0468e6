// Native wire-protocol runtime for the agent<->server transport.
//
// The reference gets its transport runtime from roscpp/TCPROS (C++); this is
// the equivalent piece for this build: length-prefixed framing with CRC32
// integrity over arbitrary payload buffers, plus a vectorized XOR-popcount
// utility used by host-side integrity checks. Compiled to a shared library
// and bound via ctypes (no pybind11 dependency in this image).
//
// Frame layout (little endian):
//   u32 magic = 0x4D435357 ("MCSW")
//   u32 payload_len
//   u32 crc32(payload)
//   u8  payload[payload_len]

#include <cstdint>
#include <cstring>

namespace {

uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
    crc_init_done = true;
}

}  // namespace

extern "C" {

constexpr uint32_t kMagic = 0x4D435357u;
constexpr uint32_t kHeaderSize = 12;

uint32_t wire_crc32(const uint8_t* buf, uint64_t len) {
    if (!crc_init_done) crc_init();
    uint32_t c = 0xFFFFFFFFu;
    for (uint64_t i = 0; i < len; i++)
        c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

uint32_t wire_header_size() { return kHeaderSize; }

// Writes header+payload into dst (must hold len + kHeaderSize bytes).
// Returns total frame size.
uint64_t wire_frame(uint8_t* dst, const uint8_t* payload, uint64_t len) {
    uint32_t crc = wire_crc32(payload, len);
    std::memcpy(dst, &kMagic, 4);
    uint32_t len32 = static_cast<uint32_t>(len);
    std::memcpy(dst + 4, &len32, 4);
    std::memcpy(dst + 8, &crc, 4);
    std::memcpy(dst + kHeaderSize, payload, len);
    return len + kHeaderSize;
}

// Parses a header. Returns payload length on success, or:
//  -1 bad magic, -2 short buffer.
int64_t wire_parse_header(const uint8_t* buf, uint64_t buflen,
                          uint32_t* crc_out) {
    if (buflen < kHeaderSize) return -2;
    uint32_t magic, len, crc;
    std::memcpy(&magic, buf, 4);
    if (magic != kMagic) return -1;
    std::memcpy(&len, buf + 4, 4);
    std::memcpy(&crc, buf + 8, 4);
    *crc_out = crc;
    return static_cast<int64_t>(len);
}

// Validates payload CRC. Returns 1 ok, 0 mismatch.
int32_t wire_check(const uint8_t* payload, uint64_t len, uint32_t crc) {
    return wire_crc32(payload, len) == crc ? 1 : 0;
}


}  // extern "C"
