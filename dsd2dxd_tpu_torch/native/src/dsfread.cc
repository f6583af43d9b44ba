// dsfread — the .dsf reader's two passes over a tile (formats/source.py).
//
// C ABI consumed via ctypes (see ../loader.py), a library of its own so a
// conversion that needs neither NJAD nor FLAC compiles only this file.
// ctypes releases the interpreter lock for each call.

#include <cstddef>
#include <cstdint>
#include <cstring>

#define DSFREAD_API extern "C" __attribute__((visibility("default")))

// De-interleave a run of `blocks` planar super-blocks, each `channels`
// runs of `bs` bytes in file order (one run per channel), into the
// (channels, stride) planes at `dst`: columns [0, ncols) of every row,
// ncols <= blocks * bs.
DSFREAD_API void dsfread_planes(const uint8_t* src, size_t blocks,
                                size_t channels, size_t bs, uint8_t* dst,
                                size_t stride, size_t ncols) {
    for (size_t b = 0; b < blocks && b * bs < ncols; ++b) {
        const size_t col = b * bs;
        const size_t take = ncols - col < bs ? ncols - col : bs;
        const uint8_t* block = src + b * channels * bs;
        for (size_t c = 0; c < channels; ++c)
            std::memcpy(dst + c * stride + col, block + c * bs, take);
    }
}

// Reverse the bit order within each of `n` bytes in place (LSB-first <->
// MSB-first): three rounds of mask-and-swap on 64-bit words, which the
// compiler widens to vector registers, then the same rounds on the tail.
DSFREAD_API void dsfread_bitrev(uint8_t* p, size_t n) {
    constexpr uint64_t k1 = 0x5555555555555555ull;
    constexpr uint64_t k2 = 0x3333333333333333ull;
    constexpr uint64_t k4 = 0x0F0F0F0F0F0F0F0Full;
    size_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t x;
        std::memcpy(&x, p + i, 8);
        x = ((x >> 1) & k1) | ((x & k1) << 1);
        x = ((x >> 2) & k2) | ((x & k2) << 2);
        x = ((x >> 4) & k4) | ((x & k4) << 4);
        std::memcpy(p + i, &x, 8);
    }
    for (; i < n; ++i) {
        uint32_t x = p[i];
        x = ((x >> 1) & 0x55u) | ((x & 0x55u) << 1);
        x = ((x >> 2) & 0x33u) | ((x & 0x33u) << 2);
        x = ((x >> 4) & 0x0Fu) | ((x & 0x0Fu) << 4);
        p[i] = static_cast<uint8_t>(x);
    }
}
