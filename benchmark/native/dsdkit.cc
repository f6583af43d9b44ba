// The benchmark's delta-sigma modulator, which makes a cell's DSD input
// from its seeded PCM program. Built with g++ into benchmark/_build/ and
// called through ctypes by benchmark/inputs.py.

#include <cstddef>
#include <cstdint>

#define DSDKIT_API extern "C" __attribute__((visibility("default")))

// 2nd-order delta-sigma modulator (Boser-Wooley), PCM -> DSD bits {0,1}.
// Sequential quantizer feedback — inherently host-side.
DSDKIT_API void dsdkit_dsm2_bits(const double* x, uint8_t* bits_out, size_t n) {
    double s1 = 0.0, s2 = 0.0;
    for (size_t i = 0; i < n; ++i) {
        double y = (s2 >= 0.0) ? 1.0 : -1.0;
        bits_out[i] = (y > 0.0) ? 1 : 0;
        s1 += 0.5 * (x[i] - y);
        s2 += 0.5 * (s1 - y);
    }
}
