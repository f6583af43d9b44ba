// The reference's FLAC decoder (flac.h) behind a C interface, for ctypes.
#include "flac.h"

extern "C" {

// Decodes the stream p[0, n) into out: channel c's samples at
// out[c * cap .. c * cap + cap). info receives [frames decoded, byte
// offset where decoding stopped]. Returns the samples per channel
// decoded, or a negative error (benchflac_error names it).
int64_t benchflac_decode(const uint8_t* p, int64_t n, int32_t* out,
                         int64_t cap, int channels, int64_t* info) {
  benchflac::StreamInfo si;
  return benchflac::decode(p, (size_t)n, out, cap, channels, &si, &info[0],
                           &info[1]);
}

const char* benchflac_error(int e) { return benchflac::err_name(e); }

// Counts the frames of p[0, n) as the drain does, fed in pieces of
// `piece` bytes: res receives [frames, samples, bad, stray bytes].
void benchflac_scan(const uint8_t* p, int64_t n, int64_t piece,
                    int64_t* res) {
  benchflac::Scanner s;
  for (int64_t at = 0; at < n; at += piece)
    s.feed(p + at, (size_t)(n - at < piece ? n - at : piece));
  s.finish();
  res[0] = s.frames, res[1] = s.samples, res[2] = s.bad, res[3] = s.stray;
}
}
