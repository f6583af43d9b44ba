// njad.cc — "Not Just Another Dither" requantizer.
//
// The reference README documents `-d N` (reference README.md:74) from the
// pre-Rust C++ dsd2dxd, crediting Airwindows (README.md:236-244); v2.7.0
// dropped it but the driver's BASELINE configs require it (SURVEY.md §2.4
// fine print). This is OUR INTERPRETATION of the publicly described
// Airwindows "Not Just Another Dither" idea — built from its published
// description only (no network in this environment, so the actual
// Airwindows source could not be consulted; fidelity to its exact
// algorithm is unverified): instead of adding noise, choose between
// floor and ceil per sample so the running distribution of leading
// digits of the quantized values tracks Benford's law — a
// deterministic, content-adaptive dither. Sequential feedback per
// channel, hence host-side native code (SURVEY.md §2.3). Tests pin the
// statistical behavior (bounded error, determinism, Benford tracking),
// not lineage.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define DSDKIT_API extern "C" __attribute__((visibility("default")))

namespace {

// Benford ideal proportions log10(1 + 1/d), d = 1..9.
const double kBenford[10] = {0.0,
                             0.301029995663981, 0.176091259055681,
                             0.124938736608300, 0.096910013008056,
                             0.079181246047625, 0.066946789630613,
                             0.057991946977687, 0.051152522447381,
                             0.045757490560675};

struct ChannelState {
  double counts[10];
  double total;
  // Near-silence memo: when a candidate is 0 (lo == 0 or lo == -1) the
  // floor/ceil decision depends ONLY on the histogram, not on x — so a
  // digital-silence run re-decides identically every sample. Memoize
  // per case, keyed on a version stamp bumped at every histogram
  // change. Pure memoization: decisions (and output) are bit-identical.
  uint64_t version;
  uint64_t memo_version[2];  // [0]: lo == 0, [1]: lo == -1
  bool memo_take_lo[2];
};

struct NjadState {
  uint32_t channels;
  ChannelState ch[16];
};

const unsigned long long kP10[20] = {
    1ull, 10ull, 100ull, 1000ull, 10000ull, 100000ull, 1000000ull,
    10000000ull, 100000000ull, 1000000000ull, 10000000000ull,
    100000000000ull, 1000000000000ull, 10000000000000ull,
    100000000000000ull, 1000000000000000ull, 10000000000000000ull,
    100000000000000000ull, 1000000000000000000ull,
    10000000000000000000ull};

// kThr[g][d] = d * 10^g: digit thresholds for the ladder digit_pair.
// g <= 18 suffices: any |lo| < 2^63 <= 9.3e18 has at most 19 digits, so
// the corrected decade index never exceeds 18, and 10 * 10^18 = 1e19
// still fits u64. Built at load time (constexpr-equivalent).
struct ThrTable {
  unsigned long long t[19][11];
  ThrTable() {
    for (int g = 0; g <= 18; ++g)
      for (int d = 0; d <= 10; ++d)
        t[g][d] = (unsigned long long)d * kP10[g];
  }
};
const ThrTable kThr;

// Leading digits of BOTH quantization candidates (lo and lo+1) from one
// integer divide: digit(lo) = q of a = q*p10[g] + r, and digit(lo+1)
// only differs from q when the increment crosses a digit boundary —
// |lo+1| is a+1 for lo >= 0 (boundary at r+1 == p10[g]) and a-1 for
// lo < 0 (boundary at r == 0). The compiler derives q and r from a
// single division instruction. The decade index g uses the Hacker's
// Delight digit-count estimate (bl+1)*log10(2), which rounds UP by
// construction so the correction only ever decrements once (the old
// bl*1233>>12 form underestimated: digit(10) came out as 10, indexing
// the histogram out of bounds).
void digit_pair_div(long long lo, int* dlo, int* dhi) {
  if (lo >= 0) {
    unsigned long long a = (unsigned long long)lo;
    if (a == 0) { *dlo = 0; *dhi = 1; return; }
    int bl = 63 - __builtin_clzll(a);
    int g = ((bl + 1) * 1233) >> 12;
    if (a < kP10[g]) --g;
    unsigned long long q = a / kP10[g], r = a % kP10[g];
    *dlo = int(q);
    if (r + 1 < kP10[g]) *dhi = int(q);           // no boundary crossed
    else *dhi = q == 9 ? 1 : int(q + 1);          // 199->200, 999->1000
  } else {
    unsigned long long a = 0ull - (unsigned long long)lo;  // a >= 1
    if (a == 1) { *dlo = 1; *dhi = 0; return; }   // hi == 0
    int bl = 63 - __builtin_clzll(a);
    int g = ((bl + 1) * 1233) >> 12;
    if (a < kP10[g]) --g;
    unsigned long long q = a / kP10[g], r = a % kP10[g];
    *dlo = int(q);
    if (r != 0) *dhi = int(q);                    // |hi| = a-1, same decade
    else *dhi = q == 1 ? 9 : int(q - 1);          // -100->-99, -200->-199
  }
}

// Same digit pair via a branchless threshold LADDER instead of the
// integer divide: with the decade index g in hand (p10[g] <= a <
// p10[g+1]), the leading digit is 1 + #{d in 2..9 : a >= d*10^g} — eight
// INDEPENDENT compare-adds a superscalar core retires in ~3 cycles,
// where the 64-bit divide is a ~25-40-cycle dependency. The candidate's
// digit then needs only the boundary test the divide form derived from
// the remainder: lo>=0 crosses iff a+1 == (d+1)*10^g (999->1000 wraps
// to 1); lo<0 has |hi| = a-1, crossing iff a == d*10^g (-100->-99;
// d==1 drops a decade to 9). Bit-identical to digit_pair_div over the
// full s64 domain (pinned in tests via the DSDKIT_NJAD_DIGIT A/B).
// Measured SLOWER than the divide under the real feedback loop — see
// use_div_digit below; kept opt-in.
void digit_pair_thr(long long lo, int* dlo, int* dhi) {
  unsigned long long a;
  bool neg = lo < 0;
  if (!neg) {
    a = (unsigned long long)lo;
    if (a == 0) { *dlo = 0; *dhi = 1; return; }
  } else {
    a = 0ull - (unsigned long long)lo;
    if (a == 1) { *dlo = 1; *dhi = 0; return; }
  }
  int bl = 63 - __builtin_clzll(a);
  int g = ((bl + 1) * 1233) >> 12;
  if (a < kP10[g]) --g;
  const unsigned long long* T = kThr.t[g];
  int d = 1 + int(a >= T[2]) + int(a >= T[3]) + int(a >= T[4])
            + int(a >= T[5]) + int(a >= T[6]) + int(a >= T[7])
            + int(a >= T[8]) + int(a >= T[9]);
  *dlo = d;
  if (!neg)
    *dhi = (a + 1 == T[d + 1]) ? (d == 9 ? 1 : d + 1) : d;
  else
    *dhi = (a == T[d]) ? (d == 1 ? 9 : d - 1) : d;
}

// Default is the DIVIDE form — the interleaved A/B (tools/njadbench.py,
// 2026-08-19, pink noise @20-bit: ladder 0.887x of div) showed the
// ladder LOSES ~11%: the per-sample critical path is the double-
// precision histogram feedback (counts update -> next error terms), so
// the divide's latency hides under it and the ladder's extra uops only
// add issue pressure. DSDKIT_NJAD_DIGIT=ladder keeps the variant
// exercisable (bit-identity pinned in tests) if the trade flips on a
// wider core. Read per quantize CALL (per ~1 s tile), never per sample.
bool use_div_digit() {
  const char* e = getenv("DSDKIT_NJAD_DIGIT");
  return !(e && strcmp(e, "ladder") == 0);
}

// Distance of the histogram (with candidate digit d added) from Benford.
double score(const ChannelState& st, int d) {
  double total = st.total + (d > 0 ? 1.0 : 0.0);
  if (total <= 0.0) return 0.0;
  double s = 0.0;
  for (int i = 1; i <= 9; ++i) {
    double c = st.counts[i] + (i == d ? 1.0 : 0.0);
    s += std::fabs(c / total - kBenford[i]);
  }
  return s;
}

int32_t clip(long long v, int bits) {
  long long lim = 1ll << (bits - 1);
  if (v >= lim) return int32_t(lim - 1);
  if (v < -lim) return int32_t(-lim);
  return int32_t(v);
}

}  // namespace

DSDKIT_API void* dsdkit_njad_new(uint32_t channels) {
  // Reject rather than clamp: a clamp would silently alias channels >= 16
  // onto ch[0]'s Benford histogram (cross-channel dither-feedback
  // coupling). The loader maps nullptr to a ConfigError.
  if (channels == 0 || channels > 16) return nullptr;
  auto* st = new NjadState();
  st->channels = channels;
  for (uint32_t c = 0; c < channels; ++c) {
    for (int i = 0; i < 10; ++i) st->ch[c].counts[i] = 0.0;
    st->ch[c].total = 0.0;
    st->ch[c].version = 1;
    st->ch[c].memo_version[0] = st->ch[c].memo_version[1] = 0;
  }
  return st;
}

namespace {

// The dither feedback is sequential PER CHANNEL (the Benford histogram
// is the feedback state) but channels never interact, so each channel's
// full sample walk can run on its own thread — the channel axis is the
// only parallelism a single NJAD stream admits (concurrent STREAMS are
// already parallel: the CLI pool runs one Converter per file, each with
// its own NjadState). Per-channel processing is byte-identical to the
// old interleaved loop by construction (pinned in tests).
template <bool USE_DIV>
void quantize_channel(ChannelState& cs, const float* in, int32_t* out,
                      size_t frames, uint32_t channels, uint32_t c,
                      double scale, int bits) {
  for (size_t i = 0; i < frames; ++i) {
    {
      double x = double(in[i * channels + c]) * scale;
      double lo = std::floor(x), hi = lo + 1.0;
      long long ilo = (long long)lo;
      int dlo, dhi;
      if (USE_DIV) digit_pair_div(ilo, &dlo, &dhi);
      else digit_pair_thr(ilo, &dlo, &dhi);
      bool take_hi;
      int dpick;
      if (dlo > 0 && dhi > 0) {
        // Both candidates add one count, so the normalizing total is
        // the same and the argmin survives scaling by it: compare
        // S(d) = sum_k |c_k - b_k*(T+1) + [k==d]|. The shared sum
        // s0 = sum_k |e_k| then CANCELS from slo <= shi, leaving only
        // each candidate's own term: |e+1| - |e|, which is exactly
        // clamp(2e+1, -1, 1) — two error terms per sample instead of
        // nine (same decision up to ~1-ulp rounding; the oracle test's
        // tie arbiter covers that band).
        double tp = cs.total + 1.0;
        double elo = cs.counts[dlo] - kBenford[dlo] * tp;
        double ehi = cs.counts[dhi] - kBenford[dhi] * tp;
        double glo = elo >= 0.0 ? 1.0 : (elo <= -1.0 ? -1.0 : 2.0 * elo + 1.0);
        double ghi = ehi >= 0.0 ? 1.0 : (ehi <= -1.0 ? -1.0 : 2.0 * ehi + 1.0);
        take_hi = glo > ghi;
        dpick = take_hi ? dhi : dlo;
      } else {
        // A candidate is 0 (lo is 0 or -1): the full two-score compare
        // depends only on the histogram — memoized per case on the
        // state version. Once a silence run settles on emitting 0
        // (dpick == 0, state frozen), every following sample is a memo
        // hit.
        int icase = dlo == 0 ? 0 : 1;
        bool take_lo;
        if (cs.memo_version[icase] == cs.version) {
          take_lo = cs.memo_take_lo[icase];
        } else {
          take_lo = score(cs, dlo) <= score(cs, dhi);
          cs.memo_version[icase] = cs.version;
          cs.memo_take_lo[icase] = take_lo;
        }
        take_hi = !take_lo;
        dpick = take_hi ? dhi : dlo;
      }
      if (dpick > 0) {
        cs.counts[dpick] += 1.0;
        cs.total += 1.0;
        ++cs.version;
        if (cs.total > 1024.0) {  // decay so the histogram stays adaptive
          for (int k = 1; k <= 9; ++k) cs.counts[k] *= 0.5;
          cs.total *= 0.5;
        }
      }
      // pick is ilo or ilo+1 exactly — no float round-trip needed
      out[i * channels + c] = clip(ilo + (take_hi ? 1 : 0), bits);
    }
  }
}

// Worker count: DSDKIT_NJAD_THREADS if set (lets a 1-core CI box
// exercise the threaded path deterministically), else the hardware
// count; always clamped to the channel count.
unsigned njad_threads(uint32_t channels) {
  unsigned n = std::thread::hardware_concurrency();
  if (const char* e = getenv("DSDKIT_NJAD_THREADS")) {
    long v = strtol(e, nullptr, 10);
    if (v >= 1 && v <= 64) n = unsigned(v);
  }
  if (n < 1) n = 1;
  return n < channels ? n : channels;
}

}  // namespace

// in: (frames x channels) float32 full-scale ±1; out: int32 at `bits`.
// Returns 0, or -1 when `channels` does not match the handle (aliasing
// extra channels onto ch[0] would couple their dither feedback — the
// exact failure njad_new's reject-don't-clamp contract exists to stop).
DSDKIT_API int dsdkit_njad_quantize(void* handle, const float* in,
                                    int32_t* out, size_t frames,
                                    uint32_t channels, int bits) {
  auto* st = static_cast<NjadState*>(handle);
  if (channels != st->channels || bits < 2 || bits > 32) return -1;
  double scale = double(1ll << (bits - 1));
  // one env read per call; the template instantiation keeps the digit
  // variant choice out of the per-sample loop entirely
  auto* qc = use_div_digit() ? &quantize_channel<true>
                             : &quantize_channel<false>;
  unsigned nt = njad_threads(channels);
  if (nt <= 1 || frames < 4096) {
    // fresh threads per call are ~25 us; skip them when the walk itself
    // is that small
    for (uint32_t c = 0; c < channels; ++c)
      qc(st->ch[c], in, out, frames, channels, c, scale, bits);
    return 0;
  }
  // quantize is called once per ~1 s engine tile (a handful of times
  // per file), so per-call std::threads cost noise-level latency and —
  // unlike a persistent per-state pool — leave nothing parked when the
  // CLI runs many concurrent Converter streams, each with its own
  // NjadState.
  std::atomic<uint32_t> cursor{0};
  auto work = [&] {
    for (uint32_t c; (c = cursor.fetch_add(1)) < channels;)
      qc(st->ch[c], in, out, frames, channels, c, scale, bits);
  };
  std::vector<std::thread> ts;
  ts.reserve(nt - 1);
  for (unsigned t = 1; t < nt; ++t) ts.emplace_back(work);
  work();
  for (auto& t : ts) t.join();
  return 0;
}

DSDKIT_API void dsdkit_njad_free(void* handle) {
  delete static_cast<NjadState*>(handle);
}
