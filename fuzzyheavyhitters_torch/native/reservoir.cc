// Streaming reservoir sampler — the native data-loader core, plus the
// incremental in-memory reservoir the ingest front door sheds into.
//
// The reference's samplers are native Rust over multi-GB CSVs: a memmap
// re-read with row indexing (src/sample_covid_data.rs:75-135) and a seeded
// reservoir (src/sample_covid_data.rs:158-166, sample_driving_data.rs:72-97).
// This is the framework's equivalent: one streaming pass, O(k) memory,
// quoted-field-aware splitting of just the two requested columns, and a
// seeded xoshiro256** reservoir (algorithm R) so runs are reproducible.
//
// Exposed as a C ABI for ctypes (no pybind11 in this toolchain):
//
//   long csv_reservoir_sample(path, col_a, col_b, k, seed, out_a, out_b)
//     -> number of rows sampled (<= k), or -1 on open failure.
//
//   // incremental reservoir (resilience/admission.py's shed mode): the
//   // caller owns the slot table of payloads, the reservoir only decides
//   // slot placement — offer n items, get back each item's slot in
//   // [0, k) (replace the occupant) or -1 (shed this item).  State is
//   // fully extractable/restorable so a recovering server resumes the
//   // SAME sampling stream (checkpoint-carried, seed-reproducible).
//   void *reservoir_new(long k, unsigned long long seed);
//   long  reservoir_offer(void *r, long n, long *out_slots);  // -> kept
//   void  reservoir_state(void *r, unsigned long long out[6]);
//   void *reservoir_from_state(const unsigned long long st[6]);
//   void  reservoir_free(void *r);
//
// Build: g++ -O3 -shared -fPIC reservoir.cc -o libreservoir.so
// (fuzzyheavyhitters_torch/native/__init__.py does this on first use, into
// the build directory of ops/cuda_build.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Xoshiro256 {
  uint64_t s[4];
  explicit Xoshiro256(uint64_t seed) {
    // splitmix64 expansion of the seed into the state
    uint64_t x = seed;
    for (auto &w : s) {
      x += 0x9E3779B97F4A7C15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      w = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // uniform in [0, n) without modulo bias (Lemire)
  uint64_t below(uint64_t n) {
    __uint128_t m = (__uint128_t)next() * n;
    uint64_t lo = (uint64_t)m;
    if (lo < n) {
      uint64_t floor = (~n + 1) % n;
      while (lo < floor) {
        m = (__uint128_t)next() * n;
        lo = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

// Extract fields col_a and col_b from one CSV line (RFC-4180-ish: quoted
// fields may contain commas; doubled quotes inside quotes are fine for
// numeric columns, which is all we parse).  Returns true when both parse.
bool parse_cols(const char *line, int col_a, int col_b, double *a, double *b) {
  int col = 0, want = 2;
  const char *p = line;
  const char *field_start = p;
  bool in_quotes = false;
  double *dst;
  while (true) {
    char c = *p;
    if (in_quotes) {
      if (c == '"') in_quotes = false;
      else if (c == '\0') return false;
      ++p;
      continue;
    }
    if (c == '"') {
      in_quotes = true;
      ++p;
      continue;
    }
    if (c == ',' || c == '\0' || c == '\n' || c == '\r') {
      dst = (col == col_a) ? a : (col == col_b) ? b : nullptr;
      if (dst != nullptr) {
        const char *fs = field_start;
        if (*fs == '"') ++fs;  // numeric field wrapped in quotes
        char *end = nullptr;
        *dst = strtod(fs, &end);
        if (end == fs) return false;  // empty / non-numeric field
        if (--want == 0) return true;
      }
      if (c != ',') return false;  // line ended before both columns
      ++col;
      field_start = ++p;
      continue;
    }
    ++p;
  }
}

// Incremental algorithm-R reservoir over caller-owned slots.  Identical
// math to the CSV path (same RNG, same below()), factored so the ingest
// plane can shed admissions one submission at a time.
struct Reservoir {
  Xoshiro256 rng;
  long k;
  long seen;
  explicit Reservoir(long k_, uint64_t seed) : rng(seed), k(k_), seen(0) {}
};

}  // namespace

extern "C" {

void *reservoir_new(long k, unsigned long long seed) {
  if (k <= 0) return nullptr;
  return new Reservoir(k, seed);
}

void reservoir_free(void *r) { delete static_cast<Reservoir *>(r); }

// Offer n sequential items; out_slots[i] = slot in [0, k) the i-th item
// lands in (replacing the occupant), or -1 when it is shed.  Returns the
// number of items kept.
long reservoir_offer(void *rp, long n, long *out_slots) {
  Reservoir *r = static_cast<Reservoir *>(rp);
  long kept = 0;
  for (long i = 0; i < n; ++i) {
    long slot;
    if (r->seen < r->k) {
      slot = r->seen;  // fill phase: sequential slots
    } else {
      uint64_t j = r->rng.below((uint64_t)r->seen + 1);
      slot = ((long)j < r->k) ? (long)j : -1;
    }
    out_slots[i] = slot;
    if (slot >= 0) ++kept;
    ++r->seen;
  }
  return kept;
}

// State layout: [k, seen, s0, s1, s2, s3] — enough to resume the exact
// sampling stream after a checkpoint restore.
void reservoir_state(void *rp, unsigned long long out[6]) {
  Reservoir *r = static_cast<Reservoir *>(rp);
  out[0] = (unsigned long long)r->k;
  out[1] = (unsigned long long)r->seen;
  for (int i = 0; i < 4; ++i) out[2 + i] = r->rng.s[i];
}

void *reservoir_from_state(const unsigned long long st[6]) {
  if ((long)st[0] <= 0) return nullptr;
  Reservoir *r = new Reservoir((long)st[0], 0);
  r->seen = (long)st[1];
  for (int i = 0; i < 4; ++i) r->rng.s[i] = st[2 + i];
  return r;
}

long csv_reservoir_sample(const char *path, int col_a, int col_b, long k,
                          unsigned long long seed, double *out_a,
                          double *out_b) {
  FILE *f = fopen(path, "rb");
  if (f == nullptr) return -1;
  setvbuf(f, nullptr, _IOFBF, 1 << 20);
  Xoshiro256 rng(seed);
  std::string line;
  line.reserve(4096);
  char buf[1 << 16];
  long seen = 0, kept = 0;
  bool header = true;
  while (fgets(buf, sizeof buf, f) != nullptr) {
    line += buf;
    if (!line.empty() && line.back() != '\n' && !feof(f)) continue;  // long line
    if (header) {  // skip the header row (both reference samplers do)
      header = false;
      line.clear();
      continue;
    }
    double a, b;
    if (parse_cols(line.c_str(), col_a, col_b, &a, &b)) {
      if (kept < k) {
        out_a[kept] = a;
        out_b[kept] = b;
        ++kept;
      } else {
        uint64_t j = rng.below((uint64_t)seen + 1);
        if ((long)j < k) {
          out_a[j] = a;
          out_b[j] = b;
        }
      }
      ++seen;
    }
    line.clear();
  }
  fclose(f);
  return kept;
}

}  // extern "C"
