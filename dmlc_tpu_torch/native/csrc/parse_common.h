// Shared scalar parse primitives: the SWAR float/int scanners and the
// single-row LibSVM parser, used by both the portable scalar chunk loop
// (parse.cc) and the AVX2 tokenize+convert engine (parse_simd.cc). The SIMD
// engine falls back to ParseSvmRowScalar for any row it cannot prove it
// handles bit-identically (qid, exponents, tokens longer than its 8-byte
// window, malformed input), so the scalar row parser is the single source
// of truth for LibSVM semantics.
#ifndef DMLC_TPU_PARSE_COMMON_H_
#define DMLC_TPU_PARSE_COMMON_H_

#include <cstdint>
#include <cstring>

#include "dmlc_tpu.h"

namespace dmlc_tpu_parse {

inline bool is_space(char c) { return c == ' ' || c == '\t'; }

// '\r' is a line terminator (LineSplitter record boundaries accept \n, \r,
// and \r\n), never inline whitespace — treating it as a space would merge
// adjacent rows.
inline bool is_eol(char c) { return c == '\n' || c == '\r'; }

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// Exact powers of ten: 10^k is representable exactly in a double for
// k <= 22, so mantissa*10^k / mantissa/10^k round once — the classic fast
// strtod fast path.
inline const double* Pow10Table() {
  static const double kPow10[23] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,
                                    1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
                                    1e12, 1e13, 1e14, 1e15, 1e16, 1e17,
                                    1e18, 1e19, 1e20, 1e21, 1e22};
  return kPow10;
}

inline double ApplyExp10(double val, int64_t exp10) {
  if (exp10 == 0) return val;
  const double* kPow10 = Pow10Table();
  // |exp10| beyond ±350 already saturates to ±inf / ±0 for any mantissa the
  // scan can produce (<= 1e19); clamping bounds the loop for adversarial
  // exponents like 1e-999999999. The clamp happens HERE, after the explicit
  // exponent has been folded in, so compensating pairs (long zero run +
  // large positive exponent) stay exact.
  if (exp10 > 350) exp10 = 350;
  else if (exp10 < -350) exp10 = -350;
  if (exp10 > 0) {
    while (exp10 > 22) { val *= 1e22; exp10 -= 22; }
    return val * kPow10[exp10];
  }
  exp10 = -exp10;
  while (exp10 > 22) { val /= 1e22; exp10 -= 22; }
  return val / kPow10[exp10];
}

// SWAR helpers for the fraction hot path: classify 8 bytes at once and
// convert a full 8-digit group with a multiply tree instead of a serial
// per-digit loop. `y` is the chunk XOR 0x30..30, so digit bytes are 0..9.
// Returns the count of leading (lowest-address-first) digit bytes and masks
// *digits down to them. Carry-free: the add is done on 7-bit bytes.
inline int CountDigits8(uint64_t y, uint64_t* digits) {
  uint64_t y7 = y & 0x7F7F7F7F7F7F7F7FULL;
  uint64_t nondigit =
      (((y7 + 0x7676767676767676ULL) | y) & 0x8080808080808080ULL);
  if (nondigit == 0) {
    *digits = y;
    return 8;
  }
  int k = __builtin_ctzll(nondigit) >> 3;
  *digits = y & ((1ULL << (k * 8)) - 1);
  return k;
}

// 8 ascii-stripped digit bytes (lowest address = most significant digit,
// little-endian load) -> the 8-digit number. Three multiplies total.
inline uint32_t Swar8Digits(uint64_t y) {
  const uint64_t mask = 0x000000FF000000FFULL;
  const uint64_t mul1 = 0x000F424000000064ULL;  // 100 + (1000000 << 32)
  const uint64_t mul2 = 0x0000271000000001ULL;  // 1 + (10000 << 32)
  y = (y * 10) + (y >> 8);
  return static_cast<uint32_t>(
      (((y & mask) * mul1) + (((y >> 16) & mask) * mul2)) >> 32);
}

// Fast float scan: sign, integer part, fraction, optional exponent.
// Handles the common data-file cases inline; no INF/NAN/hex (same contract
// as the reference's strtonum.h:37, by design: data files don't contain
// them, and rejecting keeps the loop branch-light). Digits accumulate into
// an integer mantissa (pipelinable integer ops, no serial FP chain); the
// decimal exponent is applied once at the end via exact powers of ten.
inline const char* scan_double(const char* p, const char* end, double* out) {
  if (p == end) return nullptr;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  else if (*p == '+') { ++p; }
  if (p == end || (!is_digit(*p) && *p != '.')) return nullptr;
  uint64_t mant = 0;
  int ndig = 0;   // significant digits folded into mant (19 max: fits uint64)
  // int64: bounded by the input length, so digit/zero runs can't overflow
  // it; saturation is applied once in ApplyExp10 after the explicit
  // exponent is added (a mid-scan cap would corrupt compensating pairs
  // like "0.<420 zeros>5e450").
  int64_t exp10 = 0;
  // ndig += (mant != 0) keeps leading zeros mantissa-budget-free without a
  // branch in the hot loop (folding a 0 into mant==0 is a numeric no-op).
  while (p != end && is_digit(*p)) {
    if (ndig < 19) {
      mant = mant * 10 + static_cast<uint64_t>(*p - '0');
      ndig += static_cast<int>(mant != 0);
    } else {
      ++exp10;
    }
    ++p;
  }
  if (p != end && *p == '.') {
    ++p;
    // 8-wide groups while the mantissa has room (mant*1e8 + 8 digits must
    // fit uint64: safe while ndig <= 11). A short group (k < 8) appends
    // 8-k virtual zero digits — value-preserving for a fraction tail, and
    // the byte at p+k is a real non-digit so the scalar loop below exits
    // immediately. An all-zero group before any significant digit shifts
    // the decimal point but costs no mantissa budget, so long zero runs
    // ("0.<420 zeros>5") skip 8 bytes at a time with their significant
    // digits preserved.
    while (end - p >= 8 && ndig <= 11) {
      uint64_t chunk;
      std::memcpy(&chunk, p, 8);
      uint64_t digs;
      int k = CountDigits8(chunk ^ 0x3030303030303030ULL, &digs);
      if (k == 0) break;
      // branchless: folding an all-zero group into a zero mantissa is a
      // numeric no-op, and ndig charges 8 only once a significant digit
      // has appeared
      mant = mant * 100000000ULL + Swar8Digits(digs);
      ndig += static_cast<int>(mant != 0) << 3;
      exp10 -= 8;
      p += k;
      if (k < 8) break;
    }
    while (p != end && is_digit(*p)) {
      if (ndig < 19) {
        mant = mant * 10 + static_cast<uint64_t>(*p - '0');
        ndig += static_cast<int>(mant != 0);
        --exp10;
      }
      ++p;
    }
  }
  if (p != end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p != end && (*p == '-' || *p == '+')) { eneg = (*p == '-'); ++p; }
    int ex = 0;
    while (p != end && is_digit(*p)) {
      if (ex < 100000000) ex = ex * 10 + (*p - '0');
      ++p;
    }
    exp10 += eneg ? -ex : ex;
  }
  *out = ApplyExp10(neg ? -static_cast<double>(mant)
                        : static_cast<double>(mant),
                    exp10);
  return p;
}

inline const char* scan_u64(const char* p, const char* end, uint64_t* out) {
  if (p == end || !is_digit(*p)) return nullptr;
  uint64_t v = 0;
  while (p != end && is_digit(*p)) { v = v * 10 + (*p - '0'); ++p; }
  *out = v;
  return p;
}

inline const uint64_t* Pow10U64Table() {
  static const uint64_t kPow10U64[9] = {1ULL,       10ULL,       100ULL,
                                        1000ULL,    10000ULL,    100000ULL,
                                        1000000ULL, 10000000ULL, 100000000ULL};
  return kPow10U64;
}

// SWAR u64 scan for LONG digit runs (high-cardinality feature ids: Criteo's
// 7-digit hashed ids). Classify 8 bytes at once, then convert the k leading
// digits in one multiply tree: the k digit bytes (most significant at the
// lowest address) are shifted up so Swar8Digits sees them as the LEAST
// significant digit positions behind leading zeros — value-exact, no
// division. ~constant ~20 ops per <=8-digit run vs a 4-5 cycle/digit serial
// mul-add chain; loses on 1-2 digit ids (measured 45% slower if applied
// unconditionally — see BASELINE.md round-3 notes), so callers pick it
// per-chunk from observed id lengths.
inline const char* scan_u64_swar(const char* p, const char* end,
                                 uint64_t* out) {
  if (p == end || !is_digit(*p)) return nullptr;
  const uint64_t* kPow10U64 = Pow10U64Table();
  uint64_t v = 0;
  while (end - p >= 8) {
    uint64_t chunk;
    std::memcpy(&chunk, p, 8);
    uint64_t digs;
    int k = CountDigits8(chunk ^ 0x3030303030303030ULL, &digs);
    if (k == 0) break;
    v = v * kPow10U64[k] + Swar8Digits(digs << ((8 - k) * 8));
    p += k;
    if (k < 8) { *out = v; return p; }
  }
  while (p != end && is_digit(*p)) { v = v * 10 + (*p - '0'); ++p; }
  *out = v;
  return p;
}

// Output cursor for a LibSVM parse: the caller-allocated arrays plus the
// running row/nnz counters and feature flags. Shared between the scalar
// chunk loop and the SIMD engine so fallback rows append seamlessly.
template <typename IndexT>
struct SvmSink {
  float* labels;
  float* weights;
  int64_t* qids;
  int64_t* row_nnz;
  IndexT* indices;
  float* values;
  int64_t max_rows;
  int64_t max_nnz;
  int64_t rows;
  int64_t nnz;
  int flags;
};

// Parse ONE LibSVM row: "label[:weight] [qid:n] idx[:val] ...". *pp must
// point at the first non-space byte of the row; on success it is advanced
// past the row's line terminator (one byte of \n or \r — the outer loop's
// space/eol skip absorbs the second byte of \r\n). When id_bytes/id_count
// are non-null (first row of a chunk) the feature-id byte lengths are
// sampled for the adaptive long-id scan selection.
template <typename IndexT>
inline int ParseSvmRowScalar(const char** pp, const char* end, bool long_ids,
                             int64_t* id_bytes, int64_t* id_count,
                             SvmSink<IndexT>* s) {
  const char* p = *pp;
  // label [:weight]
  double label;
  const char* q = scan_double(p, end, &label);
  if (q == nullptr) return DMLC_TPU_EPARSE;
  p = q;
  double weight = 1.0;
  if (p != end && *p == ':') {
    ++p;
    q = scan_double(p, end, &weight);
    if (q == nullptr) return DMLC_TPU_EPARSE;
    p = q;
    s->flags |= DMLC_TPU_HAS_WEIGHT;
  }
  if (s->rows >= s->max_rows) return DMLC_TPU_EOVERFLOW;
  // missing qid -> 0, matching RowBlockContainer's neutral-default policy
  // (and the pure-Python twin)
  int64_t qid = 0;
  int64_t row_start = s->nnz;
  // features until newline
  for (;;) {
    while (p != end && is_space(*p)) ++p;
    if (p == end || is_eol(*p)) {
      if (p != end) ++p;
      break;
    }
    if (*p == 'q' && end - p > 4 && std::memcmp(p, "qid:", 4) == 0) {
      uint64_t qv;
      q = scan_u64(p + 4, end, &qv);
      if (q == nullptr) return DMLC_TPU_EPARSE;
      qid = static_cast<int64_t>(qv);
      s->flags |= DMLC_TPU_HAS_QID;
      p = q;
      continue;
    }
    uint64_t idx;
    q = long_ids ? scan_u64_swar(p, end, &idx) : scan_u64(p, end, &idx);
    if (q == nullptr) return DMLC_TPU_EPARSE;
    if (id_bytes != nullptr) { *id_bytes += q - p; ++*id_count; }
    p = q;
    double val = 1.0;
    if (p != end && *p == ':') {
      ++p;
      q = scan_double(p, end, &val);
      if (q == nullptr) return DMLC_TPU_EPARSE;
      p = q;
      s->flags |= DMLC_TPU_HAS_VALUE;
    }
    if (s->nnz >= s->max_nnz) return DMLC_TPU_EOVERFLOW;
    s->indices[s->nnz] = static_cast<IndexT>(idx);
    s->values[s->nnz] = static_cast<float>(val);
    ++s->nnz;
  }
  s->labels[s->rows] = static_cast<float>(label);
  s->weights[s->rows] = static_cast<float>(weight);
  s->qids[s->rows] = qid;
  s->row_nnz[s->rows] = s->nnz - row_start;
  ++s->rows;
  *pp = p;
  return DMLC_TPU_OK;
}

// SIMD engine entry points (parse_simd.cc). SimdKernelLevel() reports the
// tier the runtime CPUID check selected: 0 = scalar only, 2 = AVX2+BMI2
// engine. The ParseSvmSimd* calls are only valid when the level is >= 2.
int SimdKernelLevel();
int ParseSvmSimdU32(const char* data, int64_t len, SvmSink<uint32_t>* s);
int ParseSvmSimdU64(const char* data, int64_t len, SvmSink<uint64_t>* s);

inline int ParseSvmSimd(const char* data, int64_t len, SvmSink<uint32_t>* s) {
  return ParseSvmSimdU32(data, len, s);
}
inline int ParseSvmSimd(const char* data, int64_t len, SvmSink<uint64_t>* s) {
  return ParseSvmSimdU64(data, len, s);
}

}  // namespace dmlc_tpu_parse

#endif  // DMLC_TPU_PARSE_COMMON_H_
