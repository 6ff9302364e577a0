// Native hot loops: text chunk -> CSR arrays.
//
// TPU-build equivalent of the reference's parse path (src/data/strtonum.h,
// libsvm_parser.h, libfm_parser.h, csv_parser.h): the chunk-level tokenize +
// numeric-convert loop is the ingest bottleneck, so it lives in C++ behind a
// flat C ABI (ctypes-loadable, zero Python objects inside). Design differs
// from the reference: single forward scan with branch-light inline float
// parsing, caller-allocated output arrays (upper bounds derived from the
// chunk), and row/nnz counts returned for exact trimming. No OpenMP — the
// Python side maps chunk pieces onto a thread pool and ctypes releases the
// GIL, so parallelism composes at the chunk level.
//
// The LibSVM path additionally runtime-dispatches to the AVX2 tokenize +
// batch-convert engine in parse_simd.cc (SimdKernelLevel() gates on CPUID
// alone); the scalar loop below is both the portable fallback
// and the row-level oracle the SIMD engine defers to for anything outside
// its fast shapes, so results are bit-identical either way.

#include <cstdint>
#include <cstring>

#include "dmlc_tpu.h"
#include "parse_common.h"

using namespace dmlc_tpu_parse;

// Status codes and feature flags come from the public header
// (dmlc_tpu.h) — the single source the Python binding and external
// consumers read.


// Parse libfm text: "label field:idx:val ..." per line. Outputs as libsvm
// plus fields [max_nnz].
template <typename IndexT>
static int parse_libfm_impl(const char* data, int64_t len,
                float* labels, int64_t* row_nnz,
                IndexT* fields, IndexT* indices, float* values,
                int64_t max_rows, int64_t max_nnz,
                int64_t* out_rows, int64_t* out_nnz) {
  const char* p = data;
  const char* end = data + len;
  int64_t rows = 0, nnz = 0;
  // Adaptive id scan, as in parse_libsvm_impl: first row's average idx
  // length picks serial vs SWAR-group conversion for the chunk.
  bool long_ids = false;
  int64_t id_bytes = 0, id_count = 0;
  while (p != end) {
    while (p != end && (is_space(*p) || is_eol(*p))) ++p;
    if (p == end) break;
    double label;
    const char* q = scan_double(p, end, &label);
    if (q == nullptr) return DMLC_TPU_EPARSE;
    p = q;
    if (rows >= max_rows) return DMLC_TPU_EOVERFLOW;
    int64_t row_start = nnz;
    for (;;) {
      while (p != end && is_space(*p)) ++p;
      if (p == end || is_eol(*p)) {
        if (p != end) ++p;
        break;
      }
      uint64_t field, idx;
      double val;
      q = scan_u64(p, end, &field);
      if (q == nullptr || q == end || *q != ':') return DMLC_TPU_EPARSE;
      const char* idx_start = q + 1;
      q = long_ids ? scan_u64_swar(idx_start, end, &idx)
                   : scan_u64(idx_start, end, &idx);
      if (q == nullptr || q == end || *q != ':') return DMLC_TPU_EPARSE;
      if (rows == 0) { id_bytes += q - idx_start; ++id_count; }
      q = scan_double(q + 1, end, &val);
      if (q == nullptr) return DMLC_TPU_EPARSE;
      p = q;
      if (nnz >= max_nnz) return DMLC_TPU_EOVERFLOW;
      fields[nnz] = static_cast<IndexT>(field);
      indices[nnz] = static_cast<IndexT>(idx);
      values[nnz] = static_cast<float>(val);
      ++nnz;
    }
    labels[rows] = static_cast<float>(label);
    row_nnz[rows] = nnz - row_start;
    ++rows;
    if (rows == 1) long_ids = id_count > 0 && id_bytes >= 5 * id_count;  // avg >= 5 digits
  }
  *out_rows = rows;
  *out_nnz = nnz;
  return DMLC_TPU_OK;
}

// First-line shape probe for kernel dispatch: average feature-id length in
// bytes. The AVX2 engine amortizes its tokenize+batch-convert tiles best on
// long tokens (Criteo-class 6-7 digit hashed ids: ~16% over scalar); on
// HIGGS-class 1-2 digit ids the scalar SWAR loop's per-byte costs are
// already near the floor and the engine's extra passes lose ~8%. Same
// homogeneity assumption as the long_ids SWAR pick below, sampled without
// parsing: bytes from each token start to its first ':' (or token end).
static bool ProbeLongIds(const char* data, int64_t len) {
  int64_t cap = len < 2048 ? len : 2048;
  int64_t i = 0;
  while (i < cap && (is_space(data[i]) || is_eol(data[i]))) ++i;
  int64_t id_bytes = 0, id_count = 0;
  bool first_tok = true;  // the label doesn't count
  while (i < cap && !is_eol(data[i])) {
    while (i < cap && is_space(data[i])) ++i;
    if (i >= cap || is_eol(data[i])) break;
    int64_t tok = i, colon = -1;
    while (i < cap && !is_space(data[i]) && !is_eol(data[i])) {
      if (colon < 0 && data[i] == ':') colon = i;
      ++i;
    }
    if (!first_tok) {
      id_bytes += (colon >= 0 ? colon : i) - tok;
      ++id_count;
    }
    first_tok = false;
  }
  return id_count > 0 && id_bytes >= 5 * id_count;  // avg >= 5 digits
}

// Templated over the index width: the pipeline consumes u32 indices, and
// writing them directly saves a whole narrowing pass over nnz (the
// NarrowU64ToU32 sweep used to re-read 8 and re-write 4 bytes per entry).
template <typename IndexT>
static int parse_libsvm_impl(const char* data, int64_t len,
                 float* labels, float* weights, int64_t* qids,
                 int64_t* row_nnz, IndexT* indices, float* values,
                 int64_t max_rows, int64_t max_nnz,
                 int64_t* out_rows, int64_t* out_nnz, int* out_flags) {
  SvmSink<IndexT> sink{labels,   weights, qids, row_nnz, indices, values,
                       max_rows, max_nnz, 0,    0,       0};
  // AVX2 engine when the CPU has it, the chunk is big enough to amortize
  // its tile setup (tiny chunks — unit-test strings — stay scalar), and the
  // first-line probe says the token shape favors it.
  if (len >= 256 && SimdKernelLevel() >= 2 && ProbeLongIds(data, len)) {
    int rc = ParseSvmSimd(data, len, &sink);
    if (rc != DMLC_TPU_OK) return rc;
    *out_rows = sink.rows;
    *out_nnz = sink.nnz;
    *out_flags = sink.flags;
    return DMLC_TPU_OK;
  }
  const char* p = data;
  const char* end = data + len;
  // Adaptive id scan: the first row's average id length picks serial vs
  // SWAR-group conversion for the whole chunk (files are homogeneous;
  // HIGGS-class 1-2 digit ids lose on SWAR classify overhead, Criteo-class
  // 7-digit hashed ids win ~constant-time conversion).
  bool long_ids = false;
  int64_t id_bytes = 0, id_count = 0;
  while (p != end) {
    while (p != end && (is_space(*p) || is_eol(*p))) ++p;
    if (p == end) break;
    bool first = sink.rows == 0;
    int rc = ParseSvmRowScalar<IndexT>(&p, end, long_ids,
                                       first ? &id_bytes : nullptr,
                                       first ? &id_count : nullptr, &sink);
    if (rc != DMLC_TPU_OK) return rc;
    if (sink.rows == 1)
      long_ids = id_count > 0 && id_bytes >= 5 * id_count;  // avg >= 5 digits
  }
  *out_rows = sink.rows;
  *out_nnz = sink.nnz;
  *out_flags = sink.flags;
  return DMLC_TPU_OK;
}


extern "C" {

// Parse libsvm text: "label[:weight] [qid:n] idx[:val] ..." per line.
// Outputs: labels/weights [max_rows], qids [max_rows], row_nnz [max_rows],
// indices/values [max_nnz] — u64 indices (the original ctypes ABI). Rows
// with no explicit weight get 1.0; bare indices get value 1.0. Returns
// DMLC_TPU_OK/errors; *out_rows, *out_nnz, *out_flags filled on success.
int parse_libsvm(const char* data, int64_t len,
                 float* labels, float* weights, int64_t* qids,
                 int64_t* row_nnz, uint64_t* indices, float* values,
                 int64_t max_rows, int64_t max_nnz,
                 int64_t* out_rows, int64_t* out_nnz, int* out_flags) {
  return parse_libsvm_impl<uint64_t>(
      data, len, labels, weights, qids, row_nnz, indices, values, max_rows,
      max_nnz, out_rows, out_nnz, out_flags);
}

// u32-index variant for the native pipeline's device-layout buffers
// (values past 2^32 truncate exactly like the old narrowing pass did).
int parse_libsvm32(const char* data, int64_t len,
                   float* labels, float* weights, int64_t* qids,
                   int64_t* row_nnz, uint32_t* indices, float* values,
                   int64_t max_rows, int64_t max_nnz,
                   int64_t* out_rows, int64_t* out_nnz, int* out_flags) {
  return parse_libsvm_impl<uint32_t>(
      data, len, labels, weights, qids, row_nnz, indices, values, max_rows,
      max_nnz, out_rows, out_nnz, out_flags);
}

int parse_libfm(const char* data, int64_t len,
                float* labels, int64_t* row_nnz,
                uint64_t* fields, uint64_t* indices, float* values,
                int64_t max_rows, int64_t max_nnz,
                int64_t* out_rows, int64_t* out_nnz) {
  return parse_libfm_impl<uint64_t>(data, len, labels, row_nnz, fields,
                                    indices, values, max_rows, max_nnz,
                                    out_rows, out_nnz);
}

// u32 variant for the native pipeline (see parse_libsvm32).
int parse_libfm32(const char* data, int64_t len,
                  float* labels, int64_t* row_nnz,
                  uint32_t* fields, uint32_t* indices, float* values,
                  int64_t max_rows, int64_t max_nnz,
                  int64_t* out_rows, int64_t* out_nnz) {
  return parse_libfm_impl<uint32_t>(data, len, labels, row_nnz, fields,
                                    indices, values, max_rows, max_nnz,
                                    out_rows, out_nnz);
}

// Parse dense CSV (no quoting — numeric data files): every line becomes
// ncols doubles; the first line fixes ncols. Outputs values row-major into
// out [max_rows * expect_cols]. If expect_cols == 0 it is inferred and
// written to *out_cols.
int parse_csv(const char* data, int64_t len, float* out,
              int64_t max_rows, int64_t expect_cols,
              int64_t* out_rows, int64_t* out_cols) {
  const char* p = data;
  const char* end = data + len;
  int64_t rows = 0;
  int64_t ncols = expect_cols;
  while (p != end) {
    while (p != end && is_eol(*p)) ++p;
    if (p == end) break;
    if (rows >= max_rows) return DMLC_TPU_EOVERFLOW;
    int64_t col = 0;
    float* row_out = out + rows * (ncols > 0 ? ncols : 0);
    for (;;) {
      double val = 0.0;
      while (p != end && is_space(*p)) ++p;
      if (p != end && *p != ',' && !is_eol(*p)) {
        const char* q = scan_double(p, end, &val);
        if (q == nullptr) return DMLC_TPU_EPARSE;
        p = q;
        while (p != end && is_space(*p)) ++p;
      }
      if (ncols > 0) {
        if (col >= ncols) return DMLC_TPU_EPARSE;
        row_out[col] = static_cast<float>(val);
      } else {
        // inference pass for first row: caller guarantees capacity via
        // max_rows * (commas in first line + 1)
        out[col] = static_cast<float>(val);
      }
      ++col;
      if (p == end || is_eol(*p)) {
        if (p != end) ++p;
        break;
      }
      if (*p != ',') return DMLC_TPU_EPARSE;
      ++p;
    }
    if (ncols <= 0) {
      ncols = col;
      row_out = out;
    } else if (col != ncols) {
      return DMLC_TPU_EPARSE;
    }
    ++rows;
  }
  *out_rows = rows;
  *out_cols = ncols;
  return DMLC_TPU_OK;
}

// One-pass upper-bound counter for output sizing: *out_rows = newline count
// + 1, *out_tokens = whitespace-delimited token count (>= nnz + rows).
void count_tokens(const char* data, int64_t len,
                  int64_t* out_rows, int64_t* out_tokens) {
  int64_t rows = 1, tokens = 0;
  bool in_tok = false;
  for (int64_t i = 0; i < len; ++i) {
    char c = data[i];
    if (is_eol(c)) {
      ++rows;
      in_tok = false;
    } else if (is_space(c)) {
      in_tok = false;
    } else if (!in_tok) {
      in_tok = true;
      ++tokens;
    }
  }
  *out_rows = rows;
  *out_tokens = tokens;
}

int dmlc_tpu_abi_version(void) { return DMLC_TPU_ABI_VERSION; }

// SIMD tier actually selected at runtime (CPUID alone):
// 0 = scalar, 2 = AVX2+BMI2 tokenizer engine. Exposed for telemetry and
// the parse-parity tests.
int dmlc_tpu_simd_level(void) { return SimdKernelLevel(); }

}  // extern "C"
