/* Public C ABI of the native core: the PyTorch port's copy of cpp/, built
 * by dmlc_tpu_torch/native/_build.py.
 *
 * The reference ships libdmlc.a consumed by C++ programs (xgboost, mxnet);
 * this header is the equivalent consumable surface for the rebuilt native
 * layer: chunk parsers (strtonum.h/libsvm_parser.h analogs), the RecordIO
 * binary format (recordio.h), and the threaded ingest pipeline
 * (threadediter.h + input_split_base.cc + text_parser.h as ONE engine).
 * The Python package binds exactly these symbols via ctypes
 * (dmlc_tpu_torch/native/__init__.py); C++ consumers can dlopen or link the .so
 * directly. Everything is plain C types — no C++ ABI exposure.
 *
 * Thread-safety: a pipeline handle may be fed (push_*) by one thread and
 * drained (peek/fetch/stage) by another; per-handle calls within each side
 * must be serialized by the caller. Parsers are pure functions.
 *
 * Check dmlc_tpu_abi_version() == DMLC_TPU_ABI_VERSION before use: the ABI
 * evolves with the package and the two always ship together.
 */
#ifndef DMLC_TPU_H_
#define DMLC_TPU_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define DMLC_TPU_ABI_VERSION 7

/* ---- status codes (parsers and pipeline) ------------------------------ */
enum {
  DMLC_TPU_OK = 0,
  DMLC_TPU_EOVERFLOW = -1, /* output capacity exceeded / bucket too small */
  DMLC_TPU_EPARSE = -2     /* malformed input */
};

/* Feature flags reported by parse_libsvm* / ingest_peek. */
enum {
  DMLC_TPU_HAS_WEIGHT = 1,
  DMLC_TPU_HAS_QID = 2,
  DMLC_TPU_HAS_VALUE = 4
};

/* Ingest formats (ingest_open / ingest_open_push). */
enum {
  DMLC_TPU_FORMAT_LIBSVM = 0,
  DMLC_TPU_FORMAT_LIBFM = 1,
  DMLC_TPU_FORMAT_CSV = 2,
  DMLC_TPU_FORMAT_RECORDIO = 3
};

int dmlc_tpu_abi_version(void);

/* SIMD tier selected at runtime for the LibSVM parse path (by the CPUID
 * check alone): 0 = portable scalar, 2 = AVX2+BMI2
 * tokenize/convert engine. Results are bit-identical at every tier; the
 * value is telemetry for bench records and the parse-parity tests. */
int dmlc_tpu_simd_level(void);

/* ---- chunk parsers (src/data/strtonum.h + libsvm/libfm/csv analogs) ---
 * One forward scan per chunk: caller allocates outputs using upper bounds
 * (rows, nnz <= len/2 + 2; or count_tokens for exact-ish sizing), parser
 * returns exact counts for trimming. row_nnz holds per-row entry counts
 * (prefix-sum to CSR offsets). The *32 variants write u32 indices directly
 * (device layout, no narrowing pass). */
int parse_libsvm(const char* data, int64_t len, float* labels, float* weights,
                 int64_t* qids, int64_t* row_nnz, uint64_t* indices,
                 float* values, int64_t max_rows, int64_t max_nnz,
                 int64_t* out_rows, int64_t* out_nnz, int* out_flags);
int parse_libsvm32(const char* data, int64_t len, float* labels,
                   float* weights, int64_t* qids, int64_t* row_nnz,
                   uint32_t* indices, float* values, int64_t max_rows,
                   int64_t max_nnz, int64_t* out_rows, int64_t* out_nnz,
                   int* out_flags);
int parse_libfm(const char* data, int64_t len, float* labels,
                int64_t* row_nnz, uint64_t* fields, uint64_t* indices,
                float* values, int64_t max_rows, int64_t max_nnz,
                int64_t* out_rows, int64_t* out_nnz);
int parse_libfm32(const char* data, int64_t len, float* labels,
                  int64_t* row_nnz, uint32_t* fields, uint32_t* indices,
                  float* values, int64_t max_rows, int64_t max_nnz,
                  int64_t* out_rows, int64_t* out_nnz);
/* expect_cols <= 0 infers the column count from the first row. */
int parse_csv(const char* data, int64_t len, float* out, int64_t max_rows,
              int64_t expect_cols, int64_t* out_rows, int64_t* out_cols);
/* Upper-bound counter for output sizing: newline count + 1 rows,
 * whitespace-delimited token count (>= nnz + rows). */
void count_tokens(const char* data, int64_t len, int64_t* out_rows,
                  int64_t* out_tokens);

/* ---- RecordIO binary format (recordio.h / src/recordio.cc analog) -----
 * Byte-identical on-disk format: [magic 0xced7230a][cflag|len][data][pad4],
 * embedded magics split records into multi-part groups (cflag 1/2/3). */
int64_t recordio_pack_bound(const char* data, int64_t len);
/* Returns bytes written, or -1 when len >= 2^29 (the length field). */
int64_t recordio_pack(const char* data, int64_t len, char* out);
int64_t recordio_pack_batch_bound(const char* data, const int64_t* offsets,
                                  int64_t n);
int64_t recordio_pack_batch(const char* data, const int64_t* offsets,
                            int64_t n, char* out);
/* Decode every whole record in buf; out_offsets gets nrec+1 entries,
 * out_consumed the bytes of complete records (a trailing partial record is
 * left for the caller's next buffer). */
int recordio_unpack(const char* buf, int64_t len, char* out_data,
                    int64_t* out_offsets, int64_t* out_nrec,
                    int64_t* out_datalen, int64_t* out_consumed);
/* First whole-record head at/after start (4-byte aligned magic with a
 * non-continuation cflag), or -1 — the SeekRecordBegin resync primitive. */
int64_t recordio_find_head(const char* buf, int64_t len, int64_t start);

/* ---- threaded ingest pipeline ----------------------------------------
 * reader thread -> parse worker pool -> ordered block queue, with chunk
 * recycling (the reference's ThreadedIter free-cell discipline). Two ways
 * in: ingest_open reads local files (paths = nfiles NUL-terminated strings
 * back to back; part/nparts = exactly-once byte-range sharding), and
 * ingest_open_push lets the caller stream bytes (remote readahead). Both
 * return NULL on bad arguments. */
void* ingest_open(const char* paths, const int64_t* sizes, int32_t nfiles,
                  int32_t format, int32_t part, int32_t nparts,
                  int32_t nthread, int64_t chunk_bytes, int32_t capacity,
                  int64_t csv_expect_cols);

/* ingest_open + seeded chunk-shuffled visit order (the reference's
 * input_split_shuffle.h semantic: sub-splits visited in random order per
 * epoch, here at chunk granularity). shuffle_seed < 0 = off (identical to
 * ingest_open). Requires the zero-copy mmap reader (single-file byte
 * range, local): the streaming reader cannot reorder
 * without deadlocking its bounded queues, so an unsatisfiable request
 * returns NULL and the caller falls back to its host-side shuffle. */
void* ingest_open_ex(const char* paths, const int64_t* sizes, int32_t nfiles,
                     int32_t format, int32_t part, int32_t nparts,
                     int32_t nthread, int64_t chunk_bytes, int32_t capacity,
                     int64_t csv_expect_cols, int64_t shuffle_seed);
void* ingest_open_push(int32_t format, int32_t nthread, int64_t chunk_bytes,
                       int32_t capacity, int64_t csv_expect_cols);

/* Push-mode feeding. Copying push, or zero-copy reserve/commit (write up to
 * `want` bytes into the returned buffer, then commit the count — the buffer
 * is valid until the next push call). End with push_eof; on a fetch failure
 * push_abort fails the pipeline so blocked consumers wake with an error. */
int ingest_push(void* handle, const char* data, int64_t len);
void* ingest_push_reserve(void* handle, int64_t want);
int ingest_push_commit(void* handle, int64_t n);
int ingest_push_eof(void* handle);
void ingest_push_abort(void* handle);

/* Remote-ingest push loop (ABI >= 5). Transport boundary, by design: this
 * library ships no HTTP/object-store client — the consumer brings the
 * transport (libcurl, an SDK, a socket; the Python package's s3://gs://
 * readahead is one such consumer) and the pipeline brings record-boundary
 * cutting, parse fan-out and ordered delivery. `fetch` is called serially
 * with the next byte offset and a destination INSIDE the pipeline's push
 * memory (readinto semantics — no staging copy); it returns the bytes
 * written (<= len), 0 at end of stream, or < 0 on a transport error
 * (which aborts the pipeline so blocked consumers fail fast instead of
 * hanging). `total` < 0 streams until fetch returns 0; `fetch_bytes`
 * <= 0 defaults to 1 MiB per call. On success the stream is EOF'd and
 * the handle drains through ingest_peek/fetch as usual. Returns 0 or a
 * pipeline error code. */
typedef int64_t (*dmlc_tpu_fetch_fn)(void* ctx, int64_t offset, char* buf,
                                     int64_t len);
int ingest_drive_push(void* handle, dmlc_tpu_fetch_fn fetch, void* ctx,
                      int64_t total, int64_t fetch_bytes);

/* Block-at-a-time draining: peek blocks for the next in-order parsed block
 * (1 = ready, 0 = end of stream, <0 = pipeline error) and reports sizes;
 * fetch copies it out (CSR: offsets[rows+1], u32 indices); fetch_view hands
 * out zero-copy pointers plus an owner token to release via block_free. */
int ingest_peek(void* handle, int64_t* rows, int64_t* nnz, int64_t* ncols,
                int32_t* flags);
int ingest_fetch(void* handle, float* labels, float* weights, int64_t* qids,
                 int64_t* offsets, uint32_t* indices, float* values,
                 uint32_t* fields);
void* ingest_fetch_view(void* handle, float** labels, float** weights,
                        int64_t** qids, int64_t** offsets, uint32_t** indices,
                        float** values, uint32_t** fields);
void ingest_block_free(void* block);

/* Fixed-shape batch staging (the TPU feed fast path): stage_batch gathers
 * the next batch_size rows (1 = staged, 0 = end of stream, <0 = error);
 * the matching fetch consumes them into device-layout buffers, padded to
 * static shapes (padding entries are arithmetic no-ops).
 *  - dense: x[batch, F] row-major, short batches zero-padded (weight 0)
 *  - coo: indices/values/row_ids[nnz_bucket] + CSR offsets[batch+1]
 *  - coo_sharded: flat [num_shards * nnz_bucket] per-shard entry sections
 *    with LOCAL row ids + offsets[num_shards * (batch/num_shards + 1)],
 *    so sharding the leading dim ships each device only its own entries.
 * Fetch returns rows consumed, or DMLC_TPU_EOVERFLOW (consuming nothing)
 * when a bucket is too small — staged_max_shard_nnz sizes it. */
int ingest_stage_batch(void* handle, int64_t batch_size, int64_t* rows,
                       int64_t* nnz);
int64_t ingest_fetch_batch_dense(void* handle, float* x, float* labels,
                                 float* weights, int64_t batch_size,
                                 int64_t num_features);
int64_t ingest_fetch_batch_coo(void* handle, float* labels, float* weights,
                               int32_t* indices, float* values,
                               int32_t* row_ids, int32_t* offsets,
                               int64_t batch_size, int64_t nnz_bucket);
int64_t ingest_staged_max_shard_nnz(void* handle, int64_t batch_size,
                                    int64_t num_shards);
int64_t ingest_fetch_batch_coo_sharded(void* handle, float* labels,
                                       float* weights, int32_t* indices,
                                       float* values, int32_t* row_ids,
                                       int32_t* offsets, int64_t batch_size,
                                       int64_t num_shards,
                                       int64_t nnz_bucket);

/* Telemetry: out[0]=bytes_read, [1]=chunks, [2]=reader_io_ns,
 * [3]=reader_wait_ns, [4]=parse_ns, [5]=worker_wait_ns,
 * [6]=consumer_wait_ns (SURVEY §5.1 per-stage timers). */
void ingest_stats(void* handle, double* out, int32_t n);
int64_t ingest_bytes_read(void* handle);
void ingest_close(void* handle);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* DMLC_TPU_H_ */
