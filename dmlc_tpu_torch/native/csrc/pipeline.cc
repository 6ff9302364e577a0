// Native ingest pipeline: reader thread -> parse workers -> ordered queue.
//
// TPU-build equivalent of the reference's threaded ingest composition:
// ThreadedInputSplit's chunk prefetch thread (src/io/threaded_input_split.h),
// ThreadedParser's parse producer (src/data/parser.h:70-126) and the OpenMP
// chunk parse team (src/data/text_parser.h:94-134) — rebuilt as one native
// pipeline so the Python layer only sees finished CSR blocks. Design differs
// from the reference: chunk-level (not intra-chunk) parallelism across a
// worker pool, sequence-numbered ordered delivery, and recycled chunk
// buffers (the ThreadedIter free-cell idea, threadediter.h:442-454) so
// steady state does no allocation on the reader side.
//
// Partitioning semantics are the reference's exactly-once contract
// (src/io/input_split_base.cc:30-64): part k of n covers global bytes
// [adj(k*step), adj((k+1)*step)) over the concatenated file sequence, where
// adj(x) scans forward from x to just past the next end-of-line run
// (line_split.cc:9-26) and adj(0) = 0. Every record lands in exactly one
// part for any n.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <new>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <utility>
#include <thread>
#include <vector>

// POSIX (any unix): the mmap zero-copy reader
#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>

#if defined(__GLIBC__)
#include <malloc.h>  // mallopt (TuneMallocOnce) is glibc-only
#endif

// The public header carries every cross-TU declaration (parse.cc hot
// loops, recordio.cc framing) — the compiler checks our definitions
// against it.
#include "dmlc_tpu.h"

namespace {

// Parsed-block output arrays are malloc'd per chunk and freed by whoever
// consumes the block (often Python, via the zero-copy numpy owner) — a
// free list can't span that boundary, but glibc tuning gets the same
// effect: keep big allocations on the heap (raise M_MMAP_THRESHOLD past
// the ~30 MB per-array bound) and never trim the heap top, so freed pages
// stay faulted-in and the next chunk's arrays land on warm memory.
// Measured on the criteo-shaped bench: ~600 -> ~670 MB/s chunked parse
// (page-fault + munmap churn was ~10-15% of the hot loop; matches a
// perfect reuse harness). Costs steady-state RSS at the pipeline's
// high-water mark.
void TuneMallocOnce() {
#if defined(__GLIBC__)
  static bool done = [] {
    mallopt(M_MMAP_THRESHOLD, 64 * 1024 * 1024);
    mallopt(M_TRIM_THRESHOLD, 512 * 1024 * 1024);
    return true;
  }();
  (void)done;
#endif
}

enum Format { kLibsvm = 0, kLibfm = 1, kCsv = 2, kRecordIO = 3 };

// RecordIO framing constants (cpp/recordio.cc; reference recordio.h:17-70)
constexpr uint32_t kRioMagic = 0xced7230aU;

// Row-group payload: the binary row format carried inside RecordIO frames —
// the TPU build's answer to "binary shards must beat text parse" (the
// reference splits recordio natively, src/io/recordio_split.cc:9-82, but
// its data parsers are text-only; here the payload IS the CSR block, so
// ingest is framing + memcpy, no byte scanning). Layout, little-endian:
//   u8 tag 'R', u8 flags (1=weights 2=qids 4=values), u16 reserved,
//   u32 nrows, u32 nnz,
//   labels f32[nrows], weights f32[nrows]?, qids i64[nrows]?,
//   row_nnz u32[nrows], indices u32[nnz], values f32[nnz]?
constexpr uint8_t kRowGroupTag = 0x52;

enum {
  kOk = 0,
  kEOverflow = -1,
  kEParse = -2,
  kEIo = -3,
  kEOom = -4,
};

// row-flag bits mirrored from parse.cc (DMLC_TPU_HAS_*)
enum { kHasWeight = 1, kHasQid = 2, kHasValue = 4 };

inline int64_t NowNs() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

inline bool is_eol(char c) { return c == '\n' || c == '\r'; }

// Growable byte buffer without value-initialization: std::string/vector
// resize() zero-fills bytes that fread is about to overwrite — a full extra
// memory pass at ingest rates. Reserve leaves new capacity uninitialized.
struct Buf {
  char* p = nullptr;
  int64_t cap = 0;
  int64_t size = 0;

  ~Buf() { std::free(p); }
  Buf() = default;
  Buf(const Buf&) = delete;
  Buf& operator=(const Buf&) = delete;

  // false on allocation failure
  bool Reserve(int64_t n) {
    if (n <= cap) return true;
    int64_t want = std::max<int64_t>(n, cap * 2);
    char* np = static_cast<char*>(std::realloc(p, static_cast<size_t>(want)));
    if (np == nullptr) return false;
    p = np;
    cap = want;
    return true;
  }

  void Swap(Buf& other) {
    std::swap(p, other.p);
    std::swap(cap, other.cap);
    std::swap(size, other.size);
  }
};

struct Chunk {
  Buf data;
  int64_t seq = 0;
  // Borrowed view into the reader's mmap (zero-copy path): when set, the
  // chunk's bytes are ext[0..ext_len) and `data` stays empty. The mapping
  // outlives every in-flight chunk (munmap happens in Close after joins).
  const char* ext = nullptr;
  int64_t ext_len = 0;

  const char* ptr() const { return ext != nullptr ? ext : data.p; }
  int64_t len() const { return ext != nullptr ? ext_len : data.size; }
};

struct BlockPool;

// One parsed CSR batch. Buffers are malloc'd to a generous bound derived
// from the chunk length (every row and every token is >= 2 bytes, so
// len/2+2 bounds both) — untouched slack pages are virtual-only, which
// beats pre-scanning the chunk to size exactly. Indices/fields are u32
// storage written directly by the 32-bit parse variants.
//
// Returnable-block contract (extends the ThreadedIter recycle idea,
// threadediter.h:442-454, ACROSS the ownership boundary): a block whose
// text-parse arrays were sized to `cap_bound` elements can be returned to
// its origin pipeline's BlockPool instead of freed — the next chunk then
// parses into the SAME already-faulted pages. Release goes through
// ReleaseBlock() everywhere (including ingest_block_free, i.e. Python
// owners via the numpy-view finalizer), so the reuse survives the C ABI;
// blocks from the exact-size parsers (csv, recordio row-groups) keep
// cap_bound = 0 and always free. `pool` is reset while pooled so the
// free list never holds the refcount that keeps its own pool alive.
struct Block {
  float* labels = nullptr;
  float* weights = nullptr;
  float* values = nullptr;
  int64_t* qids = nullptr;
  int64_t* offsets = nullptr;
  uint32_t* indices = nullptr;
  uint32_t* fields = nullptr;
  int64_t rows = 0, nnz = 0, ncols = 0;
  int flags = 0;
  int64_t seq = 0;
  int64_t cap_bound = 0;  // text-parse array capacity (elements); 0 = not
                          // poolable (exact-size csv/recordio arrays)
  std::shared_ptr<BlockPool> pool;  // origin pipeline's pool, while alive

  void FreeArrays() {
    std::free(labels);
    std::free(weights);
    std::free(values);
    std::free(qids);
    std::free(offsets);
    std::free(indices);
    std::free(fields);
    labels = weights = values = nullptr;
    qids = offsets = nullptr;
    indices = fields = nullptr;
    cap_bound = 0;
  }

  ~Block() { FreeArrays(); }
};

// Bounded free list of recycled Blocks, shared between the pipeline's
// workers and whoever frees blocks (native consumers or Python GC, any
// thread). Outlives its Pipeline via shared_ptr from in-flight blocks:
// after Close(), returns route to plain delete.
struct BlockPool {
  std::mutex mu;
  std::vector<Block*> free_list;
  size_t cap = 8;
  bool closed = false;

  Block* Acquire() {
    std::lock_guard<std::mutex> lk(mu);
    if (free_list.empty()) return nullptr;
    Block* b = free_list.back();
    free_list.pop_back();
    return b;
  }

  // true when pooled; false -> caller deletes
  bool Put(Block* b) {
    std::lock_guard<std::mutex> lk(mu);
    if (closed || free_list.size() >= cap) return false;
    free_list.push_back(b);
    return true;
  }

  void Close() {
    std::vector<Block*> drop;
    {
      std::lock_guard<std::mutex> lk(mu);
      closed = true;
      drop.swap(free_list);
    }
    for (Block* b : drop) delete b;
  }
};

// The one release path for every Block regardless of owner: recycle into
// the origin pool when the block is poolable and the pipeline is still
// alive, else free. Per-parse fields are reset here (arrays and
// cap_bound survive — they are the point).
void ReleaseBlock(Block* b) {
  if (b == nullptr) return;
  std::shared_ptr<BlockPool> pool;
  pool.swap(b->pool);
  if (pool != nullptr && b->cap_bound > 0) {
    b->rows = b->nnz = b->ncols = 0;
    b->flags = 0;
    b->seq = 0;
    if (pool->Put(b)) return;
  }
  delete b;
}

template <typename T>
T* AllocArray(int64_t n) {
  return static_cast<T*>(std::malloc(static_cast<size_t>(n) * sizeof(T) + 1));
}

// Sequential reader over the concatenated file list, restricted to a global
// byte range (the reference's InputSplitBase::Read loop spanning file
// boundaries, input_split_base.cc:177-209).
class RangeReader {
 public:
  RangeReader(const std::vector<std::string>& paths,
              const std::vector<int64_t>& sizes)
      : paths_(paths), sizes_(sizes) {
    offsets_.push_back(0);
    for (int64_t s : sizes_) offsets_.push_back(offsets_.back() + s);
  }

  ~RangeReader() { CloseFile(); }

  int64_t total() const { return offsets_.back(); }

  bool SeekGlobal(int64_t pos) {
    CloseFile();
    pos_ = pos;
    if (pos >= total()) return true;
    file_idx_ = FileIndexFor(pos);
    if (!OpenFile(file_idx_)) return false;
    int64_t local = pos - offsets_[file_idx_];
    if (local != 0 && std::fseek(file_, static_cast<long>(local), SEEK_SET)) {
      return false;
    }
    return true;
  }

  // Read up to n bytes at the current position; 0 at end of file list,
  // -1 on I/O error.
  int64_t Read(char* buf, int64_t n) {
    int64_t got = 0;
    while (got < n) {
      if (file_ == nullptr) {
        if (pos_ >= total()) break;
        file_idx_ = FileIndexFor(pos_);
        if (!OpenFile(file_idx_)) return -1;
      }
      // never read past this file's declared size: a file that grew after
      // listing must not shift the global offset<->file mapping
      int64_t want = std::min<int64_t>(n - got, offsets_[file_idx_ + 1] - pos_);
      if (want <= 0) {
        CloseFile();
        if (file_idx_ + 1 >= static_cast<int64_t>(paths_.size())) break;
        continue;
      }
      size_t r = std::fread(buf + got, 1, static_cast<size_t>(want), file_);
      if (r > 0) {
        got += static_cast<int64_t>(r);
        pos_ += static_cast<int64_t>(r);
        continue;
      }
      if (std::ferror(file_)) return -1;
      // end of this file: advance to the next one
      CloseFile();
      if (pos_ != offsets_[file_idx_ + 1]) return -1;  // size changed underfoot
      if (file_idx_ + 1 >= static_cast<int64_t>(paths_.size())) break;
    }
    return got;
  }

  int64_t pos() const { return pos_; }

 private:
  int64_t FileIndexFor(int64_t pos) const {
    int64_t lo = 0, hi = static_cast<int64_t>(sizes_.size()) - 1;
    while (lo < hi) {
      int64_t mid = (lo + hi + 1) / 2;
      if (offsets_[mid] <= pos) lo = mid;
      else hi = mid - 1;
    }
    return lo;
  }

  bool OpenFile(int64_t idx) {
    CloseFile();
    file_ = std::fopen(paths_[idx].c_str(), "rb");
    return file_ != nullptr;
  }

  void CloseFile() {
    if (file_ != nullptr) {
      std::fclose(file_);
      file_ = nullptr;
    }
  }

  const std::vector<std::string> paths_;
  const std::vector<int64_t> sizes_;
  std::vector<int64_t> offsets_;
  FILE* file_ = nullptr;
  int64_t file_idx_ = 0;
  int64_t pos_ = 0;
};

class Pipeline {
 public:
  Pipeline(std::vector<std::string> paths, std::vector<int64_t> sizes,
           int format, int part, int nparts, int nthread, int64_t chunk_bytes,
           int capacity, int64_t csv_expect_cols, bool push_mode = false,
           int64_t shuffle_seed = -1)
      : paths_(std::move(paths)),
        sizes_(std::move(sizes)),
        format_(format),
        part_(part),
        nparts_(nparts),
        nthread_(nthread < 1 ? 1 : nthread),
        chunk_bytes_(chunk_bytes < (1 << 16) ? (1 << 16) : chunk_bytes),
        out_capacity_(capacity < 2 ? 2 : capacity),
        csv_expect_cols_(csv_expect_cols),
        push_mode_(push_mode),
        shuffle_seed_(shuffle_seed) {
    TuneMallocOnce();
    pool_->cap = static_cast<size_t>(out_capacity_ + nthread_ + 4);
  }

  ~Pipeline() { Close(); }

  void Start() {
    if (!push_mode_) {
      reader_ = std::thread([this] {
        try {
          ReaderMain();
        } catch (const std::bad_alloc&) {
          Fail(kEOom);
        }
      });
    }
    for (int i = 0; i < nthread_; ++i) {
      workers_.emplace_back([this] { WorkerMain(); });
    }
  }

  // ---- push mode: the caller is the reader ----------------------------
  // Bytes arrive from Python-fetched remote chunks (parallel range-GET
  // readahead over gs://, s3://, hdfs://) instead of local fopen. The
  // caller must deliver the partition's byte range [begin, end) in order;
  // record-boundary cutting, parse fan-out and ordered delivery are the
  // same machinery the file reader uses. Blocks for backpressure when the
  // work queue is full (the ctypes call releases the GIL, so the Python
  // fetchers keep running). Returns 0, or the pipeline's error code.
  int Push(const char* data, int64_t len) {
    if (!push_mode_) return kEIo;
    int64_t off = 0;
    while (off < len) {
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (stop_) return kEIo;
        if (error_ != 0) return error_;
      }
      int64_t want = std::min<int64_t>(len - off, chunk_bytes_);
      if (!push_tail_.Reserve(push_tail_.size + want)) {
        Fail(kEOom);
        return kEOom;
      }
      std::memcpy(push_tail_.p + push_tail_.size, data + off,
                  static_cast<size_t>(want));
      push_tail_.size += want;
      off += want;
      if (push_tail_.size < chunk_bytes_) continue;
      int64_t cut = LastRecordBegin(push_tail_);
      if (cut == 0) continue;  // no boundary yet: keep accumulating
      if (!EmitPushChunk(cut)) return kEIo;
    }
    return 0;
  }

  // Zero-copy variant of Push: the caller writes into the pipeline's own
  // tail buffer (HTTP readinto lands remote bytes directly in native
  // memory) and commits. The returned pointer is valid only until the
  // next Reserve/Commit/Push call. NULL on OOM or a failed pipeline.
  char* PushReserve(int64_t want) {
    if (!push_mode_ || want < 0) return nullptr;
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (stop_ || error_ != 0) return nullptr;
    }
    if (!push_tail_.Reserve(push_tail_.size + want)) {
      Fail(kEOom);
      return nullptr;
    }
    return push_tail_.p + push_tail_.size;
  }

  // Append n caller-written bytes to the tail and emit any complete
  // chunks (same cut discipline as Push; blocks for backpressure).
  int PushCommit(int64_t n) {
    if (!push_mode_ || n < 0) return kEIo;
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (stop_) return kEIo;
      if (error_ != 0) return error_;
    }
    push_tail_.size += n;
    while (push_tail_.size >= chunk_bytes_) {
      int64_t cut = LastRecordBegin(push_tail_);
      if (cut == 0) break;  // no boundary yet: keep accumulating
      if (!EmitPushChunk(cut)) return kEIo;
    }
    return 0;
  }

  // The pipeline's current error code (0 = healthy) — lets the push
  // loop report the REAL failure (e.g. a worker's kEParse) instead of
  // guessing from a null reserve.
  int LastError() {
    std::lock_guard<std::mutex> lk(mu_);
    return error_;
  }

  bool IsPushMode() const { return push_mode_; }

  // Flush the remaining tail (the caller guarantees the pushed range ends
  // at a record boundary, so the tail is whole records) and close the
  // stream. Idempotent. Returns 0, or the pipeline's error code.
  int PushEof() {
    if (!push_mode_) return kEIo;
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (reader_done_) return error_;
      if (error_ != 0) return error_;
    }
    if (push_tail_.size > 0 && !EmitPushChunk(push_tail_.size)) return kEIo;
    FinishReader(push_seq_);
    return 0;
  }

  // The Python feeder hit an unrecoverable fetch error: fail the pipeline
  // so blocked consumers wake with an error instead of hanging.
  void PushAbort() { Fail(kEIo); }

  // Wait for the next in-order block without consuming it.
  // 1 = block staged (sizes via *out), 0 = end of stream, <0 = error.
  int Peek(Block** out) {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      if (error_ != 0) return error_;
      if (current_ != nullptr) {
        *out = current_;
        return 1;
      }
      auto it = done_.find(next_seq_out_);
      if (it != done_.end()) {
        current_ = it->second;
        done_.erase(it);
        ++next_seq_out_;
        cv_out_space_.notify_all();
        *out = current_;
        return 1;
      }
      if (reader_done_ && next_seq_out_ >= total_chunks_) return 0;
      int64_t t0 = NowNs();
      cv_out_.wait(lk);
      consumer_wait_ns_.fetch_add(NowNs() - t0);
    }
  }

  // Consume the staged block, copying into caller-owned buffers (any may be
  // null to skip). Returns 1, or 0 when nothing is staged.
  int Fetch(float* labels, float* weights, int64_t* qids, int64_t* offsets,
            uint32_t* indices, float* values, uint32_t* fields) {
    Block* b;
    {
      std::lock_guard<std::mutex> lk(mu_);
      b = current_;
      if (b == nullptr) return 0;
      current_ = nullptr;
    }
    size_t n = static_cast<size_t>(b->rows);
    size_t z = static_cast<size_t>(b->nnz);
    if (labels != nullptr) std::memcpy(labels, b->labels, n * 4);
    if (weights != nullptr) std::memcpy(weights, b->weights, n * 4);
    if (qids != nullptr) std::memcpy(qids, b->qids, n * 8);
    if (offsets != nullptr) std::memcpy(offsets, b->offsets, (n + 1) * 8);
    if (indices != nullptr) std::memcpy(indices, b->indices, z * 4);
    if (values != nullptr) std::memcpy(values, b->values, z * 4);
    if (fields != nullptr) std::memcpy(fields, b->fields, z * 4);
    ReleaseBlock(b);
    return 1;
  }

  // Consume the staged block, transferring ownership to the caller
  // (zero-copy handoff; the caller frees it via ingest_block_free).
  Block* FetchOwn() {
    std::lock_guard<std::mutex> lk(mu_);
    Block* b = current_;
    current_ = nullptr;
    return b;
  }

  // ---- consumer-side batch staging ------------------------------------
  // Fixed-shape re-batching in native code: the TPU feed consumes
  // [batch_size]-row batches with static shapes (device/csr.py's contract),
  // and doing the re-slice + densify in Python costs more than the parse
  // itself (BASELINE.md: 850 MB/s parse vs 244 MB/s feed). Staging pulls
  // parsed blocks in order and batch-fetch fills caller-owned buffers
  // (dense [batch, F] scatter or padded COO) directly from the CSR arrays —
  // the zero-copy handoff discipline of the reference's RowBlock
  // (src/data/row_block.h:169-188) extended through densify.
  //
  // Single-consumer API like Peek/Fetch: stage, then fetch consumes.

  // Stage >= batch_size rows (or all remaining). Returns 1 with
  // *rows/*nnz describing the next batch (rows = min(batch_size, staged)),
  // 0 at end of stream (no rows left), <0 on pipeline error.
  int StageBatch(int64_t batch_size, int64_t* out_rows, int64_t* out_nnz) {
    if (format_ == kCsv) return kEIo;  // csv blocks carry no CSR arrays
    while (staged_rows_ < batch_size) {
      Block* b = nullptr;
      int rc = Peek(&b);
      if (rc < 0) return rc;
      if (rc == 0) break;  // end of stream
      {
        std::lock_guard<std::mutex> lk(mu_);
        current_ = nullptr;  // take ownership
      }
      if (b->rows == 0) {
        ReleaseBlock(b);
        continue;
      }
      staged_.push_back(Span{b, 0});
      staged_rows_ += b->rows;
    }
    int64_t rows = std::min<int64_t>(batch_size, staged_rows_);
    *out_rows = rows;
    *out_nnz = NnzOfFirst(rows);
    return rows > 0 ? 1 : 0;
  }

  // Fill a dense [batch_size, num_features] f32 batch (plus labels/weights)
  // from the staged rows, consuming min(batch_size, staged) rows. Rows past
  // the valid count are zero (weight 0 ⇒ no-op in weighted losses). Feature
  // ids >= num_features are dropped, matching device/csr.py block_to_dense.
  // Returns rows consumed, or <0 (kEIo when the format has no CSR arrays).
  int64_t FetchBatchDense(float* x, float* labels, float* weights,
                          int64_t batch_size, int64_t num_features) {
    if (format_ == kCsv) return kEIo;
    // x is zeroed per-row (the dense-regular fast path writes only the
    // row's uncovered edges — a full upfront memset was ~40% of the
    // densify's memory traffic); padding rows are zeroed after the loop
    std::memset(labels, 0, static_cast<size_t>(batch_size) * 4);
    std::memset(weights, 0, static_cast<size_t>(batch_size) * 4);
    int64_t out_row = 0;
    while (out_row < batch_size && !staged_.empty()) {
      Span& sp = staged_.front();
      Block* b = sp.block;
      bool has_w = (b->flags & kHasWeight) != 0;
      bool has_v = format_ == kLibfm || (b->flags & kHasValue) != 0;
      const uint32_t* idx = b->indices;
      int64_t take = std::min<int64_t>(batch_size - out_row, b->rows - sp.row);
      for (int64_t i = 0; i < take; ++i) {
        int64_t r = sp.row + i;
        labels[out_row] = b->labels[r];
        weights[out_row] = has_w ? b->weights[r] : 1.0f;
        float* xrow = x + out_row * num_features;
        int64_t lo = b->offsets[r], hi = b->offsets[r + 1];
        // dense-regular fast path: a row whose indices are the
        // consecutive run [base, base+n) (the HIGGS/dense-table shape,
        // and every row-group written from dense data) densifies as ONE
        // memcpy instead of 28+ dependent scattered stores — the
        // densify was the dominant ingest->SGD stage (~60% of
        // host_batch time on the recordio bench). Cost: dense rows pay
        // one sequential O(n) compare scan (cheap next to the scatter it
        // replaces); sparse/irregular rows reject on the single
        // last-element compare below.
        int64_t n = hi - lo;
        if (has_v && n > 0 && static_cast<int64_t>(idx[lo]) + n <=
                                  num_features) {
          uint32_t base = idx[lo];
          // direct run check, cheapest-reject first (last element, then
          // the full scan with early exit) — no cached state, so sparse
          // rows with varying bases pay at most one compare
          bool regular = idx[hi - 1] == base + static_cast<uint32_t>(n - 1);
          for (int64_t k = 1; regular && k < n - 1; ++k) {
            regular = idx[lo + k] == base + static_cast<uint32_t>(k);
          }
          if (regular) {
            if (base > 0) std::memset(xrow, 0, static_cast<size_t>(base) * 4);
            std::memcpy(xrow + base, b->values + lo,
                        static_cast<size_t>(n) * 4);
            int64_t rest = num_features - base - n;
            if (rest > 0) {
              std::memset(xrow + base + n, 0,
                          static_cast<size_t>(rest) * 4);
            }
            ++out_row;
            continue;
          }
        }
        std::memset(xrow, 0, static_cast<size_t>(num_features) * 4);
        for (int64_t k = lo; k < hi; ++k) {
          uint32_t j = idx[k];
          if (j < static_cast<uint64_t>(num_features)) {
            xrow[j] = has_v ? b->values[k] : 1.0f;
          }
        }
        ++out_row;
      }
      ConsumeSpan(take);
    }
    if (out_row < batch_size) {  // zero-pad the short final batch
      std::memset(x + out_row * num_features, 0,
                  static_cast<size_t>((batch_size - out_row) *
                                      num_features) * 4);
    }
    return out_row;
  }

  // Fill a padded COO batch (labels/weights [batch_size]; indices/values/
  // row_ids [nnz_bucket]; offsets [batch_size + 1] CSR) from the staged
  // rows, consuming them. Padded entries are (row 0, feature 0, value 0) —
  // arithmetic no-ops for segment-sum SpMV; padded rows' offsets repeat the
  // valid nnz. The feed ships the small offsets array instead of the
  // per-entry row_ids (H2D ∝ rows, not nnz) and expands row ids on device;
  // row_ids stays filled for host-side consumers. Fails with kEOverflow
  // (consuming nothing) when the batch's nnz exceeds nnz_bucket. Returns
  // rows consumed, or <0.
  int64_t FetchBatchCoo(float* labels, float* weights, int32_t* indices,
                        float* values, int32_t* row_ids, int32_t* offsets,
                        int64_t batch_size, int64_t nnz_bucket) {
    if (format_ == kCsv) return kEIo;
    int64_t rows = std::min<int64_t>(batch_size, staged_rows_);
    if (NnzOfFirst(rows) > nnz_bucket) return kEOverflow;
    std::memset(labels, 0, static_cast<size_t>(batch_size) * 4);
    std::memset(weights, 0, static_cast<size_t>(batch_size) * 4);
    int64_t out_row = 0, out_k = 0;
    offsets[0] = 0;
    while (out_row < batch_size && !staged_.empty()) {
      Span& sp = staged_.front();
      Block* b = sp.block;
      bool has_w = (b->flags & kHasWeight) != 0;
      bool has_v = format_ == kLibfm || (b->flags & kHasValue) != 0;
      const uint32_t* idx = b->indices;
      int64_t take = std::min<int64_t>(batch_size - out_row, b->rows - sp.row);
      for (int64_t i = 0; i < take; ++i) {
        int64_t r = sp.row + i;
        labels[out_row] = b->labels[r];
        weights[out_row] = has_w ? b->weights[r] : 1.0f;
        for (int64_t k = b->offsets[r]; k < b->offsets[r + 1]; ++k) {
          indices[out_k] = static_cast<int32_t>(idx[k]);
          values[out_k] = has_v ? b->values[k] : 1.0f;
          row_ids[out_k] = static_cast<int32_t>(out_row);
          ++out_k;
        }
        ++out_row;
        offsets[out_row] = static_cast<int32_t>(out_k);
      }
      ConsumeSpan(take);
    }
    for (int64_t r = out_row + 1; r <= batch_size; ++r) {
      offsets[r] = static_cast<int32_t>(out_k);
    }
    for (int64_t k = out_k; k < nnz_bucket; ++k) {
      indices[k] = 0;
      values[k] = 0.0f;
      row_ids[k] = 0;
    }
    return out_row;
  }

  // Max per-shard nnz of the staged batch when its rows are split into
  // num_shards contiguous row ranges (the mesh dp sharding): the caller
  // sizes the shared per-shard bucket from this.
  int64_t StagedMaxShardNnz(int64_t batch_size, int64_t num_shards) const {
    if (num_shards <= 0 || batch_size % num_shards != 0) return -1;
    int64_t rows_per_shard = batch_size / num_shards;
    int64_t max_nnz = 0, cur = 0;
    int64_t row = 0, left = std::min<int64_t>(batch_size, staged_rows_);
    for (const Span& sp : staged_) {
      if (left <= 0) break;
      int64_t take = std::min<int64_t>(left, sp.block->rows - sp.row);
      for (int64_t i = 0; i < take; ++i) {
        int64_t r = sp.row + i;
        cur += sp.block->offsets[r + 1] - sp.block->offsets[r];
        if ((row + 1) % rows_per_shard == 0) {
          max_nnz = std::max(max_nnz, cur);
          cur = 0;
        }
        ++row;
      }
      left -= take;
    }
    return std::max(max_nnz, cur);
  }

  // Sharded COO fill: entries are partitioned by destination shard (row
  // range r/rows_per_shard) into per-shard sections of the flat
  // [num_shards * nnz_bucket] arrays, with LOCAL row ids — each device
  // receives only its own entries when the leading dim is sharded
  // (in_specs P(axis)), so per-device H2D is ∝ global_nnz / world instead
  // of replicating every entry to every shard. Padding entries are
  // (local row 0, feature 0, value 0) no-ops. Fails with kEOverflow
  // (consuming nothing) when any shard's nnz exceeds nnz_bucket.
  int64_t FetchBatchCooSharded(float* labels, float* weights,
                               int32_t* indices, float* values,
                               int32_t* row_ids, int32_t* offsets,
                               int64_t batch_size, int64_t num_shards,
                               int64_t nnz_bucket) {
    if (format_ == kCsv) return kEIo;
    if (num_shards <= 0 || batch_size % num_shards != 0) return kEIo;
    if (StagedMaxShardNnz(batch_size, num_shards) > nnz_bucket) {
      return kEOverflow;
    }
    int64_t rows_per_shard = batch_size / num_shards;
    // offsets: flat [num_shards * (rows_per_shard + 1)] — per-shard LOCAL
    // CSR offsets into that shard's entry section; the feed ships these
    // instead of per-entry row_ids and expands on device.
    std::memset(offsets, 0,
                static_cast<size_t>(num_shards * (rows_per_shard + 1)) * 4);
    std::vector<int64_t> filled(static_cast<size_t>(num_shards), 0);
    int64_t out_row = 0;
    int64_t cur = 0;  // entry cursor within the current shard's section
    while (out_row < batch_size && !staged_.empty()) {
      Span& sp = staged_.front();
      Block* b = sp.block;
      bool has_w = (b->flags & kHasWeight) != 0;
      bool has_v = format_ == kLibfm || (b->flags & kHasValue) != 0;
      const uint32_t* idx = b->indices;
      int64_t take = std::min<int64_t>(batch_size - out_row, b->rows - sp.row);
      for (int64_t i = 0; i < take; ++i) {
        int64_t r = sp.row + i;
        labels[out_row] = b->labels[r];
        weights[out_row] = has_w ? b->weights[r] : 1.0f;
        int64_t shard = out_row / rows_per_shard;
        int64_t local_row = out_row - shard * rows_per_shard;
        int64_t base = shard * nnz_bucket;
        for (int64_t k = b->offsets[r]; k < b->offsets[r + 1]; ++k) {
          indices[base + cur] = static_cast<int32_t>(idx[k]);
          values[base + cur] = has_v ? b->values[k] : 1.0f;
          row_ids[base + cur] = static_cast<int32_t>(local_row);
          ++cur;
        }
        ++out_row;
        offsets[shard * (rows_per_shard + 1) + local_row + 1] =
            static_cast<int32_t>(cur);
        if (out_row % rows_per_shard == 0) {
          filled[static_cast<size_t>(shard)] = cur;
          cur = 0;  // next shard section
        }
      }
      ConsumeSpan(take);
    }
    if (out_row > 0 && out_row % rows_per_shard != 0) {
      filled[static_cast<size_t>(out_row / rows_per_shard)] = cur;
    }
    // forward-fill each shard's offset tail (rows past the stream's end
    // repeat the shard's final nnz; untouched shards stay all-zero)
    for (int64_t s = 0; s < num_shards; ++s) {
      int32_t* off = offsets + s * (rows_per_shard + 1);
      int32_t run = 0;
      for (int64_t r = 1; r <= rows_per_shard; ++r) {
        run = std::max(run, off[r]);
        off[r] = run;
      }
    }
    // zero only the padding: row tail + each shard section's unfilled tail
    // (a full up-front memset would write most of the hot-path bytes twice)
    std::memset(labels + out_row, 0,
                static_cast<size_t>(batch_size - out_row) * 4);
    std::memset(weights + out_row, 0,
                static_cast<size_t>(batch_size - out_row) * 4);
    for (int64_t s = 0; s < num_shards; ++s) {
      int64_t base = s * nnz_bucket + filled[static_cast<size_t>(s)];
      size_t pad = static_cast<size_t>(
          nnz_bucket - filled[static_cast<size_t>(s)]);
      std::memset(indices + base, 0, pad * 4);
      std::memset(values + base, 0, pad * 4);
      std::memset(row_ids + base, 0, pad * 4);
    }
    return out_row;
  }

  // Per-stage counters for bench/diagnosis (SURVEY §5.1): where does wall
  // time go between reading, parsing and the consumer?
  void Stats(double* out, int32_t n) const {
    double vals[7] = {
        static_cast<double>(bytes_read_.load()),
        static_cast<double>(chunk_count_.load()),
        static_cast<double>(reader_io_ns_.load()),
        static_cast<double>(reader_wait_ns_.load()),
        static_cast<double>(parse_ns_.load()),
        static_cast<double>(worker_wait_ns_.load()),
        static_cast<double>(consumer_wait_ns_.load()),
    };
    for (int32_t i = 0; i < n && i < 7; ++i) out[i] = vals[i];
  }

  int64_t BytesRead() const { return bytes_read_.load(); }

  void Close() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (stop_) return;
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_work_space_.notify_all();
    cv_out_.notify_all();
    cv_out_space_.notify_all();
    if (reader_.joinable()) reader_.join();
    for (auto& w : workers_)
      if (w.joinable()) w.join();
    for (auto& kv : done_) delete kv.second;
    done_.clear();
    for (Chunk* c : work_) delete c;
    work_.clear();
    for (Chunk* c : free_chunks_) delete c;
    free_chunks_.clear();
    if (current_ != nullptr) {
      delete current_;
      current_ = nullptr;
    }
    for (Span& sp : staged_) delete sp.block;
    staged_.clear();
    staged_rows_ = 0;
    // after this, blocks still owned by consumers (Python views) free
    // directly on release instead of returning here
    pool_->Close();
    // all chunk views are dead (reader + workers joined, queues cleared)
    if (map_base_ != nullptr) {
      ::munmap(map_base_, map_len_);
      map_base_ = nullptr;
      map_len_ = 0;
    }
  }

 private:
  // ---- batch staging state (single consumer thread only) --------------
  struct Span {
    Block* block;
    int64_t row;  // first unconsumed row
  };

  // nnz covered by the first `rows` staged rows
  int64_t NnzOfFirst(int64_t rows) const {
    int64_t nnz = 0;
    for (const Span& sp : staged_) {
      if (rows <= 0) break;
      int64_t take = std::min<int64_t>(rows, sp.block->rows - sp.row);
      nnz += sp.block->offsets[sp.row + take] - sp.block->offsets[sp.row];
      rows -= take;
    }
    return nnz;
  }

  // advance the front span by `rows`, retiring it when exhausted
  void ConsumeSpan(int64_t rows) {
    Span& sp = staged_.front();
    sp.row += rows;
    staged_rows_ -= rows;
    if (sp.row >= sp.block->rows) {
      ReleaseBlock(sp.block);
      staged_.pop_front();
    }
  }

  // Move the first `cut` bytes of push_tail_ into a work chunk; the
  // remainder becomes the new tail. False when the pipeline stopped.
  bool EmitPushChunk(int64_t cut) {
    Chunk* chunk = AcquireChunk();
    if (chunk == nullptr) return false;
    chunk->data.Swap(push_tail_);
    int64_t rest = chunk->data.size - cut;
    push_tail_.size = 0;
    if (rest > 0) {
      if (!push_tail_.Reserve(rest)) {
        delete chunk;
        Fail(kEOom);
        return false;
      }
      std::memcpy(push_tail_.p, chunk->data.p + cut,
                  static_cast<size_t>(rest));
      push_tail_.size = rest;
    }
    chunk->data.size = cut;
    if (cut == 0) {
      ReleaseChunk(chunk);
      return true;
    }
    chunk->seq = push_seq_++;
    return PushWork(chunk);
  }

  // ---- reader side ----------------------------------------------------
  // adj(x): first record-begin at global offset >= x (0 stays 0). Text
  // formats scan to the first EOL char then consume the whole EOL run, the
  // LineSplitter SeekRecordBegin contract (line_split.cc:9-26); recordio
  // scans aligned words for a head frame (recordio_split.cc:9-25 — exact,
  // not heuristic: packing elides aligned embedded magics, so an aligned
  // magic word can only be a frame head, and cflag 0/1 selects record
  // starts over continuations).
  int64_t AdjustBoundary(RangeReader* rd, int64_t x) {
    if (format_ == kRecordIO) return AdjustBoundaryRecordIO(rd, x);
    if (x <= 0) return 0;
    if (x >= rd->total()) return rd->total();
    if (!rd->SeekGlobal(x)) return -1;
    char buf[4096];
    bool seen_eol = false;
    int64_t pos = x;
    for (;;) {
      int64_t n = rd->Read(buf, sizeof(buf));
      if (n < 0) return -1;
      if (n == 0) return pos;
      for (int64_t i = 0; i < n; ++i) {
        if (is_eol(buf[i])) {
          seen_eol = true;
        } else if (seen_eol) {
          return pos + i;
        }
      }
      pos += n;
    }
  }

  int64_t AdjustBoundaryRecordIO(RangeReader* rd, int64_t x) {
    if (x <= 0) return 0;
    int64_t total = rd->total();
    if (x >= total) return total;
    int64_t base = (x + 3) & ~int64_t(3);  // heads sit on 4B alignment
    if (!rd->SeekGlobal(base)) return -1;
    char buf[4096 + 8];
    int64_t avail = 0;
    for (;;) {
      int64_t n = rd->Read(buf + avail, 4096);
      if (n < 0) return -1;
      avail += n;
      int64_t hit = recordio_find_head(buf, avail, 0);
      if (hit >= 0) return base + hit;
      if (n == 0) return total;  // no head before EOF
      // keep the unscanned aligned tail (< 8 bytes) for the next round
      int64_t processed = std::max<int64_t>(0, (avail - 4) & ~int64_t(3));
      std::memmove(buf, buf + processed, avail - processed);
      base += processed;
      avail -= processed;
    }
  }

  void ReaderMain() {
    RangeReader rd(paths_, sizes_);
    int64_t total = rd.total();
    // ceil-div step, matching input_split_base.cc:30-40; recordio rounds
    // the step to 4B alignment like the Python splitter (input_split.py
    // reset_partition) so both stacks assign boundary records to the SAME
    // part — a mixed native/fallback job must still tile exactly-once
    int64_t align = (format_ == kRecordIO) ? 4 : 1;
    int64_t nstep = (total + nparts_ - 1) / nparts_;
    nstep = (nstep + align - 1) / align * align;
    int64_t raw_begin = std::min<int64_t>(nstep * part_, total);
    int64_t raw_end = std::min<int64_t>(nstep * (part_ + 1), total);
    if (raw_begin >= raw_end) {
      FinishReader(0);
      return;
    }
    int64_t begin = AdjustBoundary(&rd, raw_begin);
    int64_t end = AdjustBoundary(&rd, raw_end);
    if (begin < 0 || end < 0) {
      Fail(kEIo);
      return;
    }
    if (begin >= end) {  // legitimately empty part (no record begins in
      FinishReader(0);   // its byte window) — zero rows, not an error
      return;
    }
    if (TryMmapReader(begin, end)) return;
    if (shuffle_seed_ >= 0) {
      // the caller asked for shuffled visit order and the zero-copy
      // reader declined (multi-file span, mmap failure): silent
      // sequential epochs would be a correctness lie for SGD
      Fail(kEIo);
      return;
    }
    if (!rd.SeekGlobal(begin)) {
      Fail(kEIo);
      return;
    }
    int64_t seq = 0;
    Buf tail;
    while (rd.pos() < end || tail.size > 0) {
      Chunk* chunk = AcquireChunk();
      if (chunk == nullptr) {  // stopped
        FinishReader(seq);
        return;
      }
      chunk->data.Swap(tail);
      tail.size = 0;
      int64_t target = chunk_bytes_;
      bool final_chunk = false;
      for (;;) {
        int64_t want = std::min<int64_t>(target - chunk->data.size,
                                         end - rd.pos());
        if (want > 0) {
          int64_t base = chunk->data.size;
          if (!chunk->data.Reserve(base + want)) {
            delete chunk;
            Fail(kEOom);
            return;
          }
          int64_t tr = NowNs();
          int64_t got = rd.Read(chunk->data.p + base, want);
          reader_io_ns_.fetch_add(NowNs() - tr);
          if (got < 0) {
            delete chunk;
            Fail(kEIo);
            return;
          }
          chunk->data.size = base + got;
          if (got < want) {
            // file list exhausted early (sizes changed): treat as final
            final_chunk = true;
            break;
          }
        }
        if (rd.pos() >= end) {
          final_chunk = true;
          break;
        }
        // cut at the last record begin inside the buffer
        int64_t cut = LastRecordBegin(chunk->data);
        if (cut > 0) {
          int64_t rest = chunk->data.size - cut;
          if (rest > 0) {
            if (!tail.Reserve(rest)) {
              delete chunk;
              Fail(kEOom);
              return;
            }
            std::memcpy(tail.p, chunk->data.p + cut,
                        static_cast<size_t>(rest));
          }
          tail.size = rest;
          chunk->data.size = cut;
          break;
        }
        // no boundary inside: grow and keep reading (Chunk::Load doubling,
        // input_split_base.cc:241-258)
        target *= 2;
      }
      if (chunk->data.size == 0) {
        ReleaseChunk(chunk);
        if (final_chunk) break;
        continue;
      }
      chunk->seq = seq++;
      if (!PushWork(chunk)) {
        FinishReader(seq);
        return;
      }
      if (final_chunk) break;
    }
    FinishReader(seq);
  }

  // Offset of the last record begin at index >= 1, or 0 when none. Text:
  // just past the last EOL char (line_split.cc FindLastRecordBegin).
  // RecordIO: the last aligned head frame (the chunk starts at a head, so
  // in-buffer heads stay 4B-aligned; see AdjustBoundary notes).
  int64_t LastRecordBegin(const char* p, int64_t size) const {
    if (format_ == kRecordIO) {
      for (int64_t i = (size - 8) & ~int64_t(3); i >= 4; i -= 4) {
        uint32_t w;
        std::memcpy(&w, p + i, 4);
        if (w != kRioMagic) continue;
        uint32_t lrec;
        std::memcpy(&lrec, p + i + 4, 4);
        uint32_t cflag = lrec >> 29;
        if (cflag == 0 || cflag == 1) return i;
      }
      return 0;
    }
    for (int64_t i = size - 1; i >= 1; --i) {
      if (is_eol(p[i])) return i + 1;
    }
    return 0;
  }

  int64_t LastRecordBegin(const Buf& buf) const {
    return LastRecordBegin(buf.p, buf.size);
  }

  // Zero-copy reader: serve the partition's chunks as borrowed views into
  // one mmap of the file instead of fread-ing into owned buffers. On a
  // host where reader and workers share cores (every TPU-host ingest is
  // CPU-bound on parse), the fread memcpy is pure serial overhead —
  // ~10-15% of wall on the criteo shape. Engages only when the whole
  // byte range lies inside ONE file (a record spanning two files needs
  // the copying reader's stitch loop); the mapping outlives in-flight
  // chunks (munmap in Close after joins). A concurrently truncated file
  // faults here where the fread path would misread it; neither is a
  // supported use.
  // Returns true when it served the range (or was stopped mid-way);
  // false -> caller runs the fread loop.
  bool TryMmapReader(int64_t begin, int64_t end) {
    int file_idx = -1;
    int64_t file_base = 0, acc = 0;
    for (size_t i = 0; i < sizes_.size(); ++i) {
      if (begin >= acc && end <= acc + sizes_[i]) {
        file_idx = static_cast<int>(i);
        file_base = acc;
        break;
      }
      acc += sizes_[i];
    }
    if (file_idx < 0 || sizes_[file_idx] <= 0) return false;
    int64_t tr = NowNs();
    int fd = ::open(paths_[file_idx].c_str(), O_RDONLY);
    if (fd < 0) return false;
    size_t mlen = static_cast<size_t>(sizes_[file_idx]);
    void* base = ::mmap(nullptr, mlen, PROT_READ, MAP_PRIVATE, fd, 0);
    ::close(fd);
    if (base == MAP_FAILED) return false;
    ::madvise(base, mlen, MADV_SEQUENTIAL);
    map_base_ = base;
    map_len_ = mlen;
    reader_io_ns_.fetch_add(NowNs() - tr);
    const char* p = static_cast<const char*>(base);
    int64_t pos = begin - file_base;
    const int64_t le = end - file_base;
    int64_t seq = 0;
    if (shuffle_seed_ < 0) {
      // sequential: emit each chunk the moment its cut is known — the
      // boundary probe's page faults overlap parse work, and a stop
      // (AcquireChunk returning null) ends the scan promptly
      while (pos < le) {
        int64_t cut = NextCut(p, pos, le);
        if (cut > pos) {
          Chunk* chunk = AcquireChunk();
          if (chunk == nullptr) {  // stopped
            FinishReader(seq);
            return true;
          }
          chunk->ext = p + pos;
          chunk->ext_len = cut - pos;
          chunk->seq = seq++;
          if (!PushWork(chunk)) {
            FinishReader(seq);
            return true;
          }
        }
        pos = cut;
      }
      FinishReader(seq);
      return true;
    }
    // shuffle: phase 1 computes every chunk's [pos, cut) up front
    // (boundaries are data-deterministic, so a given (file, chunk_bytes)
    // always yields the same segment list), checking the stop flag so
    // ingest_close never blocks on a whole-part scan; phase 2 is a
    // seeded Fisher-Yates over mt19937_64 — the reference's
    // input_split_shuffle.h semantic (sub-splits visited in seeded
    // random order per epoch) at chunk granularity. std::shuffle is
    // implementation-defined; a shuffled EPOCH must be reproducible
    // from its seed alone. Random-access emission is only possible
    // here — the streaming reader cannot reorder without deadlocking
    // its bounded queues (ingest_open_ex refuses such requests).
    std::vector<std::pair<int64_t, int64_t>> segments;
    while (pos < le) {
      bool stopped;
      {
        std::lock_guard<std::mutex> lk(mu_);
        stopped = stop_ || error_ != 0;
      }
      // FinishReader takes mu_ itself: called under the guard it would
      // deadlock the reader, and ingest_close joining it with it
      if (stopped) {
        FinishReader(0);
        return true;
      }
      int64_t cut = NextCut(p, pos, le);
      if (cut > pos) segments.emplace_back(pos, cut);
      pos = cut;
    }
    if (segments.size() > 1) {
      std::mt19937_64 rng(static_cast<uint64_t>(shuffle_seed_));
      for (size_t i = segments.size() - 1; i > 0; --i) {
        size_t j = static_cast<size_t>(rng() % (i + 1));
        std::swap(segments[i], segments[j]);
      }
    }
    for (const auto& seg : segments) {
      Chunk* chunk = AcquireChunk();
      if (chunk == nullptr) {  // stopped
        FinishReader(seq);
        return true;
      }
      chunk->ext = p + seg.first;
      chunk->ext_len = seg.second - seg.first;
      chunk->seq = seq++;
      if (!PushWork(chunk)) {
        FinishReader(seq);
        return true;
      }
    }
    FinishReader(seq);
    return true;
  }

  // Next chunk cut in [pos, le): same discipline as the fread loop — last
  // record begin inside the window, doubling when a record outgrows it.
  int64_t NextCut(const char* p, int64_t pos, int64_t le) const {
    int64_t window = chunk_bytes_;
    for (;;) {
      int64_t target = std::min<int64_t>(pos + window, le);
      if (target >= le) return le;
      int64_t c = LastRecordBegin(p + pos, target - pos);
      if (c > 0) return pos + c;
      window *= 2;
    }
  }

  Chunk* AcquireChunk() {
    std::unique_lock<std::mutex> lk(mu_);
    // error_ must wake a backpressure-blocked producer (the push-mode
    // feeder especially: workers that exited on error stop draining work_,
    // and PushAbort/Fail would otherwise never unblock it)
    int64_t t0 = NowNs();
    cv_work_space_.wait(lk, [this] {
      return stop_ || error_ != 0 ||
             static_cast<int>(work_.size()) < nthread_ * 2;
    });
    reader_wait_ns_.fetch_add(NowNs() - t0);
    if (stop_ || error_ != 0) return nullptr;
    if (!free_chunks_.empty()) {
      Chunk* c = free_chunks_.back();
      free_chunks_.pop_back();
      c->data.size = 0;
      c->ext = nullptr;
      c->ext_len = 0;
      return c;
    }
    return new Chunk();
  }

  void ReleaseChunk(Chunk* c) {
    std::lock_guard<std::mutex> lk(mu_);
    free_chunks_.push_back(c);
  }

  bool PushWork(Chunk* chunk) {
    std::unique_lock<std::mutex> lk(mu_);
    if (stop_) {
      delete chunk;
      return false;
    }
    work_.push_back(chunk);
    cv_work_.notify_one();
    return true;
  }

  void FinishReader(int64_t nchunks) {
    std::lock_guard<std::mutex> lk(mu_);
    total_chunks_ = nchunks;
    reader_done_ = true;
    cv_work_.notify_all();
    cv_out_.notify_all();
  }

  void Fail(int code) {
    std::lock_guard<std::mutex> lk(mu_);
    if (error_ == 0) error_ = code;
    reader_done_ = true;
    cv_work_.notify_all();
    cv_out_.notify_all();
    cv_out_space_.notify_all();
    cv_work_space_.notify_all();
  }

  // ---- worker side ----------------------------------------------------
  void WorkerMain() {
    for (;;) {
      Chunk* chunk = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu_);
        int64_t t0 = NowNs();
        cv_work_.wait(lk, [this] {
          return stop_ || error_ != 0 || !work_.empty() || reader_done_;
        });
        worker_wait_ns_.fetch_add(NowNs() - t0);
        if (stop_ || error_ != 0) return;
        if (work_.empty()) {
          if (reader_done_) return;
          continue;
        }
        chunk = work_.front();
        work_.pop_front();
        cv_work_space_.notify_one();
      }
      Block* block = nullptr;
      int rc;
      int64_t t0 = NowNs();
      try {
        block = pool_->Acquire();
        if (block == nullptr) block = new Block();
        block->pool = pool_;
        block->seq = chunk->seq;
        rc = ParseChunk(chunk->ptr(), chunk->len(), block);
      } catch (const std::bad_alloc&) {
        rc = kEOom;
      }
      parse_ns_.fetch_add(NowNs() - t0);
      chunk_count_.fetch_add(1);
      bytes_read_.fetch_add(chunk->len());
      ReleaseChunk(chunk);
      if (rc != kOk) {
        ReleaseBlock(block);
        Fail(rc);
        return;
      }
      std::unique_lock<std::mutex> lk(mu_);
      // the block the consumer is waiting for bypasses the capacity bound
      // so ordered delivery can never deadlock; an error or stop releases
      // every waiter
      cv_out_space_.wait(lk, [this, block] {
        return stop_ || error_ != 0 ||
               static_cast<int>(done_.size()) < out_capacity_ ||
               block->seq == next_seq_out_;
      });
      if (stop_ || error_ != 0) {
        ReleaseBlock(block);
        return;
      }
      done_.emplace(block->seq, block);
      cv_out_.notify_all();
    }
  }

  int ParseChunk(const char* p, int64_t len, Block* b) {
    if (format_ == kCsv) return ParseCsvChunk(p, len, b);
    if (format_ == kRecordIO) return ParseRecordIOChunk(p, len, b);
    int64_t bound = len / 2 + 2;  // rows and nnz are both >= 2 bytes each
    if (b->cap_bound < bound) {
      // recycled arrays too small (or a fresh block): (re)allocate the
      // full set at this bound. Equal-size chunks make this a one-time
      // cost per pooled block — steady state re-parses into warm pages.
      b->FreeArrays();
      b->labels = AllocArray<float>(bound);
      b->offsets = AllocArray<int64_t>(bound + 1);
      // u32 storage, filled directly by the 32-bit parse variants (no
      // narrowing pass); Block::indices stays a u64* holder by type only
      b->indices = AllocArray<uint32_t>(bound);
      b->values = AllocArray<float>(bound);
      if (b->labels == nullptr || b->offsets == nullptr ||
          b->indices == nullptr || b->values == nullptr) {
        return kEOom;
      }
      if (format_ == kLibsvm) {
        b->weights = AllocArray<float>(bound);
        b->qids = AllocArray<int64_t>(bound);
        if (b->weights == nullptr || b->qids == nullptr) return kEOom;
      } else {
        b->fields = AllocArray<uint32_t>(bound);
        if (b->fields == nullptr) return kEOom;
      }
      b->cap_bound = bound;
    }
    int64_t rows = 0, nnz = 0;
    int rc;
    if (format_ == kLibsvm) {
      rc = parse_libsvm32(p, len, b->labels, b->weights, b->qids,
                          b->offsets + 1,
                          b->indices, b->values,
                          bound, bound, &rows, &nnz, &b->flags);
    } else {
      rc = parse_libfm32(p, len, b->labels, b->offsets + 1,
                         b->fields, b->indices, b->values,
                         bound, bound, &rows, &nnz);
    }
    if (rc != kOk) return rc;
    b->rows = rows;
    b->nnz = nnz;
    // counts -> offsets prefix sum in place
    b->offsets[0] = 0;
    for (int64_t i = 1; i <= rows; ++i) b->offsets[i] += b->offsets[i - 1];
    return kOk;
  }

  int ParseCsvChunk(const char* p, int64_t len, Block* b) {
    int64_t max_rows = 2;
    for (const char* q = p; (q = static_cast<const char*>(std::memchr(
                                 q, '\n', static_cast<size_t>(p + len - q)))) !=
                            nullptr;
         ++q)
      ++max_rows;
    int64_t cols = csv_expect_cols_;
    if (cols <= 0) {
      // infer from the first line of this chunk
      cols = 1;
      for (int64_t i = 0; i < len && !is_eol(p[i]); ++i)
        if (p[i] == ',') ++cols;
    }
    b->values = AllocArray<float>(max_rows * cols);
    if (b->values == nullptr) return kEOom;
    int64_t rows = 0, out_cols = 0;
    int rc = parse_csv(p, len, b->values, max_rows, cols, &rows, &out_cols);
    if (rc != kOk) return rc;
    b->rows = rows;
    b->ncols = out_cols;
    b->nnz = rows * out_cols;
    return kOk;
  }

  // Decode a chunk of RecordIO-framed row groups into one CSR block: strip
  // the framing (recordio_unpack), then memcpy the typed sections — no text
  // scanning anywhere. Chunks are cut at record heads, so the frame stream
  // must decode completely.
  int ParseRecordIOChunk(const char* p, int64_t len, Block* b) {
    // reassembly re-inserts elided magics: output can exceed payload bytes
    // but never input length + one magic per frame
    Buf payload;
    if (!payload.Reserve(len + 4)) return kEOom;
    int64_t max_rec = len / 8 + 2;
    int64_t* offsets = AllocArray<int64_t>(max_rec + 1);
    if (offsets == nullptr) return kEOom;
    int64_t nrec = 0, dlen = 0, consumed = 0;
    int rc = recordio_unpack(p, len, payload.p, offsets, &nrec, &dlen,
                             &consumed);
    if (rc != 0 || consumed != len) {
      std::free(offsets);
      return kEParse;
    }
    // pass 1: header validation + totals
    int64_t rows = 0, nnz = 0;
    int flags = 0;
    for (int64_t r = 0; r < nrec; ++r) {
      const char* rp = payload.p + offsets[r];
      int64_t rlen = offsets[r + 1] - offsets[r];
      uint32_t n, z;
      uint8_t rflags;
      if (!RowGroupHeader(rp, rlen, &n, &z, &rflags)) {
        std::free(offsets);
        return kEParse;
      }
      rows += n;
      nnz += z;
      flags |= rflags;
    }
    b->labels = AllocArray<float>(rows + 1);
    b->offsets = AllocArray<int64_t>(rows + 1);
    b->indices = AllocArray<uint32_t>(nnz + 1);
    if (b->labels == nullptr || b->offsets == nullptr ||
        b->indices == nullptr) {
      std::free(offsets);
      return kEOom;
    }
    if (flags & kHasWeight) b->weights = AllocArray<float>(rows + 1);
    if (flags & kHasQid) b->qids = AllocArray<int64_t>(rows + 1);
    if (flags & kHasValue) b->values = AllocArray<float>(nnz + 1);
    if (((flags & kHasWeight) && b->weights == nullptr) ||
        ((flags & kHasQid) && b->qids == nullptr) ||
        ((flags & kHasValue) && b->values == nullptr)) {
      std::free(offsets);
      return kEOom;
    }
    // pass 2: memcpy the sections
    uint32_t* idx_out = b->indices;
    int64_t row_at = 0, nnz_at = 0;
    b->offsets[0] = 0;
    for (int64_t r = 0; r < nrec; ++r) {
      const char* rp = payload.p + offsets[r];
      uint32_t n = 0, z = 0;
      uint8_t rflags = 0;  // header re-read; validated in pass 1
      RowGroupHeader(rp, offsets[r + 1] - offsets[r], &n, &z, &rflags);
      const char* q = rp + 12;
      std::memcpy(b->labels + row_at, q, n * 4);
      q += int64_t(n) * 4;
      if (rflags & kHasWeight) {
        std::memcpy(b->weights + row_at, q, n * 4);
        q += int64_t(n) * 4;
      } else if (flags & kHasWeight) {
        for (uint32_t i = 0; i < n; ++i) b->weights[row_at + i] = 1.0f;
      }
      if (rflags & kHasQid) {
        std::memcpy(b->qids + row_at, q, n * 8);
        q += int64_t(n) * 8;
      } else if (flags & kHasQid) {
        std::memset(b->qids + row_at, 0, n * 8);
      }
      // row_nnz -> running offsets
      const uint32_t* row_nnz = reinterpret_cast<const uint32_t*>(q);
      for (uint32_t i = 0; i < n; ++i) {
        b->offsets[row_at + i + 1] =
            b->offsets[row_at + i] + row_nnz[i];
      }
      q += int64_t(n) * 4;
      std::memcpy(idx_out + nnz_at, q, z * 4);
      q += int64_t(z) * 4;
      if (rflags & kHasValue) {
        std::memcpy(b->values + nnz_at, q, z * 4);
      } else if (flags & kHasValue) {
        for (uint32_t k = 0; k < z; ++k) b->values[nnz_at + k] = 1.0f;
      }
      row_at += n;
      nnz_at += z;
    }
    std::free(offsets);
    if (b->offsets[rows] != nnz) return kEParse;  // row_nnz vs nnz mismatch
    b->rows = rows;
    b->nnz = nnz;
    b->flags = flags;
    return kOk;
  }

  // Validate one row-group payload; false on malformed. Exact-size check
  // keeps a corrupt length from driving the memcpys past the payload.
  static bool RowGroupHeader(const char* p, int64_t len, uint32_t* nrows,
                             uint32_t* nnz, uint8_t* flags) {
    if (len < 12) return false;
    if (static_cast<uint8_t>(p[0]) != kRowGroupTag) return false;
    uint8_t fl = static_cast<uint8_t>(p[1]);
    if (fl & ~uint8_t(kHasWeight | kHasQid | kHasValue)) return false;
    uint32_t n, z;
    std::memcpy(&n, p + 4, 4);
    std::memcpy(&z, p + 8, 4);
    int64_t want = 12 + int64_t(n) * 4 + int64_t(n) * 4 + int64_t(z) * 4;
    if (fl & kHasWeight) want += int64_t(n) * 4;
    if (fl & kHasQid) want += int64_t(n) * 8;
    if (fl & kHasValue) want += int64_t(z) * 4;
    if (want != len) return false;
    *nrows = n;
    *nnz = z;
    *flags = fl;
    return true;
  }

  // ---- state ----------------------------------------------------------
  const std::vector<std::string> paths_;
  const std::vector<int64_t> sizes_;
  const int format_;
  const int part_, nparts_;
  const int nthread_;
  const int64_t chunk_bytes_;
  const int out_capacity_;
  const int64_t csv_expect_cols_;
  const bool push_mode_;

  // push-mode state: only touched by the single pushing thread
  Buf push_tail_;
  int64_t push_seq_ = 0;

  // batch-staging state: only touched by the single consuming thread
  std::deque<Span> staged_;
  int64_t staged_rows_ = 0;

  // per-stage counters (ns); written by their owning threads, read by Stats
  std::atomic<int64_t> reader_io_ns_{0};
  std::atomic<int64_t> reader_wait_ns_{0};
  std::atomic<int64_t> parse_ns_{0};
  std::atomic<int64_t> worker_wait_ns_{0};
  std::atomic<int64_t> consumer_wait_ns_{0};
  std::atomic<int64_t> chunk_count_{0};

  std::thread reader_;
  std::vector<std::thread> workers_;

  std::mutex mu_;
  std::condition_variable cv_work_, cv_work_space_, cv_out_, cv_out_space_;
  std::deque<Chunk*> work_;
  std::vector<Chunk*> free_chunks_;
  // returnable parsed blocks (see Block/BlockPool): sized past the
  // in-flight bound (out queue + one per worker + staging slack) so a
  // prompt consumer's returns always find room
  std::shared_ptr<BlockPool> pool_ = std::make_shared<BlockPool>();
  // seeded chunk-shuffle (ingest_open_ex); -1 = sequential
  const int64_t shuffle_seed_ = -1;
  // zero-copy reader mapping (TryMmapReader); unmapped in Close
  void* map_base_ = nullptr;
  size_t map_len_ = 0;
  std::map<int64_t, Block*> done_;
  int64_t next_seq_out_ = 0;
  int64_t total_chunks_ = -1;
  bool reader_done_ = false;
  bool stop_ = false;
  int error_ = 0;
  std::atomic<int64_t> bytes_read_{0};
  Block* current_ = nullptr;
};

}  // namespace

extern "C" {

// paths: '\0'-joined (nfiles entries); sizes: byte size per file.
// format: 0=libsvm 1=libfm 2=csv. Returns NULL on bad args.
void* ingest_open_ex(const char* paths, const int64_t* sizes, int32_t nfiles,
                     int32_t format, int32_t part, int32_t nparts,
                     int32_t nthread, int64_t chunk_bytes, int32_t capacity,
                     int64_t csv_expect_cols, int64_t shuffle_seed) {
  if (nfiles <= 0 || part < 0 || nparts <= 0 || part >= nparts) return nullptr;
  if (format < 0 || format > 3) return nullptr;
  if (shuffle_seed >= 0) {
    // shuffled visit order needs the random-access mmap reader: refuse
    // up front what the reader could only fail at runtime (multi-file
    // datasets span mappings)
    if (nfiles != 1) return nullptr;
  }
  std::vector<std::string> path_vec;
  const char* p = paths;
  for (int32_t i = 0; i < nfiles; ++i) {
    path_vec.emplace_back(p);
    p += path_vec.back().size() + 1;
  }
  std::vector<int64_t> size_vec(sizes, sizes + nfiles);
  Pipeline* pl =
      new Pipeline(std::move(path_vec), std::move(size_vec), format, part,
                   nparts, nthread, chunk_bytes, capacity, csv_expect_cols,
                   /*push_mode=*/false, shuffle_seed);
  pl->Start();
  return pl;
}

void* ingest_open(const char* paths, const int64_t* sizes, int32_t nfiles,
                  int32_t format, int32_t part, int32_t nparts,
                  int32_t nthread, int64_t chunk_bytes, int32_t capacity,
                  int64_t csv_expect_cols) {
  return ingest_open_ex(paths, sizes, nfiles, format, part, nparts, nthread,
                        chunk_bytes, capacity, csv_expect_cols,
                        /*shuffle_seed=*/-1);
}

// Push-mode pipeline: no reader thread — the caller streams the partition's
// bytes in with ingest_push (Python-fetched remote chunks feed the same
// native parse workers and ordered queue as local files). End the stream
// with ingest_push_eof; on a fetch failure call ingest_push_abort so
// consumers blocked in ingest_peek fail instead of hanging.
void* ingest_open_push(int32_t format, int32_t nthread, int64_t chunk_bytes,
                       int32_t capacity, int64_t csv_expect_cols) {
  if (format < 0 || format > 3) return nullptr;
  Pipeline* pl = new Pipeline({}, {}, format, 0, 1, nthread, chunk_bytes,
                              capacity, csv_expect_cols, /*push_mode=*/true);
  pl->Start();
  return pl;
}

// Append len bytes of the partition stream. Blocks for backpressure when
// the parse workers are behind. Returns 0 or a pipeline error code.
int ingest_push(void* handle, const char* data, int64_t len) {
  return static_cast<Pipeline*>(handle)->Push(data, len);
}

int ingest_push_eof(void* handle) {
  return static_cast<Pipeline*>(handle)->PushEof();
}

// Zero-copy push: reserve tail space to write into (valid until the next
// reserve/commit/push), then commit the bytes written. Feeders use this to
// readinto() remote responses directly into pipeline memory.
void* ingest_push_reserve(void* handle, int64_t want) {
  return static_cast<Pipeline*>(handle)->PushReserve(want);
}

int ingest_push_commit(void* handle, int64_t n) {
  return static_cast<Pipeline*>(handle)->PushCommit(n);
}

void ingest_push_abort(void* handle) {
  static_cast<Pipeline*>(handle)->PushAbort();
}

// Serial reserve -> caller-fetch -> commit loop over the whole stream (the
// C-consumer twin of the Python readahead feeder; see the header for the
// transport-boundary contract). Backpressure comes from PushCommit's
// bounded work queue, exactly as for any other feeder.
int ingest_drive_push(void* handle, dmlc_tpu_fetch_fn fetch, void* ctx,
                      int64_t total, int64_t fetch_bytes) {
  Pipeline* pl = static_cast<Pipeline*>(handle);
  // handle misuse (a reader-mode handle from ingest_open) is rejected
  // up front WITHOUT failing the pipeline — the sibling push_* calls
  // return kEIo the same way, and aborting a healthy reader pipeline
  // would wedge its consumers for the caller's mistake
  if (fetch == nullptr || !pl->IsPushMode()) return kEIo;
  if (fetch_bytes <= 0) fetch_bytes = 1 << 20;
  int64_t off = 0;
  while (total < 0 || off < total) {
    int64_t want = fetch_bytes;
    if (total >= 0 && total - off < want) want = total - off;
    if (want == 0) break;
    char* dst = pl->PushReserve(want);
    if (dst == nullptr) {
      // null here (push mode checked above) means the pipeline already
      // failed (worker parse error — report its real code), was stopped
      // by a concurrent close (kEIo), or hit OOM (PushReserve already
      // failed the pipeline with kEOom); no extra abort needed
      int err = pl->LastError();
      return err != 0 ? err : kEIo;
    }
    int64_t got = fetch(ctx, off, dst, want);
    if (got < 0 || got > want) {
      pl->PushAbort();
      return kEIo;
    }
    if (got == 0) {
      if (total >= 0) {
        // premature EOF against a declared length (object truncated
        // between stat and read, short HTTP body): consumers must see a
        // failure, not a clean EOF with rows missing
        pl->PushAbort();
        return kEIo;
      }
      break;  // end of stream (unknown-length mode)
    }
    int rc = pl->PushCommit(got);
    if (rc != 0) return rc;
    off += got;
  }
  return pl->PushEof();
}

// Wait for the next in-order block and report its sizes without consuming
// it. Returns 1 (sizes filled), 0 at end of stream, <0 on error. Idempotent
// until ingest_fetch consumes the staged block.
int ingest_peek(void* handle, int64_t* rows, int64_t* nnz, int64_t* ncols,
                int32_t* flags) {
  Pipeline* pl = static_cast<Pipeline*>(handle);
  Block* b = nullptr;
  int rc = pl->Peek(&b);
  if (rc != 1) return rc;
  *rows = b->rows;
  *nnz = b->nnz;
  *ncols = b->ncols;
  *flags = b->flags;
  return 1;
}

// Copy the staged block into caller-owned buffers (sized per ingest_peek;
// any pointer may be NULL to skip that array; indices/fields receive u32)
// and consume it. Returns 1, or 0 when no block is staged.
int ingest_fetch(void* handle, float* labels, float* weights, int64_t* qids,
                 int64_t* offsets, uint32_t* indices, float* values,
                 uint32_t* fields) {
  return static_cast<Pipeline*>(handle)->Fetch(labels, weights, qids, offsets,
                                               indices, values, fields);
}

// Zero-copy variant of ingest_fetch: transfers ownership of the staged
// block. Fills the output array pointers (indices/fields point at
// u32-packed data; pointers not populated by the format are NULL, but for
// libsvm the weights/qids arrays are always allocated with their defaults —
// presence of *explicit* weights/qids is signaled by the flags from
// ingest_peek, not by pointer nullness) and returns an opaque block handle
// the caller must release with ingest_block_free once the arrays are no
// longer referenced. Returns NULL when no block is staged.
void* ingest_fetch_view(void* handle, float** labels, float** weights,
                        int64_t** qids, int64_t** offsets, uint32_t** indices,
                        float** values, uint32_t** fields) {
  Block* b = static_cast<Pipeline*>(handle)->FetchOwn();
  if (b == nullptr) return nullptr;
  *labels = b->labels;
  *weights = b->weights;
  *qids = b->qids;
  *offsets = b->offsets;
  *indices = b->indices;
  *values = b->values;
  *fields = b->fields;
  return b;
}

void ingest_block_free(void* block) {
  // routes poolable blocks back to their origin pipeline's free list
  // (cross-ABI recycle); frees otherwise
  ReleaseBlock(static_cast<Block*>(block));
}

// ---- native batch staging (fixed-shape TPU feed) -------------------------
// Stage the next batch of up to batch_size rows (pulling parsed blocks in
// order; partial blocks carry over). Fills *rows (min(batch_size, left))
// and *nnz for sizing the fetch buffers. Returns 1 when rows > 0, 0 at end
// of stream, <0 on pipeline error. Single consumer thread, like
// ingest_peek/ingest_fetch.
int ingest_stage_batch(void* handle, int64_t batch_size, int64_t* rows,
                       int64_t* nnz) {
  return static_cast<Pipeline*>(handle)->StageBatch(batch_size, rows, nnz);
}

// Consume the staged rows into a dense [batch_size, num_features] f32 image
// plus labels/weights (zero-padded past the valid rows; weights default 1
// for valid rows). Returns rows consumed, or <0 on error.
int64_t ingest_fetch_batch_dense(void* handle, float* x, float* labels,
                                 float* weights, int64_t batch_size,
                                 int64_t num_features) {
  return static_cast<Pipeline*>(handle)->FetchBatchDense(
      x, labels, weights, batch_size, num_features);
}

// Consume the staged rows into a padded COO batch: labels/weights
// [batch_size], indices/values/row_ids [nnz_bucket], offsets
// [batch_size + 1] CSR (padding = arithmetic no-ops for segment-sum).
// Fails with -1 (consuming nothing) when the batch nnz exceeds
// nnz_bucket. Returns rows consumed, or <0 on error.
int64_t ingest_fetch_batch_coo(void* handle, float* labels, float* weights,
                               int32_t* indices, float* values,
                               int32_t* row_ids, int32_t* offsets,
                               int64_t batch_size, int64_t nnz_bucket) {
  return static_cast<Pipeline*>(handle)->FetchBatchCoo(
      labels, weights, indices, values, row_ids, offsets, batch_size,
      nnz_bucket);
}

// Max per-shard nnz of the staged batch under a num_shards row-range
// split (for sizing the shared per-shard bucket). -1 on bad arguments.
int64_t ingest_staged_max_shard_nnz(void* handle, int64_t batch_size,
                                    int64_t num_shards) {
  return static_cast<Pipeline*>(handle)->StagedMaxShardNnz(batch_size,
                                                           num_shards);
}

// Consume the staged rows into a mesh-sharded COO batch: labels/weights
// [batch_size]; indices/values/row_ids flat [num_shards * nnz_bucket] with
// per-shard sections and LOCAL row ids (shard = row / (batch/num_shards));
// offsets flat [num_shards * (batch/num_shards + 1)] per-shard LOCAL CSR.
// Fails with -1 (consuming nothing) when any shard overflows nnz_bucket.
int64_t ingest_fetch_batch_coo_sharded(void* handle, float* labels,
                                       float* weights, int32_t* indices,
                                       float* values, int32_t* row_ids,
                                       int32_t* offsets,
                                       int64_t batch_size,
                                       int64_t num_shards,
                                       int64_t nnz_bucket) {
  return static_cast<Pipeline*>(handle)->FetchBatchCooSharded(
      labels, weights, indices, values, row_ids, offsets, batch_size,
      num_shards, nnz_bucket);
}

// Per-stage counters: out[0]=bytes_read, [1]=chunks, [2]=reader_io_ns,
// [3]=reader_wait_ns, [4]=parse_ns, [5]=worker_wait_ns, [6]=consumer_wait_ns.
void ingest_stats(void* handle, double* out, int32_t n) {
  static_cast<Pipeline*>(handle)->Stats(out, n);
}

int64_t ingest_bytes_read(void* handle) {
  return static_cast<Pipeline*>(handle)->BytesRead();
}

void ingest_close(void* handle) {
  Pipeline* pl = static_cast<Pipeline*>(handle);
  pl->Close();
  delete pl;
}

}  // extern "C"
