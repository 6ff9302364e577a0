// A C++ program consuming the PyTorch port's native core directly: the
// public header dmlc_tpu_torch/native/csrc/dmlc_tpu.h and the library that
// dmlc_tpu_torch/native/_build.py builds from that directory (the
// counterpart of examples/native_ingest.cc, which links the JAX package's
// cpp/libdmlc_tpu.so).
//
// Build (from the repo root; native/_build.py gives the library's path):
//   LIB=$(python -c "from dmlc_tpu_torch.native import _build;
//                    print(_build.ensure_built())")
//   g++ -O2 -std=c++17 -pthread dmlc_tpu_torch/examples/native_ingest.cc
//       -Idmlc_tpu_torch/native/csrc "$LIB" -Wl,-rpath,"$(dirname "$LIB")"
//       -o native_ingest
//   ./native_ingest data.svm            # local-file reader pipeline
//   ./native_ingest --remote data.svm   # remote-shaped drive_push path
//
// Default mode streams a libsvm file through the threaded native pipeline
// (reader thread -> parse workers -> ordered CSR blocks) and prints
// totals: the engine that dmlc_tpu_torch.data.create_parser drives through
// ctypes on its native route.
//
// --remote drives ingest_drive_push, the C-consumer remote-ingest surface:
// the pipeline ships no transport (the consumer brings libcurl, an SDK or
// a socket; here a callback over a local file stands in for ranged GETs),
// and the fetch callback lands bytes directly in the pipeline's push
// memory (no staging copy). ingest_drive_push blocks for backpressure, so
// the consumer runs it on a feeder thread while the main thread drains,
// as this program does.

#include <cinttypes>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <sys/stat.h>

#include "dmlc_tpu.h"

namespace {

// The stand-in "transport": serve [offset, offset+len) of a local file the
// way a ranged-GET loop would. A real consumer points this at HTTP.
int64_t FileFetch(void* ctx, int64_t offset, char* buf, int64_t len) {
  std::FILE* f = static_cast<std::FILE*>(ctx);
  if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) return -1;
  size_t got = std::fread(buf, 1, static_cast<size_t>(len), f);
  if (got == 0 && std::ferror(f)) return -1;
  return static_cast<int64_t>(got);
}

}  // namespace

int main(int argc, char** argv) {
  bool remote = argc == 3 && std::strcmp(argv[1], "--remote") == 0;
  if (argc != 2 && !remote) {
    std::fprintf(stderr, "usage: %s [--remote] <file.svm>\n", argv[0]);
    return 2;
  }
  if (remote) argv[1] = argv[2];
  if (dmlc_tpu_abi_version() != DMLC_TPU_ABI_VERSION) {
    std::fprintf(stderr, "ABI mismatch: header %d, library %d\n",
                 DMLC_TPU_ABI_VERSION, dmlc_tpu_abi_version());
    return 2;
  }
  struct stat st;
  if (stat(argv[1], &st) != 0) {
    std::perror("stat");
    return 1;
  }
  int64_t size = static_cast<int64_t>(st.st_size);
  void* h;
  std::thread feeder;
  std::FILE* remote_file = nullptr;
  if (remote) {
    h = ingest_open_push(DMLC_TPU_FORMAT_LIBSVM, /*nthread=*/2,
                         /*chunk_bytes=*/8 << 20, /*capacity=*/4,
                         /*csv_expect_cols=*/0);
    if (h == nullptr) {
      std::fprintf(stderr, "ingest_open_push failed\n");
      return 1;
    }
    remote_file = std::fopen(argv[1], "rb");
    if (remote_file == nullptr) {
      std::perror("fopen");
      ingest_close(h);
      return 1;
    }
    feeder = std::thread([h, remote_file, size] {
      int rc = ingest_drive_push(h, FileFetch, remote_file, size,
                                 /*fetch_bytes=*/1 << 20);
      if (rc != 0) std::fprintf(stderr, "drive_push rc=%d\n", rc);
    });
  } else {
    // paths: NUL-terminated strings back to back (one file here)
    std::string paths(argv[1]);
    paths.push_back('\0');
    h = ingest_open(paths.data(), &size, /*nfiles=*/1,
                    DMLC_TPU_FORMAT_LIBSVM, /*part=*/0, /*nparts=*/1,
                    /*nthread=*/2, /*chunk_bytes=*/8 << 20,
                    /*capacity=*/4, /*csv_expect_cols=*/0);
    if (h == nullptr) {
      std::fprintf(stderr, "ingest_open failed\n");
      return 1;
    }
  }
  int64_t total_rows = 0, total_nnz = 0, blocks = 0;
  for (;;) {
    int64_t rows, nnz, ncols;
    int32_t flags;
    int rc = ingest_peek(h, &rows, &nnz, &ncols, &flags);
    if (rc == 0) break;  // end of stream
    if (rc < 0) {
      std::fprintf(stderr, "pipeline error rc=%d\n", rc);
      if (feeder.joinable()) feeder.join();
      if (remote_file != nullptr) std::fclose(remote_file);
      ingest_close(h);
      return 1;
    }
    float *labels, *weights, *values;
    int64_t *qids, *offsets;
    uint32_t *indices, *fields;
    void* block = ingest_fetch_view(h, &labels, &weights, &qids, &offsets,
                                    &indices, &values, &fields);
    // zero-copy CSR views are valid until ingest_block_free
    total_rows += rows;
    total_nnz += offsets[rows];
    ++blocks;
    ingest_block_free(block);
  }
  std::printf("rows=%" PRId64 " nnz=%" PRId64 " blocks=%" PRId64
              " bytes=%" PRId64 "\n",
              total_rows, total_nnz, blocks, ingest_bytes_read(h));
  if (feeder.joinable()) feeder.join();
  if (remote_file != nullptr) std::fclose(remote_file);
  ingest_close(h);
  return 0;
}
