// Native RecordIO framing: pack/unpack hot loops.
//
// TPU-build equivalent of the reference's RecordIO core (src/recordio.cc:
// WriteRecord 11-51, NextRecord 53-82, ChunkReader 101-156): the per-record
// frame/scan/reassemble loops live in C++ behind the same flat C ABI as
// parse.cc. Batch-oriented by design — the Python side hands a whole chunk
// (or a batch of records) across ctypes once, instead of one record at a
// time.
//
// Format (recordio.h:17-70): [magic u32][lrec u32][payload][pad to 4B] where
// lrec = cflag<<29 | length, cflag 0=whole 1=start 2=middle 3=end; payloads
// containing the aligned magic word are split at those words, which are
// re-inserted on read.

#include <cstdint>
#include <cstring>

#include "dmlc_tpu.h"

namespace {

constexpr uint32_t kMagic = 0xced7230aU;
constexpr uint32_t kLenMask = (1U << 29) - 1U;

inline uint32_t lower_align4(uint32_t x) { return x & ~3U; }
inline int64_t pad4(int64_t n) { return (n + 3) & ~int64_t(3); }

inline void put_u32(char* p, uint32_t v) { std::memcpy(p, &v, 4); }
inline uint32_t get_u32(const char* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Number of aligned magic words inside a payload (the reference's
// except_counter_, recordio.cc:16-23).
inline int64_t count_embedded_magic(const char* data, int64_t len) {
  int64_t n = 0;
  for (int64_t i = 0; i + 4 <= len; i += 4) {
    if (get_u32(data + i) == kMagic) ++n;
  }
  return n;
}

}  // namespace

extern "C" {

// Exact packed size of one record (header + payload + padding + extra
// headers for embedded-magic splits).
int64_t recordio_pack_bound(const char* data, int64_t len) {
  return 8 + pad4(len) + 8 * count_embedded_magic(data, len);
}

// Frame one record into out (caller sized via recordio_pack_bound).
// Returns bytes written. Mirrors WriteRecord (recordio.cc:11-51): payload is
// split at aligned embedded magic words; parts carry cflag start/middle/end.
int64_t recordio_pack(const char* data, int64_t len, char* out) {
  if (len >= (int64_t(1) << 29)) return -1;  // length field is 29 bits
  int64_t nmagic = count_embedded_magic(data, len);
  char* o = out;
  if (nmagic == 0) {
    put_u32(o, kMagic);
    put_u32(o + 4, static_cast<uint32_t>(len));
    std::memcpy(o + 8, data, len);
    o += 8 + len;
    while ((o - out) & 3) *o++ = 0;
    return o - out;
  }
  // split at each aligned embedded magic; the magic word itself is elided
  // (re-inserted by the reader between parts)
  int64_t part_start = 0;
  int64_t part_index = 0;
  for (int64_t i = 0; i + 4 <= len; i += 4) {
    if (get_u32(data + i) != kMagic) continue;
    int64_t plen = i - part_start;
    uint32_t cflag = (part_index == 0) ? 1U : 2U;
    put_u32(o, kMagic);
    put_u32(o + 4, (cflag << 29) | static_cast<uint32_t>(plen));
    std::memcpy(o + 8, data + part_start, plen);
    o += 8 + plen;
    while ((o - out) & 3) *o++ = 0;
    part_start = i + 4;
    ++part_index;
  }
  int64_t plen = len - part_start;
  put_u32(o, kMagic);
  put_u32(o + 4, (3U << 29) | static_cast<uint32_t>(plen));
  std::memcpy(o + 8, data + part_start, plen);
  o += 8 + plen;
  while ((o - out) & 3) *o++ = 0;
  return o - out;
}

// Exact packed size of a batch (one call instead of n ctypes round-trips).
int64_t recordio_pack_batch_bound(const char* data, const int64_t* offsets,
                                  int64_t n) {
  int64_t total = 0;
  for (int64_t r = 0; r < n; ++r) {
    total += recordio_pack_bound(data + offsets[r],
                                 offsets[r + 1] - offsets[r]);
  }
  return total;
}

// Batch pack: n records, payloads concatenated in data with offsets[n+1].
// out must hold the sum of per-record bounds. Returns bytes written.
int64_t recordio_pack_batch(const char* data, const int64_t* offsets,
                            int64_t n, char* out) {
  char* o = out;
  for (int64_t r = 0; r < n; ++r) {
    int64_t wrote =
        recordio_pack(data + offsets[r], offsets[r + 1] - offsets[r], o);
    if (wrote < 0) return -1;  // oversized record
    o += wrote;
  }
  return o - out;
}

// Unpack every complete record in buf[0:len] (must start at a record head).
// Reassembled payloads are written contiguously to out_data (re-inserting
// the magic between split parts, NextRecord recordio.cc:53-82), with
// out_offsets[r]..out_offsets[r+1] delimiting record r.
//   returns 0 ok; -2 corrupt framing
// *out_nrec = records decoded, *out_datalen = bytes written to out_data,
// *out_consumed = input bytes consumed (trailing partial frame is left).
int recordio_unpack(const char* buf, int64_t len, char* out_data,
                    int64_t* out_offsets, int64_t* out_nrec,
                    int64_t* out_datalen, int64_t* out_consumed) {
  int64_t pos = 0;
  int64_t nrec = 0;
  int64_t dlen = 0;
  out_offsets[0] = 0;
  int64_t rec_start = 0;        // current record's start in out_data
  int64_t rec_frame_start = 0;  // its first frame's offset in buf
  bool in_multi = false;
  while (pos + 8 <= len) {
    if (get_u32(buf + pos) != kMagic) return -2;
    uint32_t lrec = get_u32(buf + pos + 4);
    uint32_t cflag = lrec >> 29;
    int64_t plen = lrec & kLenMask;
    int64_t frame_end = pos + 8 + pad4(plen);
    if (frame_end > len) break;  // partial frame: stop
    if (!in_multi) {
      if (cflag != 0 && cflag != 1) return -2;
      rec_start = dlen;
      rec_frame_start = pos;
      in_multi = (cflag == 1);
    } else {
      if (cflag != 2 && cflag != 3) return -2;
      // re-insert the elided magic between parts
      put_u32(out_data + dlen, kMagic);
      dlen += 4;
    }
    std::memcpy(out_data + dlen, buf + pos + 8, plen);
    dlen += plen;
    pos = frame_end;
    if (cflag == 0 || cflag == 3) {
      out_offsets[++nrec] = dlen;
      in_multi = false;
    }
  }
  if (in_multi) {
    // incomplete multi-part record: roll both the payload AND the consumed
    // count back to the record's first frame, so callers see the truncation
    dlen = rec_start;
    pos = rec_frame_start;
  }
  *out_nrec = nrec;
  *out_datalen = dlen;
  *out_consumed = pos;
  return 0;
}

// First aligned offset >= start where a plausible record head begins
// (SeekRecordBegin, recordio_split.cc:9-25). Returns -1 if none.
int64_t recordio_find_head(const char* buf, int64_t len, int64_t start) {
  for (int64_t i = (start + 3) & ~int64_t(3); i + 8 <= len; i += 4) {
    if (get_u32(buf + i) == kMagic) {
      uint32_t cflag = get_u32(buf + i + 4) >> 29;
      if (cflag == 0 || cflag == 1) return i;
    }
  }
  return -1;
}

}  // extern "C"
