// AVX2 tokenize + batch-convert engine for the LibSVM hot path.
//
// The scalar loop in parse.cc walks the chunk byte by byte: ~25-30 cycles
// per "idx:val" pair, which caps chunk parse near 1 GB/s on one core. This
// engine restructures the work into three passes so the per-byte and
// per-token costs vectorize:
//
//   1. tokenize: 32 bytes per iteration — vpcmpeqb masks for \n \r ' ' \t
//      ':' classify every byte, and token start/end offsets fall out of
//      (sep << 1) boundary masks via tzcnt extraction. A '-' that sits
//      between a separator and a non-separator is treated as a separator
//      too (a sign), so token starts always point at the first digit and
//      the converter never sees signs; any other '-' stays inside its
//      token and fails digit validation, routing the row to the scalar
//      fallback. Newline offsets are extracted the same way for row
//      assembly.
//   2. convert: branchless and fully lane-parallel, four tokens per
//      iteration. One vpgatherqq pulls the four 8-byte windows; length
//      masks, dot removal (lowest-set-bit blend), dot position (vpsadbw
//      byte count), digit validation, the ascii->integer multiply tree
//      (vpmaddubsw / vpmaddwd / vpmuludq), and the 10^e divisor (vgatherpd
//      from an exact table) never leave the vector unit. The window is
//      left-aligned, so the packed integer is mant * 10^(8-ndig) and the
//      value is exactly mant8 / 10^(8-dp) with dp = min(dotpos, len); both
//      operands are exact doubles, so the single vdivpd rounds once —
//      bit-identical to the scalar scan_double/strtod fast path.
//   3. assemble: a scalar walk over the token stream builds rows (label,
//      optional :weight, idx[:val] features), checking structure with the
//      separator byte after each token and start adjacency across ':'.
//      Signs are recovered here: data[st-1] == '-' flips the converted
//      value, and the byte before the sign is required to be a true
//      separator so shapes like "--5" or a freestanding "-" can never
//      silently parse — they fall back to the scalar oracle.
//
// Anything outside the proven-exact shapes — tokens longer than the 8-byte
// window, exponents, qid:, inf/nan, malformed rows — falls back to
// ParseSvmRowScalar for THAT ROW, so the scalar parser remains the single
// source of truth and outputs are bit-identical in all cases. The engine
// is compiled for generic x86-64 with per-function target("avx2,bmi,bmi2,
// lzcnt") attributes and only runs after a CPUID check (SimdKernelLevel),
// so the .so stays loadable on baseline hardware.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#include "dmlc_tpu.h"
#include "parse_common.h"

#if defined(__x86_64__) && (defined(__GNUC__) || defined(__clang__))
#define DMLC_TPU_SIMD_X86 1
#include <immintrin.h>
#else
#define DMLC_TPU_SIMD_X86 0
#endif

namespace dmlc_tpu_parse {

int SimdKernelLevel() {
  static const int level = [] {
#if DMLC_TPU_SIMD_X86
    if (__builtin_cpu_supports("avx2") && __builtin_cpu_supports("bmi") &&
        __builtin_cpu_supports("bmi2")) {
      return 2;
    }
#endif
    return 0;
  }();
  return level;
}

#if DMLC_TPU_SIMD_X86

namespace {

constexpr int kTileTokens = 4096;
constexpr int kTileEvents = kTileTokens * 2;
// extraction writes up to 32 events past the soft cap (one full block),
// and the convert loop reads a full group of four past ntok
constexpr int kTileSlack = 40;

constexpr uint8_t kBad = 1;  // token needs the scalar row fallback
constexpr uint8_t kDot = 4;  // contains '.'

// true separators (sign '-' is contextual and never one of these)
inline bool IsBaseSep(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == ':';
}

struct Tile {
  uint32_t pos[kTileEvents + kTileSlack];  // alternating start/end offsets
  uint32_t nl[kTileEvents + kTileSlack];   // \n and \r offsets
  double val[kTileTokens + kTileSlack];    // converted numeric value
  uint8_t info[kTileTokens + kTileSlack];  // kBad | kDot
};

Tile* GetTile() {
  // one tile per parse thread; POD so thread_local costs a TLS slot, and
  // the ~170 KB stays L2-resident across chunks
  static thread_local Tile tile;
  return &tile;
}

// Tokenize [off, len) into tile->pos / tile->nl until the tile fills or
// the chunk ends. *prev_sep carries boundary state across blocks and
// calls: bit 0 = previous byte was an effective separator, bit 1 = it was
// a base separator (3 at beginning-of-chunk; rewinds set 1, which is
// always safe — a mis-sighted sign only widens the scalar fallback).
// Returns the scan frontier: events are complete for every byte before it.
__attribute__((target("avx2,bmi,lzcnt")))
int64_t TokenizeTile(const char* data, int64_t len, int64_t off,
                     uint32_t* prev_sep, Tile* tile, int* out_ne,
                     int* out_nn) {
  const __m256i vnl = _mm256_set1_epi8('\n');
  const __m256i vcr = _mm256_set1_epi8('\r');
  const __m256i vsp = _mm256_set1_epi8(' ');
  const __m256i vtb = _mm256_set1_epi8('\t');
  const __m256i vco = _mm256_set1_epi8(':');
  const __m256i vmi = _mm256_set1_epi8('-');
  int ne = 0, nn = 0;
  uint32_t prev_eff = *prev_sep & 1u;
  uint32_t prev_base = (*prev_sep >> 1) & 1u;
  while (off < len && ne < kTileEvents && nn < kTileEvents) {
    uint32_t m_nl, m_base, m_mi;
    int64_t tail = len - off;
    if (tail >= 32) {
      __m256i v =
          _mm256_loadu_si256(reinterpret_cast<const __m256i*>(data + off));
      m_nl = static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_or_si256(
          _mm256_cmpeq_epi8(v, vnl), _mm256_cmpeq_epi8(v, vcr))));
      uint32_t m_sp = static_cast<uint32_t>(_mm256_movemask_epi8(
          _mm256_or_si256(_mm256_cmpeq_epi8(v, vsp),
                          _mm256_cmpeq_epi8(v, vtb))));
      uint32_t m_co = static_cast<uint32_t>(
          _mm256_movemask_epi8(_mm256_cmpeq_epi8(v, vco)));
      m_mi = static_cast<uint32_t>(
          _mm256_movemask_epi8(_mm256_cmpeq_epi8(v, vmi)));
      m_base = m_nl | m_sp | m_co;
      tail = 32;
    } else {
      // pad the final partial block with '\n': separator bytes, so a token
      // running to end-of-chunk gets its end event at exactly `len`, and
      // the nl extraction below masks the padding out
      alignas(32) unsigned char buf[32];
      std::memset(buf, '\n', sizeof(buf));
      std::memcpy(buf, data + off, static_cast<size_t>(tail));
      __m256i v = _mm256_load_si256(reinterpret_cast<const __m256i*>(buf));
      m_nl = static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_or_si256(
          _mm256_cmpeq_epi8(v, vnl), _mm256_cmpeq_epi8(v, vcr))));
      uint32_t m_sp = static_cast<uint32_t>(_mm256_movemask_epi8(
          _mm256_or_si256(_mm256_cmpeq_epi8(v, vsp),
                          _mm256_cmpeq_epi8(v, vtb))));
      uint32_t m_co = static_cast<uint32_t>(
          _mm256_movemask_epi8(_mm256_cmpeq_epi8(v, vco)));
      m_mi = static_cast<uint32_t>(
          _mm256_movemask_epi8(_mm256_cmpeq_epi8(v, vmi)));
      m_base = m_nl | m_sp | m_co;
      m_nl &= (tail == 32) ? ~0u : ((1u << tail) - 1u);
    }
    // a '-' is a sign (and thus an effective separator) iff the previous
    // byte is a base separator and the next byte is not; the next-block
    // byte is classified scalar so bit 31 needs no lookahead iteration
    uint32_t next_is_sep =
        (off + tail < len) ? (IsBaseSep(static_cast<unsigned char>(
                                  data[off + tail]))
                                  ? 1u
                                  : 0u)
                           : 1u;
    uint32_t nextsep = (m_base >> 1) | (next_is_sep << 31);
    uint32_t sign = m_mi & ((m_base << 1) | prev_base) & ~nextsep;
    uint32_t m_sep = m_base | sign;
    uint32_t nonsep = ~m_sep;
    uint32_t starts = nonsep & ((m_sep << 1) | prev_eff);
    uint32_t ends = m_sep & ((nonsep << 1) | (prev_eff ^ 1u));
    prev_eff = m_sep >> 31;
    prev_base = m_base >> 31;
    uint32_t base = static_cast<uint32_t>(off);
    uint32_t ev = starts | ends;
    while (ev != 0) {
      tile->pos[ne++] = base + static_cast<uint32_t>(_tzcnt_u32(ev));
      ev = _blsr_u32(ev);
    }
    while (m_nl != 0) {
      tile->nl[nn++] = base + static_cast<uint32_t>(_tzcnt_u32(m_nl));
      m_nl = _blsr_u32(m_nl);
    }
    off += tail;
  }
  *prev_sep = prev_eff | (prev_base << 1);
  *out_ne = ne;
  *out_nn = nn;
  return off;
}

// spread the low 4 bits of b into the low bit of 4 consecutive bytes
inline uint32_t SpreadNibble(uint32_t b) {
  return (b * 0x00204081u) & 0x01010101u;
}

// Convert tokens [0, ntok) in groups of four, branchlessly. Each token's
// 8-byte window (starts point at the first digit: the tokenizer stripped
// signs) is masked to its length, the dot byte is squeezed out with a
// lowest-set-bit blend, and the remaining ascii digits go through the
// multiply tree: the window is left-aligned, so the packed integer is
// mant * 10^(8-ndig) and the value is exactly mant8 / 10^(8-dp) with
// dp = min(dotpos, len) in [0, 8]. Both operands are exact doubles, so
// the single divide rounds once: identical bits to scan_double.
__attribute__((target("avx2,bmi,lzcnt")))
void ConvertTile(const char* data, int64_t len, Tile* tile, int64_t ntok) {
  if (ntok <= 0) return;
  // powtab[dp] = 10^(8-dp), every entry exact
  static const double powtab[9] = {1e8, 1e7, 1e6, 1e5, 1e4,
                                   1e3, 1e2, 1e1, 1e0};
  // pad the event array so the last group's idle lanes replay the final
  // real token (keeps the gather in-bounds and the lanes harmless)
  for (int k = 0; k < 8; k += 2) {
    tile->pos[2 * ntok + k] = tile->pos[2 * ntok - 2];
    tile->pos[2 * ntok + k + 1] = tile->pos[2 * ntok - 1];
  }
  const __m256i vone = _mm256_set1_epi64x(1);
  const __m256i veight = _mm256_set1_epi64x(8);
  const __m256i v30 = _mm256_set1_epi8(0x30);
  const __m256i vdotx = _mm256_set1_epi8(0x1E);  // '.' ^ 0x30
  const __m256i vnine = _mm256_set1_epi8(9);
  const __m256i v01 = _mm256_set1_epi8(1);
  const __m256i vzero = _mm256_setzero_si256();
  const __m256i vm10_1 = _mm256_set1_epi16(0x010A);       // bytes [10, 1]
  const __m256i vm100_1 = _mm256_set1_epi32(0x00010064);  // words [100, 1]
  const __m256i vm1e4 = _mm256_set1_epi64x(10000);
  const __m256i idx_even = _mm256_setr_epi32(0, 2, 4, 6, 1, 3, 5, 7);
  for (int64_t i = 0; i < ntok; i += 4) {
    int64_t lastr = (i + 3 < ntok) ? i + 3 : ntok - 1;
    if (static_cast<int64_t>(tile->pos[2 * lastr]) + 8 > len) {
      // tokens inside the chunk's final 8 bytes: the window gather would
      // over-read the mapping, so route their row(s) to the scalar oracle
      for (int k = 0; k < 4; ++k) {
        tile->val[i + k] = 0.0;
        tile->info[i + k] = kBad;
      }
      continue;
    }
    __m256i pv = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(tile->pos + 2 * i));
    __m256i de = _mm256_permutevar8x32_epi32(pv, idx_even);
    __m128i st4 = _mm256_castsi256_si128(de);           // starts
    __m128i en4 = _mm256_extracti128_si256(de, 1);      // ends
    // four plain loads beat vpgatherqq here: the offsets are already hot
    // in L1 and the inserts pipeline with the mask math below
    uint64_t w0, w1, w2, w3;
    std::memcpy(&w0, data + tile->pos[2 * i], 8);
    std::memcpy(&w1, data + tile->pos[2 * i + 2], 8);
    std::memcpy(&w2, data + tile->pos[2 * i + 4], 8);
    std::memcpy(&w3, data + tile->pos[2 * i + 6], 8);
    __m256i w = _mm256_set_epi64x(static_cast<int64_t>(w3),
                                  static_cast<int64_t>(w2),
                                  static_cast<int64_t>(w1),
                                  static_cast<int64_t>(w0));
    __m256i L = _mm256_cvtepu32_epi64(_mm_sub_epi32(en4, st4));
    __m256i L8 = _mm256_slli_epi64(L, 3);
    // (1 << 8*len) - 1; len == 8 shifts by 64 -> sllv yields 0 -> all-ones
    __m256i lenbit = _mm256_sllv_epi64(vone, L8);
    __m256i lenmask = _mm256_sub_epi64(lenbit, vone);
    __m256i y = _mm256_and_si256(_mm256_xor_si256(w, v30), lenmask);
    // dot handling: lowest set bit of (dot-compare | length-bit) marks
    // min(dotpos, len); bytes below it form dlow, and vpsadbw counts them
    __m256i dcmp = _mm256_cmpeq_epi8(y, vdotx);
    __m256i dcmp2 = _mm256_or_si256(dcmp, lenbit);
    __m256i low = _mm256_and_si256(dcmp2, _mm256_sub_epi64(vzero, dcmp2));
    __m256i dlow = _mm256_sub_epi64(low, vone);
    __m256i dp = _mm256_sad_epu8(_mm256_and_si256(dlow, v01), vzero);
    __m256i nodot = _mm256_cmpeq_epi64(dcmp, vzero);
    // ndig = len - hasdot; ndig == 0 (".", or sign debris) is malformed
    __m256i shift2 = _mm256_sub_epi64(L8, _mm256_andnot_si256(nodot, veight));
    __m256i ndigmask =
        _mm256_sub_epi64(_mm256_sllv_epi64(vone, shift2), vone);
    // squeeze the dot byte out: bytes below it stay, bytes above shift down
    __m256i m = _mm256_and_si256(
        _mm256_or_si256(_mm256_and_si256(y, dlow),
                        _mm256_andnot_si256(dlow, _mm256_srli_epi64(y, 8))),
        ndigmask);
    // any byte > 9 => not a plain digit string (second dot, exponent, a
    // '-' inside the token, letters): scalar fallback for the row
    __m256i okdig = _mm256_cmpeq_epi64(_mm256_subs_epu8(m, vnine), vzero);
    __m256i bad = _mm256_or_si256(
        _mm256_or_si256(_mm256_cmpeq_epi64(shift2, vzero),
                        _mm256_cmpgt_epi64(L, veight)),
        _mm256_andnot_si256(okdig, _mm256_cmpeq_epi64(vzero, vzero)));
    // ascii digit pack: pairs *10+1, then *100+1, then *10000+1
    __m256i t1 = _mm256_maddubs_epi16(m, vm10_1);
    __m256i t2 = _mm256_madd_epi16(t1, vm100_1);
    __m256i mant = _mm256_add_epi64(_mm256_mul_epu32(t2, vm1e4),
                                    _mm256_srli_epi64(t2, 32));
    // mant < 1e8 < 2^31: pack the four u64 lanes to i32 and convert exactly
    __m256i sh = _mm256_shuffle_epi32(mant, _MM_SHUFFLE(2, 0, 2, 0));
    __m128i pk = _mm_unpacklo_epi64(_mm256_castsi256_si128(sh),
                                    _mm256_extracti128_si256(sh, 1));
    __m256d md = _mm256_cvtepi32_pd(pk);
    __m256d pw = _mm256_i64gather_pd(powtab, dp, 8);
    _mm256_storeu_pd(tile->val + i, _mm256_div_pd(md, pw));
    uint32_t bb = static_cast<uint32_t>(
        _mm256_movemask_pd(_mm256_castsi256_pd(bad)));
    uint32_t db = ~static_cast<uint32_t>(
                      _mm256_movemask_pd(_mm256_castsi256_pd(nodot))) &
                  0xFu;
    uint32_t iw = SpreadNibble(bb) * kBad | (SpreadNibble(db) * kDot);
    std::memcpy(tile->info + i, &iw, 4);
  }
}

template <typename IndexT>
int ParseSvmSimdImpl(const char* data, int64_t len, SvmSink<IndexT>* s) {
  Tile* tile = GetTile();
  int64_t off = 0;
  uint32_t prev_sep = 3;  // beginning-of-chunk: effective + base separator
  bool row_open = false;
  double label = 0.0, weight = 1.0;
  int64_t row_start_nnz = 0;
  int64_t row_begin = 0;   // byte offset of the open row's label token
  int64_t consumed = 0;    // bytes eaten by scalar fallback rows
  while (off < len) {
    int ne = 0, nn = 0;
    int64_t scan_end = TokenizeTile(data, len, off, &prev_sep, tile, &ne, &nn);
    int64_t resume = scan_end;
    if (scan_end < len) {
      // mid-chunk tile boundary: rewind a dangling token start, and hold
      // back a trailing ':'-terminated token so idx:val / label:weight
      // pairs never straddle tiles (the assembler looks ahead one token)
      if (ne & 1) {
        resume = tile->pos[ne - 1];
        --ne;
        prev_sep = 1;
      }
      if (ne >= 2 && data[tile->pos[ne - 1]] == ':') {
        resume = tile->pos[ne - 2];
        ne -= 2;
        prev_sep = 1;
      }
      while (nn > 0 && tile->nl[nn - 1] >= resume) --nn;
    } else if (ne & 1) {
      // chunk ends inside a token scanned by a full 32-byte block (no pad
      // byte to close it): synthesize the end event at end-of-chunk
      tile->pos[ne++] = static_cast<uint32_t>(len);
    }
    int64_t ntok = ne / 2;
    ConvertTile(data, len, tile, ntok);
    int nl_i = 0;
    for (int64_t t = 0; t < ntok; ++t) {
      uint32_t st = tile->pos[2 * t];
      if (static_cast<int64_t>(st) < consumed) continue;
      uint32_t en = tile->pos[2 * t + 1];
      bool brk = false;
      while (nl_i < nn && tile->nl[nl_i] < st) {
        ++nl_i;
        brk = true;
      }
      if (brk && row_open) {
        s->labels[s->rows] = static_cast<float>(label);
        s->weights[s->rows] = static_cast<float>(weight);
        s->qids[s->rows] = 0;
        s->row_nnz[s->rows] = s->nnz - row_start_nnz;
        ++s->rows;
        row_open = false;
      }
      uint8_t info = tile->info[t];
      bool colon = static_cast<int64_t>(en) < len && data[en] == ':';
      // sign recovery: the tokenizer classified data[st-1] == '-' as a
      // separator only in sign position; require a true separator (or
      // chunk start) before it so "--5" and friends cannot slip through
      bool neg = st > 0 && data[st - 1] == '-';
      bool fall = false;
      if (!row_open) {
        // ---- label token, opens a row ----
        if ((info & kBad) != 0 ||
            (neg && st >= 2 &&
             !IsBaseSep(static_cast<unsigned char>(data[st - 2])))) {
          fall = true;
        } else {
          row_begin = st - (neg ? 1 : 0);
          label = neg ? -tile->val[t] : tile->val[t];
          weight = 1.0;
          row_start_nnz = s->nnz;
          row_open = true;
          if (colon) {
            // label:weight — the weight token must be adjacent (one byte
            // after the ':', or two with a sign), clean, and not itself
            // ':'-terminated
            uint32_t wst = t + 1 < ntok ? tile->pos[2 * t + 2] : 0;
            bool wneg = t + 1 < ntok && wst == en + 2 && data[en + 1] == '-';
            if (t + 1 >= ntok || (wst != en + 1 && !wneg) ||
                (tile->info[t + 1] & kBad) != 0 ||
                (static_cast<int64_t>(tile->pos[2 * t + 3]) < len &&
                 data[tile->pos[2 * t + 3]] == ':')) {
              fall = true;
            } else {
              weight = wneg ? -tile->val[t + 1] : tile->val[t + 1];
              s->flags |= DMLC_TPU_HAS_WEIGHT;
              ++t;
            }
          }
          if (!fall && s->rows >= s->max_rows) return DMLC_TPU_EOVERFLOW;
        }
      } else if (info & kBad) {
        // qid:, letters, exponents, window-overflow tokens
        fall = true;
      } else if (colon) {
        // ---- idx:val ----
        uint32_t vst = t + 1 < ntok ? tile->pos[2 * t + 2] : 0;
        bool vneg = t + 1 < ntok && vst == en + 2 && data[en + 1] == '-';
        if ((info & kDot) != 0 || neg || t + 1 >= ntok ||
            (vst != en + 1 && !vneg) || (tile->info[t + 1] & kBad) != 0 ||
            (static_cast<int64_t>(tile->pos[2 * t + 3]) < len &&
             data[tile->pos[2 * t + 3]] == ':')) {
          fall = true;
        } else {
          if (s->nnz >= s->max_nnz) return DMLC_TPU_EOVERFLOW;
          // integer tokens convert to an exact integral double
          s->indices[s->nnz] = static_cast<IndexT>(
              static_cast<uint64_t>(static_cast<int64_t>(tile->val[t])));
          s->values[s->nnz] = static_cast<float>(
              vneg ? -tile->val[t + 1] : tile->val[t + 1]);
          ++s->nnz;
          s->flags |= DMLC_TPU_HAS_VALUE;
          ++t;
          // ---- fast pair loop ----
          // a feature row is a run of clean idx:val pairs; validate each
          // with one branchless predicate instead of re-entering the
          // general state machine (any miss — newline, sign debris, bad
          // token, capacity — drops back out with nothing consumed)
          uint32_t next_nl =
              nl_i < nn ? tile->nl[nl_i] : 0xFFFFFFFFu;
          int64_t u = t + 1;
          while (u + 1 < ntok) {
            uint32_t fst = tile->pos[2 * u];
            uint32_t fen = tile->pos[2 * u + 1];
            uint32_t fvs = tile->pos[2 * u + 2];
            uint32_t fve = tile->pos[2 * u + 3];
            uint16_t inf2;
            std::memcpy(&inf2, tile->info + u, 2);
            uint32_t fneg = data[fvs - 1] == '-';
            // idx byte: no flags at all; value byte: kDot is fine, kBad not
            bool ok = ((inf2 & (0xFFu | (static_cast<uint32_t>(kBad) << 8))) ==
                       0) &
                      (data[fen] == ':') &
                      (fvs == fen + 1 + fneg) & (data[fst - 1] != '-') &
                      (fst < next_nl) & (s->nnz < s->max_nnz);
            if (!ok) break;
            if (static_cast<int64_t>(fve) < len && data[fve] == ':') break;
            uint64_t vb;
            std::memcpy(&vb, tile->val + (u + 1), 8);
            vb ^= static_cast<uint64_t>(fneg) << 63;
            double fv;
            std::memcpy(&fv, &vb, 8);
            s->indices[s->nnz] = static_cast<IndexT>(
                static_cast<uint64_t>(static_cast<int64_t>(tile->val[u])));
            s->values[s->nnz] = static_cast<float>(fv);
            ++s->nnz;
            u += 2;
          }
          t = u - 1;
        }
      } else {
        // ---- bare idx (implicit value 1.0) ----
        if ((info & kDot) != 0 || neg) {
          fall = true;
        } else {
          if (s->nnz >= s->max_nnz) return DMLC_TPU_EOVERFLOW;
          s->indices[s->nnz] = static_cast<IndexT>(
              static_cast<uint64_t>(static_cast<int64_t>(tile->val[t])));
          s->values[s->nnz] = 1.0f;
          ++s->nnz;
        }
      }
      if (fall) {
        // rewind the open row and let the scalar oracle parse it whole;
        // it consumes through the row's line terminator
        if (row_open) s->nnz = row_start_nnz;
        int64_t rb = row_open ? row_begin
                              : static_cast<int64_t>(st) - (neg ? 1 : 0);
        row_open = false;
        const char* q = data + rb;
        int64_t idb = 0, idc = 0;
        bool first = s->rows == 0;
        int rc = ParseSvmRowScalar<IndexT>(&q, data + len, false,
                                           first ? &idb : nullptr,
                                           first ? &idc : nullptr, s);
        if (rc != DMLC_TPU_OK) return rc;
        consumed = q - data;
        while (nl_i < nn && tile->nl[nl_i] < consumed) ++nl_i;
      }
    }
    // newlines between the last token and the resume frontier close the row
    while (nl_i < nn && tile->nl[nl_i] < resume) {
      ++nl_i;
      if (row_open) {
        s->labels[s->rows] = static_cast<float>(label);
        s->weights[s->rows] = static_cast<float>(weight);
        s->qids[s->rows] = 0;
        s->row_nnz[s->rows] = s->nnz - row_start_nnz;
        ++s->rows;
        row_open = false;
      }
    }
    if (consumed > resume) {
      // a fallback row ran past the scan frontier; resume just after its
      // line terminator, which is a separator by definition
      off = consumed;
      prev_sep = 1;
    } else {
      off = resume;
    }
  }
  if (row_open) {
    s->labels[s->rows] = static_cast<float>(label);
    s->weights[s->rows] = static_cast<float>(weight);
    s->qids[s->rows] = 0;
    s->row_nnz[s->rows] = s->nnz - row_start_nnz;
    ++s->rows;
  }
  return DMLC_TPU_OK;
}

}  // namespace

int ParseSvmSimdU32(const char* data, int64_t len, SvmSink<uint32_t>* s) {
  return ParseSvmSimdImpl<uint32_t>(data, len, s);
}
int ParseSvmSimdU64(const char* data, int64_t len, SvmSink<uint64_t>* s) {
  return ParseSvmSimdImpl<uint64_t>(data, len, s);
}

#else  // !DMLC_TPU_SIMD_X86

int ParseSvmSimdU32(const char*, int64_t, SvmSink<uint32_t>*) {
  return DMLC_TPU_EPARSE;  // unreachable: SimdKernelLevel() == 0
}
int ParseSvmSimdU64(const char*, int64_t, SvmSink<uint64_t>*) {
  return DMLC_TPU_EPARSE;
}

#endif  // DMLC_TPU_SIMD_X86

}  // namespace dmlc_tpu_parse
