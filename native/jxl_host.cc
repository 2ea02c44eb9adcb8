// Host-side native kernels for the libjxl_tpu codec runtime.
//
// The device (JAX/XLA on the GPU) handles everything pixel-parallel; these C kernels
// cover the inherently sequential per-stream work the host must do:
//   * rANS stream emission (reverse pass + LSB-first bit packing)
//     (reference semantics: lib/jxl/enc_ans.h:49-77, enc_ans.cc:1261-1320)
//   * rANS + hybrid-uint token decode for single-context streams
//     (lib/jxl/dec_ans.h:162-262)
//   * ClampedGradient scanline reconstruction (decode) — row-sequential
//     (lib/jxl/modular/encoding/encoding.cc:289-310)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <vector>

#include <cstdlib>
#include <algorithm>
#include <array>
#include <atomic>
#include <cmath>
#include <thread>
#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kAnsLogTabSize = 12;
constexpr uint32_t kAnsTabSize = 1u << kAnsLogTabSize;
constexpr uint32_t kAnsSignature = 0x13;

struct BitSink {
  uint8_t* out;
  int64_t cap;
  int64_t bitpos = 0;
  bool overflow = false;

  inline void Write(uint32_t nbits, uint64_t value) {
    if (nbits == 0) return;
    int64_t end = bitpos + nbits;
    if ((end + 7) / 8 > cap) {
      overflow = true;
      return;
    }
    // LSB-first append.
    int64_t byte = bitpos >> 3;
    int off = bitpos & 7;
    uint64_t v = value & ((nbits >= 64) ? ~0ull : ((1ull << nbits) - 1));
    // write up to 9 bytes
    uint64_t cur = v << off;
    int total = off + nbits;
    int n_bytes = (total + 7) / 8;
    for (int i = 0; i < n_bytes; i++) {
      out[byte + i] |= (uint8_t)(cur & 0xFF);
      cur >>= 8;
      if (i == 7 && total > 64) {
        // spilled beyond 64 bits of cur: handle the tail explicitly
        out[byte + 8] |= (uint8_t)(v >> (64 - off));
        break;
      }
    }
    bitpos = end;
  }
};

struct BitSource {
  const uint8_t* data;
  int64_t nbytes;
  int64_t bitpos;

  inline uint64_t Peek(int nbits) const {
    int64_t byte = bitpos >> 3;
    int off = bitpos & 7;
    uint64_t v = 0;
    int need = (off + nbits + 7) / 8;
    for (int i = 0; i < need && byte + i < nbytes; i++) {
      v |= (uint64_t)data[byte + i] << (8 * i);
    }
    v >>= off;
    return v & ((nbits >= 64) ? ~0ull : ((1ull << nbits) - 1));
  }

  inline uint64_t Read(int nbits) {
    uint64_t v = Peek(nbits);
    bitpos += nbits;
    return v;
  }
};

}  // namespace

// rANS-encode a pretokenized stream (single clustered context).
// tokens/nbits/bits: per-token arrays (length n).
// counts: normalized histogram (alphabet_size entries, sum 4096).
// start:  per-symbol slot-table offsets (alphabet_size+1).
// slots:  inverse alias mapping (4096): slot value for (symbol, offset).
// out:    byte buffer (must be zeroed), cap bytes.
// Returns total bits written, or -1 on overflow.
EXPORT int64_t jxlt_ans_encode_stream(
    const int32_t* tokens, const int32_t* nbits, const uint32_t* bits,
    int64_t n, const int32_t* counts, const int64_t* start,
    const int32_t* slots, uint8_t* out, int64_t cap) {
  // Reverse pass: collect emissions.
  std::vector<uint32_t> rev_bits;
  std::vector<uint8_t> rev_nbits;
  rev_bits.reserve(n + n / 8 + 8);
  rev_nbits.reserve(n + n / 8 + 8);
  uint32_t state = kAnsSignature << 16;
  for (int64_t i = n - 1; i >= 0; --i) {
    uint8_t nb = (uint8_t)nbits[i];
    if (nb) {
      rev_bits.push_back(bits[i]);
      rev_nbits.push_back(nb);
    }
    int32_t t = tokens[i];
    uint32_t freq = (uint32_t)counts[t];
    if ((state >> (32 - kAnsLogTabSize)) >= freq) {
      rev_bits.push_back(state & 0xFFFF);
      rev_nbits.push_back(16);
      state >>= 16;
    }
    state = ((state / freq) << kAnsLogTabSize) +
            (uint32_t)slots[start[t] + state % freq];
  }
  BitSink sink{out, cap};
  sink.Write(32, state);
  for (int64_t i = (int64_t)rev_bits.size() - 1; i >= 0; --i) {
    sink.Write(rev_nbits[i], rev_bits[i]);
  }
  if (sink.overflow) return -1;
  return sink.bitpos;
}

// Multi-context variant: per-token histogram ids with flattened
// per-histogram tables (counts/start at counts_off/start_off, slots at
// hist*4096). Same reverse-emission flow as jxlt_ans_encode_stream.
EXPORT int64_t jxlt_ans_encode_multi(
    const int32_t* tokens, const int32_t* histos, const int32_t* nbits,
    const uint32_t* bits, int64_t n, const int32_t* counts_flat,
    const int64_t* counts_off, const int64_t* start_flat,
    const int64_t* start_off, const int32_t* slots_flat, uint8_t* out,
    int64_t cap) {
  std::vector<uint32_t> rev_bits;
  std::vector<uint8_t> rev_nbits;
  rev_bits.reserve(n + n / 8 + 8);
  rev_nbits.reserve(n + n / 8 + 8);
  uint32_t state = kAnsSignature << 16;
  for (int64_t i = n - 1; i >= 0; --i) {
    uint8_t nb = (uint8_t)nbits[i];
    if (nb) {
      rev_bits.push_back(bits[i]);
      rev_nbits.push_back(nb);
    }
    int32_t h = histos[i];
    int32_t t = tokens[i];
    uint32_t freq = (uint32_t)counts_flat[counts_off[h] + t];
    if ((state >> (32 - kAnsLogTabSize)) >= freq) {
      rev_bits.push_back(state & 0xFFFF);
      rev_nbits.push_back(16);
      state >>= 16;
    }
    state = ((state / freq) << kAnsLogTabSize) +
            (uint32_t)slots_flat[(int64_t)h * kAnsTabSize +
                                 start_flat[start_off[h] + t] +
                                 state % freq];
  }
  BitSink sink{out, cap};
  sink.Write(32, state);
  for (int64_t i = (int64_t)rev_bits.size() - 1; i >= 0; --i) {
    sink.Write(rev_nbits[i], rev_bits[i]);
  }
  if (sink.overflow) return -1;
  return sink.bitpos;
}

// Decode `n` hybrid-uint values from a single-context ANS stream.
// alias_sym/alias_off: per-slot decode tables (4096 entries).
// freqs: per-symbol counts. cfg = (split_exponent, msb, lsb).
// Returns final bit position, or -1 if the final-state checksum fails,
// -2 on bounds overflow.
EXPORT int64_t jxlt_ans_decode_tokens(
    const uint8_t* data, int64_t nbytes, int64_t start_bit, int64_t n,
    const int32_t* alias_sym, const int32_t* alias_off, const int32_t* freqs,
    int32_t split_exponent, int32_t msb_in_token, int32_t lsb_in_token,
    uint32_t* out_values, int check_final, uint32_t* state_io) {
  BitSource src{data, nbytes, start_bit};
  uint32_t state = state_io ? *state_io : (uint32_t)src.Read(32);
  const uint32_t split_token = 1u << split_exponent;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t res = state & (kAnsTabSize - 1);
    uint32_t sym = (uint32_t)alias_sym[res];
    uint32_t off = (uint32_t)alias_off[res];
    state = (uint32_t)freqs[sym] * (state >> kAnsLogTabSize) + off;
    if (state < (1u << 16)) {
      state = (state << 16) | (uint32_t)src.Read(16);
    }
    uint32_t token = sym;
    uint32_t value;
    if (token < split_token) {
      value = token;
    } else {
      uint32_t nb = split_exponent - (msb_in_token + lsb_in_token) +
                    ((token - split_token) >> (msb_in_token + lsb_in_token));
      if (nb > 31) return -2;  // corrupt stream: reject, don't mask
      uint32_t low = token & ((1u << lsb_in_token) - 1);
      token >>= lsb_in_token;
      uint32_t extra = (uint32_t)src.Read(nb);
      value = ((((1u << msb_in_token) |
                 (token & ((1u << msb_in_token) - 1)))
                << nb) |
               extra)
                  << lsb_in_token |
              low;
    }
    out_values[i] = value;
  }
  if (src.bitpos > nbytes * 8) return -2;
  if (state_io) *state_io = state;
  if (check_final && state != (kAnsSignature << 16)) return -1;
  return src.bitpos;
}

static inline int32_t ClampedGradient(int32_t n, int32_t w, int32_t l) {
  const int32_t m = n < w ? n : w;
  const int32_t M = n < w ? w : n;
  const int32_t grad = (int32_t)((uint32_t)n + (uint32_t)w - (uint32_t)l);
  const int32_t grad_clamp_M = (l < m) ? M : grad;
  return (l > M) ? m : grad_clamp_M;
}

// Reconstruct pixels from zigzag residuals with the ClampedGradient
// predictor and modular edge rules, in place. values: packed uint32
// residual tokens in row-major order; out: int32 plane.
EXPORT void jxlt_gradient_reconstruct(const uint32_t* residuals, int64_t h,
                                      int64_t w, int32_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    int32_t* row = out + y * w;
    const int32_t* prev = row - w;
    for (int64_t x = 0; x < w; ++x) {
      uint32_t v = residuals[y * w + x];
      int32_t res = (v & 1) ? -(int32_t)(v >> 1) - 1 : (int32_t)(v >> 1);
      int32_t left = x ? row[x - 1] : (y ? prev[x] : 0);
      int32_t top = y ? prev[x] : left;
      int32_t topleft = (x && y) ? prev[x - 1] : left;
      row[x] = res + ClampedGradient(top, left, topleft);
    }
  }
}

// Forward gradient residuals (encode side host fallback).
EXPORT void jxlt_gradient_residuals(const int32_t* plane, int64_t h,
                                    int64_t w, uint32_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const int32_t* row = plane + y * w;
    const int32_t* prev = row - w;
    for (int64_t x = 0; x < w; ++x) {
      int32_t left = x ? row[x - 1] : (y ? prev[x] : 0);
      int32_t top = y ? prev[x] : left;
      int32_t topleft = (x && y) ? prev[x - 1] : left;
      int32_t res = row[x] - ClampedGradient(top, left, topleft);
      out[y * w + x] =
          (res >= 0) ? (uint32_t)res * 2 : (uint32_t)(-res) * 2 - 1;
    }
  }
}

EXPORT int64_t jxlt_version() { return 3; }

// Build the rANS alias table for one normalized histogram (the
// [0,4096) slot -> (symbol, offset) mapping; semantics of
// lib/jxl/ans_common.cc InitAliasTable, re-derived — the table is
// spec-defined so both sides must agree bit-for-bit).
//   counts:   int32[n_counts], sums to 4096 (trailing zeros allowed).
//   sym_out:  int32[4096], off_out: int32[4096],
//   freq_out: int32[1 << log_alpha_size].
// Returns 0, or -1 on invalid histogram.
EXPORT int64_t jxlt_build_alias_table(const int32_t* counts, int64_t n_counts,
                                      int32_t log_alpha_size,
                                      int32_t* sym_out, int32_t* off_out,
                                      int32_t* freq_out) {
  const int64_t table_size = (int64_t)1 << log_alpha_size;
  const int log_entry_size = kAnsLogTabSize - log_alpha_size;
  const int64_t entry_size = (int64_t)1 << log_entry_size;
  while (n_counts > 0 && counts[n_counts - 1] == 0) n_counts--;
  int64_t n = n_counts ? n_counts : 1;
  if (n > table_size) return -1;
  int32_t one[1] = {(int32_t)kAnsTabSize};
  const int32_t* dist = n_counts ? counts : one;
  int64_t total = 0;
  int64_t single = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (dist[i] < 0) return -1;
    total += dist[i];
    if (dist[i] == (int32_t)kAnsTabSize) single = i;
  }
  if (total != (int64_t)kAnsTabSize) return -1;
  for (int64_t i = 0; i < table_size; ++i)
    freq_out[i] = i < n ? dist[i] : 0;
  if (single >= 0) {
    for (int64_t v = 0; v < (int64_t)kAnsTabSize; ++v) {
      sym_out[v] = (int32_t)single;
      off_out[v] = (int32_t)v;
    }
    return 0;
  }
  // Robin-hood pairing of overfull/underfull buckets (stack order must
  // match the decoder's expectation exactly).
  std::vector<int64_t> cutoffs(table_size), right_value(table_size, 0),
      offsets1(table_size, 0);
  std::vector<int64_t> underfull, overfull;
  underfull.reserve(table_size);
  overfull.reserve(table_size);
  for (int64_t i = 0; i < n; ++i) {
    cutoffs[i] = dist[i];
    if (dist[i] > entry_size) overfull.push_back(i);
    else if (dist[i] < entry_size) underfull.push_back(i);
  }
  for (int64_t i = n; i < table_size; ++i) {
    cutoffs[i] = 0;
    underfull.push_back(i);
  }
  while (!overfull.empty()) {
    int64_t oi = overfull.back();
    overfull.pop_back();
    if (underfull.empty()) return -1;
    int64_t ui = underfull.back();
    underfull.pop_back();
    int64_t by = entry_size - cutoffs[ui];
    cutoffs[oi] -= by;
    right_value[ui] = oi;
    offsets1[ui] = cutoffs[oi];
    if (cutoffs[oi] < entry_size) underfull.push_back(oi);
    else if (cutoffs[oi] > entry_size) overfull.push_back(oi);
  }
  std::vector<int64_t> cutoff(table_size);
  for (int64_t i = 0; i < table_size; ++i) {
    if (cutoffs[i] == entry_size) {
      right_value[i] = i;
      offsets1[i] = 0;
      cutoff[i] = 0;
    } else {
      offsets1[i] -= cutoffs[i];
      cutoff[i] = cutoffs[i];
    }
  }
  for (int64_t v = 0; v < (int64_t)kAnsTabSize; ++v) {
    int64_t i = v >> log_entry_size;
    int64_t pos = v & (entry_size - 1);
    if (pos >= cutoff[i]) {
      sym_out[v] = (int32_t)right_value[i];
      off_out[v] = (int32_t)(offsets1[i] + pos);
    } else {
      sym_out[v] = (int32_t)i;
      off_out[v] = (int32_t)pos;
    }
  }
  return 0;
}

// Assemble a complete byte-aligned section: copy `prefix_nbits` header
// bits (LSB-first, from prefix_bytes), then splice chunks [c0, c1), then
// zero-pad to a byte boundary. Returns the section byte count or -1.
// This keeps per-section host work at memcpy speed — BitWriter python
// paths only handle the few global sections.
EXPORT int64_t jxlt_splice_section(const uint8_t* prefix_bytes,
                                   int64_t prefix_nbits,
                                   const uint32_t* words,
                                   const int64_t* word_start,
                                   const uint16_t* chunk_bits, int64_t c0,
                                   int64_t c1, uint8_t* out, int64_t cap) {
  uint64_t acc = 0;
  int accbits = 0;
  int64_t bytepos = 0;
  for (int64_t i = 0; i < prefix_nbits; i += 32) {
    int take = (int)((prefix_nbits - i < 32) ? prefix_nbits - i : 32);
    uint32_t v = 0;
    memcpy(&v, prefix_bytes + (i >> 3), (take + 7) >> 3);
    v &= (take == 32) ? 0xFFFFFFFFu : ((1u << take) - 1);
    acc |= (uint64_t)v << accbits;
    accbits += take;
    while (accbits >= 32) {
      if (bytepos + 4 > cap) return -1;
      memcpy(out + bytepos, &acc, 4);
      bytepos += 4;
      acc >>= 32;
      accbits -= 32;
    }
  }
  for (int64_t c = c0; c < c1; ++c) {
    const uint32_t* w = words + word_start[c];
    int64_t bits = chunk_bits[c];
    int64_t nw = bits >> 5;
    for (int64_t i = 0; i < nw; ++i) {
      acc |= (uint64_t)w[i] << accbits;
      if (bytepos + 4 > cap) return -1;
      memcpy(out + bytepos, &acc, 4);
      bytepos += 4;
      acc >>= 32;
    }
    int rem = (int)(bits & 31);
    if (rem) {
      uint32_t last = w[nw] & ((1u << rem) - 1);
      acc |= (uint64_t)last << accbits;
      accbits += rem;
      while (accbits >= 32) {
        if (bytepos + 4 > cap) return -1;
        memcpy(out + bytepos, &acc, 4);
        bytepos += 4;
        acc >>= 32;
        accbits -= 32;
      }
    }
  }
  while (accbits > 0) {  // zero-pad to byte boundary
    if (bytepos >= cap) return -1;
    out[bytepos++] = (uint8_t)(acc & 0xFF);
    acc >>= 8;
    accbits -= 8;
  }
  return bytepos;
}

// ---------------------------------------------------------------------------
// VarDCT AC group token decode (dec_group.cc DecodeACVarBlock:470-545).
//
// The per-coefficient rANS read chain is inherently sequential per
// section; this native pass turns a whole AC-group section into dense
// quantized coefficients so the (embarrassingly parallel) dequant + CfL
// + IDCT reconstruction can run batched on the device or in numpy. Context model
// constants from lib/jxl/ac_context.h.
// ---------------------------------------------------------------------------

namespace {

// kCoeffFreqContext / kCoeffNumNonzeroContext (ac_context.h:28-48)
static const uint8_t kCoeffFreqCtx[64] = {
    0xBA, 0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14,
    15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30};
static const uint8_t kCoeffNumNonzeroCtx[64] = {
    0xBA, 0,   31,  62,  62,  93,  93,  93,  93,  123, 123, 123, 123,
    152,  152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180,  180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206,  206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206,  206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206};

struct AnsDec {
  const uint8_t* data;
  int64_t nbytes;
  int64_t bitpos;
  uint32_t state;
  bool overflow = false;

  inline uint64_t Read(int nbits) {
    if (nbits == 0) return 0;
    int64_t byte = bitpos >> 3;
    if (byte + 9 > nbytes) {
      if ((bitpos + nbits + 7) / 8 > nbytes) {
        overflow = true;
        return 0;
      }
    }
    uint64_t v = 0;
    int64_t avail = nbytes - byte;
    memcpy(&v, data + byte, avail >= 8 ? 8 : avail);
    v >>= (bitpos & 7);
    bitpos += nbits;
    return v & ((nbits >= 64) ? ~0ull : ((1ull << nbits) - 1));
  }

  inline uint32_t ReadSym(const int32_t* alias_sym, const int32_t* alias_off,
                          const int32_t* freqs) {
    uint32_t res = state & (kAnsTabSize - 1);
    uint32_t sym = (uint32_t)alias_sym[res];
    uint32_t off = (uint32_t)alias_off[res];
    state = (uint32_t)freqs[sym] * (state >> kAnsLogTabSize) + off;
    if (state < (1u << 16)) {
      state = (state << 16) | (uint32_t)Read(16);
    }
    return sym;
  }
};

}  // namespace

namespace {

// Shared per-group AC token decode body (dec_group.cc
// DecodeACVarBlock:470-545 semantics). Strided so it can read a group
// window out of frame-level acs/anchor/block_ctx3 arrays.
//   stride:     row stride of acs/anchor (and block_ctx3 rows)
//   bc_plane:   channel-plane stride of block_ctx3
//   dense_out:  if nonzero, out_coeffs is a frame-dense buffer: block
//               (c, by, bx) writes at c*out_cstride + (by*out_rstride)
//               + bx*64 + pos (all relative to the group-origin base
//               pointer the caller passes). Otherwise run-packed:
//               qc = out + c*plane + coff.
// Returns end bit position (>=0) or a negative error:
//   -1 checksum, -2 corrupt token, -3 invalid nzeros, -4 overrun.
static int64_t AcGroupDecodeImpl(
    const uint8_t* data, int64_t nbytes, int64_t start_bit,
    const int32_t* alias_sym, const int32_t* alias_off,
    const int32_t* freqs, const int32_t* uint_cfg,
    const int32_t* ctx_map, int64_t n_ctx, int32_t ctx_offset,
    const int32_t* block_ctx3, int64_t bc_plane,
    const int8_t* acs_raw, const uint8_t* anchor, int64_t stride,
    const uint8_t* cov_x, const uint8_t* cov_y, const uint8_t* log2cov,
    const int32_t* orders, const int64_t* order_off,
    const uint8_t* strat_ord, int32_t num_ctxs, int64_t gwb, int64_t ghb,
    int32_t check_final, int32_t shift, int32_t* out_coeffs,
    int32_t accumulate, int32_t dense_out, int64_t out_cstride,
    int64_t out_rstride, int32_t* sp_idx = nullptr,
    int32_t* sp_val = nullptr, int64_t sp_cap = 0,
    int64_t* sp_n = nullptr, int64_t base_flat = 0) {
  AnsDec dec{data, nbytes, start_bit, 0};
  dec.state = (uint32_t)dec.Read(32);
  std::vector<int32_t> nz(3 * ghb * gwb, 0);
  int64_t coff = 0;  // running coefficient offset (same for all channels)
  const int64_t plane = gwb * ghb * 64;
  for (int64_t by = 0; by < ghb; ++by) {
    for (int64_t bx = 0; bx < gwb; ++bx) {
      if (!anchor[by * stride + bx]) continue;
      int strat = acs_raw[by * stride + bx];
      if (strat < 0 || strat >= 27) return -2;
      int cx = cov_x[strat], cy = cov_y[strat], l2 = log2cov[strat];
      int covered = cx * cy;
      int size = covered * 64;
      int ord_b = strat_ord[strat];
      static const int kChanOrder[3] = {1, 0, 2};
      for (int ci = 0; ci < 3; ++ci) {
        int c = kChanOrder[ci];
        // nzeros prediction from top/left neighbors
        int32_t* nzp = nz.data() + c * ghb * gwb;
        int predicted;
        if (bx == 0) {
          predicted = by > 0 ? nzp[(by - 1) * gwb + bx] : 32;
        } else if (by == 0) {
          predicted = nzp[by * gwb + bx - 1];
        } else {
          predicted =
              (nzp[(by - 1) * gwb + bx] + nzp[by * gwb + bx - 1] + 1) / 2;
        }
        if (predicted > 64) predicted = 64;
        int block_ctx = block_ctx3[c * bc_plane + by * stride + bx];
        int nz_small = predicted < 8 ? predicted : 4 + predicted / 2;
        int64_t nzero_ctx =
            ctx_offset + nz_small * num_ctxs + block_ctx;
        if (nzero_ctx >= n_ctx) return -2;
        // --- read hybrid uint helper (clustered) ---
        auto read_uint = [&](int64_t ctx) -> int64_t {
          int h = ctx_map[ctx];
          uint32_t tok = dec.ReadSym(alias_sym + (int64_t)h * 4096,
                                     alias_off + (int64_t)h * 4096,
                                     freqs + (int64_t)h * 256);
          int split_exp = uint_cfg[h * 3], msb = uint_cfg[h * 3 + 1],
              lsb = uint_cfg[h * 3 + 2];
          uint32_t split = 1u << split_exp;
          if (tok < split) return tok;
          uint32_t nb =
              split_exp - (msb + lsb) + ((tok - split) >> (msb + lsb));
          if (nb > 31) return -2;
          uint32_t low = tok & ((1u << lsb) - 1);
          uint32_t t2 = tok >> lsb;
          uint32_t extra = (uint32_t)dec.Read((int)nb);
          return (int64_t)((((((1u << msb) | (t2 & ((1u << msb) - 1)))
                              << nb) |
                             extra)
                            << lsb) |
                           low);
        };
        int64_t nzeros = read_uint(nzero_ctx);
        if (nzeros < 0 || nzeros > size - covered) return -3;
        int nzv = (int)((nzeros + covered - 1) >> l2);
        for (int iy = 0; iy < cy; ++iy)
          for (int ix = 0; ix < cx; ++ix)
            nzp[(by + iy) * gwb + bx + ix] = nzv;
        int64_t histo_off =
            ctx_offset + num_ctxs * 37 + 458 * block_ctx;
        const int32_t* order = orders + order_off[ord_b * 3 + c];
        int prev = nzeros > size / 16 ? 0 : 1;
        int32_t* qc = sp_idx != nullptr ? nullptr
            : dense_out
            ? out_coeffs + c * out_cstride + by * out_rstride + bx * 64
            : out_coeffs + c * plane + coff;
        for (int k = covered; k < size && nzeros != 0; ++k) {
          // zero_density_context (ac_context.h:52-63)
          int nzl = (int)((nzeros + covered - 1) >> l2);
          int kk = k >> l2;
          int64_t ctx = histo_off +
                        (kCoeffNumNonzeroCtx[nzl] + kCoeffFreqCtx[kk]) * 2 +
                        prev;
          if (ctx >= n_ctx) return -2;
          int64_t u = read_uint(ctx);
          if (u < 0) return -2;
          // unpack_signed
          int32_t coeff = (u & 1) ? -(int32_t)((uint64_t)u >> 1) - 1
                                  : (int32_t)((uint64_t)u >> 1);
          int64_t pos = order[k];
          if (pos < 0 || pos >= size) return -2;
          if (sp_idx != nullptr) {
            // sparse emission: record the frame-dense flat index +
            // value as it decodes (saves the full dense write + the
            // sparsify rescan — ~2x the memory traffic of this stage)
            if (coeff != 0) {
              if (*sp_n >= sp_cap) return -5;
              sp_idx[*sp_n] = (int32_t)(base_flat + c * out_cstride +
                                        by * out_rstride + bx * 64 + pos);
              sp_val[*sp_n] = coeff << shift;
              ++*sp_n;
            }
          } else if (accumulate)
            qc[pos] += coeff << shift;
          else
            qc[pos] = coeff << shift;
          prev = u != 0;
          nzeros -= prev;
        }
        if (nzeros != 0) return -3;
      }
      coff += size;
    }
  }
  if (dec.overflow) return -4;
  if (check_final && dec.state != (kAnsSignature << 16)) return -1;
  return dec.bitpos;
}

}  // namespace

// Single-group AC token decode (original entry point; see
// AcGroupDecodeImpl for parameter semantics). Group-local arrays:
// acs/anchor are (ghb, gwb), block_ctx3 is (3, ghb, gwb), output is
// run-packed (3, gwb*ghb*64).
EXPORT int64_t jxlt_ac_group_decode(
    const uint8_t* data, int64_t nbytes, int64_t start_bit,
    const int32_t* alias_sym, const int32_t* alias_off,
    const int32_t* freqs, const int32_t* uint_cfg,
    const int32_t* ctx_map, int64_t n_ctx, int32_t ctx_offset,
    const int32_t* block_ctx3, const int8_t* acs_raw,
    const uint8_t* anchor, const uint8_t* cov_x, const uint8_t* cov_y,
    const uint8_t* log2cov, const int32_t* orders,
    const int64_t* order_off, const uint8_t* strat_ord, int32_t num_ctxs,
    int64_t gwb, int64_t ghb, int32_t check_final, int32_t shift,
    int32_t* out_coeffs, int32_t accumulate) {
  return AcGroupDecodeImpl(
      data, nbytes, start_bit, alias_sym, alias_off, freqs, uint_cfg,
      ctx_map, n_ctx, ctx_offset, block_ctx3, ghb * gwb, acs_raw, anchor,
      gwb, cov_x, cov_y, log2cov, orders, order_off, strat_ord, num_ctxs,
      gwb, ghb, check_final, shift, out_coeffs, accumulate,
      /*dense_out=*/0, 0, 0);
}

// Decode ALL AC-group sections of one pass concurrently (the
// dec_frame.cc:726 RunOnPool-over-groups analog: std::thread over the
// per-group byte ranges; each group's rANS stream is independent by
// format design, doc/format_overview.md:180-193).
//
//   data:        the whole frame byte buffer
//   sec_off/len: per-group byte ranges of the AC sections
//   start_bit:   per-group initial bit offset inside its section
//   gx0/gy0/gw/gh: per-group block-space rects
//   block_ctx3:  (3, fhb, fwb) frame-level block contexts
//   acs/anchor:  (fhb, fwb) frame-level strategy/anchor planes
//   selector_bits: histogram-selector width; read per group here
//   out:         run-packed per group at out + out_off[g] (3, gw*gh*64)
//   end_bits:    per-group end bit position or negative error code
// Returns 0 if every group decoded, else the first error code.
EXPORT int64_t jxlt_ac_frame_decode(
    const uint8_t* data, const int64_t* sec_off, const int64_t* sec_len,
    const int64_t* start_bit, int64_t n_groups, const int64_t* gx0,
    const int64_t* gy0, const int64_t* gw, const int64_t* gh,
    const int32_t* alias_sym, const int32_t* alias_off,
    const int32_t* freqs, const int32_t* uint_cfg,
    const int32_t* ctx_map, int64_t n_ctx, int32_t selector_bits,
    int32_t num_histograms, int32_t num_ac_ctxs,
    const int32_t* block_ctx3, int64_t fwb, int64_t fhb,
    const int8_t* acs_raw, const uint8_t* anchor, const uint8_t* cov_x,
    const uint8_t* cov_y, const uint8_t* log2cov, const int32_t* orders,
    const int64_t* order_off, const uint8_t* strat_ord, int32_t num_ctxs,
    int32_t check_final, int32_t shift, int32_t* out,
    const int64_t* out_off, int32_t accumulate, int32_t n_threads,
    int64_t* end_bits, int32_t dense_out, int64_t out_cstride,
    int64_t out_rstride, int32_t* sp_idx, int32_t* sp_val,
    int64_t sp_cap_per_group, int64_t* sp_counts) {
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> err(0);
  auto worker = [&]() {
    for (;;) {
      int64_t g = next.fetch_add(1);
      if (g >= n_groups) return;
      const uint8_t* sdata = data + sec_off[g];
      int64_t nbytes = sec_len[g];
      // Histogram selector precedes the ANS state (dec_frame.cc:481).
      AnsDec sel_rd{sdata, nbytes, start_bit[g], 0};
      int64_t sel =
          selector_bits ? (int64_t)sel_rd.Read(selector_bits) : 0;
      if (sel_rd.overflow || sel >= num_histograms) {
        end_bits[g] = -4;
        err.store(-4);
        continue;
      }
      int64_t base = gy0[g] * fwb + gx0[g];
      int32_t* g_sp_idx = sp_idx ? sp_idx + g * sp_cap_per_group : nullptr;
      int32_t* g_sp_val = sp_val ? sp_val + g * sp_cap_per_group : nullptr;
      int64_t g_sp_n = 0;
      int64_t res = AcGroupDecodeImpl(
          sdata, nbytes, sel_rd.bitpos, alias_sym, alias_off, freqs,
          uint_cfg, ctx_map, n_ctx, (int32_t)(sel * num_ac_ctxs),
          block_ctx3 + base, fhb * fwb, acs_raw + base, anchor + base,
          fwb, cov_x, cov_y, log2cov, orders, order_off, strat_ord,
          num_ctxs, gw[g], gh[g], check_final, shift,
          sp_idx ? nullptr : out + out_off[g],
          accumulate, dense_out, out_cstride, out_rstride, g_sp_idx,
          g_sp_val, sp_cap_per_group, sp_idx ? &g_sp_n : nullptr,
          sp_idx ? out_off[g] : 0);
      if (sp_counts) sp_counts[g] = g_sp_n;
      end_bits[g] = res;
      if (res < 0) err.store(res);
    }
  };
  int nt = (int)(n_threads < n_groups ? n_threads : n_groups);
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int i = 0; i < nt; ++i) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return err.load();
}

// Compact a dense int32 buffer into (index, value) pairs, threaded
// over chunks (two-pass: count then fill; replaces np.flatnonzero on
// the decode hot path — the sparse coefficient upload format of
// models/vardct_decode.FrameRecon). Returns total nonzero count.
// out_idx/out_val must hold >= n entries.
EXPORT int64_t jxlt_sparsify_i32(const int32_t* buf, int64_t n,
                                 int32_t n_threads, int32_t* out_idx,
                                 int32_t* out_val) {
  int nt = n_threads < 1 ? 1 : n_threads;
  if ((int64_t)nt > n / 65536 + 1) nt = (int)(n / 65536 + 1);
  std::vector<int64_t> counts(nt, 0);
  const int64_t chunk = (n + nt - 1) / nt;
  auto count_fn = [&](int t) {
    int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    int64_t c = 0;
    for (int64_t i = lo; i < hi; ++i) c += buf[i] != 0;
    counts[t] = c;
  };
  auto fill_fn = [&](int t, int64_t base) {
    int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    for (int64_t i = lo; i < hi; ++i) {
      if (buf[i] != 0) {
        out_idx[base] = (int32_t)i;
        out_val[base] = buf[i];
        ++base;
      }
    }
  };
  if (nt == 1) {
    count_fn(0);
    fill_fn(0, 0);
    return counts[0];
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(count_fn, t);
  for (auto& th : threads) th.join();
  threads.clear();
  int64_t base = 0;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back(fill_fn, t, base);
    base += counts[t];
  }
  for (auto& th : threads) th.join();
  return base;
}

// Paint the AC-strategy / quant-field / sharpness planes for one DC
// group from the decoded AC-metadata channels (frame_dec.py
// _decode_ac_metadata raster loop; dec_modular.cc DecodeAcMetadata).
// Returns consumed strategy count, or -1 on corrupt data.
EXPORT int64_t jxlt_acs_paint(const int32_t* acs_vals,
                              const int32_t* qf_vals, int64_t count,
                              const int32_t* sharp, int64_t bw, int64_t bh,
                              int64_t gdb, const uint8_t* cov_x,
                              const uint8_t* cov_y, int32_t* acs_out,
                              int32_t* qf_out, uint8_t* anchor_out,
                              int32_t* sharp_out) {
  int64_t num = 0;
  for (int64_t y = 0; y < bh; ++y) {
    for (int64_t x = 0; x < bw; ++x) {
      int s = sharp[y * bw + x];
      if (s < 0 || s >= 8) return -1;
      sharp_out[y * bw + x] = s;
      if (acs_out[y * bw + x] >= 0) continue;
      if (num >= count) return -1;
      int raw = acs_vals[num];
      if (raw < 0 || raw >= 27) return -1;
      int cx = cov_x[raw], cy = cov_y[raw];
      if ((x % gdb) + cx > gdb || (y % gdb) + cy > gdb) return -1;
      if (x + cx > bw || y + cy > bh) return -1;
      int qf = qf_vals[num];
      qf = 1 + (qf < 0 ? 0 : (qf > 255 ? 255 : qf));
      for (int64_t iy = 0; iy < cy; ++iy)
        for (int64_t ix = 0; ix < cx; ++ix) {
          acs_out[(y + iy) * bw + x + ix] = raw;
          qf_out[(y + iy) * bw + x + ix] = qf;
        }
      anchor_out[y * bw + x] = 1;
      ++num;
    }
  }
  return num;
}

// Prefix-encode one group's packed residuals straight into a complete
// byte-aligned section (header bits + tokens + pad). Used when the
// raw residual download (1 B/px) is smaller than the device-packed
// stream (content above ~8 bpp): the device computes
// residuals + histogram, the host entropy-codes. Same canonical code /
// bitstream as the device pack path. Hybrid-uint cfg (4,2,0).
EXPORT int64_t jxlt_prefix_encode_group(
    const void* packed, int32_t elem_size, int64_t nch, int64_t gd,
    int64_t gw, int64_t gh, const uint32_t* lut_bits,
    const int32_t* lut_len, const uint8_t* prefix_bytes,
    int64_t prefix_nbits, uint8_t* out, int64_t cap) {
  uint64_t acc = 0;
  int accbits = 0;
  int64_t bytepos = 0;
#define FLUSH32()                        \
  while (accbits >= 32) {                \
    if (bytepos + 4 > cap) return -1;    \
    memcpy(out + bytepos, &acc, 4);      \
    bytepos += 4;                        \
    acc >>= 32;                          \
    accbits -= 32;                       \
  }
  for (int64_t i = 0; i < prefix_nbits; i += 32) {
    int take = (int)((prefix_nbits - i < 32) ? prefix_nbits - i : 32);
    uint32_t v = 0;
    memcpy(&v, prefix_bytes + (i >> 3), (take + 7) >> 3);
    v &= (take == 32) ? 0xFFFFFFFFu : ((1u << take) - 1);
    acc |= (uint64_t)v << accbits;
    accbits += take;
    FLUSH32();
  }
  for (int64_t c = 0; c < nch; ++c) {
    for (int64_t y = 0; y < gh; ++y) {
      const uint8_t* row8 =
          (const uint8_t*)packed + (c * gd + y) * gd * elem_size;
      for (int64_t x = 0; x < gw; ++x) {
        uint32_t v;
        if (elem_size == 1) {
          v = row8[x];
        } else if (elem_size == 2) {
          v = ((const uint16_t*)row8)[x];
        } else {
          v = ((const uint32_t*)row8)[x];
        }
        uint32_t token, nbits, raw;
        if (v < 16) {
          token = v;
          nbits = 0;
          raw = 0;
        } else {
          uint32_t n = 31 - __builtin_clz(v);
          nbits = n - 2;
          token = 16 + ((n - 4) << 2) + ((v >> nbits) & 3);
          raw = v & ((1u << nbits) - 1);
        }
        uint32_t clen = (uint32_t)lut_len[token];
        acc |= (uint64_t)(lut_bits[token] | (raw << clen)) << accbits;
        accbits += (int)(clen + nbits);
        FLUSH32();
      }
    }
  }
  while (accbits > 0) {
    if (bytepos >= cap) return -1;
    out[bytepos++] = (uint8_t)(acc & 0xFF);
    acc >>= 8;
    accbits -= 8;
  }
#undef FLUSH32
  return bytepos;
}

// Splice word-aligned packed chunks into one continuous LSB-first
// bitstream. The device packs each T-token chunk into its own
// word-aligned run (libjxl_tpu/models/lossless.py chunk_pack_device); the host
// concatenates them bit-exactly at memcpy-class speed. ``words`` holds the
// compacted stream (chunk i occupies words[word_start[i] ..
// word_start[i] + ceil(bits[i]/32))); returns total bits written or -1
// on overflow. Mirrors the byte-assembly role of WriteTokens
// (lib/jxl/enc_ans.cc:1237) with the entropy work already done on device.
EXPORT int64_t jxlt_splice_chunks(const uint32_t* words,
                                  const int64_t* word_start,
                                  const uint16_t* chunk_bits, int64_t c0,
                                  int64_t c1, uint8_t* out, int64_t cap) {
  uint64_t acc = 0;
  int accbits = 0;
  int64_t bytepos = 0;
  for (int64_t c = c0; c < c1; ++c) {
    const uint32_t* w = words + word_start[c];
    int64_t bits = chunk_bits[c];
    int64_t nw = bits >> 5;
    for (int64_t i = 0; i < nw; ++i) {
      acc |= (uint64_t)w[i] << accbits;
      if (bytepos + 4 > cap) return -1;
      memcpy(out + bytepos, &acc, 4);
      bytepos += 4;
      acc >>= 32;
    }
    int rem = bits & 31;
    if (rem) {
      uint32_t last = w[nw] & ((1u << rem) - 1);
      acc |= (uint64_t)last << accbits;
      accbits += rem;
      while (accbits >= 32) {
        if (bytepos + 4 > cap) return -1;
        memcpy(out + bytepos, &acc, 4);
        bytepos += 4;
        acc >>= 32;
        accbits -= 32;
      }
    }
  }
  int64_t total_bits = bytepos * 8 + accbits;
  while (accbits > 0) {
    if (bytepos >= cap) return -1;
    out[bytepos++] = (uint8_t)(acc & 0xFF);
    acc >>= 8;
    accbits -= 8;
  }
  return total_bits;
}

// ---------------------------------------------------------------------------
// One-shot lossless group stream: hybrid-uint tokenize (split=4, msb=2,
// lsb=0 — the default HybridUintConfig) + reverse-pass rANS + LSB-first
// bit packing, all in a single call over the group's valid rectangle.
// Mirrors enc_ans.cc WriteTokens for one clustered context.
// ---------------------------------------------------------------------------
EXPORT int64_t jxlt_lossless_group_encode(
    const void* packed_v, int32_t elem_bytes, int64_t nch, int64_t gd,
    int64_t gw, int64_t gh, const int32_t* counts, const int64_t* start,
    const int32_t* slots, uint8_t* out, int64_t cap) {
  const int64_t n = nch * gw * gh;
  std::vector<int32_t> tokens(n);
  std::vector<uint8_t> tnbits(n);
  std::vector<uint32_t> tbits(n);
  int64_t k = 0;
  for (int64_t c = 0; c < nch; ++c) {
    for (int64_t y = 0; y < gh; ++y) {
      const int64_t row = (c * gd + y) * gd;
      for (int64_t x = 0; x < gw; ++x) {
        uint32_t v = (elem_bytes == 1)
                         ? ((const uint8_t*)packed_v)[row + x]
                         : (elem_bytes == 2)
                               ? ((const uint16_t*)packed_v)[row + x]
                               : ((const uint32_t*)packed_v)[row + x];
        if (v < 16) {
          tokens[k] = (int32_t)v;
          tnbits[k] = 0;
          tbits[k] = 0;
        } else {
          int nbit = 31 - __builtin_clz(v);
          int nb = nbit - 2;
          tokens[k] = 16 + ((nbit - 4) << 2) +
                      (int32_t)((v - (1u << nbit)) >> nb);
          tnbits[k] = (uint8_t)nb;
          tbits[k] = v & ((1u << nb) - 1);
        }
        ++k;
      }
    }
  }
  // Reverse rANS pass (same flow as jxlt_ans_encode_stream).
  std::vector<uint32_t> rev_bits;
  std::vector<uint8_t> rev_nbits;
  rev_bits.reserve(n + n / 8 + 8);
  rev_nbits.reserve(n + n / 8 + 8);
  uint32_t state = kAnsSignature << 16;
  for (int64_t i = n - 1; i >= 0; --i) {
    if (tnbits[i]) {
      rev_bits.push_back(tbits[i]);
      rev_nbits.push_back(tnbits[i]);
    }
    int32_t t = tokens[i];
    uint32_t freq = (uint32_t)counts[t];
    if ((state >> (32 - kAnsLogTabSize)) >= freq) {
      rev_bits.push_back(state & 0xFFFF);
      rev_nbits.push_back(16);
      state >>= 16;
    }
    state = ((state / freq) << kAnsLogTabSize) +
            (uint32_t)slots[start[t] + state % freq];
  }
  BitSink sink{out, cap};
  sink.Write(32, state);
  for (int64_t i = (int64_t)rev_bits.size() - 1; i >= 0; --i) {
    sink.Write(rev_nbits[i], rev_bits[i]);
  }
  if (sink.overflow) return -1;
  return sink.bitpos;
}

// Pack variable-length LSB-first codes into bytes (BitWriter::to_bytes).
EXPORT int64_t jxlt_pack_bits(const int64_t* nbits, const uint64_t* values,
                              int64_t n, uint8_t* out, int64_t cap) {
  BitSink sink{out, cap};
  for (int64_t i = 0; i < n; ++i) {
    sink.Write((uint32_t)nbits[i], values[i]);
  }
  if (sink.overflow) return -1;
  return sink.bitpos;
}

// ---------------------------------------------------------------------------
// Weighted predictor sweep over a whole plane: outputs the WP prediction
// and the WP error property (p15) per pixel (context_predict.h State,
// default WPHeader). Used by the encoder's tree learner/tokenizer.
// ---------------------------------------------------------------------------
namespace {
struct WpConsts {
  // default WPHeader (context_predict.h:28-61)
  int p1C = 16, p2C = 10, p3Ca = 7, p3Cb = 7, p3Cc = 7, p3Cd = 0, p3Ce = 0;
  int w[4] = {13, 12, 12, 12};
};
static inline int FloorLog2(uint64_t x) { return 63 - __builtin_clzll(x); }
}  // namespace

EXPORT void jxlt_wp_plane(const int32_t* plane, int64_t w, int64_t h,
                          const int32_t* hdr9, int32_t* out_pred,
                          int32_t* out_prop) {
  static int64_t divlookup[64];
  for (int i = 0; i < 64; i++) divlookup[i] = (1ll << 24) / (i + 1);
  const int kBits = 3;
  const int kRound = ((1 << kBits) >> 1) - 1;
  WpConsts c;
  if (hdr9) {
    c.p1C = hdr9[0]; c.p2C = hdr9[1]; c.p3Ca = hdr9[2]; c.p3Cb = hdr9[3];
    c.p3Cc = hdr9[4]; c.p3Cd = hdr9[5]; c.p3Ce = hdr9[6];
    c.w[0] = hdr9[7]; c.w[1] = hdr9[8]; c.w[2] = hdr9[9];
    c.w[3] = hdr9[10];
  }
  std::vector<int64_t> pred_errors[4];
  std::vector<int64_t> error((w + 2) * 2, 0);
  for (int i = 0; i < 4; i++) pred_errors[i].assign((w + 2) * 2, 0);
  int64_t prediction[4];

  for (int64_t y = 0; y < h; y++) {
    int64_t cur_row = (y & 1) ? 0 : (w + 2);
    int64_t prev_row = (y & 1) ? (w + 2) : 0;
    for (int64_t x = 0; x < w; x++) {
      // neighbors with border rules
      int64_t left = x ? plane[y * w + x - 1]
                       : (y ? plane[(y - 1) * w + x] : 0);
      int64_t top = y ? plane[(y - 1) * w + x] : left;
      int64_t topleft = (x && y) ? plane[(y - 1) * w + x - 1] : left;
      int64_t topright = (x + 1 < w && y) ? plane[(y - 1) * w + x + 1] : top;
      int64_t toptop = y > 1 ? plane[(y - 2) * w + x] : top;

      int64_t pos_n = prev_row + x;
      int64_t pos_ne = x < w - 1 ? pos_n + 1 : pos_n;
      int64_t pos_nw = x > 0 ? pos_n - 1 : pos_n;
      int64_t weights[4];
      for (int i = 0; i < 4; i++) {
        int64_t werr = (uint32_t)(pred_errors[i][pos_n] +
                                  pred_errors[i][pos_ne] +
                                  pred_errors[i][pos_nw]);
        int shift = FloorLog2(werr + 1) - 5;
        if (shift < 0) shift = 0;
        weights[i] = 4 + ((c.w[i] * divlookup[werr >> shift]) >> shift);
      }
      int64_t N = top << kBits, W = left << kBits, NE = topright << kBits;
      int64_t NW = topleft << kBits, NN = toptop << kBits;
      int64_t teW = x == 0 ? 0 : error[cur_row + x - 1];
      int64_t teN = error[pos_n];
      int64_t teNW = error[pos_nw];
      int64_t teNE = error[pos_ne];
      int64_t sumWN = teN + teW;
      // property: max-abs of the tracked errors
      int64_t p = teW;
      if (std::llabs(teN) > std::llabs(p)) p = teN;
      if (std::llabs(teNW) > std::llabs(p)) p = teNW;
      if (std::llabs(teNE) > std::llabs(p)) p = teNE;
      out_prop[y * w + x] = (int32_t)p;
      prediction[0] = W + NE - N;
      prediction[1] = N - (((sumWN + teNE) * c.p1C) >> 5);
      prediction[2] = W - (((sumWN + teNW) * c.p2C) >> 5);
      prediction[3] =
          N - ((teNW * c.p3Ca + teN * c.p3Cb + teNE * c.p3Cc +
                (NN - N) * c.p3Cd + (NW - W) * c.p3Ce) >> 5);
      int64_t weight_sum = weights[0] + weights[1] + weights[2] + weights[3];
      int log_weight = FloorLog2(weight_sum);
      for (int i = 0; i < 4; i++) weights[i] >>= (log_weight - 4);
      weight_sum = weights[0] + weights[1] + weights[2] + weights[3];
      int64_t s = (weight_sum >> 1) - 1;
      for (int i = 0; i < 4; i++) s += prediction[i] * weights[i];
      int64_t pred = (s * divlookup[weight_sum - 1]) >> 24;
      if (((teN ^ teW) | (teN ^ teNW)) <= 0) {
        int64_t mx = std::max(W, std::max(NE, N));
        int64_t mn = std::min(W, std::min(NE, N));
        pred = std::max(mn, std::min(mx, pred));
      }
      out_pred[y * w + x] = (int32_t)((pred + kRound) >> kBits);
      // update errors with the true value
      int64_t val = ((int64_t)plane[y * w + x]) << kBits;
      error[cur_row + x] = (int32_t)(pred - val);
      for (int i = 0; i < 4; i++) {
        int64_t err = (std::llabs(prediction[i] - val) + kRound) >> kBits;
        pred_errors[i][cur_row + x] = (uint32_t)err;
        pred_errors[i][prev_row + x + 1] =
            (uint32_t)(pred_errors[i][prev_row + x + 1] + err);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// LZ77 match parsing for token streams (greedy + one-symbol lazy match,
// hash-chain candidate search; reference algorithm: enc_lz77.cc:439-545
// ApplyLZ77_LZ77 / HashChain). The caller passes per-symbol literal bit
// costs as a prefix-sum; we accept a match when the copy is estimated
// cheaper than re-emitting the literals. Distances are reported as JXL
// distance-token VALUES (special-distance index when the distance is in
// the caller-provided special table, else nspecial + dist - 1 —
// dec_ans.h:216-226 inverse).
// ---------------------------------------------------------------------------
namespace {

struct Lz77Matcher {
  const uint32_t* v;
  int64_t n;
  int64_t wsize, wmask;
  int64_t min_len;

  static constexpr uint32_t kHashSize = 1u << 15;
  static constexpr uint32_t kHashMask = kHashSize - 1;
  static constexpr uint32_t kMaxChain = 256;

  std::vector<int32_t> head;       // hash -> most recent window pos
  std::vector<uint32_t> chain;     // window pos -> previous same-hash pos
  std::vector<int32_t> hval;       // window pos -> hash stored there
  // zero-run acceleration (runs of value 0 all hash alike)
  std::vector<int32_t> headz;
  std::vector<uint32_t> chainz;
  std::vector<uint32_t> zrun;
  uint32_t numzeros = 0;
  // actual distance -> special-distance index (smallest index wins)
  std::vector<std::pair<int32_t, int32_t>> special_sorted;
  int64_t nspecial;

  Lz77Matcher(const uint32_t* vals, int64_t count, int64_t window,
              int64_t minl, const int32_t* special, int64_t ns)
      : v(vals), n(count), wsize(window), wmask(window - 1), min_len(minl),
        head(kHashSize, -1), chain(window), hval(window, -1),
        headz(window + 1, -1), chainz(window), zrun(window), nspecial(ns) {
    for (int64_t i = 0; i < window; ++i) chain[i] = (uint32_t)i;
    for (int64_t i = 0; i < window; ++i) chainz[i] = (uint32_t)i;
    for (int64_t i = ns - 1; i >= 0; --i)
      special_sorted.emplace_back(special[i], (int32_t)i);
    std::stable_sort(special_sorted.begin(), special_sorted.end(),
                     [](const auto& a, const auto& b) {
                       return a.first < b.first ||
                              (a.first == b.first && a.second < b.second);
                     });
    // keep only the smallest index per distance
    auto last = std::unique(special_sorted.begin(), special_sorted.end(),
                            [](const auto& a, const auto& b) {
                              return a.first == b.first;
                            });
    special_sorted.erase(last, special_sorted.end());
  }

  inline uint32_t Hash(int64_t pos) const {
    if (pos + 2 >= n) return 0;  // 2-token tail can never reach min_len 3
    uint32_t h = v[pos] ^ (v[pos + 1] << 5) ^ (v[pos + 2] << 10);
    return h & kHashMask;
  }

  inline uint32_t ZerosAt(int64_t pos, uint32_t prev) const {
    int64_t end = std::min(pos + wsize, n);
    if (prev > 0) {
      if (prev >= (uint32_t)wmask && v[end - 1] == 0 && end == pos + wsize)
        return prev;
      return prev - 1;
    }
    uint32_t z = 0;
    while (pos + z < end && v[pos + z] == 0) z++;
    return z;
  }

  void Insert(int64_t pos) {
    uint32_t h = Hash(pos);
    uint32_t wp = (uint32_t)(pos & wmask);
    hval[wp] = (int32_t)h;
    if (head[h] != -1) chain[wp] = (uint32_t)head[h];
    head[h] = (int32_t)wp;
    if (pos > 0 && v[pos] != v[pos - 1]) numzeros = 0;
    numzeros = ZerosAt(pos, numzeros);
    zrun[wp] = numzeros;
    if (headz[numzeros] != -1) chainz[wp] = (uint32_t)headz[numzeros];
    headz[numzeros] = (int32_t)wp;
  }

  inline int32_t DistSymbol(int64_t dist) const {
    auto it = std::lower_bound(
        special_sorted.begin(), special_sorted.end(),
        std::make_pair((int32_t)dist, (int32_t)-1));
    if (it != special_sorted.end() && it->first == (int32_t)dist)
      return it->second;
    return (int32_t)(nspecial + dist - 1);
  }

  // best (len, dist_symbol) at pos; len < min_len when nothing found
  void Best(int64_t pos, int64_t* out_len, int64_t* out_sym) const {
    *out_len = 1;
    *out_sym = 0;
    uint32_t wp = (uint32_t)(pos & wmask);
    uint32_t hp = chain[wp];
    uint32_t h = Hash(pos);
    int64_t end = std::min(pos + n, n);  // max_length = stream length
    int64_t prev_dist = 0;
    uint32_t steps = 0;
    int64_t best = 0;
    for (;;) {
      int64_t dist = (hp <= wp) ? (int64_t)(wp - hp)
                                : (int64_t)(wp - hp) + wmask + 1;
      if (dist < prev_dist) break;
      prev_dist = dist;
      int64_t len = 0;
      if (dist > 0) {
        int64_t i = pos, j = pos - dist;
        if (numzeros > 3) {  // skip ahead inside shared zero runs
          int64_t r = std::min<int64_t>(numzeros - 1, zrun[hp]);
          if (i + r >= end) r = end - i - 1;
          i += r;
          j += r;
        }
        while (i < end && v[i] == v[j]) { i++; j++; }
        len = i - pos;
        if (len >= min_len && len + 2 >= best) {
          int64_t sym = DistSymbol(dist);
          // prefer longer; at equal length prefer the smaller symbol
          if (len > *out_len || (len == *out_len && sym < *out_sym)) {
            *out_len = len;
            *out_sym = sym;
          }
          if (len > best) best = len;
        }
      }
      if (++steps >= kMaxChain) break;
      if (numzeros >= 3 && len > (int64_t)numzeros) {
        if (hp == chainz[hp]) break;
        hp = chainz[hp];
        if (zrun[hp] != numzeros) break;
      } else {
        if (hp == chain[hp]) break;
        hp = chain[hp];
        if (hval[hp] != (int32_t)h) break;
      }
    }
  }
};

// cost heuristics for a copy: hybrid(1,0,0) length token + distance
// token under hybrid(7,0,0); flat per-token estimates stand in for the
// final (unknown at parse time) entropy code
inline float LenBits(uint32_t len_minus_min) {
  // hybrid(1,0,0): x < 2 -> 0 extra bits, else floor(log2 x) extra bits;
  // ~3.5 bits assumed for the length token itself
  uint32_t x = len_minus_min;
  uint32_t nbits = x < 2 ? 0 : (31 - __builtin_clz(x));
  return 3.5f + (float)nbits;
}

inline float DistBits(int64_t dist_symbol, int64_t nspecial) {
  if (dist_symbol < nspecial) return 5.5f;
  // hybrid(7,0,0) on the raw symbol: x < 128 -> 0 extra bits, else
  // floor(log2 x); ~9.5 bits assumed for the distance token itself
  uint32_t x = (uint32_t)dist_symbol;
  uint32_t nbits = x < 128 ? 0 : (31 - __builtin_clz(x));
  return 9.5f + (float)nbits;
}

}  // namespace

// values: token values; sym_cost: prefix-sum of literal bit costs
// (length n+1); add_cost: per-position penalty for introducing a length
// symbol into that position's context (SymbolCostEstimator::
// AddSymbolCost); out_len/out_sym: per-position emitted matches (zeroed
// by the caller). Returns the number of matches, or -1.
EXPORT int64_t jxlt_lz77_parse(const uint32_t* values, int64_t n,
                               const float* sym_cost, const float* add_cost,
                               int64_t min_length, int64_t window_size,
                               const int32_t* special, int64_t nspecial,
                               uint32_t* out_len, uint32_t* out_sym) {
  if (n <= 0 || min_length < 3 || window_size < 2 ||
      (window_size & (window_size - 1)) != 0)
    return -1;
  Lz77Matcher m(values, n, window_size, min_length, special, nspecial);
  int64_t matches = 0;
  bool ahead = false;  // next position already inserted (lazy probe)
  constexpr int64_t kMaxLazyLen = 256;
  for (int64_t i = 0; i < n; ++i) {
    if (!ahead) m.Insert(i);
    ahead = false;
    int64_t len, sym;
    m.Best(i, &len, &sym);
    if (len < min_length) continue;
    if (len < kMaxLazyLen && i + 1 < n) {
      m.Insert(i + 1);
      ahead = true;
      int64_t len2, sym2;
      m.Best(i + 1, &len2, &sym2);
      if (len2 > len) {  // defer: literal now, longer match from i+1
        ++i;
        ahead = false;
        len = len2;
        sym = sym2;
      }
    }
    float lit_cost = sym_cost[i + len] - sym_cost[i];
    float copy_cost = LenBits((uint32_t)(len - min_length)) +
                      DistBits(sym, nspecial) + add_cost[i];
    int64_t insert_from = i + (ahead ? 2 : 1);
    int64_t insert_len = len - (ahead ? 2 : 1);
    if (copy_cost <= lit_cost) {
      out_len[i] = (uint32_t)len;
      out_sym[i] = (uint32_t)sym;
      ++matches;
      for (int64_t k = 0; k < insert_len; ++k) m.Insert(insert_from + k);
      ahead = false;
      i += len - 1;
    }
    // rejected matches fall through: literals continue, positions get
    // inserted one by one on the next iterations
  }
  return matches;
}

// ---------------------------------------------------------------------------
// VarDCT AC-group tokenizer for DCT8 groups (enc_entropy_coder.cc:153
// DecodeACVarBlock mirror): per block (raster, channels Y,X,B) the
// nonzero-count token then zero-density coefficient tokens. Hot path of
// serving-mode lossy encode; block contexts and zero-density histogram
// offsets are precomputed by the caller.
// ---------------------------------------------------------------------------
EXPORT int64_t jxlt_tokenize_dct8(
    const int32_t* qp,          // (gh, gw, 3, 64) stored-layout coeffs
    int64_t gh, int64_t gw,
    const int32_t* order,       // 64 natural-order indices
    const int32_t* block_ctx,   // (gh, gw, 3) [c in memory order 0,1,2]
    const int32_t* histo_off,   // (gh, gw, 3) zero-density offsets
    int64_t num_ctxs,
    const int32_t* knz,         // kCoeffNumNonzeroContext[64]
    const int32_t* kfr,         // kCoeffFreqContext[64]
    int32_t* out_ctx, int32_t* out_val) {
  // per-channel nzeros of the previous row / current row (for the
  // predicted-nonzeros context)
  std::vector<int32_t> prev_row(gw * 3, 0);
  std::vector<int32_t> cur_row(gw * 3, 0);
  static const int corder[3] = {1, 0, 2};
  int64_t n = 0;
  for (int64_t by = 0; by < gh; ++by) {
    for (int64_t bx = 0; bx < gw; ++bx) {
      for (int ci = 0; ci < 3; ++ci) {
        int c = corder[ci];
        const int32_t* blk = qp + ((by * gw + bx) * 3 + c) * 64;
        int32_t vals[63];
        int32_t nzeros = 0;
        for (int k = 1; k < 64; ++k) {
          int32_t v = blk[order[k]];
          vals[k - 1] = v;
          nzeros += (v != 0);
        }
        int32_t predicted;
        if (bx == 0) {
          predicted = by > 0 ? prev_row[bx * 3 + c] : 32;
        } else if (by == 0) {
          predicted = cur_row[(bx - 1) * 3 + c];
        } else {
          predicted =
              (prev_row[bx * 3 + c] + cur_row[(bx - 1) * 3 + c] + 1) >> 1;
        }
        cur_row[bx * 3 + c] = nzeros;
        int64_t bc = block_ctx[(by * gw + bx) * 3 + c];
        int32_t nzb = predicted < 8 ? predicted : 4 + predicted / 2;
        out_ctx[n] = (int32_t)(nzb * num_ctxs + bc);
        out_val[n] = nzeros;
        ++n;
        if (nzeros == 0) continue;
        int64_t ho = histo_off[(by * gw + bx) * 3 + c];
        int32_t prev = nzeros > 4 ? 0 : 1;
        int32_t left = nzeros;
        for (int k = 1; k < 64; ++k) {
          int32_t v = vals[k - 1];
          out_ctx[n] = (int32_t)(ho + (knz[left] + kfr[k]) * 2 + prev);
          out_val[n] = v >= 0 ? (v << 1) : ((-v) << 1) - 1;
          ++n;
          prev = v != 0;
          left -= prev;
          if (left == 0) break;
        }
      }
    }
    std::swap(prev_row, cur_row);
  }
  return n;
}

// ---------------------------------------------------------------------------
// General modular channel decode (encoding.cc DecodeModularChannelMAANS
// :149-506): interleaved rANS + hybrid-uint reads with per-pixel MA-tree
// context selection over properties 0..15 (+ precomputed prev-channel
// reference properties), all 14 predictors incl. the weighted predictor.
// This is the host decode hot path for learned-tree streams; LZ77 and
// prefix-code streams stay on the python path (the wrapper bails).
// ---------------------------------------------------------------------------
namespace {

struct WpDec {
  // incremental weighted predictor (context_predict.h State), matching
  // jxlt_wp_plane's math pixel for pixel
  WpConsts c;
  int64_t w;
  std::vector<int64_t> pred_errors[4];
  std::vector<int64_t> error;
  int64_t prediction[4];
  int64_t pred = 0;
  int64_t divlookup[64];
  static constexpr int kBits = 3;
  static constexpr int kRound = ((1 << kBits) >> 1) - 1;

  WpDec(int64_t width, const int32_t* hdr11) : w(width) {
    if (hdr11) {
      c.p1C = hdr11[0]; c.p2C = hdr11[1]; c.p3Ca = hdr11[2];
      c.p3Cb = hdr11[3]; c.p3Cc = hdr11[4]; c.p3Cd = hdr11[5];
      c.p3Ce = hdr11[6];
      c.w[0] = hdr11[7]; c.w[1] = hdr11[8]; c.w[2] = hdr11[9];
      c.w[3] = hdr11[10];
    }
    for (int i = 0; i < 64; i++) divlookup[i] = (1ll << 24) / (i + 1);
    for (int i = 0; i < 4; i++) pred_errors[i].assign((w + 2) * 2, 0);
    error.assign((w + 2) * 2, 0);
  }

  int64_t Predict(int64_t x, int64_t y, int64_t top, int64_t left,
                  int64_t topright, int64_t topleft, int64_t toptop,
                  int64_t* p15) {
    int64_t cur_row = (y & 1) ? 0 : (w + 2);
    int64_t prev_row = (y & 1) ? (w + 2) : 0;
    int64_t pos_n = prev_row + x;
    int64_t pos_ne = x < w - 1 ? pos_n + 1 : pos_n;
    int64_t pos_nw = x > 0 ? pos_n - 1 : pos_n;
    int64_t weights[4];
    for (int i = 0; i < 4; i++) {
      // pred_errors is std::vector<uint32_t> in the reference: the
      // 3-term sum wraps mod 2^32 (context_predict.h:72,148)
      int64_t werr = (uint32_t)(pred_errors[i][pos_n] +
                                pred_errors[i][pos_ne] +
                                pred_errors[i][pos_nw]);
      int shift = FloorLog2(werr + 1) - 5;
      if (shift < 0) shift = 0;
      weights[i] = 4 + ((c.w[i] * divlookup[werr >> shift]) >> shift);
    }
    int64_t N = top << kBits, W = left << kBits, NE = topright << kBits;
    int64_t NW = topleft << kBits, NN = toptop << kBits;
    int64_t teW = x == 0 ? 0 : error[cur_row + x - 1];
    int64_t teN = error[pos_n];
    int64_t teNW = error[pos_nw];
    int64_t teNE = error[pos_ne];
    int64_t sumWN = teN + teW;
    int64_t p = teW;
    if (std::llabs(teN) > std::llabs(p)) p = teN;
    if (std::llabs(teNW) > std::llabs(p)) p = teNW;
    if (std::llabs(teNE) > std::llabs(p)) p = teNE;
    *p15 = (int32_t)p;
    prediction[0] = W + NE - N;
    prediction[1] = N - (((sumWN + teNE) * c.p1C) >> 5);
    prediction[2] = W - (((sumWN + teNW) * c.p2C) >> 5);
    prediction[3] = N - ((teNW * c.p3Ca + teN * c.p3Cb + teNE * c.p3Cc +
                          (NN - N) * c.p3Cd + (NW - W) * c.p3Ce) >> 5);
    int64_t weight_sum = weights[0] + weights[1] + weights[2] + weights[3];
    int log_weight = FloorLog2(weight_sum);
    for (int i = 0; i < 4; i++) weights[i] >>= (log_weight - 4);
    weight_sum = weights[0] + weights[1] + weights[2] + weights[3];
    int64_t s = (weight_sum >> 1) - 1;
    for (int i = 0; i < 4; i++) s += prediction[i] * weights[i];
    pred = (s * divlookup[weight_sum - 1]) >> 24;
    if (((teN ^ teW) | (teN ^ teNW)) <= 0) {
      int64_t mx = std::max(W, std::max(NE, N));
      int64_t mn = std::min(W, std::min(NE, N));
      pred = std::max(mn, std::min(mx, pred));
    }
    return (pred + kRound) >> kBits;
  }

  void Update(int64_t x, int64_t y, int64_t val) {
    int64_t cur_row = (y & 1) ? 0 : (w + 2);
    int64_t prev_row = (y & 1) ? (w + 2) : 0;
    val <<= kBits;
    // error is std::vector<int32_t>, pred_errors std::vector<uint32_t>
    // in the reference: stores wrap (context_predict.h:72-73)
    error[cur_row + x] = (int32_t)(pred - val);
    for (int i = 0; i < 4; i++) {
      int64_t err = (std::llabs(prediction[i] - val) + kRound) >> kBits;
      pred_errors[i][cur_row + x] = (uint32_t)err;
      pred_errors[i][prev_row + x + 1] =
          (uint32_t)(pred_errors[i][prev_row + x + 1] + err);
    }
  }
};

inline int64_t TDiv(int64_t a, int64_t b) {
  int64_t q = (a >= 0 ? a : -a) / b;
  return a >= 0 ? q : -q;
}

inline int64_t PredictOneC(int p, int64_t left, int64_t top,
                           int64_t toptop, int64_t topleft,
                           int64_t topright, int64_t leftleft,
                           int64_t trr, int64_t wp_pred) {
  switch (p) {
    case 0: return 0;                       // Zero
    case 1: return left;
    case 2: return top;
    case 3: return TDiv(left + top, 2);     // Average0
    case 4: {                               // Select
      int64_t g = left + top - topleft;
      return std::llabs(g - left) < std::llabs(g - top) ? left : top;
    }
    case 5: {                               // clamped gradient
      int64_t m = std::min(top, left), M = std::max(top, left);
      int64_t grad = top + left - topleft;
      if (topleft < m) return M;
      if (topleft > M) return m;
      return grad;
    }
    case 6: return wp_pred;                 // Weighted
    case 7: return topright;
    case 8: return topleft;
    case 9: return leftleft;
    case 10: return TDiv(left + topleft, 2);
    case 11: return TDiv(topleft + top, 2);
    case 12: return TDiv(top + topright, 2);
    case 13: return TDiv(6 * top - 2 * toptop + 7 * left + leftleft +
                         trr + 3 * topright + 8, 16);
    default: return 0;
  }
}

}  // namespace

// tree: (n_nodes, 8) int32 rows [prop, splitval, lch, rch, ctx, pred,
// offset, multiplier]; prop < 0 marks a leaf.
// refs: (n_ref_props, h, w) int32 precomputed reference-property planes
// (properties 16+), or null.
// Returns new bit position, or negative error; *state_io updated.
EXPORT int64_t jxlt_modular_generic_decode(
    const uint8_t* data, int64_t nbytes, int64_t start_bit,
    uint32_t* state_io,
    const int32_t* alias_sym_flat, const int32_t* alias_off_flat,
    const int32_t* freqs_flat, const int64_t* freqs_off,
    const int32_t* cluster_map, int64_t n_ctx,
    const int32_t* cfg_se, const int32_t* cfg_msb, const int32_t* cfg_lsb,
    const int32_t* tree, int64_t n_nodes,
    int32_t* plane, int64_t w, int64_t h,
    const int32_t* refs, int64_t n_ref_props,
    int32_t chan_idx, int32_t group_id, int32_t use_wp,
    const int32_t* wp_hdr11,
    // LZ77 (dec_ans.h window semantics); lz_* ignored when !lz_enabled
    int32_t lz_enabled, int32_t lz_min_symbol, int32_t lz_min_length,
    int32_t lz_len_se, int32_t lz_len_msb, int32_t lz_len_lsb,
    int32_t lz_dist_hist, const int32_t* lz_special, int64_t lz_nspecial,
    uint32_t* lz_window, int64_t* lz_state_io) {
  BitSource src{data, nbytes, start_bit};
  uint32_t state = *state_io;
  WpDec wp(w, wp_hdr11);
  // LZ77 value window: the CALLER's buffer (the python reader's own
  // window array), so state persists across channels and paths
  constexpr int64_t kWin = 1 << 20;
  constexpr int64_t kWinMask = kWin - 1;
  int64_t num_decoded = 0, copy_pos = 0, copy_remaining = 0;
  if (lz_enabled) {
    num_decoded = lz_state_io[0];
    copy_pos = lz_state_io[1];
    copy_remaining = lz_state_io[2];
  }
  int64_t props[32] = {0};
  props[0] = chan_idx;
  props[1] = group_id;
  for (int64_t y = 0; y < h; ++y) {
    props[2] = y;
    int64_t prev_grad = 0;
    for (int64_t x = 0; x < w; ++x) {
      // neighbors with border rules (context_predict.h Predict)
      int64_t left = x ? plane[y * w + x - 1]
                       : (y ? plane[(y - 1) * w + x] : 0);
      int64_t top = y ? plane[(y - 1) * w + x] : left;
      int64_t topleft = (x && y) ? plane[(y - 1) * w + x - 1] : left;
      int64_t topright = (x + 1 < w && y) ? plane[(y - 1) * w + x + 1]
                                          : top;
      int64_t leftleft = x > 1 ? plane[y * w + x - 2] : left;
      int64_t toptop = y > 1 ? plane[(y - 2) * w + x] : top;
      int64_t trr = (x + 2 < w && y) ? plane[(y - 1) * w + x + 2]
                                     : topright;
      // PropertyVal is int32_t in the reference (options.h:18):
      // assignments wrap; required for 32-bit (float-sample) content
      props[3] = x;
      props[4] = (int32_t)std::llabs(top);
      props[5] = (int32_t)std::llabs(left);
      props[6] = (int32_t)top;
      props[7] = (int32_t)left;
      props[8] = (int32_t)(left - prev_grad);
      props[9] = (int32_t)(left + top - topleft);
      prev_grad = props[9];
      props[10] = (int32_t)(left - topleft);
      props[11] = (int32_t)(topleft - top);
      props[12] = (int32_t)(top - topright);
      props[13] = (int32_t)(top - toptop);
      props[14] = (int32_t)(left - leftleft);
      int64_t wp_pred = 0;
      if (use_wp) {
        wp_pred = wp.Predict(x, y, top, left, topright, topleft, toptop,
                             &props[15]);
      } else {
        props[15] = 0;
      }
      for (int64_t k = 0; k < n_ref_props; ++k) {
        props[16 + k] = refs[(k * h + y) * w + x];
      }
      // tree walk
      int64_t node = 0;
      while (tree[node * 8] >= 0) {
        node = props[tree[node * 8]] > tree[node * 8 + 1]
                   ? tree[node * 8 + 2]
                   : tree[node * 8 + 3];
      }
      int32_t ctx = tree[node * 8 + 4];
      if (ctx < 0 || ctx >= n_ctx) return -3;
      int32_t hist = cluster_map[ctx];
      auto read_symbol = [&](int32_t hh) -> uint32_t {
        uint32_t res = state & (kAnsTabSize - 1);
        uint32_t sym = (uint32_t)alias_sym_flat[hh * kAnsTabSize + res];
        uint32_t off = (uint32_t)alias_off_flat[hh * kAnsTabSize + res];
        state = (uint32_t)freqs_flat[freqs_off[hh] + sym] *
                    (state >> kAnsLogTabSize) + off;
        if (state < (1u << 16)) {
          state = (state << 16) | (uint32_t)src.Read(16);
        }
        return sym;
      };
      bool bad = false;
      auto hybrid = [&](uint32_t token, uint32_t se, uint32_t msb,
                        uint32_t lsb) -> uint32_t {
        if (token < (1u << se)) return token;
        uint32_t nb = se - (msb + lsb) + ((token - (1u << se)) >>
                                          (msb + lsb));
        if (nb > 31) { bad = true; return 0; }
        uint32_t low = token & ((1u << lsb) - 1);
        token >>= lsb;
        uint32_t extra = (uint32_t)src.Read(nb);
        return ((((1u << msb) | (token & ((1u << msb) - 1))) << nb) |
                extra) << lsb | low;
      };
      uint32_t value;
      if (lz_enabled) {
        // dec_ans.h ReadHybridUintClustered window semantics
        // (entropy/ans.py:312-344 mirror)
        for (;;) {
          if (copy_remaining > 0) {
            value = lz_window[copy_pos & kWinMask];
            ++copy_pos;
            --copy_remaining;
            lz_window[num_decoded & kWinMask] = value;
            ++num_decoded;
            break;
          }
          uint32_t token = read_symbol(hist);
          if ((int32_t)token >= lz_min_symbol) {
            copy_remaining = (int64_t)hybrid(token - lz_min_symbol,
                                             lz_len_se, lz_len_msb,
                                             lz_len_lsb) + lz_min_length;
            uint32_t dt = read_symbol(lz_dist_hist);
            int64_t distance = (int64_t)hybrid(
                dt, (uint32_t)cfg_se[lz_dist_hist],
                (uint32_t)cfg_msb[lz_dist_hist],
                (uint32_t)cfg_lsb[lz_dist_hist]);
            if (bad) return -2;
            if (distance < lz_nspecial) {
              distance = lz_special[distance];
            } else {
              distance = distance + 1 - lz_nspecial;
            }
            if (distance > num_decoded) distance = num_decoded;
            if (distance > kWin) distance = kWin;
            copy_pos = num_decoded - distance;
            if (distance == 0) {
              int64_t nz = copy_remaining < kWin ? copy_remaining : kWin;
              for (int64_t z = 0; z < nz; ++z) lz_window[z] = 0;
            }
            continue;
          }
          value = hybrid(token, (uint32_t)cfg_se[hist],
                         (uint32_t)cfg_msb[hist],
                         (uint32_t)cfg_lsb[hist]);
          if (bad) return -2;
          lz_window[num_decoded & kWinMask] = value;
          ++num_decoded;
          break;
        }
      } else {
        uint32_t token = read_symbol(hist);
        value = hybrid(token, (uint32_t)cfg_se[hist],
                       (uint32_t)cfg_msb[hist], (uint32_t)cfg_lsb[hist]);
      }
      if (bad) return -2;
      // unpack_signed
      int64_t sv = (value & 1) ? -(int64_t)((value >> 1) + 1)
                               : (int64_t)(value >> 1);
      int64_t guess = PredictOneC(tree[node * 8 + 5], left, top, toptop,
                                  topleft, topright, leftleft, trr,
                                  wp_pred);
      int64_t val = sv * tree[node * 8 + 7] + guess + tree[node * 8 + 6];
      plane[y * w + x] = (int32_t)val;
      if (use_wp) wp.Update(x, y, val);
    }
  }
  if (src.bitpos > nbytes * 8) return -2;
  *state_io = state;
  if (lz_enabled) {
    lz_state_io[0] = num_decoded;
    lz_state_io[1] = copy_pos;
    lz_state_io[2] = copy_remaining;
  }
  return src.bitpos;
}

// ---------------------------------------------------------------------------
// DecodeHistograms (dec_ans.cc:295-340) as one native call: LZ77 params,
// context map (dec_context_map.cc:48-95, incl. the nested single-context
// ANS code + inverse MTF), per-cluster hybrid-uint configs and ANS
// histograms (dec_ans.cc:58-191). Returns the end bit position, or a
// negative error: -100 = feature needs the Python path (prefix codes /
// nested LZ77), other negatives = corrupt stream (caller re-parses in
// Python to raise the precise FormatError).
// ---------------------------------------------------------------------------

namespace {

// logcount static prefix code (dec_ans.cc:110-125): 7-bit peek ->
// (bits consumed, logcount+1). Index pattern repeats with period 16.
static const uint8_t kLogBits[128] = {
    3, 7, 3, 4, 3, 3, 3, 4, 3, 4, 3, 4, 3, 3, 3, 4,
    3, 5, 3, 4, 3, 3, 3, 4, 3, 4, 3, 4, 3, 3, 3, 4,
    3, 6, 3, 4, 3, 3, 3, 4, 3, 4, 3, 4, 3, 3, 3, 4,
    3, 5, 3, 4, 3, 3, 3, 4, 3, 4, 3, 4, 3, 3, 3, 4,
    3, 7, 3, 4, 3, 3, 3, 4, 3, 4, 3, 4, 3, 3, 3, 4,
    3, 5, 3, 4, 3, 3, 3, 4, 3, 4, 3, 4, 3, 3, 3, 4,
    3, 6, 3, 4, 3, 3, 3, 4, 3, 4, 3, 4, 3, 3, 3, 4,
    3, 5, 3, 4, 3, 3, 3, 4, 3, 4, 3, 4, 3, 3, 3, 4};
static const uint8_t kLogSym[128] = {
    10, 12, 7, 3, 6, 8, 9, 5, 10, 4, 7, 1, 6, 8, 9, 2,
    10, 0,  7, 3, 6, 8, 9, 5, 10, 4, 7, 1, 6, 8, 9, 2,
    10, 11, 7, 3, 6, 8, 9, 5, 10, 4, 7, 1, 6, 8, 9, 2,
    10, 0,  7, 3, 6, 8, 9, 5, 10, 4, 7, 1, 6, 8, 9, 2,
    10, 13, 7, 3, 6, 8, 9, 5, 10, 4, 7, 1, 6, 8, 9, 2,
    10, 0,  7, 3, 6, 8, 9, 5, 10, 4, 7, 1, 6, 8, 9, 2,
    10, 11, 7, 3, 6, 8, 9, 5, 10, 4, 7, 1, 6, 8, 9, 2,
    10, 0,  7, 3, 6, 8, 9, 5, 10, 4, 7, 1, 6, 8, 9, 2};

static inline int64_t HdVarU8(AnsDec& r) {
  if (r.Read(1)) {
    int nb = (int)r.Read(3);
    if (!nb) return 1;
    return (int64_t)r.Read(nb) + ((int64_t)1 << nb);
  }
  return 0;
}

static inline int HdCeilLog2(int64_t x) {
  int n = 0;
  while (((int64_t)1 << n) < x) n++;
  return n;
}

static int HdReadUintConfig(AnsDec& r, int log_alpha, int32_t* cfg3) {
  int split = (int)r.Read(HdCeilLog2(log_alpha + 1));
  int msb = 0, lsb = 0;
  if (split != log_alpha) {
    msb = (int)r.Read(HdCeilLog2(split + 1));
    if (msb > split) return -1;
    lsb = (int)r.Read(HdCeilLog2(split - msb + 1));
  }
  if (lsb + msb > split) return -1;
  cfg3[0] = split;
  cfg3[1] = msb;
  cfg3[2] = lsb;
  return 0;
}

static inline int HdPopPrecision(int logcount, int shift) {
  int rr = shift - ((kAnsLogTabSize - logcount) >> 1);
  if (logcount < rr) rr = logcount;
  return rr > 0 ? rr : 0;
}

// Decode one histogram into counts[]; returns length (trailing zeros
// possible) or negative on corruption. counts must hold >= 320 ints.
static int64_t HdReadHistogram(AnsDec& r, int32_t* counts) {
  const int64_t rng = (int64_t)1 << kAnsLogTabSize;
  if (r.Read(1)) {  // simple
    int n_sym = (int)r.Read(1) + 1;
    int64_t syms[2] = {0, 0};
    for (int i = 0; i < n_sym; ++i) syms[i] = HdVarU8(r);
    int64_t len = (syms[0] > syms[1] ? syms[0] : syms[1]) + 1;
    for (int64_t i = 0; i < len; ++i) counts[i] = 0;
    if (n_sym == 1) {
      counts[syms[0]] = (int32_t)rng;
    } else {
      if (syms[0] == syms[1]) return -1;
      counts[syms[0]] = (int32_t)r.Read(kAnsLogTabSize);
      counts[syms[1]] = (int32_t)(rng - counts[syms[0]]);
    }
    return len;
  }
  if (r.Read(1)) {  // flat
    int64_t alpha = HdVarU8(r) + 1;
    if (alpha > rng) return -1;
    // CreateFlatHistogram semantics: evenly split 4096 over alpha
    int64_t base = rng / alpha, rem = rng % alpha;
    for (int64_t i = 0; i < alpha; ++i)
      counts[i] = (int32_t)(base + (i < rem ? 1 : 0));
    return alpha;
  }
  // general code
  int upper = 0;
  {
    int64_t ub = kAnsLogTabSize + 1;
    while ((1 << (upper + 1)) <= ub) upper++;  // floor(log2(13)) = 3
  }
  int log = 0;
  while (log < upper) {
    if (r.Read(1) == 0) break;
    log++;
  }
  int64_t shift = (int64_t)(r.Read(log) | ((uint64_t)1 << log)) - 1;
  if (shift > kAnsLogTabSize + 1) return -1;
  int64_t length = HdVarU8(r) + 3;
  if (length > 300) return -1;
  int32_t logcounts[304];
  int32_t same[304];
  for (int64_t i = 0; i < length; ++i) {
    logcounts[i] = 0;
    same[i] = 0;
  }
  int omit_log = -1;
  int64_t omit_pos = -1;
  for (int64_t i = 0; i < length;) {
    uint32_t idx;
    {  // 7-bit peek (AnsDec has no Peek; read without advancing)
      int64_t byte = r.bitpos >> 3;
      uint64_t v = 0;
      int64_t avail = r.nbytes - byte;
      if (avail > 0) memcpy(&v, r.data + byte, avail >= 8 ? 8 : avail);
      idx = (uint32_t)((v >> (r.bitpos & 7)) & 127);
    }
    int bits = kLogBits[idx];
    int value = kLogSym[idx];
    r.bitpos += bits;
    logcounts[i] = value - 1;
    if (logcounts[i] == kAnsLogTabSize) {
      int64_t rle = HdVarU8(r);
      same[i] = (int32_t)(rle + 5);
      i += rle + 4;
      continue;
    }
    if (logcounts[i] > omit_log) {
      omit_log = logcounts[i];
      omit_pos = i;
    }
    i++;
  }
  if (omit_pos < 0) return -1;
  if (omit_pos + 1 < length && logcounts[omit_pos + 1] == kAnsLogTabSize)
    return -1;
  int64_t total = 0, prev = 0, numsame = 0;
  for (int64_t i = 0; i < length; ++i) {
    counts[i] = 0;
    if (same[i]) {
      numsame = same[i] - 1;
      prev = i > 0 ? counts[i - 1] : 0;
    }
    if (numsame > 0) {
      counts[i] = (int32_t)prev;
      numsame--;
    } else {
      int code = logcounts[i];
      if (i == omit_pos || code < 0) continue;
      if (shift == 0 || code == 0) {
        counts[i] = (int32_t)((int64_t)1 << code);
      } else {
        int bitcount = HdPopPrecision(code, (int)shift);
        counts[i] = (int32_t)(((int64_t)1 << code) +
                              ((int64_t)r.Read(bitcount)
                               << (code - bitcount)));
      }
    }
    total += counts[i];
  }
  int64_t om = rng - total;
  if (om <= 0) return -1;
  counts[omit_pos] = (int32_t)om;
  return length;
}

}  // namespace

// See header comment. Outputs:
//   lz77_out[7]: enabled, min_symbol, min_length, len_cfg split/msb/lsb,
//                distance_context
//   ctx_map_out: num_contexts (+1 when LZ77) int32 entries
//   info_out[2]: num_histograms, log_alpha_size
//   uint_cfgs_out: 3 per histogram (<= 256 histograms)
//   counts_out: 320 int32 per histogram (zero-padded)
//   alpha_out: per-histogram alphabet length
EXPORT int64_t jxlt_decode_histograms(
    const uint8_t* data, int64_t nbytes, int64_t start_bit,
    int64_t num_contexts, int32_t disallow_lz77, int32_t* lz77_out,
    int32_t* ctx_map_out, int32_t* info_out, int32_t* uint_cfgs_out,
    int32_t* counts_out, int32_t* alpha_out) {
  AnsDec r{data, nbytes, start_bit, 0};
  // ---- LZ77Params (dec_ans.cc LZ77Params::VisitFields) ----
  int enabled = (int)r.Read(1);
  int64_t min_symbol = 224, min_length = 3;
  lz77_out[3] = lz77_out[4] = lz77_out[5] = 0;
  if (enabled) {
    if (disallow_lz77) return -2;
    uint32_t sel = (uint32_t)r.Read(2);
    min_symbol = sel == 0 ? 224
                 : sel == 1 ? 512
                 : sel == 2 ? 4096
                            : (int64_t)r.Read(15) + 8;
    sel = (uint32_t)r.Read(2);
    min_length = sel == 0 ? 3
                 : sel == 1 ? 4
                 : sel == 2 ? (int64_t)r.Read(2) + 5
                            : (int64_t)r.Read(8) + 9;
    num_contexts += 1;
    if (HdReadUintConfig(r, 8, lz77_out + 3) < 0) return -1;
  }
  lz77_out[0] = enabled;
  lz77_out[1] = (int32_t)min_symbol;
  lz77_out[2] = (int32_t)min_length;
  // ---- context map (dec_context_map.cc:48-95) ----
  int64_t num_histograms = 1;
  if (num_contexts > 1) {
    if (r.Read(1)) {  // simple
      int bpe = (int)r.Read(2);
      for (int64_t i = 0; i < num_contexts; ++i)
        ctx_map_out[i] = bpe ? (int32_t)r.Read(bpe) : 0;
    } else {
      int use_mtf = (int)r.Read(1);
      // nested single-context code
      if (r.Read(1)) return -100;  // nested LZ77: python path
      if (r.Read(1)) return -100;  // nested prefix code: python path
      int n_log_alpha = (int)r.Read(2) + 5;
      int32_t ncfg[3];
      if (HdReadUintConfig(r, n_log_alpha, ncfg) < 0) return -1;
      int32_t ncounts[320];
      int64_t nlen = HdReadHistogram(r, ncounts);
      if (nlen < 0) return -1;
      if (nlen > ((int64_t)1 << n_log_alpha)) return -1;
      std::vector<int32_t> nsym(4096), noff(4096),
          nfreq((size_t)1 << n_log_alpha);
      if (jxlt_build_alias_table(ncounts, nlen, n_log_alpha, nsym.data(),
                                 noff.data(), nfreq.data()) < 0)
        return -1;
      r.state = (uint32_t)r.Read(32);
      for (int64_t i = 0; i < num_contexts; ++i) {
        uint32_t tok = r.ReadSym(nsym.data(), noff.data(), nfreq.data());
        int64_t v;
        uint32_t split = 1u << ncfg[0];
        if (tok < split) {
          v = tok;
        } else {
          int msb = ncfg[1], lsb = ncfg[2];
          uint32_t nb = ncfg[0] - (msb + lsb) + ((tok - split) >> (msb + lsb));
          if (nb > 31) return -1;
          uint32_t low = tok & ((1u << lsb) - 1);
          uint32_t t2 = tok >> lsb;
          uint32_t extra = (uint32_t)r.Read((int)nb);
          v = (int64_t)((((((1u << msb) | (t2 & ((1u << msb) - 1))) << nb) |
                          extra)
                         << lsb) |
                        low);
        }
        if (v >= 256) return -1;
        ctx_map_out[i] = (int32_t)v;
      }
      if (r.state != (0x13u << 16)) return -1;
      if (use_mtf) {
        uint8_t mtf[256];
        for (int i = 0; i < 256; ++i) mtf[i] = (uint8_t)i;
        for (int64_t i = 0; i < num_contexts; ++i) {
          int idx = ctx_map_out[i];
          uint8_t v = mtf[idx];
          ctx_map_out[i] = v;
          for (int j = idx; j > 0; --j) mtf[j] = mtf[j - 1];
          mtf[0] = v;
        }
      }
    }
    int32_t mx = 0;
    uint8_t used[256] = {0};
    for (int64_t i = 0; i < num_contexts; ++i) {
      if (ctx_map_out[i] < 0 || ctx_map_out[i] > 255) return -1;
      used[ctx_map_out[i]] = 1;
      if (ctx_map_out[i] > mx) mx = ctx_map_out[i];
    }
    num_histograms = mx + 1;
    for (int64_t i = 0; i < num_histograms; ++i)
      if (!used[i]) return -1;  // incomplete context map
  } else {
    ctx_map_out[0] = 0;
  }
  lz77_out[6] = ctx_map_out[num_contexts - 1];
  // ---- code tables ----
  if (r.Read(1)) return -100;  // prefix codes: python path
  int log_alpha = (int)r.Read(2) + 5;
  info_out[0] = (int32_t)num_histograms;
  info_out[1] = log_alpha;
  for (int64_t h = 0; h < num_histograms; ++h)
    if (HdReadUintConfig(r, log_alpha, uint_cfgs_out + 3 * h) < 0)
      return -1;
  const int64_t max_alpha = (int64_t)1 << log_alpha;
  for (int64_t h = 0; h < num_histograms; ++h) {
    int32_t* cts = counts_out + 320 * h;
    for (int i = 0; i < 320; ++i) cts[i] = 0;
    int64_t len = HdReadHistogram(r, cts);
    if (len < 0) return -1;
    if (len > max_alpha) return -1;
    alpha_out[h] = (int32_t)len;
  }
  if (r.overflow) return -1;
  return r.bitpos;
}

// ---------------------------------------------------------------------------
// Full MA-tree decode (dec_ma.cc:107-182): histogram set (6 tree
// contexts) + the ANS-coded node stream, one native call. Fills
// nodes_out rows of [property, splitval, lchild/context, rchild,
// predictor, offset, multiplier]; returns node count (>=0) with
// *end_bit_out set, or negative (-100 = python path needed).
// ---------------------------------------------------------------------------
EXPORT int64_t jxlt_decode_tree(const uint8_t* data, int64_t nbytes,
                                int64_t start_bit, int64_t max_nodes,
                                int32_t* nodes_out, int64_t cap_nodes,
                                int64_t* end_bit_out) {
  const int64_t kNumTreeCtx = 6;
  int32_t lz77[7];
  int32_t ctx_map[8];
  int32_t info[2];
  std::vector<int32_t> cfgs(3 * 256);
  std::vector<int32_t> counts(320 * 256);
  std::vector<int32_t> alphas(256);
  int64_t hist_end = jxlt_decode_histograms(
      data, nbytes, start_bit, kNumTreeCtx, /*disallow_lz77=*/0,
      lz77, ctx_map, info, cfgs.data(), counts.data(), alphas.data());
  if (hist_end < 0) return hist_end;
  if (lz77[0]) return -100;  // LZ77-coded tree: python path (windowed)
  int num_histo = info[0];
  int log_alpha = info[1];
  std::vector<int32_t> sym((size_t)num_histo * 4096),
      off((size_t)num_histo * 4096),
      freq((size_t)num_histo << log_alpha);
  for (int h = 0; h < num_histo; ++h) {
    if (jxlt_build_alias_table(counts.data() + 320 * h, alphas[h],
                               log_alpha, sym.data() + (size_t)h * 4096,
                               off.data() + (size_t)h * 4096,
                               freq.data() + ((size_t)h << log_alpha)) < 0)
      return -1;
  }
  AnsDec r{data, nbytes, hist_end, 0};
  r.state = (uint32_t)r.Read(32);
  auto read_uint = [&](int ctx) -> int64_t {
    int h = ctx_map[ctx];
    uint32_t tok =
        r.ReadSym(sym.data() + (size_t)h * 4096,
                  off.data() + (size_t)h * 4096,
                  freq.data() + ((size_t)h << log_alpha));
    const int32_t* c3 = cfgs.data() + 3 * h;
    uint32_t split = 1u << c3[0];
    if (tok < split) return tok;
    int msb = c3[1], lsb = c3[2];
    uint32_t nb = c3[0] - (msb + lsb) + ((tok - split) >> (msb + lsb));
    if (nb > 31) return -1;
    uint32_t low = tok & ((1u << lsb) - 1);
    uint32_t t2 = tok >> lsb;
    uint32_t extra = (uint32_t)r.Read((int)nb);
    return (int64_t)((((((1u << msb) | (t2 & ((1u << msb) - 1))) << nb) |
                       extra)
                      << lsb) |
                     low);
  };
  int64_t n = 0, leaf_id = 0, to_decode = 1;
  while (to_decode > 0) {
    if (n >= cap_nodes && n <= max_nodes) return -3;  // grow buffer
    if (n > max_nodes || r.overflow) return -1;
    to_decode--;
    int64_t prop1 = read_uint(1);  // K_PROPERTY_CTX
    if (prop1 < 0 || prop1 > 256) return -1;
    int32_t* row = nodes_out + 7 * n;
    if (prop1 == 0) {  // leaf
      int64_t pred = read_uint(2);         // K_PREDICTOR_CTX
      if (pred < 0 || pred >= 16) return -1;
      int64_t uoff = read_uint(3);         // K_OFFSET_CTX
      if (uoff < 0) return -1;
      int64_t offset = (uoff & 1) ? -((uoff + 1) >> 1) : (uoff >> 1);
      int64_t mlog = read_uint(4);         // K_MULTIPLIER_LOG_CTX
      if (mlog < 0 || mlog >= 31) return -1;
      int64_t mbits = read_uint(5);        // K_MULTIPLIER_BITS_CTX
      if (mbits < 0 || mbits >= (((int64_t)1 << (31 - mlog)) - 1))
        return -1;
      row[0] = -1;
      row[1] = 0;
      row[2] = (int32_t)leaf_id++;
      row[3] = 0;
      row[4] = (int32_t)pred;
      row[5] = (int32_t)offset;
      row[6] = (int32_t)((mbits + 1) << mlog);
    } else {
      int64_t usv = read_uint(0);          // K_SPLITVAL_CTX
      if (usv < 0) return -1;
      int64_t sv = (usv & 1) ? -((usv + 1) >> 1) : (usv >> 1);
      row[0] = (int32_t)(prop1 - 1);
      row[1] = (int32_t)sv;
      row[2] = (int32_t)(n + to_decode + 1);
      row[3] = (int32_t)(n + to_decode + 2);
      row[4] = 0;
      row[5] = 0;
      row[6] = 1;
      to_decode += 2;
    }
    n++;
  }
  if (r.state != (0x13u << 16)) return -1;
  *end_bit_out = r.bitpos;
  return n;
}

// ---------------------------------------------------------------------------
// MA-tree greedy learner (reference: enc_ma.cc ComputeBestTree/FindBestSplit).
//
// Exact port of the numpy learner in modular/enc_ma.py (learn_tree_streams
// greedy phase): presorted-CART with per-leaf contiguous ranges in every
// property's sort order, quantile candidate thresholds, entropy+rawbits cost
// batched over the candidate predictor set, penalty 96 bits per split.
// Inputs are the learner's sample matrices; Python maps property/predictor
// indices back to ids and builds the TreeNode list.

namespace tree_learn {

struct Leaf {
  int64_t a, b;          // contiguous range in every sorted-index array
  double cost;           // best_pred cost
  int pred;              // best predictor (index into candidate set)
  double gain;           // best split gain (-inf when none)
  int sprop;             // best split property (index)
  int64_t sval;          // best split threshold
  int left = -1, right = -1;   // children (index into pool), -1 = leaf
  int prop = -1;               // chosen split prop once split
  int64_t splitval = 0;
};

static inline double ent_term(int64_t c) {
  return c > 0 ? (double)c * std::log2((double)c) : 0.0;
}

struct Ctx {
  const int32_t* tok;      // (n_pred, n)
  const int32_t* nbits;    // (n_pred, n)
  const int32_t* props;    // (n_props, n)
  int64_t n;
  int n_pred, n_props, alphabet;
  std::vector<std::vector<int32_t>> sorted;  // per prop: sample indices
  std::vector<int32_t> scratch;              // partition scratch
};

static void best_pred(Ctx& C, Leaf& L) {
  int64_t m = L.b - L.a;
  std::vector<int64_t> hist((size_t)C.n_pred * C.alphabet, 0);
  std::vector<int64_t> nbsum(C.n_pred, 0);
  const int32_t* s0 = C.sorted[0].data() + L.a;
  for (int64_t i = 0; i < m; i++) {
    int32_t s = s0[i];
    for (int k = 0; k < C.n_pred; k++) {
      hist[(size_t)k * C.alphabet + C.tok[(size_t)k * C.n + s]]++;
      nbsum[k] += C.nbits[(size_t)k * C.n + s];
    }
  }
  double best = 0.0;
  int bestk = 0;
  for (int k = 0; k < C.n_pred; k++) {
    double tot = 0, e = 0;
    for (int a = 0; a < C.alphabet; a++) {
      int64_t c = hist[(size_t)k * C.alphabet + a];
      tot += (double)c;
      e += ent_term(c);
    }
    double cost = ent_term((int64_t)tot) - e + (double)nbsum[k];
    if (k == 0 || cost < best) { best = cost; bestk = k; }
  }
  L.cost = best;
  L.pred = bestk;
}

static const double kQFrac[9] = {0.06, 0.12, 0.25, 0.37, 0.50,
                                 0.63, 0.75, 0.88, 0.94};

static void best_split(Ctx& C, Leaf& L) {
  L.gain = -1.0;  // sentinel: no split (python uses gain>0 gate)
  int64_t m = L.b - L.a;
  if (m < 256) return;
  std::vector<int32_t> svals(m);
  std::vector<int64_t> qs;
  std::vector<int64_t> cuts;
  int np_ = C.n_pred;
  int A = C.alphabet;
  // hist: (n_pred, nseg, alphabet); nseg <= 10
  std::vector<int64_t> hist;
  std::vector<int64_t> nbseg;
  bool have_best = false;
  double best_gain = 0.0;
  int best_prop = -1;
  int64_t best_sv = 0;
  for (int p = 0; p < C.n_props; p++) {
    const int32_t* sp = C.sorted[p].data() + L.a;
    const int32_t* pv = C.props + (size_t)p * C.n;
    for (int64_t i = 0; i < m; i++) svals[i] = pv[sp[i]];
    // candidate thresholds: quantiles (linear interp on sorted values,
    // truncated toward zero), adjacent-unique
    qs.clear();
    for (int j = 0; j < 9; j++) {
      double qpos = (double)(m - 1) * kQFrac[j];
      int64_t flo = (int64_t)std::floor(qpos);
      double frac = qpos - (double)flo;
      int64_t fhi = flo + 1 < m ? flo + 1 : m - 1;
      double qv = (double)svals[flo] * (1.0 - frac) +
                  (double)svals[fhi] * frac;
      int64_t qi = (int64_t)qv;  // trunc toward zero (matches .astype)
      if (qs.empty() || qi != qs.back()) qs.push_back(qi);
    }
    int q = (int)qs.size();
    cuts.assign(q, 0);
    bool any_valid = false;
    for (int j = 0; j < q; j++) {
      // count of svals <= qs[j]  (searchsorted right)
      int64_t lo = 0, hi = m;
      while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if ((int64_t)svals[mid] <= qs[j]) lo = mid + 1; else hi = mid;
      }
      cuts[j] = lo;
      if (lo >= 64 && m - lo >= 64) any_valid = true;
    }
    if (!any_valid) continue;
    int nseg = q + 1;
    hist.assign((size_t)np_ * nseg * A, 0);
    nbseg.assign((size_t)np_ * nseg, 0);
    {
      int seg = 0;
      for (int64_t i = 0; i < m; i++) {
        while (seg < q && i >= cuts[seg]) seg++;
        int32_t s = sp[i];
        for (int k = 0; k < np_; k++) {
          hist[((size_t)k * nseg + seg) * A + C.tok[(size_t)k * C.n + s]]++;
          nbseg[(size_t)k * nseg + seg] += C.nbits[(size_t)k * C.n + s];
        }
      }
    }
    // prefix over segments; score each threshold k: right = cum[:k],
    // left = total - right
    for (int k = 1; k < nseg; k++) {
      for (int pr = 0; pr < np_; pr++) {
        nbseg[(size_t)pr * nseg + k] += nbseg[(size_t)pr * nseg + k - 1];
        int64_t* h0 = hist.data() + ((size_t)pr * nseg + k - 1) * A;
        int64_t* h1 = hist.data() + ((size_t)pr * nseg + k) * A;
        for (int a = 0; a < A; a++) h1[a] += h0[a];
      }
    }
    double gk_best = 0.0;
    int64_t sv_best = 0;
    bool have_k = false;
    for (int j = 0; j < q; j++) {
      if (!(cuts[j] >= 64 && m - cuts[j] >= 64)) continue;
      double cr_min = 0, cl_min = 0;
      for (int pr = 0; pr < np_; pr++) {
        const int64_t* le = hist.data() + ((size_t)pr * nseg + j) * A;
        const int64_t* tot = hist.data() + ((size_t)pr * nseg + nseg - 1) * A;
        double tr = 0, er = 0, tl = 0, el = 0;
        for (int a = 0; a < A; a++) {
          int64_t c = le[a];
          int64_t cg = tot[a] - c;
          tr += (double)c; er += ent_term(c);
          tl += (double)cg; el += ent_term(cg);
        }
        double nr = (double)nbseg[(size_t)pr * nseg + j];
        double nl = (double)nbseg[(size_t)pr * nseg + nseg - 1] - nr;
        double cr = ent_term((int64_t)tr) - er + nr;
        double cl = ent_term((int64_t)tl) - el + nl;
        if (pr == 0 || cr < cr_min) cr_min = cr;
        if (pr == 0 || cl < cl_min) cl_min = cl;
      }
      double gain = L.cost - (cl_min + cr_min) - 96.0;
      // argmax over thresholds, first max wins (python np.argmax)
      if (!have_k || gain > gk_best) { have_k = true; gk_best = gain;
                                       sv_best = qs[j]; }
    }
    if (have_k && gk_best > 0.0 &&
        (!have_best || gk_best > best_gain)) {
      have_best = true;
      best_gain = gk_best;
      best_prop = p;
      best_sv = sv_best;
    }
  }
  if (have_best) { L.gain = best_gain; L.sprop = best_prop;
                   L.sval = best_sv; }
}

}  // namespace tree_learn

// Returns node count (<= 2*max_leaves-1) or -1. Outputs per node:
//   out_prop: split property INDEX (into the caller's prop list), -1 = leaf
//   out_sval: split threshold
//   out_child: left-child node index (right = left+1), 0 for leaves
//   out_pred: predictor INDEX (into the caller's candidate list), 0 internal
EXPORT int64_t jxlt_tree_learn(
    const int32_t* tok, const int32_t* nbits, const int32_t* props,
    int64_t n, int32_t n_pred, int32_t n_props, int32_t alphabet,
    int32_t max_leaves, int32_t* out_prop, int32_t* out_sval,
    int32_t* out_child, int32_t* out_pred) {
  using namespace tree_learn;
  if (n <= 0 || n_pred <= 0 || n_props <= 0 || alphabet <= 0) return -1;
  Ctx C;
  C.tok = tok; C.nbits = nbits; C.props = props;
  C.n = n; C.n_pred = n_pred; C.n_props = n_props; C.alphabet = alphabet;
  C.sorted.resize(n_props);
  {
    // initial per-property sorts (value order; ties arbitrary — segment
    // content only depends on values), parallel across properties
    int nt = (int)std::min<int64_t>(4, n_props);
    std::atomic<int> next(0);
    auto work = [&]() {
      int p;
      while ((p = next.fetch_add(1)) < n_props) {
        auto& v = C.sorted[p];
        v.resize(n);
        for (int64_t i = 0; i < n; i++) v[i] = (int32_t)i;
        const int32_t* pv = props + (size_t)p * n;
        std::sort(v.begin(), v.end(),
                  [pv](int32_t x, int32_t y) { return pv[x] < pv[y]; });
      }
    };
    std::vector<std::thread> th;
    for (int t = 1; t < nt; t++) th.emplace_back(work);
    work();
    for (auto& t : th) t.join();
  }
  C.scratch.resize(n);

  std::vector<Leaf> pool;
  pool.reserve(2 * max_leaves);
  pool.push_back(Leaf{0, n, 0, 0, -1.0, -1, 0});
  best_pred(C, pool[0]);
  best_split(C, pool[0]);
  std::vector<int> leaves = {0};
  while ((int)leaves.size() < max_leaves) {
    int bi = -1;
    double bg = 0.0;
    for (int li : leaves) {
      if (pool[li].gain > 0.0 && (bi < 0 || pool[li].gain > bg)) {
        bi = li; bg = pool[li].gain;
      }
    }
    if (bi < 0) break;
    Leaf& L = pool[bi];
    int p = L.sprop;
    int64_t sv = L.sval;
    // stable partition every property's range: prop > sv first (lchild)
    const int32_t* pv = C.props + (size_t)p * C.n;
    int64_t mid = 0;
    for (int pp = 0; pp < C.n_props; pp++) {
      int32_t* arr = C.sorted[pp].data();
      int64_t w0 = L.a;          // write ptr: left side
      int64_t nr = 0;            // right count in scratch
      for (int64_t i = L.a; i < L.b; i++) {
        int32_t s = arr[i];
        if ((int64_t)pv[s] > sv) arr[w0++] = s;
        else C.scratch[nr++] = s;
      }
      std::memcpy(arr + w0, C.scratch.data(), nr * sizeof(int32_t));
      mid = w0;
    }
    int il = (int)pool.size();
    // NOTE: pool may reallocate; re-reference L afterwards
    pool.push_back(Leaf{pool[bi].a, mid, 0, 0, -1.0, -1, 0});
    pool.push_back(Leaf{mid, pool[bi].b, 0, 0, -1.0, -1, 0});
    pool[bi].left = il;
    pool[bi].right = il + 1;
    pool[bi].prop = p;
    pool[bi].splitval = sv;
    best_pred(C, pool[il]);
    best_pred(C, pool[il + 1]);
    best_split(C, pool[il]);
    best_split(C, pool[il + 1]);
    // python: leaves.remove(leaf); leaves += [left, right]
    for (size_t i = 0; i < leaves.size(); i++) {
      if (leaves[i] == bi) { leaves.erase(leaves.begin() + i); break; }
    }
    leaves.push_back(il);
    leaves.push_back(il + 1);
  }

  // BFS serialization (decode layout, dec_ma.cc:107-159)
  std::vector<int> queue = {0};
  size_t qh = 0;
  int64_t count = 0;
  while (qh < queue.size()) {
    int ni = queue[qh++];
    const Leaf& L = pool[ni];
    if (L.left < 0) {
      out_prop[count] = -1;
      out_sval[count] = 0;
      out_child[count] = 0;
      out_pred[count] = L.pred;
    } else {
      int64_t base = count + (int64_t)(queue.size() - qh) + 1;
      out_prop[count] = L.prop;
      out_sval[count] = (int32_t)L.splitval;
      out_child[count] = (int32_t)base;
      out_pred[count] = 0;
      queue.push_back(L.left);
      queue.push_back(L.right);
    }
    count++;
  }
  return count;
}

// ---------------------------------------------------------------------------
// Entropy-encode tail (no-LZ77): histogram clustering + normalization +
// quantized serialization + context-map coding + per-cluster hybrid-uint
// config search + per-group reverse-rANS emission, in ONE call.
//
// Exact port of the Python pipeline (entropy/ans.py build_entropy_codes +
// write_entropy_codes + write_tokens, entropy/histogram.py; reference
// semantics enc_ans.cc:915 BuildAndStoreEntropyCodes / enc_cluster.cc /
// enc_context_map.cc). Bit-identical output to the Python path (modulo
// float near-ties in clustering, which only change a valid encoder choice).
// ---------------------------------------------------------------------------

namespace enc_tail {

constexpr int kLogAlpha = 8;
constexpr int kAlpha = 1 << kLogAlpha;   // 256

// growable LSB-first bit writer (internal candidates/headers)
struct VecBW {
  std::vector<uint8_t> buf;
  int64_t bitpos = 0;
  inline void Write(uint32_t nbits, uint64_t value) {
    if (!nbits) return;
    size_t need = (size_t)((bitpos + nbits + 7) / 8);
    if (buf.size() < need + 8) buf.resize(need + 8, 0);
    int64_t byte = bitpos >> 3;
    int off = bitpos & 7;
    uint64_t v = value & ((nbits >= 64) ? ~0ull : ((1ull << nbits) - 1));
    uint64_t cur = v << off;
    int total = off + (int)nbits;
    int n_bytes = (total + 7) / 8;
    for (int i = 0; i < n_bytes && i < 8; i++) {
      buf[byte + i] |= (uint8_t)(cur & 0xFF);
      cur >>= 8;
    }
    if (total > 64) buf[byte + 8] |= (uint8_t)(v >> (64 - off));
    bitpos += nbits;
  }
  inline void Append(const VecBW& o) {
    int64_t left = o.bitpos;
    int64_t pos = 0;
    while (left > 0) {
      int take = (int)std::min<int64_t>(32, left);
      // read `take` bits at pos from o.buf
      uint64_t w = 0;
      int64_t byte = pos >> 3;
      for (int i = 0; i < 6 && byte + i < (int64_t)o.buf.size(); i++)
        w |= ((uint64_t)o.buf[byte + i]) << (8 * i);
      w >>= (pos & 7);
      Write(take, w & ((take >= 64) ? ~0ull : ((1ull << take) - 1)));
      pos += take;
      left -= take;
    }
  }
};

static inline void hybrid_enc(uint32_t v, int se, int msb, int lsb,
                              int32_t* tok, int32_t* nb, uint32_t* bits) {
  uint32_t split = 1u << se;
  if (v < split) { *tok = (int32_t)v; *nb = 0; *bits = 0; return; }
  int n = 31 - __builtin_clz(v);
  uint32_t m = v - (1u << n);
  int nbits = n - msb - lsb;
  uint32_t msb_part = m >> (uint32_t)std::max(n - msb, 0);
  *tok = (int32_t)(split + (((uint32_t)(n - se)) << (msb + lsb)) +
                   (msb_part << lsb) + (m & ((1u << lsb) - 1u)));
  *nb = nbits;
  *bits = (nbits > 0) ? ((v >> lsb) & ((1u << nbits) - 1u)) : 0;
}

static inline void varlen_u8(VecBW& w, uint32_t v) {
  if (v == 0) { w.Write(1, 0); return; }
  w.Write(1, 1);
  int nbits = 31 - __builtin_clz(v);
  w.Write(3, nbits);
  if (nbits) w.Write(nbits, v - (1u << nbits));
}

static inline int pop_count_precision(int logcount, int shift) {
  int r = std::min(logcount, shift - ((kAnsLogTabSize - logcount) >> 1));
  return std::max(r, 0);
}

// normalize to sum 4096 keeping nonzeros nonzero (ans.py normalize_counts)
static void normalize_counts(const int64_t* hist, int A, int64_t* out) {
  int64_t total = 0;
  int n_nz = 0;
  int argmax = 0;
  for (int i = 0; i < A; i++) {
    total += hist[i];
    if (hist[i] > 0) n_nz++;
    if (hist[i] > hist[argmax]) argmax = i;
  }
  if (n_nz == 1) {
    for (int i = 0; i < A; i++) out[i] = 0;
    out[argmax] = kAnsTabSize;
    return;
  }
  std::vector<double> scaled(A), frac(A);
  int64_t sum = 0;
  for (int i = 0; i < A; i++) {
    scaled[i] = (double)hist[i] * (double)(kAnsTabSize - n_nz) /
                (double)total;
    double fl = std::floor(scaled[i]);
    out[i] = (int64_t)fl + (hist[i] > 0 ? 1 : 0);
    frac[i] = hist[i] > 0 ? scaled[i] - fl : -1.0;
    sum += out[i];
  }
  int64_t deficit = kAnsTabSize - sum;
  if (deficit > 0) {
    // argsort(-frac, stable): descending frac, ties by index
    std::vector<int> order(A);
    for (int i = 0; i < A; i++) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int a, int b) { return frac[a] > frac[b]; });
    for (int64_t j = 0; j < deficit; j++) out[order[j]] += 1;
  } else if (deficit < 0) {
    std::vector<int> order(A);
    for (int i = 0; i < A; i++) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int a, int b) { return out[a] > out[b]; });
    int64_t k = -deficit;
    for (int oi : order) {
      if (k == 0) break;
      int64_t room = hist[oi] > 0 ? out[oi] - 1 : 0;
      int64_t take = std::min(room, k);
      out[oi] -= take;
      k -= take;
    }
  }
}

// quantize to `shift` precision (histogram.py quantize_histogram)
static void quantize_histogram(int64_t* counts, int A, int shift) {
  if (shift >= kAnsLogTabSize + 1) return;
  int n_nz = 0;
  for (int i = 0; i < A; i++) if (counts[i]) n_nz++;
  if (n_nz <= 2) return;
  int omit = 0;
  for (int i = 1; i < A; i++) if (counts[i] > counts[omit]) omit = i;
  std::vector<int64_t> out(counts, counts + A);
  for (int i = 0; i < A; i++) {
    int64_t c = counts[i];
    if (c == 0 || i == omit) continue;
    int lc = 63 - __builtin_clzll((uint64_t)c);
    int bitcount = pop_count_precision(lc, shift);
    int64_t step = 1ll << (lc - bitcount);
    int64_t mant = (c - (1ll << lc) + step / 2) / step;
    if (mant >= (1ll << bitcount)) mant = (1ll << bitcount) - 1;
    out[i] = (1ll << lc) + mant * step;
  }
  int64_t rem = kAnsTabSize;
  for (int i = 0; i < A; i++) if (i != omit) rem -= out[i];
  if (rem <= 0) return;          // keep exact
  out[omit] = rem;
  // decoder derives omit as FIRST max logcount; verify
  int best = -1, best_log = -2;
  for (int i = 0; i < A; i++) {
    int lg = out[i] ? 63 - __builtin_clzll((uint64_t)out[i]) : -1;
    if (lg > best_log) { best_log = lg; best = i; }
  }
  if (best != omit) return;      // keep exact
  for (int i = 0; i < A; i++) counts[i] = out[i];
}

// logcount-symbol static prefix code: sym -> (nbits, lsb-first code)
static const int kHuffBits[14] = {5,4,4,4,4,4,3,3,3,3,3,6,7,7};
static const int kHuffCode[14] = {17,11,15,3,9,7,4,2,5,6,0,33,1,65};

// write one histogram (counts sum 4096, already quantized) — EncodeCounts
static void write_histogram(VecBW& w, const int64_t* counts_in, int A_in,
                            int shift) {
  int A = A_in;
  while (A > 0 && counts_in[A - 1] == 0) A--;
  std::vector<int64_t> counts(counts_in, counts_in + A);
  int nz = 0, first = -1, second = -1;
  for (int i = 0; i < A; i++)
    if (counts[i]) { if (first < 0) first = i; else if (second < 0) second = i; nz++; }
  if (nz == 1) {
    w.Write(1, 1); w.Write(1, 0); varlen_u8(w, first);
    return;
  }
  if (nz == 2) {
    w.Write(1, 1); w.Write(1, 1);
    varlen_u8(w, first); varlen_u8(w, second);
    w.Write(kAnsLogTabSize, counts[first]);
    return;
  }
  // flat?
  {
    int64_t base = kAnsTabSize / A, rem = kAnsTabSize % A;
    bool flat = true;
    for (int i = 0; i < A; i++)
      if (counts[i] != base + (i < rem ? 1 : 0)) { flat = false; break; }
    if (flat) {
      w.Write(1, 0); w.Write(1, 1); varlen_u8(w, A - 1);
      return;
    }
  }
  w.Write(1, 0); w.Write(1, 0);
  int v = shift + 1;
  int log = 31 - __builtin_clz((uint32_t)v);
  int upper = 3;   // bit_length(13)-1
  for (int i = 0; i < log; i++) w.Write(1, 1);
  if (log < upper) w.Write(1, 0);
  w.Write(log, v - (1 << log));
  varlen_u8(w, A - 3);
  std::vector<int> logc(A);
  int omit = 0, omit_log = -2;
  for (int i = 0; i < A; i++) {
    logc[i] = counts[i] > 0 ? 63 - __builtin_clzll((uint64_t)counts[i]) : -1;
    if (logc[i] > omit_log) { omit_log = logc[i]; omit = i; }
  }
  for (int i = 0; i < A; i++) {
    int sym = (counts[i] == 0 && i != omit) ? 0 : logc[i] + 1;
    w.Write(kHuffBits[sym], kHuffCode[sym]);
  }
  for (int i = 0; i < A; i++) {
    if (i == omit || counts[i] == 0) continue;
    int lc = logc[i];
    if (shift != 0 && lc != 0) {
      int bitcount = pop_count_precision(lc, shift);
      int64_t mant = (counts[i] - (1ll << lc)) >> (lc - bitcount);
      w.Write(bitcount, (uint64_t)mant);
    }
  }
}

// encoder slot tables from normalized counts (alias.py build_encoder_slots)
struct EncTables {
  std::vector<int64_t> start;   // kAlpha+1
  std::vector<int32_t> slots;   // 4096
  std::vector<int64_t> freq;    // kAlpha
};

static bool build_slots(const int64_t* norm, int A_in, EncTables& T) {
  int A = A_in;
  while (A > 0 && norm[A - 1] == 0) A--;
  std::vector<int64_t> dist(norm, norm + A);
  if (dist.empty()) dist.push_back(kAnsTabSize);
  int table_size = kAlpha;
  if ((int)dist.size() > table_size) return false;
  int entry_size = kAnsTabSize / table_size;       // 16
  int log_entry = 4;
  T.freq.assign(kAlpha, 0);
  for (size_t i = 0; i < dist.size(); i++) T.freq[i] = dist[i];
  std::vector<int32_t> sym(kAnsTabSize), off(kAnsTabSize);
  int single = -1;
  for (size_t i = 0; i < dist.size(); i++)
    if (dist[i] == kAnsTabSize) single = (int)i;
  if (single >= 0) {
    for (int vv = 0; vv < (int)kAnsTabSize; vv++) { sym[vv] = single; off[vv] = vv; }
  } else {
    std::vector<int64_t> cutoffs(table_size, 0), right(table_size, 0),
        offsets1(table_size, 0), cutoff(table_size, 0);
    std::vector<int> under, over;
    for (int i = 0; i < table_size; i++) {
      cutoffs[i] = i < (int)dist.size() ? dist[i] : 0;
      if (cutoffs[i] > entry_size) over.push_back(i);
      else if (cutoffs[i] < entry_size) under.push_back(i);
    }
    while (!over.empty()) {
      int oi = over.back(); over.pop_back();
      if (under.empty()) return false;
      int ui = under.back(); under.pop_back();
      int64_t by = entry_size - cutoffs[ui];
      cutoffs[oi] -= by;
      right[ui] = oi;
      offsets1[ui] = cutoffs[oi];
      if (cutoffs[oi] < entry_size) under.push_back(oi);
      else if (cutoffs[oi] > entry_size) over.push_back(oi);
    }
    for (int i = 0; i < table_size; i++) {
      if (cutoffs[i] == entry_size) { right[i] = i; offsets1[i] = 0; cutoff[i] = 0; }
      else { offsets1[i] -= cutoffs[i]; cutoff[i] = cutoffs[i]; }
    }
    for (int vv = 0; vv < (int)kAnsTabSize; vv++) {
      int i = vv >> log_entry;
      int pos = vv & (entry_size - 1);
      bool greater = pos >= cutoff[i];
      sym[vv] = greater ? (int32_t)right[i] : i;
      off[vv] = greater ? (int32_t)(offsets1[i] + pos) : pos;
    }
  }
  T.start.assign(kAlpha + 1, 0);
  for (int i = 0; i < kAlpha; i++) T.start[i + 1] = T.start[i] + T.freq[i];
  T.slots.assign(kAnsTabSize, 0);
  for (int vv = 0; vv < (int)kAnsTabSize; vv++)
    T.slots[T.start[sym[vv]] + off[vv]] = vv;
  return true;
}

static double ent_cost(const int64_t* h, int A) {
  int64_t tot = 0;
  double e = 0;
  for (int i = 0; i < A; i++) {
    tot += h[i];
    if (h[i] > 0) e += (double)h[i] * std::log2((double)h[i]);
  }
  if (tot == 0) return 0.0;
  return (double)tot * std::log2((double)tot) - e;
}

// FastClusterHistograms port (ans.py cluster_histograms)
static void cluster(const int64_t* hists, int n_ctx, int A,
                    int max_clusters, std::vector<int32_t>& cmap,
                    std::vector<std::vector<int64_t>>& clustered) {
  int width = 0;
  for (int i = 0; i < n_ctx; i++)
    for (int a = A - 1; a >= 0; a--)
      if (hists[(size_t)i * A + a]) { width = std::max(width, a + 1); break; }
  if (width == 0) width = 1;
  std::vector<int64_t> totals(n_ctx, 0);
  for (int i = 0; i < n_ctx; i++)
    for (int a = 0; a < width; a++) totals[i] += hists[(size_t)i * A + a];
  std::vector<int> order(n_ctx);
  for (int i = 0; i < n_ctx; i++) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return totals[a] > totals[b]; });
  std::vector<std::vector<int64_t>> C;
  std::vector<double> costs;
  cmap.assign(n_ctx, 0);
  for (int idx : order) {
    if (totals[idx] == 0 && !C.empty()) { cmap[idx] = 0; continue; }
    const int64_t* h = hists + (size_t)idx * A;
    double own = ent_cost(h, width);
    int best = -1;
    double best_cost = 0.0, merged_best = 0.0;
    for (size_t c = 0; c < C.size(); c++) {
      std::vector<int64_t> m(width);
      for (int a = 0; a < width; a++) m[a] = C[c][a] + h[a];
      double mc = ent_cost(m.data(), width);
      double d = mc - costs[c] - own;
      if (best < 0 || d < best_cost) { best = (int)c; best_cost = d;
                                       merged_best = mc; }
    }
    int nnz = 0;
    for (int a = 0; a < width; a++) if (h[a] > 0) nnz++;
    double ser_est = nnz <= 1 ? 12.0 : nnz == 2 ? 33.0
                     : 40.0 + 5.5 * nnz;
    if (!C.empty() && (best_cost <= std::max(ser_est, 0.01 * own) ||
                       (int)C.size() >= max_clusters)) {
      for (int a = 0; a < width; a++) C[best][a] += h[a];
      costs[best] = merged_best;
      cmap[idx] = best;
    } else {
      cmap[idx] = (int32_t)C.size();
      C.push_back(std::vector<int64_t>(h, h + width));
      costs.push_back(own);
    }
  }
  if (C.empty()) C.push_back(std::vector<int64_t>(width, 0));
  clustered = std::move(C);
}

static void mtf_transform(const int32_t* v, int n, int32_t* out) {
  int maxv = 0;
  for (int i = 0; i < n; i++) maxv = std::max(maxv, (int)v[i]);
  std::vector<int> mtf(maxv + 1);
  for (int i = 0; i <= maxv; i++) mtf[i] = i;
  for (int i = 0; i < n; i++) {
    int idx = 0;
    while (mtf[idx] != v[i]) idx++;
    out[i] = idx;
    if (idx) {
      int val = mtf[idx];
      mtf.erase(mtf.begin() + idx);
      mtf.insert(mtf.begin(), val);
    }
  }
}

// single/dual-context stream build + emit for the context-map candidates.
// rows: (n, 3) of (ctx, val, kind): kind 0 literal, 1 lz length (token
// gets +min_symbol under length cfg), 2 distance. n_ctx counts the
// distance context when lz_on.
static bool emit_small_stream(VecBW& w, const int32_t* ctx,
                              const int32_t* val, const int8_t* kind,
                              int n, int n_ctx, bool lz_on);

// encode_context_map port (recursion depth <= 2: inner maps are tiny)
static void encode_context_map(VecBW& w, const int32_t* cm, int n,
                               int num_histograms) {
  if (n <= 1) return;
  if (num_histograms == 1) { w.Write(1, 1); w.Write(2, 0); return; }
  int bpe = 0;
  while ((1 << bpe) < num_histograms) bpe++;
  std::vector<VecBW> cands;
  if (bpe <= 3) {
    VecBW ww;
    ww.Write(1, 1); ww.Write(2, bpe);
    for (int i = 0; i < n; i++) ww.Write(bpe, cm[i]);
    if (n <= 16) { w.Append(ww); return; }
    cands.push_back(std::move(ww));
  }
  std::vector<int32_t> mtf(n);
  mtf_transform(cm, n, mtf.data());
  bool allow_lz = n > 2 && n >= 16;
  for (int use_mtf = 0; use_mtf <= 1; use_mtf++) {
    const int32_t* arr = use_mtf ? mtf.data() : cm;
    for (int use_lz = 0; use_lz <= 1; use_lz++) {
      if (use_lz && !allow_lz) continue;
      VecBW ww;
      ww.Write(1, 0);
      ww.Write(1, use_mtf);
      if (use_lz) {
        // RLE transform (ans.py lz77_rle_transform, min_emit=4,
        // min_length=3 -> min_run=4, no distance multiplier)
        std::vector<int32_t> rc, rv;
        std::vector<int8_t> rk;
        int pos = 0;
        bool any = false;
        int i = 1;
        while (i < n) {
          int a = i;
          while (i < n && arr[i] == arr[i - 1]) i++;
          int run = i - a;
          if (run >= 4 && a > 0) {
            for (int j = pos; j < a; j++) { rc.push_back(0);
              rv.push_back(arr[j]); rk.push_back(0); }
            rc.push_back(0); rv.push_back(run); rk.push_back(1);
            rc.push_back(1); rv.push_back(0); rk.push_back(2);
            pos = i;
            any = true;
          }
          if (i == n) break;
          if (run == 0) i++;
        }
        if (!any) continue;     // py: len(t) >= len(arr) -> skip
        for (int j = pos; j < n; j++) { rc.push_back(0);
          rv.push_back(arr[j]); rk.push_back(0); }
        if ((int)rc.size() >= n) continue;
        if (!emit_small_stream(ww, rc.data(), rv.data(), rk.data(),
                               (int)rc.size(), 2, true)) continue;
      } else {
        std::vector<int32_t> zc(n, 0);
        std::vector<int8_t> zk(n, 0);
        if (!emit_small_stream(ww, zc.data(), arr, zk.data(), n, 1,
                               false)) continue;
      }
      cands.push_back(std::move(ww));
    }
  }
  int best = 0;
  for (size_t i = 1; i < cands.size(); i++)
    if (cands[i].bitpos < cands[best].bitpos) best = (int)i;
  w.Append(cands[best]);
}

static bool emit_small_stream(VecBW& w, const int32_t* ctx,
                              const int32_t* val, const int8_t* kind,
                              int n, int n_ctx, bool lz_on) {
  // tokenize: default cfg (4,2,0); lengths use cfg (0,0,0) + 224
  std::vector<int32_t> tok(n), nb(n);
  std::vector<uint32_t> bits(n);
  int max_tok = 0;
  for (int i = 0; i < n; i++) {
    if (kind[i] == 1) {
      hybrid_enc((uint32_t)(val[i] - 3), 0, 0, 0, &tok[i], &nb[i],
                 &bits[i]);
      tok[i] += 224;
    } else {
      hybrid_enc((uint32_t)val[i], 4, 2, 0, &tok[i], &nb[i], &bits[i]);
    }
    max_tok = std::max(max_tok, (int)tok[i]);
  }
  if (max_tok >= kAlpha) return false;
  // histograms per context — NO clustering (mirrors the Python
  // candidates: build_entropy_codes(..., allow_clustering=False))
  std::vector<int64_t> hists((size_t)n_ctx * kAlpha, 0);
  for (int i = 0; i < n; i++) hists[(size_t)ctx[i] * kAlpha + tok[i]]++;
  std::vector<int32_t> cmap(n_ctx);
  std::vector<std::vector<int64_t>> clustered;
  for (int c = 0; c < n_ctx; c++) {
    cmap[c] = c;
    clustered.push_back(std::vector<int64_t>(
        hists.begin() + (size_t)c * kAlpha,
        hists.begin() + (size_t)(c + 1) * kAlpha));
  }
  // header: lz77 params
  w.Write(1, lz_on ? 1 : 0);
  if (lz_on) {
    // min_symbol 224 -> U32Enc selector 0 (Val 224); min_length 3 -> 0
    w.Write(2, 0);
    w.Write(2, 0);
    // length_uint_config (0,0,0) with log_alpha 8:
    // split_exponent 0 in ceil_log2(9)=4 bits
    w.Write(4, 0);
  }
  if (n_ctx > 1)
    encode_context_map(w, cmap.data(), n_ctx, (int)clustered.size());
  w.Write(1, 0);                 // prefix off
  w.Write(2, kLogAlpha - 5);
  for (size_t h = 0; h < clustered.size(); h++) {
    // uint config (4,2,0): split 4 (4 bits), msb 2 (3 bits), lsb 0
    // (ceil_log2(4-2+1)=2 bits)
    w.Write(4, 4); w.Write(3, 2); w.Write(2, 0);
  }
  std::vector<EncTables> tabs(clustered.size());
  for (size_t h = 0; h < clustered.size(); h++) {
    std::vector<int64_t> norm(kAlpha, 0);
    std::vector<int64_t> hh(clustered[h]);
    while (!hh.empty() && hh.back() == 0) hh.pop_back();
    if (hh.empty()) hh.push_back(1);
    normalize_counts(hh.data(), (int)hh.size(), norm.data());
    // histo_shift default 13 here: no quantization
    write_histogram(w, norm.data(), (int)hh.size(), 13);
    if (!build_slots(norm.data(), (int)hh.size(), tabs[h])) return false;
  }
  // emission (reverse)
  std::vector<uint32_t> rev_b;
  std::vector<uint8_t> rev_n;
  uint32_t state = kAnsSignature << 16;
  for (int i = n - 1; i >= 0; i--) {
    if (nb[i]) { rev_b.push_back(bits[i]); rev_n.push_back((uint8_t)nb[i]); }
    int h = cmap[ctx[i]];
    uint32_t freq = (uint32_t)tabs[h].freq[tok[i]];
    if ((state >> (32 - kAnsLogTabSize)) >= freq) {
      rev_b.push_back(state & 0xFFFF); rev_n.push_back(16);
      state >>= 16;
    }
    state = ((state / freq) << kAnsLogTabSize) +
            (uint32_t)tabs[h].slots[tabs[h].start[tok[i]] + state % freq];
  }
  w.Write(32, state);
  for (int64_t i = (int64_t)rev_b.size() - 1; i >= 0; i--)
    w.Write(rev_n[i], rev_b[i]);
  return true;
}

static const int kUintCand[10][3] = {
    {4,2,0},{4,1,0},{4,2,1},{4,1,2},{5,2,0},{5,1,0},{3,2,0},{2,0,1},
    {0,0,0},{7,0,0}};

}  // namespace enc_tail

// Full no-LZ77 entropy tail. tokens: (N,2) int64 rows (ctx, val).
// Group g covers rows [grp_off[g], grp_off[g+1]). Outputs:
//  - header (codes serialization, write_entropy_codes layout) into
//    hdr_out/hdr_bits
//  - per-group token streams into grp_out + g*grp_stride, bit lengths in
//    grp_bits
// Returns num_histograms (>0) or -1 on error/overflow.
EXPORT int64_t jxlt_entropy_tail(
    const int64_t* tokens, int64_t n_rows, const int64_t* grp_off,
    int32_t n_groups, int32_t num_contexts, int32_t max_clusters,
    int32_t histo_shift, int32_t uint_search, uint8_t* hdr_out,
    int64_t hdr_cap, int64_t* hdr_bits, uint8_t* grp_out,
    int64_t grp_stride, int64_t* grp_bits) {
  using namespace enc_tail;
  if (num_contexts <= 0 || n_groups <= 0) return -1;

  // default-config tokenization of everything
  std::vector<int32_t> tok(n_rows), nb(n_rows);
  std::vector<uint32_t> bits(n_rows);
  int max_tok = 0;
  for (int64_t i = 0; i < n_rows; i++) {
    hybrid_enc((uint32_t)tokens[2 * i + 1], 4, 2, 0, &tok[i], &nb[i],
               &bits[i]);
    max_tok = std::max(max_tok, (int)tok[i]);
  }
  if (max_tok >= kAlpha) return -1;
  std::vector<int64_t> hists((size_t)num_contexts * kAlpha, 0);
  for (int64_t i = 0; i < n_rows; i++) {
    int64_t c = tokens[2 * i];
    if (c < 0 || c >= num_contexts) return -1;
    hists[(size_t)c * kAlpha + tok[i]]++;
  }
  std::vector<int32_t> cmap;
  std::vector<std::vector<int64_t>> clustered;
  cluster(hists.data(), num_contexts, kAlpha, max_clusters, cmap,
          clustered);
  int K = (int)clustered.size();

  // per-cluster hybrid-uint config search (ans.py uint_search port,
  // incl. the >=2^15 subsampling)
  std::vector<std::array<int, 3>> cfgs(K, std::array<int, 3>{4, 2, 0});
  std::vector<std::vector<int64_t>> final_hist(K);
  for (int h = 0; h < K; h++) {
    std::vector<int64_t> hh(clustered[h]);
    while (!hh.empty() && hh.back() == 0) hh.pop_back();
    if (hh.empty()) hh.push_back(1);
    final_hist[h] = std::move(hh);
  }
  if (uint_search) {
    // cluster values grouped via stable counting sort by cluster
    std::vector<int64_t> cnt(K + 1, 0);
    std::vector<int32_t> row_cl(n_rows);
    for (int64_t i = 0; i < n_rows; i++) {
      row_cl[i] = cmap[tokens[2 * i]];
      cnt[row_cl[i] + 1]++;
    }
    for (int h = 0; h < K; h++) cnt[h + 1] += cnt[h];
    std::vector<uint32_t> vals(n_rows);
    {
      std::vector<int64_t> w0(cnt.begin(), cnt.end() - 1);
      for (int64_t i = 0; i < n_rows; i++)
        vals[w0[row_cl[i]]++] = (uint32_t)tokens[2 * i + 1];
    }
    for (int h = 0; h < K; h++) {
      int64_t a = cnt[h], b = cnt[h + 1];
      int64_t m = b - a;
      if (m < 64) continue;
      int64_t step = 1;
      if (m > (1ll << 15)) step = (m >> 15) + 1;
      double sfac = (double)m / (double)((m + step - 1) / step);
      double best_cost = 0;
      int best_c = -1;
      std::vector<int64_t> best_h;
      for (int c = 0; c < 10; c++) {
        int se = kUintCand[c][0], ms = kUintCand[c][1],
            ls = kUintCand[c][2];
        std::vector<int64_t> hist(kAlpha, 0);
        double rawbits = 0;
        bool bad = false;
        for (int64_t i = a; i < b; i += step) {
          int32_t t, nbi; uint32_t bi;
          hybrid_enc(vals[i], se, ms, ls, &t, &nbi, &bi);
          if (t >= kAlpha) { bad = true; break; }
          hist[t]++;
          rawbits += nbi;
        }
        if (bad) continue;
        std::vector<int64_t> hh(hist);
        while (!hh.empty() && hh.back() == 0) hh.pop_back();
        if (hh.empty()) hh.push_back(1);
        std::vector<int64_t> norm(kAlpha, 0);
        normalize_counts(hh.data(), (int)hh.size(), norm.data());
        quantize_histogram(norm.data(), (int)hh.size(), histo_shift);
        double ans_bits = 0;
        for (size_t t2 = 0; t2 < hh.size(); t2++) {
          if (hh[t2] > 0 && norm[t2] > 0)
            ans_bits += -(double)hh[t2] *
                        std::log2((double)norm[t2] / kAnsTabSize);
        }
        VecBW hw;
        write_histogram(hw, norm.data(), (int)hh.size(), histo_shift);
        double cost = sfac * (ans_bits + rawbits) + (double)hw.bitpos;
        if (best_c < 0 || cost < best_cost) {
          best_cost = cost; best_c = c; best_h = hist;
        }
      }
      if (best_c >= 0) {
        cfgs[h] = {kUintCand[best_c][0], kUintCand[best_c][1],
                   kUintCand[best_c][2]};
        if (step > 1) {
          // re-tokenize winner at full size
          int se = cfgs[h][0], ms = cfgs[h][1], ls = cfgs[h][2];
          std::vector<int64_t> hist(kAlpha, 0);
          bool bad = false;
          for (int64_t i = a; i < b; i++) {
            int32_t t, nbi; uint32_t bi;
            hybrid_enc(vals[i], se, ms, ls, &t, &nbi, &bi);
            if (t >= kAlpha) { bad = true; break; }
            hist[t]++;
          }
          if (bad) { cfgs[h] = {4, 2, 0}; continue; }
          best_h = std::move(hist);
        }
        std::vector<int64_t> hh(best_h);
        while (!hh.empty() && hh.back() == 0) hh.pop_back();
        if (hh.empty()) hh.push_back(1);
        final_hist[h] = std::move(hh);
      }
    }
  }

  // normalized+quantized histograms + slot tables
  std::vector<EncTables> tabs(K);
  std::vector<std::vector<int64_t>> norm(K);
  for (int h = 0; h < K; h++) {
    norm[h].assign(kAlpha, 0);
    normalize_counts(final_hist[h].data(), (int)final_hist[h].size(),
                     norm[h].data());
    quantize_histogram(norm[h].data(), (int)final_hist[h].size(),
                       histo_shift);
    if (!build_slots(norm[h].data(), (int)final_hist[h].size(), tabs[h]))
      return -1;
  }

  // ---- header ----
  VecBW hdr;
  hdr.Write(1, 0);                           // lz77 off
  if (num_contexts > 1)
    encode_context_map(hdr, cmap.data(), num_contexts, K);
  hdr.Write(1, 0);                           // prefix off
  hdr.Write(2, kLogAlpha - 5);
  for (int h = 0; h < K; h++) {
    int se = cfgs[h][0], ms = cfgs[h][1], ls = cfgs[h][2];
    hdr.Write(4, se);                        // ceil_log2(9) = 4 bits
    if (se != kLogAlpha) {
      int b1 = 0; while ((1 << b1) < se + 1) b1++;
      hdr.Write(b1, ms);
      int b2 = 0; while ((1 << b2) < se - ms + 1) b2++;
      hdr.Write(b2, ls);
    }
  }
  for (int h = 0; h < K; h++)
    write_histogram(hdr, norm[h].data(), (int)final_hist[h].size(),
                    histo_shift);
  if ((int64_t)hdr.buf.size() > hdr_cap) return -1;
  std::memset(hdr_out, 0, hdr_cap);
  std::memcpy(hdr_out, hdr.buf.data(), hdr.buf.size());
  *hdr_bits = hdr.bitpos;

  // ---- per-group emission (parallel across groups) ----
  bool uniform = true;
  for (int h = 1; h < K; h++) if (cfgs[h] != cfgs[0]) uniform = false;
  bool default_cfg = uniform && cfgs[0][0] == 4 && cfgs[0][1] == 2 &&
                     cfgs[0][2] == 0;
  std::atomic<int> next_g(0);
  std::atomic<bool> fail(false);
  auto work = [&]() {
    int g;
    std::vector<uint32_t> rev_b;
    std::vector<uint8_t> rev_n;
    while ((g = next_g.fetch_add(1)) < n_groups) {
      if (fail.load()) return;
      int64_t a = grp_off[g], b = grp_off[g + 1];
      uint8_t* out = grp_out + (int64_t)g * grp_stride;
      std::memset(out, 0, grp_stride);
      BitSink sink{out, grp_stride};
      rev_b.clear(); rev_n.clear();
      uint32_t state = kAnsSignature << 16;
      for (int64_t i = b - 1; i >= a; i--) {
        int h = cmap[tokens[2 * i]];
        int32_t t; int32_t nbi; uint32_t bi;
        if (default_cfg) { t = tok[i]; nbi = nb[i]; bi = bits[i]; }
        else hybrid_enc((uint32_t)tokens[2 * i + 1], cfgs[h][0],
                        cfgs[h][1], cfgs[h][2], &t, &nbi, &bi);
        if (nbi) { rev_b.push_back(bi); rev_n.push_back((uint8_t)nbi); }
        uint32_t freq = (uint32_t)tabs[h].freq[t];
        if (freq == 0) { fail.store(true); return; }
        if ((state >> (32 - kAnsLogTabSize)) >= freq) {
          rev_b.push_back(state & 0xFFFF); rev_n.push_back(16);
          state >>= 16;
        }
        state = ((state / freq) << kAnsLogTabSize) +
                (uint32_t)tabs[h].slots[tabs[h].start[t] + state % freq];
      }
      sink.Write(32, state);
      for (int64_t i = (int64_t)rev_b.size() - 1; i >= 0; i--)
        sink.Write(rev_n[i], rev_b[i]);
      if (sink.overflow) { fail.store(true); return; }
      grp_bits[g] = sink.bitpos;
    }
  };
  int nt = std::min(n_groups, 3);
  std::vector<std::thread> th;
  for (int t = 1; t < nt; t++) th.emplace_back(work);
  work();
  for (auto& t : th) t.join();
  if (fail.load()) return -1;
  return K;
}
