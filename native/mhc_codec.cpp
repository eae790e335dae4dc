// mhc_codec — native host-side Markov-Huffman unit codec.
//
// The hybrid executor (mhc/hybrid.py) splits the unit batch between
// the device stream and host threads; this file is the host side. Its
// output is BIT-IDENTICAL to the device path by construction: identical
// canonical code assignment (mirrors ops/canonical.py canonical_codes),
// identical MSB-first bit packing (mirrors ops/bitpack.py), identical
// per-unit context reset semantics. Tests enforce the identity.
//
// Capability parity: the reference's encoder/decoder drivers and bit I/O
// are native C++ (SURVEY.md §2 L0/L4, §3.1-3.2); this is their
// multithreaded host counterpart inside the framework.
//
// Build: make -C native (g++ -O3 -pthread; linked into libmhc_host.so).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int MAXL = 15;  // MAX_CODE_LEN (ops/huffman.py)

int hw_threads2() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(std::min(n, 16u)) : 4;
}

template <typename F>
void parallel_range(int64_t R, int nt, F&& fn) {
  if (R <= 0) return;
  if (nt <= 1 || R < 2) {
    fn(0, (int64_t)0, R);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (R + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(R, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=, &fn] { fn(t, lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// Canonical code assignment for one 256-symbol context from lengths —
// mirrors ops/canonical.py canonical_codes (codes right-aligned,
// DEFLATE numbering, rank within length by ascending symbol).
void canon_codes_ctx(const uint8_t* len, uint32_t* code_out) {
  int bl[MAXL + 1] = {0};
  for (int s = 0; s < 256; ++s)
    if (len[s]) ++bl[len[s]];
  uint32_t first[MAXL + 2];
  first[0] = 0;
  uint32_t c = 0;
  for (int l = 1; l <= MAXL; ++l) {
    c = (c + (uint32_t)bl[l - 1]) << 1;
    first[l] = c;
  }
  uint32_t next[MAXL + 1];
  for (int l = 1; l <= MAXL; ++l) next[l] = first[l];
  for (int s = 0; s < 256; ++s) {
    if (len[s])
      code_out[s] = next[len[s]]++;
    else
      code_out[s] = 0;
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// statistics
// ---------------------------------------------------------------------------

// Markov histogram over a contiguous byte range laid out as units of
// `unit` bytes, context reset to 0 at each unit start (the block-parallel
// format's semantics — api.blockify + histogram_markov equivalent).
// counts: int64[256*256], ACCUMULATED into (caller zeroes).
void mhc_hist_markov(const uint8_t* data, int64_t n, int64_t unit,
                     int64_t* counts) {
  int nt = hw_threads2();
  int64_t n_units = (n + unit - 1) / unit;
  std::vector<std::vector<int64_t>> local(nt);
  parallel_range(n_units, nt, [&](int t, int64_t lo, int64_t hi) {
    auto& cnt = local[t];
    cnt.assign(256 * 256, 0);
    for (int64_t u = lo; u < hi; ++u) {
      const uint8_t* p = data + u * unit;
      int64_t m = std::min(unit, n - u * unit);
      int prev = 0;
      for (int64_t i = 0; i < m; ++i) {
        ++cnt[prev * 256 + p[i]];
        prev = p[i];
      }
    }
  });
  for (auto& cnt : local) {
    if (cnt.empty()) continue;
    for (int i = 0; i < 256 * 256; ++i) counts[i] += cnt[i];
  }
}

// Order-0 histogram (no context). counts: int64[256], accumulated.
void mhc_hist_order0(const uint8_t* data, int64_t n, int64_t* counts) {
  int nt = hw_threads2();
  std::vector<std::vector<int64_t>> local(nt);
  parallel_range(n, nt, [&](int t, int64_t lo, int64_t hi) {
    auto& cnt = local[t];
    cnt.assign(256, 0);
    for (int64_t i = lo; i < hi; ++i) ++cnt[data[i]];
  });
  for (auto& cnt : local) {
    if (cnt.empty()) continue;
    for (int i = 0; i < 256; ++i) counts[i] += cnt[i];
  }
}

// ---------------------------------------------------------------------------
// encode
// ---------------------------------------------------------------------------

// Build the packed encode table (len<<16 | code, u32[nctx*256]) from code
// lengths — the host twin of bitpack._gather_codes_lens's packed layout.
void mhc_build_enc_table(const uint8_t* lengths, int64_t nctx,
                         uint32_t* packed) {
  parallel_range(nctx, hw_threads2(), [&](int, int64_t lo, int64_t hi) {
    uint32_t codes[256];
    for (int64_t c = lo; c < hi; ++c) {
      canon_codes_ctx(lengths + c * 256, codes);
      for (int s = 0; s < 256; ++s)
        packed[c * 256 + s] =
            ((uint32_t)lengths[c * 256 + s] << 16) | codes[s];
    }
  });
}

// Encode units [0, n_units) of `data` (unit size `unit`, last unit may be
// short of `n` total bytes). markov: ctx = previous byte (reset 0 per
// unit); order-0 passes a table whose 256 context rows are identical and
// markov=0 skips the context update. Output: rows (n_units, row_stride)
// byte streams MSB-first big-endian, zero-padded; bit_lens[i] = exact
// stream length in BITS (the container index stores bits for the legacy
// layout; byte length = ceil(bits/8)). Bit-identical to
// encode_blocks/_merge on device (tested, tests/test_hybrid.py).
// raw_mode (round 5, container FLAG_RAW_UNITS): 0 = never substitute
// (legacy layouts), 1 = unaligned byte layout (literal when
// ceil(bits/8) >= m), 2 = word-aligned layout (literal when
// ceil(bits/32) >= ceil(m/4)). A literal unit's stream is the original
// bytes and bit_lens = m*8 — the same rule as
// ops/bitpack.substitute_raw_units (containers stay byte-identical
// across the host and device encoders, tested in test_hybrid.py).
void mhc_encode_units(const uint8_t* data, int64_t n, int64_t unit,
                      int64_t n_units, const uint32_t* packed, int markov,
                      uint8_t* rows, int64_t row_stride,
                      int64_t* bit_lens, int raw_mode) {
  parallel_range(n_units, hw_threads2(), [&](int, int64_t lo, int64_t hi) {
    for (int64_t u = lo; u < hi; ++u) {
      const uint8_t* p = data + u * unit;
      int64_t m = std::min(unit, n - u * unit);
      uint8_t* out = rows + u * row_stride;
      uint64_t acc = 0;  // bits accumulate at the top, MSB-first
      int nbits = 0;
      int64_t pos = 0;
      int64_t total_bits = 0;
      int prev = 0;
      for (int64_t i = 0; i < m; ++i) {
        uint32_t e = packed[prev * 256 + p[i]];
        int len = (int)(e >> 16);
        uint32_t code = e & 0xFFFF;
        acc |= (uint64_t)code << (64 - nbits - len);
        nbits += len;
        total_bits += len;
        while (nbits >= 8) {
          out[pos++] = (uint8_t)(acc >> 56);
          acc <<= 8;
          nbits -= 8;
        }
        if (markov) prev = p[i];
      }
      if (nbits > 0) out[pos++] = (uint8_t)(acc >> 56);
      bool raw = (raw_mode == 1 && (total_bits + 7) / 8 >= m) ||
                 (raw_mode == 2 && (total_bits + 31) / 32 >= (m + 3) / 4);
      if (raw) {
        std::memcpy(out, p, (size_t)m);
        pos = m;
        total_bits = m * 8;
      }
      std::memset(out + pos, 0, (size_t)(row_stride - pos));
      bit_lens[u] = total_bits;
    }
  });
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

// Build the O(1) decode LUT: for each context, lut[ctx][w] = sym | len<<8
// for every MAXL-bit window w. Mirrors canonical decode (lim/base/
// first_code) — filled directly from canonical code ranges.
void mhc_build_dec_lut(const uint8_t* lengths, int64_t nctx,
                       uint16_t* lut) {
  parallel_range(nctx, hw_threads2(), [&](int, int64_t lo, int64_t hi) {
    uint32_t codes[256];
    for (int64_t c = lo; c < hi; ++c) {
      const uint8_t* len = lengths + c * 256;
      uint16_t* L = lut + c * (1 << MAXL);
      // default: garbage windows resolve to (sym 0, len 1) — never hit
      // inside the valid bit budget of a well-formed stream
      std::fill(L, L + (1 << MAXL), (uint16_t)(1 << 8));
      canon_codes_ctx(len, codes);
      for (int s = 0; s < 256; ++s) {
        if (!len[s]) continue;
        uint32_t lo_w = codes[s] << (MAXL - len[s]);
        uint32_t hi_w = (codes[s] + 1) << (MAXL - len[s]);
        uint16_t v = (uint16_t)(s | (len[s] << 8));
        std::fill(L + lo_w, L + hi_w, v);
      }
    }
  });
}

// Decode n_units independent unit streams into `out` (contiguous,
// unit-strided: unit u writes out[u*unit .. u*unit+m)). payload points at
// the first unit's stream; offsets[u] = byte offset of unit u's stream
// within payload; byte_lens[u] its length. markov: decoded byte becomes
// the next context (reset 0 per unit).
// raw_mode as in mhc_encode_units: literal units are detected by their
// stored length reaching the layout size of the unit's original bytes
// and copied through without entropy decode.
void mhc_decode_units(const uint8_t* payload, const int64_t* offsets,
                      const int64_t* byte_lens, int64_t n_units,
                      int64_t unit, int64_t n_total, const uint16_t* lut,
                      int markov, uint8_t* out, int raw_mode) {
  parallel_range(n_units, hw_threads2(), [&](int, int64_t lo, int64_t hi) {
    for (int64_t u = lo; u < hi; ++u) {
      const uint8_t* src = payload + offsets[u];
      int64_t nb = byte_lens[u];
      int64_t m = std::min(unit, n_total - u * unit);
      uint8_t* dst = out + u * unit;
      if ((raw_mode == 1 && nb == m) ||
          (raw_mode == 2 && nb == ((m + 3) / 4) * 4)) {
        std::memcpy(dst, src, (size_t)m);
        continue;
      }
      uint64_t acc = 0;  // next bits left-aligned at the top
      int nbits = 0;
      int64_t pos = 0;
      int prev = 0;
      for (int64_t i = 0; i < m; ++i) {
        while (nbits <= 56) {
          acc |= (uint64_t)(pos < nb ? src[pos] : 0) << (56 - nbits);
          ++pos;
          nbits += 8;
        }
        uint16_t e = lut[((int64_t)prev << MAXL) + (acc >> (64 - MAXL))];
        int len = e >> 8;
        uint8_t sym = (uint8_t)(e & 0xFF);
        acc <<= len;
        nbits -= len;
        dst[i] = sym;
        if (markov) prev = sym;
      }
    }
  });
}

// ---------------------------------------------------------------------------
// tiny order-0 entropy codec for container metadata sections (table
// nibbles, index residual bytes). Single-threaded: sections are ~30 KB.
// Canonical semantics identical to canon_codes_ctx (alphabet <= 256).
// ---------------------------------------------------------------------------

// Decode n_out symbols from a MSB-first bitstream given per-symbol code
// lengths (alphabet A <= 256). Returns bytes consumed, or -1 on error.
int64_t mhc_entropy_decode(const uint8_t* src, int64_t nb, const uint8_t* lens,
                           int64_t A, int64_t n_out, uint8_t* out) {
  uint8_t len256[256];
  std::memset(len256, 0, 256);
  std::memcpy(len256, lens, (size_t)A);
  uint32_t codes[256];
  canon_codes_ctx(len256, codes);
  std::vector<uint16_t> lut(1 << MAXL, (uint16_t)0);
  for (int s = 0; s < 256; ++s) {
    if (!len256[s]) continue;
    uint32_t lo_w = codes[s] << (MAXL - len256[s]);
    uint32_t hi_w = (codes[s] + 1) << (MAXL - len256[s]);
    std::fill(lut.begin() + lo_w, lut.begin() + hi_w,
              (uint16_t)(s | (len256[s] << 8)));
  }
  uint64_t acc = 0;
  int nbits = 0;
  int64_t pos = 0, bits_used = 0;
  for (int64_t i = 0; i < n_out; ++i) {
    while (nbits <= 56) {
      acc |= (uint64_t)(pos < nb ? src[pos] : 0) << (56 - nbits);
      ++pos;
      nbits += 8;
    }
    uint16_t e = lut[acc >> (64 - MAXL)];
    int len = e >> 8;
    if (len == 0) return -1;
    out[i] = (uint8_t)(e & 0xFF);
    acc <<= len;
    nbits -= len;
    bits_used += len;
  }
  return (bits_used + 7) / 8;
}

int mhc_codec_version() { return 5; }

}  // extern "C"
