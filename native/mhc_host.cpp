// mhc_host — native host-side runtime for the codec.
//
// Capability parity: the reference's runtime is native C++ (file IO, bit
// IO, driver — SURVEY.md §2b). The framework's device path is
// JAX/XLA/Pallas; this library is the native counterpart for the
// host-side data plane: packing/unpacking the container payload
// (variable-length unit streams <-> fixed-stride word matrices) without
// Python/numpy overhead. Loaded via ctypes (utils/native.py) with a
// numpy fallback when the .so is absent.
//
// Build: make -C native   (g++ -O3 -march=native -pthread)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(std::min(n, 16u)) : 4;
}

template <typename F>
void parallel_rows(int64_t R, F&& fn) {
  int nt = hw_threads();
  if (R < 1024 || nt <= 1) {
    fn((int64_t)0, R);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (R + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(R, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Concatenate R variable-length unit streams (prefix of each fixed-stride
// row) into `out`. `offsets[i]` = destination offset of row i (exclusive
// prefix sum of lens, precomputed by the caller); lens[i] <= row_stride.
void mhc_join(const uint8_t* rows, int64_t R, int64_t row_stride,
              const int64_t* lens, const int64_t* offsets, uint8_t* out) {
  parallel_rows(R, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + offsets[i], rows + i * row_stride,
                  (size_t)lens[i]);
    }
  });
}

// Inverse of mhc_join: scatter the packed payload back into zero-padded
// fixed-stride rows.
void mhc_split(const uint8_t* payload, int64_t R, int64_t row_stride,
               const int64_t* lens, const int64_t* offsets, uint8_t* rows) {
  parallel_rows(R, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      uint8_t* dst = rows + i * row_stride;
      std::memcpy(dst, payload + offsets[i], (size_t)lens[i]);
      std::memset(dst + lens[i], 0, (size_t)(row_stride - lens[i]));
    }
  });
}

// Big-endian u32 byteswap of a word matrix in place (words <-> the
// MSB-first byte stream view), threaded.
void mhc_bswap32(uint32_t* words, int64_t n) {
  parallel_rows(n, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      words[i] = __builtin_bswap32(words[i]);
    }
  });
}

// Huffman code-length assignment for `nctx` independent 256-symbol
// contexts — the host-side twin of ops/huffman.py (numpy + JAX builders).
// Mirrors code_lengths_np bit-for-bit: two-queue merge over leaves sorted
// by (count, symbol), ties prefer the leaf queue, then the deflate-style
// length-limit repair. `counts` must already be rescaled (per-context
// total < 2^28, see huffman.rescale_counts); lengths land in `out`
// (nctx*256 uint8). Called from utils/native.py for single-process table
// builds (cross-host replicated builds use the JAX twin on device).
void mhc_code_lengths(const int32_t* counts, int64_t nctx, int32_t max_len,
                      uint8_t* out) {
  constexpr int N = 256;
  parallel_rows(nctx, [=](int64_t lo, int64_t hi) {
    // per-thread scratch
    std::vector<int> order(N);
    std::vector<int64_t> leaf_w(N + 2), int_w(N);
    std::vector<int> leaf_parent(N), int_parent(N), depth(N);
    std::vector<int> lengths(N);
    const int64_t INF = int64_t(1) << 40;
    for (int64_t c = lo; c < hi; ++c) {
      const int32_t* cnt = counts + c * N;
      uint8_t* len_out = out + c * N;
      int m = 0;
      for (int s = 0; s < N; ++s)
        if (cnt[s] > 0) ++m;
      std::memset(len_out, 0, N);
      if (m == 0) continue;
      if (m == 1) {
        for (int s = 0; s < N; ++s)
          if (cnt[s] > 0) { len_out[s] = 1; break; }
        continue;
      }
      // sort present leaves by (count, symbol) ascending; absent last
      for (int s = 0; s < N; ++s) order[s] = s;
      std::sort(order.begin(), order.end(), [&](int a, int b) {
        int64_t wa = cnt[a] > 0 ? cnt[a] : INF;
        int64_t wb = cnt[b] > 0 ? cnt[b] : INF;
        return wa != wb ? wa < wb : a < b;
      });
      for (int s = 0; s < N; ++s)
        leaf_w[s] = cnt[order[s]] > 0 ? cnt[order[s]] : INF;
      leaf_w[N] = leaf_w[N + 1] = INF;
      // two-queue merge: m-1 internal nodes; leaf ties win (lw <= iw)
      int i = 0, j = 0;
      for (int t = 0; t < m - 1; ++t) {
        int64_t w = 0;
        for (int pick = 0; pick < 2; ++pick) {
          int64_t lw = i < N ? leaf_w[i] : INF;
          int64_t iw = j < t ? int_w[j] : INF;
          if (lw <= iw) {
            leaf_parent[i++] = t;
            w += lw;
          } else {
            int_parent[j++] = t;
            w += iw;
          }
        }
        int_w[t] = w;
      }
      // internal depths from the root (index m-2) down
      depth[m - 2] = 0;
      for (int t = m - 3; t >= 0; --t) depth[t] = depth[int_parent[t]] + 1;
      for (int s = 0; s < m; ++s)
        lengths[order[s]] = depth[leaf_parent[s]] + 1;
      for (int s = m; s < N; ++s) lengths[order[s]] = 0;
      // length-limit repair (mirrors limit_lengths_np)
      int over = 0;
      for (int s = 0; s < N; ++s)
        if (lengths[s] > max_len) ++over;
      if (over == 0) {
        for (int s = 0; s < N; ++s) len_out[s] = (uint8_t)lengths[s];
        continue;
      }
      std::vector<int64_t> bl(max_len + 2, 0);
      for (int s = 0; s < N; ++s)
        if (lengths[s] > 0) ++bl[std::min(lengths[s], (int)max_len)];
      int64_t budget = int64_t(1) << max_len;
      int64_t K = 0;
      for (int l = 1; l <= max_len; ++l) K += bl[l] << (max_len - l);
      while (K > budget) {
        int bits = 0;
        for (int l = max_len - 1; l >= 1; --l)
          if (bl[l] > 0) { bits = l; break; }
        --bl[bits];
        ++bl[bits + 1];
        K -= int64_t(1) << (max_len - bits - 1);
      }
      int64_t slack = budget - K;
      for (int l = max_len; l > 1; --l) {
        int64_t cost = int64_t(1) << (max_len - l);
        int64_t k = std::min(bl[l], slack / cost);
        bl[l] -= k;
        bl[l - 1] += k;
        slack -= k * cost;
      }
      // reassign: present symbols in (clamped length, symbol) order get
      // the new nondecreasing lengths drawn from bl
      std::vector<int> present_order;
      present_order.reserve(m);
      for (int s = 0; s < N; ++s)
        if (lengths[s] > 0) present_order.push_back(s);
      std::stable_sort(present_order.begin(), present_order.end(),
                       [&](int a, int b) {
                         int ca = std::min(lengths[a], (int)max_len);
                         int cb = std::min(lengths[b], (int)max_len);
                         return ca != cb ? ca < cb : a < b;
                       });
      int fill_len = 0;
      int64_t remaining = 0;
      for (int s : present_order) {
        while (remaining == 0 && fill_len <= max_len) {
          ++fill_len;
          remaining = fill_len <= max_len ? bl[fill_len] : 0;
        }
        len_out[s] = (uint8_t)fill_len;
        --remaining;
      }
    }
  });
}

int mhc_version() { return 2; }

}  // extern "C"
