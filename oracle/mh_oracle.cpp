// mh_oracle — C++ re-implementation of the reference codec's semantics.
//
// The reference repo (jeremy-rifkin/Markov-Huffman-Coding) could not be
// mounted this session (SURVEY.md §0), so this oracle re-creates the
// behavior SURVEY.md §§1-3 describes from first principles: a single-
// threaded, bit-serial CLI codec with
//   * order-0 canonical Huffman coding (one table from the global byte
//     histogram), and
//   * Markov-Huffman coding (one canonical table per 256 preceding-byte
//     contexts; first byte uses context 0),
// using UNLIMITED-depth Huffman trees (greedy two-least-frequent merge,
// deterministic (count, symbol) tie-break) and a compact lengths-only
// canonical header. It serves as the "compressed size <= reference" and
// "reference-class CPU throughput" baseline for the framework
// (BASELINE.md), and as a differential fuzzing partner in tests/.
//
// Usage:
//   mh_oracle e0 IN OUT    order-0 encode
//   mh_oracle em IN OUT    markov encode
//   mh_oracle d  IN OUT    decode (mode auto-detected from header)
//   mh_oracle bench MODE IN  in-memory encode+decode timing (JSON line)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <chrono>
#include <queue>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x3148'4D4Fu;  // "OMH1" little-endian
constexpr int kMaxLen = 63;                 // fits u64 canonical arithmetic

struct Node {
  uint64_t weight;
  int min_sym;   // deterministic tie-break
  int left, right, sym;
};

struct Table {
  uint8_t len[256] = {0};
  uint64_t code[256] = {0};
  // canonical decode state
  uint64_t first_code[kMaxLen + 1] = {0};
  int32_t base[kMaxLen + 1] = {0};
  uint16_t bl_count[kMaxLen + 1] = {0};
  uint8_t sorted_syms[256] = {0};
};

// Greedy Huffman over one 256-entry histogram; lengths only.
void build_lengths(const uint64_t counts[256], uint8_t out_len[256]) {
  struct QNode {
    uint64_t w;
    int min_sym;
    int idx;
  };
  auto cmp = [](const QNode& a, const QNode& b) {
    if (a.w != b.w) return a.w > b.w;
    return a.min_sym > b.min_sym;
  };
  std::priority_queue<QNode, std::vector<QNode>, decltype(cmp)> pq(cmp);
  std::vector<Node> nodes;
  nodes.reserve(512);
  for (int s = 0; s < 256; ++s) {
    out_len[s] = 0;
    if (counts[s] > 0) {
      nodes.push_back({counts[s], s, -1, -1, s});
      pq.push({counts[s], s, (int)nodes.size() - 1});
    }
  }
  if (nodes.empty()) return;
  if (nodes.size() == 1) {
    out_len[nodes[0].sym] = 1;
    return;
  }
  while (pq.size() > 1) {
    QNode a = pq.top(); pq.pop();
    QNode b = pq.top(); pq.pop();
    nodes.push_back({a.w + b.w, std::min(a.min_sym, b.min_sym),
                     a.idx, b.idx, -1});
    pq.push({a.w + b.w, nodes.back().min_sym, (int)nodes.size() - 1});
  }
  // iterative depth assignment
  std::vector<std::pair<int, int>> stack;  // (node, depth)
  stack.push_back({pq.top().idx, 0});
  while (!stack.empty()) {
    auto [ni, d] = stack.back();
    stack.pop_back();
    const Node& nd = nodes[ni];
    if (nd.sym >= 0) {
      out_len[nd.sym] = (uint8_t)std::min(d, kMaxLen);
    } else {
      stack.push_back({nd.left, d + 1});
      stack.push_back({nd.right, d + 1});
    }
  }
}

void canonicalize(Table& t) {
  uint16_t bl[kMaxLen + 1] = {0};
  for (int s = 0; s < 256; ++s) bl[t.len[s]]++;
  bl[0] = 0;
  uint64_t code = 0;
  for (int l = 1; l <= kMaxLen; ++l) {
    code = (code + bl[l - 1]) << 1;
    t.first_code[l] = code;
    t.bl_count[l] = bl[l];
  }
  int32_t acc = 0;
  for (int l = 1; l <= kMaxLen; ++l) {
    t.base[l] = acc;
    acc += bl[l];
  }
  uint64_t next[kMaxLen + 1];
  std::memcpy(next, t.first_code, sizeof(next));
  int32_t fill[kMaxLen + 1];
  std::memcpy(fill, t.base, sizeof(fill));
  for (int s = 0; s < 256; ++s) {
    int l = t.len[s];
    if (!l) continue;
    t.code[s] = next[l]++;
    t.sorted_syms[fill[l]++] = (uint8_t)s;
  }
}

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nbits = 0;
  void write(uint64_t code, int len) {
    acc = (acc << len) | code;
    nbits += len;
    while (nbits >= 8) {
      out.push_back((uint8_t)(acc >> (nbits - 8)));
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) {
      out.push_back((uint8_t)(acc << (8 - nbits)));
      nbits = 0;
    }
    acc = 0;
  }
};

struct BitReader {
  const uint8_t* p;
  size_t n;
  size_t byte = 0;
  int bit = 0;
  int next() {
    if (byte >= n) return 0;
    int b = (p[byte] >> (7 - bit)) & 1;
    if (++bit == 8) { bit = 0; ++byte; }
    return b;
  }
};

void put_u64(std::vector<uint8_t>& v, uint64_t x) {
  for (int i = 0; i < 8; ++i) v.push_back((uint8_t)(x >> (8 * i)));
}
uint64_t get_u64(const uint8_t* p) {
  uint64_t x = 0;
  for (int i = 0; i < 8; ++i) x |= (uint64_t)p[i] << (8 * i);
  return x;
}

std::vector<uint8_t> encode(const std::vector<uint8_t>& in, bool markov) {
  const int nctx = markov ? 256 : 1;
  std::vector<uint64_t> counts((size_t)nctx * 256, 0);
  uint8_t prev = 0;
  for (size_t i = 0; i < in.size(); ++i) {
    counts[(markov ? prev : 0) * 256 + in[i]]++;
    prev = in[i];
  }
  std::vector<Table> tables(nctx);
  for (int c = 0; c < nctx; ++c) {
    build_lengths(&counts[(size_t)c * 256], tables[c].len);
    canonicalize(tables[c]);
  }
  std::vector<uint8_t> out;
  out.push_back((uint8_t)(kMagic & 0xFF));
  out.push_back((uint8_t)(kMagic >> 8));
  out.push_back((uint8_t)(kMagic >> 16));
  out.push_back((uint8_t)(kMagic >> 24));
  out.push_back(markov ? 1 : 0);
  put_u64(out, in.size());
  if (markov) {
    uint8_t bitmap[32] = {0};
    for (int c = 0; c < 256; ++c) {
      bool present = false;
      for (int s = 0; s < 256; ++s) present |= counts[(size_t)c * 256 + s] > 0;
      if (present) bitmap[c >> 3] |= (uint8_t)(1 << (c & 7));
    }
    out.insert(out.end(), bitmap, bitmap + 32);
    for (int c = 0; c < 256; ++c)
      if (bitmap[c >> 3] & (1 << (c & 7)))
        out.insert(out.end(), tables[c].len, tables[c].len + 256);
  } else {
    out.insert(out.end(), tables[0].len, tables[0].len + 256);
  }
  BitWriter bw;
  prev = 0;
  for (size_t i = 0; i < in.size(); ++i) {
    const Table& t = tables[markov ? prev : 0];
    bw.write(t.code[in[i]], t.len[in[i]]);
    prev = in[i];
  }
  bw.flush();
  out.insert(out.end(), bw.out.begin(), bw.out.end());
  return out;
}

std::vector<uint8_t> decode(const std::vector<uint8_t>& in) {
  if (in.size() < 13 ||
      (uint32_t)(in[0] | in[1] << 8 | in[2] << 16 | (uint32_t)in[3] << 24) != kMagic) {
    std::fprintf(stderr, "mh_oracle: bad magic\n");
    std::exit(2);
  }
  bool markov = in[4] != 0;
  uint64_t orig_len = get_u64(&in[5]);
  size_t off = 13;
  const int nctx = markov ? 256 : 1;
  std::vector<Table> tables(nctx);
  if (markov) {
    const uint8_t* bitmap = &in[off];
    off += 32;
    for (int c = 0; c < 256; ++c) {
      if (bitmap[c >> 3] & (1 << (c & 7))) {
        std::memcpy(tables[c].len, &in[off], 256);
        off += 256;
      }
      canonicalize(tables[c]);
    }
  } else {
    std::memcpy(tables[0].len, &in[off], 256);
    off += 256;
    canonicalize(tables[0]);
  }
  std::vector<uint8_t> out;
  out.reserve(orig_len);
  BitReader br{in.data() + off, in.size() - off};
  uint8_t prev = 0;
  for (uint64_t i = 0; i < orig_len; ++i) {
    const Table& t = tables[markov ? prev : 0];
    uint64_t code = 0;
    int len = 0;
    // bit-serial canonical walk (the reference-style hot decode loop)
    for (;;) {
      code = (code << 1) | (uint64_t)br.next();
      ++len;
      if (len > kMaxLen) {
        std::fprintf(stderr, "mh_oracle: corrupt stream\n");
        std::exit(2);
      }
      int64_t idx = (int64_t)(code - t.first_code[len]);
      if (idx >= 0 && idx < t.bl_count[len]) {
        uint8_t sym = t.sorted_syms[t.base[len] + idx];
        out.push_back(sym);
        prev = sym;
        break;
      }
    }
  }
  return out;
}

std::vector<uint8_t> read_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { std::perror(path); std::exit(2); }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)n);
  if (n && std::fread(buf.data(), 1, (size_t)n, f) != (size_t)n) {
    std::perror(path); std::exit(2);
  }
  std::fclose(f);
  return buf;
}

void write_file(const char* path, const std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "wb");
  if (!f) { std::perror(path); std::exit(2); }
  if (!buf.empty()) std::fwrite(buf.data(), 1, buf.size(), f);
  std::fclose(f);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: %s e0|em|d IN OUT | %s bench e0|em IN\n",
                 argv[0], argv[0]);
    return 2;
  }
  std::string cmd = argv[1];
  if (cmd == "bench") {
    if (argc < 4) return 2;
    bool markov = std::string(argv[2]) == "em";
    auto in = read_file(argv[3]);
    auto t0 = std::chrono::steady_clock::now();
    auto enc = encode(in, markov);
    auto t1 = std::chrono::steady_clock::now();
    auto dec = decode(enc);
    auto t2 = std::chrono::steady_clock::now();
    if (dec != in) {
      std::fprintf(stderr, "mh_oracle: roundtrip MISMATCH\n");
      return 1;
    }
    double es = std::chrono::duration<double>(t1 - t0).count();
    double ds = std::chrono::duration<double>(t2 - t1).count();
    std::printf(
        "{\"mode\":\"%s\",\"orig_bytes\":%zu,\"compressed_bytes\":%zu,"
        "\"ratio\":%.6f,\"encode_s\":%.6f,\"decode_s\":%.6f,"
        "\"encode_MBps\":%.2f,\"decode_MBps\":%.2f}\n",
        markov ? "markov" : "huffman", in.size(), enc.size(),
        in.empty() ? 0.0 : (double)enc.size() / (double)in.size(), es, ds,
        in.size() / es / 1e6, in.size() / ds / 1e6);
    return 0;
  }
  if (argc < 4) return 2;
  auto in = read_file(argv[2]);
  if (cmd == "e0") {
    write_file(argv[3], encode(in, false));
  } else if (cmd == "em") {
    write_file(argv[3], encode(in, true));
  } else if (cmd == "d") {
    write_file(argv[3], decode(in));
  } else {
    std::fprintf(stderr, "unknown command %s\n", cmd.c_str());
    return 2;
  }
  return 0;
}
