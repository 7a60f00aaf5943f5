// Canonical byte-wise Huffman codec — native fast path for the entropy
// coding subsystem (implicit_image_tpu_torch/coding/huffman.py holds the
// bit-identical pure-Python reference and the format spec). A copy of
// implicit_image_tpu/coding/native/huffman.cpp.
//
// The reference declared a `huffman` entropy-coding backend but left it an
// unimplemented stub (reference entropy_coding/__init__.py:51-52,64-65);
// this is a real implementation. Container format (little-endian):
//   u32 magic 'IIHF', u64 raw_size, u8 code_length[256], packed MSB-first
//   bitstream of canonical Huffman codes.
//
// Build: g++ -O3 -shared -fPIC huffman.cpp -o libiihuff.so
// (coding/native_loader.py builds it into build/native/ at first use)

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x46484949;  // "IIHF"
constexpr int kMaxBits = 32;

struct Node {
  uint64_t freq;
  int sym;       // -1 for internal
  int l, r;      // child indices, -1 for leaf
};

struct HeapCmp {
  const std::vector<Node>* nodes;
  bool operator()(int a, int b) const {
    if ((*nodes)[a].freq != (*nodes)[b].freq)
      return (*nodes)[a].freq > (*nodes)[b].freq;
    return a > b;  // deterministic tie-break
  }
};

void collect_depths(const std::vector<Node>& nodes, int idx, int depth,
                    uint8_t* lens) {
  const Node& n = nodes[idx];
  if (n.sym >= 0) {
    lens[n.sym] = static_cast<uint8_t>(depth == 0 ? 1 : depth);
    return;
  }
  collect_depths(nodes, n.l, depth + 1, lens);
  collect_depths(nodes, n.r, depth + 1, lens);
}

// Canonical code assignment from lengths: symbols sorted by (length, value).
void canonical_codes(const uint8_t* lens, uint32_t* codes) {
  uint32_t code = 0;
  for (int bits = 1; bits <= kMaxBits; ++bits) {
    for (int s = 0; s < 256; ++s) {
      if (lens[s] == bits) codes[s] = code++;
    }
    code <<= 1;
  }
}

void build_lengths(const uint64_t* freq, uint8_t* lens) {
  std::memset(lens, 0, 256);
  std::vector<Node> nodes;
  std::priority_queue<int, std::vector<int>, HeapCmp> heap{HeapCmp{&nodes}};
  for (int s = 0; s < 256; ++s) {
    if (freq[s]) {
      nodes.push_back({freq[s], s, -1, -1});
      heap.push(static_cast<int>(nodes.size()) - 1);
    }
  }
  if (heap.empty()) return;
  if (heap.size() == 1) {
    lens[nodes[heap.top()].sym] = 1;
    return;
  }
  while (heap.size() > 1) {
    int a = heap.top(); heap.pop();
    int b = heap.top(); heap.pop();
    nodes.push_back({nodes[a].freq + nodes[b].freq, -1, a, b});
    heap.push(static_cast<int>(nodes.size()) - 1);
  }
  collect_depths(nodes, heap.top(), 0, lens);
}

}  // namespace

extern "C" {

// Worst-case output bound for buffer allocation.
uint64_t iihuff_bound(uint64_t n) { return n * 2 + 256 + 16 + 64; }

// Returns number of bytes written to out, or 0 on error.
uint64_t iihuff_encode(const uint8_t* in, uint64_t n, uint8_t* out,
                       uint64_t out_cap) {
  uint64_t freq[256] = {0};
  for (uint64_t i = 0; i < n; ++i) freq[in[i]]++;

  uint8_t lens[256];
  build_lengths(freq, lens);
  uint32_t codes[256] = {0};
  canonical_codes(lens, codes);

  uint64_t header = 4 + 8 + 256;
  if (out_cap < header) return 0;
  std::memcpy(out, &kMagic, 4);
  std::memcpy(out + 4, &n, 8);
  std::memcpy(out + 12, lens, 256);

  uint64_t pos = header;
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  for (uint64_t i = 0; i < n; ++i) {
    int s = in[i];
    bitbuf = (bitbuf << lens[s]) | codes[s];
    bitcnt += lens[s];
    while (bitcnt >= 8) {
      if (pos >= out_cap) return 0;
      out[pos++] = static_cast<uint8_t>(bitbuf >> (bitcnt - 8));
      bitcnt -= 8;
    }
  }
  if (bitcnt > 0) {
    if (pos >= out_cap) return 0;
    out[pos++] = static_cast<uint8_t>(bitbuf << (8 - bitcnt));
  }
  return pos;
}

// Returns raw size decoded, or 0 on error. Call with out=null to query size.
uint64_t iihuff_decode(const uint8_t* in, uint64_t n, uint8_t* out,
                       uint64_t out_cap) {
  if (n < 268) return 0;
  uint32_t magic;
  std::memcpy(&magic, in, 4);
  if (magic != kMagic) return 0;
  uint64_t raw;
  std::memcpy(&raw, in + 4, 8);
  if (!out) return raw;
  if (out_cap < raw) return 0;
  const uint8_t* lens = in + 12;

  // Canonical decode tables: per length, first code value and symbol base.
  uint32_t first_code[kMaxBits + 1] = {0};
  uint32_t first_sym[kMaxBits + 1] = {0};
  uint8_t sym_by_rank[256];
  {
    uint32_t code = 0, rank = 0;
    for (int bits = 1; bits <= kMaxBits; ++bits) {
      first_code[bits] = code;
      first_sym[bits] = rank;
      for (int s = 0; s < 256; ++s) {
        if (lens[s] == bits) {
          sym_by_rank[rank++] = static_cast<uint8_t>(s);
          code++;
        }
      }
      code <<= 1;
    }
  }

  uint64_t pos = 268;
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  uint32_t code = 0;
  int bits = 0;
  uint32_t count_at[kMaxBits + 1] = {0};
  for (int b = 1; b <= kMaxBits; ++b) {
    uint32_t c = 0;
    for (int s = 0; s < 256; ++s)
      if (lens[s] == b) c++;
    count_at[b] = c;
  }

  for (uint64_t o = 0; o < raw;) {
    if (bitcnt == 0) {
      if (pos >= n) return 0;
      bitbuf = in[pos++];
      bitcnt = 8;
    }
    code = (code << 1) | ((bitbuf >> (bitcnt - 1)) & 1);
    bitcnt--;
    bits++;
    if (bits > kMaxBits) return 0;
    if (count_at[bits] && code - first_code[bits] < count_at[bits]) {
      out[o++] = sym_by_rank[first_sym[bits] + (code - first_code[bits])];
      code = 0;
      bits = 0;
    }
  }
  return raw;
}

}  // extern "C"
