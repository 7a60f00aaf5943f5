// Static 2-way interleaved rANS codec — fast-decode entropy backend.
//
// The adaptive order-1 range coder (range_coder.cpp) wins rate but decodes
// bit-serially (~17 MB/s); canonical Huffman decodes fast but pays integer
// bit lengths (up to ~3% on skewed k-means label streams). Static rANS
// closes that gap: fractional-bit rate like the range coder's order-0
// floor, table-driven byte-level decode like Huffman's — the right
// backend when decode latency is first-class (serving). A copy of
// implicit_image_tpu/coding/native/rans.cpp.
//
// Container format (little-endian):
//   u32 magic 'IIRA' | u64 raw_size | u16 n_syms
//   | n_syms x { u8 symbol, u16 freq }   (freqs sum to 1<<14 exactly)
//   | u32 state0 | u32 state1 | renorm byte stream
//
// Two rANS states alternate over symbol positions (state0 takes even
// indices); the encoder walks the input backwards emitting renorm bytes
// back-to-front, so the decoder streams strictly forward. Frequencies are
// normalized to 1<<14 by cumulative rounding (deterministic; every
// present symbol keeps freq >= 1, deficit stolen from the largest bins) —
// coding/rans.py holds the bit-identical pure-Python reference.
//
// Build: g++ -O3 -shared -fPIC rans.cpp -o libiirans.so
// (coding/native_loader.py builds it into build/native/ at first use)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x41524949;  // "IIRA"
constexpr int kScaleBits = 14;
constexpr uint32_t kScale = 1u << kScaleBits;
constexpr uint32_t kRansL = 1u << 23;  // state lower bound

// Deterministic frequency normalization to sum kScale. Mirrored exactly in
// coding/rans.py (_normalize_freqs).
void normalize(const uint64_t* freq, uint64_t total, uint32_t* scaled) {
  uint64_t acc = 0, cum = 0;
  for (int s = 0; s < 256; ++s) {
    acc += freq[s];
    uint64_t new_cum = acc * kScale / total;
    scaled[s] = static_cast<uint32_t>(new_cum - cum);
    cum = new_cum;
  }
  // every present symbol needs a nonzero bin
  int64_t deficit = 0;
  for (int s = 0; s < 256; ++s)
    if (freq[s] && scaled[s] == 0) {
      scaled[s] = 1;
      ++deficit;
    }
  while (deficit > 0) {  // steal from the largest bin (lowest index wins ties)
    int big = -1;
    for (int s = 0; s < 256; ++s)
      if (scaled[s] > 1 && (big < 0 || scaled[s] > scaled[big])) big = s;
    --scaled[big];
    --deficit;
  }
}

}  // namespace

extern "C" {

// Worst case is kScaleBits bits/byte plus header+states.
uint64_t iirans_bound(uint64_t n) { return n * 2 + 2048; }

// Returns bytes written, or 0 on error/overflow.
uint64_t iirans_encode(const uint8_t* in, uint64_t n, uint8_t* out,
                       uint64_t out_cap) {
  uint64_t freq[256] = {0};
  for (uint64_t i = 0; i < n; ++i) ++freq[in[i]];

  uint32_t scaled[256] = {0};
  if (n) normalize(freq, n, scaled);

  uint32_t cum[257] = {0};
  for (int s = 0; s < 256; ++s) cum[s + 1] = cum[s] + scaled[s];

  int n_syms = 0;
  for (int s = 0; s < 256; ++s) n_syms += scaled[s] != 0;

  uint64_t header = 4 + 8 + 2 + 3ull * n_syms;
  if (out_cap < header + 8) return 0;
  std::memcpy(out, &kMagic, 4);
  std::memcpy(out + 4, &n, 8);
  uint16_t ns16 = static_cast<uint16_t>(n_syms);
  std::memcpy(out + 12, &ns16, 2);
  uint64_t hp = 14;
  for (int s = 0; s < 256; ++s)
    if (scaled[s]) {
      out[hp++] = static_cast<uint8_t>(s);
      uint16_t f16 = static_cast<uint16_t>(scaled[s]);
      std::memcpy(out + hp, &f16, 2);
      hp += 2;
    }
  if (n == 0) return hp;

  // emit back-to-front into a scratch buffer
  std::vector<uint8_t> scratch(2 * n + 64);  // worst case kScaleBits bits/byte
  uint8_t* end = scratch.data() + scratch.size();
  uint8_t* ptr = end;
  uint32_t x0 = kRansL, x1 = kRansL;
  for (uint64_t j = n; j-- > 0;) {
    uint32_t f = scaled[in[j]];
    uint32_t& x = (j & 1) ? x1 : x0;
    uint32_t x_max = ((kRansL >> kScaleBits) << 8) * f;
    while (x >= x_max) {
      if (ptr == scratch.data()) return 0;
      *--ptr = static_cast<uint8_t>(x);
      x >>= 8;
    }
    x = ((x / f) << kScaleBits) + (x % f) + cum[in[j]];
  }
  uint64_t payload = 8 + static_cast<uint64_t>(end - ptr);
  if (out_cap < hp + payload) return 0;
  std::memcpy(out + hp, &x0, 4);
  std::memcpy(out + hp + 4, &x1, 4);
  std::memcpy(out + hp + 8, ptr, end - ptr);
  return hp + payload;
}

// Returns raw size decoded, or 0 on error. Call with out=null to query size.
uint64_t iirans_decode(const uint8_t* in, uint64_t n, uint8_t* out,
                       uint64_t out_cap) {
  if (n < 14) return 0;
  uint32_t magic;
  std::memcpy(&magic, in, 4);
  if (magic != kMagic) return 0;
  uint64_t raw;
  std::memcpy(&raw, in + 4, 8);
  if (!out) return raw ? raw : 0;
  if (out_cap < raw) return 0;
  if (raw == 0) return 0;

  uint16_t n_syms;
  std::memcpy(&n_syms, in + 12, 2);
  uint64_t hp = 14;
  if (n < hp + 3ull * n_syms + 8) return 0;

  uint32_t scaled[256] = {0};
  for (int i = 0; i < n_syms; ++i) {
    uint8_t s = in[hp++];
    uint16_t f16;
    std::memcpy(&f16, in + hp, 2);
    hp += 2;
    scaled[s] = f16;
  }
  uint32_t cum[257] = {0};
  for (int s = 0; s < 256; ++s) cum[s + 1] = cum[s] + scaled[s];
  if (cum[256] != kScale) return 0;

  // slot -> symbol table (16 KB, L1/L2-resident)
  std::vector<uint8_t> slot(kScale);
  for (int s = 0; s < 256; ++s)
    if (scaled[s]) std::memset(slot.data() + cum[s], s, scaled[s]);

  uint32_t x0, x1;
  std::memcpy(&x0, in + hp, 4);
  std::memcpy(&x1, in + hp + 4, 4);
  const uint8_t* p = in + hp + 8;
  const uint8_t* pend = in + n;

  for (uint64_t i = 0; i < raw; ++i) {
    uint32_t& x = (i & 1) ? x1 : x0;
    uint32_t lo = x & (kScale - 1);
    uint8_t s = slot[lo];
    out[i] = s;
    x = scaled[s] * (x >> kScaleBits) + lo - cum[s];
    while (x < kRansL) {
      if (p == pend) return 0;
      x = (x << 8) | *p++;
    }
  }
  return raw;
}

}  // extern "C"
