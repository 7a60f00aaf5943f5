// Adaptive order-1 binary range coder — native entropy backend.
//
// The reference's entropy stage is generic zstd-22 / LZMA over the
// concatenated weight bytes (reference entropy_coding/__init__.py:44-67).
// Those are LZ-family codecs; the weight payload has almost no repeated
// substrings, so their gains come solely from their entropy stages. This
// codec attacks the payload directly: every byte is coded bit-by-bit
// (MSB first) through a 255-node probability tree, with the previous byte
// as context (order-1), probabilities adapting per bit (LZMA-style 12-bit
// probabilities, shift-5 update). On fp16 weight + k-means label streams
// this is consistently smaller than zstd-22 (see tests/test_coding.py).
//
// Container format (little-endian):
//   u32 magic 'IIRC' | u64 raw_size | carryless-range-coder bytes
//
// The encoder is the classic LZMA rc_encoder (64-bit low, cache + pending
// 0xFF run for carry propagation); the decoder mirrors it with a 32-bit
// code register. implicit_image_tpu_torch/coding/range_coder.py holds
// the bit-identical pure-Python reference. A copy of
// implicit_image_tpu/coding/native/range_coder.cpp, except that this
// decoder rejects a body it does not read exactly to its end.
//
// Build: g++ -O3 -shared -fPIC range_coder.cpp -o libiirange.so
// (coding/native_loader.py builds it into build/native/ at first use)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x43524949;  // "IIRC"
constexpr uint32_t kTop = 1u << 24;
constexpr int kProbBits = 12;
constexpr int kProbInit = 1 << (kProbBits - 1);  // 2048
constexpr int kAdaptShift = 5;

struct Encoder {
  uint8_t* out;
  uint64_t cap;
  uint64_t pos = 0;
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  uint64_t cache_size = 1;
  bool overflow = false;

  void put(uint8_t b) {
    if (pos >= cap) {
      overflow = true;
      return;
    }
    out[pos++] = b;
  }

  void shift_low() {
    if (static_cast<uint32_t>(low) < 0xFF000000u || (low >> 32) != 0) {
      uint8_t carry = static_cast<uint8_t>(low >> 32);
      uint8_t temp = cache;
      do {
        put(static_cast<uint8_t>(temp + carry));
        temp = 0xFF;
      } while (--cache_size != 0);
      cache = static_cast<uint8_t>(low >> 24);
    }
    cache_size++;
    low = (low << 8) & 0xFFFFFFFFu;
  }

  void encode_bit(uint16_t* p, int bit) {
    uint32_t bound = (range >> kProbBits) * *p;
    if (!bit) {
      range = bound;
      *p = static_cast<uint16_t>(*p + (((1 << kProbBits) - *p) >> kAdaptShift));
    } else {
      low += bound;
      range -= bound;
      *p = static_cast<uint16_t>(*p - (*p >> kAdaptShift));
    }
    while (range < kTop) {
      range <<= 8;
      shift_low();
    }
  }

  void flush() {
    for (int i = 0; i < 5; ++i) shift_low();
  }
};

struct Decoder {
  const uint8_t* in;
  uint64_t n;
  uint64_t pos;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;
  uint64_t past_end = 0;  // reads beyond the body, each taken as a 0 byte

  uint8_t get() {
    if (pos < n) return in[pos++];
    ++past_end;
    return 0;
  }

  // An intact stream is read exactly to its end: the encoder's flush emits
  // one byte for each of the decoder's reads.
  bool read_exactly() const { return past_end == 0 && pos == n; }

  void init() {
    for (int i = 0; i < 5; ++i) code = (code << 8) | get();
  }

  int decode_bit(uint16_t* p) {
    uint32_t bound = (range >> kProbBits) * *p;
    int bit;
    if (code < bound) {
      range = bound;
      *p = static_cast<uint16_t>(*p + (((1 << kProbBits) - *p) >> kAdaptShift));
      bit = 0;
    } else {
      code -= bound;
      range -= bound;
      *p = static_cast<uint16_t>(*p - (*p >> kAdaptShift));
      bit = 1;
    }
    while (range < kTop) {
      range <<= 8;
      code = (code << 8) | get();
    }
    return bit;
  }
};

}  // namespace

extern "C" {

// Worst-case output bound for buffer allocation (adaptive coder on
// adversarial input stays under ~1.1x; 2x + slack is a hard guarantee
// enforced by the encoder's overflow flag).
uint64_t iirange_bound(uint64_t n) { return n * 2 + 1024; }

// Returns number of bytes written to out, or 0 on error/overflow.
uint64_t iirange_encode(const uint8_t* in, uint64_t n, uint8_t* out,
                        uint64_t out_cap) {
  uint64_t header = 4 + 8;
  if (out_cap < header) return 0;
  std::memcpy(out, &kMagic, 4);
  std::memcpy(out + 4, &n, 8);

  std::vector<uint16_t> probs(256 * 256, kProbInit);
  Encoder enc{out + header, out_cap - header};
  int ctx = 0;
  for (uint64_t i = 0; i < n; ++i) {
    int b = in[i];
    int node = 1;
    for (int k = 7; k >= 0; --k) {
      int bit = (b >> k) & 1;
      enc.encode_bit(&probs[ctx * 256 + node], bit);
      node = (node << 1) | bit;
    }
    ctx = b;
    if (enc.overflow) return 0;
  }
  enc.flush();
  if (enc.overflow) return 0;
  return header + enc.pos;
}

// Returns raw size decoded, or 0 on error: a bad header, or a body that the
// decoder did not read exactly to its end (cut short or with bytes
// appended). Call with out=null to query size.
uint64_t iirange_decode(const uint8_t* in, uint64_t n, uint8_t* out,
                        uint64_t out_cap) {
  if (n < 12) return 0;
  uint32_t magic;
  std::memcpy(&magic, in, 4);
  if (magic != kMagic) return 0;
  uint64_t raw;
  std::memcpy(&raw, in + 4, 8);
  if (!out) return raw ? raw : 0;
  if (out_cap < raw) return 0;

  std::vector<uint16_t> probs(256 * 256, kProbInit);
  Decoder dec{in + 12, n - 12, 0};
  dec.init();
  int ctx = 0;
  for (uint64_t i = 0; i < raw; ++i) {
    int node = 1;
    for (int k = 0; k < 8; ++k)
      node = (node << 1) | dec.decode_bit(&probs[ctx * 256 + node]);
    uint8_t b = static_cast<uint8_t>(node & 0xFF);
    out[i] = b;
    ctx = b;
  }
  return dec.read_exactly() ? raw : 0;
}

}  // extern "C"
