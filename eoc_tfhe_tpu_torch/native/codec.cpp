// Native host-side codec of the PyTorch/CUDA port (a copy of
// eoc_tfhe_tpu/native/codec.cpp).
//
// Upstream's runtime tier is C/C++ (its wrapper's base64 codec in
// ao-tfhe/eoc-tfhe-run.cpp and the tfhe_io record streams it wraps).  This
// library is the equivalent native tier here: bulk UID-framed record packing
// for LWE/TLWE sample arrays (the keyswitch key alone is 32,768 records at
// the default 128-bit parameters) and the wrapper-compatible truncating
// base64 decoder.  Compute stays on the card; this speeds up the host
// serialization boundary.
//
// ABI: little-endian host (x86-64 / aarch64 Linux). All sizes are element
// counts, not bytes; callers allocate exact-size buffers and check the input
// sizes before calling (eoc_tfhe_tpu_torch/native/__init__.py).

#include <array>
#include <cstdint>
#include <cstring>

namespace {

constexpr int32_t kLweSampleUid = 42;
constexpr int32_t kTlweSampleUid = 169;

inline void put_i32(uint8_t*& p, int32_t v) {
  std::memcpy(p, &v, 4);
  p += 4;
}

inline int32_t get_i32(const uint8_t*& p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  p += 4;
  return v;
}

inline void put_f64(uint8_t*& p, double v) {
  std::memcpy(p, &v, 8);
  p += 8;
}

inline double get_f64(const uint8_t*& p) {
  double v;
  std::memcpy(&v, p, 8);
  p += 8;
  return v;
}

const char kB64Alpha[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Base64 decode, mirroring the reference wrapper: stop at the first
// non-alphabet character, tolerate missing padding (upstream
// eoc-tfhe-run.cpp). Returns bytes written.  The reference's encoder is not
// copied: CPython's binascii encodes faster (PERF.md).
// ---------------------------------------------------------------------------

int64_t eoc_b64_decode(const char* in, int64_t n, uint8_t* out) {
  // A function-local static is initialized once, safely across threads
  // (ctypes releases the interpreter lock around the call).
  static const std::array<int8_t, 256> lut = [] {
    std::array<int8_t, 256> t;
    t.fill(-1);
    for (int i = 0; i < 64; ++i) t[uint8_t(kB64Alpha[i])] = int8_t(i);
    return t;
  }();
  uint8_t* o = out;
  uint32_t acc = 0;
  int bits = 0;
  for (int64_t i = 0; i < n; ++i) {
    int8_t v = lut[uint8_t(in[i])];
    if (v < 0) break;  // '=' padding or any non-alphabet char terminates
    acc = (acc << 6) | uint32_t(v);
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      *o++ = uint8_t((acc >> bits) & 0xFF);
    }
  }
  return o - out;
}

// ---------------------------------------------------------------------------
// LWE sample array: B records of [uid=42 i32 | a[n] i32 | b i32 | var f64].
// a is (B, n) row-major, b and var are length-B.
// ---------------------------------------------------------------------------

void eoc_pack_lwe_array(const int32_t* a, const int32_t* b, const double* var,
                        int64_t B, int64_t n, uint8_t* out) {
  uint8_t* p = out;
  for (int64_t s = 0; s < B; ++s) {
    put_i32(p, kLweSampleUid);
    std::memcpy(p, a + s * n, size_t(n) * 4);
    p += n * 4;
    put_i32(p, b[s]);
    put_f64(p, var[s]);
  }
}

// Returns 0 on success, or (index + 1) of the first record with a bad UID.
int64_t eoc_unpack_lwe_array(const uint8_t* in, int64_t B, int64_t n,
                             int32_t* a, int32_t* b, double* var) {
  const uint8_t* p = in;
  for (int64_t s = 0; s < B; ++s) {
    if (get_i32(p) != kLweSampleUid) return s + 1;
    std::memcpy(a + s * n, p, size_t(n) * 4);
    p += n * 4;
    b[s] = get_i32(p);
    var[s] = get_f64(p);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// TLWE sample array: B records of [uid=169 i32 | polys[(k+1)*N] i32 | var f64].
// ---------------------------------------------------------------------------

void eoc_pack_tlwe_array(const int32_t* polys, const double* var, int64_t B,
                         int64_t m, uint8_t* out) {
  uint8_t* p = out;
  for (int64_t s = 0; s < B; ++s) {
    put_i32(p, kTlweSampleUid);
    std::memcpy(p, polys + s * m, size_t(m) * 4);
    p += m * 4;
    put_f64(p, var[s]);
  }
}

int64_t eoc_unpack_tlwe_array(const uint8_t* in, int64_t B, int64_t m,
                              int32_t* polys, double* var) {
  const uint8_t* p = in;
  for (int64_t s = 0; s < B; ++s) {
    if (get_i32(p) != kTlweSampleUid) return s + 1;
    std::memcpy(polys + s * m, p, size_t(m) * 4);
    p += m * 4;
    var[s] = get_f64(p);
  }
  return 0;
}

}  // extern "C"
