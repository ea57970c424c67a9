// Blind rotation over the CRT-NTT bootstrapping key in int8 byte pairs on the
// int8 tensor cores, for Hopper (sm_90a): the kernel of the "ntt_scan"
// eval-key form.
//
// Replaces the TPU kernel eoc_tfhe_tpu/ops/pallas_ntt_blindrot.py,
// blind_rotate_ntt_pallas (line 146, its pallas_call at line 321): the v1
// fused CRT-NTT blind rotation over the unpadded key
// (n, P, F, K, 2M) int8, the last axis [lo bytes | hi bytes] of the balanced
// residues in (limb, u, s) order, for either prime pair (both primes, their
// reduction constants and the CRT inverse are run-time arguments). The
// dataflow, its limbs, bounds and shared-memory budget are in
// crt_ntt_mma.cuh, shared with blind_rotate_ntt.cu; this file gives the key's
// load. The key is the form's own, read as stored.
//
// The loader. The pointwise stage's A operand is the m16n8k16 fragment of
// T^T: each 32-bit register holds four consecutive k of one m, while a v1
// row holds the M residues of one k. So each 16 x 16 tile (step, prime, f,
// m-tile, k-tile) is transposed on the chip, through 544 bytes of shared
// memory per warp: lane 16q + r loads the 16 bytes of plane q (lo or hi) in
// row k = 16kt + r with one 16-byte load, stores them as column r of a
// [q][m][16] tile (16 byte stores, no bank conflicts: the planes are 272
// bytes apart), and after a __syncwarp each lane reads its four fragment
// words (lo a0, lo a1, hi a0, hi a1) with 32-bit loads. Rows k >= K and
// columns m >= M of the ragged last tiles read as zero (the key is not
// padded); where M is not a multiple of 16 the loads go byte by byte.
//
// Exactness. The pointwise sum reduces C2 = hi.hi to a balanced residue
// before its product with c16 = 2^16 mod p, which over DEFAULT_PRIMES is
// -16386 (mod 40961) and would overflow int32 otherwise (crt_ntt_mma.cuh).
// Digits wider than int8 (the 80-bit set, halfBg = 512) are two int8 limbs,
// so that set keeps the scan form's bits; the TPU kernel casts them to int8
// and does not (ROADMAP C3).
//
// Bound on an H100 at the 128-bit set over (40961, 61441) (B=8192, n=630;
// chip_smoke.py rotation_bound): the same K = M = 48 and F = 128 as K1,
// ntt_macs = 1.18e7 int8 limb MACs per sample and step, 2 operations each at
// the 1,979 TOP/s int8 peak: 61.53 ms, against 0.27 ms for the 743 MB key and
// the accumulators at 3.35 TB/s, so bound by operations. This design runs
// those MACs on the tensor cores with mma.sync, as K1 does; the transpose is
// extra work of the pointwise stage on the CUDA cores.
//
// The cluster path (crt_ntt_mma.cuh, ROADMAP C10). Where one sample does
// not fit a block (N >= 8192, F >= 1024; F = 512 with Kp >= 144), a
// thread-block cluster of 2, 4 or 8 blocks holds it, split by frequency:
// each block reads only its F/C frequencies of the key, so the loader and
// its staging tiles are unchanged, and the inverse reads the other blocks'
// chat through DSMEM between two cluster barriers a prime. It replaces the
// refusal of those shapes, not the instantiations of the shapes above. At N
// = 8192 (C = 2) a block needs 133,632 bytes, at N = 16384 (C = 4) 167,424,
// of the card's 232,448; a shape beyond a cluster of 8 stays refused.

#include "crt_ntt_mma.cuh"

namespace {

struct V1Key {
  using Elem = int8_t;
  static constexpr int kPlane = 16 * 16 + 16;        // [m][16 k] + 16 bytes: bank spread
  static constexpr int kStageBytes = 2 * kPlane;     // lo and hi planes, per warp
  static constexpr bool kReduceC2 = true;            // DEFAULT_PRIMES: |c16| = 16386
  static constexpr bool kNarrow = false;             // no narrow tier (its key needs a transpose)
  __device__ static uint4 load(const int8_t* key, const crt_mma::Shape& S, int i, int pi,
                               int f, int mt, int kt, int lane, int8_t* stage) {
    const int q = lane >> 4, r = lane & 15, k = 16 * kt + r, m0 = 16 * mt;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < S.K) {
      const int8_t* row = key + ((static_cast<size_t>(i * 2 + pi) * S.F + f) * S.K + k) *
                                    (2 * S.M) + q * S.M + m0;
      if (S.M % 16 == 0) {
        v = __ldg(reinterpret_cast<const uint4*>(row));
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
        for (int m = 0; m < 16 && m0 + m < S.M; ++m)
          w[m >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(row + m)))
                       << (8 * (m & 3));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncwarp();   // the previous tile's fragment reads are done
    int8_t* col = stage + q * kPlane + r;
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int m = 0; m < 16; ++m) col[16 * m] = static_cast<int8_t>(words[m >> 2] >> (8 * (m & 3)));
    __syncwarp();
    const int8_t* frag = stage + (lane >> 2) * 16 + 4 * (lane & 3);   // m = g, k = 4 tig
    return make_uint4(crt_mma::lds32(frag), crt_mma::lds32(frag + 128),
                      crt_mma::lds32(frag + kPlane), crt_mma::lds32(frag + kPlane + 128));
  }
};

}  // namespace

// Launches the blind rotation on `stream`.  acc0, out: (B, U, N) int32;
// bara: (n, B) int32 in [0, 2N); key: (n, 2, F, K, 2M) int8, [lo | hi] bytes
// of the balanced residues; Wf, Wi: (2, FP/8, FP/32, 32, 4, 8) int8 B
// fragments; scratch: scratch_bytes of device memory (see crt_mma::launch);
// L limbs of kbits bits and rb rounding bits: the key's plan.
// Returns a cudaError_t (0 on success); allocates nothing and does not sync.
extern "C" int blind_rotate_ntt_v1_launch(const void* acc0, const void* bara, const void* key,
                                          const void* Wf, const void* Wi, void* scratch,
                                          long long scratch_bytes, void* out, int B, int n,
                                          int U, int N, int R, int l, int Bgbit, int L,
                                          int kbits, int rb, int p0, int p1, int crt_inv,
                                          void* stream) {
  return crt_mma::launch<V1Key>(acc0, bara, key, Wf, Wi, scratch, scratch_bytes, out, B, n, U,
                                N, R, l, Bgbit, L, kbits, rb, p0, p1, crt_inv, stream);
}

#ifdef CRT_MMA_PROFILE
extern "C" int blind_rotate_ntt_v1_phase_clocks(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, crt_mma::phase_clocks,
                                               sizeof(crt_mma::phase_clocks)));
}
#endif

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
