// Blind rotation over the CRT-NTT bootstrapping key in int8 byte pairs, for
// Hopper (sm_90a): the kernel of the "ntt_scan" eval-key form.
//
// Replaces the TPU kernel eoc_tfhe_tpu/ops/pallas_ntt_blindrot.py,
// blind_rotate_ntt_pallas (line 146, its pallas_call at line 321): the v1
// fused CRT-NTT blind rotation over the unpadded key
// (n, P, F, K, 2M) int8, the last axis [lo bytes | hi bytes] of the balanced
// residues in (limb, u, s) order, for either prime pair (both primes, their
// Barrett constants and the CRT inverse are run-time arguments). The kernel
// reads that key as stored: two 4-byte loads per four residues, rebuilt as
// lo + 256 * hi. The dataflow and its design are in crt_ntt_rotate.cuh,
// shared with blind_rotate_ntt.cu.
//
// The TPU kernel casts the gadget digits to int8 and gives wrong bits for
// halfBg > 128; here they are int16, so the 80-bit set (halfBg = 512, four
// 8-bit key limbs) gives the scan form's bits.
//
// Bound on an H100 at the 128-bit set over (40961, 61441) (B=8192, n=630, the
// same K = M = 48 and F = 128 as the int16 kernel): about 1.2e7 int8 limb MACs
// per sample and step, about 62 ms at the 1,979 TOP/s int8 peak, against the
// 743 MB key and the accumulators (about 0.27 ms at 3.35 TB/s): bound by
// operations. The design keeps every intermediate in shared memory and each
// key load serves two samples; it runs on the CUDA cores, and the tensor
// cores (int8 wgmma over the byte pairs) are later work.

#include "crt_ntt_rotate.cuh"

namespace {

struct BytePairKey {
  using Elem = int8_t;
  __host__ __device__ static int row_stride(int M) { return 2 * M; }
  __device__ static int4 load4(const int8_t* row, int m0, int M) {
    const char4 lo = *reinterpret_cast<const char4*>(row + m0);
    const char4 hi = *reinterpret_cast<const char4*>(row + M + m0);
    return make_int4(lo.x + 256 * hi.x, lo.y + 256 * hi.y, lo.z + 256 * hi.z,
                     lo.w + 256 * hi.w);
  }
};

}  // namespace

// Launches the blind rotation on `stream`.  acc0, out: (B, U, N) int32;
// bara: (n, B) int32 in [0, 2N); key: (n, 2, F, K, 2M) int8, [lo | hi] bytes
// of the balanced residues; W: (2, F, F) int16 [t][f]; Winv: (2, F, F) int16
// [f][t]; F = N / R.  Returns a cudaError_t (0 on success); allocates nothing
// and does not sync.
extern "C" int blind_rotate_ntt_v1_launch(const void* acc0, const void* bara, const void* key,
                                          const void* W, const void* Winv, void* out, int B,
                                          int n, int U, int N, int R, int l, int Bgbit, int L,
                                          int kbits, int p0, int p1, int crt_inv,
                                          void* stream) {
  return crt_ntt::launch<BytePairKey>(acc0, bara, key, W, Winv, out, B, n, U, N, R, l, Bgbit,
                                      L, kbits, p0, p1, crt_inv, stream);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
