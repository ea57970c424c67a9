// Blind rotation over the CRT-NTT bootstrapping key in int16 residues, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel eoc_tfhe_tpu/ops/pallas_ntt_blindrot2.py,
// blind_rotate_ntt_pallas2 (its pallas_call at line 648): all n CMux steps of
// the blind rotation in one launch, over the same primes and key. The
// dataflow and its design are in crt_ntt_rotate.cuh; this file gives the key
// layout, (n, P, F, K, M) int16 balanced residues, one 8-byte load per four
// residues.
//
// Bound on an H100 at the 128-bit set (B=8192, n=630): the dataflow needs
// about 1.2e7 int8 limb MACs per sample and step, 1.2e14 operations in all,
// about 62 ms at the 1,979 TOP/s int8 peak, against about 0.9 GB of key and
// accumulator traffic (0.27 ms at 3.35 TB/s): the work is bound by operations.
// The kernel runs on the CUDA cores; the tensor cores are later work.

#include "crt_ntt_rotate.cuh"

namespace {

struct Int16Key {
  using Elem = int16_t;
  __host__ __device__ static int row_stride(int M) { return M; }
  __device__ static int4 load4(const int16_t* row, int m0, int) {
    const short4 w = crt_ntt::load4(row + m0);
    return make_int4(w.x, w.y, w.z, w.w);
  }
};

}  // namespace

// Launches the blind rotation on `stream`.  acc0, out: (B, U, N) int32;
// bara: (n, B) int32 in [0, 2N); key: (n, 2, F, K, M) int16 balanced residues;
// W: (2, F, F) int16 [t][f]; Winv: (2, F, F) int16 [f][t]; F = N / R.
// Returns a cudaError_t (0 on success); allocates nothing and does not sync.
extern "C" int blind_rotate_ntt_launch(const void* acc0, const void* bara, const void* key,
                                       const void* W, const void* Winv, void* out, int B,
                                       int n, int U, int N, int R, int l, int Bgbit, int L,
                                       int kbits, int p0, int p1, int crt_inv, void* stream) {
  return crt_ntt::launch<Int16Key>(acc0, bara, key, W, Winv, out, B, n, U, N, R, l, Bgbit, L,
                                   kbits, p0, p1, crt_inv, stream);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
