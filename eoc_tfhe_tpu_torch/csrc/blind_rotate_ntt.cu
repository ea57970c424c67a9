// Blind rotation over the CRT-NTT bootstrapping key on the int8 tensor cores,
// for Hopper (sm_90a): the kernel of the "ntt_kernel" eval-key form.
//
// Replaces the TPU kernel eoc_tfhe_tpu/ops/pallas_ntt_blindrot2.py,
// blind_rotate_ntt_pallas2 (line 241, its pallas_call at line 648): all n
// CMux steps of the blind rotation in one launch, over the same primes
// (64513, 32257). The dataflow, its limbs, bounds and shared-memory budget
// are in crt_ntt_mma.cuh; this file gives the key's layout and load. The key
// is stored as the pointwise stage's A operand: per step, prime, frequency,
// m16 tile of M and k16 tile of K, 32 lanes x 16 bytes (lo a0, lo a1, hi a0,
// hi a1 of the m16n8k16 fragment of T^T, T the (K, M) balanced residues
// zero-padded to multiples of 16), so each lane loads one tile with one
// 16-byte load, and a warp 512 contiguous bytes. It is the same 743 MB as the
// int16 residues (ntt.prepare_kernel_key, ntt.unpack_kernel_key).
//
// Bound on an H100 at the 128-bit set (B=8192, n=630; chip_smoke.py
// rotation_bound): ntt_macs = 1.18e7 int8 limb MACs per sample and step, 2
// operations each at the 1,979 TOP/s int8 peak: 61.5 ms, against 0.27 ms for
// the key and accumulator bytes at 3.35 TB/s, so bound by operations. This
// design runs exactly those MACs (plus the zero padding of F to 32 at small
// N) on the tensor cores with mma.sync; the reductions between stages run on
// the CUDA cores, and latency, not the MMAs, is its critical path
// (crt_ntt_mma.cuh). K1's contexts end at N = 2048 (KERNEL_PRIMES has no
// 2F-th root beyond F = 256), so its shapes take the cluster path of
// crt_ntt_mma.cuh only where one sample outgrows a block at F = 256; K > 256
// and F = 4 (N = 16) take its general instantiation (ROADMAP C10).

#include "crt_ntt_mma.cuh"

namespace {

struct PackedKey {
  using Elem = int8_t;
  static constexpr int kStageBytes = 0;     // read in fragment order: no staging
  static constexpr bool kReduceC2 = false;  // KERNEL_PRIMES: |c16| = 1023
  static constexpr bool kNarrow = true;     // the narrow tier: a share of a step is contiguous
  __device__ static uint4 load(const int8_t* key, const crt_mma::Shape& S, int i, int pi,
                               int f, int mt, int kt, int lane, int8_t*) {
    const size_t tile = ((static_cast<size_t>(i * 2 + pi) * S.F + f) * (S.Mp / 16) + mt) *
                            (S.Kp / 16) + kt;
    return __ldg(reinterpret_cast<const uint4*>(key + tile * 512) + lane);
  }
};

}  // namespace

// Launches the blind rotation on `stream`.  acc0, out: (B, U, N) int32;
// bara: (n, B) int32 in [0, 2N); key: (n, 2, F, Mp/16, Kp/16, 32, 16) int8;
// Wf, Wi: (2, FP/8, FP/32, 32, 4, 8) int8 B fragments; scratch:
// scratch_bytes of device memory (see crt_mma::launch); L limbs of kbits bits
// and rb rounding bits: the key's plan (ntt.NttContext).  Returns a
// cudaError_t (0 on success); allocates nothing and does not sync.
extern "C" int blind_rotate_ntt_launch(const void* acc0, const void* bara, const void* key,
                                       const void* Wf, const void* Wi, void* scratch,
                                       long long scratch_bytes, void* out, int B, int n, int U,
                                       int N, int R, int l, int Bgbit, int L, int kbits, int rb,
                                       int p0, int p1, int crt_inv, void* stream) {
  return crt_mma::launch<PackedKey>(acc0, bara, key, Wf, Wi, scratch, scratch_bytes, out, B,
                                    n, U, N, R, l, Bgbit, L, kbits, rb, p0, p1, crt_inv, stream);
}

// Clusters of C blocks of the narrow tier (digit limbs DL, `smem` bytes of
// shared memory a block) that the current device holds at once, into
// *clusters: the launcher's query, for ops/blind_rotate.narrow_plan.
// Returns a cudaError_t.
extern "C" int blind_rotate_ntt_narrow_clusters(int DL, int C, long long smem, int* clusters) {
  return crt_mma::narrow_clusters<PackedKey>(DL, C, static_cast<size_t>(smem), clusters);
}

#ifdef CRT_MMA_PROFILE
extern "C" int blind_rotate_ntt_phase_clocks(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, crt_mma::phase_clocks,
                                               sizeof(crt_mma::phase_clocks)));
}
#endif

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
