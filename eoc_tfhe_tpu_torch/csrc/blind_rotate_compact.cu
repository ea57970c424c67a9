// Blind rotation over the stored ("compact") bootstrapping key, for Hopper (sm_90a).
//
// Replaces the TPU kernel eoc_tfhe_tpu/ops/pallas_blindrot.py,
// blind_rotate_pallas (its pallas_call at line 208): all n CMux steps of the
// blind rotation in one launch, each step
//   acc += sum_j digits_j(X^a acc - acc) (negacyclic*) key[i, j, u]   mod 2^32
// against the stored key (the true TGSW rows, or the rows rounded to a
// multiple of 2^(8*drop) for the reference's rounded form), with the
// reference's signed gadget digits (offset trick).  This is ring arithmetic
// mod 2^32, so direct uint32 multiply-adds give the reference's bits in any
// order. The TPU kernel's int8 limbs, in-kernel Toeplitz blocks and 2N
// overlap-add buffer exist for its matrix unit and are not carried over.
//
// Bound on an H100 at the 128-bit set (n=630, kpl=6, N=1024), as chip_smoke.py
// computes it: the same function by the cheapest exact dataflow in this
// package, the CRT-NTT one of blind_rotate_ntt.cu (1.18e7 int8 limb MACs per
// sample and step), plus the stored key's transform into the NTT domain once
// per step, shared by the batch; 2 operations per MAC at the 1,979 TOP/s int8
// peak: about 7.7 ms for B=1024. The key (31 MB as int32 rows) is read once
// in 0.01 ms at 3.35 TB/s, so the work is bound by operations. This kernel
// does the direct product instead, kpl*U*N^2 = 1.26e7 uint32 multiply-adds
// per sample and step on the CUDA cores (64 per clock per SM, an architecture
// figure), which cannot go below about 0.5 ms per sample.
//
// Design. A block holds kSamples samples for all n steps: their accumulators
// (U*N uint32 each) and gadget digits (kpl*N int32 each) stay in shared
// memory. Each step the block stages the key slice, negacyclically extended
// as [-k, k] (kpl*U*2N uint32, 96 KB at 128-bit) so that the sign of the
// wrapped index needs no branch. A thread owns kTile consecutive output
// coefficients of one output polynomial for all kSamples samples; it walks
// the input coefficients r in groups of kTile, holding a sliding window of
// 2*kTile key values (four 16-byte loads) and kTile digits per sample
// (broadcast loads), so each group does kSamples*kTile*kTile multiply-adds
// for six shared-memory loads. Later work, not done here: int8 mma.sync or
// wgmma over key limbs (the tensor cores), a TMA ring for the key steps, and
// filling the 132 SMs at small batch (one block per four samples).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSamples = 4;     // samples per block: every key load serves each
constexpr int kTile = 8;        // consecutive output coefficients per thread
constexpr int kMaxThreads = 256;

struct Shape {
  int B, n, U, N, l, J, Bgbit, halfBg;
  uint32_t offset, mask;
};

__global__ void __launch_bounds__(kMaxThreads, 1) blind_rotate_compact_kernel(
    const int32_t* __restrict__ acc0, const int32_t* __restrict__ bara,
    const int32_t* __restrict__ key, int32_t* __restrict__ out, const Shape S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = S.N, UN = S.U * N, JN = S.J * N, twoN = 2 * N;
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);                 // [s][u][N]
  int32_t* dig = reinterpret_cast<int32_t*>(acc + kSamples * UN);    // [s][j][N]
  uint32_t* ext = reinterpret_cast<uint32_t*>(dig + kSamples * JN);  // [j][u][2N]
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int b0 = blockIdx.x * kSamples;
  const int nvalid = min(kSamples, S.B - b0);
  const int tiles_per_poly = N / kTile;
  const size_t step_size = static_cast<size_t>(S.J) * UN;

  for (int x = tid; x < kSamples * UN; x += nthreads) {
    const int s = x / UN;
    acc[x] = s < nvalid ? static_cast<uint32_t>(acc0[static_cast<size_t>(b0) * UN + x]) : 0u;
  }

  for (int i = 0; i < S.n; ++i) {
    __syncthreads();   // the previous step no longer reads dig or ext; acc is updated
    // Key slice i as [-k, k] along each polynomial.
    const int32_t* key_i = key + static_cast<size_t>(i) * step_size;
    for (int x = tid; x < S.J * UN; x += nthreads) {
      const int ju = x / N, c = x - ju * N;
      const uint32_t v = static_cast<uint32_t>(key_i[x]);
      ext[ju * twoN + c] = 0u - v;
      ext[ju * twoN + N + c] = v;
    }
    // d = X^a * acc - acc, then its signed gadget digits (offset trick).
    for (int x = tid; x < kSamples * UN; x += nthreads) {
      const int s = x / UN, y = x - s * UN;
      const int a = s < nvalid ? bara[static_cast<size_t>(i) * S.B + b0 + s] : 0;
      const uint32_t* as = acc + s * UN;
      const int u = y / N, c = y - u * N;
      const int src = (c - a + twoN) & (twoN - 1);    // a in [0, 2N)
      const uint32_t v = src < N ? as[u * N + src] : 0u - as[u * N + src - N];
      const uint32_t du = v - as[y] + S.offset;
      int32_t* ds = dig + s * JN;
      for (int li = 0; li < S.l; ++li) {
        const int shift = 32 - (li + 1) * S.Bgbit;
        ds[(u * S.l + li) * N + c] = static_cast<int>((du >> shift) & S.mask) - S.halfBg;
      }
    }
    __syncthreads();

    // out[u][c] = sum_j sum_r dig[j][r] * ext[j][u][c - r + N], for the
    // thread's c = c0 .. c0 + kTile - 1.  With r = r0 + q the key index is
    // (c0 + N - kTile - r0) + (kTile + t - q): one 2*kTile window per r0.
    for (int tile = tid; tile < S.U * tiles_per_poly; tile += nthreads) {
      const int u = tile / tiles_per_poly;
      const int c0 = (tile - u * tiles_per_poly) * kTile;
      uint32_t sum[kSamples][kTile] = {};
      for (int j = 0; j < S.J; ++j) {
        const uint32_t* e = ext + (j * S.U + u) * twoN + c0 + N - kTile;
        const int32_t* dj = dig + j * N;
#pragma unroll 2
        for (int r0 = 0; r0 < N; r0 += kTile) {
          uint32_t w[2 * kTile];
#pragma unroll
          for (int v = 0; v < 2 * kTile / 4; ++v) {
            const uint4 x = *reinterpret_cast<const uint4*>(e - r0 + 4 * v);
            w[4 * v] = x.x; w[4 * v + 1] = x.y; w[4 * v + 2] = x.z; w[4 * v + 3] = x.w;
          }
#pragma unroll
          for (int s = 0; s < kSamples; ++s) {
            uint32_t d[kTile];
#pragma unroll
            for (int v = 0; v < kTile / 4; ++v) {
              const int4 x = *reinterpret_cast<const int4*>(dj + s * JN + r0 + 4 * v);
              d[4 * v] = x.x; d[4 * v + 1] = x.y; d[4 * v + 2] = x.z; d[4 * v + 3] = x.w;
            }
#pragma unroll
            for (int q = 0; q < kTile; ++q)
#pragma unroll
              for (int t = 0; t < kTile; ++t)
                sum[s][t] += d[q] * w[kTile + t - q];
          }
        }
      }
      // Only the step's digit pass reads acc, and it is behind the barrier above.
#pragma unroll
      for (int s = 0; s < kSamples; ++s)
#pragma unroll
        for (int t = 0; t < kTile; ++t)
          acc[s * UN + u * N + c0 + t] += sum[s][t];
    }
  }
  __syncthreads();

  for (int x = tid; x < nvalid * UN; x += nthreads)
    out[static_cast<size_t>(b0) * UN + x] = static_cast<int32_t>(acc[x]);
}

}  // namespace

// Launches the blind rotation on `stream`.  acc0, out: (B, U, N) int32;
// bara: (n, B) int32 in [0, 2N); key: (n, U*l, U, N) int32, the stored key.
// Returns a cudaError_t (0 on success); allocates nothing and does not sync.
extern "C" int blind_rotate_compact_launch(const void* acc0, const void* bara, const void* key,
                                           void* out, int B, int n, int U, int N, int l,
                                           int Bgbit, void* stream) {
  Shape S;
  S.B = B; S.n = n; S.U = U; S.N = N; S.l = l; S.J = U * l; S.Bgbit = Bgbit;
  if (B <= 0 || n < 0 || U <= 0 || l <= 0 || Bgbit <= 0 || Bgbit > 8 || l * Bgbit > 32 ||
      N < 2 * kTile || (N & (N - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  S.halfBg = 1 << (Bgbit - 1);   // <= 128: the digits of the reference's exact domain
  S.mask = (1u << Bgbit) - 1u;
  S.offset = 0;
  for (int p = 0; p < l; ++p)
    S.offset += static_cast<uint32_t>(S.halfBg) << (32 - (p + 1) * Bgbit);
  const size_t smem = sizeof(uint32_t) * (static_cast<size_t>(kSamples) * U * N +
                                          static_cast<size_t>(kSamples) * S.J * N +
                                          static_cast<size_t>(S.J) * U * 2 * N);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(blind_rotate_compact_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = U * N / kTile;
  const int threads = tiles >= kMaxThreads ? kMaxThreads : (tiles + 31) / 32 * 32;
  const int grid = (B + kSamples - 1) / kSamples;
  blind_rotate_compact_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc0), static_cast<const int32_t*>(bara),
      static_cast<const int32_t*>(key), static_cast<int32_t*>(out), S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
