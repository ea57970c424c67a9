// The CRT-NTT blind rotation on the CUDA cores, templated over the key's
// load: the dataflow of blind_rotate_ntt_v1.cu (int8 [lo | hi] byte pairs),
// which instantiates rotate_kernel and launch with its key layout.
// blind_rotate_ntt.cu runs the same dataflow on the int8 tensor cores
// (crt_ntt_mma.cuh).
//
// All n CMux steps of the blind rotation in one launch, each step
//   acc += sum_j digits_j(X^a acc - acc) (negacyclic*) bk[i, j, u]   mod 2^32
// computed with the reference's CRT-NTT dataflow: R-way Nussbaumer split, a
// length-F negacyclic NTT per prime, the pointwise contraction over K = J*R
// rows against the NTT-domain key (n, P, F, K, M), the inverse NTT, CRT, and
// the recombination of the 32-bit key limbs. Every product is the exact
// integer one, so any exact order of sums gives the reference's bits. Sums
// are exact int32 (forward NTT, bound checked by the launcher) or int64;
// residues are reduced exactly (a float64 quotient estimate corrected by one
// conditional step); the mod 2^32 work is done in uint32. Gadget digits are
// held in int16, so every halfBg the launcher accepts (|digit| * p/2 * F <
// 2^31) is exact.
//
// Design. The arithmetic runs on the CUDA cores in plain integer form. A
// block holds kSamples samples; their accumulators (4*U*N bytes each) and
// every per-step intermediate stay in shared memory for all n steps (the
// TPU grid's sequential axis becomes this loop), and each thread computes
// the same outputs for all of them, so every load of the key and of the NTT
// matrices serves kSamples samples. Each stage tiles its outputs in
// registers: a thread owns four columns (one load of four matrix or key
// elements) times several rows, so each shared-memory load feeds four
// products. Blocks that run together walk the steps together, so a key step
// (about 1.2 MB at the 128-bit set) is served from the 50 MB L2. The prime
// constants are scalar fields selected at compile time (template <int PI>):
// indexing a prime array with a run-time index puts the parameter struct on
// the stack. Tensor-core (int8 wgmma) and TMA key pipelines are later work.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace crt_ntt {

constexpr int kThreads = 256;
constexpr int kSamples = 2;   // samples per block: every key/matrix load serves each
constexpr int kVec = 4;       // matrix or key elements per load
constexpr int kFwdRows = 6;   // digit rows per thread and pass (forward NTT)
constexpr int kInvRows = 2;   // result rows per thread and pass (first inverse NTT)

struct Shape {
  int B, n, U, N, R, F, l, J, K, M, L, Bgbit, kbits, halfBg, crt_inv;
  int p0, p1, half0, half1;
  double inv_p0, inv_p1;
  uint32_t offset, mask;
};

// Centered z mod p in [-(p-1)/2, (p-1)/2], p odd, |z| < 2^52. The float64
// quotient is the nearest integer or off by one, so one step corrects it.
__device__ __forceinline__ int reduce(long long z, int p, int half, double inv_p) {
  const long long q = __double2ll_rn(static_cast<double>(z) * inv_p);
  int r = static_cast<int>(z - q * p);
  if (r > half) r -= p;
  else if (r < -half) r += p;
  return r;
}

__device__ __forceinline__ short4 load4(const int16_t* ptr) {
  return *reinterpret_cast<const short4*>(ptr);
}

// Shared-memory buffers of one block, each [sample][...].
struct Smem {
  uint32_t* acc;   // [U][N] accumulator
  int16_t* dig;    // [J][N] gadget digits
  int16_t* dhat;   // [K][F] digit transforms
  int16_t* chat;   // [F][M] products with the key
  int16_t* res0;   // [M][F] first prime's inverse transform
  int UN, JN, FK, FM;
};

// One prime's forward NTT, pointwise product and inverse NTT; for the second
// prime also the CRT, key-limb recombination and accumulator update.
// Thread layout: column quad q (four f or t values from c0) and group g.
// `Key` gives the key's row stride and loads four residues of a row.
template <class Key, int PI>
__device__ __forceinline__ void prime_pass(const Shape& S, const Smem& sm,
                                           const typename Key::Elem* __restrict__ Tp,
                                           const int16_t* __restrict__ Wp,
                                           const int16_t* __restrict__ Wip, int tid) {
  const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
  const double inv_p = PI ? S.inv_p1 : S.inv_p0;
  const int FQ = S.F / kVec, NG = kThreads / FQ;
  const int g = tid / FQ, c0 = (tid - g * FQ) * kVec;

  // Forward: dhat[k, f] = sum_t dig[j, t*R + r] W[t, f] for k = (j, r), f = c0..c0+3.
  for (int kb = g; kb < S.K; kb += NG * kFwdRows) {
    int sum[kSamples][kFwdRows][kVec] = {};
    int off[kFwdRows];
#pragma unroll
    for (int c = 0; c < kFwdRows; ++c) {
      const int k = min(kb + c * NG, S.K - 1);
      off[c] = (k / S.R) * S.N + k % S.R;
    }
#pragma unroll 4
    for (int t = 0; t < S.F; ++t) {
      const short4 w = load4(Wp + t * S.F + c0);
#pragma unroll
      for (int c = 0; c < kFwdRows; ++c) {
#pragma unroll
        for (int s = 0; s < kSamples; ++s) {
          const int d = sm.dig[s * sm.JN + off[c] + t * S.R];
          sum[s][c][0] += d * w.x;
          sum[s][c][1] += d * w.y;
          sum[s][c][2] += d * w.z;
          sum[s][c][3] += d * w.w;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kFwdRows; ++c) {
      const int k = kb + c * NG;
      if (k >= S.K) continue;
#pragma unroll
      for (int s = 0; s < kSamples; ++s)
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          sm.dhat[s * sm.FK + k * S.F + c0 + v] =
              static_cast<int16_t>(reduce(sum[s][c][v], p, half, inv_p));
    }
  }
  __syncthreads();

  // Pointwise: chat[f, m] = sum_k dhat[k, f] T[f, k, m] for four m per item.
  const int MQ = S.M / kVec;
  const int stride = Key::row_stride(S.M);
  for (int o = tid; o < S.F * MQ; o += kThreads) {
    const int f = o / MQ, m0 = (o - f * MQ) * kVec;
    const typename Key::Elem* Tf = Tp + static_cast<size_t>(f) * S.K * stride;
    long long sum[kSamples][kVec] = {};
#pragma unroll 4
    for (int k = 0; k < S.K; ++k) {
      const int4 w = Key::load4(Tf + k * stride, m0, S.M);
#pragma unroll
      for (int s = 0; s < kSamples; ++s) {
        const long long d = sm.dhat[s * sm.FK + k * S.F + f];
        sum[s][0] += d * w.x;
        sum[s][1] += d * w.y;
        sum[s][2] += d * w.z;
        sum[s][3] += d * w.w;
      }
    }
#pragma unroll
    for (int s = 0; s < kSamples; ++s)
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        sm.chat[s * sm.FM + f * S.M + m0 + v] =
            static_cast<int16_t>(reduce(sum[s][v], p, half, inv_p));
  }
  __syncthreads();

  if (PI == 0) {
    // Inverse: res0[m, t] = sum_f chat[f, m] Winv[f, t] for t = c0..c0+3.
    for (int mb = g; mb < S.M; mb += NG * kInvRows) {
      long long sum[kSamples][kInvRows][kVec] = {};
#pragma unroll 4
      for (int f = 0; f < S.F; ++f) {
        const short4 w = load4(Wip + f * S.F + c0);
#pragma unroll
        for (int c = 0; c < kInvRows; ++c) {
          const int m = min(mb + c * NG, S.M - 1);
#pragma unroll
          for (int s = 0; s < kSamples; ++s) {
            const long long d = sm.chat[s * sm.FM + f * S.M + m];
            sum[s][c][0] += d * w.x;
            sum[s][c][1] += d * w.y;
            sum[s][c][2] += d * w.z;
            sum[s][c][3] += d * w.w;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kInvRows; ++c) {
        const int m = mb + c * NG;
        if (m >= S.M) continue;
#pragma unroll
        for (int s = 0; s < kSamples; ++s)
#pragma unroll
          for (int v = 0; v < kVec; ++v)
            sm.res0[s * sm.FM + m * S.F + c0 + v] =
                static_cast<int16_t>(reduce(sum[s][c][v], p, half, inv_p));
      }
    }
  } else {
    // Inverse for the second prime, CRT to the exact integer, key-limb
    // recombination mod 2^32. This thread alone owns acc[u, t*R + r] for
    // t = c0..c0+3 and its (u, r) pairs.
    const int US = S.U * S.R;
    for (int us = g; us < US; us += NG) {
      const int u = us / S.R, r = us - u * S.R;
      uint32_t upd[kSamples][kVec] = {};
      for (int li = 0; li < S.L; ++li) {
        const int m = li * US + us;
        long long sum[kSamples][kVec] = {};
#pragma unroll 4
        for (int f = 0; f < S.F; ++f) {
          const short4 w = load4(Wip + f * S.F + c0);
#pragma unroll
          for (int s = 0; s < kSamples; ++s) {
            const long long d = sm.chat[s * sm.FM + f * S.M + m];
            sum[s][0] += d * w.x;
            sum[s][1] += d * w.y;
            sum[s][2] += d * w.z;
            sum[s][3] += d * w.w;
          }
        }
#pragma unroll
        for (int s = 0; s < kSamples; ++s) {
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            const int v1 = reduce(sum[s][v], p, half, inv_p);
            const int v0 = sm.res0[s * sm.FM + m * S.F + c0 + v];
            const int q = reduce(static_cast<long long>(v1 - v0) * S.crt_inv, p, half, inv_p);
            const long long V = static_cast<long long>(v0) + static_cast<long long>(q) * S.p0;
            upd[s][v] += static_cast<uint32_t>(V) << (S.kbits * li);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSamples; ++s)
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          sm.acc[s * sm.UN + u * S.N + (c0 + v) * S.R + r] += upd[s][v];
    }
  }
  __syncthreads();
}

template <class Key>
__global__ void __launch_bounds__(kThreads, 2) rotate_kernel(
    const int32_t* __restrict__ acc0, const int32_t* __restrict__ bara,
    const typename Key::Elem* __restrict__ key, const int16_t* __restrict__ W,
    const int16_t* __restrict__ Winv, int32_t* __restrict__ out, const Shape S) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem sm;
  sm.UN = S.U * S.N; sm.JN = S.J * S.N; sm.FK = S.F * S.K; sm.FM = S.F * S.M;
  sm.acc = reinterpret_cast<uint32_t*>(smem);
  sm.dig = reinterpret_cast<int16_t*>(sm.acc + kSamples * sm.UN);
  sm.dhat = sm.dig + kSamples * sm.JN;
  sm.chat = sm.dhat + kSamples * sm.FK;
  sm.res0 = sm.chat + kSamples * sm.FM;
  const int UN = sm.UN;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kSamples;
  const int nvalid = min(kSamples, S.B - b0);
  const int FF = S.F * S.F;
  const int twoN = 2 * S.N;
  const size_t prime_size = static_cast<size_t>(S.F) * S.K * Key::row_stride(S.M);

  for (int x = tid; x < kSamples * UN; x += kThreads) {
    const int s = x / UN;
    sm.acc[x] = s < nvalid ? static_cast<uint32_t>(acc0[static_cast<size_t>(b0) * UN + x]) : 0u;
  }
  __syncthreads();

  for (int i = 0; i < S.n; ++i) {
    // d = X^a * acc - acc, then its signed gadget digits (offset trick).
    for (int x = tid; x < kSamples * UN; x += kThreads) {
      const int s = x / UN, y = x - s * UN;
      const int a = s < nvalid ? bara[static_cast<size_t>(i) * S.B + b0 + s] : 0;
      const uint32_t* as = sm.acc + s * UN;
      const int u = y / S.N, c = y - u * S.N;
      const int src = (c - a + twoN) & (twoN - 1);    // a in [0, 2N)
      const uint32_t v = src < S.N ? as[u * S.N + src] : 0u - as[u * S.N + src - S.N];
      const uint32_t du = v - as[y] + S.offset;
      int16_t* ds = sm.dig + s * sm.JN;
      for (int li = 0; li < S.l; ++li) {
        const int shift = 32 - (li + 1) * S.Bgbit;
        ds[(u * S.l + li) * S.N + c] =
            static_cast<int16_t>(static_cast<int>((du >> shift) & S.mask) - S.halfBg);
      }
    }
    __syncthreads();

    const typename Key::Elem* key_i = key + static_cast<size_t>(i) * 2 * prime_size;
    prime_pass<Key, 0>(S, sm, key_i, W, Winv, tid);
    prime_pass<Key, 1>(S, sm, key_i + prime_size, W + FF, Winv + FF, tid);
  }

  for (int x = tid; x < nvalid * UN; x += kThreads)
    out[static_cast<size_t>(b0) * UN + x] = static_cast<int32_t>(sm.acc[x]);
}

// Checks the shape, sizes shared memory against the device's opt-in limit and
// launches rotate_kernel<Key> on `stream`. acc0, out: (B, U, N) int32; bara:
// (n, B) int32 in [0, 2N); key: (n, 2, F, K, Key::row_stride(M)) of
// Key::Elem; W: (2, F, F) int16 [t][f]; Winv: (2, F, F) int16 [f][t];
// F = N / R. Returns a cudaError_t (0 on success); allocates nothing and does
// not sync.
template <class Key>
int launch(const void* acc0, const void* bara, const void* key, const void* W,
           const void* Winv, void* out, int B, int n, int U, int N, int R, int l, int Bgbit,
           int L, int kbits, int p0, int p1, int crt_inv, void* stream) {
  Shape S;
  S.B = B; S.n = n; S.U = U; S.N = N; S.R = R; S.F = R > 0 ? N / R : 0; S.l = l;
  S.J = U * l; S.K = S.J * R; S.L = L; S.M = L * U * R; S.Bgbit = Bgbit; S.kbits = kbits;
  S.crt_inv = crt_inv; S.p0 = p0; S.p1 = p1;
  S.half0 = (p0 - 1) / 2; S.half1 = (p1 - 1) / 2;
  S.inv_p0 = 1.0 / p0; S.inv_p1 = 1.0 / p1;
  if (B <= 0 || n < 0 || U <= 0 || l <= 0 || Bgbit <= 0 || Bgbit > 15 || l * Bgbit > 32 ||
      R <= 0 || N % R != 0 || (N & (N - 1)) != 0 || S.F % kVec != 0 ||
      kThreads % (S.F / kVec) != 0 || S.M % kVec != 0 || p0 < 3 || p1 < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  S.halfBg = 1 << (Bgbit - 1);
  S.mask = (1u << Bgbit) - 1u;
  S.offset = 0;
  for (int p = 0; p < l; ++p)
    S.offset += static_cast<uint32_t>(S.halfBg) << (32 - (p + 1) * Bgbit);
  // The forward NTT sums F products |digit| * |residue| in int32.
  const long long fwd_bound = static_cast<long long>(S.halfBg) *
                              (S.half0 > S.half1 ? S.half0 : S.half1) * S.F;
  if (fwd_bound >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kSamples * (sizeof(uint32_t) * U * N +
                                  sizeof(int16_t) * (static_cast<size_t>(S.J) * N +
                                                     S.F * S.K + 2 * S.F * S.M));
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(rotate_kernel<Key>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + kSamples - 1) / kSamples;
  rotate_kernel<Key><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc0), static_cast<const int32_t*>(bara),
      static_cast<const typename Key::Elem*>(key), static_cast<const int16_t*>(W),
      static_cast<const int16_t*>(Winv), static_cast<int32_t*>(out), S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace crt_ntt
