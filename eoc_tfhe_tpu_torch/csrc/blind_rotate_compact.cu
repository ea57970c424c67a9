// Blind rotation over the stored ("compact") bootstrapping key on the int8
// tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel eoc_tfhe_tpu/ops/pallas_blindrot.py,
// blind_rotate_pallas (line 109, its pallas_call at line 208): all n CMux
// steps of the blind rotation in one launch, each step
//   acc += sum_j digits_j(X^a acc - acc) (negacyclic*) key[i, j, u]   mod 2^32
// against the stored key (the true TGSW rows, or the rows rounded to a
// multiple of 2^(8*drop) for the reference's rounded form), with the
// reference's signed gadget digits (offset trick). The product is the direct
// negacyclic one as a Toeplitz matrix times the digits, on the int8 tensor
// cores (mma.sync m16n8k32), as the TPU kernel does on its matrix unit.
//
// Limbs and exactness. Each key word v is split into balanced signed bytes,
// v = b0 + 2^8 b1 + 2^16 b2 + 2^24 b3 mod 2^32 with every b in [-128, 127],
// and so is -v (the Toeplitz block's wrapped entries), so every entry of the
// negacyclic matrix is a byte. Digits are int8 (|d| <= halfBg <= 128; the
// form refuses halfBg > 128, ROADMAP C1). For each limb t the MMA sums
// J*N products into int32, |sum| <= J*N*halfBg*128 < 2^31 (5.0e7 at the
// 128-bit set; the launcher checks the bound); the limbs are combined as
// acc += sum_t << 8t in uint32, mod 2^32. A limb that is zero in every word
// of a step (the low limb of the rounded limbs=3 key) is skipped, so that
// form costs 3/4 of the MACs and still gives the plain version's bits.
//
// Design. A block holds ns = 8 samples (the MMA's N; 4 or 2 where 8 do not
// fit in shared memory, the MMA's other columns repeating sample 0 and never
// stored) for all n steps: their accumulators (U*N uint32) and int8 digits
// (J*N) stay in shared memory. Each step the block converts the key step
// (J*U*N int32 from L2; by instruction count about 2% of a step, which is
// why the stored key stays int32 rows) into byte rows rev[t][j][u][y] =
// limb_t(T[c][r]) at y = N-1-c+r, that is [k reversed | -k reversed], so the
// Toeplitz block is read along increasing addresses and never leaves the SM.
// Where the rows of all four limbs do not fit (k = 2 at N = 1024, k = 3, l =
// 5, N = 2048), the step is converted and consumed one limb at a time: four
// passes, each converting the words again and keeping one limb's rows.
// Where even one limb's J rows do not fit (k = 3 l = 5 at N = 1024, k = 3 at
// N = 2048, k = 2 at N = 4096), each limb pass goes over the rows jp at a
// time and adds each share's partial sums into acc (mod 2^32 the shifted
// sum of the parts is the shifted sum), so no share costs more conversion.
// Warp w owns CT = max(1, N/64) output tiles of 16 coefficients of one
// output polynomial, so a block has U*N/(16*CT) warps: 4U at N >= 64, U*2
// at N = 32. A fragment row of 4 consecutive input coefficients is 4 bytes
// at an offset that is fixed per lane mod 4: two aligned 32-bit loads and a
// __byte_perm. The A fragment depends only on the diagonal d = c0 - r0, so
// the warp walks the diagonals: for each d it builds A once (two new words
// of the sliding window, four loads) and runs every (c-tile, r-tile) pair
// on that diagonal, with the digit fragments of up to 32 r-tiles and the
// accumulators of its CT tiles in registers (64 + 64 at N = 1024): about 0.7
// shared-memory loads per MMA. At N = 2048 the 64 r-tiles go in two passes
// of 32 (64 + 128 registers); at N = 4096 the 128 r-tiles go in four, and a
// warp's 64 tiles in two walks of 32 (CG), each walk adding its sums into
// acc. The walk is unrolled at compile time, so the kernel is instantiated
// per (N, U): every power of two N from 32 to 4096 at U = 2 to 5 (k = 1 to
// 4; at N = 4096 U = 2 to 4, since no plan fits U = 5 there); a shape whose
// shared memory does not fit at 2 samples, one limb and one row a pass is
// refused.
//
// Bound on an H100 at the 128-bit set (chip_smoke.py compact_bound): the
// same function by the cheapest exact dataflow the repo has, the CRT-NTT one
// of blind_rotate_ntt.cu plus the stored key's transform once per step,
// shared by the batch: 7.7 ms at B=1024, bound by operations. This design
// does 4*J*U*N^2 = 5.03e7 int8 MACs per sample and step instead, so it cannot
// go below about 33 ms at B=1024 and 262 ms at B=8192 at the 1,979 TOP/s
// peak, 4.3x that bound (PERF.md has the measured times).
//
// Shared memory at the 128-bit set: acc 65,664 + digits 49,280 + byte rows
// 98,320 = 213,264 of the 232,448 bytes a block may use, one block per SM. B = 1024 is 128 blocks
// on the 132 SMs; B = 8192 is 1024 blocks, 7.8 waves. The key step is read
// once per block and step (48 KB from L2) and converted in place; there is
// no room for a second buffer, and the conversion is not on the critical
// path.

#include <cstdint>
#include <initializer_list>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSamples = 8;   // samples per block: the MMA's N
constexpr int kLimbs = 4;

// Output tiles of 16 coefficients per warp, the tiles a warp's walk holds
// in registers at once, and warps per block, at (N, U).
template <int N, int U>
struct Tiling {
  static constexpr int kTPP = N / 16;                        // tiles per polynomial
  static constexpr int kCT = kTPP >= 4 ? kTPP / 4 : 1;       // tiles per warp
  static constexpr int kCG = kCT < 32 ? kCT : 32;            // tiles a walk (N = 4096: 2 walks)
  static constexpr int kWarps = U * kTPP / kCT;
  static constexpr int kThreads = 32 * kWarps;
};

struct Shape {
  int B, n, U, N, l, J, Bgbit, halfBg;
  int ns;      // samples a block: 8, 4 or 2
  int lp;      // limbs converted a pass: 4, or 1 where four limbs' rows do not fit
  int jp;      // digit rows j converted a pass: J, or fewer where all J rows do not fit
  uint32_t offset, mask;
  int acc_s;   // words per sample of acc: U*N + 4 (bank spread of the flush)
  int dig_s;   // bytes per sample of dig: J*N + 16 (bank spread of the B loads)
  int dig_off, rev_off;
};

__device__ __forceinline__ void mma_k32(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The balanced byte limbs of v: v == sum_t 2^(8t) b_t mod 2^32, b_t in [-128, 127].
__device__ __forceinline__ void limbs(uint32_t v, int (&b)[kLimbs]) {
#pragma unroll
  for (int t = 0; t < kLimbs; ++t) {
    b[t] = static_cast<int8_t>(v);
    v = (v - static_cast<uint32_t>(b[t])) >> 8;
  }
}

// The diagonal walk of r-tiles Q0 .. Q0+RG-1 of digit row j (dgj: this
// lane's digit bytes of row j) against the byte rows rv of one limb: for
// each diagonal e build A once and add every (c-tile, r-tile) pair on it.
template <int CT, int Q0, int RG>
__device__ __forceinline__ void diagonal_walk(int (&c)[CT][4], const int8_t* dgj,
                                              const int8_t* rv, uint32_t sel) {
  constexpr int E0 = -(2 * (Q0 + RG) - 2), E1 = CT - 1 - 2 * Q0;   // diagonals e = i - 2q
  uint32_t bf[RG][2];
#pragma unroll
  for (int q = 0; q < RG; ++q) {
    bf[q][0] = lds32(dgj + 32 * (Q0 + q));
    bf[q][1] = lds32(dgj + 32 * (Q0 + q) + 16);
  }
  // U_m = the 4 bytes at base - 8m; A(e) = (U_2e, U_2e+1, U_2e-2, U_2e-1).
  auto word = [&](int m) { return __byte_perm(lds32(rv - 8 * m), lds32(rv - 8 * m + 4), sel); };
  uint32_t um2 = word(2 * E0 - 2), um1 = word(2 * E0 - 1);
#pragma unroll
  for (int e = E0; e <= E1; ++e) {
    const uint32_t u0 = word(2 * e), u1 = word(2 * e + 1);
#pragma unroll
    for (int q = 0; q < RG; ++q) {
      const int ii = e + 2 * (Q0 + q);
      if (ii >= 0 && ii < CT) mma_k32(c[ii], u0, u1, um2, um1, bf[q][0], bf[q][1]);
    }
    um2 = u0;
    um1 = u1;
  }
}

template <int N, int U>
__global__ void __launch_bounds__(Tiling<N, U>::kThreads, 1) blind_rotate_compact_kernel(
    const int32_t* __restrict__ acc0, const int32_t* __restrict__ bara,
    const int32_t* __restrict__ key, int32_t* __restrict__ out, const Shape S) {
  constexpr int UN = U * N, twoN = 2 * N;
  constexpr int TPP = Tiling<N, U>::kTPP;     // 16-coefficient tiles per polynomial
  constexpr int CT = Tiling<N, U>::kCT;       // tiles per warp
  constexpr int CG = Tiling<N, U>::kCG;       // tiles a walk
  constexpr int kThreads = Tiling<N, U>::kThreads;
  constexpr int RT = N / 32;                  // 32-coefficient input tiles
  constexpr int RG = RT < 32 ? RT : 32;       // r-tiles a pass of the walk
  static_assert(CT >= 1 && TPP % CT == 0 && RT >= 1, "a warp's tiles lie in one polynomial");
  static_assert(CT % CG == 0 && RT % RG == 0 && RT <= 4 * RG, "one to four passes of the walk");

  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);          // [s][acc_s]
  int8_t* dig = reinterpret_cast<int8_t*>(smem + S.dig_off);  // [s][j][N] + pad
  int8_t* rev = reinterpret_cast<int8_t*>(smem + S.rev_off);  // [t - t0][j][u][2N]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int J = S.J, ns = S.ns;
  const int b0 = blockIdx.x * ns;
  const int nvalid = min(ns, S.B - b0);

  for (int x = tid; x < ns * UN; x += kThreads) {
    const int s = x / UN, y = x - s * UN;
    acc[s * S.acc_s + y] =
        s < nvalid ? static_cast<uint32_t>(acc0[static_cast<size_t>(b0) * UN + x]) : 0u;
  }

  // This warp's output tiles and its lane's fixed byte offset into rev.
  const int tile0 = warp * CT, u_out = tile0 / TPP, cb = (tile0 % TPP) * 16;
  const int base = N - 1 - cb - g + 4 * tig;      // y of row cb+g, column 4 tig, at d = cb
  const int sh = base & 3;
  const uint32_t sel = 0x3210u + 0x1111u * sh;
  const int pb = base - sh;

  // Lanes past the block's samples read sample 0's digits (columns never stored).
  const int8_t* dg = dig + (g < ns ? g : 0) * S.dig_s + 4 * tig;
  for (int i = 0; i < S.n; ++i) {
    const int32_t* key_i = key + static_cast<size_t>(i) * J * UN;
    for (int t0 = 0; t0 < kLimbs; t0 += S.lp)
    for (int j0 = 0; j0 < J; j0 += S.jp) {
      const int jn = min(S.jp, J - j0);
      __syncthreads();   // the previous pass no longer reads dig or rev; acc is updated
      // Limbs t0 .. t0+lp-1 of rows j0 .. j0+jn-1 of key step i as byte rows:
      // rev[t-t0][j-j0][u][N-1-m] = limb_t(k[m]), rev[..][2N-1-m] =
      // limb_t(-k[m]); four words of k a thread.
      int nz = 0;
      for (int x = tid; x < jn * UN / 4; x += kThreads) {
        const int ju = x / (N / 4), m0 = (x - ju * (N / 4)) * 4;
        const int4 kv = *reinterpret_cast<const int4*>(key_i + (j0 * U + ju) * N + m0);
        const uint32_t v[4] = {static_cast<uint32_t>(kv.x), static_cast<uint32_t>(kv.y),
                               static_cast<uint32_t>(kv.z), static_cast<uint32_t>(kv.w)};
        uint32_t pos[kLimbs] = {}, neg[kLimbs] = {};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int bp[kLimbs], bn[kLimbs];
          limbs(v[e], bp);
          limbs(0u - v[e], bn);
#pragma unroll
          for (int t = 0; t < kLimbs; ++t) {
            pos[t] |= static_cast<uint32_t>(bp[t] & 255) << (8 * (3 - e));
            neg[t] |= static_cast<uint32_t>(bn[t] & 255) << (8 * (3 - e));
          }
        }
#pragma unroll
        for (int t = 0; t < kLimbs; ++t) {
          if (t < t0 || t >= t0 + S.lp) continue;
          int8_t* row = rev + static_cast<size_t>((t - t0) * S.jp * U + ju) * twoN;
          *reinterpret_cast<uint32_t*>(row + N - 4 - m0) = pos[t];
          *reinterpret_cast<uint32_t*>(row + twoN - 4 - m0) = neg[t];
          nz |= (pos[t] | neg[t]) != 0u ? 1 << t : 0;
        }
      }
      // d = X^a * acc - acc, then its signed gadget digits (offset trick),
      // once a step, before any limb updates acc.
      if (t0 == 0 && j0 == 0) {
        for (int x = tid; x < ns * UN; x += kThreads) {
          const int s = x / UN, y = x - s * UN;
          const int u = y / N, c = y - u * N;
          uint32_t du = S.offset;
          if (s < nvalid) {
            const uint32_t* as = acc + s * S.acc_s + u * N;
            const int a = bara[static_cast<size_t>(i) * S.B + b0 + s];
            const int src = (c - a + twoN) & (twoN - 1);    // a in [0, 2N)
            const uint32_t v = src < N ? as[src] : 0u - as[src - N];
            du = v - as[c] + S.offset;
          }
          int8_t* ds = dig + s * S.dig_s + c;
          for (int li = 0; li < S.l; ++li) {
            const int shift = 32 - (li + 1) * S.Bgbit;
            ds[(u * S.l + li) * N] =
                static_cast<int8_t>(static_cast<int>((du >> shift) & S.mask) - S.halfBg);
          }
        }
      }
      // Barriers that also tell every thread which limbs are nonzero in this
      // pass's rows.
      int live = 0;
      for (int t = t0; t < t0 + S.lp; ++t) live |= __syncthreads_or(nz & (1 << t)) ? 1 << t : 0;

#pragma unroll 1
      for (int t = t0; t < t0 + S.lp; ++t) {
        if (!(live & (1 << t))) continue;
#pragma unroll 1
        for (int g0 = 0; g0 < CT; g0 += CG) {
          // The rows' partial sums are added into acc pass by pass: mod 2^32
          // the shifted sum of the parts is the shifted sum.
          int c[CG][4] = {};
#pragma unroll 1
          for (int j = j0; j < j0 + jn; ++j) {
            const int8_t* rv = rev +
                static_cast<size_t>(((t - t0) * S.jp + j - j0) * U + u_out) * twoN + pb - 16 * g0;
            const int8_t* dgj = dg + j * N;
            diagonal_walk<CG, 0, RG>(c, dgj, rv, sel);
            if constexpr (RT > RG) diagonal_walk<CG, RG, RG>(c, dgj, rv, sel);
            if constexpr (RT > 2 * RG) diagonal_walk<CG, 2 * RG, RG>(c, dgj, rv, sel);
            if constexpr (RT > 3 * RG) diagonal_walk<CG, 3 * RG, RG>(c, dgj, rv, sel);
          }
          // acc += limb sum << 8t (mod 2^32): rows cb + 16 (g0 + ii) + g (+8),
          // samples 2 tig (+1).
          if (2 * tig < ns) {
#pragma unroll
            for (int ii = 0; ii < CG; ++ii) {
              uint32_t* a = acc + 2 * tig * S.acc_s + u_out * N + cb + 16 * (g0 + ii) + g;
              a[0] += static_cast<uint32_t>(c[ii][0]) << (8 * t);
              a[S.acc_s] += static_cast<uint32_t>(c[ii][1]) << (8 * t);
              a[8] += static_cast<uint32_t>(c[ii][2]) << (8 * t);
              a[S.acc_s + 8] += static_cast<uint32_t>(c[ii][3]) << (8 * t);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  for (int x = tid; x < nvalid * UN; x += kThreads) {
    const int s = x / UN, y = x - s * UN;
    out[static_cast<size_t>(b0) * UN + x] = static_cast<int32_t>(acc[s * S.acc_s + y]);
  }
}

template <int N, int U>
int launch_n(const Shape& S, size_t smem, const void* acc0, const void* bara, const void* key,
             void* out, cudaStream_t stream) {
  auto kernel = blind_rotate_compact_kernel<N, U>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (S.B + S.ns - 1) / S.ns;
  kernel<<<grid, Tiling<N, U>::kThreads, smem, stream>>>(
      static_cast<const int32_t*>(acc0), static_cast<const int32_t*>(bara),
      static_cast<const int32_t*>(key), static_cast<int32_t*>(out), S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of a block of `ns` samples with the byte rows of `lp` limbs
// and `jp` digit rows: the accumulators, the digits and the rows, + 16
// (ops/blind_rotate_compact.smem_bytes). Sets S's layout fields.
static size_t plan(Shape& S, int ns, int lp, int jp) {
  S.ns = ns;
  S.lp = lp;
  S.jp = jp;
  S.acc_s = S.U * S.N + 4;
  S.dig_s = S.J * S.N + 16;
  S.dig_off = ns * S.acc_s * 4;
  S.rev_off = S.dig_off + ns * S.dig_s;
  return static_cast<size_t>(S.rev_off) + static_cast<size_t>(lp) * jp * S.U * 2 * S.N + 16;
}

// Launches the blind rotation on `stream`.  acc0, out: (B, U, N) int32;
// bara: (n, B) int32 in [0, 2N); key: (n, U*l, U, N) int32, the stored key.
// Supported: U = 2 to 5 and N a power of two from 32 to 4096, at the first
// of (samples, limbs a pass, rows a pass) = (8, 4, J), (8, 1, J), (4, 4, J),
// (4, 1, J), (2, 4, J), (2, 1, J), then (8, 1, jp), (4, 1, jp), (2, 1, jp)
// with the most rows jp < J that fit, whose shared memory is below the
// card's limit (the Python wrapper refuses the rest first, by name:
// ops/blind_rotate_compact.check_kernel_domain).
// Returns a cudaError_t (0 on success); allocates nothing and does not sync.
extern "C" int blind_rotate_compact_launch(const void* acc0, const void* bara, const void* key,
                                           void* out, int B, int n, int U, int N, int l,
                                           int Bgbit, void* stream) {
  Shape S;
  S.B = B; S.n = n; S.U = U; S.N = N; S.l = l; S.J = U * l; S.Bgbit = Bgbit;
  if (B <= 0 || n < 0 || U < 2 || U > 5 || N < 32 || N > 4096 || (N & (N - 1)) != 0 ||
      l <= 0 || Bgbit <= 0 || Bgbit > 8 || l * Bgbit > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  S.halfBg = 1 << (Bgbit - 1);   // <= 128: int8 digits, the reference's exact domain
  // Each limb's MMA sum: J*N products |digit| * |byte| <= halfBg * 128.
  if (static_cast<long long>(S.J) * N * S.halfBg * 128 >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  S.mask = (1u << Bgbit) - 1u;
  S.offset = 0;
  for (int p = 0; p < l; ++p)
    S.offset += static_cast<uint32_t>(S.halfBg) << (32 - (p + 1) * Bgbit);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t smem = 0;
  bool fits = false;
  for (int ns = kMaxSamples; ns >= 2 && !fits; ns /= 2)
    for (int lp : {kLimbs, 1})
      if (!fits) fits = (smem = plan(S, ns, lp, S.J)) <= static_cast<size_t>(optin);
  for (int ns = kMaxSamples; ns >= 2 && !fits; ns /= 2)
    for (int jp = S.J - 1; jp >= 1 && !fits; --jp)
      fits = (smem = plan(S, ns, 1, jp)) <= static_cast<size_t>(optin);
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto at_u = [&](auto u) {
    constexpr int kU = decltype(u)::value;
    switch (N) {
      case 32: return launch_n<32, kU>(S, smem, acc0, bara, key, out, st);
      case 64: return launch_n<64, kU>(S, smem, acc0, bara, key, out, st);
      case 128: return launch_n<128, kU>(S, smem, acc0, bara, key, out, st);
      case 256: return launch_n<256, kU>(S, smem, acc0, bara, key, out, st);
      case 512: return launch_n<512, kU>(S, smem, acc0, bara, key, out, st);
      case 1024: return launch_n<1024, kU>(S, smem, acc0, bara, key, out, st);
      case 2048: return launch_n<2048, kU>(S, smem, acc0, bara, key, out, st);
      default:   // N = 4096: no plan fits at U = 5 (acc and digits alone at 2 samples)
        if constexpr (kU < 5) return launch_n<4096, kU>(S, smem, acc0, bara, key, out, st);
        return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (U == 2) return at_u(std::integral_constant<int, 2>{});
  if (U == 3) return at_u(std::integral_constant<int, 3>{});
  if (U == 4) return at_u(std::integral_constant<int, 4>{});
  return at_u(std::integral_constant<int, 5>{});
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
