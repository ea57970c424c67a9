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
// form refuses halfBg > 128, ROADMAP C1). For each limb t the MMA sums the
// jp*N products of one pass (jp digit rows, all N coefficients) into int32,
// |sum| <= jp*N*halfBg*128 < 2^31 (5.0e7 at the 128-bit set, jp = J = 6),
// and the pass adds its sums into acc as acc += sum_t << 8t in uint32, mod
// 2^32. The launcher bounds the sum per pass, as the reference's fused
// kernel bounds it per chunk of 128 coefficients (J*128*halfBg*128 < 2^31,
// pallas_blindrot.py:135) and adds the chunks mod 2^32: where the whole J*N
// would overflow (N = 16384 k = 2 l = 3 Bgbit = 8: 2.4e9) the plan takes
// fewer rows a pass (ROADMAP C11). It does not rely on the MMA's int32
// wraparound. A limb that is zero in every word
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
// 4; at N = 4096 U = 2 to 4, since no plan fits U = 5 there), at 2 to 8
// samples a block.
//
// The general kernel (ROADMAP C10) replaces the refusal of every other
// shape, not the instantiations, which keep every shape they took: U of any
// size (a run-time value; 8 warps take the walks of 16*CG output
// coefficients in turn), N = 8 and 16 (digit rows padded with zeros to the MMA's
// k32), N >= 2048 at run time (32 tiles a walk, the r-tiles in any number of
// passes of 32: N = 8192, 16384, ...), one sample a block, and, where one
// sample does not fit a block at one limb and one row a pass, a thread-block
// cluster of C = 2, 4 or 8 blocks (the fewest that hold it). It is taken
// only where no instantiation's plan fits. The cluster splits the outputs:
// block c owns coefficients [c N/C, (c+1) N/C) of each output polynomial,
// its share of the accumulators (in its shared memory), holds the whole
// samples' digits, computed from the whole accumulators (the other blocks'
// shares read through DSMEM, cluster.map_shared_rank), and of each key row
// only the N + N/C bytes its outputs meet. Barriers: a cluster barrier
// (barrier.cluster.arrive.release / wait.acquire) before each step's digit
// pass (every share holds the last step) and one after it (no block updates
// its share while another reads it); no DSMEM read follows the last one, so
// no block exits while another reads its shared memory. Shared memory a
// block: ns (U N/C + 4) 4 + ns (J max(N, 32) + 16) + lp jp U (N + N/C + 32,
// or 2N + 32 without a cluster) + 16: at N = 8192 k = 1 l = 3, one sample, one
// limb and 3 rows a pass, 213,232 bytes; at N = 16384, C = 2, one row a
// pass, 213,104. What bounds it on this card: 232,448 bytes a block and 8
// portable blocks a cluster, so a sample whose digits alone (J N bytes,
// held whole in each block) and one row's window exceed a block is refused
// (N = 16384 k = 3 l = 2: 237,744 bytes at C = 8); the launcher asks
// cudaOccupancyMaxActiveClusters whether the cluster can be scheduled.
//
// The staged tier (ROADMAP C11) of the general kernel replaces the refusal
// of a sample whose J digit rows do not fit a block of a cluster of 8 (N =
// 8192 k = 2 l = 8 Bgbit = 4: 236,688 bytes; N = 16384 k = 3 l = 2), and is
// taken only where no plan above fits. Each pass's share of jp digit rows is
// computed from the step's starting accumulators (the other blocks' shares
// read through DSMEM, as above), so the block holds jp*max(N, 32) digit
// bytes, not J of them; the share's Toeplitz products go into an update
// buffer of the block's U*N/C words beside acc, which is committed to acc
// (and cleared) after the last share, so acc stays the step's start while
// the shares' digits are computed. The passes go share by share, the limbs
// of a share inside: a share's digits are computed once, at its first limb
// pass, so a step still computes J*N digits, but each row reads its
// polynomial's accumulators again (two words a digit, l times the reads of
// the pass above, some through DSMEM); each limb pass converts the share's
// key words again, as the instantiations' one-limb plans do.
// Barriers a step: a cluster barrier before the first pass (every share of
// acc holds the last step) and one before the commit (no block reads acc
// any more); the last DSMEM read comes before the last commit's barrier.
// Shared memory: 2 ns (U N/C + 4) 4 + ns (jp max(N, 32) + 16) + lp jp U RW
// + 16: at N = 8192 k = 2 l = 8 Bgbit = 4, C = 2, one limb and 2 rows a pass,
// 188,672 bytes; at N = 16384 k = 4, C = 8, one limb and 1 row, 190,688.
// Nothing in it grows with J but the number of passes, so every shape up to
// N = 16384 with l*Bgbit <= 32 and halfBg <= 128 is taken.
//
// The global tier (ROADMAP C12) replaces the refusal of every shape whose
// sample's share of the accumulators (and the staged tier's update buffer)
// outgrows a block of a cluster of 8 (N = 32768 at k >= 2: 241,824 bytes a
// block at k = 2; every k at N = 65536), and of the shapes whose limb sum
// over one digit row and the whole ring reaches 2^31 (N >= 131072 at halfBg
// = 128); it is taken only where no plan above fits, so every shape up to N
// = 16384 keeps its plan. The accumulators live in device memory: the
// output, (B, U, N) int32, copied from acc0 and updated in place. Each step
// is two launches on the stream: compact_global_digits writes the step's
// digits of every sample once to the device scratch (B, J, N) int8, then
// blind_rotate_compact_global gives each block 8 samples (the MMA's
// columns) and a tile of kGlobalTile output coefficients of one polynomial
// (one walk of 32 tiles a warp, the general kernel's walk). The block
// streams the contraction through shared memory a pass at a time: jp digit
// rows of a chunk of kGlobalChunk input coefficients, and of each of the
// rows the key window y in [N - c0 - TB + r0, + TB + RC) the tile meets,
// converted to its four byte limbs as above; jp = min(J, kGlobalRows).
// Its int32 MMA sums cover jp rows of one chunk, jp*RC*halfBg*128 < 2^31
// (the reference's per-chunk rule, whatever N), and are added into the
// block's sums (shared memory, uint32) mod 2^32 after each pass; the sums
// are added into acc at the end of the launch. No claim on the MMA's
// wraparound. The launches order the steps (the next step's digits read
// every block's update), so the Python wrapper counts one launch a
// rotation. Shared memory: 8 (TB + 4) 4 + 8 (jp RC + 16) + 4 jp (TB + RC +
// 32) + 16 = 217,744 bytes at 3 rows a pass, whatever U, N, J: the tier has
// no N ceiling; device memory bounds it (B U N 4 + B J N bytes).
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

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
  int staged;  // the general kernel's staged tier: jp digit rows held, an update buffer
  int upd_off; // byte offset of the update buffer (staged only)
  // The general kernel only:
  int global_tier;   // the global tier: acc in device memory, digits in the scratch
  int C;       // blocks a cluster (1: no cluster)
  int Ns;      // coefficients of each output polynomial a block owns: N / C
  int NR;      // bytes of a digit row: max(N, 32) (rows past N are zero)
  int RW;      // bytes of a key row's window: (2N, or N + Ns in a cluster) + 32;
               // the global tier: kGlobalTile + kGlobalChunk + 32
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


// --- The general kernel ------------------------------------------------------
// Every shape the instantiations above do not take: U = k+1 of any size, N =
// 8 and 16 (one 16-row output tile a polynomial, rows past N not stored; the
// digit rows padded with zeros to 32 coefficients, the k32 tile of the
// MMA), N >= 8192, one sample a
// block, and a thread-block cluster where one sample does not fit a block.
// kGeneralWarps warps (up to 255 registers each: a walk holds 32 output tiles
// and 32 r-tiles of digits in registers) take the walks of 16*CG output
// coefficients in turn, walk w being (u = w / walks a polynomial, its
// coefficients); the r-tiles go in passes of RG, any number of them.
//
// The cluster. C blocks (2, 4 or 8) hold S.ns samples and split the
// outputs: block c owns coefficients [c Ns, (c+1) Ns) of each of the U
// polynomials (Ns = N/C), its share of the accumulators, in shared memory.
// Each block holds the digits of the whole samples, computed from the whole
// accumulators, its own share and the other blocks' read through DSMEM
// (cluster.map_shared_rank), and the bytes of each key row that its outputs
// meet: y in [N - c Ns - Ns, 2N - c Ns) of the row [k reversed | -k
// reversed], N + Ns of its 2N bytes. Two cluster barriers
// (barrier.cluster.arrive.release / wait.acquire) a step: before the digit
// pass (every block's last update of its share is visible) and after it
// (every block has read the accumulators before any block updates its
// share). A block's last DSMEM read comes before the last barrier, so no
// block exits while another reads its shared memory.
constexpr int kGeneralWarps = 8;
constexpr int kGeneralThreads = 32 * kGeneralWarps;

// NT: N where N < 2048 (the walk's tile counts at compile time), 0 for every
// N >= 2048 (32 output tiles a walk, r-tiles in passes of 32, N at run time).
template <int NT>
__global__ void __launch_bounds__(kGeneralThreads, 1) blind_rotate_compact_general(
    const int32_t* __restrict__ acc0, const int32_t* __restrict__ bara,
    const int32_t* __restrict__ key, int32_t* __restrict__ out, const Shape S) {
  constexpr int TPP = NT == 0 ? 128 : NT < 16 ? 1 : NT / 16;   // 16-row tiles a polynomial
  constexpr bool kShort = NT != 0 && NT < 16;            // N = 8: rows N..15 of the tile unused
  constexpr int CG = TPP >= 128 ? 32 : TPP >= 4 ? TPP / 4 : 1;   // tiles a walk
  constexpr int RG = NT == 0 ? 32 : NT <= 32 ? 1 : NT / 32 < 32 ? NT / 32 : 32;   // r-tiles a pass
  const int N = NT ? NT : S.N, twoN = 2 * N;
  const int U = S.U, J = S.J, ns = S.ns, C = S.C, Ns = S.Ns, NR = S.NR, RW = S.RW;
  const int UN = U * N, UNs = U * Ns;

  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);          // [s][acc_s]: u*Ns + c - c0
  uint32_t* upd = reinterpret_cast<uint32_t*>(smem + S.upd_off);   // staged: as acc
  int8_t* dig = reinterpret_cast<int8_t*>(smem + S.dig_off);  // [s][j (- j0 staged)][NR] + pad
  int8_t* rev = reinterpret_cast<int8_t*>(smem + S.rev_off);  // [t - t0][j - j0][u][RW]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int c0 = rank * Ns, y0 = N - c0 - Ns;     // first coefficient; first y of the window
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b0 = (blockIdx.x / C) * ns;
  const int nvalid = min(ns, S.B - b0);

  for (int x = tid; x < ns * UNs; x += kGeneralThreads) {
    const int s = x / UNs, y = x - s * UNs, u = y / Ns;
    acc[s * S.acc_s + y] = s < nvalid ? static_cast<uint32_t>(
        acc0[static_cast<size_t>(b0 + s) * UN + u * N + c0 + y - u * Ns]) : 0u;
    if (S.staged) upd[s * S.acc_s + y] = 0u;
  }
  const int held = S.staged ? S.jp : J;   // digit rows dig holds
  for (int x = tid; x < ns * held * (NR - N); x += kGeneralThreads) {   // N = 16: r in [16, 32)
    const int row = x / (NR - N);
    dig[(row / held) * S.dig_s + (row % held) * NR + N + x - row * (NR - N)] = 0;
  }
  // Word x of sample s, polynomial u, coefficient c of the whole accumulators.
  auto acc_word = [&](int s, int u, int c) {
    const int owner = c / Ns;
    uint32_t* p = acc + s * S.acc_s + u * Ns + c - owner * Ns;
    return C > 1 ? *cluster.map_shared_rank(p, owner) : *p;
  };

  const int sh = (Ns + 15 - g) & 3;           // byte offset of this lane's row in a word
  const uint32_t sel = 0x3210u + 0x1111u * sh;
  const int walks = kShort ? 1 : Ns / (16 * CG);   // walks of a polynomial's share
  const int8_t* dg = dig + (g < ns ? g : 0) * S.dig_s + 4 * tig;   // past ns: sample 0
  uint32_t* sum = S.staged ? upd : acc;   // where the passes add their limb sums
  const int shares = (J + S.jp - 1) / S.jp, lpasses = kLimbs / S.lp;
  for (int i = 0; i < S.n; ++i) {
    const int32_t* key_i = key + static_cast<size_t>(i) * J * UN;
    // Limb passes outside the row shares; staged: the shares outside.
    for (int ps = 0; ps < shares * lpasses; ++ps) {
      const int t0 = (S.staged ? ps % lpasses : ps / shares) * S.lp;
      const int j0 = (S.staged ? ps / lpasses : ps % shares) * S.jp;
      const int jn = min(S.jp, J - j0);
      const bool first = ps == 0;
      if (first && C > 1) cluster.sync();   // every block's share holds step i-1
      else __syncthreads();                 // the previous pass no longer reads dig or rev
      // Limbs t0 .. t0+lp-1 of rows j0 .. j0+jn-1 as byte rows, the window
      // of each: rev[..][16 + y - y0] for y = N-1-m (limb of k[m]) and
      // 2N-1-m (limb of -k[m]), four words of k a thread.
      int nz = 0;
      for (int x = tid; x < jn * U * (N / 4); x += kGeneralThreads) {
        const int ju = x / (N / 4), m0 = (x - ju * (N / 4)) * 4;
        const int yp = N - 4 - m0, yn = twoN - 4 - m0;
        const bool inp = yp >= y0 && yp < y0 + N + Ns, inn = yn >= y0 && yn < y0 + N + Ns;
        if (!inp && !inn) continue;
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
          int8_t* row = rev + static_cast<size_t>((t - t0) * S.jp * U + ju) * RW + 16 - y0;
          if (inp) *reinterpret_cast<uint32_t*>(row + yp) = pos[t];
          if (inn) *reinterpret_cast<uint32_t*>(row + yn) = neg[t];
          nz |= ((inp ? pos[t] : 0u) | (inn ? neg[t] : 0u)) != 0u ? 1 << t : 0;
        }
      }
      // d = X^a * acc - acc of the whole samples, then its signed gadget
      // digits (offset trick), once a step, before any block updates acc;
      // staged: rows j0 .. j0+jn-1 alone, at the share's first limb pass,
      // from the step's accumulators (acc changes only at the commit).
      if (S.staged && t0 == 0) {
        for (int x = tid; x < ns * jn * N; x += kGeneralThreads) {
          const int s = x / (jn * N), y = x - s * jn * N;
          const int jr = y / N, c = y - jr * N;
          const int u = (j0 + jr) / S.l, li = j0 + jr - u * S.l;
          uint32_t du = S.offset;
          if (s < nvalid) {
            const int a = bara[static_cast<size_t>(i) * S.B + b0 + s];
            const int src = (c - a + twoN) & (twoN - 1);    // a in [0, 2N)
            const uint32_t v = src < N ? acc_word(s, u, src) : 0u - acc_word(s, u, src - N);
            du = v - acc_word(s, u, c) + S.offset;
          }
          const int shift = 32 - (li + 1) * S.Bgbit;
          dig[s * S.dig_s + jr * NR + c] =
              static_cast<int8_t>(static_cast<int>((du >> shift) & S.mask) - S.halfBg);
        }
      } else if (first) {
        for (int x = tid; x < ns * UN; x += kGeneralThreads) {
          const int s = x / UN, y = x - s * UN;
          const int u = y / N, c = y - u * N;
          uint32_t du = S.offset;
          if (s < nvalid) {
            const int a = bara[static_cast<size_t>(i) * S.B + b0 + s];
            const int src = (c - a + twoN) & (twoN - 1);    // a in [0, 2N)
            const uint32_t v = src < N ? acc_word(s, u, src) : 0u - acc_word(s, u, src - N);
            du = v - acc_word(s, u, c) + S.offset;
          }
          int8_t* ds = dig + s * S.dig_s + c;
          for (int li = 0; li < S.l; ++li) {
            const int shift = 32 - (li + 1) * S.Bgbit;
            ds[(u * S.l + li) * NR] =
                static_cast<int8_t>(static_cast<int>((du >> shift) & S.mask) - S.halfBg);
          }
        }
        if (C > 1) cluster.sync();   // every block has read the accumulators
      }
      int live = 0;
      for (int t = t0; t < t0 + S.lp; ++t) live |= __syncthreads_or(nz & (1 << t)) ? 1 << t : 0;

#pragma unroll 1
      for (int t = t0; t < t0 + S.lp; ++t) {
        if (!(live & (1 << t))) continue;
#pragma unroll 1
        for (int w = warp; w < U * walks; w += kGeneralWarps) {
          const int u_out = w / walks, cb = (w - u_out * walks) * 16 * CG;   // in the share
          const int pb = Ns - 1 - cb - g + 4 * tig + 16 - sh;   // window index of the walk
          int c[CG][4] = {};
#pragma unroll 1
          for (int j = j0; j < j0 + jn; ++j) {
            const int8_t* rv = rev +
                static_cast<size_t>(((t - t0) * S.jp + j - j0) * U + u_out) * RW + pb;
            const int8_t* dgj = dg + (S.staged ? j - j0 : j) * NR;
#pragma unroll 1
            for (int q0 = 0; q0 < NR / 32; q0 += RG)
              diagonal_walk<CG, 0, RG>(c, dgj + 32 * q0, rv + 32 * q0, sel);
          }
          // acc += limb sum << 8t (mod 2^32): rows cb + 16 ii + g (+8),
          // samples 2 tig (+1).
#pragma unroll
          for (int ii = 0; ii < CG; ++ii) {
            uint32_t* a = sum + 2 * tig * S.acc_s + u_out * Ns + cb + 16 * ii + g;
            const bool hi8 = !kShort || cb + 16 * ii + g + 8 < Ns;   // row exists
            if (2 * tig < ns) {
              a[0] += static_cast<uint32_t>(c[ii][0]) << (8 * t);
              if (hi8) a[8] += static_cast<uint32_t>(c[ii][2]) << (8 * t);
            }
            if (2 * tig + 1 < ns) {
              a[S.acc_s] += static_cast<uint32_t>(c[ii][1]) << (8 * t);
              if (hi8) a[S.acc_s + 8] += static_cast<uint32_t>(c[ii][3]) << (8 * t);
            }
          }
        }
      }
    }
    if (S.staged) {   // commit the step's update once no block reads acc
      if (C > 1) cluster.sync();
      else __syncthreads();
      for (int x = tid; x < ns * UNs; x += kGeneralThreads) {
        const int y = (x / UNs) * S.acc_s + x % UNs;
        acc[y] += upd[y];
        upd[y] = 0u;
      }
    }
  }
  __syncthreads();

  for (int x = tid; x < nvalid * UNs; x += kGeneralThreads) {
    const int s = x / UNs, y = x - s * UNs, u = y / Ns;
    out[static_cast<size_t>(b0 + s) * UN + u * N + c0 + y - u * Ns] =
        static_cast<int32_t>(acc[s * S.acc_s + y]);
  }
}

int launch_general(const Shape& S, size_t smem, const void* acc0, const void* bara,
                   const void* key, void* out, cudaStream_t stream) {
  auto at = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((S.B + S.ns - 1) / S.ns * S.C);
    cfg.blockDim = dim3(kGeneralThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = S.C > 1 ? 1 : 0;
    if (S.C > 1) {   // a cluster of C blocks at this shared memory must fit the card
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const int32_t*>(acc0),
                             static_cast<const int32_t*>(bara), static_cast<const int32_t*>(key),
                             static_cast<int32_t*>(out), S);
    return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
  };
  switch (S.N) {
    case 8: return at(blind_rotate_compact_general<8>);
    case 16: return at(blind_rotate_compact_general<16>);
    case 32: return at(blind_rotate_compact_general<32>);
    case 64: return at(blind_rotate_compact_general<64>);
    case 128: return at(blind_rotate_compact_general<128>);
    case 256: return at(blind_rotate_compact_general<256>);
    case 512: return at(blind_rotate_compact_general<512>);
    case 1024: return at(blind_rotate_compact_general<1024>);
    default: return at(blind_rotate_compact_general<0>);   // N >= 2048
  }
}

// --- The global tier ---------------------------------------------------------
// The accumulators in device memory and the digits in the device scratch, one
// launch of each kernel below a step (see the head of this file).
constexpr int kGlobalTile = kGeneralWarps * 16 * 32;   // outputs a block: a walk a warp
constexpr int kGlobalChunk = 1024;                     // inputs a pass: 32 r-tiles
constexpr int kGlobalSamples = 8;                      // the MMA's columns
constexpr int kGlobalRows = 3;                         // digit rows a pass, at most
// The block's sums, the pass's digit chunks and its rows' windows of four
// limbs: 217,744 bytes; a fourth row (246,544) would pass the H100's 232,448.
constexpr size_t kGlobalSmem =
    kGlobalSamples * (kGlobalTile + 4) * 4 + kGlobalSamples * (kGlobalRows * kGlobalChunk + 16) +
    static_cast<size_t>(kLimbs) * kGlobalRows * (kGlobalTile + kGlobalChunk + 32) + 16;
static_assert(kGlobalSmem <= 232448, "the global tier's plan fits an H100 block");

// d = X^a acc - acc of every sample and its signed gadget digits (offset
// trick) into dig[s][j][c], j = u l + li.
__global__ void compact_global_digits(const uint32_t* __restrict__ acc,
                                      const int32_t* __restrict__ bara_i,
                                      int8_t* __restrict__ dig, const Shape S) {
  const int N = S.N, twoN = 2 * N;
  const size_t total = static_cast<size_t>(S.B) * S.U * N;
  for (size_t x = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; x < total;
       x += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t su = x / N;                        // sample s, polynomial u
    const int c = static_cast<int>(x - su * N), u = static_cast<int>(su % S.U);
    const int s = static_cast<int>(su / S.U);
    const uint32_t* as = acc + su * N;
    const int src = (c - bara_i[s] + twoN) & (twoN - 1);   // a in [0, 2N)
    const uint32_t v = src < N ? as[src] : 0u - as[src - N];
    const uint32_t du = v - as[c] + S.offset;
    int8_t* ds = dig + (static_cast<size_t>(s) * S.J + u * S.l) * N + c;
    for (int li = 0; li < S.l; ++li) {
      const int shift = 32 - (li + 1) * S.Bgbit;
      ds[static_cast<size_t>(li) * N] =
          static_cast<int8_t>(static_cast<int>((du >> shift) & S.mask) - S.halfBg);
    }
  }
}

// One CMux step's product for the block's 8 samples and kGlobalTile outputs
// of polynomial u_out: acc += sum_j dig_j (negacyclic*) key[j, u_out] over
// the tile, a pass (jp rows, one chunk, four limbs) at a time.
__global__ void __launch_bounds__(kGeneralThreads, 1) blind_rotate_compact_global(
    const int32_t* __restrict__ key_i, const int8_t* __restrict__ dig,
    uint32_t* __restrict__ acc, const Shape S) {
  constexpr int CG = 32, RG = 32, TB = kGlobalTile, RC = kGlobalChunk, ns = kGlobalSamples;
  static_assert(TB == kGeneralWarps * 16 * CG && RC % (32 * RG) == 0,
                "one walk a warp; whole walk passes a chunk");
  const int N = S.N, twoN = 2 * N, U = S.U, J = S.J, RW = S.RW;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sum = reinterpret_cast<uint32_t*>(smem);          // [s][acc_s]: c - c0
  int8_t* dgs = reinterpret_cast<int8_t*>(smem + S.dig_off);  // [s][j - j0][RC] + pad
  int8_t* win = reinterpret_cast<int8_t*>(smem + S.rev_off);  // [t][j - j0][RW]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int tiles = N / TB, u_out = blockIdx.y;
  const int c0 = (blockIdx.x % tiles) * TB, b0 = (blockIdx.x / tiles) * ns;
  const int nvalid = min(ns, S.B - b0);

  for (int x = tid; x < ns * S.acc_s; x += kGeneralThreads) sum[x] = 0u;
  const int sh = (TB + 15 - g) & 3;           // byte offset of this lane's row in a word
  const uint32_t sel = 0x3210u + 0x1111u * sh;
  const int cb = warp * 16 * CG;              // this warp's walk in the tile
  const int pb = TB - 1 - cb - g + 4 * tig + 16 - sh;   // its window index at r = r0
  const int8_t* dg = dgs + g * S.dig_s + 4 * tig;
  constexpr int kWords = (TB + RC) / 4;       // words of a window
  for (int j0 = 0; j0 < J; j0 += S.jp) {
    const int jn = min(S.jp, J - j0);
    for (int r0 = 0; r0 < N; r0 += RC) {
      const int y0 = N - c0 - TB + r0;        // the window's first y
      __syncthreads();     // the previous pass no longer reads dgs or win
      // Rows j0 .. j0+jn-1 of the chunk, 16 bytes a thread; zeros past B.
      for (int x = tid; x < ns * jn * (RC / 16); x += kGeneralThreads) {
        const int s = x / (jn * (RC / 16)), y = x - s * jn * (RC / 16);
        const int jr = y / (RC / 16), q = y - jr * (RC / 16);
        int4 v = make_int4(0, 0, 0, 0);
        if (s < nvalid)
          v = *reinterpret_cast<const int4*>(
              dig + (static_cast<size_t>(b0 + s) * J + j0 + jr) * N + r0 + 16 * q);
        *reinterpret_cast<int4*>(dgs + s * S.dig_s + jr * RC + 16 * q) = v;
      }
      // The four limbs of the window of rows j0 .. j0+jn-1: win[..][16 + y -
      // y0] for y = N-1-m (limb of k[m]) or 2N-1-m (limb of -k[m]), four
      // words of k a thread.
      int nz = 0;
      for (int x = tid; x < jn * kWords; x += kGeneralThreads) {
        const int jr = x / kWords, yb = y0 + 4 * (x - jr * kWords);
        const bool neg = yb >= N;
        const int m0 = (neg ? twoN : N) - 4 - yb;
        const int4 kv = *reinterpret_cast<const int4*>(
            key_i + (static_cast<size_t>(j0 + jr) * U + u_out) * N + m0);
        const uint32_t v[4] = {static_cast<uint32_t>(kv.x), static_cast<uint32_t>(kv.y),
                               static_cast<uint32_t>(kv.z), static_cast<uint32_t>(kv.w)};
        uint32_t w[kLimbs] = {};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int b[kLimbs];
          limbs(neg ? 0u - v[e] : v[e], b);
#pragma unroll
          for (int t = 0; t < kLimbs; ++t)
            w[t] |= static_cast<uint32_t>(b[t] & 255) << (8 * (3 - e));
        }
#pragma unroll
        for (int t = 0; t < kLimbs; ++t) {
          *reinterpret_cast<uint32_t*>(
              win + static_cast<size_t>(t * S.jp + jr) * RW + 16 + yb - y0) = w[t];
          nz |= w[t] != 0u ? 1 << t : 0;
        }
      }
      int live = 0;
      for (int t = 0; t < kLimbs; ++t) live |= __syncthreads_or(nz & (1 << t)) ? 1 << t : 0;

#pragma unroll 1
      for (int t = 0; t < kLimbs; ++t) {
        if (!(live & (1 << t))) continue;
        int c[CG][4] = {};
#pragma unroll 1
        for (int jr = 0; jr < jn; ++jr) {
          const int8_t* rv = win + static_cast<size_t>(t * S.jp + jr) * RW + pb;
          const int8_t* dgj = dg + jr * RC;
#pragma unroll 1
          for (int q0 = 0; q0 < RC / 32; q0 += RG)
            diagonal_walk<CG, 0, RG>(c, dgj + 32 * q0, rv + 32 * q0, sel);
        }
        // sums += the pass's limb sum << 8t (mod 2^32): rows cb + 16 ii + g
        // (+8), samples 2 tig (+1).
#pragma unroll
        for (int ii = 0; ii < CG; ++ii) {
          uint32_t* a = sum + 2 * tig * S.acc_s + cb + 16 * ii + g;
          a[0] += static_cast<uint32_t>(c[ii][0]) << (8 * t);
          a[S.acc_s] += static_cast<uint32_t>(c[ii][1]) << (8 * t);
          a[8] += static_cast<uint32_t>(c[ii][2]) << (8 * t);
          a[S.acc_s + 8] += static_cast<uint32_t>(c[ii][3]) << (8 * t);
        }
      }
    }
  }
  __syncthreads();
  for (int x = tid; x < nvalid * TB; x += kGeneralThreads) {
    const int s = x / TB, c = x - s * TB;
    acc[(static_cast<size_t>(b0 + s) * U + u_out) * N + c0 + c] += sum[s * S.acc_s + c];
  }
}

int launch_global(const Shape& S, size_t smem, const void* acc0, const void* bara,
                  const void* key, void* scratch, void* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(blind_rotate_compact_global,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t words = static_cast<size_t>(S.B) * S.U * S.N;
  err = cudaMemcpyAsync(out, acc0, words * 4, cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S.B + kGlobalSamples - 1) / kGlobalSamples * (S.N / kGlobalTile), S.U);
  const int dgrid = static_cast<int>(words / 256 < 4096 ? (words + 255) / 256 : 4096);
  uint32_t* acc = static_cast<uint32_t*>(out);
  int8_t* dig = static_cast<int8_t*>(scratch);
  for (int i = 0; i < S.n; ++i) {
    compact_global_digits<<<dgrid, 256, 0, stream>>>(
        acc, static_cast<const int32_t*>(bara) + static_cast<size_t>(i) * S.B, dig, S);
    blind_rotate_compact_global<<<grid, kGeneralThreads, smem, stream>>>(
        static_cast<const int32_t*>(key) + static_cast<size_t>(i) * S.J * S.U * S.N, dig,
        acc, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Shared memory of a block of `ns` samples with the byte rows of `lp` limbs
// and `jp` digit rows: the accumulators, the digits and the rows, + 16
// (ops/blind_rotate_compact.smem_bytes). Sets S's layout fields.
static size_t plan(Shape& S, int ns, int lp, int jp) {
  S.global_tier = 0;
  S.staged = 0;
  S.upd_off = 0;
  S.ns = ns;
  S.lp = lp;
  S.jp = jp;
  S.acc_s = S.U * S.N + 4;
  S.dig_s = S.J * S.N + 16;
  S.dig_off = ns * S.acc_s * 4;
  S.rev_off = S.dig_off + ns * S.dig_s;
  return static_cast<size_t>(S.rev_off) + static_cast<size_t>(lp) * jp * S.U * 2 * S.N + 16;
}

// The general kernel's shared memory for a block of a cluster of C blocks
// holding `ns` samples, with the byte rows of `lp` limbs and `jp` digit
// rows: the block's share of the accumulators, the whole samples' digits
// and the rows' windows, + 16 (ops/blind_rotate_compact.smem_bytes with
// general=True); staged: an update buffer beside the accumulators' share
// and the share's jp digit rows alone (staged=True). Sets S's layout fields.
static size_t plan_general(Shape& S, int C, int ns, int lp, int jp, bool staged = false) {
  S.global_tier = 0;
  S.staged = staged ? 1 : 0;
  S.C = C;
  S.Ns = S.N / C;
  S.NR = S.N > 32 ? S.N : 32;
  S.RW = (C == 1 ? 2 * S.N : S.N + S.Ns) + 32;
  S.ns = ns;
  S.lp = lp;
  S.jp = jp;
  S.acc_s = S.U * S.Ns + 4;
  S.dig_s = (staged ? jp : S.J) * S.NR + 16;
  S.upd_off = ns * S.acc_s * 4;
  S.dig_off = (staged ? 2 : 1) * ns * S.acc_s * 4;
  S.rev_off = S.dig_off + ns * S.dig_s;
  return static_cast<size_t>(S.rev_off) + static_cast<size_t>(lp) * jp * S.U * S.RW + 16;
}

// The global tier's shared memory for a block of 8 samples with the windows
// of four limbs and `jp` digit rows a pass: its sums, the pass's digit
// chunks and the windows, + 16 (ops/blind_rotate_compact.smem_bytes with
// global_tier=True). Sets S's layout fields.
static size_t plan_global(Shape& S, int jp) {
  S.global_tier = 1;
  S.staged = 0;
  S.upd_off = 0;
  S.C = 1;
  S.Ns = kGlobalTile;
  S.NR = kGlobalChunk;
  S.RW = kGlobalTile + kGlobalChunk + 32;
  S.ns = kGlobalSamples;
  S.lp = kLimbs;
  S.jp = jp;
  S.acc_s = kGlobalTile + 4;
  S.dig_s = jp * kGlobalChunk + 16;
  S.dig_off = S.ns * S.acc_s * 4;
  S.rev_off = S.dig_off + S.ns * S.dig_s;
  return static_cast<size_t>(S.rev_off) + static_cast<size_t>(kLimbs) * jp * S.RW + 16;
}

// Blocks a cluster that the general kernel can take at N: each block's
// share holds at least one walk of CG tiles (C = 1 below N = 1024).
static int max_cluster(int N) {
  if (N < 1024) return 1;
  const int cg_tiles = N >= 2048 ? 32 : 16;
  const int c = N / (16 * cg_tiles);
  return c < 8 ? c : 8;
}

// Launches the blind rotation on `stream`.  acc0, out: (B, U, N) int32;
// bara: (n, B) int32 in [0, 2N); key: (n, U*l, U, N) int32, the stored key.
// The instantiations, at U = 2 to 5 and N from 32 to 4096, take the first
// of (samples, limbs a pass, rows a pass) = (8, 4, J), (8, 1, J), (4, 4, J),
// (4, 1, J), (2, 4, J), (2, 1, J), then (8, 1, jp), (4, 1, jp), (2, 1, jp)
// with the most rows jp < J that fit; every other shape (any U, N a power
// of two from 8) takes the general kernel at the first fit of, per cluster
// size C = 1, 2, 4, 8 and samples 8, 4, 2, 1, (4, J), (1, J) and (1, jp);
// then its staged tier at the first fit of, per C and samples, (4, jp) and
// (1, jp), the most rows first; then, from N = kGlobalTile on, the global
// tier at 4 limbs and min(J, kGlobalRows) rows a pass. Every
// plan keeps a pass's limb sums below 2^31: jp*N*halfBg*128 < 2^31, or in
// the global tier jp*kGlobalChunk*halfBg*128 < 2^31. A shape that fits no
// plan is refused (the Python wrapper refuses it first, by name:
// ops/blind_rotate_compact.check_kernel_domain). scratch: the global tier's
// digits, B*J*N bytes (scratch_bytes is checked); no other plan reads it.
// Returns a cudaError_t (0 on success); allocates nothing and does not sync.
extern "C" int blind_rotate_compact_launch(const void* acc0, const void* bara, const void* key,
                                           void* scratch, long long scratch_bytes, void* out,
                                           int B, int n, int U, int N, int l, int Bgbit,
                                           void* stream) {
  Shape S;
  S.B = B; S.n = n; S.U = U; S.N = N; S.l = l; S.J = U * l; S.Bgbit = Bgbit;
  S.C = 1;
  if (B <= 0 || n < 0 || U < 1 || N < 8 || (N & (N - 1)) != 0 || l <= 0 || Bgbit <= 0 ||
      Bgbit > 8 || l * Bgbit > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  S.halfBg = 1 << (Bgbit - 1);   // <= 128: int8 digits, the reference's exact domain
  // Each pass's limb sum: jp*N products |digit| * |byte| <= halfBg * 128.
  auto rows_ok = [&](int jp) {
    return static_cast<long long>(jp) * N * S.halfBg * 128 < (1LL << 31);
  };
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
  const bool shipped = U >= 2 && U <= 5 && N >= 32 && N <= 4096;
  const size_t cap = static_cast<size_t>(optin);
  for (int ns = kMaxSamples; shipped && ns >= 2 && !fits; ns /= 2)
    for (int lp : {kLimbs, 1})
      if (!fits) fits = rows_ok(S.J) && (smem = plan(S, ns, lp, S.J)) <= cap;
  for (int ns = kMaxSamples; shipped && ns >= 2 && !fits; ns /= 2)
    for (int jp = S.J - 1; jp >= 1 && !fits; --jp)
      fits = rows_ok(jp) && (smem = plan(S, ns, 1, jp)) <= cap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fits) {
    // The general kernel: per cluster size (1, then 2, 4, 8), per samples
    // (8 down to 1), all J rows at four limbs and one limb a pass, then one
    // limb and the most rows that fit; then its staged tier, per cluster
    // size and samples, four limbs and then one limb a pass at the most
    // rows that fit.
    for (int C = 1; C <= max_cluster(N) && !fits; C *= 2)
      for (int ns = kMaxSamples; ns >= 1 && !fits; ns /= 2) {
        for (int lp : {kLimbs, 1})
          if (!fits) fits = rows_ok(S.J) && (smem = plan_general(S, C, ns, lp, S.J)) <= cap;
        for (int jp = S.J - 1; jp >= 1 && !fits; --jp)
          fits = rows_ok(jp) && (smem = plan_general(S, C, ns, 1, jp)) <= cap;
      }
    for (int C = 1; C <= max_cluster(N) && !fits; C *= 2)
      for (int ns = kMaxSamples; ns >= 1 && !fits; ns /= 2)
        for (int lp : {kLimbs, 1})
          for (int jp = S.J; jp >= 1 && !fits; --jp)
            fits = rows_ok(jp) && (smem = plan_general(S, C, ns, lp, jp, true)) <= cap;
    // Each pass's limb sum in the global tier: jp*kGlobalChunk products.
    auto chunk_ok = [&](int jp) {
      return static_cast<long long>(jp) * kGlobalChunk * S.halfBg * 128 < (1LL << 31);
    };
    const int jg = S.J < kGlobalRows ? S.J : kGlobalRows;
    if (!fits && N >= kGlobalTile && chunk_ok(jg)) fits = (smem = plan_global(S, jg)) <= cap;
    if (!fits) return static_cast<int>(cudaErrorInvalidValue);
    if (S.global_tier) {
      if (scratch_bytes < static_cast<long long>(B) * S.J * N)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_global(S, smem, acc0, bara, key, scratch, out, st);
    }
    return launch_general(S, smem, acc0, bara, key, out, st);
  }
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
