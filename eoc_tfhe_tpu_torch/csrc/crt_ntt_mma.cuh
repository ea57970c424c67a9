// The CRT-NTT blind rotation on the int8 tensor cores (mma.sync, sm_90a).
//
// Used by blind_rotate_ntt.cu (kernel K1, which replaces the TPU kernel
// eoc_tfhe_tpu/ops/pallas_ntt_blindrot2.py, blind_rotate_ntt_pallas2, line
// 241, its pallas_call at line 648) and by blind_rotate_ntt_v1.cu (kernel K3,
// which replaces eoc_tfhe_tpu/ops/pallas_ntt_blindrot.py,
// blind_rotate_ntt_pallas, line 146, its pallas_call at line 321); each gives
// its key's layout and load. All n CMux steps in one launch, each step
//   acc += sum_j digits_j(X^a acc - acc) (negacyclic*) bk[i, j, u]   mod 2^32
// by the reference's CRT-NTT dataflow: R-way Nussbaumer split, a length-F
// negacyclic NTT per prime as an F x F matrix product, the pointwise
// contraction over K = J*R rows against the NTT-domain key, the inverse NTT,
// CRT over the two primes and the recombination of the L key limbs (limb l
// shifted by rb + kbits l, rb > 0 for the reference's rounded-key plans,
// whose key was rounded to its top 32 - rb bits before the split). Every
// step is an exact integer sum followed by an exact reduction, so the output
// has the reference's bits.
//
// Limbs and exactness. Each residue r (|r| <= (p-1)/2 <= 32639) is split as
// r = lo + 256 hi, lo in [-128, 127], |hi| <= 127; a digit d with |d| <= 128
// is one int8 limb (DL = 1), a wider one (the 80-bit set, halfBg = 512) is
// d = lo + 256 hi with |hi| <= 2 (DL = 2). Every MMA sums int8 x int8
// products into int32; the stages combine their partial sums as follows.
//   forward  dhat = dig W: C0 = sum d_lo W_lo + d_hi V_lo, C1 = sum d_lo W_hi
//            + d_hi V_hi, with V = 256 W mod p (d_hi terms only for DL = 2),
//            so dhat == C0 + 256 C1 (mod p); |C0 + 256 C1| <= 257 FP 128
//            (128 + |d_hi|) < 2^31, checked by the launcher. At F = 512 that
//            is 2.16e9, so C1 is reduced first: |C0 + 256 (C1 mod p)| <= FP
//            128 (128 + |d_hi|) + 256 (p-1)/2.
//   pointwise chat = T dhat: three int32 sums C0 = lo.lo, C1 = lo.hi + hi.lo,
//            C2 = hi.hi, combined with c16 = 2^16 mod p balanced. A key
//            without Key::kReduceC2 (K1, over KERNEL_PRIMES, |c16| = 1023)
//            takes C0 + 256 C1 + c16 C2: |.| <= Kp 2^14 (1 + 512 + |c16|),
//            1.21e9 at Kp = 48 (2.4e9 at Kp = 96, so the general
//            instantiation reduces C2 for K1 too). A key with it (K3,
//            either prime pair) first reduces C2 to a balanced residue:
//            |.| <= Kp 2^14 513 +
//            max_p |c16_p| (p-1)/2, 7.4e8 at Kp = 48 over DEFAULT_PRIMES
//            (c16 = -16386 mod 40961), where the plain sum would be 1.33e10.
//            At Kp > 128 (up to 256 in the general instantiation) Kp 2^14
//            513 reaches 2.15e9, so C1 is reduced too: |.| <= Kp 2^14 +
//            256 (p-1)/2 + max_p |c16_p| (p-1)/2.
//            The launcher checks the bound of the key's kind against the
//            primes it is given. The reference's [A; 256A] key
//            (expand_kernel_key_256) would drop the c16 term, but it doubles
//            the key bytes that every block reads, and bytes are what this
//            stage costs; so the key stays [lo | hi] planes of A.
//   inverse  res = chat Winv with V = 256 Winv mod p: C0 = sum c_lo Wi_lo +
//            c_hi V_lo, C1 = sum c_lo Wi_hi + c_hi V_hi; |C0 + 256 C1| <=
//            257 FP 2^15 < 2^31 (FP <= 128), checked by the launcher. At F =
//            256 that bound is 2.16e9, so C1 is reduced first: |C0 + 256
//            (C1 mod p)| <= FP 2^15 + 256 (p-1)/2 < 2^31.
// Each stage ends in one reduction of an int32 sum to a balanced residue on
// the CUDA cores (a float quotient corrected by one conditional step),
// followed by the byte split for the next stage. CRT, key-limb
// recombination and the accumulator update are uint32 work on the CUDA
// cores.
//
// Shapes. K = J*R and M = L*U*R are padded to Kp, Mp, multiples of 16; the
// key reads as zero in the padding, so padded rows and columns add nothing.
// A block holds kS samples and kWarps = 16 warps. The forward and inverse
// stages are m16n8k32 products: rows k or m of one sample, columns f or t,
// contraction t or f over FP = max(F, 32) (the matrices are zero-padded, so
// stale padding columns contribute nothing). Warp w owns n8 tiles w + 16 jj
// of the columns for every live sample (one tile at F <= 128, two at F =
// 256, four at F = 512). At F <= 128 it loads its B fragments (W, Winv and
// their 256-multiples, byte planes in fragment order, NttContext.W_mma /
// Winv_mma, 32 bytes a lane per tile) once per prime into registers and
// walks the samples, so at batch 1 the warps share the one sample; at F >=
// 256 (kFW > 1) the fragments would not fit in registers, so each is read
// from L1/L2 at its use (at F = 512 the matrices are 512 x 512 byte planes
// per prime, 1 MB in all: they stream from L2), and the forward takes a
// warp's tiles two at a time. The pointwise stage is m16n8k16 per
// frequency: A is the key (Mp x Kp, Key::load gives a lane's fragment of
// one tile, through a per-warp staging tile where the key is transposed on
// the chip), the samples are N (columns past the block's kS samples repeat
// sample 0 and are not stored); warps take four frequencies at a time.
//
// Three families of instantiations. The shipped sets (F <= 128, Kp <= 64, 8
// samples fitting in shared memory) take kS = 8 at compile time and the
// m-tile count of Kp (MTK, 3 or 4) as a template parameter. Where U*R = 16
// (k = 1, N >= 64) the rows of one m-tile of the inverse are the (u, r)
// pairs of one key limb and a thread recombines the limbs of its outputs in
// registers (MTM = Mp/16 m-tiles, a template parameter); other shapes (k >=
// 2, or N = 32 where R = 4) take the scatter path (MTM = 0): each m-tile in
// turn, and the second prime's CRT'd value of row m = (limb, u, r) is added
// into acc[u][t*R + r] shifted by its limb with a uint32 atomicAdd (mod 2^32,
// so the order of the limbs does not matter). Every other shape (F = 256 or
// 512, Kp up to 256, shared memory that 8 samples overflow, or a rounded
// key, rb > 0: ROADMAP C7, C8, C9; Kp past 256 and F = 4: C10) takes the
// general instantiation, one per (digit limbs, F/128), with stages of its
// own (forward_general, pointwise_general): MTK = 16, the m-tiles of Kp four
// at a time and a warp's n8 tiles two at a time in loops (any Kp), the
// scatter path with the rb shift, and kS = 0, the samples a block a run-time
// value (8, 4, 2 or 1, the most that fit); at F = 4 (N = 16, R = 4; kTiny)
// one n8 tile whose columns f, t >= F are not stored (the matrices are zero
// there). Its pointwise sum always reduces C2 first (above),
// since at Kp = 96 K1's plain sum would leave int32 (2.4e9), and C1 too at
// Kp > 128; at F >= 256 the inverse reduces C1 before the product by 256,
// since 257 FP 2^15 would leave it too, and at F = 512 the forward does the
// same. At Kp > 128 the reduced C1 bounds the sum by Kp 2^14 + 256 (p-1)/2 +
// |c16| (p-1)/2, below 2^31 up to Kp of about 110,000, so no K is refused
// for its sums. The shipped sets keep their stages' code, instantiations and
// registers (their times move by registers alone: a shared stage that
// grew the loops and the rb shift cost K3 10% at the 128-bit set).
//
// The cluster instantiation (ROADMAP C10) replaces the refusal of a shape
// whose one sample does not fit a block (F >= 1024, i.e. N >= 8192; F = 512
// with Kp >= 144), not the instantiations above, which keep every shape
// they took. A thread-block cluster of C blocks (2, 4 or 8: the fewest
// whose share fits, then the most samples, 1 at the C10 shapes) holds the
// samples and splits them by frequency: block c owns Fc = F/C frequencies
// (at most 512) and the same Fc output columns t. Each block computes the
// samples' digits from the accumulators (global memory, read with __ldcg
// past L1, since other blocks update them) into its own dig, the forward
// for its columns of W, and the pointwise product over its frequencies of
// the key (so each key byte is read once per step and cluster); then a
// cluster barrier (cg::this_cluster().sync(): barrier.cluster.arrive.release
// and wait.acquire) makes every block's chat visible, and the inverse of
// its columns t contracts over all F, reading the A fragments of the other
// blocks' frequencies from their shared memory (DSMEM, map_shared_rank).
// The inverse reads chat, not per-block partial sums, because the partials
// of all F columns would need Mp x F int32 words a block where chat needs
// Mp x Fc bytes, and the reduction of partials mod p would add a stage. A
// second cluster barrier ends each prime: chat is free again, and every
// block's atomics into acc are visible to the next digit pass. Both the
// forward (FP 128 (128 + d_hi) + 256 (p-1)/2) and the inverse (FP 2^15 + 256
// (p-1)/2) reduce C1 first, since 257 FP 2^14 and 257 FP 2^15 leave int32 at
// FP >= 512 and 256. Shared memory a block: the digits DL ns Kp (FP + 16),
// chat 2 ns Mp (Fc + 16) in the same buffer, dhat Fc (2 ns Kp + 16) and the
// staging tiles: at N = 8192 (K3, C = 2) 133,632 bytes, at N = 16384 (C =
// 4) 167,424, at N = 4096 k = 2 l = 6 (C = 2) 162,560. What bounds it on
// this card: a block holds at most 232,448 bytes and a cluster at most 8
// portable blocks, so a shape whose digits and 1/8 of its spectra exceed a
// block (e.g. N = 4096, K = 360: 251,136 bytes) and F > 4096 are refused;
// the launcher also asks cudaOccupancyMaxActiveClusters whether a cluster of
// C blocks at that shared memory can be scheduled, and returns an error if
// not (the Python domain check refuses by name first). Such shapes take the
// stream tier (below).
//
// The stream tier (ROADMAP C11) replaces the refusal of a shape whose one
// sample's digits and 1/8 of its spectra exceed a block (N = 16384 k = 2 l
// = 4: 260,096 bytes; N = 4096 k = 2 l = 15 Bgbit = 2: 251,136; K1 at N =
// 1024 k = 4 l = 32 Bgbit = 1: 266,752), and is taken only where no plan
// above fits. One sample a cluster of C blocks, split by frequency as in the
// cluster instantiation, but no buffer grows with Kp and F together: the
// cluster's blocks write the step's digits once to the device scratch (each
// a share of the coefficients; the first block's scratch, in k32 slabs
// [t/32][DL][Kp][32] bytes, which stay in L2), and each block walks its Fc
// frequencies in sub-chunks of fs. For each sub-chunk the forward runs for
// all Kp rows at those fs frequencies: the slabs are streamed through
// shared memory (one or two in flight; rows swizzled by 16 bytes so that
// the fragment loads hit 32 banks), and each warp holds the int32 sums of up
// to kStreamTiles (m-tile, n8 tile) pairs across all of FP, so the forward's
// sum is the cluster instantiation's (C1 reduced first); then the pointwise
// product runs at once over the whole Kp of each of the fs frequencies
// (warps split by m-tile where fs/4 < 16), and its chat is stored. Carrying
// pointwise int32 sums across shares of Kp instead would need Mp Fc 4 bytes
// (245,760 at N = 16384 k = 4, Mp = 240, Fc = 256). The inverse is the
// cluster instantiation's, chat read through DSMEM. Shared memory a block:
// chat 2 Mp (Fc + 16), dhat fs (2 Kp + 16), the slabs DL Kp 32 each and the
// staging tiles. Cost: the digits are read from L2 Fc/fs times a prime and
// block (Kp FP DL bytes each time), and fs is at most 8 * 128 / (Kp/16) (the
// forward tiles the block's warps hold in registers), so a large Kp streams
// them more often (Kp = 1280: fs = 8).
//
// The narrow tier (K1 only) replaces none of these: it takes the shipped
// shapes at a batch whose sample groups leave most SMs idle (B <= 8 is one
// block of 132 SMs): clusters of up to 16 blocks, split by frequency and by
// row, the accumulator in the blocks' shared memory for the whole launch and
// each step's key share staged by bulk copies (its section below).
//
// Shared memory, per block of kS samples (128-bit set: F = 128, K = M = 48,
// kS = 8): dig [DL][s][k][t] and chat [2][s][m][f] share one buffer, rows
// padded to FP + 16 bytes so that fragment loads hit 32 banks: 110,592
// bytes; dhat [f][2][s][k], each frequency padded by 16 bytes against bank
// conflicts of the forward's stores: 100,352 bytes; then Key::kStageBytes per
// warp for a key that is transposed on the chip (K3: 8,704); 210,944 (K1) or
// 219,648 (K3) of the 232,448 bytes a block may use (80-bit set: 215,040,
// 223,744). At F = 512 (N = 4096, K = 48, M = 64 over DEFAULT_PRIMES) one
// sample needs 133,632 bytes (K3) and two 250,368, so those blocks hold
// one. A shape that needs more at 1 sample (at F = 512: Kp >= 144) takes the
// cluster instantiation (above). The accumulators
// live in the output tensor (global memory, L2-resident, each word read once
// and updated once a step); a per-block scratch tensor holds the first
// prime's inverse residues (in a thread-private order) and a copy of the
// digits, which the second prime reads back instead of recomputing them.
//
// L2 key traffic and occupancy. Every key byte a block reads serves its kS
// samples (the CUDA-core kernel served 2): 1.18 MB per step and block at the
// 128-bit set, B/8 * n * 1.18 MB per launch. The cluster instantiation
// splits one sample's frequencies across blocks; multicasting the key into
// the blocks of a cluster, so that one key read serves more samples, is later
// work.
// One block per SM; B = 8192 is 1024 blocks, 7.8 waves of 132. The
// stages are bound by latency more than by instruction rate or by the
// tensor cores (stubbing out the MMAs does not change the time), hence 16
// warps at 128 registers each, and every load of a stage is started before
// the values it feeds are needed (B fragments per prime, digit-pass loads in
// groups of 8, the CRT's res0 and acc words before the sample's MMAs).
// -DCRT_MMA_PROFILE builds a diagnostic library that counts block 0's clock
// cycles by stage (kernel_times.py --stages).

#pragma once

#include <array>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <mutex>
#include <vector>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace crt_mma {

namespace cg = cooperative_groups;

constexpr int kWarps = 16;    // warps per block: 128 registers each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSamples = 8;   // samples per block: the pointwise MMA's N

// The n8 tiles of F a warp owns and the k32 tiles of FP, at F <= 128 (kFW =
// 1), F = 256 (2) or F = 512 (4).
template <int kFW>
struct Freq {
  static constexpr int kNJ = kFW;
  static constexpr int kKT = 4 * kFW;
};
constexpr int kNJ = Freq<1>::kNJ;      // held in registers: F <= 128
constexpr int kMaxKT = Freq<1>::kKT;
constexpr int kMaxClusterF = 512;      // frequencies a block holds: F up to 512 without a cluster
constexpr int kMaxCluster = 8;         // blocks a cluster (the portable limit)
constexpr int kStreamTiles = 8;        // the stream tier's forward tiles a warp holds

struct Shape {
  int B, n, U, N, R, F, FP, l, J, K, M, L, Bgbit, kbits, halfBg, crt_inv;
  int Kp, Mp, UR;     // K and M padded to multiples of 16; U*R
  int ns;             // samples per block: 8, 4, 2 or 1
  int log_n, log_r;   // log2 N, log2 R
  int p0, p1, half0, half1;
  int c16_0, c16_1;   // balanced 2^16 mod p
  float finv0, finv1;
  uint32_t offset, mask;
  int DS;        // byte stride of a dig or chat row: FP + 16
  int dig_plane; // bytes of one digit plane: ns * Kp * DS
  int y_plane;   // bytes of one chat plane: ns * Mp * DS
  int buf2;      // byte offset of dhat
  int xs;        // bytes per frequency of dhat: 2 * ns * Kp + 16 (bank spread)
  int stage;     // byte offset of the per-warp key staging tiles
  int res0_16, dig16, scratch16;   // 16-byte words of a block's scratch: res0, digits, all
  int rb;        // key rounding bits: limb l carries scale 2^(rb + kbits l); general only
  int C;         // blocks a cluster (1: no cluster)
  int Fc;        // frequencies (and output coefficients t) a block of the cluster owns: F / C
  int DSc;       // byte stride of a chat row in the cluster instantiation: Fc + 16
  int fs;        // the stream tier: frequencies a sub-chunk (8 to 128)
  int slabs;     // the stream tier: digit slabs in flight (1 or 2)
  int slab;      // the stream tier: byte offset of the slabs
};


__device__ __forceinline__ void mma_k32(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k16(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Balanced z mod p for |z| < 2^31: q is the float quotient rounded to an
// integer by adding 1.5 * 2^23 (|z / p| < 2^22), the nearest integer or off
// by one, so one conditional step corrects it.
__device__ __forceinline__ int reduce32(int z, int p, int half, float inv_p) {
  const int q = __float_as_int(__fmaf_rn(__int2float_rn(z), inv_p, 12582912.0f)) - 0x4B400000;
  int r = static_cast<int>(static_cast<uint32_t>(z) - static_cast<uint32_t>(q * p));
  r -= r > half ? p : 0;
  r += r < -half ? p : 0;
  return r;
}

// r = lo + 256 hi with lo in [-128, 127].
__device__ __forceinline__ void split8(int r, int& lo, int& hi) {
  lo = ((r + 128) & 255) - 128;
  hi = (r - lo) >> 8;
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Gadget digits of d = X^a acc - acc (offset trick) into dig [DL][s][k][t],
// k = (u*l + li)*R + r for coefficient c = t*R + r. Dead samples get digit 0;
// the padding rows K <= k < Kp are zeroed. kS: samples a block, or 0 for
// S.ns (the general instantiation). kL2: read acc from L2 (__ldcg), where
// other blocks of a cluster updated it.
template <int DL, int kS, bool kL2 = false>
__device__ __forceinline__ void digit_pass(const Shape& S, int i, const uint32_t* acc,
                                           const int32_t* __restrict__ bara, int b0, int nvalid,
                                           int8_t* dig, int tid) {
  constexpr int kItems = 8;   // coefficients a thread loads before it computes
  const int ns = kS ? kS : S.ns;
  const int lun = S.log_n + (S.U == 2 ? 1 : 0);
  const int UN = S.U * S.N, twoN = 2 * S.N, total = ns * UN;
  for (int x0 = tid; x0 < total; x0 += kItems * kThreads) {
    uint32_t du[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int x = x0 + q * kThreads;
      const int s = S.U == 2 ? x >> lun : x / UN, y = x - s * UN;
      const int u = y >> S.log_n, c = y & (S.N - 1);
      du[q] = S.offset;
      if (x < total && s < nvalid) {
        const uint32_t* as = acc + static_cast<size_t>(s) * UN + u * S.N;
        const int a = bara[static_cast<size_t>(i) * S.B + b0 + s];
        const int src = (c - a + twoN) & (twoN - 1);    // a in [0, 2N)
        if constexpr (kL2) {
          const uint32_t v = src < S.N ? __ldcg(as + src) : 0u - __ldcg(as + src - S.N);
          du[q] = v - __ldcg(as + c) + S.offset;
        } else {
          const uint32_t v = src < S.N ? as[src] : 0u - as[src - S.N];
          du[q] = v - as[c] + S.offset;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int x = x0 + q * kThreads;
      if (x >= total) continue;
      const int s = S.U == 2 ? x >> lun : x / UN, y = x - s * UN;
      const int u = y >> S.log_n, c = y & (S.N - 1);
      const int t = c >> S.log_r, r = c & (S.R - 1);
      for (int li = 0; li < S.l; ++li) {
        const int shift = 32 - (li + 1) * S.Bgbit;
        const int d = static_cast<int>((du[q] >> shift) & S.mask) - S.halfBg;
        const size_t row = static_cast<size_t>(s * S.Kp + (u * S.l + li) * S.R + r) * S.DS + t;
        if (DL == 1) {
          dig[row] = static_cast<int8_t>(d);
        } else {
          int lo, hi;
          split8(d, lo, hi);
          dig[row] = static_cast<int8_t>(lo);
          dig[S.dig_plane + row] = static_cast<int8_t>(hi);
        }
      }
    }
  }
  if (S.Kp > S.K) {
    const int pad = S.Kp - S.K, w16 = S.FP / 16;
    for (int x = tid; x < DL * ns * pad * w16; x += kThreads) {
      const int row = x / w16, q = row / (ns * pad), sr = row - q * ns * pad;
      const int s = sr / pad, k = S.K + sr - s * pad;
      *reinterpret_cast<uint4*>(dig + q * S.dig_plane + (s * S.Kp + k) * S.DS +
                                16 * (x - row * w16)) = make_uint4(0, 0, 0, 0);
    }
  }
}

// Forward NTT of the shipped instantiations (F <= 128, MTK = 3 or 4, kS =
// 8): dhat[f][plane][s][k] = balanced residue (byte planes) of sum_t
// dig[s][k][t] W[t][f]. Warp w owns the n8 tile nt = w of f for every live
// sample: it loads its W fragments once per prime and reuses them for each
// sample, and at batch 1 the warps share the one sample.
template <int DL, int PI, int MTK, int kS>
__device__ __forceinline__ void forward(const Shape& S, const int8_t* dig, int8_t* X,
                                        const uint4* __restrict__ Wf, int nvalid, int warp,
                                        int lane) {
  constexpr int NJ = kNJ, KTM = kMaxKT;
  constexpr int MTG = MTK < 4 ? MTK : 4;   // m-tiles a pass
  const int g = lane >> 2, tig = lane & 3;
  const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
  const float inv_p = PI ? S.finv1 : S.finv0;
  const int ns = kS ? kS : S.ns;
  const int MT = S.Kp / 16, FN = S.F / 8, NT = S.FP / 8, KT = S.FP / 32;
  if (warp >= FN) return;
  auto frag_ptr = [&](int jj, int kt) {
    return Wf + ((static_cast<size_t>(PI * NT + warp + kWarps * jj) * KT + kt) * 32 + lane) * 2;
  };
  uint4 w[NJ][KTM][DL];   // held
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int kt = 0; kt < KTM; ++kt) {
      const int nt = warp + kWarps * jj;
      if (nt >= FN || kt >= KT) continue;
      const uint4* wp = frag_ptr(jj, kt);
#pragma unroll
      for (int q = 0; q < DL; ++q) w[jj][kt][q] = __ldg(wp + q);
    }
  for (int s = 0; s < nvalid; ++s) {
    const int8_t* ds = dig + static_cast<size_t>(s) * S.Kp * S.DS;
#pragma unroll
    for (int mg = 0; mg < MTK; mg += MTG) {
      if (mg > 0 && mg >= MT) break;
      int c0[MTG][NJ][4] = {}, c1[MTG][NJ][4] = {};
#pragma unroll
      for (int kt = 0; kt < KTM; ++kt) {
        if (kt >= KT) continue;
        uint32_t a[DL][MTG][4];
#pragma unroll
        for (int q = 0; q < DL; ++q)
#pragma unroll
          for (int mt = 0; mt < MTG; ++mt) {
            if (mg + mt >= MT) continue;
            const int8_t* base =
                ds + q * S.dig_plane + ((mg + mt) * 16 + g) * S.DS + kt * 32 + 4 * tig;
            a[q][mt][0] = lds32(base);
            a[q][mt][1] = lds32(base + 8 * S.DS);
            a[q][mt][2] = lds32(base + 16);
            a[q][mt][3] = lds32(base + 8 * S.DS + 16);
          }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          if (warp + kWarps * jj >= FN) continue;
          uint4 wf[DL];
#pragma unroll
          for (int q = 0; q < DL; ++q) wf[q] = w[jj][kt][q];
#pragma unroll
          for (int mt = 0; mt < MTG; ++mt) {
            if (mg + mt >= MT) continue;
            mma_k32(c0[mt][jj], a[0][mt], wf[0].x, wf[0].y);
            mma_k32(c1[mt][jj], a[0][mt], wf[0].z, wf[0].w);
            if (DL == 2) {
              mma_k32(c0[mt][jj], a[DL - 1][mt], wf[DL - 1].x, wf[DL - 1].y);
              mma_k32(c1[mt][jj], a[DL - 1][mt], wf[DL - 1].z, wf[DL - 1].w);
            }
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int nt = warp + kWarps * jj;
        if (nt >= FN) continue;
#pragma unroll
        for (int mt = 0; mt < MTG; ++mt) {
          if (mg + mt >= MT) continue;
#pragma unroll
          for (int r4 = 0; r4 < 4; ++r4) {
            const int k = (mg + mt) * 16 + g + 8 * (r4 >> 1), f = nt * 8 + 2 * tig + (r4 & 1);
            const int res = reduce32(c0[mt][jj][r4] + c1[mt][jj][r4] * 256, p, half, inv_p);
            int lo, hi;
            split8(res, lo, hi);
            int8_t* xf = X + static_cast<size_t>(f) * S.xs + s * S.Kp + k;
            xf[0] = static_cast<int8_t>(lo);
            xf[ns * S.Kp] = static_cast<int8_t>(hi);
          }
        }
      }
    }
  }
}

// Forward NTT of the general instantiation (kS = 0, Kp up to 256, F up to
// 512): as forward(), but the W fragments are read at their use where F >=
// 256 (kFW > 1; at F = 512 the matrices are 1 MB of byte planes that stream
// from L2), a warp takes its n8 tiles two at a time (the accumulators'
// registers) and the m-tiles of Kp four at a time, both in loops (the
// build time), and at F = 512 C1 is reduced before its product by 256 (257
// FP 128^2 would leave int32). kTiny: F = 4 (N = 16), one n8 tile whose
// columns f >= F are not stored.
template <int DL, int PI, int kFW, bool kTiny>
__device__ __forceinline__ void forward_general(const Shape& S, const int8_t* dig, int8_t* X,
                                                const uint4* __restrict__ Wf, int nvalid,
                                                int warp, int lane) {
  constexpr bool kWide = kFW > 1;
  constexpr int NJ = Freq<kFW>::kNJ, KTM = Freq<kFW>::kKT;
  constexpr int NJB = NJ < 2 ? NJ : 2;     // n8 tiles a pass
  constexpr int MTG = 4;                   // m-tiles a pass
  const int g = lane >> 2, tig = lane & 3;
  const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
  const float inv_p = PI ? S.finv1 : S.finv0;
  const int ns = S.ns;
  const int MT = S.Kp / 16, FN = kTiny ? 1 : S.F / 8, NT = S.FP / 8, KT = S.FP / 32;
  if (warp >= FN) return;
  auto frag_ptr = [&](int jj, int kt) {
    return Wf + ((static_cast<size_t>(PI * NT + warp + kWarps * jj) * KT + kt) * 32 + lane) * 2;
  };
  uint4 w[kWide ? 1 : NJ][kWide ? 1 : KTM][DL];   // held: F <= 128
  if constexpr (!kWide) {
#pragma unroll
    for (int kt = 0; kt < KTM; ++kt) {
      if (kt >= KT) continue;
#pragma unroll
      for (int q = 0; q < DL; ++q) w[0][kt][q] = __ldg(frag_ptr(0, kt) + q);
    }
  }
  for (int s = 0; s < nvalid; ++s) {
    const int8_t* ds = dig + static_cast<size_t>(s) * S.Kp * S.DS;
#pragma unroll 1
    for (int mg = 0; mg < MT; mg += MTG) {
#pragma unroll 1
      for (int jb = 0; jb < NJ && warp + kWarps * jb < FN; jb += NJB) {
        int c0[MTG][NJB][4] = {}, c1[MTG][NJB][4] = {};
#pragma unroll
        for (int kt = 0; kt < KTM; ++kt) {
          if (kt >= KT) continue;
          uint32_t a[DL][MTG][4];
#pragma unroll
          for (int q = 0; q < DL; ++q)
#pragma unroll
            for (int mt = 0; mt < MTG; ++mt) {
              if (mg + mt >= MT) continue;
              const int8_t* base =
                  ds + q * S.dig_plane + ((mg + mt) * 16 + g) * S.DS + kt * 32 + 4 * tig;
              a[q][mt][0] = lds32(base);
              a[q][mt][1] = lds32(base + 8 * S.DS);
              a[q][mt][2] = lds32(base + 16);
              a[q][mt][3] = lds32(base + 8 * S.DS + 16);
            }
#pragma unroll
          for (int jj = 0; jj < NJB; ++jj) {
            if (warp + kWarps * (jb + jj) >= FN) continue;
            uint4 wf[DL];
#pragma unroll
            for (int q = 0; q < DL; ++q) {
              if constexpr (kWide) wf[q] = __ldg(frag_ptr(jb + jj, kt) + q);
              else wf[q] = w[0][kt][q];
            }
#pragma unroll
            for (int mt = 0; mt < MTG; ++mt) {
              if (mg + mt >= MT) continue;
              mma_k32(c0[mt][jj], a[0][mt], wf[0].x, wf[0].y);
              mma_k32(c1[mt][jj], a[0][mt], wf[0].z, wf[0].w);
              if (DL == 2) {
                mma_k32(c0[mt][jj], a[DL - 1][mt], wf[DL - 1].x, wf[DL - 1].y);
                mma_k32(c1[mt][jj], a[DL - 1][mt], wf[DL - 1].z, wf[DL - 1].w);
              }
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < NJB; ++jj) {
          const int nt = warp + kWarps * (jb + jj);
          if (nt >= FN) continue;
#pragma unroll
          for (int mt = 0; mt < MTG; ++mt) {
            if (mg + mt >= MT) continue;
#pragma unroll
            for (int r4 = 0; r4 < 4; ++r4) {
              const int k = (mg + mt) * 16 + g + 8 * (r4 >> 1), f = nt * 8 + 2 * tig + (r4 & 1);
              if (kTiny && f >= S.F) continue;
              const int c1r = kFW > 2 ? reduce32(c1[mt][jj][r4], p, half, inv_p)
                                      : c1[mt][jj][r4];
              const int res = reduce32(c0[mt][jj][r4] + c1r * 256, p, half, inv_p);
              int lo, hi;
              split8(res, lo, hi);
              int8_t* xf = X + static_cast<size_t>(f) * S.xs + s * S.Kp + k;
              xf[0] = static_cast<int8_t>(lo);
              xf[ns * S.Kp] = static_cast<int8_t>(hi);
            }
          }
        }
      }
    }
  }
}

// Pointwise product for the frequencies of this warp, in the shipped
// instantiations (Kp <= 64, kS = 8): chat[plane][s][m][f] = balanced residue
// of sum_k T[f][k][m] dhat[f][s][k]. Four frequencies a pass, so that each
// thread stores whole 32-bit words of chat. `stage` is this warp's
// Key::kStageBytes of shared memory. C2 is reduced before its c16 product
// for a key with kReduceC2.
template <class Key, int PI, int MTK, int kS>
__device__ __forceinline__ void pointwise(const Shape& S, int i, const typename Key::Elem* key,
                                          const int8_t* X, int8_t* Y, int8_t* stage, int warp,
                                          int lane) {
  constexpr bool kReduceC2 = Key::kReduceC2 || MTK > 4;
  const int g = lane >> 2, tig = lane & 3;
  const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
  const int c16 = PI ? S.c16_1 : S.c16_0;
  const float inv_p = PI ? S.finv1 : S.finv0;
  const int ns = kS ? kS : S.ns;
  const int gs = kS ? g : (g < ns ? g : 0);   // columns past the block's samples: sample 0
  const int MT = S.Mp / 16, KT = S.Kp / 16;
  for (int f0 = 4 * warp; f0 < S.F; f0 += 4 * kWarps) {
    for (int mt = 0; mt < MT; ++mt) {
      int c[4][3][4] = {};
#pragma unroll
      for (int fi = 0; fi < 4; ++fi) {
        const int f = f0 + fi;
        const int8_t* xf = X + static_cast<size_t>(f) * S.xs + gs * S.Kp + 4 * tig;
#pragma unroll
        for (int kt = 0; kt < MTK; ++kt) {
          if (kt >= KT) continue;
          // lo a0 a1, hi a0 a1
          const uint4 a = Key::load(key, S, i, PI, f, mt, kt, lane, stage);
          const uint32_t blo = lds32(xf + kt * 16), bhi = lds32(xf + ns * S.Kp + kt * 16);
          mma_k16(c[fi][0], a.x, a.y, blo);
          mma_k16(c[fi][1], a.x, a.y, bhi);
          mma_k16(c[fi][1], a.z, a.w, blo);
          mma_k16(c[fi][2], a.z, a.w, bhi);
        }
      }
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const int m = mt * 16 + g + 8 * (r4 >> 1), s = 2 * tig + (r4 & 1);
        if (kS == 0 && s >= ns) continue;
        uint32_t wlo = 0, whi = 0;
#pragma unroll
        for (int fi = 0; fi < 4; ++fi) {
          // 2^16 == c16 (mod p): the sum stays in int32 (bound checked at launch)
          const int c2 = kReduceC2 ? reduce32(c[fi][2][r4], p, half, inv_p) : c[fi][2][r4];
          const int z = c[fi][0][r4] + c[fi][1][r4] * 256 + c2 * c16;
          int lo, hi;
          split8(reduce32(z, p, half, inv_p), lo, hi);
          wlo |= static_cast<uint32_t>(lo & 255) << (8 * fi);
          whi |= static_cast<uint32_t>(hi & 255) << (8 * fi);
        }
        int8_t* y = Y + static_cast<size_t>(s * S.Mp + m) * S.DS + f0;
        *reinterpret_cast<uint32_t*>(y) = wlo;
        *reinterpret_cast<uint32_t*>(y + S.y_plane) = whi;
      }
    }
  }
}

// The pointwise product of the general and cluster instantiations (kS = 0,
// any Kp): as pointwise(), its k-tiles in a loop (the build time), C2
// always reduced before its c16 product (at Kp = 96 K1's plain sum would
// leave int32) and at Kp > 128 C1 before its product by 256 (Kp 2^15 256
// would). It sums the block's Fc frequencies f = rank Fc + fl into chat rows
// of stride DSc (rank 0, Fc = F and DSc = DS without a cluster). kChunk (the
// stream tier): the S.fs frequencies fl = fl_begin + .. of one sub-chunk,
// whose dhat alone X holds; where they are fewer than 4 a warp, the warps of
// a quad of frequencies take its m-tiles in turn.
template <class Key, int PI, bool kChunk = false>
__device__ __forceinline__ void pointwise_general(const Shape& S, int i,
                                                  const typename Key::Elem* key, const int8_t* X,
                                                  int8_t* Y, int8_t* stage, int rank, int warp,
                                                  int lane, int fl_begin = 0) {
  const int g = lane >> 2, tig = lane & 3;
  const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
  const int c16 = PI ? S.c16_1 : S.c16_0;
  const float inv_p = PI ? S.finv1 : S.finv0;
  const int ns = S.ns;
  const int gs = g < ns ? g : 0;   // columns past the block's samples: sample 0
  const int MT = S.Mp / 16, KT = S.Kp / 16, fbase = rank * S.Fc;
  const int nq = (kChunk ? S.fs : S.Fc) / 4;                  // quads of frequencies
  const int wq = kChunk && nq < kWarps ? kWarps / nq : 1;     // warps a quad
  const int x0 = kChunk ? fl_begin : 0;                       // frequency of X's row 0
  for (int q4 = warp / wq; q4 < nq; q4 += kWarps / wq) {
    const int fl0 = x0 + 4 * q4;
    for (int mt = kChunk ? warp % wq : 0; mt < MT; mt += wq) {
      int c[4][3][4] = {};
#pragma unroll
      for (int fi = 0; fi < 4; ++fi) {
        const int fl = fl0 + fi;
        const int8_t* xf = X + static_cast<size_t>(fl - x0) * S.xs + gs * S.Kp + 4 * tig;
#pragma unroll 2
        for (int kt = 0; kt < KT; ++kt) {
          const uint4 a = Key::load(key, S, i, PI, fbase + fl, mt, kt, lane, stage);
          const uint32_t blo = lds32(xf + kt * 16), bhi = lds32(xf + ns * S.Kp + kt * 16);
          mma_k16(c[fi][0], a.x, a.y, blo);
          mma_k16(c[fi][1], a.x, a.y, bhi);
          mma_k16(c[fi][1], a.z, a.w, blo);
          mma_k16(c[fi][2], a.z, a.w, bhi);
        }
      }
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const int m = mt * 16 + g + 8 * (r4 >> 1), s = 2 * tig + (r4 & 1);
        if (s >= ns) continue;
        uint32_t wlo = 0, whi = 0;
#pragma unroll
        for (int fi = 0; fi < 4; ++fi) {
          const int c2 = reduce32(c[fi][2][r4], p, half, inv_p);
          const int c1 = S.Kp > 128 ? reduce32(c[fi][1][r4], p, half, inv_p) : c[fi][1][r4];
          const int z = c[fi][0][r4] + c1 * 256 + c2 * c16;
          int lo, hi;
          split8(reduce32(z, p, half, inv_p), lo, hi);
          wlo |= static_cast<uint32_t>(lo & 255) << (8 * fi);
          whi |= static_cast<uint32_t>(hi & 255) << (8 * fi);
        }
        int8_t* y = Y + static_cast<size_t>(s * S.Mp + m) * S.DSc + fl0;
        *reinterpret_cast<uint32_t*>(y) = wlo;
        *reinterpret_cast<uint32_t*>(y + S.y_plane) = whi;
      }
    }
  }
}

// Copies n16 16-byte words from src to dst, all threads of the block.
__device__ __forceinline__ void copy16(uint4* dst, const uint4* src, int n16, int tid) {
  for (int x = tid; x < n16; x += kThreads) dst[x] = src[x];
}

// This warp's B fragments of Winv for prime PI: n8 tiles warp + kWarps jj
// (kTiny: F = 4, one tile).
template <int PI, bool kTiny = false>
__device__ __forceinline__ void load_winv(const Shape& S, const uint4* __restrict__ Wi,
                                          uint4 (&w)[kNJ][kMaxKT][2], int warp, int lane) {
  const int TN = kTiny ? 1 : S.F / 8, NT = S.FP / 8, KT = S.FP / 32;
#pragma unroll
  for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
    for (int kt = 0; kt < kMaxKT; ++kt) {
      const int nt = warp + kWarps * jj;
      if (nt >= TN || kt >= KT) continue;
      const uint4* wp = Wi + ((static_cast<size_t>(PI * NT + nt) * KT + kt) * 32 + lane) * 2;
      w[jj][kt][0] = __ldg(wp);
      w[jj][kt][1] = __ldg(wp + 1);
    }
}

// Inverse NTT, with the n8 tiles of t shared out as in forward(). First
// prime: the balanced residues go to res0 (slots of this thread alone).
// Second prime: CRT with res0, key-limb recombination and acc[s][u][t*R + r]
// += update, mod 2^32. The register path (U*R = 16, MTM = Mp/16 m-tiles).
template <int PI, int MTM>
__device__ __forceinline__ void inverse(const Shape& S, const int8_t* Y,
                                        const uint4* __restrict__ Wi, int16_t* res0,
                                        uint32_t* acc, int nvalid, int warp, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
  const float inv_p = PI ? S.finv1 : S.finv0;
  const int MT = S.Mp / 16, TN = S.F / 8, KT = S.FP / 32;
  const int UN = S.U * S.N;
  if (warp >= TN) return;
  uint4 w[kNJ][kMaxKT][2];
  load_winv<PI>(S, Wi, w, warp, lane);
  for (int s = 0; s < nvalid; ++s) {
    const int8_t* ys = Y + static_cast<size_t>(s) * S.Mp * S.DS;
    int16_t* slots = res0 + static_cast<size_t>(s) * S.Mp * S.F + lane;
    uint32_t* acc_s = acc + static_cast<size_t>(s) * UN;
    // Second prime: this sample's res0 slots and acc words, loaded before the
    // MMAs so that their latency overlaps them.
    int v0[kNJ][MTM][4];
    uint32_t* dst[kNJ][4];
    uint32_t old[kNJ][4];
    if (PI == 1) {
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        const int nt = warp + kWarps * jj;
        if (nt >= TN) continue;
#pragma unroll
        for (int mt = 0; mt < MTM; ++mt)
#pragma unroll
          for (int r4 = 0; r4 < 4; ++r4)
            if (mt < MT) v0[jj][mt][r4] = slots[((nt * MT + mt) * 4 + r4) * 32];
#pragma unroll
        for (int r4 = 0; r4 < 4; ++r4) {
          const int ur = g + 8 * (r4 >> 1), u = ur / S.R, r = ur - u * S.R;
          dst[jj][r4] = acc_s + u * S.N + (nt * 8 + 2 * tig + (r4 & 1)) * S.R + r;
          old[jj][r4] = *dst[jj][r4];
        }
      }
    }
    int c0[MTM][kNJ][4] = {}, c1[MTM][kNJ][4] = {};
#pragma unroll
    for (int kt = 0; kt < kMaxKT; ++kt) {
      if (kt >= KT) continue;
      uint32_t a[2][MTM][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int mt = 0; mt < MTM; ++mt) {
          if (mt >= MT) continue;
          const int8_t* base = ys + q * S.y_plane + (mt * 16 + g) * S.DS + kt * 32 + 4 * tig;
          a[q][mt][0] = lds32(base);
          a[q][mt][1] = lds32(base + 8 * S.DS);
          a[q][mt][2] = lds32(base + 16);
          a[q][mt][3] = lds32(base + 8 * S.DS + 16);
        }
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        if (warp + kWarps * jj >= TN) continue;
#pragma unroll
        for (int mt = 0; mt < MTM; ++mt) {
          if (mt >= MT) continue;
          mma_k32(c0[mt][jj], a[0][mt], w[jj][kt][0].x, w[jj][kt][0].y);
          mma_k32(c1[mt][jj], a[0][mt], w[jj][kt][0].z, w[jj][kt][0].w);
          mma_k32(c0[mt][jj], a[1][mt], w[jj][kt][1].x, w[jj][kt][1].y);
          mma_k32(c1[mt][jj], a[1][mt], w[jj][kt][1].z, w[jj][kt][1].w);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      const int nt = warp + kWarps * jj;
      if (nt >= TN) continue;
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        uint32_t upd = 0;
#pragma unroll
        for (int mt = 0; mt < MTM; ++mt) {
          if (mt >= MT) continue;
          const int v = reduce32(c0[mt][jj][r4] + c1[mt][jj][r4] * 256, p, half, inv_p);
          if (PI == 0) {
            slots[((nt * MT + mt) * 4 + r4) * 32] = static_cast<int16_t>(v);
          } else {
            const int q = reduce32((v - v0[jj][mt][r4]) * S.crt_inv, S.p1, S.half1, S.finv1);
            const int V = v0[jj][mt][r4] + q * S.p0;   // |V| < p0 p1 / 2 < 2^31
            upd += static_cast<uint32_t>(V) << (S.kbits * mt);
          }
        }
        if (PI == 1) *dst[jj][r4] = old[jj][r4] + upd;
      }
    }
  }
}

// The inverse NTT of the scatter path (U*R != 16, and the general
// instantiation): one m-tile at a time; the second prime adds V << (rb +
// kbits * limb) of row m = (limb, u, r) into acc[s][u][t*R + r] with a uint32
// atomicAdd (kRb: the general instantiation, which takes every rb > 0;
// elsewhere rb = 0). Padding rows m >= M are skipped. At F >= 256 (kFW > 1) the B
// fragments are read at their use, and C1 is reduced before its product by
// 256 (257 FP 2^15 would leave int32). kTiny: F = 4, one n8 tile of t whose
// columns t >= F are not stored (res0 holds 8 columns a row).
template <int PI, int kFW, bool kRb, bool kTiny = false>
__device__ __forceinline__ void inverse_scatter(const Shape& S, const int8_t* Y,
                                                const uint4* __restrict__ Wi, int16_t* res0,
                                                uint32_t* acc, int nvalid, int warp, int lane) {
  constexpr bool kWide = kFW > 1;
  constexpr int NJ = Freq<kFW>::kNJ, KTM = Freq<kFW>::kKT;
  const int g = lane >> 2, tig = lane & 3;
  const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
  const float inv_p = PI ? S.finv1 : S.finv0;
  const int MT = S.Mp / 16, TN = kTiny ? 1 : S.F / 8, NT = S.FP / 8, KT = S.FP / 32;
  if (warp >= TN) return;
  uint4 w[kNJ][kMaxKT][2];   // held: F <= 128
  if constexpr (!kWide) load_winv<PI, kTiny>(S, Wi, w, warp, lane);
  for (int s = 0; s < nvalid; ++s) {
    const int8_t* ys = Y + static_cast<size_t>(s) * S.Mp * S.DS;
    int16_t* slots = res0 + static_cast<size_t>(s) * S.Mp * (kTiny ? 8 : S.F) + lane;
    uint32_t* acc_s = acc + static_cast<size_t>(s) * S.U * S.N;
    for (int mt = 0; mt < MT; ++mt) {
      int c0[NJ][4] = {}, c1[NJ][4] = {};
#pragma unroll
      for (int kt = 0; kt < KTM; ++kt) {
        if (kt >= KT) continue;
        uint32_t a[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int8_t* base = ys + q * S.y_plane + (mt * 16 + g) * S.DS + kt * 32 + 4 * tig;
          a[q][0] = lds32(base);
          a[q][1] = lds32(base + 8 * S.DS);
          a[q][2] = lds32(base + 16);
          a[q][3] = lds32(base + 8 * S.DS + 16);
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          if (warp + kWarps * jj >= TN) continue;
          uint4 w0, w1;
          if constexpr (kWide) {
            const size_t nt = PI * NT + warp + kWarps * jj;
            const uint4* wp = Wi + ((nt * KT + kt) * 32 + lane) * 2;
            w0 = __ldg(wp);
            w1 = __ldg(wp + 1);
          } else {
            w0 = w[jj][kt][0];
            w1 = w[jj][kt][1];
          }
          mma_k32(c0[jj], a[0], w0.x, w0.y);
          mma_k32(c1[jj], a[0], w0.z, w0.w);
          mma_k32(c0[jj], a[1], w1.x, w1.y);
          mma_k32(c1[jj], a[1], w1.z, w1.w);
        }
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int nt = warp + kWarps * jj;
        if (nt >= TN) continue;
#pragma unroll
        for (int r4 = 0; r4 < 4; ++r4) {
          const int c1r = kWide ? reduce32(c1[jj][r4], p, half, inv_p) : c1[jj][r4];
          const int v = reduce32(c0[jj][r4] + c1r * 256, p, half, inv_p);
          int16_t* slot = slots + ((nt * MT + mt) * 4 + r4) * 32;
          if (PI == 0) {
            *slot = static_cast<int16_t>(v);
            continue;
          }
          const int m = mt * 16 + g + 8 * (r4 >> 1);
          const int t = nt * 8 + 2 * tig + (r4 & 1);
          if (m >= S.M || (kTiny && t >= S.F)) continue;
          const int v0 = *slot;
          const int q = reduce32((v - v0) * S.crt_inv, S.p1, S.half1, S.finv1);
          const int V = v0 + q * S.p0;   // |V| < p0 p1 / 2 < 2^31
          const int limb = m / S.UR, ur = m - limb * S.UR, u = ur / S.R, r = ur - u * S.R;
          atomicAdd(acc_s + u * S.N + t * S.R + r,
                    static_cast<uint32_t>(V) << ((kRb ? S.rb : 0) + S.kbits * limb));
        }
      }
    }
  }
}

#ifdef CRT_MMA_PROFILE
// Diagnostic build only (-DCRT_MMA_PROFILE): clock cycles of block 0 per stage.
__device__ unsigned long long phase_clocks[8];
#define CRT_MMA_PHASE(k)                                   \
  if (blockIdx.x == 0 && tid == 0) {                       \
    const long long now = clock64();                       \
    phase_clocks[k] += static_cast<unsigned long long>(now - t0); \
    t0 = now;                                              \
  }
#else
#define CRT_MMA_PHASE(k)
#endif

// MTK: m16 tiles of Kp (3 or 4; 16 in the general instantiation); MTM: m16
// tiles of Mp on the register path (3 or 4), or 0 for the scatter path; kS:
// samples a block (8), or 0 for S.ns (the general instantiation); kFW: FP/128
// rounded up (1, 2 or 4); kTiny: F = 4 (the general instantiation at N = 16).
template <class Key, int DL, int MTK, int MTM, int kS, int kFW, bool kTiny = false>
__global__ void __launch_bounds__(kThreads, 1) rotate_kernel(
    const int32_t* __restrict__ acc0, const int32_t* __restrict__ bara,
    const typename Key::Elem* __restrict__ key, const uint4* __restrict__ Wf,
    const uint4* __restrict__ Wi, uint4* __restrict__ scratch, int32_t* __restrict__ out,
    const Shape S) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* buf1 = reinterpret_cast<int8_t*>(smem);          // dig, then chat
  int8_t* X = reinterpret_cast<int8_t*>(smem + S.buf2);     // dhat
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int8_t* stage = reinterpret_cast<int8_t*>(smem + S.stage) + warp * Key::kStageBytes;
  const int UN = S.U * S.N;
  const int ns = kS ? kS : S.ns;
  const int b0 = blockIdx.x * ns;
  const int nvalid = min(ns, S.B - b0);
  uint32_t* acc = reinterpret_cast<uint32_t*>(out) + static_cast<size_t>(b0) * UN;
  // This block's scratch: the first prime's inverse residues, then the digits.
  uint4* scratch_b = scratch + static_cast<size_t>(blockIdx.x) * S.scratch16;
  int16_t* res0_b = reinterpret_cast<int16_t*>(scratch_b);
  uint4* dig_g = scratch_b + S.res0_16;
  const int dig16 = S.dig16;

  for (int x = tid; x < nvalid * UN; x += kThreads)
    acc[x] = static_cast<uint32_t>(acc0[static_cast<size_t>(b0) * UN + x]);
  __syncthreads();
#ifdef CRT_MMA_PROFILE
  long long t0 = clock64();
#endif

  for (int i = 0; i < S.n; ++i) {
    // first prime
    digit_pass<DL, kS>(S, i, acc, bara, b0, nvalid, buf1, tid);
    __syncthreads();
    CRT_MMA_PHASE(0);
    copy16(dig_g, reinterpret_cast<const uint4*>(buf1), dig16, tid);   // kept for the second
    if constexpr (kS > 0) forward<DL, 0, MTK, kS>(S, buf1, X, Wf, nvalid, warp, lane);
    else forward_general<DL, 0, kFW, kTiny>(S, buf1, X, Wf, nvalid, warp, lane);
    __syncthreads();
    CRT_MMA_PHASE(1);
    if constexpr (kS > 0) pointwise<Key, 0, MTK, kS>(S, i, key, X, buf1, stage, warp, lane);
    else pointwise_general<Key, 0>(S, i, key, X, buf1, stage, 0, warp, lane);
    __syncthreads();
    CRT_MMA_PHASE(2);
    if constexpr (MTM > 0) inverse<0, MTM>(S, buf1, Wi, res0_b, acc, nvalid, warp, lane);
    else inverse_scatter<0, kFW, kS == 0, kTiny>(S, buf1, Wi, res0_b, acc, nvalid, warp, lane);
    __syncthreads();
    CRT_MMA_PHASE(3);
    // second prime, then the accumulator update
    copy16(reinterpret_cast<uint4*>(buf1), dig_g, dig16, tid);
    __syncthreads();
    CRT_MMA_PHASE(4);
    if constexpr (kS > 0) forward<DL, 1, MTK, kS>(S, buf1, X, Wf, nvalid, warp, lane);
    else forward_general<DL, 1, kFW, kTiny>(S, buf1, X, Wf, nvalid, warp, lane);
    __syncthreads();
    CRT_MMA_PHASE(5);
    if constexpr (kS > 0) pointwise<Key, 1, MTK, kS>(S, i, key, X, buf1, stage, warp, lane);
    else pointwise_general<Key, 1>(S, i, key, X, buf1, stage, 0, warp, lane);
    __syncthreads();
    CRT_MMA_PHASE(6);
    if constexpr (MTM > 0) inverse<1, MTM>(S, buf1, Wi, res0_b, acc, nvalid, warp, lane);
    else inverse_scatter<1, kFW, kS == 0, kTiny>(S, buf1, Wi, res0_b, acc, nvalid, warp, lane);
    __syncthreads();
    CRT_MMA_PHASE(7);
  }
}


// --- The cluster instantiation --------------------------------------------
// Where one sample's buffers do not fit a block (F >= 1024, or F = 512 with
// Kp >= 144), a thread-block cluster of C blocks (2, 4 or 8) holds S.ns
// samples and splits them by frequency: block c (its rank in the cluster)
// owns the Fc = F/C frequencies f in [c Fc, (c+1) Fc) and, in the inverse,
// the Fc output columns t in the same range. Each block computes the whole
// sample's digits from the accumulators (global memory, read from L2) into
// its own dig [DL][s][Kp][FP + 16]; the forward gives dhat for its own
// frequencies (dig times its columns of W); the pointwise product reads
// only its frequencies of the key step, so each key byte is read once per
// step and cluster; chat [2][s][Mp][Fc + 16] stays in the block's shared
// memory. A cluster barrier (barrier.cluster.arrive.release / wait.acquire)
// makes every block's chat visible, and the inverse contracts over all F,
// reading the A fragments of frequencies f outside its own share from the
// owning block's shared memory (DSMEM, cluster.map_shared_rank): res[m][t]
// for its own t, C1 reduced before its product by 256 (FP 2^15 256 would
// leave int32 at F >= 256). A second cluster barrier ends each prime: no
// block overwrites its chat (the second prime's digits, the next step's)
// while another reads it, and every block's accumulator update (global
// atomics) is visible to the next step's digit pass in every block.

// Forward NTT of the cluster instantiation: dhat[fl][plane][s][k] for the
// block's local frequencies fl = f - rank Fc, the k-tiles of FP in a loop.
template <int DL, int PI>
__device__ __forceinline__ void forward_cluster(const Shape& S, const int8_t* dig, int8_t* X,
                                                const uint4* __restrict__ Wf, int nvalid,
                                                int rank, int warp, int lane) {
  constexpr int NJB = 2, MTG = 4;   // n8 tiles and m-tiles a pass
  const int g = lane >> 2, tig = lane & 3;
  const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
  const float inv_p = PI ? S.finv1 : S.finv0;
  const int ns = S.ns;
  const int MT = S.Kp / 16, FN = S.Fc / 8, NT = S.FP / 8, KT = S.FP / 32, nt0 = rank * FN;
  for (int s = 0; s < nvalid; ++s) {
    const int8_t* ds = dig + static_cast<size_t>(s) * S.Kp * S.DS;
#pragma unroll 1
    for (int mg = 0; mg < MT; mg += MTG) {
#pragma unroll 1
      for (int jb = 0; warp + kWarps * jb < FN; jb += NJB) {
        int c0[MTG][NJB][4] = {}, c1[MTG][NJB][4] = {};
#pragma unroll 2
        for (int kt = 0; kt < KT; ++kt) {
          uint32_t a[DL][MTG][4];
#pragma unroll
          for (int q = 0; q < DL; ++q)
#pragma unroll
            for (int mt = 0; mt < MTG; ++mt) {
              if (mg + mt >= MT) continue;
              const int8_t* base =
                  ds + q * S.dig_plane + ((mg + mt) * 16 + g) * S.DS + kt * 32 + 4 * tig;
              a[q][mt][0] = lds32(base);
              a[q][mt][1] = lds32(base + 8 * S.DS);
              a[q][mt][2] = lds32(base + 16);
              a[q][mt][3] = lds32(base + 8 * S.DS + 16);
            }
#pragma unroll
          for (int jj = 0; jj < NJB; ++jj) {
            const int nt = warp + kWarps * (jb + jj);
            if (nt >= FN) continue;
            const uint4* wp =
                Wf + ((static_cast<size_t>(PI * NT + nt0 + nt) * KT + kt) * 32 + lane) * 2;
            uint4 wf[DL];
#pragma unroll
            for (int q = 0; q < DL; ++q) wf[q] = __ldg(wp + q);
#pragma unroll
            for (int mt = 0; mt < MTG; ++mt) {
              if (mg + mt >= MT) continue;
              mma_k32(c0[mt][jj], a[0][mt], wf[0].x, wf[0].y);
              mma_k32(c1[mt][jj], a[0][mt], wf[0].z, wf[0].w);
              if (DL == 2) {
                mma_k32(c0[mt][jj], a[DL - 1][mt], wf[DL - 1].x, wf[DL - 1].y);
                mma_k32(c1[mt][jj], a[DL - 1][mt], wf[DL - 1].z, wf[DL - 1].w);
              }
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < NJB; ++jj) {
          const int nt = warp + kWarps * (jb + jj);
          if (nt >= FN) continue;
#pragma unroll
          for (int mt = 0; mt < MTG; ++mt) {
            if (mg + mt >= MT) continue;
#pragma unroll
            for (int r4 = 0; r4 < 4; ++r4) {
              const int k = (mg + mt) * 16 + g + 8 * (r4 >> 1), f = nt * 8 + 2 * tig + (r4 & 1);
              const int c1r = reduce32(c1[mt][jj][r4], p, half, inv_p);
              const int res = reduce32(c0[mt][jj][r4] + c1r * 256, p, half, inv_p);
              int lo, hi;
              split8(res, lo, hi);
              int8_t* xf = X + static_cast<size_t>(f) * S.xs + s * S.Kp + k;
              xf[0] = static_cast<int8_t>(lo);
              xf[ns * S.Kp] = static_cast<int8_t>(hi);
            }
          }
        }
      }
    }
  }
}

// The inverse NTT of the cluster instantiation, after a cluster barrier:
// res[m][t] for the block's own t = rank Fc + tl, contracting over every f;
// the A fragments of k32 tile kt (f in [32 kt, 32 kt + 32)) are read from
// the shared memory of the block that owns those frequencies. One m-tile at
// a time, a warp's n8 tiles two at a time; then as inverse_scatter (the
// second prime's CRT and the shifted atomicAdd into acc).
template <int PI>
__device__ __forceinline__ void inverse_cluster(const Shape& S, const cg::cluster_group& cluster,
                                                int8_t* Y, const uint4* __restrict__ Wi,
                                                int16_t* res0, uint32_t* acc, int nvalid,
                                                int rank, int warp, int lane) {
  constexpr int NJB = 2;
  const int g = lane >> 2, tig = lane & 3;
  const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
  const float inv_p = PI ? S.finv1 : S.finv0;
  const int MT = S.Mp / 16, TN = S.Fc / 8, NT = S.FP / 8, KT = S.FP / 32, KTB = S.Fc / 32;
  const int nt0 = rank * TN, tbase = rank * S.Fc;
  for (int s = 0; s < nvalid; ++s) {
    int16_t* slots = res0 + static_cast<size_t>(s) * S.Mp * S.Fc + lane;
    uint32_t* acc_s = acc + static_cast<size_t>(s) * S.U * S.N;
    const size_t ys = static_cast<size_t>(s) * S.Mp * S.DSc;
#pragma unroll 1
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll 1
      for (int jb = 0; warp + kWarps * jb < TN; jb += NJB) {
        int c0[NJB][4] = {}, c1[NJB][4] = {};
#pragma unroll 2
        for (int kt = 0; kt < KT; ++kt) {
          const int owner = kt / KTB;
          const int8_t* yo = cluster.map_shared_rank(Y, owner) + ys +
                             (mt * 16 + g) * S.DSc + (kt - owner * KTB) * 32 + 4 * tig;
          uint32_t a[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int8_t* base = yo + q * S.y_plane;
            a[q][0] = lds32(base);
            a[q][1] = lds32(base + 8 * S.DSc);
            a[q][2] = lds32(base + 16);
            a[q][3] = lds32(base + 8 * S.DSc + 16);
          }
#pragma unroll
          for (int jj = 0; jj < NJB; ++jj) {
            const int nt = warp + kWarps * (jb + jj);
            if (nt >= TN) continue;
            const uint4* wp =
                Wi + ((static_cast<size_t>(PI * NT + nt0 + nt) * KT + kt) * 32 + lane) * 2;
            const uint4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
            mma_k32(c0[jj], a[0], w0.x, w0.y);
            mma_k32(c1[jj], a[0], w0.z, w0.w);
            mma_k32(c0[jj], a[1], w1.x, w1.y);
            mma_k32(c1[jj], a[1], w1.z, w1.w);
          }
        }
#pragma unroll
        for (int jj = 0; jj < NJB; ++jj) {
          const int nt = warp + kWarps * (jb + jj);
          if (nt >= TN) continue;
#pragma unroll
          for (int r4 = 0; r4 < 4; ++r4) {
            const int c1r = reduce32(c1[jj][r4], p, half, inv_p);
            const int v = reduce32(c0[jj][r4] + c1r * 256, p, half, inv_p);
            int16_t* slot = slots + ((nt * MT + mt) * 4 + r4) * 32;
            if (PI == 0) {
              *slot = static_cast<int16_t>(v);
              continue;
            }
            const int m = mt * 16 + g + 8 * (r4 >> 1);
            if (m >= S.M) continue;
            const int v0 = *slot;
            const int q = reduce32((v - v0) * S.crt_inv, S.p1, S.half1, S.finv1);
            const int V = v0 + q * S.p0;   // |V| < p0 p1 / 2 < 2^31
            const int limb = m / S.UR, ur = m - limb * S.UR, u = ur / S.R, r = ur - u * S.R;
            const int t = tbase + nt * 8 + 2 * tig + (r4 & 1);
            atomicAdd(acc_s + u * S.N + t * S.R + r,
                      static_cast<uint32_t>(V) << (S.rb + S.kbits * limb));
          }
        }
      }
    }
  }
}

// The cluster instantiation (see above): cluster blockIdx.x / C holds
// samples b0 .. b0 + ns - 1; its blocks share them by frequency.
template <class Key, int DL>
__global__ void __launch_bounds__(kThreads, 1) rotate_kernel_cluster(
    const int32_t* __restrict__ acc0, const int32_t* __restrict__ bara,
    const typename Key::Elem* __restrict__ key, const uint4* __restrict__ Wf,
    const uint4* __restrict__ Wi, uint4* __restrict__ scratch, int32_t* __restrict__ out,
    const Shape S) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  int8_t* buf1 = reinterpret_cast<int8_t*>(smem);          // dig, then chat
  int8_t* X = reinterpret_cast<int8_t*>(smem + S.buf2);     // dhat of the block's frequencies
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int8_t* stage = reinterpret_cast<int8_t*>(smem + S.stage) + warp * Key::kStageBytes;
  const int rank = static_cast<int>(cluster.block_rank());
  const int UN = S.U * S.N, ns = S.ns;
  const int b0 = (blockIdx.x / S.C) * ns;
  const int nvalid = min(ns, S.B - b0);
  uint32_t* acc = reinterpret_cast<uint32_t*>(out) + static_cast<size_t>(b0) * UN;
  uint4* scratch_b = scratch + static_cast<size_t>(blockIdx.x) * S.scratch16;
  int16_t* res0_b = reinterpret_cast<int16_t*>(scratch_b);
  uint4* dig_g = scratch_b + S.res0_16;

  for (int x = rank * kThreads + tid; x < nvalid * UN; x += S.C * kThreads)
    acc[x] = static_cast<uint32_t>(acc0[static_cast<size_t>(b0) * UN + x]);
  cluster.sync();

  for (int i = 0; i < S.n; ++i) {
    // first prime
    digit_pass<DL, 0, true>(S, i, acc, bara, b0, nvalid, buf1, tid);
    __syncthreads();
    copy16(dig_g, reinterpret_cast<const uint4*>(buf1), S.dig16, tid);   // kept for the second
    forward_cluster<DL, 0>(S, buf1, X, Wf, nvalid, rank, warp, lane);
    __syncthreads();
    pointwise_general<Key, 0>(S, i, key, X, buf1, stage, rank, warp, lane);
    cluster.sync();   // every block's chat is written
    inverse_cluster<0>(S, cluster, buf1, Wi, res0_b, acc, nvalid, rank, warp, lane);
    cluster.sync();   // no block reads chat any more
    // second prime, then the accumulator update
    copy16(reinterpret_cast<uint4*>(buf1), dig_g, S.dig16, tid);
    __syncthreads();
    forward_cluster<DL, 1>(S, buf1, X, Wf, nvalid, rank, warp, lane);
    __syncthreads();
    pointwise_general<Key, 1>(S, i, key, X, buf1, stage, rank, warp, lane);
    cluster.sync();
    inverse_cluster<1>(S, cluster, buf1, Wi, res0_b, acc, nvalid, rank, warp, lane);
    cluster.sync();   // chat is free, and acc holds every block's update
  }
}

// --- The stream tier -------------------------------------------------------
// One sample a cluster, split by frequency as in the cluster instantiation,
// the digits in the device scratch and each block's frequencies walked in
// sub-chunks (see the head of this file).

// The step's digits into the cluster's scratch, as k32 slabs
// dig_g[t/32][plane][k][t%32]; block `rank` of the cluster takes every C-th
// share of the coefficients. acc is read from L2 (the other blocks' atomics).
template <int DL>
__device__ __forceinline__ void digit_pass_stream(const Shape& S, int i, const uint32_t* acc,
                                                  const int32_t* __restrict__ bara, int b0,
                                                  int8_t* dig_g, int rank, int tid) {
  const int UN = S.U * S.N, twoN = 2 * S.N;
  const int a = bara[static_cast<size_t>(i) * S.B + b0];
  for (int x = rank * kThreads + tid; x < UN; x += S.C * kThreads) {
    const int u = x >> S.log_n, c = x & (S.N - 1);
    const uint32_t* as = acc + u * S.N;
    const int src = (c - a + twoN) & (twoN - 1);    // a in [0, 2N)
    const uint32_t v = src < S.N ? __ldcg(as + src) : 0u - __ldcg(as + src - S.N);
    const uint32_t du = v - __ldcg(as + c) + S.offset;
    const int t = c >> S.log_r, r = c & (S.R - 1);
    int8_t* col = dig_g + static_cast<size_t>(t >> 5) * DL * S.Kp * 32 + (t & 31);
    for (int li = 0; li < S.l; ++li) {
      const int d = static_cast<int>((du >> (32 - (li + 1) * S.Bgbit)) & S.mask) - S.halfBg;
      const int k = (u * S.l + li) * S.R + r;
      if (DL == 1) {
        col[k * 32] = static_cast<int8_t>(d);
      } else {
        int lo, hi;
        split8(d, lo, hi);
        col[k * 32] = static_cast<int8_t>(lo);
        col[(S.Kp + k) * 32] = static_cast<int8_t>(hi);
      }
    }
  }
}

// Forward NTT of one sub-chunk of the stream tier: dhat[fl][plane][k] for the
// block's frequencies fs0 .. fs0 + fs - 1 (local fl = f - rank Fc - fs0) and
// every k, contracting over all FP columns t slab by slab. Warp w owns n8
// tile nt = w % (fs/8) of the sub-chunk and the m-tiles w / (fs/8) + q *
// (16 / (fs/8)), q < kStreamTiles; its sums run across every slab in
// registers. A slab, k32 tile kt of the digits (DL Kp rows of 32 bytes), is
// copied from the scratch (__ldcg: the digits change every step) with 16-byte
// half-rows swapped where bit 2 of the row is set, so that the A fragment
// loads (rows g and g + 8, bytes 4 tig and 16 + 4 tig) hit 32 banks.
template <int DL, int PI>
__device__ __forceinline__ void forward_stream(const Shape& S, const int8_t* dig_g,
                                               int8_t* slab, int8_t* X,
                                               const uint4* __restrict__ Wf, int rank, int fs0,
                                               int tid, int warp, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
  const float inv_p = PI ? S.finv1 : S.finv0;
  const int MT = S.Kp / 16, KT = S.FP / 32, NT = S.FP / 8;
  const int FN = S.fs / 8, WPN = kWarps / FN;   // n8 tiles of the sub-chunk; warps a tile
  const int nt = warp % FN, m0 = warp / FN;
  const int ntg = (rank * S.Fc + fs0) / 8 + nt;   // this warp's n8 tile of F
  const int slab_bytes = DL * S.Kp * 32;
  int c0[kStreamTiles][4] = {}, c1[kStreamTiles][4] = {};
#pragma unroll 1
  for (int kt = 0; kt < KT; ++kt) {
    int8_t* sb = slab + (kt % S.slabs) * slab_bytes;
    if (S.slabs == 1 && kt > 0) __syncthreads();   // no warp reads slab kt - 1 any more
    const uint4* src = reinterpret_cast<const uint4*>(dig_g + static_cast<size_t>(kt) * slab_bytes);
    for (int x = tid; x < slab_bytes / 16; x += kThreads) {
      const int row = x >> 1;
      reinterpret_cast<uint4*>(sb)[2 * row + ((x & 1) ^ ((row >> 2) & 1))] = __ldcg(src + x);
    }
    __syncthreads();   // slab kt is in shared memory
    const uint4* wp = Wf + ((static_cast<size_t>(PI * NT + ntg) * KT + kt) * 32 + lane) * 2;
    uint4 wf[DL];
#pragma unroll
    for (int q = 0; q < DL; ++q) wf[q] = __ldg(wp + q);
#pragma unroll
    for (int tw = 0; tw < kStreamTiles; ++tw) {
      const int mt = m0 + tw * WPN;
      if (mt >= MT) continue;
      uint32_t a[DL][4];
#pragma unroll
      for (int q = 0; q < DL; ++q) {
        const int r0 = q * S.Kp + mt * 16 + g;      // rows r0, r0 + 8: one swizzle
        const int sw = ((r0 >> 2) & 1) * 16;
        const int8_t* base = sb + r0 * 32 + 4 * tig;
        a[q][0] = lds32(base + sw);
        a[q][1] = lds32(base + 8 * 32 + sw);
        a[q][2] = lds32(base + (16 ^ sw));
        a[q][3] = lds32(base + 8 * 32 + (16 ^ sw));
      }
      mma_k32(c0[tw], a[0], wf[0].x, wf[0].y);
      mma_k32(c1[tw], a[0], wf[0].z, wf[0].w);
      if (DL == 2) {
        mma_k32(c0[tw], a[DL - 1], wf[DL - 1].x, wf[DL - 1].y);
        mma_k32(c1[tw], a[DL - 1], wf[DL - 1].z, wf[DL - 1].w);
      }
    }
  }
#pragma unroll
  for (int tw = 0; tw < kStreamTiles; ++tw) {
    const int mt = m0 + tw * WPN;
    if (mt >= MT) continue;
#pragma unroll
    for (int r4 = 0; r4 < 4; ++r4) {
      const int k = mt * 16 + g + 8 * (r4 >> 1), f = nt * 8 + 2 * tig + (r4 & 1);
      const int c1r = reduce32(c1[tw][r4], p, half, inv_p);
      const int res = reduce32(c0[tw][r4] + c1r * 256, p, half, inv_p);
      int lo, hi;
      split8(res, lo, hi);
      int8_t* xf = X + static_cast<size_t>(f) * S.xs + k;
      xf[0] = static_cast<int8_t>(lo);
      xf[S.Kp] = static_cast<int8_t>(hi);
    }
  }
}

// One prime of a step of the stream tier: the sub-chunks' forward and
// pointwise products into chat, then the cluster instantiation's inverse.
template <class Key, int DL, int PI>
__device__ __forceinline__ void stream_prime(const Shape& S, cg::cluster_group& cluster, int i,
                                             const typename Key::Elem* key, const uint4* Wf,
                                             const uint4* Wi, const int8_t* dig_g, int8_t* slab,
                                             int8_t* X, int8_t* Y, int8_t* stage, int16_t* res0,
                                             uint32_t* acc, int rank, int tid, int warp,
                                             int lane) {
  for (int fs0 = 0; fs0 < S.Fc; fs0 += S.fs) {
    forward_stream<DL, PI>(S, dig_g, slab, X, Wf, rank, fs0, tid, warp, lane);
    __syncthreads();   // the sub-chunk's dhat is written
    pointwise_general<Key, PI, true>(S, i, key, X, Y, stage, rank, warp, lane, fs0);
    __syncthreads();   // and read
  }
  cluster.sync();   // every block's chat is written
  inverse_cluster<PI>(S, cluster, Y, Wi, res0, acc, 1, rank, warp, lane);
  cluster.sync();   // no block reads chat any more; after PI = 1 acc holds every update
}

// The stream tier: cluster blockIdx.x / C holds sample blockIdx.x / C.
template <class Key, int DL>
__global__ void __launch_bounds__(kThreads, 1) rotate_kernel_stream(
    const int32_t* __restrict__ acc0, const int32_t* __restrict__ bara,
    const typename Key::Elem* __restrict__ key, const uint4* __restrict__ Wf,
    const uint4* __restrict__ Wi, uint4* __restrict__ scratch, int32_t* __restrict__ out,
    const Shape S) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  int8_t* Y = reinterpret_cast<int8_t*>(smem);               // chat of the block's frequencies
  int8_t* X = reinterpret_cast<int8_t*>(smem + S.buf2);      // dhat of one sub-chunk
  int8_t* slab = reinterpret_cast<int8_t*>(smem + S.slab);   // digit slabs
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int8_t* stage = reinterpret_cast<int8_t*>(smem + S.stage) + warp * Key::kStageBytes;
  const int rank = static_cast<int>(cluster.block_rank());
  const int UN = S.U * S.N, b0 = blockIdx.x / S.C;
  uint32_t* acc = reinterpret_cast<uint32_t*>(out) + static_cast<size_t>(b0) * UN;
  int16_t* res0_b = reinterpret_cast<int16_t*>(scratch + static_cast<size_t>(blockIdx.x) *
                                                             S.scratch16);
  // The cluster's digits: the digit part of its first block's scratch.
  int8_t* dig_g = reinterpret_cast<int8_t*>(
      scratch + static_cast<size_t>(blockIdx.x - rank) * S.scratch16 + S.res0_16);

  for (int x = rank * kThreads + tid; x < UN; x += S.C * kThreads)
    acc[x] = static_cast<uint32_t>(acc0[static_cast<size_t>(b0) * UN + x]);
  // The padding rows K <= k < Kp of every slab read as zero; written once.
  const int pad = S.Kp - S.K, KT = S.FP / 32;
  for (int x = rank * kThreads + tid; x < KT * DL * pad * 2; x += S.C * kThreads) {
    const int row = x >> 1, kq = row / pad, k = S.K + row - kq * pad;   // kq = kt DL + plane
    reinterpret_cast<uint4*>(dig_g + (static_cast<size_t>(kq) * S.Kp + k) * 32)[x & 1] =
        make_uint4(0, 0, 0, 0);
  }
  cluster.sync();

  for (int i = 0; i < S.n; ++i) {
    digit_pass_stream<DL>(S, i, acc, bara, b0, dig_g, rank, tid);
    cluster.sync();   // the step's digits are in the scratch
    stream_prime<Key, DL, 0>(S, cluster, i, key, Wf, Wi, dig_g, slab, X, Y, stage, res0_b, acc,
                             rank, tid, warp, lane);
    stream_prime<Key, DL, 1>(S, cluster, i, key, Wf, Wi, dig_g, slab, X, Y, stage, res0_b, acc,
                             rank, tid, warp, lane);
  }
}

// --- The narrow tier -------------------------------------------------------
// Where the batch's sample groups leave most SMs idle (B <= 8 is one group:
// one block on 1 of 132 SMs, each step streaming 1.18 MB of key through it),
// K1's shipped shapes (F from 32 to 128, Kp <= 64, rb = 0) take clusters of
// C blocks, each holding a group of ns samples (C = 16, 8, 4 or 2 dividing U
// R, the largest for which some ns, the fewest first, gives G = ceil(B/ns)
// groups with G C <= SMs that fit and that the card holds at once; 16 is the
// non-portable size: plan_narrow_tier), with no global memory in the step
// loop except the key and bara. The forward and pointwise products are split
// by frequency, the inverse and the accumulator by row:
// - block `rank` owns the pairs (u, r) = rank P .. rank P + P - 1, P = U R /
//   C: the coefficients t R + r of u, every t (own [s][P][F]), loaded once
//   and written once, and the inverse's rows m = (limb, u, r) of its pairs;
// - after its update each owner pushes its slice to every block of the
//   cluster, itself included, into the r-major accumulator (accf [s][u][r]
//   [t]: the owners' slices side by side), one bulk copy from shared memory
//   to shared memory a block and sample; each block forms the digits of X^a
//   acc - acc from accf (dig, the layout of the shipped instantiations; four
//   columns t a thread, so that loads and stores are whole words), a = bara
//   read one step ahead;
// - both primes at once: the forward of the block's Fc = F/C frequencies
//   (warps by prime and n8 tile, then by (sample, m-tile)) and the pointwise
//   product over them from the key share staged in shared memory (warps by
//   (prime, frequency quad, m-tile)), whose chat words are staged by the
//   owner of their row (z [owner][prime][s L P rows][plane][Fc]), so that one
//   bulk copy sends each owner its share; the owner receives them by sender
//   (y, the same layout with the sender for the owner) and runs the inverse
//   of its rows over all F from its own shared memory (transposed: t the
//   MMA's rows, the block's (sample, own row) pairs its columns), then the
//   CRT and the limb sum update its slice. So the accumulator and chat each
//   cross the cluster once a step, and every other read is local;
// - the key share of a prime and step (Fc (Mp/16) (Kp/16) 512 bytes,
//   contiguous in the packed key: 36,864 at the 128-bit set and C = 16) is
//   copied by one cp.async.bulk on an mbarrier a slot: four slots (the next
//   step's key is in flight while this step's is read) where shared memory
//   allows, else two (step i + 1's copies start after step i's pointwise);
//   where they fit (one sample a cluster, two slots) Winv's fragments of
//   both primes (128 KB at F = 128), which every block's inverse reads
//   whole each step, are staged in shared memory once a launch.
// Every int32 sum is the shipped instantiation's, over the same F and Kp
// (the contraction only runs across blocks), so its bounds hold unchanged.
// No cluster barrier in the step: a block learns that the accumulator and
// its chat have arrived from two mbarriers of its own ("acc", "chat"), each
// armed by the block for the bytes it expects a step (acc_tx, chat_tx) and
// completed by the senders' copies, its phase the step's parity. The step's
// data dependence orders each buffer's reuse: an owner pushes step i + 1's
// accumulator after it has every block's chat of step i, which each block
// sends after its digit pass has read accf and after every owner's step i
// accumulator, pushed after that owner's inverse of step i - 1 read y, has
// arrived; so accf, z, y and own (the push's source) are rewritten only after
// the copies that read or wrote them have completed. z and, after it, res
// (which a block still reads while an early owner pushes into accf) share
// the digits' bytes, dead from the forward until the next step's
// accumulator has arrived, which comes after the block's update and after
// z's copies have completed (the digit pass clears the padding rows each
// step). The key slots of step i are free after the block's own barrier
// past its pointwise. One cluster barrier after the mbarriers' initialisation (no
// block signals one before it is initialised) and one after the loop (every
// block's shared memory lives until no copy reads or writes it).

// Byte offsets of the narrow tier's buffers in shared memory, its key
// slots and the bytes of its exchanges (ops/blind_rotate.narrow_smem_bytes,
// narrow_exchange).
struct Narrow {
  int slots;       // key slots of one prime-step each: 4 or 2
  int key_bytes;   // a block's key share of one prime and step
  int pairs;       // pairs (u, r) a block owns: U R / C
  int rows;        // the inverse's rows a sample and block: L pairs
  int nr;          // n8 tiles of the block's rows (samples x rows, rounded up)
  int share;       // chat one block sends one owner a step: [prime][s rows][plane][Fc] int8
  int acc_tx;      // bytes a block receives on "acc" a step: ns U N 4 (C ns copies)
  int chat_tx;     // bytes a block receives on "chat" a step: C share (C copies)
  int accf;        // the pushed accumulator [s][u][r][F] uint32, acc_tx bytes
  int dig;         // the digits [DL][s][Kp][F + 16]; then chat staged by owner [C][share]
                   // and, chat_tx bytes on, the inverse's residues [prime][8 nr][F] int16
  int own;         // the block's slice [s][pairs][F] uint32
  int x;           // dhat [prime][fl][plane][s][Kp] (+16 a frequency)
  int y;           // chat received by sender [C][share], chat_tx bytes
  int bar;         // one mbarrier a slot, "acc", "chat", then bara of two steps [2][8] int32
  int wi;          // Winv's fragments (Wi) staged once a launch where they fit, else -1
  int smem;        // bytes in all
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of the bytes at `p` in block `rank` of the
// cluster (every block has the same layout).
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// One arrival on `bar` that expects `bytes` more in its current phase.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Arms `bar` for `bytes` and copies them from global memory into shared
// memory with one bulk copy that completes on it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  bar_expect(bar, bytes);
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Copies `bytes` of this block's shared memory at `src` to `dst` in block
// `rank` with one bulk copy that completes on `bar` in that block. The
// block's generic writes of `src` come first (fence_async, then a barrier).
__device__ __forceinline__ void bulk_push(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, int rank) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(peer_addr(dst, rank)), "r"(smem_addr(src)), "r"(bytes),
                  "r"(peer_addr(bar, rank)) : "memory");
}

// Orders this thread's generic writes to shared memory before the bulk
// copies that read them.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Waits until phase `parity` of `bar` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// The key shares of step i (both primes) into slots `slot` and slot + 1.
__device__ __forceinline__ void narrow_key_load(const Shape& S, const Narrow& P,
                                                const int8_t* key, int8_t* keys, uint64_t* bar,
                                                int i, int slot, int rank) {
  for (int pi = 0; pi < 2; ++pi) {
    const int8_t* src = key + (static_cast<size_t>(i * 2 + pi) * S.F + rank * S.Fc) *
                                  (S.Mp / 16) * (S.Kp / 16) * 512;
    bulk_load(keys + static_cast<size_t>(slot + pi) * P.key_bytes, src, P.key_bytes,
              bar + slot + pi);
  }
}

// Digits of d = X^a acc - acc (offset trick) from the r-major accumulator
// into dig [DL][s][k][t], k = (u l + li) R + r: a thread takes columns t =
// 4 tq .. 4 tq + 3 of one (s, u, r), so it reads a word of acc and stores a
// word of each digit plane. a: bara of this step; dead samples get digit 0.
template <int DL>
__device__ __forceinline__ void digits_narrow(const Shape& S, const uint32_t* accf,
                                              const int* a_s, int nvalid, int8_t* dig, int tid) {
  const int F = S.F, FQ = F / 4, twoN = 2 * S.N;
  for (int x = tid; x < S.ns * S.U * S.R * FQ; x += kThreads) {
    const int sur = x / FQ, tq = x - sur * FQ, s = sur / (S.U * S.R);
    const int ur = sur - s * S.U * S.R, u = ur >> S.log_r, r = ur & (S.R - 1);
    uint32_t du[4] = {S.offset, S.offset, S.offset, S.offset};
    if (s < nvalid) {
      const int a = a_s[s];
      const uint4 cur =
          *reinterpret_cast<const uint4*>(accf + static_cast<size_t>(sur) * F + 4 * tq);
      const uint32_t* as = accf + static_cast<size_t>(s * S.U + u) * S.R * F;
      const uint32_t c4[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int src = (((4 * tq + j) << S.log_r) + r - a + twoN) & (twoN - 1);   // a in [0, 2N)
        const int st = src >> S.log_r;
        const uint32_t v = as[(src & (S.R - 1)) * F + (st & (F - 1))];
        du[j] = (st < F ? v : 0u - v) - c4[j] + S.offset;
      }
    }
    for (int li = 0; li < S.l; ++li) {
      const int shift = 32 - (li + 1) * S.Bgbit;
      uint32_t wlo = 0, whi = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = static_cast<int>((du[j] >> shift) & S.mask) - S.halfBg;
        int lo = d, hi = 0;
        if (DL == 2) split8(d, lo, hi);
        wlo |= static_cast<uint32_t>(lo & 255) << (8 * j);
        whi |= static_cast<uint32_t>(hi & 255) << (8 * j);
      }
      int8_t* row = dig + static_cast<size_t>(s * S.Kp + (u * S.l + li) * S.R + r) * S.DS + 4 * tq;
      *reinterpret_cast<uint32_t*>(row) = wlo;
      if (DL == 2) *reinterpret_cast<uint32_t*>(row + S.dig_plane) = whi;
    }
  }
}

// The W fragments of this warp's forward group (prime, n8 tile of the
// block's frequencies): loaded at the start of a step, so that their latency
// overlaps the gather and the digit pass.
template <int DL>
__device__ __forceinline__ void load_w_narrow(const Shape& S, const uint4* __restrict__ Wf,
                                              uint4 (&w)[kMaxKT][DL], int rank, int warp,
                                              int lane) {
  const int FN = S.Fc / 8, grp = warp / (kWarps / (2 * FN)), PI = grp / FN;
  const int NT = S.F / 8, KT = S.F / 32;
  const size_t nt = PI * NT + rank * FN + grp - PI * FN;   // this group's n8 tile of F
  const uint4* wp = Wf + (nt * KT * 32 + lane) * 2;
#pragma unroll
  for (int kt = 0; kt < kMaxKT; ++kt) {
    if (kt >= KT) continue;
#pragma unroll
    for (int q = 0; q < DL; ++q) w[kt][q] = __ldg(wp + kt * 64 + q);
  }
}

// Forward NTT of the block's Fc frequencies for both primes: dhat[pi][fl]
// [plane][s][k]. Warps take a (prime, n8 tile) group each (16 / (2 Fc/8)
// warps a group), with its W fragments `w`, and walk its (sample, m-tile)
// pairs. The sum is the shipped forward's: |C0 + 256 C1| <= 257 F 128 (128 +
// |d_hi|).
template <int DL>
__device__ __forceinline__ void forward_narrow(const Shape& S, const int8_t* dig, int8_t* X,
                                               const uint4 (&w)[kMaxKT][DL], int nvalid,
                                               int warp, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int FN = S.Fc / 8, wpg = kWarps / (2 * FN);
  const int grp = warp / wpg, PI = grp / FN, nt = grp - PI * FN;
  const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
  const float inv_p = PI ? S.finv1 : S.finv0;
  const int MT = S.Kp / 16, KT = S.F / 32, ns = S.ns;
  int8_t* Xp = X + PI * S.Fc * S.xs;
  for (int u = warp - grp * wpg; u < nvalid * MT; u += wpg) {
    const int s = u / MT, mt = u - s * MT;
    const int8_t* ds = dig + static_cast<size_t>(s) * S.Kp * S.DS + (mt * 16 + g) * S.DS + 4 * tig;
    int c0[4] = {}, c1[4] = {};
#pragma unroll
    for (int kt = 0; kt < kMaxKT; ++kt) {
      if (kt >= KT) continue;
#pragma unroll
      for (int q = 0; q < DL; ++q) {
        const int8_t* base = ds + q * S.dig_plane + kt * 32;
        const uint32_t a[4] = {lds32(base), lds32(base + 8 * S.DS), lds32(base + 16),
                               lds32(base + 8 * S.DS + 16)};
        mma_k32(c0, a, w[kt][q].x, w[kt][q].y);
        mma_k32(c1, a, w[kt][q].z, w[kt][q].w);
      }
    }
#pragma unroll
    for (int r4 = 0; r4 < 4; ++r4) {
      const int k = mt * 16 + g + 8 * (r4 >> 1), f = nt * 8 + 2 * tig + (r4 & 1);
      int lo, hi;
      split8(reduce32(c0[r4] + c1[r4] * 256, p, half, inv_p), lo, hi);
      int8_t* xf = Xp + static_cast<size_t>(f) * S.xs + s * S.Kp + k;
      xf[0] = static_cast<int8_t>(lo);
      xf[ns * S.Kp] = static_cast<int8_t>(hi);
    }
  }
}

// Stages the chat words of row m (four frequencies 4 q4 .. of the block's,
// sample s, prime pi; planes lo, hi) in the share of the block that owns (u,
// r) of m = (limb, u, r), at its row s L P + limb P + pair % P.
__device__ __forceinline__ void stage_chat(const Shape& S, const Narrow& P, int8_t* Z, int pi,
                                           int s, int m, int q4, uint32_t wlo, uint32_t whi) {
  const int limb = m / S.UR, pair = m - limb * S.UR, owner = pair / P.pairs;
  const int row = s * P.rows + limb * P.pairs + pair - owner * P.pairs;
  int8_t* z = Z + owner * P.share + (pi * S.ns * P.rows + row) * 2 * S.Fc + 4 * q4;
  *reinterpret_cast<uint32_t*>(z) = wlo;
  *reinterpret_cast<uint32_t*>(z + S.Fc) = whi;
}

// Pointwise product of the block's frequencies for both primes from the
// staged key shares (`kslot`: prime 0's, prime 1's key_bytes further), four
// frequencies a unit so that a thread has whole words, units (prime, quad,
// m-tile) over the warps; each word is staged for its row's owner (stage_chat). C2
// is not reduced: K1's sum C0 + 256 C1 + c16 C2 <= Kp 2^14 (513 + 1023) <
// 2^31 at Kp <= 64.
__device__ __forceinline__ void pointwise_narrow(const Shape& S, const Narrow& P,
                                                 const int8_t* kslot, const int8_t* X, int8_t* Z,
                                                 int warp, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int ns = S.ns, gs = g < ns ? g : 0;   // columns past the samples: sample 0
  const int MT = S.Mp / 16, KT = S.Kp / 16, nq = S.Fc / 4;
  for (int u = warp; u < 2 * nq * MT; u += kWarps) {
    const int PI = u / (nq * MT), q4 = (u - PI * nq * MT) / MT, mt = u % MT;
    const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
    const int c16 = PI ? S.c16_1 : S.c16_0;
    const float inv_p = PI ? S.finv1 : S.finv0;
    const int8_t* kp = kslot + PI * P.key_bytes + lane * 16;
    int c[4][3][4] = {};
#pragma unroll
    for (int fi = 0; fi < 4; ++fi) {
      const int8_t* xf = X + static_cast<size_t>(PI * S.Fc + 4 * q4 + fi) * S.xs + gs * S.Kp +
                         4 * tig;
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt >= KT) continue;
        const uint4 a = *reinterpret_cast<const uint4*>(
            kp + (((4 * q4 + fi) * MT + mt) * KT + kt) * 512);
        const uint32_t blo = lds32(xf + kt * 16), bhi = lds32(xf + ns * S.Kp + kt * 16);
        mma_k16(c[fi][0], a.x, a.y, blo);
        mma_k16(c[fi][1], a.x, a.y, bhi);
        mma_k16(c[fi][1], a.z, a.w, blo);
        mma_k16(c[fi][2], a.z, a.w, bhi);
      }
    }
#pragma unroll
    for (int r4 = 0; r4 < 4; ++r4) {
      const int m = mt * 16 + g + 8 * (r4 >> 1), s = 2 * tig + (r4 & 1);
      if (s >= ns || m >= S.M) continue;
      uint32_t wlo = 0, whi = 0;
#pragma unroll
      for (int fi = 0; fi < 4; ++fi) {
        int lo, hi;
        split8(reduce32(c[fi][0][r4] + c[fi][1][r4] * 256 + c[fi][2][r4] * c16, p, half, inv_p),
               lo, hi);
        wlo |= static_cast<uint32_t>(lo & 255) << (8 * fi);
        whi |= static_cast<uint32_t>(hi & 255) << (8 * fi);
      }
      stage_chat(S, P, Z, PI, s, m, q4, wlo, whi);
    }
  }
}

// Inverse NTT of the block's rows for both primes, once every block's chat
// has arrived, from its own shared memory, transposed so that the rows are
// the MMA's columns: res[pi][row][t] = balanced residue of sum_f Winv[f][t]
// chat[row][f], units (prime, m-tile of t, n8 tile of rows) over the warps.
// Frequency f of a row is in sender f / Fc's share, four consecutive ones in
// one plane (Fc >= 8); the columns past the block's rows read its last row,
// and their residues are never read. The A fragments of Winv^T over t = 16
// mt .. are the B fragments of Winv's n8 tiles 2 mt and 2 mt + 1
// (ntt.NttContext.Winv_mma), read from shared memory where they are staged,
// else from L1/L2. |C0 + 256 C1| <= 257 F 2^15, as shipped.
__device__ __forceinline__ void inverse_narrow(const Shape& S, const Narrow& P, const int8_t* Y,
                                               const uint4* Wi, int16_t* res, int warp,
                                               int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int NT = S.F / 8, KT = S.F / 32, MT = S.F / 16, rows = S.ns * P.rows;
  const int lfc = __ffs(S.Fc) - 1;
  for (int u = warp; u < 2 * MT * P.nr; u += kWarps) {
    const int PI = u / (MT * P.nr), mt = u / P.nr % MT, nr = u % P.nr;
    const int p = PI ? S.p1 : S.p0, half = PI ? S.half1 : S.half0;
    const float inv_p = PI ? S.finv1 : S.finv0;
    const int8_t* y = Y + (PI * rows + min(nr * 8 + g, rows - 1)) * 2 * S.Fc;
    const uint4* wa = Wi + ((static_cast<size_t>(PI * NT + 2 * mt) * KT) * 32 + lane) * 2;
    const uint4* wb = wa + KT * 64;   // n8 tile 2 mt + 1
    int c0[4] = {}, c1[4] = {};
#pragma unroll
    for (int kt = 0; kt < kMaxKT; ++kt) {
      if (kt >= KT) continue;
      const uint4 w0a = wa[kt * 64], w1a = wa[kt * 64 + 1];
      const uint4 w0b = wb[kt * 64], w1b = wb[kt * 64 + 1];
      const uint32_t alo[4] = {w0a.x, w0b.x, w0a.y, w0b.y}, ahi[4] = {w0a.z, w0b.z, w0a.w, w0b.w};
      const uint32_t vlo[4] = {w1a.x, w1b.x, w1a.y, w1b.y}, vhi[4] = {w1a.z, w1b.z, w1a.w, w1b.w};
      const int f0 = kt * 32 + 4 * tig, f1 = f0 + 16;
      const int8_t* y0 = y + (f0 >> lfc) * P.share + (f0 & (S.Fc - 1));
      const int8_t* y1 = y + (f1 >> lfc) * P.share + (f1 & (S.Fc - 1));
      const uint32_t b0 = lds32(y0), b1 = lds32(y1);
      const uint32_t h0 = lds32(y0 + S.Fc), h1 = lds32(y1 + S.Fc);
      mma_k32(c0, alo, b0, b1);
      mma_k32(c0, vlo, h0, h1);
      mma_k32(c1, ahi, b0, b1);
      mma_k32(c1, vhi, h0, h1);
    }
#pragma unroll
    for (int r4 = 0; r4 < 4; ++r4) {
      const int t = mt * 16 + g + 8 * (r4 >> 1), row = nr * 8 + 2 * tig + (r4 & 1);
      res[(PI * 8 * P.nr + row) * S.F + t] =
          static_cast<int16_t>(reduce32(c0[r4] + c1[r4] * 256, p, half, inv_p));
    }
  }
}

// The CRT of the two primes' residues and the key-limb sum into the block's
// slice: own[s][pair][t] += sum_limb V(s, limb P + pair, t) << (kbits limb).
__device__ __forceinline__ void update_narrow(const Shape& S, const Narrow& P, const int16_t* res,
                                              uint32_t* own, int nvalid, int tid) {
  const int F = S.F, prime1 = 8 * P.nr * F;
  for (int x = tid; x < nvalid * P.pairs * F; x += kThreads) {
    const int sp = x / F, t = x - sp * F, s = sp / P.pairs, pair = sp - s * P.pairs;
    uint32_t upd = 0;
    for (int limb = 0; limb < S.L; ++limb) {
      const int at = (s * P.rows + limb * P.pairs + pair) * F + t;
      const int v0 = res[at], v1 = res[prime1 + at];
      const int q = reduce32((v1 - v0) * S.crt_inv, S.p1, S.half1, S.finv1);
      upd += static_cast<uint32_t>(v0 + q * S.p0) << (S.kbits * limb);   // |V| < p0 p1 / 2
    }
    own[x] += upd;
  }
}

// Pushes the block's slice of the accumulator, every sample, into accf of
// every block of the cluster, itself included, at the owner's place in the
// r-major layout: one bulk copy a block and sample (P pairs F words), each
// completing on that block's "acc" mbarrier, issued by lane 0 of the warps in
// turn (the copies of one warp's lanes issue one after another). After
// fence_async and a barrier past the slice's last generic write.
__device__ __forceinline__ void push_acc(const Shape& S, const Narrow& P, const uint32_t* own,
                                         uint32_t* accf, uint64_t* acc_bar, int rank, int warp,
                                         int lane) {
  if (lane != 0) return;
  const int words = P.pairs * S.F;
  for (int j = warp; j < S.C * S.ns; j += kWarps) {
    const int to = j % S.C, s = j / S.C;
    bulk_push(accf + static_cast<size_t>(s * S.UR + rank * P.pairs) * S.F, own + s * words,
              4 * words, acc_bar, to);
  }
}

// The narrow tier (see above): cluster blockIdx.x / C holds samples b0 .. b0
// + ns - 1, block `rank` of it their frequencies [rank Fc, (rank + 1) Fc)
// and their pairs (u, r) rank P .. rank P + P - 1.
template <class Key, int DL>
__global__ void __launch_bounds__(kThreads, 1) rotate_kernel_narrow(
    const int32_t* __restrict__ acc0, const int32_t* __restrict__ bara,
    const typename Key::Elem* __restrict__ key, const uint4* __restrict__ Wf,
    const uint4* __restrict__ Wi, int32_t* __restrict__ out, const Shape S, const Narrow P) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  const int ns = S.ns, F = S.F, UN = S.U * S.N;
  const int b0 = (blockIdx.x / S.C) * ns, nvalid = min(ns, S.B - b0);
  int8_t* keys = reinterpret_cast<int8_t*>(smem);
  uint32_t* accf = reinterpret_cast<uint32_t*>(smem + P.accf);
  int8_t* dig = reinterpret_cast<int8_t*>(smem + P.dig);
  uint32_t* own = reinterpret_cast<uint32_t*>(smem + P.own);
  int8_t* X = reinterpret_cast<int8_t*>(smem + P.x);
  int8_t* Z = reinterpret_cast<int8_t*>(smem + P.dig);   // the digits are dead by then
  int16_t* res = reinterpret_cast<int16_t*>(smem + P.dig + P.chat_tx);
  int8_t* Y = reinterpret_cast<int8_t*>(smem + P.y);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + P.bar);
  uint64_t* acc_bar = bar + P.slots;         // the accumulator has arrived
  uint64_t* chat_bar = bar + P.slots + 1;    // chat of this block's rows has arrived
  int* a_s = reinterpret_cast<int*>(bar + P.slots + 2);   // [2][kMaxSamples]
  const int ahead = P.slots / 2;   // steps whose key shares are in flight
  const int own_n = ns * P.pairs * F;   // the slice: pairs (u, r) = rank P + pair

  // own[s][pair][t] = acc[b0 + s][u][t R + r]
  for (int x = tid; x < own_n; x += kThreads) {
    const int sp = x / F, s = sp / P.pairs, ur = rank * P.pairs + sp - s * P.pairs;
    own[x] = s < nvalid ? static_cast<uint32_t>(acc0[static_cast<size_t>(b0 + s) * UN +
                                                     (ur >> S.log_r) * S.N +
                                                     ((x - sp * F) << S.log_r) + (ur & (S.R - 1))])
                        : 0u;
  }
  if (tid < nvalid) a_s[tid] = __ldg(bara + b0 + tid);
  const uint4* wi = Wi;
  if (P.wi >= 0) {   // both primes' Winv fragments, 4 F^2 bytes each
    uint4* staged = reinterpret_cast<uint4*>(smem + P.wi);
    for (int x = tid; x < F * F / 2; x += kThreads) staged[x] = __ldg(Wi + x);
    wi = staged;
  }
  if (tid == 0) {
    for (int k = 0; k < P.slots + 2; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(bar + k)) : "memory");
    if (S.n > 0) {   // step 0's phases
      bar_expect(acc_bar, P.acc_tx);
      bar_expect(chat_bar, P.chat_tx);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < ahead && i < S.n; ++i)
      narrow_key_load(S, P, key, keys, bar, i, 2 * i, rank);
  }
  fence_async();
  cluster.sync();   // every block's mbarriers are initialised, and every slice loaded
  if (S.n > 0) push_acc(S, P, own, accf, acc_bar, rank, warp, lane);
#ifdef CRT_MMA_PROFILE
  long long t0 = clock64();
#endif

  for (int i = 0; i < S.n; ++i) {
    uint4 w[kMaxKT][DL];
    load_w_narrow<DL>(S, Wf, w, rank, warp, lane);
    // bara of the next step, stored at the end of this one
    const int a_next =
        tid < nvalid && i + 1 < S.n ? __ldg(bara + static_cast<size_t>(i + 1) * S.B + b0 + tid) : 0;
    bar_wait(acc_bar, i & 1);   // every owner's slice of the last update is in accf
    if (tid == 0 && i + 1 < S.n) bar_expect(acc_bar, P.acc_tx);
    CRT_MMA_PHASE(0);
    digits_narrow<DL>(S, accf, a_s + (i & 1) * kMaxSamples, nvalid, dig, tid);
    // the padding rows K <= k < Kp of dig read as zero (z and res wrote over them)
    const int pad = S.Kp - S.K, w16 = S.DS / 16;
    for (int x = tid; x < DL * ns * pad * w16; x += kThreads) {
      const int row = x / w16, q = row / (ns * pad), sr = row - q * ns * pad;
      const int s = sr / pad, k = S.K + sr - s * pad;
      *reinterpret_cast<uint4*>(dig + q * S.dig_plane + (s * S.Kp + k) * S.DS +
                                16 * (x - row * w16)) = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    CRT_MMA_PHASE(1);
    forward_narrow<DL>(S, dig, X, w, nvalid, warp, lane);
    const int slot = (i % ahead) * 2, parity = (i / ahead) & 1;
    bar_wait(bar + slot, parity);
    bar_wait(bar + slot + 1, parity);
    __syncthreads();
    CRT_MMA_PHASE(2);
    pointwise_narrow(S, P, keys + static_cast<size_t>(slot) * P.key_bytes, X, Z, warp, lane);
    fence_async();
    __syncthreads();   // chat is staged, and the key slots are read
    if (tid == kThreads - 32 && i + ahead < S.n)   // lane 0 of the last warp
      narrow_key_load(S, P, key, keys, bar, i + ahead, slot, rank);
    if (lane == 0 && warp < S.C)   // to owner `warp` (C <= kWarps)
      bulk_push(Y + rank * P.share, Z + warp * P.share, P.share, chat_bar, warp);
    CRT_MMA_PHASE(3);
    bar_wait(chat_bar, i & 1);   // every block's chat of this block's rows is in Y
    if (tid == 0 && i + 1 < S.n) bar_expect(chat_bar, P.chat_tx);
    CRT_MMA_PHASE(4);
    inverse_narrow(S, P, Y, wi, res, warp, lane);
    __syncthreads();
    CRT_MMA_PHASE(5);
    update_narrow(S, P, res, own, nvalid, tid);
    if (tid < nvalid && i + 1 < S.n) a_s[((i + 1) & 1) * kMaxSamples + tid] = a_next;
    CRT_MMA_PHASE(6);
    if (i + 1 < S.n) {
      fence_async();
      __syncthreads();   // the slice holds this step's update
      push_acc(S, P, own, accf, acc_bar, rank, warp, lane);
    }
    CRT_MMA_PHASE(7);
  }
  cluster.sync();   // no copy reads or writes any block's shared memory any more
  for (int x = tid; x < nvalid * P.pairs * F; x += kThreads) {
    const int sp = x / F, s = sp / P.pairs, ur = rank * P.pairs + sp - s * P.pairs;
    out[static_cast<size_t>(b0 + s) * UN + (ur >> S.log_r) * S.N + ((x - sp * F) << S.log_r) +
        (ur & (S.R - 1))] = static_cast<int32_t>(own[x]);
  }
}

// The narrow tier's layout for `ns` samples a cluster of C blocks, `slots`
// key slots and Winv staged or not (`wi`); sets S's fields of that plan and
// returns the shared memory (ops/blind_rotate.narrow_smem_bytes).
inline size_t plan_narrow(Shape& S, Narrow& P, int DL, int ns, int C, int slots, bool wi) {
  S.ns = ns;
  S.C = C;
  S.Fc = S.F / C;
  S.dig_plane = ns * S.Kp * S.DS;
  S.xs = 2 * ns * S.Kp + 16;
  P.slots = slots;
  P.key_bytes = S.Fc * (S.Mp / 16) * (S.Kp / 16) * 512;
  P.pairs = S.UR / C;
  P.rows = S.L * P.pairs;
  P.nr = (ns * P.rows + 7) / 8;
  P.share = 2 * ns * P.rows * 2 * S.Fc;
  P.acc_tx = ns * S.U * S.N * 4;
  P.chat_tx = C * P.share;
  const int dig = DL * S.dig_plane, zres = P.chat_tx + 2 * 8 * P.nr * S.F * 2;
  P.accf = slots * P.key_bytes;
  P.dig = P.accf + P.acc_tx;
  P.own = P.dig + (dig > zres ? dig : zres);
  P.x = P.own + ns * P.pairs * S.F * 4;
  P.y = P.x + 2 * S.Fc * S.xs;
  P.bar = P.y + P.chat_tx;
  const int end = P.bar + 8 * (slots + 2) + 8 * kMaxSamples;
  P.wi = wi ? end : -1;
  P.smem = end + (wi ? 8 * S.F * S.F : 0);
  return static_cast<size_t>(P.smem);
}

// Clusters of C blocks of the narrow tier at `smem` bytes that the card
// holds at once (cudaOccupancyMaxActiveClusters).
template <class Key, int DL>
int narrow_clusters_dl(int C, size_t smem, int* clusters) {
  auto kernel = rotate_kernel_narrow<Key, DL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

// The same, asked of the card once for each (device, DL, C, smem).
template <class Key>
int narrow_clusters(int DL, int C, size_t smem, int* clusters) {
  static std::mutex mu;
  static std::vector<std::array<long long, 5>> asked;   // device, DL, C, smem, clusters
  int device = 0;
  const cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const std::array<long long, 4> at = {device, DL, C, static_cast<long long>(smem)};
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& q : asked)
    if (q[0] == at[0] && q[1] == at[1] && q[2] == at[2] && q[3] == at[3]) {
      *clusters = static_cast<int>(q[4]);
      return 0;
    }
  const int err = DL == 1 ? narrow_clusters_dl<Key, 1>(C, smem, clusters)
                          : narrow_clusters_dl<Key, 2>(C, smem, clusters);
  if (err == 0) asked.push_back({at[0], at[1], at[2], at[3], *clusters});
  return err;
}

// The narrow tier's plan for S.B samples (ops/blind_rotate.narrow_plan): C
// the largest of 16, 8, 4, 2 (F/C a multiple of 8, C dividing U R) for
// which some ns of 1, 2, 4, 8 (the fewest first, so that the most clusters
// run side by side; at most the power of two that holds B) gives G =
// ceil(B/ns) groups with G C <= SMs, blocks that fit shared memory with two
// slots (more samples need more: the next C then), and G clusters that the
// card holds at once; then the first that fits of four slots and Winv
// staged, two slots and Winv, four slots, two. Sets S and P and returns
// true where it is taken; `err` carries a failed query.
template <class Key>
bool plan_narrow_tier(Shape& S, Narrow& P, int DL, int sms, size_t optin, int& err) {
  int top = 1;
  while (top < S.B && top < kMaxSamples) top *= 2;
  for (int C = 16; C >= 2; C /= 2) {
    if (S.F % (8 * C) != 0 || S.UR % C != 0) continue;
    for (int ns = 1; ns <= top; ns *= 2) {
      const int G = (S.B + ns - 1) / ns;
      if (static_cast<long long>(G) * C > sms) continue;
      const size_t smem = plan_narrow(S, P, DL, ns, C, 2, false);
      if (smem > optin) break;
      int clusters = 0;
      err = narrow_clusters<Key>(DL, C, smem, &clusters);
      if (err != 0) return false;
      if (clusters < G) continue;
      for (int k = 0; k < 4; ++k)
        if (plan_narrow(S, P, DL, ns, C, k % 2 ? 2 : 4, k < 2) <= optin) return true;
    }
  }
  return false;
}

// Shared memory of a block of `ns` samples (S.DS, Kp, Mp, F set): dig and
// chat in one buffer, dhat, and Key::kStageBytes per warp. Sets the layout
// fields of S that depend on ns. (ops/blind_rotate.crt_mma_smem_bytes.)
template <class Key>
size_t plan_samples(Shape& S, int DL, int ns) {
  S.ns = ns;
  S.C = 1;
  S.Fc = S.F;
  S.DSc = S.DS;
  S.dig_plane = ns * S.Kp * S.DS;
  S.y_plane = ns * S.Mp * S.DS;
  const int buf1 = DL * S.dig_plane > 2 * S.y_plane ? DL * S.dig_plane : 2 * S.y_plane;
  S.buf2 = (buf1 + 15) / 16 * 16;
  S.xs = 2 * ns * S.Kp + 16;
  S.stage = S.buf2 + S.F * S.xs;
  return static_cast<size_t>(S.stage) + static_cast<size_t>(kWarps) * Key::kStageBytes;
}

// Shared memory of a block of a cluster of C blocks holding `ns` samples:
// the whole samples' digits and, in the same buffer, chat of the block's Fc
// = F/C frequencies, then dhat of those frequencies and the staging tiles
// (ops/blind_rotate.crt_mma_smem_bytes with cluster = C). Sets S's layout.
template <class Key>
size_t plan_cluster(Shape& S, int DL, int C, int ns) {
  S.ns = ns;
  S.C = C;
  S.Fc = S.F / C;
  S.DSc = S.Fc + 16;
  S.dig_plane = ns * S.Kp * S.DS;
  S.y_plane = ns * S.Mp * S.DSc;
  const int buf1 = DL * S.dig_plane > 2 * S.y_plane ? DL * S.dig_plane : 2 * S.y_plane;
  S.buf2 = (buf1 + 15) / 16 * 16;
  S.xs = 2 * ns * S.Kp + 16;
  S.stage = S.buf2 + S.Fc * S.xs;
  return static_cast<size_t>(S.stage) + static_cast<size_t>(kWarps) * Key::kStageBytes;
}

// Shared memory of a block of the stream tier in a cluster of C blocks: chat
// of its Fc = F/C frequencies, dhat of fs of them, `slabs` digit slabs and the
// staging tiles, at the first fit below `optin` of fs = 128, 64, .., 8 (at
// most F/C, and at most kStreamTiles forward tiles a warp) and two slabs,
// then one; SIZE_MAX if none fits (ops/blind_rotate.crt_mma_smem_bytes with
// stream = (fs, slabs)). The scratch keeps the cluster layout's digit part,
// Kp (FP + 16) DL bytes a block, of which the first block's holds the
// cluster's slabs. Sets S's layout.
template <class Key>
size_t plan_stream(Shape& S, int DL, int C, size_t optin) {
  S.ns = 1;
  S.C = C;
  S.Fc = S.F / C;
  S.DSc = S.Fc + 16;
  S.dig_plane = S.Kp * S.DS;
  S.y_plane = S.Mp * S.DSc;
  S.buf2 = (2 * S.y_plane + 15) / 16 * 16;
  S.xs = 2 * S.Kp + 16;
  for (int fs = 128; fs >= 8; fs /= 2) {
    if (fs > S.Fc || (S.Kp / 16) * (fs / 8) > kWarps * kStreamTiles) continue;
    for (int slabs = 2; slabs >= 1; --slabs) {
      S.fs = fs;
      S.slabs = slabs;
      S.slab = S.buf2 + fs * S.xs;
      S.stage = S.slab + slabs * DL * S.Kp * 32;
      const size_t smem = static_cast<size_t>(S.stage) + static_cast<size_t>(kWarps) *
                                                            Key::kStageBytes;
      if (smem <= optin) return smem;
    }
  }
  return SIZE_MAX;
}

// Launches the narrow tier's plan (S, P) on `stream`: a grid of ceil(B/ns)
// clusters of C blocks.
template <class Key, int DL>
int launch_narrow(const Shape& S, const Narrow& P, const void* acc0, const void* bara,
                  const void* key, const void* Wf, const void* Wi, void* out, void* stream) {
  auto kernel = rotate_kernel_narrow<Key, DL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((S.B + S.ns - 1) / S.ns * S.C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = P.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const int32_t*>(acc0),
                           static_cast<const int32_t*>(bara),
                           static_cast<const typename Key::Elem*>(key),
                           static_cast<const uint4*>(Wf), static_cast<const uint4*>(Wi),
                           static_cast<int32_t*>(out), S, P);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// Checks the shape and the stated bounds, sizes shared memory and launches
// rotate_kernel<Key, ...> on `stream`. rb: the key's rounding bits (0 for
// the exact plan; the L limbs of kbits bits cover 32 - rb bits once).
// acc0, out: (B, U, N) int32; bara:
// (n, B) int32 in [0, 2N); key: the NTT-domain key as Key reads it; Wf, Wi:
// (2, FP/8, FP/32, 32, 4, 8) int8 B fragments of W [t][f] and Winv [f][t]
// (ntt.NttContext.W_mma / Winv_mma); scratch: scratch_bytes of device
// memory, 16-byte aligned, at least ceil(B/ns) * C * (2*ns*Mp*Fr + DL*ns*Kp*(FP+16))
// rounded up per part to 16 bytes, ns the samples a block or cluster (8, or
// 4, 2 or 1 where 8 do not fit in shared memory), C the blocks a cluster (1
// without one), Fr = F/C (8 at F = 4); none for the narrow tier (a key
// with Key::kNarrow, K1), which a batch whose groups leave most SMs idle
// takes (plan_narrow_tier). Returns a cudaError_t (0 on success);
// allocates nothing and does not sync. The Python wrappers refuse the same
// shapes first, by name (ops/blind_rotate.check_crt_mma_domain), and size
// the scratch by the same plan (ops/blind_rotate.crt_mma_plan).
template <class Key>
int launch(const void* acc0, const void* bara, const void* key, const void* Wf,
           const void* Wi, void* scratch, long long scratch_bytes, void* out, int B, int n,
           int U, int N, int R, int l, int Bgbit, int L, int kbits, int rb, int p0, int p1,
           int crt_inv, void* stream) {
  Shape S;
  S.B = B; S.n = n; S.U = U; S.N = N; S.R = R; S.F = R > 0 ? N / R : 0; S.l = l; S.rb = rb;
  S.FP = S.F > 32 ? S.F : 32;
  S.J = U * l; S.K = S.J * R; S.L = L; S.M = L * U * R; S.Bgbit = Bgbit; S.kbits = kbits;
  S.Kp = (S.K + 15) / 16 * 16; S.Mp = (S.M + 15) / 16 * 16; S.UR = U * R;
  S.crt_inv = crt_inv; S.p0 = p0; S.p1 = p1;
  S.half0 = (p0 - 1) / 2; S.half1 = (p1 - 1) / 2;
  S.finv0 = 1.0f / p0; S.finv1 = 1.0f / p1;
  S.log_n = 0;
  while ((1 << S.log_n) < N) ++S.log_n;
  S.log_r = 0;
  while ((1 << S.log_r) < R) ++S.log_r;
  auto bal16 = [](int p) { const int r = 65536 % p; return r > p / 2 ? r - p : r; };
  S.c16_0 = bal16(p0); S.c16_1 = bal16(p1);
  S.fs = S.slabs = S.slab = 0;
  if (B <= 0 || n < 0 || U <= 0 || l <= 0 || Bgbit <= 0 || Bgbit > 15 || l * Bgbit > 32 ||
      R <= 0 || N % R != 0 || (N & (N - 1)) != 0 || (R & (R - 1)) != 0 ||
      (S.F % 8 != 0 && S.F != 4) || S.FP % 32 != 0 || S.F > kMaxCluster * kMaxClusterF ||
      rb < 0 || rb >= 32 ||
      L * kbits < 32 - rb || kbits * (L - 1) >= 32 - rb ||
      p0 < 1024 || p1 < 1024 || (p0 & 1) == 0 || (p1 & 1) == 0)   // reduce32: |z/p| < 2^22
    return static_cast<int>(cudaErrorInvalidValue);
  S.halfBg = 1 << (Bgbit - 1);
  S.mask = (1u << Bgbit) - 1u;
  S.offset = 0;
  for (int p = 0; p < l; ++p)
    S.offset += static_cast<uint32_t>(S.halfBg) << (32 - (p + 1) * Bgbit);
  const int DL = S.halfBg <= 128 ? 1 : 2;
  const long long dhi = DL == 1 ? 0 : (S.halfBg + 255) / 256;
  S.DS = S.FP + 16;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The shipped instantiations where they apply (F <= 128, Kp <= 64, 8
  // samples fitting), else the general one at the most samples that fit;
  // where one sample does not fit a block (or F > 512), the cluster one at
  // the fewest blocks a cluster that hold one sample, and the most samples
  // that fit at that size; where no cluster holds one sample, the stream
  // tier at the fewest blocks a cluster whose share fits.
  const int fw = S.FP <= 128 ? 1 : S.FP <= 256 ? 2 : 4;
  const bool wide = fw > 1;
  size_t smem = plan_samples<Key>(S, DL, kMaxSamples);
  const bool general = wide || S.Kp > 64 || rb > 0 || S.F < 8 || smem > static_cast<size_t>(optin);
  for (int ns = kMaxSamples / 2; general && ns >= 1 && smem > static_cast<size_t>(optin); ns /= 2)
    smem = plan_samples<Key>(S, DL, ns);
  const bool clustered = S.F > kMaxClusterF || smem > static_cast<size_t>(optin);
  bool streamed = false;
  if (clustered) {
    auto splits = [&](int C) { return S.F % (32 * C) == 0 && S.F / C <= kMaxClusterF; };
    int C = 2;
    while (C <= kMaxCluster &&
           (!splits(C) || plan_cluster<Key>(S, DL, C, 1) > static_cast<size_t>(optin)))
      C *= 2;
    if (C <= kMaxCluster) {
      int ns = kMaxSamples;
      while (ns > 1 && plan_cluster<Key>(S, DL, C, ns) > static_cast<size_t>(optin)) ns /= 2;
      smem = plan_cluster<Key>(S, DL, C, ns);
    } else {
      for (C = 2; C <= kMaxCluster; C *= 2)
        if (splits(C) && plan_stream<Key>(S, DL, C, optin) <= static_cast<size_t>(optin)) break;
      if (C > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
      smem = plan_stream<Key>(S, DL, C, optin);
      streamed = true;
    }
  }
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  // Residues split into bytes with |hi| <= 127; the forward, pointwise and
  // inverse int32 sums stay below 2^31 (see the note at the head of this
  // file); the CRT product (v1 - v0) * crt_inv and V = v0 + q p0 fit int32.
  const int hmax = S.half0 > S.half1 ? S.half0 : S.half1;
  const long long c16 = abs(S.c16_0) > abs(S.c16_1) ? abs(S.c16_0) : abs(S.c16_1);
  const long long c16_half = abs(S.c16_0) * static_cast<long long>(S.half0) >
                                     abs(S.c16_1) * static_cast<long long>(S.half1)
                                 ? abs(S.c16_0) * static_cast<long long>(S.half0)
                                 : abs(S.c16_1) * static_cast<long long>(S.half1);
  // The general instantiation reduces C2 always and C1 at Kp > 128 in the
  // pointwise sum, C1 at F = 512 in the forward and at F >= 256 in the
  // inverse; the cluster one reduces C1 in the forward and the inverse always.
  const long long pointwise_sum =
      general && S.Kp > 128 ? static_cast<long long>(S.Kp) * 128 * 128 + 256LL * hmax + c16_half
      : Key::kReduceC2 || general
          ? static_cast<long long>(S.Kp) * 128 * 128 * (1 + 2 * 256) + c16_half
          : static_cast<long long>(S.Kp) * 128 * 128 * (1 + 2 * 256 + c16);
  const long long forward_sum = fw > 2 || clustered ? S.FP * 128LL * (128 + dhi) + 256LL * hmax
                                                    : 257LL * S.FP * 128 * (128 + dhi);
  const long long inverse_sum = wide || clustered ? S.FP * 2LL * 128 * 128 + 256LL * hmax
                                                  : 257LL * S.FP * 2 * 128 * 128;
  if (hmax > 127 * 256 + 127 || dhi > 127 || pointwise_sum >= (1LL << 31) ||
      forward_sum >= (1LL << 31) || inverse_sum >= (1LL << 31) ||
      static_cast<long long>(S.half0 + S.half1) * abs(crt_inv) >= (1LL << 31) ||
      static_cast<long long>(S.half1) * p0 + S.half0 >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (Key::kNarrow) {
    int sms = 0;
    if (!general && S.F >= 32) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return static_cast<int>(err);
      Shape T = S;
      Narrow P;
      int qerr = 0;
      if (plan_narrow_tier<Key>(T, P, DL, sms, static_cast<size_t>(optin), qerr))
        return DL == 1 ? launch_narrow<Key, 1>(T, P, acc0, bara, key, Wf, Wi, out, stream)
                       : launch_narrow<Key, 2>(T, P, acc0, bara, key, Wf, Wi, out, stream);
      if (qerr != 0) return qerr;
    }
  }
  const int grid = (B + S.ns - 1) / S.ns * S.C;
  S.res0_16 = (S.ns * S.Mp * (S.Fc > 8 ? S.Fc : 8) * 2 + 15) / 16;
  S.dig16 = (DL * S.dig_plane + 15) / 16;
  S.scratch16 = S.res0_16 + S.dig16;
  if (scratch_bytes < static_cast<long long>(grid) * S.scratch16 * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto args = [&](auto kernel) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return;
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(acc0), static_cast<const int32_t*>(bara),
        static_cast<const typename Key::Elem*>(key), static_cast<const uint4*>(Wf),
        static_cast<const uint4*>(Wi), static_cast<uint4*>(scratch),
        static_cast<int32_t*>(out), S);
    err = cudaGetLastError();
  };
  // Compile-time tile counts of the shipped instantiations: (MTK, MTM) =
  // (3, 3), (3, 4) or (4, 4) on the register path (U*R = 16, Mp <= 64), (4,
  // 0) on the scatter path; the general one is (16, 0) at kS = 0, per F/128.
  const bool reg = S.UR == 16 && S.Mp <= 64;
  if (clustered) {
    auto kernel = streamed ? (DL == 1 ? rotate_kernel_stream<Key, 1> : rotate_kernel_stream<Key, 2>)
                         : (DL == 1 ? rotate_kernel_cluster<Key, 1> : rotate_kernel_cluster<Key, 2>);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;   // a cluster of C blocks at this shared memory must fit the card
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const int32_t*>(acc0),
                             static_cast<const int32_t*>(bara),
                             static_cast<const typename Key::Elem*>(key),
                             static_cast<const uint4*>(Wf), static_cast<const uint4*>(Wi),
                             static_cast<uint4*>(scratch), static_cast<int32_t*>(out), S);
    if (err == cudaSuccess) err = cudaGetLastError();
  } else if (general && S.F < 8) {
    if (DL == 1) args(rotate_kernel<Key, 1, 16, 0, 0, 1, true>);
    else args(rotate_kernel<Key, 2, 16, 0, 0, 1, true>);
  } else if (general) {
    if (fw == 4) {
      if (DL == 1) args(rotate_kernel<Key, 1, 16, 0, 0, 4>);
      else args(rotate_kernel<Key, 2, 16, 0, 0, 4>);
    } else if (fw == 2) {
      if (DL == 1) args(rotate_kernel<Key, 1, 16, 0, 0, 2>);
      else args(rotate_kernel<Key, 2, 16, 0, 0, 2>);
    } else {
      if (DL == 1) args(rotate_kernel<Key, 1, 16, 0, 0, 1>);
      else args(rotate_kernel<Key, 2, 16, 0, 0, 1>);
    }
  } else if (reg && S.Kp <= 48 && S.Mp <= 48) {
    if (DL == 1) args(rotate_kernel<Key, 1, 3, 3, 8, 1>);
    else args(rotate_kernel<Key, 2, 3, 3, 8, 1>);
  } else if (reg && S.Kp <= 48) {
    if (DL == 1) args(rotate_kernel<Key, 1, 3, 4, 8, 1>);
    else args(rotate_kernel<Key, 2, 3, 4, 8, 1>);
  } else if (reg) {
    if (DL == 1) args(rotate_kernel<Key, 1, 4, 4, 8, 1>);
    else args(rotate_kernel<Key, 2, 4, 4, 8, 1>);
  } else {
    if (DL == 1) args(rotate_kernel<Key, 1, 4, 0, 8, 1>);
    else args(rotate_kernel<Key, 2, 4, 0, 8, 1>);
  }
  return static_cast<int>(err);
}

}  // namespace crt_mma
