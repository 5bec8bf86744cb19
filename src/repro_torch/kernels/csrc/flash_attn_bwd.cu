// flash_attention backward for Hopper (sm_90a): dQ, dK, dV of the forward in
// flash_attn.cu, in the model layout (B, S, H, hd), grouped-query heads, on
// the tensor cores (wgmma), fed by a TMA ring, deterministic (no atomics).
//
// No TPU kernel is replaced: src/repro/kernels/flash_attn.py is forward only,
// and the reference differentiates its oracle, online_attention
// (src/repro/models/common.py:154), with XLA's autodiff.  This computes the
// same gradient of the same masked softmax attention:
//
//   P[i, j]  = exp(s[i, j] - lse[i]),  s = scale q_i . k_j, 0 where masked
//   dV[j]   += sum_i P[i, j] dO[i]
//   dP[i, j] = dO[i] . v_j
//   dS[i, j] = P[i, j] (dP[i, j] - D[i]),  D[i] = dO[i] . O[i]
//   dQ[i]    = scale sum_j dS[i, j] k_j
//   dK[j]   += scale sum_i dS[i, j] q_i
//
// with lse the forward's per-row log-sum-exp, which the forward writes when
// it is given an lse buffer: in log2 units (m + log2 max(l, 1e-30), m and l
// the running max and sum of the base-2 scores), so P = exp2(s log2(e) -
// lse).  Masked pairs, queries at or past Sq and keys at or past Sk get
// P = 0 exactly, so they add exactly 0 to every sum.
//
// Three kernels, launched in order on one stream:
//  1. dot: D = rowsum(dO o O) in f32, one warp a (b, i, h) row;
//  2. dkdv: one block per (64 keys, KV head, batch), low key tiles (the
//     most query rows under a causal mask) first.  K and V stay in shared
//     memory; the block walks the q_per_kv query heads of its KV head and,
//     for each, the query tiles that see its keys, computes S^T = K Q^T and
//     dP^T = V dO^T, then P^T and dS^T in registers, and accumulates
//     dV += P^T dO and dK += dS^T Q in registers (64 keys x hd each): the
//     GQA sum runs inside the block, in a fixed order;
//  3. dq: one block per (64 query rows, head, batch), heaviest first.  Q and
//     dO stay in shared memory; the block walks the key tiles its rows see,
//     computes S = Q K^T, dP = dO V^T, P, dS, and accumulates dQ += dS K.
// Both are one template: the resident pair (A1, A2) = (K, V) or (Q, dO),
// the streamed pair (B1, B2) = (Q, dO) or (K, V); S = A1 B1^T, dP = A2 B2^T,
// acc2 += dS B1 (dK or dQ) and, in dkdv, acc1 += P B2 (dV).  dQ is not
// summed across the key blocks of kernel 2 (that would need float atomics,
// whose order changes from run to run), so S and dP are computed twice.
// Every output element is one block's sum in one fixed order, so the bits
// repeat from call to call.
//
// What bounds it.  At the 4096-token causal shape of qwen3-1.7b (H = 16,
// Hkv = 8, hd = 128) one product over the causal pairs is 34.36 GFLOP; the
// five the gradient needs, 171.8 GFLOP, take 1.041 ms as 3xTF32 at the H100
// SXM's 495 TFLOP/s and 0.174 ms in bf16 at 989 TFLOP/s.  This does 7
// products in bf16 (0.243 ms of work) and 8 in f32, where dkdv computes S^T
// twice (below; 3xTF32 1.666 ms of work).  Every product runs on the tensor
// cores:
//  - f32 as 3xTF32, as in the forward: a = hi + lo, hi = tf32(a), lo =
//    tf32(a - hi), and a product is hi.hi + hi.lo + lo.hi summed in f32
//    (about 1e-6 relative);
//  - bf16 in one pass with f32 sums; P^T and dS^T (dS) are rounded to bf16
//    as the A operand of the second pair of products.
//
// The design.  Roles by warpgroup: the consumers, then for f32 a splitter
// whose first warp is also the producer, for bf16 a producer warp.  One
// consumer warpgroup, except f32 dkdv: there dK and dV (hd f32 registers a
// thread each) do not fit one warpgroup's registers at hd 128 beside the
// score tiles and fragments, so a dV warpgroup computes S^T, P^T and dV,
// and a dK warpgroup S^T, dP^T, dS^T and dK (S^T twice).  Threads: f32 dkdv
// 384 (setmaxnreg hands the consumers 200 registers a thread and leaves
// the splitter 104), f32 dq 256, bf16 160.  A separate producer warpgroup
// (512 threads, 128 registers a thread at launch) made ptxas wait for every
// wgmma before the next.
//  - the producer loads the two resident tiles once (TMA, "res" barrier)
//    and then the streamed tiles (rank-4 tensor maps over (hd, S, heads, B)
//    built on the host from the strides: strided q, k, v and the KV head
//    h / q_per_kv are read in place; rows past the end arrive as zeros) into
//    a ring of STAGES stages, each signalled by a "full" mbarrier (the TMA
//    bytes and one arrival of each of the warp's 32 lanes) and released by
//    an "empty" one (f32: tile i + STAGES - 1 is loaded as the split of tile
//    i begins).  In dkdv the lanes also copy the tile's lse and D (zeros
//    past Sq) beside the stage.  Tiles that the mask empties for the whole
//    block are never loaded.
//  - TF32 wgmma takes K-major operands only, and the two pairs of products
//    sum over different indices: S and dP over hd, the accumulations over
//    the streamed rows.  So f32 needs each streamed tile in both
//    orientations.  The splitter warpgroup, for each tile: splits B1 and B2
//    into hi (in place, in the ring stage) and lo (the "lo" set), and
//    signals "lo ready"; then transposes B1 (dkdv: B2 too) hi and lo into
//    the "T" set (hd rows x 32 streamed rows, 128-byte swizzled rows), the
//    rows of every group of 8 stored in the order 0 2 4 6 1 3 5 7: the
//    order in which the accumulator layout hands P's and dS's columns to the
//    A operand's k slots, so they need no shuffle (the forward's V^T
//    trick), and signals "T ready".  The consumers free the lo set after
//    the first pair of products and the T set after the second, so the
//    split of tile i + 1 runs while the consumers multiply tile i, and the
//    transposes of tile i while they run tile i's first pair.
//  - f32 resident tiles stay raw: the consumers load the A fragments of the
//    first pair from shared memory and split them in registers (the "rs"
//    form), FB_KG k steps at a time into one of two buffers, so at most
//    2 FB_KG x 8 fragment registers are in flight.  bf16 reads every
//    operand from shared memory where TMA wrote it: the second pair reads
//    B1 and B2 through the transpose flag of the bf16 wgmma; nothing is
//    copied.
//  - the consumers keep the score tiles (64 x 32 f32, 64 x 64 bf16) and the
//    accumulators in registers (the wgmma layout: a thread holds two rows
//    and, for each group of 8 columns, two neighbours) and feed P and dS
//    back to the tensor cores as the register A operand.  The per-element
//    mask runs only on tiles that the mask or an end cuts.
//  - f32 sums: the tensor cores' f32 accumulation drifts one way, by up to
//    an ulp an instruction; chained over the thousands of instructions of a
//    4096-token sum it took dK and dV past 1e-5 relative (H100).  So an f32
//    block chains FB_FLUSH tiles (96 instructions) in the tensor cores and
//    then adds that partial sum to the f32 output rows it owns (written by
//    the first, read and added by the next, all by the same thread, in
//    order: no new memory, the same bits every call); bf16 sums a block's
//    whole range in the tensor cores.
//  - the dK scale is applied once, to each partial sum the block adds to
//    its rows (to the one sum for bf16); dQ's likewise.
//
// Shared memory a block (FbCfg below; the barriers and 1 KB of alignment
// slack come on top; A1 / A2 resident, lo and T only for f32, a stage holds
// B1 and B2, and in dkdv the stage's lse and D):
//   f32  hd 128 dkdv: K, V 64 K + lo 32 K + T 64 K + 2 stages x 32.25 K = 224.5 K
//   f32  hd 128 dq:   Q, dO 64 K + lo 32 K + T 32 K + 3 stages x 32 K = 224 K
//   f32  hd  64: dkdv 32 + 16 + 32 + 4 x 16.25 = 145 K; dq 32 + 16 + 16 + 4 x 16 = 128 K
//   f32  hd  32: dkdv 16 + 8 + 16 + 4 x 8.25 = 73 K;   dq 16 + 8 + 8 + 4 x 8 = 64 K
//   bf16 hd 128: dkdv 32 K + 2 x 32.5 K = 97 K; dq 32 K + 2 x 32 K = 96 K
//   bf16 hd  64: dkdv 16 K + 4 x 16.5 K = 82 K; dq 16 K + 4 x 16 K = 80 K
//   bf16 hd  32: dkdv 8 K + 4 x 8.5 K = 42 K;   dq 8 K + 4 x 8 K = 40 K
// Registers (nvcc 12.9, -Xptxas -v, no spills; chip_smoke.py's build line
// reports every fb_ kernel and fails on a spill), at hd 128: f32 dkdv 168 at
// launch (200 a consumer after setmaxnreg), f32 dq 181, bf16 dkdv 250, bf16
// dq 168.
#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int FB_BM = 64;          // rows of a resident tile (one wgmma M)
constexpr int FB_KG = 2;           // f32: k steps of the resident A split at a time
constexpr int FB_FLUSH = 8;        // f32: tiles summed in the tensor cores between flushes
constexpr int FB_DOT_THREADS = 256;

template <typename T, int HD, bool KV>
struct FbCfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int ESZ = sizeof(T);
  static constexpr int BN = F32 ? 32 : 64;               // rows of a streamed tile
  // consumer warpgroups: f32 dkdv gives dV and dK one each (both accumulators
  // in one warpgroup do not fit its registers at hd 128); then for f32 a
  // splitter warpgroup whose first warp also loads the tiles, for bf16 a
  // producer warp
  static constexpr int NC = F32 && KV ? 2 : 1;
  static constexpr int THREADS = F32 ? (NC + 1) * FA_WG : FA_WG + 32;
  static constexpr int SPLITTER = NC * FA_WG;                // f32: its first thread
  // f32 dkdv registers a thread by role (setmaxnreg): the warpgroups trade
  // among the registers the block was given at launch, 168 a thread of 384
  static constexpr int CONSUMER_REGS = 200, SPLITTER_REGS = 104;
  static_assert(2 * CONSUMER_REGS + SPLITTER_REGS <= 3 * (65536 / (3 * FA_WG) / 8 * 8),
                "register budget");
  static constexpr int ROWB = HD * ESZ < 128 ? HD * ESZ : 128;  // swizzled row bytes
  static constexpr int BOXE = ROWB / ESZ;                // elements of a box row
  static constexpr int NBOX = HD * ESZ / ROWB;           // boxes across hd
  static constexpr uint32_t SWIZZLE = ROWB == 128 ? 1 : 2;  // descriptor mode
  static constexpr int KSTEPS = HD * ESZ / 32;           // wgmma k steps over hd
  static constexpr int R_BYTES = FB_BM * HD * ESZ;       // one resident tile
  static constexpr int T_BYTES = BN * HD * ESZ;          // one streamed tile
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  static constexpr int LD_BYTES = KV ? 2 * BN * 4 : 0;   // a stage's lse and D
  static constexpr int NT = KV ? 2 : 1;                  // f32: tiles transposed
  static constexpr int FIXED = 2 * R_BYTES + (F32 ? 2 * T_BYTES + 2 * NT * T_BYTES : 0);
  static constexpr int PER_STAGE = STAGE_BYTES + LD_BYTES;
  static constexpr bool TWO = FIXED + 2 * PER_STAGE <= FA_BUDGET_2;
  static constexpr int FIT = ((TWO ? FA_BUDGET_2 : FA_BUDGET_1) - FIXED) / PER_STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  // byte offsets in the (1024-aligned) shared memory
  static constexpr int OFF_LO = 2 * R_BYTES;             // f32: B1 lo, B2 lo
  static constexpr int OFF_T = OFF_LO + 2 * T_BYTES;     // f32: B1^T hi, lo (, B2^T hi, lo)
  static constexpr int OFF_RING = FIXED;
  static constexpr int OFF_LD = FIXED + STAGES * STAGE_BYTES;
  static constexpr int OFF_BAR = OFF_LD + STAGES * LD_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (2 * STAGES + 5) + 1024;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(R_BYTES % 1024 == 0 && T_BYTES % 1024 == 0, "swizzle atoms");
  static_assert(!F32 || ROWB == 128, "the f32 split assumes 128-byte rows");
};

// The f32 tile of 32 rows x HD (HD / 32 boxes of 32 rows x 128 swizzled
// bytes, as TMA wrote it) into its transpose (HD rows x 32, 128 swizzled
// bytes a row), row r of each group of 8 at column (r & 1) * 4 + (r & 7) / 2.
template <int HD>
__device__ __forceinline__ void transpose_tile(const uint8_t* src, uint8_t* dst, int tid) {
  for (int idx = tid; idx < 32 * HD / 4; idx += FA_WG) {
    const int r = idx % 32;           // row
    const int dg = idx / 32;          // columns 4 dg .. 4 dg + 3
    const float4 a = *reinterpret_cast<const float4*>(
        src + (dg / 8) * 32 * 128 + r * 128 + (((dg % 8) ^ (r % 8)) << 4));
    const int j = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * dg + e;
      *reinterpret_cast<float*>(dst + d * 128 + (((j >> 2) ^ (d & 7)) << 4) + ((j & 3) << 2)) =
          av[e];
    }
  }
}

// The tf32 A fragment of k step `kk` (hd columns 8 kk .. 8 kk + 7) of a
// resident f32 tile (64 rows, boxes of 64 rows x 128 swizzled bytes), split
// into hi and lo: slot e holds (row0 + 8 (e & 1), column 8 kk + t4 + 4 (e / 2)).
__device__ __forceinline__ void a_frag_tf32(const uint8_t* tile, int kk, int row0, int t4,
                                            uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int ch = 2 * (kk % 4);       // 16-byte chunk of columns 8 kk .. 8 kk + 3
  const uint8_t* r = tile + (kk / 4) * FB_BM * 128 + row0 * 128 + t4 * 4;
  const int sw = row0 & 7;           // row0 + 8 has the same swizzle
  float x[4];
  x[0] = *reinterpret_cast<const float*>(r + ((ch ^ sw) << 4));
  x[1] = *reinterpret_cast<const float*>(r + 8 * 128 + ((ch ^ sw) << 4));
  x[2] = *reinterpret_cast<const float*>(r + (((ch + 1) ^ sw) << 4));
  x[3] = *reinterpret_cast<const float*>(r + 8 * 128 + (((ch + 1) ^ sw) << 4));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = sm90::to_tf32(x[e]);
    lo[e] = sm90::to_tf32(x[e] - __uint_as_float(hi[e]));
  }
}

__device__ __forceinline__ bool admitted(long long kpos, long long qpos, int mask_kind,
                                         long long window) {
  if (mask_kind == FA_FULL) return true;
  if (kpos > qpos) return false;
  return mask_kind != FA_WINDOW || kpos > qpos - window;
}

// acc (64 x HD) += X Y for X, the 64 x BN score tile in registers, and Y the
// BN x HD streamed tile at `y` (f32: its transpose, hi at y and lo at
// y + T_BYTES; bf16: as TMA wrote it, read through the transpose flag).
// The caller commits and waits.
template <typename C, int HD>
__device__ __forceinline__ void mma_acc(float (&acc)[HD / 2], const float (&x)[C::BN / 2],
                                        uint32_t y) {
  if constexpr (C::F32) {
    uint32_t xh[C::BN / 8][4], xl[C::BN / 8][4];
#pragma unroll
    for (int kk = 0; kk < C::BN / 8; ++kk) {
      // A slot (row, k): k = t4 holds column 2 t4, k = t4 + 4 column 2 t4 + 1
      const float v[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1], x[4 * kk + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xh[kk][e] = sm90::to_tf32(v[e]);
        xl[kk][e] = sm90::to_tf32(v[e] - __uint_as_float(xh[kk][e]));
      }
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BN / 8; ++kk) {
      const uint64_t dh = sm90::make_desc(y + 32 * kk, 16, 1024, 1);
      const uint64_t dl = sm90::make_desc(y + C::T_BYTES + 32 * kk, 16, 1024, 1);
      mma_pv_tf32<HD>(acc, xh[kk], dh);
      mma_pv_tf32<HD>(acc, xh[kk], dl);
      mma_pv_tf32<HD>(acc, xl[kk], dh);
    }
  } else {
    uint32_t a[C::BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) {
      a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
      a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
      a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
      a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) {
      const uint64_t d = sm90::make_desc(y + kk * 16 * C::ROWB, C::BN * C::ROWB,
                                         8 * C::ROWB, C::SWIZZLE);
      mma_pv_bf16<HD>(acc, a[kk], d);
    }
  }
}

// x (64 x BN) = A B^T over hd: A the resident tile at `a` (f32: raw, split
// in registers), B the streamed tile at `b` (f32: hi, with lo at `blo`).
// f32 splits FB_KG k steps of A at a time into one of two fragment buffers
// and commits them as a wgmma group; before the next group overwrites the
// other buffer, the group that read it has completed (wait_group 1), so the
// fragments in flight hold 2 FB_KG x 8 registers a thread whatever hd is.
// The caller waits for the last group.
template <typename C>
__device__ __forceinline__ void mma_scores(float (&x)[C::BN / 2], uint32_t sbase, int a,
                                           uint32_t b, uint32_t blo, const uint8_t* smem,
                                           int row0, int t4) {
  sm90::fence_regs(x);
  if constexpr (C::F32) {
    uint32_t hi[2][FB_KG][4], lo[2][FB_KG][4];
#pragma unroll
    for (int g = 0; g < C::KSTEPS / FB_KG; ++g) {
#pragma unroll
      for (int j = 0; j < FB_KG; ++j)
        a_frag_tf32(smem + a, g * FB_KG + j, row0, t4, hi[g % 2][j], lo[g % 2][j]);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < FB_KG; ++j) {
        const int kk = g * FB_KG + j;
        const uint32_t bo = koff<128>(kk, C::BN);
        const uint64_t dh = sm90::make_desc(b + bo, 16, 1024, 1);
        const uint64_t dl = sm90::make_desc(blo + bo, 16, 1024, 1);
        sm90::wgmma_tf32_rs_n32(x, hi[g % 2][j], dh, kk > 0);
        sm90::wgmma_tf32_rs_n32(x, hi[g % 2][j], dl, 1);
        sm90::wgmma_tf32_rs_n32(x, lo[g % 2][j], dh, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
    }
  } else {
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const uint64_t da = sm90::make_desc(sbase + a + koff<C::ROWB>(kk, FB_BM), 16,
                                          8 * C::ROWB, C::SWIZZLE);
      const uint64_t db = sm90::make_desc(b + koff<C::ROWB>(kk, C::BN), 16, 8 * C::ROWB,
                                          C::SWIZZLE);
      sm90::wgmma_bf16_ss_n64(x, da, db, kk > 0);
    }
    sm90::wgmma_commit();
  }
}

// mul times row row0 + 8 v1 of a 64 x HD accumulator (this thread's two
// columns of every group of 8) into `dst`, the row's column 2 t4; f32 with
// `add` adds it to what dst holds
template <typename T, int HD>
__device__ __forceinline__ void store_row(T* dst, const float (&acc)[HD / 2], int v1,
                                          float mul, bool add) {
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    float x = acc[4 * c + 2 * v1] * mul, y = acc[4 * c + 2 * v1 + 1] * mul;
    if constexpr (std::is_same<T, float>::value) {
      if (add) {
        const float2 was = *reinterpret_cast<const float2*>(dst + 8 * c);
        x += was.x;
        y += was.y;
      }
      *reinterpret_cast<float2*>(dst + 8 * c) = make_float2(x, y);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) = __floats2bfloat162_rn(x, y);
    }
  }
}

// D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d]; dO and O contiguous
template <typename T, int HD>
__global__ void __launch_bounds__(FB_DOT_THREADS)
fb_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
              long long rows, int Sq, int H) {
  const long long row = (long long)blockIdx.x * (FB_DOT_THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* orow = o + row * HD;
  const T* grow = dout + row * HD;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) s = fmaf(cg::to_f32(grow[d]), cg::to_f32(orow[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long i = (row / H) % Sq, b = row / ((long long)H * Sq);
    dsum[(b * H + h) * Sq + i] = s;
  }
}

// Where a block's tiles are and what it has been handed: what the roles of
// fb_kernel share
struct FbBlock {
  uint8_t* smem;
  uint32_t sbase, bar_full, bar_empty, bar_res, bar_lo, bar_lo_free, bar_t, bar_t_free;
  const float* lse;
  const float* dsum;
  int Sq, Sk, H, q_per_kv, mask_kind, b;
  long long window, q_pos0;
  int rh, r0;                       // resident rows [r0, r0 + 64) of head rh
  int st_begin, per_head, n_tiles;  // streamed tiles: per_head of each head visited
  // tile i: its first streamed row and its head
  __device__ int s_row0(int i, bool kv, int bn) const {
    return (st_begin + (kv ? i % per_head : i)) * bn;
  }
  __device__ int s_head(int i, bool kv) const {
    return kv ? rh * q_per_kv + i / per_head : rh / q_per_kv;
  }
};

// The resident rows' gradients, in the input type, contiguous (B, S,
// heads, hd): acc2 times scale into out2, acc1 into out1 (dkdv's dV),
// written or, with `add` (f32: the partial sums of FB_FLUSH tiles, see the
// note at the top), added to what the rows hold.
template <typename T, int HD, bool KV, bool DO1, bool DO2>
__device__ __forceinline__ void flush(const FbBlock& k, int row0, int t4, T* __restrict__ out1,
                                      T* __restrict__ out2,
                                      const float (&acc1)[DO1 ? HD / 2 : 1],
                                      const float (&acc2)[DO2 ? HD / 2 : 1], float scale,
                                      bool add) {
  const int rows = KV ? k.Sk : k.Sq, heads = KV ? k.H / k.q_per_kv : k.H;
#pragma unroll
  for (int v1 = 0; v1 < 2; ++v1) {
    const int row = k.r0 + row0 + 8 * v1;
    if (row >= rows) continue;
    const long long off = (((long long)k.b * rows + row) * heads + k.rh) * HD + 2 * t4;
    if constexpr (DO2) store_row<T, HD>(out2 + off, acc2, v1, scale, add);
    if constexpr (DO1) store_row<T, HD>(out1 + off, acc1, v1, 1.f, add);
  }
}

// The two resident tiles, by TMA (one thread)
template <typename T, int HD, bool KV>
__device__ __forceinline__ void load_resident(const FbBlock& k, const CUtensorMap* a1,
                                              const CUtensorMap* a2, const CUtensorMap* b1,
                                              const CUtensorMap* b2) {
  using C = FbCfg<T, HD, KV>;
  sm90::prefetch_tmap(a1);
  sm90::prefetch_tmap(a2);
  sm90::prefetch_tmap(b1);
  sm90::prefetch_tmap(b2);
  sm90::mbar_arrive_expect_tx(k.bar_res, 2 * C::R_BYTES);
  for (int box = 0; box < C::NBOX; ++box) {
    sm90::tma_load_4d(k.sbase + box * FB_BM * C::ROWB, a1, k.bar_res, box * C::BOXE, k.r0,
                      k.rh, k.b);
    sm90::tma_load_4d(k.sbase + C::R_BYTES + box * FB_BM * C::ROWB, a2, k.bar_res,
                      box * C::BOXE, k.r0, k.rh, k.b);
  }
}

// Streamed tile i into its ring stage, once the stage is free: all 32 lanes
// of one warp (each arrives on the stage's "full" barrier); lane 0 issues
// the TMA loads, and in dkdv the lanes copy the tile's lse and D beside it
template <typename T, int HD, bool KV>
__device__ __forceinline__ void load_tile(const FbBlock& k, const CUtensorMap* b1,
                                          const CUtensorMap* b2, int i, int lane) {
  using C = FbCfg<T, HD, KV>;
  constexpr int BN = C::BN;
  const int s = i % C::STAGES;
  if (i >= C::STAGES) sm90::mbar_wait(k.bar_empty + 8 * s, (i / C::STAGES - 1) & 1);
  const int row0 = k.s_row0(i, KV, BN), head = k.s_head(i, KV);
  const uint32_t full = k.bar_full + 8 * s;
  if constexpr (KV) {
    // zeros for rows at or past Sq
    float* ld = reinterpret_cast<float*>(k.smem + C::OFF_LD + s * C::LD_BYTES);
    const long long off = ((long long)k.b * k.H + head) * k.Sq;
    for (int j = lane; j < BN; j += 32) {
      const bool in = row0 + j < k.Sq;
      ld[j] = in ? k.lse[off + row0 + j] : 0.f;
      ld[BN + j] = in ? k.dsum[off + row0 + j] : 0.f;
    }
  }
  if (lane == 0) {
    const uint32_t dst = k.sbase + C::OFF_RING + s * C::STAGE_BYTES;
    sm90::mbar_arrive_expect_tx(full, C::STAGE_BYTES);
    for (int box = 0; box < C::NBOX; ++box) {
      sm90::tma_load_4d(dst + box * BN * C::ROWB, b1, full, box * C::BOXE, row0, head, k.b);
      sm90::tma_load_4d(dst + C::T_BYTES + box * BN * C::ROWB, b2, full, box * C::BOXE, row0,
                        head, k.b);
    }
  } else {
    sm90::mbar_arrive(full);
  }
}

// One consumer warpgroup (thread tid of 128) of fb_kernel, over every tile
// of the block, then its rows' gradients.  DO1: acc1 += P B2 (dkdv: dV, into
// out1); DO2: acc2 += dS B1 (dkdv: dK, dq: dQ, into out2, times scale).
template <typename T, int HD, bool KV, bool DO1, bool DO2>
__device__ __forceinline__ void consume(const FbBlock& k, int tid, T* __restrict__ out1,
                                        T* __restrict__ out2, float scale, float scale_log2) {
  using C = FbCfg<T, HD, KV>;
  constexpr int BN = C::BN;
  const int row0 = 16 * (tid / 32) + (tid % 32) / 4;  // rows row0 and row0 + 8
  const int t4 = tid % 4;                              // columns 2 t4, 2 t4 + 1 of 8
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};    // dq: the rows' lse and D
  if constexpr (!KV) {
    const long long off = ((long long)k.b * k.H + k.rh) * k.Sq;
#pragma unroll
    for (int v1 = 0; v1 < 2; ++v1) {
      const int row = k.r0 + row0 + 8 * v1;
      if (row < k.Sq) {
        lse_r[v1] = k.lse[off + row];
        d_r[v1] = k.dsum[off + row];
      }
    }
  }

  float acc1[DO1 ? HD / 2 : 1], acc2[DO2 ? HD / 2 : 1];
#pragma unroll
  for (int i = 0; i < (DO1 ? HD / 2 : 1); ++i) acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DO2 ? HD / 2 : 1); ++i) acc2[i] = 0.f;
  float sc[BN / 2], dp[DO2 ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DO2 ? BN / 2 : 1); ++i) dp[i] = 0.f;

  sm90::mbar_wait(k.bar_res, 0);
  for (int i = 0; i < k.n_tiles; ++i) {
    const int s = i % C::STAGES;
    const int srow0 = k.s_row0(i, KV, BN);
    const uint32_t b1 = k.sbase + C::OFF_RING + s * C::STAGE_BYTES;
    const uint32_t b2 = b1 + C::T_BYTES;
    sm90::mbar_wait(k.bar_full + 8 * s, (i / C::STAGES) & 1);
    if constexpr (C::F32) sm90::mbar_wait(k.bar_lo, i & 1);
    // key range [k_a, k_a + k_n), query rows [q_a, q_a + q_n) of this tile
    const int k_a = KV ? k.r0 : srow0, k_n = KV ? FB_BM : BN;
    const int q_a = KV ? srow0 : k.r0, q_n = KV ? BN : FB_BM;
    // a tile that the mask admits whole needs no per-element mask
    const bool edge =
        k_a + k_n > k.Sk || q_a + q_n > k.Sq ||
        (k.mask_kind != FA_FULL && k_a + k_n - 1 > k.q_pos0 + q_a) ||
        (k.mask_kind == FA_WINDOW && k_a <= k.q_pos0 + q_a + q_n - 1 - k.window);

    // S = A1 B1^T, dP = A2 B2^T (dkdv: S^T, dP^T)
    mma_scores<C>(sc, k.sbase, 0, b1, k.sbase + C::OFF_LO, k.smem, row0, t4);
    if constexpr (DO2)
      mma_scores<C>(dp, k.sbase, C::R_BYTES, b2, k.sbase + C::OFF_LO + C::T_BYTES, k.smem,
                    row0, t4);
    sm90::wgmma_wait_all();
    sm90::fence_regs(sc);
    if constexpr (DO2) sm90::fence_regs(dp);

    // P and dS in place of S and dP
    const float* ld = reinterpret_cast<const float*>(k.smem + C::OFF_LD + s * C::LD_BYTES);
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      float2 lse_c = make_float2(0.f, 0.f), d_c = lse_c;   // dkdv: the columns' lse and D
      if constexpr (KV) {
        lse_c = *reinterpret_cast<const float2*>(ld + 8 * c + 2 * t4);
        if constexpr (DO2) d_c = *reinterpret_cast<const float2*>(ld + BN + 8 * c + 2 * t4);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * c + e, v1 = e / 2, v0 = e % 2;
        const int rr = row0 + 8 * v1, cc = 8 * c + 2 * t4 + v0;
        const float l = KV ? (v0 ? lse_c.y : lse_c.x) : lse_r[v1];
        float p = exp2f(sc[idx] * scale_log2 - l);
        if (edge) {
          const long long kpos = KV ? k.r0 + rr : srow0 + cc;
          const long long qrow = KV ? srow0 + cc : k.r0 + rr;
          if (kpos >= k.Sk || qrow >= k.Sq ||
              !admitted(kpos, k.q_pos0 + qrow, k.mask_kind, k.window))
            p = 0.f;
        }
        sc[idx] = p;
        if constexpr (DO2) {
          const float d = KV ? (v0 ? d_c.y : d_c.x) : d_r[v1];
          dp[idx] = p * (dp[idx] - d);
        }
      }
    }
    if constexpr (C::F32) {
      sm90::mbar_arrive(k.bar_lo_free);
      sm90::mbar_arrive(k.bar_empty + 8 * s);
      sm90::mbar_wait(k.bar_t, i & 1);
    }

    // dV += P^T dO; acc2 += dS B1 (dK += dS^T Q, dQ += dS K)
    if constexpr (DO1) {
      sm90::fence_regs(acc1);
      mma_acc<C, HD>(acc1, sc, C::F32 ? k.sbase + C::OFF_T + 2 * C::T_BYTES : b2);
    }
    if constexpr (DO2) {
      sm90::fence_regs(acc2);
      mma_acc<C, HD>(acc2, dp, C::F32 ? k.sbase + C::OFF_T : b1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    if constexpr (DO1) sm90::fence_regs(acc1);
    if constexpr (DO2) sm90::fence_regs(acc2);
    sm90::mbar_arrive(C::F32 ? k.bar_t_free : k.bar_empty + 8 * s);
    if constexpr (C::F32) {
      if ((i + 1) % FB_FLUSH == 0 && i + 1 < k.n_tiles) {
        flush<T, HD, KV, DO1, DO2>(k, row0, t4, out1, out2, acc1, acc2, scale, i + 1 > FB_FLUSH);
#pragma unroll
        for (int j = 0; j < (DO1 ? HD / 2 : 1); ++j) acc1[j] = 0.f;
#pragma unroll
        for (int j = 0; j < (DO2 ? HD / 2 : 1); ++j) acc2[j] = 0.f;
      }
    }
  }
  flush<T, HD, KV, DO1, DO2>(k, row0, t4, out1, out2, acc1, acc2, scale,
                             C::F32 && k.n_tiles > FB_FLUSH);
}

// KV: the dkdv kernel (resident K, V; streamed Q, dO; out1 = dV, out2 = dK);
// else the dq kernel (resident Q, dO; streamed K, V; out2 = dQ).
template <typename T, int HD, bool KV>
__global__ void __launch_bounds__(FbCfg<T, HD, KV>::THREADS, 1)
fb_kernel(const __grid_constant__ CUtensorMap tm_a1, const __grid_constant__ CUtensorMap tm_a2,
          const __grid_constant__ CUtensorMap tm_b1, const __grid_constant__ CUtensorMap tm_b2,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          T* __restrict__ out1, T* __restrict__ out2, int Sq, int Sk, int H, int q_per_kv,
          int n_rt, int mask_kind, long long window, long long q_pos0, float scale,
          float scale_log2) {
  using C = FbCfg<T, HD, KV>;
  constexpr int BN = C::BN;
  extern __shared__ __align__(1024) uint8_t fb_smem[];
  FbBlock k;
  k.smem = fb_smem + ((1024 - (sm90::smem_addr(fb_smem) & 1023)) & 1023);
  k.sbase = sm90::smem_addr(k.smem);
  k.bar_full = k.sbase + C::OFF_BAR;           // + 8 s
  k.bar_empty = k.bar_full + 8 * C::STAGES;    // + 8 s
  k.bar_res = k.bar_empty + 8 * C::STAGES;     // the resident tiles
  k.bar_lo = k.bar_res + 8;                    // f32: lo set ready
  k.bar_lo_free = k.bar_lo + 8;                // f32: lo set read
  k.bar_t = k.bar_lo_free + 8;                 // f32: T set ready
  k.bar_t_free = k.bar_t + 8;                  // f32: T set read
  k.lse = lse;
  k.dsum = dsum;
  k.Sq = Sq;
  k.Sk = Sk;
  k.H = H;
  k.q_per_kv = q_per_kv;
  k.mask_kind = mask_kind;
  k.window = window;
  k.q_pos0 = q_pos0;
  k.b = blockIdx.y;

  const int Hkv = H / q_per_kv;
  int rt;
  if constexpr (KV) {
    rt = (int)(blockIdx.x / Hkv);                  // low key tiles first
    k.rh = (int)(blockIdx.x % Hkv);
  } else {
    rt = n_rt - 1 - (int)(blockIdx.x / H);         // heaviest query tiles first
    k.rh = (int)(blockIdx.x % H);
  }
  k.r0 = rt * FB_BM;

  // the streamed tiles this block visits: the others are masked for every row
  int st_begin = 0, st_end;
  if constexpr (KV) {
    // query rows that see a key of [r0, r0 + 64)
    long long i_begin = 0, i_end = Sq;
    if (mask_kind != FA_FULL) {
      i_begin = k.r0 - q_pos0 > 0 ? k.r0 - q_pos0 : 0;
      if (mask_kind == FA_WINDOW) {
        const long long k_last = (k.r0 + FB_BM < Sk ? k.r0 + FB_BM : Sk) - 1;
        const long long e = k_last + window - q_pos0;
        i_end = e < Sq ? e : Sq;
      }
    }
    st_begin = (int)(i_begin / BN);
    st_end = i_end > i_begin ? (int)((i_end + BN - 1) / BN) : st_begin;
  } else {
    const long long q_last = q_pos0 + (k.r0 + FB_BM < Sq ? k.r0 + FB_BM : Sq) - 1;
    const int n_kt = (Sk + BN - 1) / BN;
    st_end = n_kt;
    if (mask_kind != FA_FULL) {
      st_end = q_last / BN + 1 < n_kt ? (int)(q_last / BN + 1) : n_kt;
      if (mask_kind == FA_WINDOW) {
        const long long first_key = q_pos0 + k.r0 - window + 1;
        st_begin = first_key > 0 ? (int)(first_key / BN) : 0;
      }
    }
  }
  k.st_begin = st_begin;
  k.per_head = st_end > st_begin ? st_end - st_begin : 0;
  k.n_tiles = KV ? k.per_head * q_per_kv : k.per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(k.bar_full + 8 * s, 32);
      sm90::mbar_init(k.bar_empty + 8 * s, C::F32 ? (C::NC + 1) * FA_WG : FA_WG);
    }
    sm90::mbar_init(k.bar_res, 1);
    sm90::mbar_init(k.bar_lo, FA_WG);
    sm90::mbar_init(k.bar_lo_free, C::NC * FA_WG);
    sm90::mbar_init(k.bar_t, FA_WG);
    sm90::mbar_init(k.bar_t_free, C::NC * FA_WG);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if constexpr (!C::F32) {
    if (threadIdx.x >= FA_WG) {
      // -------------------------------------------------------- producer
      const int lane = threadIdx.x % 32;
      if (lane == 0) load_resident<T, HD, KV>(k, &tm_a1, &tm_a2, &tm_b1, &tm_b2);
      for (int i = 0; i < k.n_tiles; ++i) load_tile<T, HD, KV>(k, &tm_b1, &tm_b2, i, lane);
      return;
    }
  } else {
    if (threadIdx.x >= C::SPLITTER) {
      // ------------------------------------------------ splitter, producer
      if constexpr (C::NC == 2) sm90::setmaxnreg_dec<C::SPLITTER_REGS>();
      const int sid = threadIdx.x - C::SPLITTER;
      // warp 0 loads tile i + STAGES - 1 as tile i's split begins, into the
      // stage tile i - 1 has left
      const bool loads = sid < 32;
      if (sid == 0) load_resident<T, HD, KV>(k, &tm_a1, &tm_a2, &tm_b1, &tm_b2);
      if (loads)
        for (int i = 0; i < C::STAGES - 1 && i < k.n_tiles; ++i)
          load_tile<T, HD, KV>(k, &tm_b1, &tm_b2, i, sid);
      uint8_t* smem = k.smem;
      for (int i = 0; i < k.n_tiles; ++i) {
        const int s = i % C::STAGES;
        uint8_t* raw = smem + C::OFF_RING + s * C::STAGE_BYTES;
        if (loads && i + C::STAGES - 1 < k.n_tiles)
          load_tile<T, HD, KV>(k, &tm_b1, &tm_b2, i + C::STAGES - 1, sid);
        sm90::mbar_wait(k.bar_full + 8 * s, (i / C::STAGES) & 1);
        if (i > 0) sm90::mbar_wait(k.bar_lo_free, (i - 1) & 1);
        split_tile(raw, smem + C::OFF_LO, C::T_BYTES, sid);
        split_tile(raw + C::T_BYTES, smem + C::OFF_LO + C::T_BYTES, C::T_BYTES, sid);
        sm90::fence_proxy_async();
        sm90::mbar_arrive(k.bar_lo);
        sm90::named_bar_sync(1, FA_WG);   // hi and lo written before they are transposed
        if (i > 0) sm90::mbar_wait(k.bar_t_free, (i - 1) & 1);
        for (int t = 0; t < C::NT; ++t) {
          transpose_tile<HD>(raw + t * C::T_BYTES, smem + C::OFF_T + 2 * t * C::T_BYTES, sid);
          transpose_tile<HD>(smem + C::OFF_LO + t * C::T_BYTES,
                             smem + C::OFF_T + (2 * t + 1) * C::T_BYTES, sid);
        }
        sm90::fence_proxy_async();
        sm90::mbar_arrive(k.bar_t);
        sm90::mbar_arrive(k.bar_empty + 8 * s);
        sm90::named_bar_sync(1, FA_WG);   // lo read before the next tile's split
      }
      return;
    }
  }

  // ------------------------------------------------------------ consumers
  const int tid = threadIdx.x % FA_WG;
  if constexpr (C::NC == 2) {
    sm90::setmaxnreg_inc<C::CONSUMER_REGS>();
    if (threadIdx.x < FA_WG) consume<T, HD, KV, true, false>(k, tid, out1, out2, scale, scale_log2);
    else consume<T, HD, KV, false, true>(k, tid, out1, out2, scale, scale_log2);
  } else {
    consume<T, HD, KV, KV, true>(k, tid, out1, out2, scale, scale_log2);
  }
}

template <typename T, int HD, bool KV>
int launch_fb(const CUtensorMap& a1, const CUtensorMap& a2, const CUtensorMap& b1,
              const CUtensorMap& b2, const void* lse, const void* dsum, void* out1, void* out2,
              int B, int Sq, int Sk, int H, int Hkv, int mask_kind, long long window,
              long long q_pos0, float scale, cudaStream_t st) {
  using C = FbCfg<T, HD, KV>;
  cudaError_t err = cudaFuncSetAttribute(fb_kernel<T, HD, KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_rt = ((KV ? Sk : Sq) + FB_BM - 1) / FB_BM;
  const dim3 grid((unsigned)(n_rt * (KV ? Hkv : H)), (unsigned)B);
  fb_kernel<T, HD, KV><<<grid, C::THREADS, C::SMEM, st>>>(
      a1, a2, b1, b2, (const float*)lse, (const float*)dsum, (T*)out1, (T*)out2, Sq, Sk, H,
      H / Hkv, n_rt, mask_kind, window, q_pos0, scale, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dq, void* dk, void* dv, void* dsum, int B, long long Sq,
               long long Sk, int H, int Hkv, long long qsb, long long qss, long long qsh,
               long long ksb, long long kss, long long ksh, long long vsb, long long vss,
               long long vsh, int mask_kind, long long window, long long q_pos0, float scale,
               cudaStream_t st) {
  using KVC = FbCfg<T, HD, true>;
  using QC = FbCfg<T, HD, false>;
  constexpr bool F32 = KVC::F32;
  // dO is contiguous (B, Sq, H, hd)
  const long long gss = (long long)H * HD, gsb = Sq * gss;
  CUtensorMap kr, vr, qs, gs, qr, gr, ks, vs;   // resident (64 rows) and streamed (BN) maps
  int rc = make_map(&kr, k, F32, HD, Sk, Hkv, B, kss, ksh, ksb, FB_BM, KVC::BOXE, KVC::ROWB);
  if (rc == 0) rc = make_map(&vr, v, F32, HD, Sk, Hkv, B, vss, vsh, vsb, FB_BM, KVC::BOXE, KVC::ROWB);
  if (rc == 0) rc = make_map(&qs, q, F32, HD, Sq, H, B, qss, qsh, qsb, KVC::BN, KVC::BOXE, KVC::ROWB);
  if (rc == 0) rc = make_map(&gs, dout, F32, HD, Sq, H, B, gss, HD, gsb, KVC::BN, KVC::BOXE, KVC::ROWB);
  if (rc == 0) rc = make_map(&qr, q, F32, HD, Sq, H, B, qss, qsh, qsb, FB_BM, QC::BOXE, QC::ROWB);
  if (rc == 0) rc = make_map(&gr, dout, F32, HD, Sq, H, B, gss, HD, gsb, FB_BM, QC::BOXE, QC::ROWB);
  if (rc == 0) rc = make_map(&ks, k, F32, HD, Sk, Hkv, B, kss, ksh, ksb, QC::BN, QC::BOXE, QC::ROWB);
  if (rc == 0) rc = make_map(&vs, v, F32, HD, Sk, Hkv, B, vss, vsh, vsb, QC::BN, QC::BOXE, QC::ROWB);
  if (rc != 0) return rc;

  const long long rows = (long long)B * Sq * H;
  const long long dot_blocks = (rows + FB_DOT_THREADS / 32 - 1) / (FB_DOT_THREADS / 32);
  if (dot_blocks > 2147483647LL) return CG_ERR_SHAPE;
  fb_dot_kernel<T, HD><<<(unsigned)dot_blocks, FB_DOT_THREADS, 0, st>>>(
      (const T*)o, (const T*)dout, (float*)dsum, rows, (int)Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rc = launch_fb<T, HD, true>(kr, vr, qs, gs, lse, dsum, dv, dk, B, (int)Sq, (int)Sk, H, Hkv,
                              mask_kind, window, q_pos0, scale, st);
  if (rc != 0) return rc;
  return launch_fb<T, HD, false>(qr, gr, ks, vs, lse, dsum, nullptr, dq, B, (int)Sq, (int)Sk,
                                 H, Hkv, mask_kind, window, q_pos0, scale, st);
}

}  // namespace

// Gradients of flash_attention_launch's output.  q: (B, Sq, H, hd) with
// element strides (qsb, qss, qsh, 1); k, v: (B, Sk, Hkv, hd) with strides
// (ksb, kss, ksh, 1) and (vsb, vss, vsh, 1); o (the forward's output) and
// dout: contiguous (B, Sq, H, hd); lse: the forward's (B, H, Sq) f32 in
// log2 units; dsum: (B, H, Sq) f32 scratch.  Writes dq contiguous (B, Sq,
// H, hd) and dk, dv contiguous (B, Sk, Hkv, hd), in the input type.  Bases
// and the strides of every dimension longer than 1 are multiples of 16
// bytes (TMA).  The mask, q_pos0 and scale as in the forward.  Returns
// cudaGetLastError() of the last launch, or a negative code (CG_ERR_*,
// FA_ERR_*) when nothing was launched.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* dq, void* dk, void* dv, void* dsum, int B,
                                          long long Sq, long long Sk, int H, int Hkv, int hd,
                                          long long qsb, long long qss, long long qsh,
                                          long long ksb, long long kss, long long ksh,
                                          long long vsb, long long vss, long long vsh,
                                          int mask_kind, long long window, long long q_pos0,
                                          float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 ||
      q_pos0 < 0 || Sq > 2147483647LL || Sk > 2147483647LL)
    return CG_ERR_SHAPE;
  if (mask_kind != FA_CAUSAL && mask_kind != FA_FULL && mask_kind != FA_WINDOW)
    return CG_ERR_SHAPE;
  if (mask_kind == FA_WINDOW && window < 1) return CG_ERR_SHAPE;
  if ((Sq + FB_BM - 1) / FB_BM * H > 2147483647LL || (Sk + FB_BM - 1) / FB_BM * Hkv > 2147483647LL)
    return CG_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
#define FB_CALL(T, HDV)                                                                   \
  return launch_bwd<T, HDV>(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, Sq, Sk, H, Hkv,   \
                            qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, mask_kind, window, \
                            q_pos0, scale, st)
#define FB_HD(T)                 \
  switch (hd) {                  \
    case 32: FB_CALL(T, 32);     \
    case 64: FB_CALL(T, 64);     \
    case 128: FB_CALL(T, 128);   \
    default: return CG_ERR_SHAPE; \
  }
  switch (dtype) {
    case CG_F32: FB_HD(float)
    case CG_BF16: FB_HD(__nv_bfloat16)
    default: return CG_ERR_DTYPE;
  }
  return CG_ERR_DTYPE;  // not reached: every case returns
#undef FB_HD
#undef FB_CALL
}

// Dynamic shared memory a block of the backward's dkdv and dq kernels for
// (dtype, hd) asks for, the larger of the two, in bytes (alignment slack
// and barriers included), or a negative CG_ERR_*.
extern "C" int flash_attention_bwd_smem_bytes(int dtype, int hd) {
#define FB_MAX(T, HDV)                                                           \
  return FbCfg<T, HDV, true>::SMEM > FbCfg<T, HDV, false>::SMEM                  \
             ? FbCfg<T, HDV, true>::SMEM : FbCfg<T, HDV, false>::SMEM
#define FB_SMEM(T)                     \
  switch (hd) {                        \
    case 32: FB_MAX(T, 32);            \
    case 64: FB_MAX(T, 64);            \
    case 128: FB_MAX(T, 128);          \
    default: return CG_ERR_SHAPE;      \
  }
  switch (dtype) {
    case CG_F32: FB_SMEM(float)
    case CG_BF16: FB_SMEM(__nv_bfloat16)
    default: return CG_ERR_DTYPE;
  }
#undef FB_SMEM
#undef FB_MAX
}
