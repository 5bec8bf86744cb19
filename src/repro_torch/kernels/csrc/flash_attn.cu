// flash_attention for Hopper (sm_90a): the forward pass of attention with an
// online softmax, in the model layout (B, S, H, hd), grouped-query heads, on
// the tensor cores (wgmma), fed by a TMA ring.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py (flash_attention,
// _flash_kernel, and the layout wrapper flash_attention_gqa):
//
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / g] / sqrt(hd)) v[b, j, h / g]
//
// over the keys j that the mask admits ("causal": j <= p0 + i, "window": also
// j > p0 + i - window, "full": all), p0 the position of query row 0.  Masked
// scores are -1e30, keys past the end weigh exactly 0, and the denominator is
// floored at 1e-30, as in the TPU kernel; the running (m, l, O) state is f32
// whatever the input type, and the output is in the input type.
//
// What bounds it.  Causal attention over S keys does 2 S^2 H hd operations
// (half of the dense 4 S^2 H hd) on 2 S H hd + 2 S Hkv hd elements: at the
// 4096-token prompt of qwen3-1.7b (H = 16, Hkv = 8, hd = 128) that is
// 68.7 GFLOP on about 101 MB (f32), several hundred operations a byte, so it
// is bound by the tensor cores:
//  - f32 inputs run as 3xTF32 (below): three TF32 products for each one,
//    3 x 68.7 GFLOP at the H100 SXM's 495 TFLOP/s of TF32 = 0.417 ms;
//  - bf16 inputs run one bf16 product each: 68.7 GFLOP at 989 TFLOP/s =
//    0.0695 ms.
//
// Numbers.  f32: each operand a is split as a = hi + lo, hi = tf32(a) and
// lo = tf32(a - hi) (both exact tf32 values, so the tensor cores read them
// as they are), and a product is hi.hi + hi.lo + lo.hi, summed in f32: about
// 1e-6 relative, where one TF32 pass (10 mantissa bits) would miss the
// port's 2e-5 f32 contract.  bf16: S = Q K^T in bf16 with f32 sums, P
// rounded to bf16 (as the plain version's p.to(bf16)), O += P V with f32
// sums.
//
// The design:
//  - one block per (64 query rows, query head, batch), heaviest query tiles
//    of every head first (the causal triangle's long rows).  Roles by warp:
//    a consumer warpgroup (warps 0-3), for f32 a splitter warpgroup (warps
//    4-7), and a producer warp (the last): 288 threads for f32, 160 for bf16.
//  - the producer's one thread loads the Q tile once and then the K and V
//    tiles of the visited key range by TMA (rank-4 tensor maps over
//    (hd, S, heads, B) built on the host from the strides: GQA reads KV head
//    h / q_per_kv in place, non-contiguous views need no copy) into a ring of
//    STAGES (2-4) stages, each signalled by a "full" mbarrier (bytes) and
//    released by an "empty" one (128 consumer arrivals): the loads of the
//    next tiles overlap the math on this one.  Rows past the end arrive as
//    zeros.
//  - the consumer warpgroup keeps the 64 x BK score tile S and the 64 x hd
//    output O in registers (the wgmma accumulator layout: a thread holds two
//    rows, and a row's max and sum are reduced over the 4 threads of a quad)
//    and runs the online softmax there.  S = Q K^T reads Q and K from shared
//    memory (K-major, 128-byte swizzle as TMA writes it; 64-byte rows for
//    bf16 at hd = 32); P goes back into the tensor cores as the register A
//    operand of O += P V.
//  - f32: BK = 32.  The consumers split Q once into hi (in place) and lo.
//    The splitter warpgroup splits each K tile into hi (in place, in its
//    ring stage) and lo, and each V tile into V^T hi and lo, transposed
//    because TF32 wgmma takes K-major operands only, with the keys of every
//    group of 8 stored in the order 0 2 4 6 1 3 5 7: that is the order in
//    which the accumulator layout hands P's columns to the A operand's k
//    slots, so P needs no shuffle.  It writes two sets of (K lo, V^T hi,
//    V^T lo) in turn, each guarded by a "split" and a "free" mbarrier, so
//    the split of tile j + 1 runs while the consumers multiply tile j.  P is
//    split in registers.
//  - bf16: BK = 64.  V is read as it lies (hd contiguous) through the
//    transpose flag of the bf16 wgmma; nothing is copied.
//  - key tiles that the mask empties for every row of the block (above the
//    causal diagonal, before the window) are never loaded.  A fully masked
//    tile adds exp(-1e30 - m) = 0 after a valid key has been seen, and what
//    it adds before one is wiped by the exact 0 of the correction factor
//    once a valid key arrives, so skipping does not change the result.
//    Tiles that the mask admits whole skip the per-element mask.
//
// Shared memory a block (FaCfg below; 1 KB of alignment slack and the
// barriers come on top):
//   f32  hd 128: Q hi/lo 64 K + 2 split sets x 48 K + 2 stages x 32 K = 224 K, 1 block an SM
//   f32  hd  64: 32 K + 2 x 24 K + 4 x 16 K = 144 K, 1 block an SM
//   f32  hd  32: 16 K + 2 x 12 K + 4 x 8 K = 72 K, 2 blocks an SM
//   bf16 hd 128: Q 16 K + 2 stages x 32 K = 80 K, 2 blocks an SM
//   bf16 hd  64: 8 K + 4 x 16 K = 72 K;   bf16 hd 32: 4 K + 4 x 8 K = 36 K
// Registers (nvcc 12.8, -Xptxas -v; chip_smoke.py's build line reports
// them): 155 (f32) and 164 (bf16) a thread at hd 128, nothing spilled.
#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

#define FA_CAUSAL 0
#define FA_FULL 1
#define FA_WINDOW 2

// refusals of the launcher besides CG_ERR_SHAPE / CG_ERR_DTYPE
#define FA_ERR_ALIGN (-3)  // a base or a stride TMA cannot take
#define FA_ERR_TMA (-4)    // no tensor-map encoder, or it refused the map

namespace {

constexpr int FA_BQ = 64;                    // query rows per block
constexpr int FA_WG = 128;                    // threads of a warpgroup
constexpr float FA_MASKED = -1e30f;
constexpr int FA_BUDGET_2 = 110 * 1024;      // two blocks an SM
constexpr int FA_BUDGET_1 = 225 * 1024;      // one block an SM (227 K at most)

template <typename T, int HD>
struct FaCfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int ESZ = sizeof(T);
  static constexpr int BK = F32 ? 32 : 64;               // keys per tile
  // consumer warpgroup, f32: splitter warpgroup, then the producer warp
  static constexpr int THREADS = FA_WG * (F32 ? 2 : 1) + 32;
  static constexpr int ROWB = HD * ESZ < 128 ? HD * ESZ : 128;  // swizzled row bytes
  static constexpr int BOXE = ROWB / ESZ;                // elements of a box row
  static constexpr int NBOX = HD * ESZ / ROWB;           // boxes across hd
  static constexpr uint32_t SWIZZLE = ROWB == 128 ? 1 : 2;  // descriptor mode
  static constexpr int KSTEPS = HD * ESZ / 32;           // wgmma k steps over hd
  static constexpr int Q_BYTES = FA_BQ * HD * ESZ;
  static constexpr int T_BYTES = BK * HD * ESZ;          // one K or V tile
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  static constexpr int SET_BYTES = 3 * T_BYTES;          // f32: K lo, V^T hi, V^T lo
  static constexpr int FIXED = F32 ? 2 * Q_BYTES + 2 * SET_BYTES : Q_BYTES;
  static constexpr bool TWO = FIXED + 2 * STAGE_BYTES <= FA_BUDGET_2;
  static constexpr int FIT = ((TWO ? FA_BUDGET_2 : FA_BUDGET_1) - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int MIN_BLOCKS = TWO ? 2 : 1;
  // byte offsets in the (1024-aligned) shared memory
  static constexpr int OFF_QLO = Q_BYTES;                // f32 only
  static constexpr int OFF_SET = 2 * Q_BYTES;            // f32: two split sets
  static constexpr int OFF_RING = FIXED;
  static constexpr int OFF_BAR = FIXED + STAGES * STAGE_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (2 * STAGES + 5) + 1024;
  // split set t: K lo, V^T hi, V^T lo
  __host__ __device__ static constexpr int klo(int t) { return OFF_SET + t * SET_BYTES; }
  __host__ __device__ static constexpr int vthi(int t) { return klo(t) + T_BYTES; }
  __host__ __device__ static constexpr int vtlo(int t) { return klo(t) + 2 * T_BYTES; }
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(Q_BYTES % 1024 == 0 && T_BYTES % 1024 == 0, "swizzle atoms");
  static_assert(!F32 || ROWB == 128, "the f32 split assumes 128-byte rows");
};

// byte offset of wgmma k step `kk` (32 bytes of hd) in a tile of `rows` rows
// stored as boxes of rows x ROWB
template <int ROWB>
__device__ __forceinline__ uint32_t koff(int kk, int rows) {
  return (kk * 32 / ROWB) * rows * ROWB + (kk * 32) % ROWB;
}

// a = hi + lo over a whole tile, elementwise: hi in place, lo into `lo`
__device__ __forceinline__ void split_tile(uint8_t* raw, uint8_t* lo, int bytes, int tid) {
  float4* r = reinterpret_cast<float4*>(raw);
  float4* l = reinterpret_cast<float4*>(lo);
  for (int i = tid; i < bytes / 16; i += FA_WG) {
    const float4 a = r[i];
    float4 h, w;
    h.x = __uint_as_float(sm90::to_tf32(a.x));
    h.y = __uint_as_float(sm90::to_tf32(a.y));
    h.z = __uint_as_float(sm90::to_tf32(a.z));
    h.w = __uint_as_float(sm90::to_tf32(a.w));
    w.x = __uint_as_float(sm90::to_tf32(a.x - h.x));
    w.y = __uint_as_float(sm90::to_tf32(a.y - h.y));
    w.z = __uint_as_float(sm90::to_tf32(a.z - h.z));
    w.w = __uint_as_float(sm90::to_tf32(a.w - h.w));
    r[i] = h;
    l[i] = w;
  }
}

// The f32 V tile (32 keys x HD, as TMA wrote it: HD / 32 boxes of 32 rows x
// 128 swizzled bytes) into V^T hi and lo (HD rows x 32 keys, 128 swizzled
// bytes a row), key r of each group of 8 at column (r & 1) * 4 + (r & 7) / 2.
template <int HD>
__device__ __forceinline__ void split_v_transposed(const uint8_t* raw, uint8_t* vthi,
                                                   uint8_t* vtlo, int tid) {
  for (int idx = tid; idx < 32 * HD / 4; idx += FA_WG) {
    const int r = idx % 32;           // key
    const int dg = idx / 32;          // columns 4 dg .. 4 dg + 3
    const float4 a = *reinterpret_cast<const float4*>(
        raw + (dg / 8) * 32 * 128 + r * 128 + (((dg % 8) ^ (r % 8)) << 4));
    const int j = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * dg + e;
      const int off = d * 128 + (((j >> 2) ^ (d & 7)) << 4) + ((j & 3) << 2);
      const uint32_t hi = sm90::to_tf32(av[e]);
      *reinterpret_cast<uint32_t*>(vthi + off) = hi;
      *reinterpret_cast<uint32_t*>(vtlo + off) = sm90::to_tf32(av[e] - __uint_as_float(hi));
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__device__ __forceinline__ void mma_pv_tf32(float (&o)[HD / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (HD == 32) sm90::wgmma_tf32_rs_n32(o, a, db, 1);
  else if constexpr (HD == 64) sm90::wgmma_tf32_rs_n64(o, a, db, 1);
  else sm90::wgmma_tf32_rs_n128(o, a, db, 1);
}

template <int HD>
__device__ __forceinline__ void mma_pv_bf16(float (&o)[HD / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (HD == 32) sm90::wgmma_bf16_rs_n32_tb(o, a, db, 1);
  else if constexpr (HD == 64) sm90::wgmma_bf16_rs_n64_tb(o, a, db, 1);
  else sm90::wgmma_bf16_rs_n128_tb(o, a, db, 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(FaCfg<T, HD>::THREADS, FaCfg<T, HD>::MIN_BLOCKS)
flash_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out, int Sq, int Sk,
             int H, int q_per_kv, int n_qt, int mask_kind, long long window,
             long long q_pos0, float scale_log2) {
  using C = FaCfg<T, HD>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(1024) uint8_t fa_smem[];
  uint8_t* smem = fa_smem + ((1024 - (sm90::smem_addr(fa_smem) & 1023)) & 1023);
  const uint32_t sbase = sm90::smem_addr(smem);
  const uint32_t bar_full = sbase + C::OFF_BAR;         // + 8 s
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;  // + 8 s
  const uint32_t bar_q = bar_empty + 8 * C::STAGES;
  const uint32_t bar_split = bar_q + 8;         // f32: set t is split, + 8 t
  const uint32_t bar_free = bar_split + 16;     // f32: set t is read, + 8 t

  const int qt = n_qt - 1 - (int)(blockIdx.x / H);  // heaviest query tiles first
  const int h = (int)(blockIdx.x % H);
  const int hk = h / q_per_kv;
  const int b = blockIdx.y;
  const int q0 = qt * FA_BQ;

  // the key tiles this block visits: the others are masked for every row
  const long long qlo = q_pos0 + q0;
  const int q_end = q0 + FA_BQ < Sq ? q0 + FA_BQ : Sq;
  const long long qhi = q_pos0 + q_end - 1;
  const int n_kt = (Sk + BK - 1) / BK;
  int kt_begin = 0, kt_end = n_kt;
  if (mask_kind != FA_FULL) {
    kt_end = qhi / BK + 1 < n_kt ? (int)(qhi / BK + 1) : n_kt;
    if (mask_kind == FA_WINDOW) {
      const long long first_key = qlo - window + 1;
      kt_begin = first_key > 0 ? (int)(first_key / BK) : 0;
    }
  }
  const int n_tiles = kt_end > kt_begin ? kt_end - kt_begin : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(bar_full + 8 * s, 1);
      sm90::mbar_init(bar_empty + 8 * s, FA_WG);
    }
    sm90::mbar_init(bar_q, 1);
    for (int t = 0; t < 2; ++t) {
      sm90::mbar_init(bar_split + 8 * t, FA_WG);
      sm90::mbar_init(bar_free + 8 * t, FA_WG);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::THREADS - 32) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x == C::THREADS - 32) {
      sm90::prefetch_tmap(&tm_q);
      sm90::prefetch_tmap(&tm_k);
      sm90::prefetch_tmap(&tm_v);
      sm90::mbar_arrive_expect_tx(bar_q, C::Q_BYTES);
      for (int box = 0; box < C::NBOX; ++box)
        sm90::tma_load_4d(sbase + box * FA_BQ * C::ROWB, &tm_q, bar_q, box * C::BOXE, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES;
        if (i >= C::STAGES) sm90::mbar_wait(bar_empty + 8 * s, (i / C::STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t dst = sbase + C::OFF_RING + s * C::STAGE_BYTES;
        const int k0 = (kt_begin + i) * BK;
        sm90::mbar_arrive_expect_tx(full, C::STAGE_BYTES);
        for (int box = 0; box < C::NBOX; ++box) {
          sm90::tma_load_4d(dst + box * BK * C::ROWB, &tm_k, full, box * C::BOXE, k0, hk, b);
          sm90::tma_load_4d(dst + C::T_BYTES + box * BK * C::ROWB, &tm_v, full, box * C::BOXE,
                            k0, hk, b);
        }
      }
    }
    return;
  }

  if constexpr (C::F32) {
    if (threadIdx.x >= FA_WG) {
      // -------------------------------------------------------- splitter
      // tile i from its ring stage into split set i % 2 (K hi in place),
      // while the consumers run the products of tile i - 1 on the other set
      const int sid = threadIdx.x - FA_WG;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES, t = i % 2;
        sm90::mbar_wait(bar_full + 8 * s, (i / C::STAGES) & 1);
        if (i >= 2) sm90::mbar_wait(bar_free + 8 * t, (i / 2 - 1) & 1);
        uint8_t* kraw = smem + C::OFF_RING + s * C::STAGE_BYTES;
        split_tile(kraw, smem + C::klo(t), C::T_BYTES, sid);
        split_v_transposed<HD>(kraw + C::T_BYTES, smem + C::vthi(t), smem + C::vtlo(t), sid);
        sm90::fence_proxy_async();
        sm90::mbar_arrive(bar_split + 8 * t);
      }
      return;
    }
  }

  // ------------------------------------------------------------ consumers
  const int tid = threadIdx.x;
  const int row0 = 16 * (tid / 32) + (tid % 32) / 4;  // rows row0 and row0 + 8
  const int t4 = tid % 4;                              // columns 2 t4, 2 t4 + 1 of 8
  const long long qpos[2] = {qlo + row0, qlo + row0 + 8};

  sm90::mbar_wait(bar_q, 0);
  if constexpr (C::F32) {
    split_tile(smem, smem + C::OFF_QLO, C::Q_BYTES, tid);
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1, FA_WG);
  }

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {FA_MASKED, FA_MASKED};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  float sc[C::BK / 2];          // S, then P, of the current key tile
#pragma unroll
  for (int i = 0; i < C::BK / 2; ++i) sc[i] = 0.f;
  const float neg_inf = -__int_as_float(0x7f800000);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::STAGES;
    const int k0 = (kt_begin + i) * BK;
    const uint32_t kst = sbase + C::OFF_RING + s * C::STAGE_BYTES;
    const uint32_t vst = kst + C::T_BYTES;
    const int t = i % 2;  // f32: the split set of this tile
    if constexpr (C::F32) sm90::mbar_wait(bar_split + 8 * t, (i / 2) & 1);
    else sm90::mbar_wait(bar_full + 8 * s, (i / C::STAGES) & 1);
    // a tile that the mask admits whole, for every row of the block, needs
    // no per-element mask (most tiles of a long causal prompt)
    const bool edge = k0 + BK > Sk || (mask_kind != FA_FULL && k0 + BK - 1 > qlo) ||
                      (mask_kind == FA_WINDOW && k0 <= qhi - window);

    // S = Q K^T (f32: hi.hi + hi.lo + lo.hi)
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const uint32_t qo = koff<C::ROWB>(kk, FA_BQ), ko = koff<C::ROWB>(kk, BK);
      const uint64_t dq = sm90::make_desc(sbase + qo, 16, 8 * C::ROWB, C::SWIZZLE);
      const uint64_t dk = sm90::make_desc(kst + ko, 16, 8 * C::ROWB, C::SWIZZLE);
      if constexpr (C::F32) {
        const uint64_t dql = sm90::make_desc(sbase + C::OFF_QLO + qo, 16, 1024, 1);
        const uint64_t dkl = sm90::make_desc(sbase + C::klo(t) + ko, 16, 1024, 1);
        sm90::wgmma_tf32_ss_n32(sc, dq, dk, kk > 0);
        sm90::wgmma_tf32_ss_n32(sc, dq, dkl, 1);
        sm90::wgmma_tf32_ss_n32(sc, dql, dk, 1);
      } else {
        sm90::wgmma_bf16_ss_n64(sc, dq, dk, kk > 0);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(sc);
    if constexpr (C::F32) sm90::mbar_arrive(bar_empty + 8 * s);  // K hi read

    // scores in log2 units, masked on an edge tile only
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const long long kpos = k0 + 8 * (i / 4) + 2 * t4 + i % 2;
        const long long qp = qpos[(i / 2) % 2];
        bool ok = true;
        if (mask_kind != FA_FULL) ok = kpos <= qp;
        if (mask_kind == FA_WINDOW) ok = ok && kpos > qp - window;
        // a key past Sk is absent (weight exactly 0); a masked one is -1e30
        sc[i] = kpos >= Sk ? neg_inf : (ok ? sc[i] : FA_MASKED);
      }
    }

    // online softmax, P in sc
#pragma unroll
    for (int v1 = 0; v1 < 2; ++v1) {
      float mx = neg_inf;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int v0 = 0; v0 < 2; ++v0) mx = fmaxf(mx, sc[4 * c + 2 * v1 + v0]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[v1], mx);
      const float corr = exp2f(m_run[v1] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int v0 = 0; v0 < 2; ++v0) {
          const int idx = 4 * c + 2 * v1 + v0;
          const float p = exp2f(sc[idx] - m_new);
          sc[idx] = p;
          sum += p;
        }
      l_run[v1] = l_run[v1] * corr + sum;
      m_run[v1] = m_new;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        o[4 * c + 2 * v1] *= corr;
        o[4 * c + 2 * v1 + 1] *= corr;
      }
    }

    // O += P V
    sm90::fence_regs(o);
    if constexpr (C::F32) {
      uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        // A slot (row, k): k = t4 holds key 2 t4, k = t4 + 4 key 2 t4 + 1
        const float pv[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1], sc[4 * kk + 3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ahi[kk][e] = sm90::to_tf32(pv[e]);
          alo[kk][e] = sm90::to_tf32(pv[e] - __uint_as_float(ahi[kk][e]));
        }
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t dh = sm90::make_desc(sbase + C::vthi(t) + 32 * kk, 16, 1024, 1);
        const uint64_t dl = sm90::make_desc(sbase + C::vtlo(t) + 32 * kk, 16, 1024, 1);
        mma_pv_tf32<HD>(o, ahi[kk], dh);
        mma_pv_tf32<HD>(o, ahi[kk], dl);
        mma_pv_tf32<HD>(o, alo[kk], dh);
      }
    } else {
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        a[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        a[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        a[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        a[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = sm90::make_desc(vst + kk * 16 * C::ROWB, BK * C::ROWB,
                                            8 * C::ROWB, C::SWIZZLE);
        mma_pv_bf16<HD>(o, a[kk], dv);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(o);
    // bf16: K and V read; f32: K lo and V^T of set t read
    sm90::mbar_arrive(C::F32 ? bar_free + 8 * t : bar_empty + 8 * s);
  }

  // out = O / max(l, 1e-30), in the input type, layout (B, Sq, H, hd)
#pragma unroll
  for (int v1 = 0; v1 < 2; ++v1) {
    float l = l_run[v1];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int row = q0 + row0 + 8 * v1;
    if (row >= Sq) continue;
    T* orow = out + (((long long)b * Sq + row) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const float x = o[4 * c + 2 * v1] / denom, y = o[4 * c + 2 * v1 + 1] / denom;
      if constexpr (C::F32) {
        *reinterpret_cast<float2*>(orow + 8 * c + 2 * t4) = make_float2(x, y);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + 2 * t4) = __floats2bfloat162_rn(x, y);
      }
    }
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime: nothing more to link
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Rank-4 tensor map over (hd, S, heads, B) with element strides (1, ss, sh,
// sb), boxes of box_rows x boxe elements.  A dimension of extent 1 never
// moves, so its stride is not read.
int make_map(CUtensorMap* map, const void* ptr, bool f32, int hd, long long S, int heads,
             int B, long long ss, long long sh, long long sb, int box_rows, int boxe,
             int rowb) {
  const long long esz = f32 ? 4 : 2;
  const long long extent[3] = {S, heads, B};
  const long long stride[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const long long bytes = extent[i] == 1 ? hd * esz : stride[i] * esz;
    if (bytes <= 0 || bytes % 16 != 0 || bytes >= (1LL << 40)) return FA_ERR_ALIGN;
    strides[i] = (cuuint64_t)bytes;
  }
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return FA_ERR_ALIGN;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return FA_ERR_TMA;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint32_t box[4] = {(cuuint32_t)boxe, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         4, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         rowb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : FA_ERR_TMA;
}

template <typename T, int HD>
int launch_flash(const void* q, const void* k, const void* v, void* out, int B, long long Sq,
                 long long Sk, int H, int Hkv, long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh, long long vsb, long long vss,
                 long long vsh, int mask_kind, long long window, long long q_pos0,
                 float scale, cudaStream_t st) {
  using C = FaCfg<T, HD>;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, C::F32, HD, Sq, H, B, qss, qsh, qsb, FA_BQ, C::BOXE, C::ROWB);
  if (rc == 0) rc = make_map(&tk, k, C::F32, HD, Sk, Hkv, B, kss, ksh, ksb, C::BK, C::BOXE, C::ROWB);
  if (rc == 0) rc = make_map(&tv, v, C::F32, HD, Sk, Hkv, B, vss, vsh, vsb, C::BK, C::BOXE, C::ROWB);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (int)((Sq + FA_BQ - 1) / FA_BQ);
  const dim3 grid((unsigned)(n_qt * H), (unsigned)B);
  flash_kernel<T, HD><<<grid, C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, (T*)out, (int)Sq, (int)Sk, H, H / Hkv, n_qt, mask_kind, window, q_pos0,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, hd) with element strides (qsb, qss, qsh, 1); k, v: (B, Sk, Hkv,
// hd) with strides (ksb, kss, ksh, 1) and (vsb, vss, vsh, 1); out: contiguous
// (B, Sq, H, hd).  All of one element type, on the current device; hd is 32,
// 64 or 128, Hkv divides H; bases and the strides of every dimension longer
// than 1 are multiples of 16 bytes (TMA).  Query row i sits at position
// q_pos0 + i, key j at j.  Returns cudaGetLastError() of the launch, or a
// negative code (CG_ERR_*, FA_ERR_*) when nothing was launched.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, long long Sq, long long Sk,
                                      int H, int Hkv, int hd, long long qsb,
                                      long long qss, long long qsh, long long ksb,
                                      long long kss, long long ksh, long long vsb,
                                      long long vss, long long vsh, int mask_kind,
                                      long long window, long long q_pos0, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H > 65535 || B > 65535 || q_pos0 < 0 || Sq > 2147483647LL || Sk > 2147483647LL)
    return CG_ERR_SHAPE;
  if (mask_kind != FA_CAUSAL && mask_kind != FA_FULL && mask_kind != FA_WINDOW)
    return CG_ERR_SHAPE;
  if (mask_kind == FA_WINDOW && window < 1) return CG_ERR_SHAPE;
  if ((Sq + FA_BQ - 1) / FA_BQ * H > 2147483647LL) return CG_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_CALL(T, HDV)                                                              \
  return launch_flash<T, HDV>(q, k, v, out, B, Sq, Sk, H, Hkv, qsb, qss, qsh, ksb,   \
                              kss, ksh, vsb, vss, vsh, mask_kind, window, q_pos0,   \
                              scale, st)
#define FA_HD(T)                       \
  switch (hd) {                        \
    case 32: FA_CALL(T, 32);           \
    case 64: FA_CALL(T, 64);           \
    case 128: FA_CALL(T, 128);         \
    default: return CG_ERR_SHAPE;      \
  }
  switch (dtype) {
    case CG_F32: FA_HD(float)
    case CG_BF16: FA_HD(__nv_bfloat16)
    default: return CG_ERR_DTYPE;
  }
  return CG_ERR_DTYPE;  // not reached: every case returns
#undef FA_HD
#undef FA_CALL
}

// Dynamic shared memory a block of the kernel for (dtype, hd) asks for, in
// bytes (alignment slack and barriers included), or a negative CG_ERR_*.
extern "C" int flash_attention_smem_bytes(int dtype, int hd) {
#define FA_SMEM(T)                                   \
  switch (hd) {                                      \
    case 32: return FaCfg<T, 32>::SMEM;              \
    case 64: return FaCfg<T, 64>::SMEM;              \
    case 128: return FaCfg<T, 128>::SMEM;            \
    default: return CG_ERR_SHAPE;                    \
  }
  switch (dtype) {
    case CG_F32: FA_SMEM(float)
    case CG_BF16: FA_SMEM(__nv_bfloat16)
    default: return CG_ERR_DTYPE;
  }
#undef FA_SMEM
}
