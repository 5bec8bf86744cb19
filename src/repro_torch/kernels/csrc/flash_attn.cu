// flash_attention for Hopper (sm_90a): the forward pass of attention with an
// online softmax, in the model layout (B, S, H, hd), grouped-query heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py (flash_attention,
// _flash_kernel, and the layout wrapper flash_attention_gqa):
//
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / g] / sqrt(hd)) v[b, j, h / g]
//
// over the keys j that the mask admits ("causal": j <= p0 + i, "window": also
// j > p0 + i - window, "full": all), p0 the position of query row 0.  Masked
// scores are -1e30 and the denominator is floored at 1e-30, as in the TPU
// kernel; the running (m, l, acc) state is f32 whatever the input type.
//
// What bounds it.  Causal attention over S keys does 2 S^2 H hd operations
// (half of the dense 4 S^2 H hd) on 2 S H hd + 2 S Hkv hd elements: at the
// 4096-token prompt of qwen3-1.7b (H = 16, Hkv = 8, hd = 128, f32) that is
// 68.7 GFLOP on about 101 MB, about 680 operations a byte.  So it is bound by
// arithmetic: 1.03 ms at the H100 SXM's 67 TFLOP/s of f32 outside the tensor
// cores, against 0.03 ms for the bytes.  This first kernel runs on the CUDA
// cores in f32 (no wgmma, no TMA).
//
// The design, for arithmetic:
//  - one block of 256 threads per (query tile of 64 rows, query head, batch);
//    the loop over key tiles runs inside the block, where the TPU walks them
//    as a sequential grid axis.  The q tile sits in shared memory for the
//    whole loop; each key tile is staged once in shared memory (K, then V in
//    the same buffer) and read by all 64 query rows.
//  - thread (ty, tx) of the 16 x 16 grid owns query rows 4 ty .. 4 ty + 3: a
//    4 x 4 block of the score tile (keys tx + 16 j) and a 4 x hd/16 block of
//    the output accumulator, both in registers, so every value read from
//    shared memory feeds at least 4 fused multiply-adds.  Q and K rows are
//    read as float4 along hd, with rows padded by 4 floats so the 16 threads
//    of a row group hit distinct banks.
//  - a row's max and sum are reduced across its 16 threads with shuffles;
//    m and l stay in the registers of each of them.
//  - key tiles that the mask empties for every row of the block (above the
//    causal diagonal, before the window) are skipped.  The TPU kernel visits
//    them; a fully masked tile adds exp(-1e30 - m) = 0 after a valid key has
//    been seen, and what it adds before one is wiped by the exact 0 of the
//    correction factor once a valid key arrives, so skipping does not change
//    the result.  Causal attention does half the work of full attention.
//  - the KV head of query head h is h / q_per_kv: K and V are read in place,
//    never repeated q_per_kv times in memory as the TPU wrapper does.
//  - q, k, v are read through strides (B, S, H) with unit stride along hd;
//    bf16 inputs are widened to f32 as they are staged.  Query tiles are
//    scheduled heaviest first (the causal triangle's long rows).
#include "common.cuh"

#define FA_CAUSAL 0
#define FA_FULL 1
#define FA_WINDOW 2

namespace {

constexpr int FA_BQ = 64;        // query rows per block
constexpr int FA_BK = 64;        // keys per tile
constexpr int FA_THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr float FA_MASKED = -1e30f;
static_assert(FA_BQ == FA_BK, "stage_tile stages q tiles and key tiles alike");

template <int HD>
struct FaLayout {
  static constexpr int LD = HD + 4;          // row stride of the Q / K / V tiles
  static constexpr int PLD = FA_BK + 4;      // row stride of the P tile
  static constexpr int VW = HD >= 64 ? 4 : 2;  // output columns per vector load
  static constexpr int NG = HD / (16 * VW);    // vector groups per thread
  static constexpr int OC = NG * VW;           // output columns per thread
  static constexpr int FLOATS = FA_BQ * LD + FA_BK * LD + FA_BQ * PLD;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  }
}

// Stage rows [row0, row0 + FA_BK) of one head into dst (row stride LD), as
// f32; rows past `rows` are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src,
                                           long long row0, long long rows,
                                           long long row_stride) {
  constexpr int LD = FaLayout<HD>::LD;
  for (int e = threadIdx.x; e < FA_BK * HD; e += FA_THREADS) {
    const int r = e / HD;
    const int c = e % HD;
    const long long row = row0 + r;
    dst[r * LD + c] = row < rows ? cg::to_f32(src[row * row_stride + c]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, long long Sq, long long Sk, int H, int q_per_kv,
             long long qsb, long long qss, long long qsh,
             long long ksb, long long kss, long long ksh,
             long long vsb, long long vss, long long vsh,
             int mask_kind, long long window, long long q_pos0, float scale) {
  using L = FaLayout<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [FA_BQ][LD]
  float* KVs = Qs + FA_BQ * L::LD;        // [FA_BK][LD]: K, then V
  float* Ps = KVs + FA_BK * L::LD;        // [FA_BQ][PLD]

  const float neg_inf = -__int_as_float(0x7f800000);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long n_qt = gridDim.x;
  const long long qt = n_qt - 1 - blockIdx.x;  // heaviest (last) tiles first
  const long long q0 = qt * FA_BQ;
  const int h = blockIdx.y;
  const int hk = h / q_per_kv;
  const long long b = blockIdx.z;

  const T* qh = q + b * qsb + h * qsh;
  const T* kh = k + b * ksb + hk * ksh;
  const T* vh = v + b * vsb + hk * vsh;
  stage_tile<T, HD>(Qs, qh, q0, Sq, qss);

  // the key tiles this block visits: the others are masked for every row
  const long long qlo = q_pos0 + q0;
  const long long q_end = q0 + FA_BQ < Sq ? q0 + FA_BQ : Sq;
  const long long qhi = q_pos0 + q_end - 1;
  const long long n_kt = (Sk + FA_BK - 1) / FA_BK;
  long long kt_begin = 0, kt_end = n_kt;
  if (mask_kind != FA_FULL) {
    kt_end = qhi / FA_BK + 1 < n_kt ? qhi / FA_BK + 1 : n_kt;
    if (mask_kind == FA_WINDOW) {
      const long long first_key = qlo - window + 1;
      kt_begin = first_key > 0 ? first_key / FA_BK : 0;
    }
  }

  float m_run[4], l_run[4], acc[4][L::OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = FA_MASKED;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::OC; ++c) acc[i][c] = 0.f;
  }

  for (long long kt = kt_begin; kt < kt_end; ++kt) {
    const long long k0 = kt * FA_BK;
    __syncthreads();  // the previous tile's V and P are no longer read
    stage_tile<T, HD>(KVs, kh, k0, Sk, kss);
    __syncthreads();

    // scores of rows 4 ty + i against keys tx + 16 j, f32, hd in order
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HD; kk += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&Qs[(4 * ty + i) * L::LD + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bb[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * L::LD + kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bb[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bb[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bb[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bb[j].w, s[i][j]);
        }
    }

    // mask, online softmax update, P into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = qlo + 4 * ty + i;
      float rmax = neg_inf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = k0 + tx + 16 * j;
        bool ok = true;
        if (mask_kind != FA_FULL) ok = kpos <= qpos;
        if (mask_kind == FA_WINDOW) ok = ok && kpos > qpos - window;
        // a key past Sk is absent (weight exactly 0); a masked one is -1e30
        s[i][j] = kpos >= Sk ? neg_inf : (ok ? s[i][j] * scale : FA_MASKED);
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m_run[i], rmax);
      const float corr = expf(m_run[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(4 * ty + i) * L::PLD + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l_run[i] = l_run[i] * corr + rsum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::OC; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // P written, K no longer read
    stage_tile<T, HD>(KVs, vh, k0, Sk, vss);
    __syncthreads();

    // acc += P V over the tile's keys, in key order
#pragma unroll 2
    for (int kk = 0; kk < FA_BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(4 * ty + i) * L::PLD + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float vv[L::OC];
#pragma unroll
        for (int g = 0; g < L::NG; ++g)
          load_vec<L::VW>(&KVs[(kk + t) * L::LD + L::VW * tx + 16 * L::VW * g],
                          vv + g * L::VW);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = t == 0 ? pa[i].x : t == 1 ? pa[i].y : t == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < L::OC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), in the input type, layout (B, Sq, H, hd)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
    T* o = out + ((b * Sq + row) * H + h) * HD;
#pragma unroll
    for (int g = 0; g < L::NG; ++g)
#pragma unroll
      for (int e = 0; e < L::VW; ++e)
        o[L::VW * tx + 16 * L::VW * g + e] = cg::from_f32<T>(acc[i][g * L::VW + e] / denom);
  }
}

template <typename T, int HD>
int launch_flash(const void* q, const void* k, const void* v, void* out, int B,
                 long long Sq, long long Sk, int H, int Hkv, long long qsb,
                 long long qss, long long qsh, long long ksb, long long kss,
                 long long ksh, long long vsb, long long vss, long long vsh,
                 int mask_kind, long long window, long long q_pos0, float scale,
                 cudaStream_t st) {
  const size_t smem = FaLayout<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + FA_BQ - 1) / FA_BQ), (unsigned)H, (unsigned)B);
  flash_kernel<T, HD><<<grid, FA_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, H / Hkv, qsb, qss,
      qsh, ksb, kss, ksh, vsb, vss, vsh, mask_kind, window, q_pos0, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, hd) with element strides (qsb, qss, qsh, 1); k, v: (B, Sk, Hkv,
// hd) with strides (ksb, kss, ksh, 1) and (vsb, vss, vsh, 1); out: contiguous
// (B, Sq, H, hd).  All of one element type, on the current device; hd is 32,
// 64 or 128, Hkv divides H.  Query row i sits at position q_pos0 + i, key j at
// j.  Returns cudaGetLastError() of the launch, or a negative CG_ERR_* code
// when nothing was launched.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, long long Sq, long long Sk,
                                      int H, int Hkv, int hd, long long qsb,
                                      long long qss, long long qsh, long long ksb,
                                      long long kss, long long ksh, long long vsb,
                                      long long vss, long long vsh, int mask_kind,
                                      long long window, long long q_pos0, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H > 65535 || B > 65535 || q_pos0 < 0)
    return CG_ERR_SHAPE;
  if (mask_kind != FA_CAUSAL && mask_kind != FA_FULL && mask_kind != FA_WINDOW)
    return CG_ERR_SHAPE;
  if (mask_kind == FA_WINDOW && window < 1) return CG_ERR_SHAPE;
  if ((Sq + FA_BQ - 1) / FA_BQ > 2147483647LL) return CG_ERR_SHAPE;
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
