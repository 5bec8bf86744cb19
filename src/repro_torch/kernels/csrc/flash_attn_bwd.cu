// flash_attention backward for Hopper (sm_90a): dQ, dK, dV of the forward in
// flash_attn.cu, in the model layout (B, S, H, hd), grouped-query heads, on
// the CUDA cores, deterministic (no atomics).
//
// The TPU kernel src/repro/kernels/flash_attn.py is forward only; the
// reference differentiates its oracle, online_attention
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
// lse).  The sums over the query heads of one KV head (GQA) run inside one
// block.
//
// Three kernels, launched in order on one stream:
//  1. dot: D = rowsum(dO o O) in f32, one warp a (b, i, h) row;
//  2. dkdv: one block per (64 keys, KV head, batch).  K and V stay in shared
//     memory; the block walks the q_per_kv query heads of its KV head and,
//     for each, the query tiles of 64 rows that see its keys, recomputes S
//     and P, and accumulates dV += P^T dO and dK += dS^T Q in registers;
//  3. dq: one block per (64 query rows, head, batch).  Q and dO stay in
//     shared memory; the block walks the key tiles its rows see, recomputes
//     S, P, dP and dS, and accumulates dQ += dS K in registers.
// dQ is not summed across the key blocks of kernel 2 (that would need float
// atomics, whose order changes from run to run), so S and dP are computed
// twice: 7 products of 2 x (pairs) x hd operations where 5 would do.
//
// What bounds it.  At the 4096-token causal shape of qwen3-1.7b (H = 16,
// Hkv = 8, hd = 128) one product over the causal pairs is 34.4 GFLOP, the
// five the gradient needs 171.8 GFLOP: 2.56 ms at the H100 SXM's 67 TFLOP/s
// of f32 outside the tensor cores, 1.04 ms as 3xTF32 on them.  This kernel
// does 7 on the CUDA cores.  Every tile is held in f32 in shared memory
// (bf16 inputs are widened as they are loaded), a row padded by 4 floats so
// that 16-byte reads of 8 neighbouring rows fall on distinct banks.  A
// thread computes a 4 x 4 block of a 64 x 64 score tile from 16-byte reads
// of both operands (rows 16 apart), and an (hd / 16) x 4 block of a 64 x hd
// product.  Tiles that the mask empties are skipped, as in the forward;
// heaviest tiles are scheduled first.  The tensor cores are later work.
//
// Shared memory a block (f32 whatever the input type):
//   dkdv: K, V, Q, dO (64 x (hd + 4)) + P, dS (64 x 68) + lse, D (64) =
//         170,496 bytes at hd 128, 104,960 at 64, 72,192 at 32;
//   dq:   Q, dO, K, V + dS^T + lse, D = 153,088 bytes at hd 128.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

#define FB_CAUSAL 0
#define FB_FULL 1
#define FB_WINDOW 2

namespace {

constexpr int FB_T = 64;         // rows of a query tile and of a key tile
constexpr int FB_THREADS = 256;
constexpr int FB_LDP = FB_T + 4;  // row stride of the P / dS tiles

template <int HD>
struct FbCfg {
  static constexpr int LD = HD + 4;        // row stride of a (64, hd) tile
  static constexpr int NPT = HD / 16;      // product rows a thread owns
  static constexpr int TD = HD / 4;        // threads along hd (4 columns each)
  static constexpr int TILE = FB_T * LD;   // floats of one (64, hd) tile
  static constexpr int PT = FB_T * FB_LDP; // floats of one P / dS tile
  static constexpr int DKDV_FLOATS = 4 * TILE + 2 * PT + 2 * FB_T;
  static constexpr int DQ_FLOATS = 4 * TILE + PT + 2 * FB_T;
  static_assert(HD % 32 == 0 && HD <= 128, "hd is 32, 64 or 128");
};

// rows [row0, row0 + 64) of one head, hd contiguous, element stride ss
// between rows, into a (64, LD) f32 tile; rows at or past `rows` are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long row0,
                                          long long rows, long long ss) {
  constexpr int VE = 16 / (int)sizeof(T);   // elements in 16 bytes
  constexpr int VPR = HD / VE;
  constexpr int LD = FbCfg<HD>::LD;
  for (int idx = threadIdx.x; idx < FB_T * VPR; idx += FB_THREADS) {
    const int r = idx / VPR, c = (idx % VPR) * VE;
    float v[VE];
    if (row0 + r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c);
#pragma unroll
      for (int l = 0; l < VE; ++l) v[l] = cg::lane<T>(raw, l);
    } else {
#pragma unroll
      for (int l = 0; l < VE; ++l) v[l] = 0.f;
    }
#pragma unroll
    for (int l = 0; l < VE; l += 4)
      *reinterpret_cast<float4*>(dst + r * LD + c + l) = make_float4(v[l], v[l + 1], v[l + 2], v[l + 3]);
  }
}

// acc[a][c] = A[ty + 16 a] . B[tx + 16 c] over hd: a 64 x 64 block of
// products of rows of two (64, LD) tiles
template <int HD>
__device__ __forceinline__ void mm_rows(const float* A, const float* Bm, float (&acc)[4][4],
                                        int ty, int tx) {
  constexpr int LD = FbCfg<HD>::LD;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * c) * LD + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[a][c];
        s = fmaf(av[a].x, bv[c].x, s);
        s = fmaf(av[a].y, bv[c].y, s);
        s = fmaf(av[a].z, bv[c].z, s);
        s = fmaf(av[a].w, bv[c].w, s);
        acc[a][c] = s;
      }
  }
}

// acc[e][c] += sum_r X[r][tn NPT + e] Y[r][4 td + c] over the 64 rows r of
// a (64, FB_LDP) tile X and a (64, LD) tile Y
template <int HD>
__device__ __forceinline__ void mm_cols(const float* X, const float* Y,
                                        float (&acc)[FbCfg<HD>::NPT][4], int tn, int td) {
  constexpr int LD = FbCfg<HD>::LD, NPT = FbCfg<HD>::NPT;
#pragma unroll 4
  for (int r = 0; r < FB_T; ++r) {
    float x[NPT];
    const float* xr = X + r * FB_LDP + tn * NPT;
    if constexpr (NPT == 2) {
      const float2 t = *reinterpret_cast<const float2*>(xr);
      x[0] = t.x; x[1] = t.y;
    } else {
#pragma unroll
      for (int e = 0; e < NPT; e += 4) {
        const float4 t = *reinterpret_cast<const float4*>(xr + e);
        x[e] = t.x; x[e + 1] = t.y; x[e + 2] = t.z; x[e + 3] = t.w;
      }
    }
    const float4 y = *reinterpret_cast<const float4*>(Y + r * LD + 4 * td);
#pragma unroll
    for (int e = 0; e < NPT; ++e) {
      acc[e][0] = fmaf(x[e], y.x, acc[e][0]);
      acc[e][1] = fmaf(x[e], y.y, acc[e][1]);
      acc[e][2] = fmaf(x[e], y.z, acc[e][2]);
      acc[e][3] = fmaf(x[e], y.w, acc[e][3]);
    }
  }
}

__device__ __forceinline__ bool admitted(long long kpos, long long qpos, int mask_kind,
                                         long long window) {
  if (mask_kind == FB_FULL) return true;
  if (kpos > qpos) return false;
  return mask_kind != FB_WINDOW || kpos > qpos - window;
}

// `scale` times the rows the thread owns, in T, into rows [row0, row0 + 64)
// of a contiguous (B, S, heads, hd) output (rows at or past `rows` skipped)
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[FbCfg<HD>::NPT][4],
                                           float scale, long long row0, long long rows,
                                           long long row_stride, int tn, int td) {
#pragma unroll
  for (int e = 0; e < FbCfg<HD>::NPT; ++e) {
    const long long r = row0 + tn * FbCfg<HD>::NPT + e;
    if (r >= rows) continue;
    const float v[4] = {acc[e][0] * scale, acc[e][1] * scale, acc[e][2] * scale,
                        acc[e][3] * scale};
    cg::store_run<T, 4>(dst + r * row_stride + 4 * td, v);
  }
}

// D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d]; dO and O contiguous
template <typename T, int HD>
__global__ void __launch_bounds__(FB_THREADS)
fb_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
              long long rows, int Sq, int H) {
  const long long row = (long long)blockIdx.x * (FB_THREADS / 32) + threadIdx.x / 32;
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

template <typename T, int HD>
__global__ void __launch_bounds__(FB_THREADS, 1)
fb_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv, int Sq,
               int Sk, int H, int Hkv, long long qsb, long long qss, long long qsh,
               long long ksb, long long kss, long long ksh, long long vsb, long long vss,
               long long vsh, int mask_kind, long long window, long long q_pos0,
               float scale, float scale_log2) {
  using C = FbCfg<HD>;
  extern __shared__ __align__(16) float fb_smem[];
  float* Ks = fb_smem;
  float* Vs = Ks + C::TILE;
  float* Qs = Vs + C::TILE;
  float* Gs = Qs + C::TILE;   // dO
  float* Ps = Gs + C::TILE;   // P[i][j]
  float* Ds = Ps + C::PT;     // dS[i][j]
  float* lse_s = Ds + C::PT;
  float* dsum_s = lse_s + FB_T;

  const int hk = (int)(blockIdx.x % Hkv);
  const int kt = (int)(blockIdx.x / Hkv);   // low key tiles, the heaviest, first
  const int b = blockIdx.y;
  const int q_per_kv = H / Hkv;
  const long long k0 = (long long)kt * FB_T;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int td = tid % C::TD, tn = tid / C::TD;

  // the query rows that see a key of this tile
  long long i_begin = 0, i_end = Sq;
  if (mask_kind != FB_FULL) {
    i_begin = k0 - q_pos0 > 0 ? k0 - q_pos0 : 0;
    if (mask_kind == FB_WINDOW) {
      const long long k_last = (k0 + FB_T < Sk ? k0 + FB_T : Sk) - 1;
      const long long e = k_last + window - q_pos0;
      i_end = e < Sq ? e : Sq;
    }
  }
  const int qt_begin = (int)(i_begin / FB_T);
  const int qt_end = i_end > i_begin ? (int)((i_end + FB_T - 1) / FB_T) : qt_begin;

  load_tile<T, HD>(Ks, k + b * ksb + hk * ksh, k0, Sk, kss);
  load_tile<T, HD>(Vs, v + b * vsb + hk * vsh, k0, Sk, vss);

  float dk_acc[C::NPT][4], dv_acc[C::NPT][4];
#pragma unroll
  for (int e = 0; e < C::NPT; ++e)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[e][c] = dv_acc[e][c] = 0.f;

  const long long gss = (long long)H * HD;  // row stride of dO (contiguous)
  for (int g = 0; g < q_per_kv; ++g) {
    const int h = hk * q_per_kv + g;
    const float* lse_h = lse + ((long long)b * H + h) * Sq;
    const float* dsum_h = dsum + ((long long)b * H + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const long long q0 = (long long)qt * FB_T;
      __syncthreads();   // the previous tile's Q, dO, P, dS are read
      load_tile<T, HD>(Qs, q + b * qsb + h * qsh, q0, Sq, qss);
      load_tile<T, HD>(Gs, dout + (long long)b * Sq * gss + (long long)h * HD, q0, Sq, gss);
      if (tid < FB_T) {
        const bool in = q0 + tid < Sq;
        lse_s[tid] = in ? lse_h[q0 + tid] : 0.f;
        dsum_s[tid] = in ? dsum_h[q0 + tid] : 0.f;
      }
      __syncthreads();
      // S^T (key j = ty + 16 a, query i = tx + 16 c), then P
      float p[4][4], dp[4][4];
      mm_rows<HD>(Ks, Qs, p, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const long long kpos = k0 + ty + 16 * a;
          const long long qrow = q0 + tx + 16 * c;
          const bool ok = kpos < Sk && qrow < Sq &&
                          admitted(kpos, q_pos0 + qrow, mask_kind, window);
          p[a][c] = ok ? exp2f(p[a][c] * scale_log2 - lse_s[tx + 16 * c]) : 0.f;
        }
      mm_rows<HD>(Vs, Gs, dp, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = tx + 16 * c, j = ty + 16 * a;
          Ps[i * FB_LDP + j] = p[a][c];
          Ds[i * FB_LDP + j] = p[a][c] * (dp[a][c] - dsum_s[i]);
        }
      __syncthreads();
      mm_cols<HD>(Ps, Gs, dv_acc, tn, td);
      mm_cols<HD>(Ds, Qs, dk_acc, tn, td);
    }
  }
  const long long kvrow = (long long)Hkv * HD;
  store_rows<T, HD>(dk + (long long)b * Sk * kvrow + hk * HD, dk_acc, scale, k0, Sk, kvrow, tn, td);
  store_rows<T, HD>(dv + (long long)b * Sk * kvrow + hk * HD, dv_acc, 1.f, k0, Sk, kvrow, tn, td);
}

template <typename T, int HD>
__global__ void __launch_bounds__(FB_THREADS, 1)
fb_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ dsum, T* __restrict__ dq, int Sq, int Sk, int H,
             int Hkv, int n_qt, long long qsb, long long qss, long long qsh, long long ksb,
             long long kss, long long ksh, long long vsb, long long vss, long long vsh,
             int mask_kind, long long window, long long q_pos0, float scale,
             float scale_log2) {
  using C = FbCfg<HD>;
  extern __shared__ __align__(16) float fb_smem[];
  float* Qs = fb_smem;
  float* Gs = Qs + C::TILE;   // dO
  float* Ks = Gs + C::TILE;
  float* Vs = Ks + C::TILE;
  float* St = Vs + C::TILE;   // dS^T[j][i]
  float* lse_s = St + C::PT;
  float* dsum_s = lse_s + FB_T;

  const int qt = n_qt - 1 - (int)(blockIdx.x / H);  // heaviest query tiles first
  const int h = (int)(blockIdx.x % H);
  const int hk = h / (H / Hkv);
  const int b = blockIdx.y;
  const long long q0 = (long long)qt * FB_T;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int td = tid % C::TD, tn = tid / C::TD;

  // the key tiles this block's rows see
  const long long q_last = q_pos0 + (q0 + FB_T < Sq ? q0 + FB_T : Sq) - 1;
  const int n_kt = (Sk + FB_T - 1) / FB_T;
  int kt_begin = 0, kt_end = n_kt;
  if (mask_kind != FB_FULL) {
    kt_end = q_last / FB_T + 1 < n_kt ? (int)(q_last / FB_T + 1) : n_kt;
    if (mask_kind == FB_WINDOW) {
      const long long first_key = q_pos0 + q0 - window + 1;
      kt_begin = first_key > 0 ? (int)(first_key / FB_T) : 0;
    }
  }

  const long long gss = (long long)H * HD;
  load_tile<T, HD>(Qs, q + b * qsb + h * qsh, q0, Sq, qss);
  load_tile<T, HD>(Gs, dout + (long long)b * Sq * gss + (long long)h * HD, q0, Sq, gss);
  if (tid < FB_T) {
    const bool in = q0 + tid < Sq;
    const long long off = ((long long)b * H + h) * Sq + q0 + tid;
    lse_s[tid] = in ? lse[off] : 0.f;
    dsum_s[tid] = in ? dsum[off] : 0.f;
  }

  float dq_acc[C::NPT][4];
#pragma unroll
  for (int e = 0; e < C::NPT; ++e)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq_acc[e][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const long long k0 = (long long)kt * FB_T;
    __syncthreads();   // the previous tile's K, V, dS^T are read
    load_tile<T, HD>(Ks, k + b * ksb + hk * ksh, k0, Sk, kss);
    load_tile<T, HD>(Vs, v + b * vsb + hk * vsh, k0, Sk, vss);
    __syncthreads();
    // S (query i = ty + 16 a, key j = tx + 16 c), P, dP, dS
    float p[4][4], dp[4][4];
    mm_rows<HD>(Qs, Ks, p, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long qrow = q0 + ty + 16 * a;
        const long long kpos = k0 + tx + 16 * c;
        const bool ok = kpos < Sk && qrow < Sq &&
                        admitted(kpos, q_pos0 + qrow, mask_kind, window);
        p[a][c] = ok ? exp2f(p[a][c] * scale_log2 - lse_s[ty + 16 * a]) : 0.f;
      }
    mm_rows<HD>(Gs, Vs, dp, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty + 16 * a, j = tx + 16 * c;
        St[j * FB_LDP + i] = p[a][c] * (dp[a][c] - dsum_s[i]);
      }
    __syncthreads();
    mm_cols<HD>(St, Ks, dq_acc, tn, td);
  }
  store_rows<T, HD>(dq + (long long)b * Sq * gss + (long long)h * HD, dq_acc, scale, q0, Sq,
                    gss, tn, td);
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dq, void* dk, void* dv, void* dsum, int B, long long Sq,
               long long Sk, int H, int Hkv, long long qsb, long long qss, long long qsh,
               long long ksb, long long kss, long long ksh, long long vsb, long long vss,
               long long vsh, int mask_kind, long long window, long long q_pos0, float scale,
               cudaStream_t st) {
  using C = FbCfg<HD>;
  const float scale_log2 = scale * 1.4426950408889634f;
  const long long rows = (long long)B * Sq * H;
  const long long dot_blocks = (rows + FB_THREADS / 32 - 1) / (FB_THREADS / 32);
  if (dot_blocks > 2147483647LL) return CG_ERR_SHAPE;
  fb_dot_kernel<T, HD><<<(unsigned)dot_blocks, FB_THREADS, 0, st>>>(
      (const T*)o, (const T*)dout, (float*)dsum, rows, (int)Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int dkdv_smem = C::DKDV_FLOATS * (int)sizeof(float);
  err = cudaFuncSetAttribute(fb_dkdv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_kt = (Sk + FB_T - 1) / FB_T;
  fb_dkdv_kernel<T, HD><<<dim3((unsigned)(n_kt * Hkv), (unsigned)B), FB_THREADS, dkdv_smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)dsum, (T*)dk, (T*)dv, (int)Sq, (int)Sk, H, Hkv, qsb, qss, qsh, ksb, kss,
      ksh, vsb, vss, vsh, mask_kind, window, q_pos0, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int dq_smem = C::DQ_FLOATS * (int)sizeof(float);
  err = cudaFuncSetAttribute(fb_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (int)((Sq + FB_T - 1) / FB_T);
  fb_dq_kernel<T, HD><<<dim3((unsigned)(n_qt * H), (unsigned)B), FB_THREADS, dq_smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)dsum, (T*)dq, (int)Sq, (int)Sk, H, Hkv, n_qt, qsb, qss, qsh, ksb, kss, ksh,
      vsb, vss, vsh, mask_kind, window, q_pos0, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Gradients of flash_attention_launch's output.  q: (B, Sq, H, hd) with
// element strides (qsb, qss, qsh, 1); k, v: (B, Sk, Hkv, hd) with strides
// (ksb, kss, ksh, 1) and (vsb, vss, vsh, 1); o (the forward's output) and
// dout: contiguous (B, Sq, H, hd); lse: the forward's (B, H, Sq) f32 in
// log2 units; dsum: (B, H, Sq) f32 scratch.  Writes dq contiguous (B, Sq,
// H, hd) and dk, dv contiguous (B, Sk, Hkv, hd), in the input type.  Every
// base and row stride a multiple of 16 bytes.  The mask, q_pos0 and scale
// as in the forward.  Returns cudaGetLastError() of the last launch, or a
// negative CG_ERR_* when nothing was launched.
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
  if (mask_kind != FB_CAUSAL && mask_kind != FB_FULL && mask_kind != FB_WINDOW)
    return CG_ERR_SHAPE;
  if (mask_kind == FB_WINDOW && window < 1) return CG_ERR_SHAPE;
  if ((Sq + FB_T - 1) / FB_T * H > 2147483647LL || (Sk + FB_T - 1) / FB_T * Hkv > 2147483647LL)
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
