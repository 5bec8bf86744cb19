// Shared helpers of the coded_encode / coded_decode kernels: element type
// codes of the C interface, conversions to and from the f32 accumulator,
// 16-byte loads and stores, the grid of a grid-stride kernel, and the
// per-element encode and decode contractions.
#pragma once

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// element type codes passed through the C interface
#define CG_F32 0
#define CG_BF16 1

// error codes of the launchers that are not cudaError_t values
#define CG_ERR_DTYPE (-1)
#define CG_ERR_SHAPE (-2)
// the vector path was asked for operands it cannot take
#define CG_ERR_PATH (-3)

#define CG_THREADS 256

namespace cg {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round-to-nearest-even, the rounding of a PyTorch cast
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// copy a small coefficient block into shared memory, whole block takes part
__device__ __forceinline__ void load_coef(float* dst, const float* __restrict__ src,
                                          int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) dst[t] = src[t];
  __syncthreads();
}

// number of blocks for `total` threads, or -1 when the grid would overflow
inline long long blocks_for(long long total) {
  long long b = (total + CG_THREADS - 1) / CG_THREADS;
  return b > 2147483647LL ? -1 : b;
}

// an attribute of the current device, read once per device (`fallback`
// where it cannot be read: the H100's value)
template <cudaDeviceAttr A>
inline int device_attr(int fallback) {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return fallback;
  if (cached[dev] == 0 && cudaDeviceGetAttribute(&cached[dev], A, dev) != cudaSuccess)
    return fallback;
  return cached[dev];
}
inline int sm_count() { return device_attr<cudaDevAttrMultiProcessorCount>(132); }
inline long long l2_bytes() { return device_attr<cudaDevAttrL2CacheSize>(50 << 20); }

// Blocks of a grid-stride kernel for `work` thread tasks: no more than fit
// on the card at once (`per_sm`, the kernel's occupancy, queried on its
// first launch).
template <typename K>
unsigned grid_for(K kernel, int& per_sm, long long work, size_t smem) {
  if (per_sm == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, CG_THREADS, smem) !=
           cudaSuccess || per_sm < 1))
    per_sm = 1;
  const long long want = (work + CG_THREADS - 1) / CG_THREADS;
  return (unsigned)std::max(1LL, std::min(want, (long long)per_sm * sm_count()));
}

// 16 bytes of a stream that is read once: evict first
template <typename T>
__device__ __forceinline__ uint4 load16_cs(const T* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ unsigned word(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}
__device__ __forceinline__ unsigned word(const uint2& r, int k) { return k == 0 ? r.x : r.y; }

// element l of a 16- or 8-byte vector V of T, as f32 (the conversion of
// to_f32)
template <typename T, typename V> __device__ __forceinline__ float lane(const V& r, int l) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(r, l));
  } else {
    const unsigned w = word(r, l >> 1);
    return to_f32(__ushort_as_bfloat16((unsigned short)((l & 1) ? w >> 16 : w & 0xffffu)));
  }
}

// N f32 results to N consecutive elements of dst, rounded to TO: 16-byte
// stores where the run is a whole number of 16 bytes (dst 16-byte aligned),
// else 8-byte stores where it is one of 8 (dst 8-byte aligned), else 4-byte
// stores
template <typename TO, int N>
__device__ __forceinline__ void store_run(TO* dst, const float (&s)[N]) {
  static_assert(N * sizeof(TO) % 4 == 0, "a run is a whole number of 4 bytes");
  constexpr int kWords = N * (int)sizeof(TO) / 4;
  unsigned w[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    if constexpr (sizeof(TO) == 4) {
      w[k] = __float_as_uint(s[k]);
    } else {
      w[k] = (unsigned)__bfloat16_as_ushort(from_f32<TO>(s[2 * k])) |
             ((unsigned)__bfloat16_as_ushort(from_f32<TO>(s[2 * k + 1])) << 16);
    }
  }
  unsigned* d = reinterpret_cast<unsigned*>(dst);
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int k = 0; k < kWords; k += 4)
      *reinterpret_cast<uint4*>(d + k) = make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
  } else if constexpr (kWords % 2 == 0) {
#pragma unroll
    for (int k = 0; k < kWords; k += 2)
      *reinterpret_cast<uint2*>(d + k) = make_uint2(w[k], w[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < kWords; ++k) d[k] = w[k];
  }
}

// N consecutive f32 of src (16-byte aligned, N a multiple of 4)
template <int N>
__device__ __forceinline__ void load_f32s(const float* src, float (&a)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(src + k);
    a[k] = x.x; a[k + 1] = x.y; a[k + 2] = x.z; a[k + 3] = x.w;
  }
}

// coefficients held in registers: c[j][u] = C[j, u] for j < d, else 0
template <int M, int DMAX>
__device__ __forceinline__ void load_coef_regs(const float* __restrict__ C, int d,
                                               float (&c)[DMAX][M]) {
#pragma unroll
  for (int j = 0; j < DMAX; ++j)
#pragma unroll
    for (int u = 0; u < M; ++u) c[j][u] = j < d ? __ldg(C + j * M + u) : 0.f;
}

// The encode fold of one output element: sum_{j<d, u<m} g[j*stride_j +
// u*stride_u] * coef[j*m + u], started from 0 and added in (j, u) order with
// fmaf.  The encode kernels' general form calls it; their register form and
// vector path (coded_encode.cu) run the same chain inline, so every path,
// plain or accumulating, rounds an element identically.
template <typename TI>
__device__ __forceinline__ float encode_dot(const TI* g, long long stride_j,
                                            long long stride_u,
                                            const float* coef, int d, int m) {
  float acc = 0.f;
  for (int j = 0; j < d; ++j) {
    const float* cj = coef + j * m;
    for (int u = 0; u < m; ++u) acc = fmaf(to_f32(g[u * stride_u]), cj[u], acc);
    g += stride_j;
  }
  return acc;
}

// The decode contraction of columns [u0, u0 + MC) (masked at m) for one
// element: acc[k] = sum_{i<n} f[i*stride] * wts[i*m + u0 + k], started from
// 0 and added in row order with fmaf.  Shared by every decode kernel, so the
// plain and the fused decode round an element identically.
template <typename TI, int MC>
__device__ __forceinline__ void decode_cols(const TI* f, long long stride,
                                            const float* wts, int n, int m,
                                            int u0, float (&acc)[MC]) {
#pragma unroll
  for (int k = 0; k < MC; ++k) acc[k] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float x = to_f32(*f);
    const float* w = wts + i * m + u0;
#pragma unroll
    for (int k = 0; k < MC; ++k)
      if (u0 + k < m) acc[k] = fmaf(x, w[k], acc[k]);
    f += stride;
  }
}

}  // namespace cg

// Expand `CALL(TI, TO)` for the (input, output) element types named by the
// two codes; sets `rc` to CG_ERR_DTYPE for an unknown code.
#define CG_DISPATCH_OUT(TI, out_code, CALL)              \
  switch (out_code) {                                    \
    case CG_F32: CALL(TI, float); break;                 \
    case CG_BF16: CALL(TI, __nv_bfloat16); break;        \
    default: rc = CG_ERR_DTYPE;                          \
  }

#define CG_DISPATCH(in_code, out_code, CALL)                             \
  switch (in_code) {                                                     \
    case CG_F32: CG_DISPATCH_OUT(float, out_code, CALL) break;           \
    case CG_BF16: CG_DISPATCH_OUT(__nv_bfloat16, out_code, CALL) break;  \
    default: rc = CG_ERR_DTYPE;                                          \
  }
