// Shared helpers of the coded_encode / coded_decode kernels: element type
// codes of the C interface, conversions to and from the f32 accumulator, and
// the per-element encode and decode contractions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// element type codes passed through the C interface
#define CG_F32 0
#define CG_BF16 1

// error codes of the launchers that are not cudaError_t values
#define CG_ERR_DTYPE (-1)
#define CG_ERR_SHAPE (-2)

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
