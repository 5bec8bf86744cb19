// coded_decode for Hopper (sm_90a): the paper's eq. 19-21 reconstruction
//
//   2D: out[v, u]    = sum_{i<n} F[i, v]    * W[i, u]
//   3D: out[v, u, r] = sum_{i<n} F[i, v, r] * W[i, u]
//
// A skinny product (m is a handful of columns), so one read of F bounds it.
// One thread owns one v (2D) or one (v, r) (3D): it walks the n rows of F in
// order, coalesced across the warp, and keeps MC f32 accumulators in
// registers; W (n*m floats) sits in shared memory.  m is a run-time value:
// the kernel is compiled for MC in {2, 4, 8} accumulators and walks u in
// chunks of MC, masking the last chunk, so any m works in one launch (F is
// read once when m <= 8 and re-read from cache per chunk above that).  The
// ragged tail over v is masked.  All offsets are 64-bit.
//
// coded_decode_apply (the pipelined step's fused decode + SGD-momentum, 2D):
//
//   g = scale * (F^T W);  mu' = momentum * mu + g;  p' = p - lr * mu'
//
// over the (V, m) f32 bucket views P and MU, written in place, plus sum g^2.
// Bound by bytes as the decode is, plus one read and one write of P and MU.
// The contraction is the decode's own (decode_cols); the update rounds after
// every multiply and add (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc does
// not contract into an FMA), as PyTorch's unfused elementwise ops do, so p'
// and mu' equal coded_decode followed by the optimizer's expressions bit for
// bit.  The TPU kernel adds sum g^2 into one cell across its sequential grid;
// here each block writes its partial (a fixed tree over its threads) and one
// one-block kernel adds the partials in a fixed order: no float atomics, so
// the sum is the same from run to run.
#include "common.cuh"

namespace {

template <typename TI, typename TO, int MC>
__global__ void decode2d_kernel(const TI* __restrict__ F, const float* __restrict__ W,
                                TO* __restrict__ out, int n, long long V, int m) {
  extern __shared__ float wts[];
  cg::load_coef(wts, W, n * m);
  const long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (v >= V) return;
  for (int u0 = 0; u0 < m; u0 += MC) {
    float acc[MC];
    cg::decode_cols<TI, MC>(F + v, V, wts, n, m, u0, acc);
    TO* o = out + v * m + u0;
#pragma unroll
    for (int k = 0; k < MC; ++k)
      if (u0 + k < m) o[k] = cg::from_f32<TO>(acc[k]);
  }
}

template <typename TI, typename TO, int MC>
__global__ void decode3d_kernel(const TI* __restrict__ F, const float* __restrict__ W,
                                TO* __restrict__ out, int n, long long V, int m,
                                long long R) {
  extern __shared__ float wts[];
  cg::load_coef(wts, W, n * m);
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long VR = V * R;
  if (idx >= VR) return;
  const long long v = idx / R;
  const long long r = idx - v * R;
  for (int u0 = 0; u0 < m; u0 += MC) {
    float acc[MC];
    cg::decode_cols<TI, MC>(F + idx, VR, wts, n, m, u0, acc);
    TO* o = out + (v * m + u0) * R + r;
#pragma unroll
    for (int k = 0; k < MC; ++k)
      if (u0 + k < m) o[k * R] = cg::from_f32<TO>(acc[k]);
  }
}

// sum of the CG_THREADS values in red[], in a fixed tree; whole block
__device__ __forceinline__ float block_sum(float* red, float x) {
  red[threadIdx.x] = x;
  __syncthreads();
  for (int s = CG_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  return red[0];
}

template <typename TI, int MC>
__global__ void decode_apply_kernel(const TI* __restrict__ F, const float* __restrict__ W,
                                    float* __restrict__ P, float* __restrict__ MU,
                                    float* __restrict__ partials, int n, long long V,
                                    int m, float lr, float momentum, float scale) {
  extern __shared__ float smem[];      // n*m weights, then CG_THREADS partials
  float* wts = smem;
  cg::load_coef(wts, W, n * m);
  const long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  float ss = 0.f;
  if (v < V) {
    for (int u0 = 0; u0 < m; u0 += MC) {
      float acc[MC];
      cg::decode_cols<TI, MC>(F + v, V, wts, n, m, u0, acc);
      float* p = P + v * m + u0;
      float* mu = MU + v * m + u0;
#pragma unroll
      for (int k = 0; k < MC; ++k) {
        if (u0 + k < m) {
          const float g = __fmul_rn(acc[k], scale);
          const float mun = __fadd_rn(__fmul_rn(momentum, mu[k]), g);
          p[k] = __fsub_rn(p[k], __fmul_rn(lr, mun));
          mu[k] = mun;
          ss = __fmaf_rn(g, g, ss);
        }
      }
    }
  }
  const float total = block_sum(smem + n * m, ss);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void sum_partials_kernel(const float* __restrict__ partials, long long count,
                                    float* __restrict__ out) {
  __shared__ float red[CG_THREADS];
  float s = 0.f;
  for (long long t = threadIdx.x; t < count; t += CG_THREADS) s = __fadd_rn(s, partials[t]);
  const float total = block_sum(red, s);
  if (threadIdx.x == 0) *out = total;
}

}  // namespace

// F: (n, V) when rank3 == 0, else (n, V, R); W: (n, m) f32; out: (V, m) or
// (V, m, R).  All contiguous, on the current device.  Returns
// cudaGetLastError() of the launch, or a negative CG_ERR_* code when nothing
// was launched.
extern "C" int coded_decode_launch(const void* F, const void* W, void* out, int n,
                                   long long V, int m, long long R, int rank3,
                                   int in_dtype, int out_dtype, void* stream) {
  if (n <= 0 || m <= 0 || V <= 0 || R <= 0) return CG_ERR_SHAPE;
  const long long total = rank3 ? V * R : V;
  const long long blocks = cg::blocks_for(total);
  if (blocks < 0) return CG_ERR_SHAPE;
  const size_t smem = (size_t)n * m * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
#define CG_DECODE_LAUNCH(TI, TO, MC)                                                \
  if (rank3)                                                                        \
    decode3d_kernel<TI, TO, MC><<<(unsigned)blocks, CG_THREADS, smem, st>>>(        \
        (const TI*)F, (const float*)W, (TO*)out, n, V, m, R);                       \
  else                                                                              \
    decode2d_kernel<TI, TO, MC><<<(unsigned)blocks, CG_THREADS, smem, st>>>(        \
        (const TI*)F, (const float*)W, (TO*)out, n, V, m);
#define CG_DECODE_CALL(TI, TO)                                                      \
  if (m <= 2) {                                                                     \
    CG_DECODE_LAUNCH(TI, TO, 2)                                                     \
  } else if (m <= 4) {                                                              \
    CG_DECODE_LAUNCH(TI, TO, 4)                                                     \
  } else {                                                                          \
    CG_DECODE_LAUNCH(TI, TO, 8)                                                     \
  }
  CG_DISPATCH(in_dtype, out_dtype, CG_DECODE_CALL)
#undef CG_DECODE_CALL
#undef CG_DECODE_LAUNCH
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// F: (n, V) in_dtype; W: (n, m) f32; P, MU: (V, m) f32, overwritten with p'
// and mu'; partials: num_partials f32 of scratch, at least one per block of
// CG_THREADS over V; ss: one f32, set to sum g^2.  All contiguous, on the
// current device.  Two launches (the fused pass, then the one-block sum of
// the partials) in stream order.  Returns cudaGetLastError(), or a negative
// CG_ERR_* code when nothing was launched.
extern "C" int coded_decode_apply_launch(const void* F, const void* W, void* P, void* MU,
                                         void* partials, void* ss, int n, long long V,
                                         int m, float lr, float momentum, float scale,
                                         int in_dtype, long long num_partials,
                                         void* stream) {
  if (n <= 0 || m <= 0 || V <= 0) return CG_ERR_SHAPE;
  const long long blocks = cg::blocks_for(V);
  if (blocks < 0 || blocks > num_partials) return CG_ERR_SHAPE;
  const size_t smem = ((size_t)n * m + CG_THREADS) * sizeof(float);
  if (smem > 48 * 1024) return CG_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
#define CG_APPLY_LAUNCH(TI, MC)                                                     \
  decode_apply_kernel<TI, MC><<<(unsigned)blocks, CG_THREADS, smem, st>>>(          \
      (const TI*)F, (const float*)W, (float*)P, (float*)MU, (float*)partials, n, V, \
      m, lr, momentum, scale);
#define CG_APPLY_CALL(TI)                                                           \
  if (m <= 2) {                                                                     \
    CG_APPLY_LAUNCH(TI, 2)                                                          \
  } else if (m <= 4) {                                                              \
    CG_APPLY_LAUNCH(TI, 4)                                                          \
  } else {                                                                          \
    CG_APPLY_LAUNCH(TI, 8)                                                          \
  }
  switch (in_dtype) {
    case CG_F32: CG_APPLY_CALL(float) break;
    case CG_BF16: CG_APPLY_CALL(__nv_bfloat16) break;
    default: return CG_ERR_DTYPE;
  }
#undef CG_APPLY_CALL
#undef CG_APPLY_LAUNCH
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  sum_partials_kernel<<<1, CG_THREADS, 0, st>>>((const float*)partials, blocks, (float*)ss);
  return (int)cudaGetLastError();
}
