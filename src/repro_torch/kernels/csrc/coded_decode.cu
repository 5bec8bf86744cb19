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
#pragma unroll
    for (int k = 0; k < MC; ++k) acc[k] = 0.f;
    const TI* f = F + v;
    for (int i = 0; i < n; ++i) {
      const float x = cg::to_f32(*f);
      const float* w = wts + i * m + u0;
#pragma unroll
      for (int k = 0; k < MC; ++k)
        if (u0 + k < m) acc[k] = fmaf(x, w[k], acc[k]);
      f += V;
    }
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
#pragma unroll
    for (int k = 0; k < MC; ++k) acc[k] = 0.f;
    const TI* f = F + idx;
    for (int i = 0; i < n; ++i) {
      const float x = cg::to_f32(*f);
      const float* w = wts + i * m + u0;
#pragma unroll
      for (int k = 0; k < MC; ++k)
        if (u0 + k < m) acc[k] = fmaf(x, w[k], acc[k]);
      f += VR;
    }
    TO* o = out + (v * m + u0) * R + r;
#pragma unroll
    for (int k = 0; k < MC; ++k)
      if (u0 + k < m) o[k * R] = cg::from_f32<TO>(acc[k]);
  }
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
