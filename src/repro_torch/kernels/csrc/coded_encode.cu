// coded_encode for Hopper (sm_90a): the paper's eq. 17/18 fold
//
//   2D: out[v]    = sum_{j<d, u<m} G[j, v, u]    * C[j, u]
//   3D: out[v, r] = sum_{j<d, u<m} G[j, v, u, r] * C[j, u]
//
// A streaming contraction at about one operation per byte, so one read of G
// bounds it.  One thread owns one output element and walks j and u in
// order with an f32 accumulator; C (d*m floats) sits in shared memory.  In
// the 2D layout the (v, u) pair is contiguous, so a warp reads one flat run
// of 32*m elements per j; in the 3D layout r is fastest and a warp reads 32
// neighbouring r for each (j, u).  The ragged tail is masked: no tile has to
// divide V.  All offsets are 64-bit.
#include "common.cuh"

namespace {

template <typename TI, typename TO>
__global__ void encode2d_kernel(const TI* __restrict__ G, const float* __restrict__ C,
                                TO* __restrict__ out, int d, long long V, int m) {
  extern __shared__ float coef[];
  cg::load_coef(coef, C, d * m);
  const long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (v >= V) return;
  const long long stride_j = V * (long long)m;
  const TI* g = G + v * m;
  float acc = 0.f;
  for (int j = 0; j < d; ++j) {
    const float* cj = coef + j * m;
    for (int u = 0; u < m; ++u) acc = fmaf(cg::to_f32(g[u]), cj[u], acc);
    g += stride_j;
  }
  out[v] = cg::from_f32<TO>(acc);
}

template <typename TI, typename TO>
__global__ void encode3d_kernel(const TI* __restrict__ G, const float* __restrict__ C,
                                TO* __restrict__ out, int d, long long V, int m,
                                long long R) {
  extern __shared__ float coef[];
  cg::load_coef(coef, C, d * m);
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= V * R) return;
  const long long v = idx / R;
  const long long r = idx - v * R;
  const long long stride_j = V * (long long)m * R;
  const TI* g = G + v * (long long)m * R + r;
  float acc = 0.f;
  for (int j = 0; j < d; ++j) {
    const float* cj = coef + j * m;
    for (int u = 0; u < m; ++u) acc = fmaf(cg::to_f32(g[u * R]), cj[u], acc);
    g += stride_j;
  }
  out[idx] = cg::from_f32<TO>(acc);
}

}  // namespace

// G: (d, V, m) when rank3 == 0, else (d, V, m, R); C: (d, m) f32; out: (V) or
// (V, R).  All contiguous, on the current device.  Returns cudaGetLastError()
// of the launch, or a negative CG_ERR_* code when nothing was launched.
extern "C" int coded_encode_launch(const void* G, const void* C, void* out, int d,
                                   long long V, int m, long long R, int rank3,
                                   int in_dtype, int out_dtype, void* stream) {
  if (d <= 0 || m <= 0 || V <= 0 || R <= 0) return CG_ERR_SHAPE;
  const long long total = rank3 ? V * R : V;
  const long long blocks = cg::blocks_for(total);
  if (blocks < 0) return CG_ERR_SHAPE;
  const size_t smem = (size_t)d * m * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
#define CG_ENCODE_CALL(TI, TO)                                                      \
  if (rank3)                                                                        \
    encode3d_kernel<TI, TO><<<(unsigned)blocks, CG_THREADS, smem, st>>>(            \
        (const TI*)G, (const float*)C, (TO*)out, d, V, m, R);                       \
  else                                                                              \
    encode2d_kernel<TI, TO><<<(unsigned)blocks, CG_THREADS, smem, st>>>(            \
        (const TI*)G, (const float*)C, (TO*)out, d, V, m);
  CG_DISPATCH(in_dtype, out_dtype, CG_ENCODE_CALL)
#undef CG_ENCODE_CALL
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
