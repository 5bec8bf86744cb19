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
//
// coded_encode_acc (the pipelined step's fold into a wire bucket):
//
//   acc[v(, r)] = acc[v(, r)] + out[v(, r)],   acc f32, updated in place
//
// It replaces the TPU kernel's input_output_aliases={0: 0}.  The sum is
// formed from 0 by the same encode_dot as above and then added to acc with
// one __fadd_rn, so the result equals `acc + coded_encode(G, C)` (f32 out)
// bit for bit; seeding the fmaf chain with acc would save an add and round
// differently.  One more f32 read and write per element than the encode.
#include "common.cuh"

namespace {

template <typename TI, typename TO>
__global__ void encode2d_kernel(const TI* __restrict__ G, const float* __restrict__ C,
                                TO* __restrict__ out, int d, long long V, int m) {
  extern __shared__ float coef[];
  cg::load_coef(coef, C, d * m);
  const long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (v >= V) return;
  out[v] = cg::from_f32<TO>(cg::encode_dot(G + v * m, V * (long long)m, 1, coef, d, m));
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
  const float s = cg::encode_dot(G + v * (long long)m * R + r, V * (long long)m * R,
                                 R, coef, d, m);
  out[idx] = cg::from_f32<TO>(s);
}

template <typename TI>
__global__ void encode_acc2d_kernel(const TI* __restrict__ G, const float* __restrict__ C,
                                    float* __restrict__ acc, int d, long long V, int m) {
  extern __shared__ float coef[];
  cg::load_coef(coef, C, d * m);
  const long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (v >= V) return;
  const float s = cg::encode_dot(G + v * m, V * (long long)m, 1, coef, d, m);
  acc[v] = __fadd_rn(acc[v], s);
}

template <typename TI>
__global__ void encode_acc3d_kernel(const TI* __restrict__ G, const float* __restrict__ C,
                                    float* __restrict__ acc, int d, long long V, int m,
                                    long long R) {
  extern __shared__ float coef[];
  cg::load_coef(coef, C, d * m);
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= V * R) return;
  const long long v = idx / R;
  const long long r = idx - v * R;
  const float s = cg::encode_dot(G + v * (long long)m * R + r, V * (long long)m * R,
                                 R, coef, d, m);
  acc[idx] = __fadd_rn(acc[idx], s);
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

// acc: (V) when rank3 == 0, else (V, R), f32, read and written in place;
// G, C as for coded_encode_launch.  All contiguous, on the current device.
// Returns cudaGetLastError() of the launch, or a negative CG_ERR_* code when
// nothing was launched.
extern "C" int coded_encode_acc_launch(const void* G, const void* C, void* acc, int d,
                                       long long V, int m, long long R, int rank3,
                                       int in_dtype, void* stream) {
  if (d <= 0 || m <= 0 || V <= 0 || R <= 0) return CG_ERR_SHAPE;
  const long long total = rank3 ? V * R : V;
  const long long blocks = cg::blocks_for(total);
  if (blocks < 0) return CG_ERR_SHAPE;
  const size_t smem = (size_t)d * m * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define CG_ENCODE_ACC_CALL(TI)                                                      \
  if (rank3)                                                                        \
    encode_acc3d_kernel<TI><<<(unsigned)blocks, CG_THREADS, smem, st>>>(            \
        (const TI*)G, (const float*)C, (float*)acc, d, V, m, R);                    \
  else                                                                              \
    encode_acc2d_kernel<TI><<<(unsigned)blocks, CG_THREADS, smem, st>>>(            \
        (const TI*)G, (const float*)C, (float*)acc, d, V, m);
  switch (in_dtype) {
    case CG_F32: CG_ENCODE_ACC_CALL(float) break;
    case CG_BF16: CG_ENCODE_ACC_CALL(__nv_bfloat16) break;
    default: return CG_ERR_DTYPE;
  }
#undef CG_ENCODE_ACC_CALL
  return (int)cudaGetLastError();
}
