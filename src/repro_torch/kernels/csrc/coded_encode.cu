// coded_encode for Hopper (sm_90a): the paper's eq. 17/18 fold
//
//   2D: out[v]    = sum_{j<d, u<m} G[j, v, u]    * C[j, u]
//   3D: out[v, r] = sum_{j<d, u<m} G[j, v, u, r] * C[j, u]
//
// Replaces the TPU kernels coded_encode (_encode_kernel_2d / _3d) and
// coded_encode_acc (_encode_acc_kernel_2d / _3d) of
// src/repro/kernels/coded_encode.py.
//
// Bound: bytes.  About 0.5 operation per byte moved, so one read of G and
// one write of the output, d*V*m*R*sizeof(in) + V*R*sizeof(out) over
// 3.35 TB/s, bound it (the accumulating form reads and writes acc, f32).
// No tensor cores and no TMA: what limits a stream is bytes in flight and
// the fixed cost of each block, not instruction issue.  The design:
//
//  - Grid-stride blocks sized to the card: at most as many blocks as fit on
//    the SMs at once (occupancy queried once per kernel), each looping over
//    many outputs.  For d*m <= 8 and m <= 4 the coefficients go straight
//    into registers (no shared-memory round trip before the first load of
//    G); the general (d, m) case keeps them in shared memory.
//  - 16-byte loads along the contiguous axis, G read with the evict-first
//    hint (__ldcs: used once).  3D: a thread owns P = 16 / sizeof(in)
//    neighbouring r and reads one vector per (j, u).  2D: a thread owns P
//    consecutive v, whose interleaved (v, u) run is m vectors per j.  Two
//    items a thread per loop step, so that 2 or more vectors are in flight.
//    acc and out are read and written without a hint: the next operation
//    reads them.
//  - No division per element: 3D items are walked as (row, vector) pairs
//    advanced by the grid stride with a carry.
//  - A scalar path in the same kernel takes a V tail (2D), an R that is no
//    multiple of P, a base that is not 16-byte aligned, or (2D, d > 1) G[j]
//    slabs that are not: the caller picks the path from shapes and
//    data_ptr() (kernels/coded_encode.py, encode_path), and the launcher
//    refuses the vector path for operands it cannot take.
//
// Every output element, on every path, is the same chain: fmaf from 0 over
// (j, u) in order, in f32, rounded once to out's type; so the two paths,
// and the one-thread-per-element kernels this design replaced, agree bit
// for bit.
//
// coded_encode_acc (the pipelined step's fold into a wire bucket):
//
//   acc[v(, r)] = acc[v(, r)] + out[v(, r)],   acc f32, updated in place
//
// It replaces the TPU kernel's input_output_aliases={0: 0}.  The sum is
// formed from 0 by the same chain and then added to acc with one
// __fadd_rn, so the result equals `acc + coded_encode(G, C)` (f32 out) bit
// for bit; seeding the chain with acc would save an add and round
// differently.
#include "common.cuh"

namespace {

constexpr int kRegTerms = 8;   // d*m up to this: coefficients in registers
constexpr int kMaxRegM = 4;    // ... and m up to this (the 2D lanes are static)

// write the P sums of one item: to out, or added into acc (read ahead as a)
template <typename TO, bool ACC, int P>
__device__ __forceinline__ void finish_vec(TO* o, float (&s)[P], const float (&a)[P]) {
  if constexpr (ACC) {
#pragma unroll
    for (int p = 0; p < P; ++p) s[p] = __fadd_rn(a[p], s[p]);
  }
  cg::store_run<TO, P>(o, s);
}

template <typename TO, bool ACC>
__device__ __forceinline__ void finish(TO* o, float s) {
  if constexpr (ACC) *o = __fadd_rn(*o, s);
  else *o = cg::from_f32<TO>(s);
}

// Position (v, k) on a grid of rows of K items, advanced by a fixed stride
// of items with a carry: one division when a thread starts, none per step.
struct Walk {
  long long v, k, dv, dk, K;
  __device__ __forceinline__ Walk(long long q, long long stride, long long K_) : K(K_) {
    v = q / K; k = q - v * K;
    dv = stride / K; dk = stride - dv * K;
  }
  __device__ __forceinline__ void next() {
    v += dv; k += dk;
    if (k >= K) { k -= K; ++v; }
  }
};

// The 3D fold, out (V, R).  M > 0: m == M with d <= kRegTerms / M,
// coefficients in registers, the vector path when `vec`; M == 0: any (d,
// m), coefficients in shared memory, scalar only.
template <typename TI, typename TO, bool ACC, int M>
__global__ void __launch_bounds__(CG_THREADS)
encode3d_kernel(const TI* __restrict__ G, const float* __restrict__ C,
                TO* __restrict__ out, int d, long long V, int m, long long R, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long sj = V * m * R;                  // G's stride over j
  if constexpr (M == 0) {
    extern __shared__ float coef[];
    cg::load_coef(coef, C, d * m);
    for (Walk w(tid, stride, R); w.v < V; w.next())
      finish<TO, ACC>(out + w.v * R + w.k,
                      cg::encode_dot(G + w.v * m * R + w.k, sj, R, coef, d, m));
  } else {
    constexpr int DMAX = kRegTerms / M;
    float c[DMAX][M];
    cg::load_coef_regs<M, DMAX>(C, d, c);
    if (vec) {
      constexpr int P = 16 / sizeof(TI);
      Walk a(tid, stride, R / P);
      while (a.v < V) {
        Walk b = a;
        b.next();
        const bool hb = b.v < V;
        const TI* ga = G + a.v * M * R + a.k * P;
        const TI* gb = G + b.v * M * R + b.k * P;
        TO* oa = out + a.v * R + a.k * P;
        TO* ob = out + b.v * R + b.k * P;
        uint4 xa[DMAX][M], xb[DMAX][M];
        float acc_a[P], acc_b[P];
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
#pragma unroll
          for (int u = 0; u < M; ++u)
            if (j < d) {
              xa[j][u] = cg::load16_cs(ga + j * sj + u * R);
              if (hb) xb[j][u] = cg::load16_cs(gb + j * sj + u * R);
            }
        if constexpr (ACC) {
          cg::load_f32s<P>(oa, acc_a);
          if (hb) cg::load_f32s<P>(ob, acc_b);
        }
        float sa[P], sb[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          sa[p] = 0.f; sb[p] = 0.f;
#pragma unroll
          for (int j = 0; j < DMAX; ++j)
#pragma unroll
            for (int u = 0; u < M; ++u)
              if (j < d) {
                sa[p] = fmaf(cg::lane<TI>(xa[j][u], p), c[j][u], sa[p]);
                sb[p] = fmaf(cg::lane<TI>(xb[j][u], p), c[j][u], sb[p]);
              }
        }
        finish_vec<TO, ACC, P>(oa, sa, acc_a);
        if (hb) finish_vec<TO, ACC, P>(ob, sb, acc_b);
        a = b;
        a.next();
      }
    } else {
      for (Walk w(tid, stride, R); w.v < V; w.next()) {
        const TI* g = G + w.v * M * R + w.k;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
#pragma unroll
          for (int u = 0; u < M; ++u)
            if (j < d) s = fmaf(cg::to_f32(g[j * sj + u * R]), c[j][u], s);
        finish<TO, ACC>(out + w.v * R + w.k, s);
      }
    }
  }
}

// The 2D fold, out (V,).  M as for encode3d_kernel.  The vector path covers
// the first V - V % P outputs; the scalar loop takes the tail, or all of V.
template <typename TI, typename TO, bool ACC, int M>
__global__ void __launch_bounds__(CG_THREADS)
encode2d_kernel(const TI* __restrict__ G, const float* __restrict__ C,
                TO* __restrict__ out, int d, long long V, int m, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long sj = V * m;                      // G's stride over j
  if constexpr (M == 0) {
    extern __shared__ float coef[];
    cg::load_coef(coef, C, d * m);
    for (long long v = tid; v < V; v += stride)
      finish<TO, ACC>(out + v, cg::encode_dot(G + v * m, sj, 1, coef, d, m));
  } else {
    constexpr int DMAX = kRegTerms / M;
    float c[DMAX][M];
    cg::load_coef_regs<M, DMAX>(C, d, c);
    long long v0 = 0;                              // first output of the scalar loop
    if (vec) {
      // item q: outputs [qP, qP + P), whose (v, u) run of P*M elements is
      // M vectors per j; element (p, u) is lane (p*M + u) % P of vector
      // (p*M + u) / P
      constexpr int P = 16 / sizeof(TI);
      const long long items = V / P;
      for (long long qa = tid; qa < items; qa += 2 * stride) {
        const long long qb = qa + stride;
        const bool hb = qb < items;
        uint4 xa[DMAX][M], xb[DMAX][M];
        float acc_a[P], acc_b[P];
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
#pragma unroll
          for (int w = 0; w < M; ++w)
            if (j < d) {
              xa[j][w] = cg::load16_cs(G + j * sj + (qa * M + w) * P);
              if (hb) xb[j][w] = cg::load16_cs(G + j * sj + (qb * M + w) * P);
            }
        if constexpr (ACC) {
          cg::load_f32s<P>(out + qa * P, acc_a);
          if (hb) cg::load_f32s<P>(out + qb * P, acc_b);
        }
        float sa[P], sb[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          sa[p] = 0.f; sb[p] = 0.f;
#pragma unroll
          for (int j = 0; j < DMAX; ++j)
#pragma unroll
            for (int u = 0; u < M; ++u)
              if (j < d) {
                const int e = p * M + u;
                sa[p] = fmaf(cg::lane<TI>(xa[j][e / P], e % P), c[j][u], sa[p]);
                sb[p] = fmaf(cg::lane<TI>(xb[j][e / P], e % P), c[j][u], sb[p]);
              }
        }
        finish_vec<TO, ACC, P>(out + qa * P, sa, acc_a);
        if (hb) finish_vec<TO, ACC, P>(out + qb * P, sb, acc_b);
      }
      v0 = items * P;
    }
    for (long long v = v0 + tid; v < V; v += stride) {
      const TI* g = G + v * M;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < DMAX; ++j)
#pragma unroll
        for (int u = 0; u < M; ++u)
          if (j < d) s = fmaf(cg::to_f32(g[j * sj + u]), c[j][u], s);
      finish<TO, ACC>(out + v, s);
    }
  }
}

__global__ void empty_kernel() {}

template <typename TI, typename TO, bool ACC, int M>
void launch_m(const void* G, const float* C, void* out, int d, long long V, int m,
              long long R, int rank3, int vec, cudaStream_t st) {
  static int per_sm_2d = 0, per_sm_3d = 0;
  constexpr int P = 16 / sizeof(TI);
  const size_t smem = M == 0 ? (size_t)d * m * sizeof(float) : 0;
  if (rank3) {
    auto k = encode3d_kernel<TI, TO, ACC, M>;
    const unsigned grid = cg::grid_for(k, per_sm_3d, vec ? V * (R / P) : V * R, smem);
    k<<<grid, CG_THREADS, smem, st>>>((const TI*)G, C, (TO*)out, d, V, m, R, vec);
  } else {
    auto k = encode2d_kernel<TI, TO, ACC, M>;
    const unsigned grid = cg::grid_for(k, per_sm_2d, vec ? V / P : V, smem);
    k<<<grid, CG_THREADS, smem, st>>>((const TI*)G, C, (TO*)out, d, V, m, vec);
  }
}

// the register form for m <= kMaxRegM and d*m <= kRegTerms, else the general
template <typename TI, typename TO, bool ACC>
void launch_typed(const void* G, const float* C, void* out, int d, long long V, int m,
                  long long R, int rank3, int vec, cudaStream_t st) {
  const int M = (m <= kMaxRegM && d * m <= kRegTerms) ? m : 0;
  switch (M) {
    case 1: launch_m<TI, TO, ACC, 1>(G, C, out, d, V, m, R, rank3, vec, st); break;
    case 2: launch_m<TI, TO, ACC, 2>(G, C, out, d, V, m, R, rank3, vec, st); break;
    case 3: launch_m<TI, TO, ACC, 3>(G, C, out, d, V, m, R, rank3, vec, st); break;
    case 4: launch_m<TI, TO, ACC, 4>(G, C, out, d, V, m, R, rank3, vec, st); break;
    default: launch_m<TI, TO, ACC, 0>(G, C, out, d, V, m, R, rank3, vec, st);
  }
}

// Can the vector path take these operands?  Both bases 16-byte aligned, and
// so every vector: in 3D R a multiple of P; in 2D each G[j] slab of V*m
// elements too, when d > 1.  The rule the Python wrapper applies
// (kernels/coded_encode.py, encode_path) before it asks for the path.
bool vector_ok(const void* G, const void* out, int d, long long V, int m, long long R,
               int rank3, int in_bytes) {
  const int P = 16 / in_bytes;
  return m <= kMaxRegM && d * m <= kRegTerms && (uintptr_t)G % 16 == 0 &&
         (uintptr_t)out % 16 == 0 &&
         (rank3 ? R % P == 0 : d == 1 || V * m % P == 0);
}

int check_args(const void* G, const void* out, int d, long long V, int m, long long R,
               int rank3, int in_dtype, int vec) {
  if (d <= 0 || m <= 0 || V <= 0 || R <= 0) return CG_ERR_SHAPE;
  if (in_dtype != CG_F32 && in_dtype != CG_BF16) return CG_ERR_DTYPE;
  if (vec && !vector_ok(G, out, d, V, m, R, rank3, in_dtype == CG_F32 ? 4 : 2))
    return CG_ERR_PATH;
  return 0;
}

}  // namespace

// G: (d, V, m) when rank3 == 0, else (d, V, m, R); C: (d, m) f32; out: (V) or
// (V, R).  All contiguous, on the current device.  vec = 1 takes the vector
// path (refused with CG_ERR_PATH where vector_ok does not hold), 0 the
// scalar path.  Returns cudaGetLastError() of the launch, or a negative
// CG_ERR_* code when nothing was launched.
extern "C" int coded_encode_launch(const void* G, const void* C, void* out, int d,
                                   long long V, int m, long long R, int rank3,
                                   int in_dtype, int out_dtype, int vec, void* stream) {
  int rc = check_args(G, out, d, V, m, R, rank3, in_dtype, vec);
  if (rc != 0) return rc;
  cudaStream_t st = (cudaStream_t)stream;
#define CG_ENCODE_CALL(TI, TO) \
  launch_typed<TI, TO, false>(G, (const float*)C, out, d, V, m, R, rank3, vec, st)
  CG_DISPATCH(in_dtype, out_dtype, CG_ENCODE_CALL)
#undef CG_ENCODE_CALL
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// acc: (V) when rank3 == 0, else (V, R), f32, read and written in place;
// G, C, vec as for coded_encode_launch.  All contiguous, on the current
// device.  Returns cudaGetLastError() of the launch, or a negative CG_ERR_*
// code when nothing was launched.
extern "C" int coded_encode_acc_launch(const void* G, const void* C, void* acc, int d,
                                       long long V, int m, long long R, int rank3,
                                       int in_dtype, int vec, void* stream) {
  const int rc = check_args(G, acc, d, V, m, R, rank3, in_dtype, vec);
  if (rc != 0) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_dtype == CG_F32)
    launch_typed<float, float, true>(G, (const float*)C, acc, d, V, m, R, rank3, vec, st);
  else
    launch_typed<__nv_bfloat16, float, true>(G, (const float*)C, acc, d, V, m, R, rank3,
                                             vec, st);
  return (int)cudaGetLastError();
}

// The launch floor: one block of one warp that does nothing, timed beside
// the coding kernels.  Returns cudaGetLastError() of the launch.
extern "C" int empty_kernel_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
