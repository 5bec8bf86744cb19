// coded_decode for Hopper (sm_90a): the paper's eq. 19-21 reconstruction
//
//   2D: out[v, u]    = sum_{i<n} F[i, v]    * W[i, u]
//   3D: out[v, u, r] = sum_{i<n} F[i, v, r] * W[i, u]
//
// Replaces the TPU kernels coded_decode (_decode_kernel_2d / _3d) and
// coded_decode_apply (_decode_apply_kernel) of
// src/repro/kernels/coded_decode.py.
//
// Bound: bytes.  A skinny product (m is a handful of columns, about m/2
// operations per byte), so one read of F and one write of the output,
// n*V*R*sizeof(in) + V*m*R*sizeof(out) over 3.35 TB/s, bound it.  At the
// training path's (8, 171776) that is 2 us, near the launch itself, so the
// 2D design cuts what stands between the launch and the stream, and at the
// LM-leaf sizes it must keep the DRAM as busy as a thread per v does:
//
//  - A thread owns 4 consecutive v (kLanes): it reads F in 16-byte (f32)
//    or 8-byte (bf16) vectors along v, issues every row of its item before
//    its first fmaf, and writes its 4*m consecutive outputs as 16-byte
//    stores (8- or 4-byte where the run is no whole number of 16).  m is a
//    compile-time lane count for m in {1, 2, 3, 4, 8}; any other m takes
//    the general form (scalar, W in shared memory, kGenCols columns a
//    pass).
//  - One item a thread, one block per 256 items: the block scheduler
//    balances the SMs.  Where 256-thread blocks would leave fewer than two
//    an SM, the plain decode takes blocks of 128 or 64 (a bf16 bucket of
//    the training path is 84 blocks of 256).
//  - W in registers for n*m <= kRegTerms (16: the training path's code
//    (8, 4, 2, 2) and serving's (4, 3, 1, 2); every register form compiles
//    without spills under -Xptxas -v): one load a lane, spread over the warp
//    by shuffles, no shared memory and no __syncthreads before the first
//    load of F.  Above that, W sits in shared memory and the rows are
//    walked kChunk at a time, a chunk's loads issued before its fmafs.
//  - F is read evict-first (__ldcs) when the L2 could hold it, and with
//    the default policy when not.
//  - A scalar path in the same kernel takes a V tail, a base that is not
//    16-byte aligned, and rows F[i] that are not (n > 1 and V*sizeof(in)
//    no multiple of 16): the caller picks the path from shapes and
//    data_ptr() (kernels/coded_decode.py, decode_path) and the launcher
//    refuses the vector path for operands it cannot take (CG_ERR_PATH).
//  - Each of these choices was timed against its alternative in one call
//    (a grid sized to the card with threads looping over items, 16 bytes of
//    bf16 a thread, W in shared memory at every size, one cache policy at
//    every size, blocks of 256 at every size): tools/decode_ab.py holds
//    them as variants, PERF.md their times.
//  - 3D keeps its first design (85 % of its bound): a thread per (v, r),
//    coalesced over r, W in shared memory, up to 8 accumulators a thread.
//
// Every output element, on every path, is the same chain: fmaf from 0 over
// i in row order, in f32, rounded once to out's type; so the paths, and the
// one-thread-per-element kernel this design replaced, agree bit for bit.
//
// coded_decode_apply (the pipelined step's fused decode + SGD-momentum, 2D):
//
//   g = scale * (F^T W);  mu' = momentum * mu + g;  p' = p - lr * mu'
//
// over the (V, m) f32 bucket views P and MU, written in place, plus sum g^2.
// Bound by bytes as the decode is, plus one read and one write of P and MU;
// the same kernel as the 2D decode, with P and MU read as 16-byte vectors
// beside F's loads and written back the same way.  The update rounds after
// every multiply and add (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc does
// not contract into an FMA), as PyTorch's unfused elementwise ops do, so p'
// and mu' equal coded_decode followed by the optimizer's expressions bit for
// bit.  The TPU kernel adds sum g^2 into one cell across its sequential grid;
// here it is one launch: each thread sums its g^2 in its own order, each
// block adds its threads' sums by a fixed tree and writes the partial, and
// the last block to finish (an integer atomicAdd on a counter, after a
// __threadfence) adds the partials in index order and resets the counter
// to 0.  No float atomics: on one card the sum is the same from call to
// call.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRegTerms = 16;   // n*m up to this: W in registers
constexpr int kChunk = 8;       // rows of F in flight a thread when W is in shared memory
constexpr int kGenCols = 8;     // columns a pass of the general form
constexpr int kMinThreads = 64; // the smallest block, for a grid that would leave SMs idle

// the vector path's compile-time m
inline bool vector_m(int m) { return m == 1 || m == 2 || m == 3 || m == 4 || m == 8; }

// What the fused decode-apply adds to the decode; `out` is P.  Unused by
// the plain decode.
struct Apply {
  float* mu;            // MU (V, m), updated in place
  float* partials;      // one sum g^2 partial per block
  unsigned* done;       // blocks finished; 0 before and after every launch
  float* ss;            // sum g^2
  float lr, momentum, scale;
};

// One element's SGD-momentum update from its decoded sum, in the unfused
// ops' order and rounding; adds g^2 to ss.
__device__ __forceinline__ void sgd(float acc, float& p, float& mu, const Apply& a,
                                    float& ss) {
  const float g = __fmul_rn(acc, a.scale);
  const float mun = __fadd_rn(__fmul_rn(a.momentum, mu), g);
  p = __fsub_rn(p, __fmul_rn(a.lr, mun));
  mu = mun;
  ss = __fmaf_rn(g, g, ss);
}

// v a thread owns on the vector path: F read in 16-byte (f32) or 8-byte
// (bf16) vectors
template <typename TI> constexpr int kLanes = 4;

// P consecutive elements of one row of F: a 16- or 8-byte vector (P > 1),
// read evict-first when `cs`, or one element (P == 1, the scalar path)
template <typename TI, int P>
struct Row {
  using T = std::conditional_t<P * sizeof(TI) == 16, uint4, uint2>;
  static_assert(sizeof(T) == P * sizeof(TI), "a row's vector is 8 or 16 bytes");
  static __device__ __forceinline__ T load(const TI* f, bool cs) {
    const T* p = reinterpret_cast<const T*>(f);
    return cs ? __ldcs(p) : *p;
  }
  static __device__ __forceinline__ float at(const T& x, int p) { return cg::lane<TI>(x, p); }
};
template <typename TI>
struct Row<TI, 1> {
  using T = float;
  static __device__ __forceinline__ T load(const TI* f, bool) { return cg::to_f32(*f); }
  static __device__ __forceinline__ float at(T x, int) { return x; }
};

// W into registers, c[i][u] = W[i, u] for i < n, else 0: one load a lane
// (n*M <= 32 coefficients), spread over the warp by shuffles.  Whole warp.
template <int M, int NR>
__device__ __forceinline__ void coef_regs(const float* __restrict__ W, int n,
                                          float (&c)[NR][M]) {
  static_assert(NR * M <= 32, "one coefficient a lane");
  const int lane = threadIdx.x & 31;
  const float mine = lane < n * M ? __ldg(W + lane) : 0.f;
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int u = 0; u < M; ++u) c[i][u] = __shfl_sync(0xffffffffu, mine, i * M + u);
}

// The decode of P consecutive v from f = &F[0, v]: s[p*M + u] = sum_{i<n}
// F[i, v + p] * W[i, u], fmaf from 0 in row order.  NR > 0: n <= NR, the
// coefficients in registers (c), every row loaded first; NR == 0: any n,
// the coefficients in shared memory (wts), kChunk rows loaded at a time.
template <typename TI, int M, int NR, int P>
__device__ __forceinline__ void contract(const TI* f, long long V, int n,
                                         const float (&c)[NR > 0 ? NR : 1][M],
                                         const float* wts, bool cs, float (&s)[P * M]) {
  using R = Row<TI, P>;
  constexpr int NX = NR > 0 ? NR : kChunk;     // rows in flight
#pragma unroll
  for (int e = 0; e < P * M; ++e) s[e] = 0.f;
  for (int i0 = 0; i0 < (NR > 0 ? 1 : n); i0 += NX) {   // one pass with W in registers
    typename R::T x[NX];
#pragma unroll
    for (int r = 0; r < NX; ++r)
      if (i0 + r < n) x[r] = R::load(f + (i0 + r) * V, cs);
#pragma unroll
    for (int r = 0; r < NX; ++r)
      if (i0 + r < n)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float xp = R::at(x[r], p);
#pragma unroll
          for (int u = 0; u < M; ++u) {
            float w;
            if constexpr (NR > 0) w = c[r][u];
            else w = wts[(i0 + r) * M + u];
            s[p * M + u] = fmaf(xp, w, s[p * M + u]);
          }
        }
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

// The block's partial of sum g^2 (its threads' sums by a fixed tree); the
// last block to finish adds the partials in index order into *a.ss and
// resets the counter.  Whole block.
__device__ __forceinline__ void sum_g2(float ss, const Apply& a) {
  __shared__ float red[CG_THREADS];      // the kernel's only static shared memory
  const float total = block_sum(red, ss);
  bool last = false;
  if (threadIdx.x == 0) {
    a.partials[blockIdx.x] = total;
    __threadfence();                     // the partial is visible before the count
    last = atomicAdd(a.done, 1u) == gridDim.x - 1;
    __threadfence();
  }
  if (!__syncthreads_or(last)) return;
  float s = 0.f;
  for (unsigned t = threadIdx.x; t < gridDim.x; t += CG_THREADS)
    s = __fadd_rn(s, __ldcg(a.partials + t));
  const float sum = block_sum(red, s);
  if (threadIdx.x == 0) {
    *a.ss = sum;
    *a.done = 0u;
  }
}

// The 2D decode, out (V, m), or with APPLY the fused update (out is P, TO
// float).  M > 0: m == M; NR > 0: n <= NR with W in registers, NR == 0: W
// in shared memory.  The vector path covers the first V - V % P outputs
// when `vec`; the scalar loop takes the tail, or all of V.  M == 0: any m,
// the general form (W in shared memory, scalar, kGenCols columns a pass).
template <typename TI, typename TO, int M, int NR, bool APPLY>
__global__ void __launch_bounds__(CG_THREADS)
decode2d_kernel(const TI* __restrict__ F, const float* __restrict__ W,
                TO* __restrict__ out, int n, long long V, int m, int vec, int cs,
                Apply a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float ss = 0.f;                              // sum g^2 of this thread (APPLY)
  if constexpr (M == 0) {
    extern __shared__ float wts[];
    cg::load_coef(wts, W, n * m);
    for (long long v = tid; v < V; v += stride) {
      for (int u0 = 0; u0 < m; u0 += kGenCols) {
        float acc[kGenCols];
        cg::decode_cols<TI, kGenCols>(F + v, V, wts, n, m, u0, acc);
        const long long o = v * m + u0;
#pragma unroll
        for (int k = 0; k < kGenCols; ++k) {
          if (u0 + k < m) {
            if constexpr (APPLY) sgd(acc[k], out[o + k], a.mu[o + k], a, ss);
            else out[o + k] = cg::from_f32<TO>(acc[k]);
          }
        }
      }
    }
  } else {
    float c[NR > 0 ? NR : 1][M];
    const float* wts = nullptr;
    if constexpr (NR > 0) {
      coef_regs<M, NR>(W, n, c);
    } else {
      extern __shared__ float sw[];
      cg::load_coef(sw, W, n * M);
      wts = sw;
    }
    long long v0 = 0;                          // first output of the scalar loop
    if (vec) {
      constexpr int P = kLanes<TI>;
      const long long items = V / P;
      for (long long q = tid; q < items; q += stride) {
        const long long o = q * P * M;         // the item's run of P*M outputs
        float pv[APPLY ? P * M : 4], mv[APPLY ? P * M : 4];
        if constexpr (APPLY) {
          cg::load_f32s<P * M>(out + o, pv);
          cg::load_f32s<P * M>(a.mu + o, mv);
        }
        float s[P * M];
        contract<TI, M, NR, P>(F + q * P, V, n, c, wts, cs, s);
        if constexpr (APPLY) {
#pragma unroll
          for (int e = 0; e < P * M; ++e) sgd(s[e], pv[e], mv[e], a, ss);
          cg::store_run<float, P * M>(out + o, pv);
          cg::store_run<float, P * M>(a.mu + o, mv);
        } else {
          cg::store_run<TO, P * M>(out + o, s);
        }
      }
      v0 = items * P;
    }
    for (long long v = v0 + tid; v < V; v += stride) {
      float s[M];
      contract<TI, M, NR, 1>(F + v, V, n, c, wts, false, s);
#pragma unroll
      for (int u = 0; u < M; ++u) {
        if constexpr (APPLY) sgd(s[u], out[v * M + u], a.mu[v * M + u], a, ss);
        else out[v * M + u] = cg::from_f32<TO>(s[u]);
      }
    }
  }
  if constexpr (APPLY) sum_g2(ss, a);
}

long long blocks_of(long long work, int threads) {
  return std::max(1LL, (work + threads - 1) / threads);
}

// One block per `threads` items, one item a thread (the block scheduler
// balances the SMs); 256 threads a block, or for the plain decode 128 or 64
// where 256 would leave fewer than two blocks an SM.  F is read evict-first
// when the L2 could hold it.
template <typename TI, typename TO, int M, int NR, bool APPLY>
int launch_form(const void* F, const float* W, void* out, int n, long long V, int m,
                int vec, const Apply& a, long long max_grid, cudaStream_t st) {
  const long long work = vec ? V / kLanes<TI> : V;
  int threads = CG_THREADS;
  while (!APPLY && threads > kMinThreads && blocks_of(work, threads) < 2LL * cg::sm_count())
    threads /= 2;
  const long long grid = blocks_of(work, threads);
  if (grid > max_grid || grid > 2147483647LL) return CG_ERR_SHAPE;
  const size_t smem = NR == 0 ? (size_t)n * m * sizeof(float) : 0;
  const int cs = (long long)n * V * (long long)sizeof(TI) <= cg::l2_bytes();
  decode2d_kernel<TI, TO, M, NR, APPLY><<<(unsigned)grid, threads, smem, st>>>(
      (const TI*)F, W, (TO*)out, n, V, m, vec, cs, a);
  return 0;
}

// the register form for n*m <= kRegTerms, W in shared memory above it; the
// general form for m outside the vector path's lane counts
template <typename TI, typename TO, bool APPLY>
int launch_typed(const void* F, const float* W, void* out, int n, long long V, int m,
                 int vec, const Apply& a, long long max_grid, cudaStream_t st) {
  const bool reg = n * m <= kRegTerms;
#define CG_FORM(M)                                                                        \
  return reg ? launch_form<TI, TO, M, kRegTerms / M, APPLY>(F, W, out, n, V, m, vec, a,  \
                                                             max_grid, st)               \
             : launch_form<TI, TO, M, 0, APPLY>(F, W, out, n, V, m, vec, a, max_grid, st);
  switch (m) {
    case 1: CG_FORM(1)
    case 2: CG_FORM(2)
    case 3: CG_FORM(3)
    case 4: CG_FORM(4)
    case 8: CG_FORM(8)
    default: return launch_form<TI, TO, 0, 0, APPLY>(F, W, out, n, V, m, vec, a, max_grid, st);
  }
#undef CG_FORM
}

// Can the 2D vector path take these operands?  m one of its lane counts,
// every base 16-byte aligned (F, out, and MU when given), and so every row
// F[i]: V*sizeof(in) a multiple of 16 when n > 1.  The rule the Python
// wrapper applies (kernels/coded_decode.py, decode_path) before it asks for
// the path.
bool vector_ok(const void* F, const void* out, const void* mu, int n, long long V, int m,
               int in_bytes) {
  return vector_m(m) && (uintptr_t)F % 16 == 0 && (uintptr_t)out % 16 == 0 &&
         (uintptr_t)mu % 16 == 0 && (n == 1 || V * in_bytes % 16 == 0);
}

}  // namespace

// F: (n, V) when rank3 == 0, else (n, V, R); W: (n, m) f32; out: (V, m) or
// (V, m, R).  All contiguous, on the current device.  vec = 1 takes the 2D
// vector path (refused with CG_ERR_PATH where vector_ok does not hold, and
// in 3D), 0 the scalar path.  Returns cudaGetLastError() of the launch, or a
// negative CG_ERR_* code when nothing was launched.
extern "C" int coded_decode_launch(const void* F, const void* W, void* out, int n,
                                   long long V, int m, long long R, int rank3,
                                   int in_dtype, int out_dtype, int vec, void* stream) {
  if (n <= 0 || m <= 0 || V <= 0 || R <= 0) return CG_ERR_SHAPE;
  if (in_dtype != CG_F32 && in_dtype != CG_BF16) return CG_ERR_DTYPE;
  if (vec && (rank3 || !vector_ok(F, out, nullptr, n, V, m, in_dtype == CG_F32 ? 4 : 2)))
    return CG_ERR_PATH;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  if (rank3) {
    const long long blocks = cg::blocks_for(V * R);
    if (blocks < 0) return CG_ERR_SHAPE;
    const size_t smem = (size_t)n * m * sizeof(float);
#define CG_DECODE3D(TI, TO, MC)                                                       \
  decode3d_kernel<TI, TO, MC><<<(unsigned)blocks, CG_THREADS, smem, st>>>(            \
      (const TI*)F, (const float*)W, (TO*)out, n, V, m, R);
#define CG_DECODE3D_CALL(TI, TO)                                                      \
  if (m <= 2) {                                                                       \
    CG_DECODE3D(TI, TO, 2)                                                            \
  } else if (m <= 4) {                                                                \
    CG_DECODE3D(TI, TO, 4)                                                            \
  } else {                                                                            \
    CG_DECODE3D(TI, TO, 8)                                                            \
  }
    CG_DISPATCH(in_dtype, out_dtype, CG_DECODE3D_CALL)
#undef CG_DECODE3D_CALL
#undef CG_DECODE3D
  } else {
#define CG_DECODE2D_CALL(TI, TO)                                                      \
  rc = launch_typed<TI, TO, false>(F, (const float*)W, out, n, V, m, vec, Apply{},    \
                                   2147483647LL, st)
    CG_DISPATCH(in_dtype, out_dtype, CG_DECODE2D_CALL)
#undef CG_DECODE2D_CALL
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// F: (n, V) in_dtype; W: (n, m) f32; P, MU: (V, m) f32, overwritten with p'
// and mu'; partials: num_partials f32 of scratch, at least one per block
// (the grid is refused with CG_ERR_SHAPE when it has more blocks); done: one
// 32-bit counter that is 0 before the call and is left 0 by it, of this
// stream alone (two streams need two counters); ss: one f32, set to sum
// g^2.  vec as for coded_decode_launch.  All contiguous, on the current
// device.  One launch.  Returns cudaGetLastError(), or a negative CG_ERR_*
// code when nothing was launched.
extern "C" int coded_decode_apply_launch(const void* F, const void* W, void* P, void* MU,
                                         void* partials, void* done, void* ss, int n,
                                         long long V, int m, float lr, float momentum,
                                         float scale, int in_dtype, long long num_partials,
                                         int vec, void* stream) {
  if (n <= 0 || m <= 0 || V <= 0) return CG_ERR_SHAPE;
  if (in_dtype != CG_F32 && in_dtype != CG_BF16) return CG_ERR_DTYPE;
  if (((size_t)n * m + CG_THREADS) * sizeof(float) > 48 * 1024) return CG_ERR_SHAPE;
  if (vec && !vector_ok(F, P, MU, n, V, m, in_dtype == CG_F32 ? 4 : 2)) return CG_ERR_PATH;
  const Apply a{(float*)MU, (float*)partials, (unsigned*)done, (float*)ss, lr, momentum,
                scale};
  cudaStream_t st = (cudaStream_t)stream;
  const int rc =
      in_dtype == CG_F32
          ? launch_typed<float, float, true>(F, (const float*)W, P, n, V, m, vec, a,
                                             num_partials, st)
          : launch_typed<__nv_bfloat16, float, true>(F, (const float*)W, P, n, V, m, vec,
                                                     a, num_partials, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
