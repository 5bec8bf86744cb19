// What the flash attention kernels share, forward (flash_attn.cu) and
// backward (flash_attn_bwd.cu): the f32 split into TF32 hi and lo, the
// k-step offsets and register packing of their wgmma operands, and, on the
// host, the rank-4 TMA tensor maps over the model layout (B, S, heads, hd).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "sm90.cuh"

#define FA_CAUSAL 0
#define FA_FULL 1
#define FA_WINDOW 2

// refusals of the launchers besides CG_ERR_SHAPE / CG_ERR_DTYPE
#define FA_ERR_ALIGN (-3)  // a base or a stride TMA cannot take
#define FA_ERR_TMA (-4)    // no tensor-map encoder, or it refused the map

namespace {

constexpr int FA_WG = 128;                   // threads of a warpgroup
constexpr int FA_BUDGET_2 = 110 * 1024;      // two blocks an SM
constexpr int FA_BUDGET_1 = 225 * 1024;      // one block an SM (227 K at most)

// byte offset of wgmma k step `kk` (32 bytes of hd) in a tile of `rows` rows
// stored as boxes of rows x ROWB
template <int ROWB>
__device__ __forceinline__ uint32_t koff(int kk, int rows) {
  return (kk * 32 / ROWB) * rows * ROWB + (kk * 32) % ROWB;
}

// a = hi + lo over a whole tile, elementwise: hi in place, lo into `lo`
__device__ __forceinline__ void split_tile(uint8_t* raw, uint8_t* lo, int bytes, int tid) {
  float4* r = reinterpret_cast<float4*>(raw);
  float4* l = reinterpret_cast<float4*>(lo);
  for (int i = tid; i < bytes / 16; i += FA_WG) {
    const float4 a = r[i];
    float4 h, w;
    h.x = __uint_as_float(sm90::to_tf32(a.x));
    h.y = __uint_as_float(sm90::to_tf32(a.y));
    h.z = __uint_as_float(sm90::to_tf32(a.z));
    h.w = __uint_as_float(sm90::to_tf32(a.w));
    w.x = __uint_as_float(sm90::to_tf32(a.x - h.x));
    w.y = __uint_as_float(sm90::to_tf32(a.y - h.y));
    w.z = __uint_as_float(sm90::to_tf32(a.z - h.z));
    w.w = __uint_as_float(sm90::to_tf32(a.w - h.w));
    r[i] = h;
    l[i] = w;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc (64 x HD) += A (64 x k, registers) B, B from shared memory: tf32 with
// B K-major, bf16 with B read transposed (MN-major)
template <int HD>
__device__ __forceinline__ void mma_pv_tf32(float (&o)[HD / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (HD == 32) sm90::wgmma_tf32_rs_n32(o, a, db, 1);
  else if constexpr (HD == 64) sm90::wgmma_tf32_rs_n64(o, a, db, 1);
  else sm90::wgmma_tf32_rs_n128(o, a, db, 1);
}

template <int HD>
__device__ __forceinline__ void mma_pv_bf16(float (&o)[HD / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (HD == 32) sm90::wgmma_bf16_rs_n32_tb(o, a, db, 1);
  else if constexpr (HD == 64) sm90::wgmma_bf16_rs_n64_tb(o, a, db, 1);
  else sm90::wgmma_bf16_rs_n128_tb(o, a, db, 1);
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime: nothing more to link
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Rank-4 tensor map over (hd, S, heads, B) with element strides (1, ss, sh,
// sb), boxes of box_rows x boxe elements.  A dimension of extent 1 never
// moves, so its stride is not read.  The encoder is a driver call: it needs
// the device's context current on the calling thread, and a thread that has
// made no runtime call yet has none (PyTorch runs a backward on a thread of
// its own, where this may be the first CUDA call), so the current device's
// primary context is bound first.
int make_map(CUtensorMap* map, const void* ptr, bool f32, int hd, long long S, int heads,
             int B, long long ss, long long sh, long long sb, int box_rows, int boxe,
             int rowb) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return FA_ERR_TMA;
  const long long esz = f32 ? 4 : 2;
  const long long extent[3] = {S, heads, B};
  const long long stride[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const long long bytes = extent[i] == 1 ? hd * esz : stride[i] * esz;
    if (bytes <= 0 || bytes % 16 != 0 || bytes >= (1LL << 40)) return FA_ERR_ALIGN;
    strides[i] = (cuuint64_t)bytes;
  }
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return FA_ERR_ALIGN;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return FA_ERR_TMA;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint32_t box[4] = {(cuuint32_t)boxe, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         4, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         rowb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : FA_ERR_TMA;
}

}  // namespace
