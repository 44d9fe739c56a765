// Small device helpers shared by the paged attention kernels
// (paged_decode.cu, paged_window.cu, ragged_paged.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// The head dims the kernels take are 64, 96, 128 and 256.  Shared-memory
// tiles and lane layouts run at the padded width (96 -> 128, as the Pallas
// kernels pad their lanes to 128), with the columns past D held at zero;
// global rows keep their own stride D, and only D columns are written.
__host__ __device__ constexpr int padded_dim(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float to what type T holds (identity for float).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Load 16 bytes of T at p (16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) out[i] = to_float(e[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Flat row of K/V head `kvh` for cache position `pos` of a sequence whose
// block-table row is `bt`: index into (num_blocks * page, Hkv) rows.
__device__ __forceinline__ size_t cache_row(const int* bt, int pos, int page_size,
                                            int Hkv, int kvh) {
  return (static_cast<size_t>(bt[pos / page_size]) * page_size + pos % page_size) * Hkv + kvh;
}

}  // namespace
