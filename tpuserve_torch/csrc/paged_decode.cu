// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention` / `_paged_decode_kernel`
// in tpuserve/ops/pallas_paged_attention.py.  Same contract as the plain
// version `paged_decode_attention` in tpuserve_torch/ops/attention.py:
// one query token per sequence against its K/V pages, found through
// `block_tables` and `seq_lens` (which counts the token being decoded),
// grouped-query heads, optional int8 pages with one f32 scale per
// (block, position, kv head), optional sliding window and softcap.
//
// What bounds it on this card: bytes.  Every cached K and V row of the
// attended range is read once per step and used for `group` dot products
// (2 for Qwen3-0.6B), about one FLOP per byte against the H100's ~295 for
// bf16 tensor cores, so the kernel can at best run at HBM bandwidth.
//
// Design:
// - Grid (B, Hkv): one block serves the `group = Hq / Hkv` query heads that
//   share a KV head, so each K/V row is read from memory once for all of
//   them.  The block reads its own block-table row and seq_len.
// - Each warp strides over the sequence's tokens; a K/V row is split over
//   the lanes in 16-byte loads (8 bf16, 4 f32 or 16 int8 values a lane), so
//   a warp covers one to four rows per step with every load fully used.
// - Each lane group keeps a float32 online softmax (running max, sum and
//   its slice of the output); groups merge inside the warp by shuffles,
//   then the warps merge through shared memory.
// - int8 rows are multiplied by their scale after loading and rounded to
//   the query's type, as the TPU kernel dequantizes into q's dtype.
// - Only tokens in [win_start, seq_len) are read, so pages wholly before
//   the window are never touched and V outside the range (possibly NaN in
//   a fresh cache) never reaches the sum.  seq_len == 0 writes zeros.
// Known limit, the first thing to fix: B * Hkv blocks (64 at batch 8 for
// Qwen3-0.6B) leave most of the 132 SMs idle at small batch; splitting the
// sequence over several blocks (split-K) and merging after is the cure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

struct Args {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const float* k_scale;   // null unless the cache is int8
  const float* v_scale;
  const int* block_tables;
  const int* seq_lens;
  void* out;
  int B, Hq, Hkv, page_size, max_pages;
  float scale;
  int window;             // 0 = none
  float softcap;          // 0 = none
};

template <typename QT, typename KVT, int D, int MAXG, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_kernel(Args a) {
  constexpr int kVec = 16 / sizeof(KVT);                 // elements per 16-byte load
  constexpr int kLpr = (D / kVec < 32) ? D / kVec : 32;  // lanes per K/V row
  constexpr int kVpl = D / (kVec * kLpr);                // 16-byte loads per lane per row
  constexpr int kRpw = 32 / kLpr;                        // rows a warp covers per step
  constexpr int kEpl = kVpl * kVec;                      // elements per lane

  __shared__ float sm_acc[NWARPS][MAXG][D];
  __shared__ float sm_m[NWARPS][MAXG];
  __shared__ float sm_l[NWARPS][MAXG];

  const QT* q = static_cast<const QT*>(a.q);
  const KVT* kc = static_cast<const KVT*>(a.k_cache);
  const KVT* vc = static_cast<const KVT*>(a.v_cache);
  QT* out = static_cast<QT*>(a.out);

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = a.Hq / a.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / kLpr;          // which row of the warp's step
  const int li = lane % kLpr;           // position inside the row
  const int seq_len = a.seq_lens[b];
  const int start = a.window > 0 ? max(seq_len - a.window, 0) : 0;
  const int* bt = a.block_tables + static_cast<size_t>(b) * a.max_pages;

  // this lane's dims: d = (v * kLpr + li) * kVec + i
  float qr[MAXG][kEpl];
  float acc[MAXG][kEpl];
  float m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int v = 0; v < kVpl; ++v)
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int d = (v * kLpr + li) * kVec + i;
        acc[g][v * kVec + i] = 0.f;
        qr[g][v * kVec + i] =
            g < G ? to_float(q[(static_cast<size_t>(b) * a.Hq + kvh * G + g) * D + d]) : 0.f;
      }
  }

  for (int t0 = start + warp * kRpw; t0 < seq_len; t0 += NWARPS * kRpw) {
    const int t = t0 + sub;
    const bool valid = t < seq_len;
    float kf[kEpl], vf[kEpl];
    if (valid) {
      const int page = bt[t / a.page_size];
      const size_t row =
          (static_cast<size_t>(page) * a.page_size + t % a.page_size) * a.Hkv + kvh;
#pragma unroll
      for (int v = 0; v < kVpl; ++v) {
        load16(kc + row * D + (v * kLpr + li) * kVec, kf + v * kVec);
        load16(vc + row * D + (v * kLpr + li) * kVec, vf + v * kVec);
      }
      if (a.k_scale != nullptr) {
        const float sk = a.k_scale[row];
        const float sv = a.v_scale[row];
#pragma unroll
        for (int i = 0; i < kEpl; ++i) {
          kf[i] = round_to<QT>(kf[i] * sk);
          vf[i] = round_to<QT>(vf[i] * sv);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kEpl; ++i) kf[i] = vf[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kEpl; ++i) s += qr[g][i] * kf[i];
#pragma unroll
      for (int off = kLpr / 2; off > 0; off /= 2) s += __shfl_xor_sync(kFull, s, off);
      if (!valid) continue;
      s *= a.scale;
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < kEpl; ++i) acc[g][i] = acc[g][i] * alpha + p * vf[i];
      m[g] = m_new;
    }
  }

  // merge the lane groups of this warp (same li, different sub)
#pragma unroll
  for (int off = kLpr; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mm = fmaxf(m[g], mo);
      const float sa = expf(m[g] - mm);
      const float so = expf(mo - mm);
      l[g] = l[g] * sa + lo * so;
#pragma unroll
      for (int i = 0; i < kEpl; ++i) {
        const float ao = __shfl_xor_sync(kFull, acc[g][i], off);
        acc[g][i] = acc[g][i] * sa + ao * so;
      }
      m[g] = mm;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
#pragma unroll
      for (int v = 0; v < kVpl; ++v)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          sm_acc[warp][g][(v * kLpr + li) * kVec + i] = acc[g][v * kVec + i];
      if (li == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps and write (B, Hq, D)
  for (int idx = threadIdx.x; idx < G * D; idx += NWARPS * 32) {
    const int g = idx / D;
    const int d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float s = expf(sm_m[w][g] - mm);
      ll += sm_l[w][g] * s;
      o += sm_acc[w][g][d] * s;
    }
    out[(static_cast<size_t>(b) * a.Hq + kvh * G + g) * D + d] =
        from_float<QT>(ll > 0.f ? o / ll : 0.f);
  }
}

template <typename QT, typename KVT, int D, int MAXG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kWarps = MAXG <= 2 ? 8 : 4;
  paged_decode_kernel<QT, KVT, D, MAXG, kWarps>
      <<<dim3(a.B, a.Hkv), kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t by_shape(const Args& a, int D, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (G > 8) return cudaErrorInvalidValue;
  const bool small = G <= 2;
  switch (D) {
    case 64: return small ? launch<QT, KVT, 64, 2>(a, stream) : launch<QT, KVT, 64, 8>(a, stream);
    case 128: return small ? launch<QT, KVT, 128, 2>(a, stream) : launch<QT, KVT, 128, 8>(a, stream);
    case 256: return small ? launch<QT, KVT, 256, 2>(a, stream) : launch<QT, KVT, 256, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32, 1 bfloat16, 2 int8
// (then k_scale / v_scale are required).  The output has q's type.
// Returns the launch's cudaError_t (0 on success).
extern "C" int paged_decode(const void* q, const void* k_cache, const void* v_cache,
                            const float* k_scale, const float* v_scale,
                            const int* block_tables, const int* seq_lens, void* out,
                            int B, int Hq, int Hkv, int D, int page_size, int max_pages,
                            float scale, int window, float softcap, int q_dtype,
                            int kv_dtype, void* stream) {
  if (B == 0) return 0;
  Args a{q, k_cache, v_cache, k_scale, v_scale, block_tables, seq_lens, out,
         B, Hq, Hkv, page_size, max_pages, scale, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return by_shape<float, float>(a, D, s);
  if (q_dtype == 1 && kv_dtype == 1) return by_shape<__nv_bfloat16, __nv_bfloat16>(a, D, s);
  if (q_dtype == 0 && kv_dtype == 2) return by_shape<float, int8_t>(a, D, s);
  if (q_dtype == 1 && kv_dtype == 2) return by_shape<__nv_bfloat16, int8_t>(a, D, s);
  return cudaErrorInvalidValue;
}
