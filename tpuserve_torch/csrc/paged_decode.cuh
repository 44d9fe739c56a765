// One query row of paged decode attention, for one KV head: the body of
// paged_decode.cu's kernel, shared with ragged_paged.cu's decode rows so
// both compute the same per-row math.
//
// The calling block has NWARPS warps.  Each warp strides over the
// sequence's tokens; a K/V row is split over the lanes in 16-byte loads,
// each lane group keeps a float32 online softmax, groups merge inside the
// warp by shuffles and warps merge through `smem`
// (decode_smem_floats<D, MAXG, NWARPS>() floats).  Only tokens in
// [win_start, seq_len) are read, so pages before the window and unwritten
// (possibly NaN) slots never reach the sum; seq_len == 0 writes zeros.
#pragma once

#include "attn_common.cuh"

namespace {

struct DecodeArgs {
  const void* q;            // row b's heads at q + b * Hq * D
  const void* k_cache;
  const void* v_cache;
  const float* k_scale;     // null unless the cache is int8
  const float* v_scale;
  const int* block_tables;  // row b at block_tables + b * max_pages
  void* out;                // same layout as q
  int Hq, Hkv, page_size, max_pages;
  float scale;
  int window;               // 0 = none
  float softcap;            // 0 = none
};

template <int D, int MAXG, int NWARPS>
__host__ __device__ constexpr int decode_smem_floats() {
  return NWARPS * MAXG * D + 2 * NWARPS * MAXG;
}

template <typename QT, typename KVT, int D, int MAXG, int NWARPS>
__device__ __forceinline__ void paged_decode_row(const DecodeArgs& a, int b, int kvh,
                                                 int seq_len, float* smem) {
  constexpr int kVec = 16 / sizeof(KVT);                 // elements per 16-byte load
  constexpr int kLpr = (D / kVec < 32) ? D / kVec : 32;  // lanes per K/V row
  constexpr int kVpl = D / (kVec * kLpr);                // 16-byte loads per lane per row
  constexpr int kRpw = 32 / kLpr;                        // rows a warp covers per step
  constexpr int kEpl = kVpl * kVec;                      // elements per lane

  float (*sm_acc)[MAXG][D] = reinterpret_cast<float (*)[MAXG][D]>(smem);
  float (*sm_m)[MAXG] = reinterpret_cast<float (*)[MAXG]>(smem + NWARPS * MAXG * D);
  float (*sm_l)[MAXG] = sm_m + NWARPS;

  const QT* q = static_cast<const QT*>(a.q);
  const KVT* kc = static_cast<const KVT*>(a.k_cache);
  const KVT* vc = static_cast<const KVT*>(a.v_cache);
  QT* out = static_cast<QT*>(a.out);

  const int G = a.Hq / a.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / kLpr;          // which row of the warp's step
  const int li = lane % kLpr;           // position inside the row
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
      const size_t row = cache_row(bt, t, a.page_size, a.Hkv, kvh);
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

  // merge the warps and write row b's G heads
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

}  // namespace
