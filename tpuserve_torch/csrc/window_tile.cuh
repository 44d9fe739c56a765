// The float32 tile of query-window attention against a paged KV cache:
// the device code paged_window.cu runs for float32 queries and
// ragged_paged.cu runs for its float32 prefill blocks (the bf16 ones run
// at::attn_tile, attn_tile.cuh, whose note sets out the tile's contract).
//
// 32 rows x 32 keys on the CUDA cores, since bf16 or TF32 products would
// miss the float32 tolerance: these serve the fp32 identity checks, not
// serving.
#pragma once

#include "attn_tile.cuh"

namespace {

namespace wf32 {

constexpr int kThreads = 128;
constexpr int kRows = 32;      // tile rows
constexpr int kBk = 32;        // keys per K/V tile

template <int D>
constexpr int smem_bytes() {
  return 4 * (kRows * D + kBk * (D + 1) + kBk * D + kRows * (kBk + 1) + 3 * kRows);
}

template <typename KVT, int D>
__device__ void window_tile(const WindowArgs& a, const Tile& t, unsigned char* smem_raw) {
  constexpr int kAcc = kRows * D / kThreads;   // output elements per thread
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kRows][D]
  float* ks = qs + kRows * D;                  // [kBk][D + 1]
  float* vs = ks + kBk * (D + 1);              // [kBk][D]
  float* ps = vs + kBk * D;                    // [kRows][kBk + 1]
  float* row_m = ps + kRows * (kBk + 1);       // [kRows]
  float* row_l = row_m + kRows;
  float* row_alpha = row_l + kRows;

  const float* q = static_cast<const float*>(t.q);
  float* out = static_cast<float*>(t.out);
  const KVT* kc = static_cast<const KVT*>(a.k_cache);
  const KVT* vc = static_cast<const KVT*>(a.v_cache);

  const int G = a.Hq / a.Hkv;
  const int nq = min(kRows / G, t.n_valid);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int i = r / G;
    qs[idx] = i < nq ? q[(static_cast<size_t>(i) * a.Hq + t.kvh * G + r % G) * D + d] : 0.f;
  }
  if (tid < kRows) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const int kv_start = tile_kv_start(t, a);
  const int kv_end = tile_kv_end(t);
  for (int k0 = kv_start / kBk * kBk; k0 < kv_end; k0 += kBk) {
    __syncthreads();   // previous tile's ps / vs fully consumed
    for (int idx = tid; idx < kBk * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key >= kv_start && key < kv_end) {
        const size_t row = cache_row(t.bt, key, a.page_size, a.Hkv, t.kvh);
        kv = to_float(kc[row * D + d]);
        vv = to_float(vc[row * D + d]);
        if (a.k_scale != nullptr) {
          kv *= a.k_scale[row];
          vv *= a.v_scale[row];
        }
      }
      ks[r * (D + 1) + d] = kv;
      vs[r * D + d] = vv;
    }
    __syncthreads();

    // S = Q K^T: lane = key column, each thread 8 rows
    {
      const int c = lane;
      float s[kRows / 4];
#pragma unroll
      for (int j = 0; j < kRows / 4; ++j) s[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = ks[c * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < kRows / 4; ++j) s[j] += qs[(warp + 4 * j) * D + d] * kv;
      }
#pragma unroll
      for (int j = 0; j < kRows / 4; ++j) {
        const int r = warp + 4 * j;
        const int i = r / G;
        ps[r * (kBk + 1) + c] = i < nq && window_key_ok(k0 + c, t.pos0 + i, a)
                                    ? window_score(s[j], a) : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: each warp owns 8 rows, lane = key column
    for (int r = warp; r < kRows; r += 4) {
      const float x = ps[r * (kBk + 1) + lane];
      const bool ok = x > 0.5f * kNegInf;
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(ok ? x : kNegInf));
      const float p = ok ? expf(x - m_new) : 0.f;
      ps[r * (kBk + 1) + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P V: thread owns elements e = tid + kThreads * i
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + kThreads * i;
      const int r = e / D, d = e % D;
      float o = acc[i] * row_alpha[r];
#pragma unroll 8
      for (int c = 0; c < kBk; ++c) o += ps[r * (kBk + 1) + c] * vs[c * D + d];
      acc[i] = o;
    }
  }
  __syncthreads();

  const int nw = min(kRows / G, t.n_write);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + kThreads * i;
    const int r = e / D, d = e % D;
    const int qi = r / G;
    if (qi >= nw) continue;
    const float l = row_l[r];
    out[(static_cast<size_t>(qi) * a.Hq + t.kvh * G + r % G) * D + d] =
        l > 0.f ? acc[i] / l : 0.f;
  }
}

}  // namespace wf32

}  // namespace
