// One tile of query-window attention against a paged KV cache: the
// device code paged_window.cu runs for every block and ragged_paged.cu
// runs for its prefill blocks.
//
// A tile holds up to `bq = kRows / G` consecutive query positions of one
// sequence and the G = Hq / Hkv query heads that share KV head `kvh`: row
// r of the tile is position r / G, head kvh * G + r % G, so each K/V tile
// loaded from the cache serves all G heads.  Query position i sits at
// cache position pos0 + i and attends every written key at or before it
// (causal on top of the cached context), within the sliding window.
//
// The block walks K/V tiles from the window start of its first row (or 0)
// to the causal limit of its last valid row, with a float32 online
// softmax.  Only keys in [kv_start, kv_end) are ever read: pages before
// the window and unwritten (possibly NaN) slots past the written keys are
// stored as 0 and masked, so they never reach the sum.  Rows in
// [n_valid, n_write) (past the chunk) and rows with no key write 0.
//
// - bf16 queries (the serving path): 4 warps x 16 rows, 64-key tiles; QK^T
//   and PV run on the tensor cores as 16x16x16 WMMA products from shared
//   memory with float32 sums, as flash_prefill.cu does.  int8 pages are
//   scaled and rounded to bf16 as they are stored into shared memory.
// - float32 queries: 32 rows x 32 keys on the CUDA cores, since bf16 or
//   TF32 products would miss the float32 tolerance.
#pragma once

#include <mma.h>

#include "attn_common.cuh"

namespace {

struct WindowArgs {        // what every tile of a launch shares
  const void* k_cache;     // (num_blocks, page_size, Hkv, D)
  const void* v_cache;
  const float* k_scale;    // (num_blocks, page_size, Hkv); null unless int8
  const float* v_scale;
  int Hq, Hkv, page_size;
  float scale;
  int window;              // 0 = none
  float softcap;           // 0 = none
};

struct Tile {              // one block's tile
  const void* q;           // position 0: element (i, h, d) at q + (i * Hq + h) * D + d
  void* out;               // the same layout
  const int* bt;           // the sequence's block-table row
  int pos0;                // cache position of query position 0
  int n_valid;             // positions [0, n_valid) are queries
  int n_write;             // positions [n_valid, n_write) are written as 0
  int total;               // keys written for the sequence
  int kvh;
};

__device__ __forceinline__ float window_score(float s, const WindowArgs& a) {
  s *= a.scale;
  return a.softcap > 0.f ? a.softcap * tanhf(s / a.softcap) : s;
}

__device__ __forceinline__ bool window_key_ok(int key, int pos, const WindowArgs& a) {
  return key <= pos && (a.window <= 0 || key > pos - a.window);
}

// first key any valid row of the tile attends, and one past the last
__device__ __forceinline__ int tile_kv_start(const Tile& t, const WindowArgs& a) {
  return a.window > 0 ? max(0, t.pos0 - a.window + 1) : 0;
}
__device__ __forceinline__ int tile_kv_end(const Tile& t) {
  return t.n_valid > 0 ? min(t.total, t.pos0 + t.n_valid) : 0;
}

// ---------------------------------------------------------------------------
// bfloat16 queries: tensor cores (WMMA)
// ---------------------------------------------------------------------------

namespace wtc {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 128;
constexpr int kRows = 64;   // tile rows: 4 warps x 16
constexpr int kBk = 64;     // keys per K/V tile
constexpr int kWm = 16;     // WMMA tile edge

// Shared-memory layout; every offset and row stride keeps the 32-byte
// alignment WMMA loads and stores need, and the +8 / +4 padding staggers
// rows across banks.
template <int D>
struct Smem {
  static constexpr int ldh = D + 8;       // bf16 stride of Q, K, V
  static constexpr int lds = kBk + 4;     // float stride of S
  static constexpr int ldp = kBk + 8;     // bf16 stride of P
  static constexpr int ldo = D + 4;       // float stride of O
  static constexpr int q = 0;
  static constexpr int k = q + kRows * ldh * 2;
  static constexpr int v = k + kBk * ldh * 2;
  static constexpr int s = v + kBk * ldh * 2;
  static constexpr int p = s + kRows * lds * 4;
  static constexpr int o = p + kRows * ldp * 2;
  static constexpr int stats = o + kRows * ldo * 4;
  static constexpr int bytes = stats + 3 * kRows * 4;
};

// 16 bytes of cache values at src (8 bf16 or 16 int8) as bf16 into dst;
// int8 values are multiplied by their row's scale and rounded to bf16.
__device__ __forceinline__ void kv_to_smem(const bf16* src, float, bf16* dst) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void kv_to_smem(const int8_t* src, float sc, bf16* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) bf16 t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = __float2bfloat16(static_cast<float>(e[i]) * sc);
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(t)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(t)[1];
}
template <typename KVT>
__device__ __forceinline__ void zero_to_smem(bf16* dst) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(16 / sizeof(KVT)) / 8; ++i)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(0, 0, 0, 0);
}

template <typename KVT, int D>
__device__ void window_tile(const WindowArgs& a, const Tile& t, unsigned char* smem) {
  using L = Smem<D>;
  constexpr int kVecsQ = D / 8;                  // 16-byte vectors per q row
  constexpr int kE = 16 / sizeof(KVT);           // cache values per 16-byte load
  constexpr int kVecsKV = D / kE;
  bf16* qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::p);
  float* os = reinterpret_cast<float*>(smem + L::o);
  float* row_m = reinterpret_cast<float*>(smem + L::stats);
  float* row_l = row_m + kRows;
  float* row_alpha = row_l + kRows;

  const bf16* q = static_cast<const bf16*>(t.q);
  bf16* out = static_cast<bf16*>(t.out);
  const KVT* kc = static_cast<const KVT*>(a.k_cache);
  const KVT* vc = static_cast<const KVT*>(a.v_cache);

  const int G = a.Hq / a.Hkv;
  const int nq = min(kRows / G, t.n_valid);      // valid positions in the tile
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wr = (tid / 32) * kWm;               // this warp's first row

  for (int idx = tid; idx < kRows * kVecsQ; idx += kThreads) {
    const int r = idx / kVecsQ, c = (idx % kVecsQ) * 8;
    const int i = r / G;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (i < nq)
      val = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(i) * a.Hq + t.kvh * G + r % G) * D + c);
    *reinterpret_cast<uint4*>(qs + r * L::ldh + c) = val;
  }
  for (int idx = tid; idx < kRows * D; idx += kThreads) os[(idx / D) * L::ldo + idx % D] = 0.f;
  if (tid < kRows) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  // this warp's positions [i_lo, i_hi]; it has work only if i_lo is valid
  const int i_lo = wr / G;
  const int i_hi = min((wr + kWm - 1) / G, nq - 1);
  const bool warp_live = i_lo < nq;
  const int kv_start = tile_kv_start(t, a);
  const int kv_end = tile_kv_end(t);
  for (int k0 = kv_start / kBk * kBk; k0 < kv_end; k0 += kBk) {
    __syncthreads();   // the previous tile's K / V are consumed
    for (int idx = tid; idx < kBk * kVecsKV; idx += kThreads) {
      const int r = idx / kVecsKV, c = (idx % kVecsKV) * kE;
      const int key = k0 + r;
      bf16* kd = ks + r * L::ldh + c;
      bf16* vd = vs + r * L::ldh + c;
      if (key >= kv_start && key < kv_end) {
        const size_t row = cache_row(t.bt, key, a.page_size, a.Hkv, t.kvh);
        const float sk = a.k_scale != nullptr ? a.k_scale[row] : 1.f;
        const float sv = a.v_scale != nullptr ? a.v_scale[row] : 1.f;
        kv_to_smem(kc + row * D + c, sk, kd);
        kv_to_smem(vc + row * D + c, sv, vd);
      } else {
        zero_to_smem<KVT>(kd);
        zero_to_smem<KVT>(vd);
      }
    }
    __syncthreads();
    // skip a tile wholly after this warp's rows or before their windows
    if (!warp_live || k0 > t.pos0 + i_hi) continue;
    if (a.window > 0 && k0 + kBk - 1 <= t.pos0 + i_lo - a.window) continue;

    // S = Q K^T over this warp's 16 rows
    wmma::fragment<wmma::accumulator, kWm, kWm, kWm, float> sacc[kBk / kWm];
#pragma unroll
    for (int j = 0; j < kBk / kWm; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += kWm) {
      wmma::fragment<wmma::matrix_a, kWm, kWm, kWm, bf16, wmma::row_major> qf;
      wmma::load_matrix_sync(qf, qs + wr * L::ldh + kk, L::ldh);
#pragma unroll
      for (int j = 0; j < kBk / kWm; ++j) {
        wmma::fragment<wmma::matrix_b, kWm, kWm, kWm, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, ks + j * kWm * L::ldh + kk, L::ldh);
        wmma::mma_sync(sacc[j], qf, kf, sacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBk / kWm; ++j)
      wmma::store_matrix_sync(ss + wr * L::lds + j * kWm, sacc[j], L::lds,
                              wmma::mem_row_major);
    __syncwarp();

    // online softmax, one row at a time: lane = key columns lane, lane + 32
    for (int r = wr; r < wr + kWm; ++r) {
      const int i = r / G;
      const int pos = t.pos0 + i;
      float x[2];
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        ok[c] = i < nq && window_key_ok(k0 + col, pos, a);
        x[c] = ok[c] ? window_score(ss[r * L::lds + col], a) : kNegInf;
      }
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x[0], x[1])));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = ok[c] ? expf(x[c] - m_new) : 0.f;
        ps[r * L::ldp + lane + 32 * c] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncwarp();

    // O = O * alpha + P V over this warp's rows
    for (int idx = lane; idx < kWm * D; idx += 32) {
      const int r = wr + idx / D;
      os[r * L::ldo + idx % D] *= row_alpha[r];
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, kWm, kWm, kWm, bf16, wmma::row_major> pf[kBk / kWm];
#pragma unroll
    for (int j = 0; j < kBk / kWm; ++j)
      wmma::load_matrix_sync(pf[j], ps + wr * L::ldp + j * kWm, L::ldp);
#pragma unroll 2
    for (int n = 0; n < D; n += kWm) {
      wmma::fragment<wmma::accumulator, kWm, kWm, kWm, float> of;
      wmma::load_matrix_sync(of, os + wr * L::ldo + n, L::ldo, wmma::mem_row_major);
#pragma unroll
      for (int j = 0; j < kBk / kWm; ++j) {
        wmma::fragment<wmma::matrix_b, kWm, kWm, kWm, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, vs + j * kWm * L::ldh + n, L::ldh);
        wmma::mma_sync(of, pf[j], vf, of);
      }
      wmma::store_matrix_sync(os + wr * L::ldo + n, of, L::ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  const int nw = min(kRows / G, t.n_write);
  for (int idx = lane; idx < kWm * D; idx += 32) {
    const int r = wr + idx / D, d = idx % D;
    const int i = r / G;
    if (i >= nw) break;
    const float l = row_l[r];
    out[(static_cast<size_t>(i) * a.Hq + t.kvh * G + r % G) * D + d] =
        __float2bfloat16(l > 0.f ? os[r * L::ldo + d] / l : 0.f);
  }
}

}  // namespace wtc

// ---------------------------------------------------------------------------
// float32 queries: CUDA cores
// ---------------------------------------------------------------------------

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
