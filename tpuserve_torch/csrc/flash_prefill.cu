// Causal flash attention over right-padded prompts for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_prefill_attention` / `_flash_kernel` in
// tpuserve/ops/pallas_flash_attention.py.  Same contract as the plain
// version `prefill_attention` in tpuserve_torch/ops/attention.py: q
// (B, T, Hq, D), k/v (B, T, Hkv, D), per-batch `prompt_lens` key mask,
// grouped-query heads (q head h reads kv head h / (Hq / Hkv)), optional
// sliding window and softcap; rows at or past prompt_len are unspecified.
//
// What bounds it on this card: a sequence of n tokens needs about
// 2 * Hq * D * n^2 FLOPs for (2 * Hq + 2 * Hkv) * D * n values moved, n / 3
// FLOPs per bf16 byte for Qwen3-0.6B's heads.  That is near the ~295 where
// the H100's bf16 tensor cores stop waiting on memory: bytes bound short
// prompts and operations long ones, and either way only the tensor cores
// come near the bound.
//
// Design:
// - bfloat16 (the serving path): grid (Hkv, B, ceil(T / bq)), the query
//   tiles with the most keys dispatched first; a block serves
//   bq = 128 / G positions (64 / G at D=256) of one sequence times the G
//   query heads of KV head blockIdx.x, the row mapping of the window
//   kernel.  It runs at::attn_tile (attn_tile.cuh), the Hopper core it
//   shares with paged_window.cu and ragged_paged.cu: two consumer
//   warpgroups, 128-key K/V tiles in a 2-stage cp.async ring on
//   mbarriers, S = QK^T and O += PV on wgmma, softmax and O in registers,
//   masks only on tiles that cross the diagonal, prompt_len or the window
//   edge; 161 KB of shared memory and 255 registers a thread at D=128, one
//   block an SM.  The keys are the sequence's contiguous rows; keys at or
//   past prompt_len are never read (zero-filled, masked), so NaN padding
//   stays harmless.  A block wholly past prompt_len reads no key and
//   writes zeros.  Against the WMMA kernel it replaces: (1) no S, P or O
//   in shared memory; (2) asynchronous K/V loads under the math; (3)
//   wgmma instead of 16x16x16 WMMA; (4) 128-row tiles; (5) each K/V tile
//   is loaded once per KV head, not once per query head (G times less
//   K/V traffic).
// - float32: the tensor cores' bf16 or TF32 products would miss the float32
//   tolerance, so QK^T and PV run on the CUDA cores from shared memory,
//   32 query rows of one head and 32 keys a step, the running max, sum and
//   output in float32 (54 KB at D=128, 103 KB at D=256).  V rows at or past
//   prompt_len are stored as 0; a row with no key writes 0.

#include "attn_tile.cuh"

namespace {

constexpr int kThreads = 128;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* prompt_lens;
  void* out;
  int B, T, Hq, Hkv;
  float scale;
  int window;       // 0 = none
  float softcap;    // 0 = none
};

__device__ __forceinline__ bool key_ok(int col, int row, int plen, int window) {
  return col <= row && col < plen && (window <= 0 || col > row - window);
}

__device__ __forceinline__ float score(float s, const Args& a) {
  s *= a.scale;
  return a.softcap > 0.f ? a.softcap * tanhf(s / a.softcap) : s;
}

// first key tile any of rows [q0, ...) may attend
__device__ __forceinline__ int first_tile(int q0, int window, int bk) {
  return window > 0 ? max(0, q0 - window + 1) / bk * bk : 0;
}

// ---------------------------------------------------------------------------
// bfloat16: the Hopper attention tile (attn_tile.cuh)
// ---------------------------------------------------------------------------

namespace tile {

template <int D>
__global__ void __launch_bounds__(at::warpgroups<D>() * 128, 1) flash_prefill_bf16(Args a) {
  constexpr int nwg = at::warpgroups<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = a.Hq / a.Hkv;
  const int bq = 64 * nwg / G;             // positions a block serves
  // grid (Hkv, B, query tiles), the last tiles (the most keys) first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * bq;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int plen = min(a.prompt_lens[b], a.T);
  Tile t;
  t.kvh = kvh;
  t.pos0 = q0;
  t.total = plen;
  t.n_write = min(bq, a.T - q0);
  t.n_valid = q0 < plen ? t.n_write : 0;   // a block wholly past the prompt writes 0
  const size_t off = (static_cast<size_t>(b) * a.T + q0) * a.Hq * D;
  t.q = static_cast<const __nv_bfloat16*>(a.q) + off;
  t.out = static_cast<__nv_bfloat16*>(a.out) + off;
  t.bt = nullptr;
  const WindowArgs w{a.k, a.v, nullptr, nullptr, a.Hq, a.Hkv, 0, a.scale, a.window, a.softcap};
  const at::DenseSrc src{static_cast<size_t>(b) * a.T * a.Hkv + kvh, a.Hkv};
  at::attn_tile<__nv_bfloat16, D, nwg>(w, t, src, smem);
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int nwg = at::warpgroups<D>();
  constexpr int bytes = at::Smem<__nv_bfloat16, D, nwg>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int bq = 64 * nwg / (a.Hq / a.Hkv);
  const dim3 grid(a.Hkv, a.B, (a.T + bq - 1) / bq);
  flash_prefill_bf16<D><<<grid, 128 * nwg, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tile

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBq = 32;        // query rows per block
constexpr int kBk = 32;        // key rows per tile

template <int D>
constexpr int smem_floats() {
  return kBq * D + kBk * (D + 1) + kBk * D + kBq * (kBk + 1) + 3 * kBq;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_f32(Args a) {
  constexpr int kAcc = kBq * D / kThreads;   // output elements per thread
  extern __shared__ float smem[];
  float* qs = smem;                          // [kBq][D]
  float* ks = qs + kBq * D;                  // [kBk][D + 1]
  float* vs = ks + kBk * (D + 1);            // [kBk][D]
  float* ps = vs + kBk * D;                  // [kBq][kBk + 1]
  float* row_m = ps + kBq * (kBk + 1);       // [kBq]
  float* row_l = row_m + kBq;
  float* row_alpha = row_l + kBq;

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* out = static_cast<float*>(a.out);

  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int plen = min(a.prompt_lens[b], a.T);

  for (int idx = tid; idx < kBq * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = q0 + r;
    qs[idx] = row < a.T ? q[((static_cast<size_t>(b) * a.T + row) * a.Hq + h) * D + d] : 0.f;
  }
  if (tid < kBq) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // a block wholly past the prompt reads no key (its rows get 0)
  const int kv_end = q0 < plen ? min(q0 + kBq, plen) : 0;
  for (int k0 = first_tile(q0, a.window, kBk); k0 < kv_end; k0 += kBk) {
    __syncthreads();   // previous tile's ps / vs fully consumed
    for (int idx = tid; idx < kBk * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int key = k0 + r;
      const size_t off = ((static_cast<size_t>(b) * a.T + key) * a.Hkv + hk) * D + d;
      ks[r * (D + 1) + d] = key < a.T ? k[off] : 0.f;
      vs[r * D + d] = key < plen ? v[off] : 0.f;
    }
    __syncthreads();

    // S = Q K^T: lane = key column, each thread 8 rows
    {
      const int c = lane;
      float s[kBq / 4];
#pragma unroll
      for (int j = 0; j < kBq / 4; ++j) s[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = ks[c * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < kBq / 4; ++j) s[j] += qs[(warp + 4 * j) * D + d] * kv;
      }
#pragma unroll
      for (int j = 0; j < kBq / 4; ++j) {
        const int r = warp + 4 * j;
        ps[r * (kBk + 1) + c] =
            key_ok(k0 + c, q0 + r, plen, a.window) ? score(s[j], a) : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: each warp owns 8 rows, lane = key column
    for (int r = warp; r < kBq; r += 4) {
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

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + kThreads * i;
    const int r = e / D, d = e % D;
    const int row = q0 + r;
    if (row >= a.T) continue;
    const float l = row_l[r];
    out[((static_cast<size_t>(b) * a.T + row) * a.Hq + h) * D + d] = l > 0.f ? acc[i] / l : 0.f;
  }
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kBq - 1) / kBq, a.Hq, a.B);
  flash_prefill_f32<D><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace f32

template <int D>
cudaError_t by_dtype(const Args& a, int dtype, cudaStream_t stream) {
  if (dtype == 0) return f32::launch<D>(a, stream);
  if (dtype == 1) return tile::launch<D>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out share it).  window and
// softcap: 0 = off.  Returns the launch's cudaError_t (0 on success).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const int* prompt_lens, void* out, int B, int T, int Hq,
                             int Hkv, int D, float scale, int window, float softcap,
                             int dtype, void* stream) {
  if (B == 0 || T == 0) return 0;
  Args a{q, k, v, prompt_lens, out, B, T, Hq, Hkv, scale, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return by_dtype<64>(a, dtype, s);
    case 96: return by_dtype<96>(a, dtype, s);
    case 128: return by_dtype<128>(a, dtype, s);
    case 256: return by_dtype<256>(a, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}
