// Paged window attention for Hopper (sm_90a): a C-row query window per
// sequence against its cached context, causal within the window.
//
// Replaces the TPU kernel `paged_window_attention` / `_window_kernel` in
// tpuserve/ops/pallas_chunked_prefill.py.  Same contract as the plain
// version `chunked_prefill_attention` in tpuserve_torch/ops/attention.py:
// q (B, C, Hq, D), the window's K/V already written into the paged cache
// (num_blocks, page, Hkv, D) in q's dtype or int8 with f32 scales
// (num_blocks, page, Hkv); query row i of sequence b sits at cache
// position ctx_lens[b] + i; grouped-query heads, optional sliding window
// and softcap.  Rows at or past chunk_lens[b] are written as 0.
//
// What bounds it on this card: for a chunk of n rows over ctx cached keys
// it does 4 * Hq * D * (n * ctx + n^2 / 2) FLOPs for about
// 2 * Hkv * D * (ctx + n) cached values read; at the chunked path's
// 2,048-row chunks that is hundreds of FLOPs per byte, so operations bound
// it and only the tensor cores through wgmma come near the bound.
//
// Design: one block per (sequence, query tile, KV head), so the G query
// heads sharing a KV head share every K/V tile it loads; grid (Hkv, B,
// query tiles), the last tiles (the most keys) dispatched first.  The
// block reads its own block-table row, ctx_lens[b] and chunk_lens[b].
// bf16: at::attn_tile (attn_tile.cuh): two consumer warpgroups, 128 rows
// (bq = 128 / G positions; one warpgroup, 64 rows, at D=256), 128-key K/V
// tiles (64 for int8 or D=256) in a 2-stage cp.async ring on mbarriers,
// S = QK^T and O += PV on wgmma with S, P and O in registers; at D=128
// 161 KB of shared memory and 255 registers a thread, one block an SM.
// What it does about the WMMA tile it replaces:
// 1. scores, probabilities and output stay in registers; the softmax works
//    on the accumulator fragment with quad shuffles, not row by row
//    through shared memory;
// 2. K/V loads are asynchronous and run under the math, one block barrier
//    a tile; each warp reads a tile's block-table entries once;
// 3. wgmma (m64n128k16 for S, m64n128k16 with P from registers for PV)
//    replaces 16x16x16 WMMA;
// 4. a tile holds 128 rows, not 64, so each pass over a 4,096-6,000-key
//    context serves twice the queries; 128-key tiles halve the per-tile
//    waits;
// 5. (flash prefill's K/V reuse; here each K/V tile already served all G
//    heads.)
// Only written keys are read.  float32 queries: wf32::window_tile
// (window_tile.cuh) on the CUDA cores.

#include "window_tile.cuh"

namespace {

struct Args {
  const void* q;
  void* out;
  const int* block_tables;
  const int* ctx_lens;
  const int* chunk_lens;
  int C, max_pages;
  WindowArgs w;
};

// grid (Hkv, B, query tiles), the last query tiles (the most keys) first
template <int kRows>
__device__ __forceinline__ Tile make_tile(const Args& a, int D, int elem_size) {
  const int G = a.w.Hq / a.w.Hkv;
  const int bq = kRows / G;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * bq;
  const int ctx = a.ctx_lens[b];
  const int n = a.chunk_lens[b];
  Tile t;
  t.kvh = kvh;
  t.pos0 = ctx + i0;
  t.total = ctx + n;
  t.n_write = min(bq, a.C - i0);
  t.n_valid = max(0, min(t.n_write, n - i0));
  const size_t off = (static_cast<size_t>(b) * a.C + i0) * a.w.Hq * D * elem_size;
  t.q = static_cast<const unsigned char*>(a.q) + off;
  t.out = static_cast<unsigned char*>(a.out) + off;
  t.bt = a.block_tables + static_cast<size_t>(b) * a.max_pages;
  return t;
}

template <typename KVT, int D>
__global__ void __launch_bounds__(at::warpgroups<D>() * 128, 1) paged_window_bf16(Args a) {
  constexpr int nwg = at::warpgroups<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile t = make_tile<64 * nwg>(a, D, 2);
  const at::PagedSrc src{t.bt, a.w.page_size, a.w.Hkv, t.kvh};
  at::attn_tile<KVT, D, nwg>(a.w, t, src, smem);
}

template <typename KVT, int D>
__global__ void __launch_bounds__(wf32::kThreads) paged_window_f32(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile t = make_tile<wf32::kRows>(a, D, 4);
  wf32::window_tile<KVT, D>(a.w, t, smem);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int bytes, int rows, const Args& a, int B,
                   int threads, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int bq = rows / (a.w.Hq / a.w.Hkv);
  kernel<<<dim3(a.w.Hkv, B, (a.C + bq - 1) / bq), threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_dtype(const Args& a, int B, int q_dtype, int kv_dtype, cudaStream_t s) {
  constexpr int nwg = at::warpgroups<D>();
  if (q_dtype == 1 && kv_dtype == 1)
    return launch(paged_window_bf16<__nv_bfloat16, D>, at::Smem<__nv_bfloat16, D, nwg>::bytes,
                  64 * nwg, a, B, 128 * nwg, s);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch(paged_window_bf16<int8_t, D>, at::Smem<int8_t, D, nwg>::bytes, 64 * nwg, a,
                  B, 128 * nwg, s);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch(paged_window_f32<float, D>, wf32::smem_bytes<D>(), wf32::kRows, a, B,
                  wf32::kThreads, s);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch(paged_window_f32<int8_t, D>, wf32::smem_bytes<D>(), wf32::kRows, a, B,
                  wf32::kThreads, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32, 1 bfloat16, 2 int8
// (then k_scale / v_scale are required).  window and softcap: 0 = off.
// The output has q's type.  Returns the launch's cudaError_t (0 on success).
extern "C" int paged_window(const void* q, const void* k_cache, const void* v_cache,
                            const float* k_scale, const float* v_scale,
                            const int* block_tables, const int* ctx_lens,
                            const int* chunk_lens, void* out, int B, int C, int Hq,
                            int Hkv, int D, int page_size, int max_pages, float scale,
                            int window, float softcap, int q_dtype, int kv_dtype,
                            void* stream) {
  if (B == 0 || C == 0) return 0;
  if (Hq % Hkv != 0 || Hq / Hkv > 8) return cudaErrorInvalidValue;
  Args a{q, out, block_tables, ctx_lens, chunk_lens, C, max_pages,
         {k_cache, v_cache, k_scale, v_scale, Hq, Hkv, page_size, scale, window, softcap}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return by_dtype<64>(a, B, q_dtype, kv_dtype, s);
    case 96: return by_dtype<96>(a, B, q_dtype, kv_dtype, s);
    case 128: return by_dtype<128>(a, B, q_dtype, kv_dtype, s);
    case 256: return by_dtype<256>(a, B, q_dtype, kv_dtype, s);
    default: return cudaErrorInvalidValue;
  }
}
