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
// it and only the tensor cores come near the bound.
//
// Design (a simple first kernel, not yet fast): grid (ceil(C / bq), Hkv,
// B), bq = 64 / G query positions (32 / G in float32), one block per
// (sequence, query tile, KV head) so the G query heads sharing a KV head
// share every K/V tile it loads.  The block reads its own block-table row,
// ctx_lens[b] and chunk_lens[b], and runs window_tile (window_tile.cuh):
// K/V tiles from the window start of its first row to the causal limit of
// its last, only written keys ever read, online softmax in float32, WMMA
// for bf16.  Unlike the TPU kernel it does no page-group DMA pipeline;
// cp.async / TMA double buffering and wgmma are the next steps.

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

template <int kRows>
__device__ __forceinline__ Tile make_tile(const Args& a, int D, int elem_size) {
  const int G = a.w.Hq / a.w.Hkv;
  const int bq = kRows / G;
  const int b = blockIdx.z;
  const int i0 = blockIdx.x * bq;
  const int ctx = a.ctx_lens[b];
  const int n = a.chunk_lens[b];
  Tile t;
  t.kvh = blockIdx.y;
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
__global__ void __launch_bounds__(wtc::kThreads) paged_window_bf16(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile t = make_tile<wtc::kRows>(a, D, 2);
  wtc::window_tile<KVT, D>(a.w, t, smem);
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
  const dim3 grid((a.C + bq - 1) / bq, a.w.Hkv, B);
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_dtype(const Args& a, int B, int q_dtype, int kv_dtype, cudaStream_t s) {
  if (q_dtype == 1 && kv_dtype == 1)
    return launch(paged_window_bf16<__nv_bfloat16, D>, wtc::Smem<D>::bytes, wtc::kRows, a,
                  B, wtc::kThreads, s);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch(paged_window_bf16<int8_t, D>, wtc::Smem<D>::bytes, wtc::kRows, a, B,
                  wtc::kThreads, s);
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
    case 128: return by_dtype<128>(a, B, q_dtype, kv_dtype, s);
    case 256: return by_dtype<256>(a, B, q_dtype, kv_dtype, s);
    default: return cudaErrorInvalidValue;
  }
}
