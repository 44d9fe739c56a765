// Ragged paged attention for Hopper (sm_90a): one flat stream of decode
// rows and prefill-chunk rows in one launch.
//
// Replaces the TPU kernel `ragged_paged_attention` / `_ragged_kernel` in
// tpuserve/ops/pallas_ragged_attention.py.  Same contract as the plain
// version `ragged_paged_attention` in tpuserve_torch/ops/attention.py:
// q (T, Hq, D); rows [0, meta[0]) are decode rows (row r = sequence r),
// the decode region is padded to a multiple of `blk` (meta[1] blocks), then
// every prefill chunk starts blk-aligned; per sequence kv_lens (cached
// tokens including this step's), q_starts (first flat row) and q_lens;
// blk_seq (T / blk) names the sequence of each prefill block, -1 for
// decode-region and padding blocks.  Paged cache in q's dtype or int8 with
// f32 scales; sliding window and softcap.  Rows that serve no query
// (decode-region padding, padding blocks, rows past a chunk) write 0.
//
// What bounds it on this card: decode rows are bytes-bound (each cached
// K/V row read once for G dot products, as in paged_decode.cu); prefill
// blocks are the window kernel's work and operations-bound once chunks
// are long.
//
// Design (a simple first kernel): the grid is sized from T, blk and Hkv
// alone, (T / blk, Hkv, blk), so the wrapper never reads meta or blk_seq
// back to the host.  Each block reads them and learns its role:
// - decode block p < meta[1]: block (p, kvh, z) serves decode row
//   p * blk + z for KV head kvh with paged_decode_row (paged_decode.cuh),
//   the per-row math of the phase-split decode kernel; rows past meta[0]
//   write 0.
// - prefill block (blk_seq[p] >= 0): its blk rows x G heads are split into
//   tiles of bq = 64 / G positions (32 / G in float32); block (p, kvh, z)
//   runs tile z at the chunk's cache positions.  bf16: at::attn_tile
//   (attn_tile.cuh), the Hopper core paged_window.cu and flash_prefill.cu
//   run, with one consumer warpgroup (64 rows: blk 32 x Qwen3's G = 2), so
//   its wgmma products, register softmax and asynchronous K/V ring serve
//   these blocks too; float32: wf32::window_tile (window_tile.cuh).  Blocks
//   with z past the last tile exit at once.
// - padding block: block (p, kvh, 0) writes zeros; the rest exit.
// Right for any blk (a power of two from 8 to 128 is what the engine
// packs); blocks that exit at once cost a few microseconds of launch.

#include "paged_decode.cuh"
#include "window_tile.cuh"

namespace {

constexpr int kThreads = 128;   // both parts run 4 warps
static_assert(wf32::kThreads == kThreads, "one block shape: one warpgroup");

struct Args {
  const void* q;
  void* out;
  const int* block_tables;   // (B, max_pages)
  const int* kv_lens;        // (B,)
  const int* q_starts;
  const int* q_lens;
  const int* meta;           // (2,): [num_decode_rows, num_decode_blocks]
  const int* blk_seq;        // (T / blk,)
  int max_pages, blk;
  WindowArgs w;
};

template <typename QT, typename KVT, int D, int MAXG>
__global__ void __launch_bounds__(kThreads) ragged_paged_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kTc = sizeof(QT) == 2;
  constexpr int kRows = kTc ? 64 : wf32::kRows;
  const int p = blockIdx.x;
  const int kvh = blockIdx.y;
  const int z = blockIdx.z;
  const int Hq = a.w.Hq;
  const int G = Hq / a.w.Hkv;
  const int row0 = p * a.blk;

  if (p < a.meta[1]) {                               // decode rows
    const int r = row0 + z;
    const DecodeArgs d{a.q, a.w.k_cache, a.w.v_cache, a.w.k_scale, a.w.v_scale,
                       a.block_tables, a.out, Hq, a.w.Hkv, a.w.page_size, a.max_pages,
                       a.w.scale, a.w.window, a.w.softcap};
    paged_decode_row<QT, KVT, D, MAXG, kThreads / 32>(
        d, r, kvh, r < a.meta[0] ? a.kv_lens[r] : 0, reinterpret_cast<float*>(smem));
    return;
  }
  const int s = a.blk_seq[p];
  QT* out = static_cast<QT*>(a.out);
  if (s < 0) {                                       // padding block
    if (z != 0) return;
    for (int idx = threadIdx.x; idx < a.blk * G * D; idx += kThreads) {
      const int i = idx / (G * D), e = idx % (G * D);
      out[(static_cast<size_t>(row0 + i) * Hq + kvh * G) * D + e] = from_float<QT>(0.f);
    }
    return;
  }
  const int bq = kRows / G;                          // positions per window tile
  const int i0 = z * bq;
  if (i0 >= a.blk) return;
  const int q_len = a.q_lens[s];
  const int kv_len = a.kv_lens[s];
  const int ci = row0 + i0 - a.q_starts[s];          // chunk index of the tile's row 0
  Tile t;
  t.kvh = kvh;
  t.pos0 = kv_len - q_len + ci;
  t.total = kv_len;
  t.n_write = min(bq, a.blk - i0);
  t.n_valid = max(0, min(t.n_write, q_len - ci));
  const size_t off = static_cast<size_t>(row0 + i0) * Hq * D;
  t.q = static_cast<const QT*>(a.q) + off;
  t.out = out + off;
  t.bt = a.block_tables + static_cast<size_t>(s) * a.max_pages;
  if constexpr (kTc)
    at::attn_tile<KVT, D, 1>(a.w, t, at::PagedSrc{t.bt, a.w.page_size, a.w.Hkv, kvh}, smem);
  else
    wf32::window_tile<KVT, D>(a.w, t, smem);
}

template <typename QT, typename KVT, int D, int MAXG>
cudaError_t launch(const Args& a, int T, cudaStream_t stream) {
  constexpr int tile = sizeof(QT) == 2 ? at::Smem<KVT, D, 1>::bytes : wf32::smem_bytes<D>();
  constexpr int dec = 4 * decode_smem_floats<D, MAXG, kThreads / 32>();
  constexpr int bytes = tile > dec ? tile : dec;
  auto kernel = ragged_paged_kernel<QT, KVT, D, MAXG>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(T / a.blk, a.w.Hkv, a.blk), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t by_shape(const Args& a, int T, int D, cudaStream_t stream) {
  const bool small = a.w.Hq / a.w.Hkv <= 2;
  switch (D) {
    case 64: return small ? launch<QT, KVT, 64, 2>(a, T, stream) : launch<QT, KVT, 64, 8>(a, T, stream);
    case 128: return small ? launch<QT, KVT, 128, 2>(a, T, stream) : launch<QT, KVT, 128, 8>(a, T, stream);
    case 256: return small ? launch<QT, KVT, 256, 2>(a, T, stream) : launch<QT, KVT, 256, 8>(a, T, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32, 1 bfloat16, 2 int8
// (then k_scale / v_scale are required).  T must be a multiple of blk.
// Returns the launch's cudaError_t (0 on success).
extern "C" int ragged_paged(const void* q, const void* k_cache, const void* v_cache,
                            const float* k_scale, const float* v_scale,
                            const int* block_tables, const int* kv_lens,
                            const int* q_starts, const int* q_lens, const int* meta,
                            const int* blk_seq, void* out, int T, int Hq, int Hkv, int D,
                            int page_size, int max_pages, int blk, float scale, int window,
                            float softcap, int q_dtype, int kv_dtype, void* stream) {
  if (T == 0) return 0;
  if (blk <= 0 || T % blk != 0 || Hq % Hkv != 0 || Hq / Hkv > 8) return cudaErrorInvalidValue;
  Args a{q, out, block_tables, kv_lens, q_starts, q_lens, meta, blk_seq, max_pages, blk,
         {k_cache, v_cache, k_scale, v_scale, Hq, Hkv, page_size, scale, window, softcap}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return by_shape<float, float>(a, T, D, s);
  if (q_dtype == 1 && kv_dtype == 1) return by_shape<__nv_bfloat16, __nv_bfloat16>(a, T, D, s);
  if (q_dtype == 0 && kv_dtype == 2) return by_shape<float, int8_t>(a, T, D, s);
  if (q_dtype == 1 && kv_dtype == 2) return by_shape<__nv_bfloat16, int8_t>(a, T, D, s);
  return cudaErrorInvalidValue;
}
