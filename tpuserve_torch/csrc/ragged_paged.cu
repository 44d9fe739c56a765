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
// Design: a one-dimensional grid sized from what the host knows (T, blk,
// Hkv, the sequence count B and the SM count), so the wrapper never reads
// meta or blk_seq back to the host.  Its first part has one block a
// (flat block p, tile z, KV head), tiles only as many as a flat block
// holds; its second part runs the decode rows.  Each block reads the
// descriptors and learns its role:
// - prefill tile (blk_seq[p] >= 0): the flat block's blk rows x G heads
//   are cut into tiles of bq = 64 / G positions (32 / G in float32), and
//   block (p, z, kvh) runs tile z at the chunk's cache positions.  bf16:
//   at::attn_tile (attn_tile.cuh), the Hopper core paged_window.cu and
//   flash_prefill.cu run, with one consumer warpgroup (64 rows: blk 32 x
//   Qwen3's G = 2); float32: wf32::window_tile (window_tile.cuh).
// - decode-region block (p < meta[1]) or padding block (blk_seq[p] < 0):
//   tile 0 writes 0 to the rows that serve no query (past meta[0] in the
//   decode region, all rows of a padding block); the other tiles exit.
// - decode rows: the split-K body of paged_decode.cu (split_decode,
//   paged_decode.cuh), with its partials and in-launch merge.  Only the
//   device knows the decode-row count n = meta[0], so each decode block
//   chooses the partitions from n by the host's rule (decode_splits) and
//   takes item (split, row, KV head) of the S x n x Hkv; the wrapper sizes
//   this part to the most items any n <= min(B, T) needs (ops/paged_decode.py
//   ragged_decode_blocks), and blocks past the n x Hkv x S items exit.
// Right for any blk (a power of two from 8 to 128 is what the engine
// packs).

#include "paged_decode.cuh"
#include "window_tile.cuh"

namespace {

constexpr int kThreads = 128;   // every part runs 4 warps
static_assert(wf32::kThreads == kThreads && kDecThreads == kThreads,
              "one block shape: one warpgroup");

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
  SplitK k;                  // part, counters; splits chosen on the device
  int num_sms;
  int tiles;                 // tiles a flat block: ceil(blk / bq)
  int n_tile_blocks;         // the grid's first part: T / blk x tiles x Hkv
};

// Two blocks an SM, as the tile's shared memory allows anyway: told so, the
// compiler gives the prefill tile more registers beside the decode body
// (188 rather than 168 at D=128, G=2 on sm_90a).
template <typename QT, typename KVT, int D, int MAXG>
__global__ void __launch_bounds__(kThreads, 2) ragged_paged_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kTc = sizeof(QT) == 2;
  constexpr int kRows = kTc ? 64 : wf32::kRows;
  const int Hq = a.w.Hq, Hkv = a.w.Hkv;
  const int G = Hq / Hkv;

  if (static_cast<int>(blockIdx.x) >= a.n_tile_blocks) {     // decode rows
    const int x = blockIdx.x - a.n_tile_blocks;
    const int n_dec = a.meta[0];
    SplitK k = a.k;
    decode_splits(n_dec, Hkv, a.max_pages, a.w.page_size, a.num_sms, k.splits, k.part_pages);
    if (x >= n_dec * Hkv * k.splits) return;
    // partitions vary slowest: every row's first partitions come first, so
    // the blocks short rows need start beside the prefill tiles
    const int split = x / (n_dec * Hkv), r = x / Hkv % n_dec;
    const DecodeArgs d{a.q, a.w.k_cache, a.w.v_cache, a.w.k_scale, a.w.v_scale,
                       a.block_tables, a.out, Hq, Hkv, a.w.page_size, a.max_pages,
                       a.w.scale, a.w.window, a.w.softcap};
    split_decode<QT, KVT, D, MAXG>(d, k, r, x % Hkv, split, a.kv_lens[r], smem);
    return;
  }
  const int p = blockIdx.x / (a.tiles * Hkv);
  const int z = blockIdx.x / Hkv % a.tiles;
  const int kvh = blockIdx.x % Hkv;
  const int row0 = p * a.blk;
  QT* out = static_cast<QT*>(a.out);
  const int s = p < a.meta[1] ? -1 : a.blk_seq[p];
  if (s < 0) {             // decode-region or padding block: rows serving no query are 0
    if (z != 0) return;
    const int r0 = p < a.meta[1] ? max(row0, a.meta[0]) : row0;
    for (int idx = threadIdx.x; idx < (row0 + a.blk - r0) * G * D; idx += kThreads) {
      const int i = idx / (G * D), e = idx % (G * D);
      out[(static_cast<size_t>(r0 + i) * Hq + kvh * G) * D + e] = from_float<QT>(0.f);
    }
    return;
  }
  const int bq = kRows / G;                          // positions per window tile
  const int i0 = z * bq;
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

template <typename QT, typename KVT, int D>
constexpr int smem_bytes(int max_pages) {
  constexpr int tile = sizeof(QT) == 2 ? at::Smem<KVT, D, 1>::bytes : wf32::smem_bytes<D>();
  const int dec = DecSmem<KVT, D>::bytes(max_pages);
  return tile > dec ? tile : dec;
}

template <typename QT, typename KVT, int D, int MAXG>
cudaError_t launch(Args a, int T, int dec_blocks, cudaStream_t stream) {
  constexpr int kRows = sizeof(QT) == 2 ? 64 : wf32::kRows;
  const int G = a.w.Hq / a.w.Hkv;
  // the most partitions a row can get (one page each, or the block budget)
  const int max_splits = min(max(a.max_pages, 1), kDecWaves * a.num_sms);
  if (max_splits * G > DecSmem<KVT, D>::kWeights) return cudaErrorInvalidValue;
  a.tiles = (a.blk + kRows / G - 1) / (kRows / G);
  a.n_tile_blocks = T / a.blk * a.tiles * a.w.Hkv;
  const int bytes = smem_bytes<QT, KVT, D>(a.max_pages);
  auto kernel = ragged_paged_kernel<QT, KVT, D, MAXG>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<a.n_tile_blocks + dec_blocks, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t by_shape(const Args& a, int T, int D, int dec_blocks, cudaStream_t stream) {
  const bool small = a.w.Hq / a.w.Hkv <= 2;
  switch (D) {
    case 64:
      return small ? launch<QT, KVT, 64, 2>(a, T, dec_blocks, stream)
                   : launch<QT, KVT, 64, 8>(a, T, dec_blocks, stream);
    case 96:
      return small ? launch<QT, KVT, 96, 2>(a, T, dec_blocks, stream)
                   : launch<QT, KVT, 96, 8>(a, T, dec_blocks, stream);
    case 128:
      return small ? launch<QT, KVT, 128, 2>(a, T, dec_blocks, stream)
                   : launch<QT, KVT, 128, 8>(a, T, dec_blocks, stream);
    case 256:
      return small ? launch<QT, KVT, 256, 2>(a, T, dec_blocks, stream)
                   : launch<QT, KVT, 256, 8>(a, T, dec_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32, 1 bfloat16, 2 int8
// (then k_scale / v_scale are required).  T must be a multiple of blk.
// The decode rows take `dec_blocks` blocks (enough for the n x Hkv x S
// items of any n <= min(B, T)), `part` dec_blocks records of
// split_stride(G, D) floats and `counters` B x Hkv int32 zeros (left zero).
// Returns the launch's cudaError_t (0 on success).
extern "C" int ragged_paged(const void* q, const void* k_cache, const void* v_cache,
                            const float* k_scale, const float* v_scale,
                            const int* block_tables, const int* kv_lens,
                            const int* q_starts, const int* q_lens, const int* meta,
                            const int* blk_seq, void* out, float* part, int* counters,
                            int T, int Hq, int Hkv, int D, int page_size, int max_pages,
                            int blk, int num_sms, int dec_blocks, float scale, int window,
                            float softcap, int q_dtype, int kv_dtype, void* stream) {
  if (T == 0) return 0;
  if (blk <= 0 || T % blk != 0 || Hq % Hkv != 0 || Hq / Hkv > 8 || num_sms < 1 ||
      dec_blocks < 0)
    return cudaErrorInvalidValue;
  Args a{q, out, block_tables, kv_lens, q_starts, q_lens, meta, blk_seq, max_pages, blk,
         {k_cache, v_cache, k_scale, v_scale, Hq, Hkv, page_size, scale, window, softcap},
         {part, counters, 1, 1}, num_sms, 1, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return by_shape<float, float>(a, T, D, dec_blocks, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_shape<__nv_bfloat16, __nv_bfloat16>(a, T, D, dec_blocks, s);
  if (q_dtype == 0 && kv_dtype == 2) return by_shape<float, int8_t>(a, T, D, dec_blocks, s);
  if (q_dtype == 1 && kv_dtype == 2)
    return by_shape<__nv_bfloat16, int8_t>(a, T, D, dec_blocks, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one block (dtypes as above), for reports.
extern "C" int ragged_paged_smem_bytes(int q_dtype, int kv_dtype, int D, int max_pages) {
  switch (q_dtype * 10000 + kv_dtype * 1000 + D) {
    case 64: return smem_bytes<float, float, 64>(max_pages);
    case 96: return smem_bytes<float, float, 96>(max_pages);
    case 128: return smem_bytes<float, float, 128>(max_pages);
    case 256: return smem_bytes<float, float, 256>(max_pages);
    case 2064: return smem_bytes<float, int8_t, 64>(max_pages);
    case 2096: return smem_bytes<float, int8_t, 96>(max_pages);
    case 2128: return smem_bytes<float, int8_t, 128>(max_pages);
    case 2256: return smem_bytes<float, int8_t, 256>(max_pages);
    case 11064: return smem_bytes<__nv_bfloat16, __nv_bfloat16, 64>(max_pages);
    case 11096: return smem_bytes<__nv_bfloat16, __nv_bfloat16, 96>(max_pages);
    case 11128: return smem_bytes<__nv_bfloat16, __nv_bfloat16, 128>(max_pages);
    case 11256: return smem_bytes<__nv_bfloat16, __nv_bfloat16, 256>(max_pages);
    case 12064: return smem_bytes<__nv_bfloat16, int8_t, 64>(max_pages);
    case 12096: return smem_bytes<__nv_bfloat16, int8_t, 96>(max_pages);
    case 12128: return smem_bytes<__nv_bfloat16, int8_t, 128>(max_pages);
    case 12256: return smem_bytes<__nv_bfloat16, int8_t, 256>(max_pages);
    default: return -1;
  }
}
