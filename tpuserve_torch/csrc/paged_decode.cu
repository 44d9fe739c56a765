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
// Design (the per-row body is paged_decode_row in paged_decode.cuh, which
// ragged_paged.cu's decode rows share):
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

#include "paged_decode.cuh"

namespace {

struct Args {
  DecodeArgs d;
  const int* seq_lens;
  int B;
};

template <typename QT, typename KVT, int D, int MAXG, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_kernel(Args a) {
  __shared__ float smem[decode_smem_floats<D, MAXG, NWARPS>()];
  const int b = blockIdx.x;
  paged_decode_row<QT, KVT, D, MAXG, NWARPS>(a.d, b, blockIdx.y, a.seq_lens[b], smem);
}

template <typename QT, typename KVT, int D, int MAXG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kWarps = MAXG <= 2 ? 8 : 4;
  paged_decode_kernel<QT, KVT, D, MAXG, kWarps>
      <<<dim3(a.B, a.d.Hkv), kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t by_shape(const Args& a, int D, cudaStream_t stream) {
  const int G = a.d.Hq / a.d.Hkv;
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
  Args a{{q, k_cache, v_cache, k_scale, v_scale, block_tables, out, Hq, Hkv, page_size,
          max_pages, scale, window, softcap},
         seq_lens, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return by_shape<float, float>(a, D, s);
  if (q_dtype == 1 && kv_dtype == 1) return by_shape<__nv_bfloat16, __nv_bfloat16>(a, D, s);
  if (q_dtype == 0 && kv_dtype == 2) return by_shape<float, int8_t>(a, D, s);
  if (q_dtype == 1 && kv_dtype == 2) return by_shape<__nv_bfloat16, int8_t>(a, D, s);
  return cudaErrorInvalidValue;
}
