// Paged single-token decode attention for Hopper (sm_90a), split-K.
//
// Replaces the TPU kernel `paged_decode_attention` / `_paged_decode_kernel`
// in tpuserve/ops/pallas_paged_attention.py.  Same contract as the plain
// version `paged_decode_attention` in tpuserve_torch/ops/attention.py:
// one query token per sequence against its K/V pages, found through
// `block_tables` and `seq_lens` (which counts the token being decoded),
// grouped-query heads, optional int8 pages with one f32 scale per
// (block, position, kv head), optional sliding window and softcap.
//
// What the TPU kernel did: one program took `seqs_pp` sequences and walked
// each one's pages in order, double-buffering page DMAs into VMEM, with the
// grid running in order on one core.  That does not carry over: the card
// runs blocks in parallel on 132 SMs and hides memory latency only with
// many bytes in flight, so one block a (sequence, KV head) walking pages in
// order leaves most SMs idle at small batch and waits one memory round
// trip a step (the first port's design: 64 blocks at batch 8, 7% of the
// bound on an H100).
//
// What bounds it on this card: bytes.  Every cached K and V row of the
// attended range is read once per step and used for `group` dot products
// (2 for Qwen3-0.6B), about one FLOP per byte against the H100's ~295 for
// bf16 tensor cores, so the kernel can at best run at HBM bandwidth: the
// design aims at enough blocks and enough bytes in flight to reach it.
//
// Design (the body is split_decode in paged_decode.cuh, which
// ragged_paged.cu's decode rows share):
// - Grid (S, Hkv, B): each sequence's keys are cut into S partitions of
//   whole pages, S chosen by the wrapper from max_pages x page, B, Hkv and
//   the SM count alone (ops/paged_decode.py decode_splits: about eight
//   blocks an SM, no partition under 128 keys), so nothing is read back to
//   the host.  A block whose partition lies past seq_len or before the
//   window exits at once.
// - Each block streams its partition's K/V through a 3-stage cp.async ring
//   on mbarriers (8 KB of K and 8 KB of V a stage, up to 48 KB in flight;
//   four blocks an SM), its block-table entries read once a page into
//   shared memory.
// - The math stays on the CUDA cores: a float32 online softmax per lane
//   group, merged by shuffles and through shared memory.
// - Partials (acc, m, l) go to float32 scratch the wrapper owns; the last
//   block of a (sequence, KV head) to finish, found by an int32 counter it
//   then sets back to 0, merges them with log-sum-exp weights in the same
//   launch.  A sequence inside one partition is written directly.
// What bounds the design: the longest partition's walk (one block streams
// it alone), the merge's dependent reads of the partials, and launch cost.

#include "paged_decode.cuh"

namespace {

struct Args {
  DecodeArgs d;
  SplitK k;
  const int* seq_lens;
  int B;
};

template <typename QT, typename KVT, int D, int MAXG>
__global__ void __launch_bounds__(kDecThreads) paged_decode_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z;
  split_decode<QT, KVT, D, MAXG>(a.d, a.k, b, blockIdx.y, blockIdx.x, a.seq_lens[b], smem);
}

template <typename QT, typename KVT, int D, int MAXG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = DecSmem<KVT, D>;
  if (a.k.splits * (a.d.Hq / a.d.Hkv) > L::kWeights) return cudaErrorInvalidValue;
  const int bytes = L::bytes(a.k.part_pages);
  auto kernel = paged_decode_kernel<QT, KVT, D, MAXG>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.k.splits, a.d.Hkv, a.B), kDecThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t by_shape(const Args& a, int D, cudaStream_t stream) {
  const int G = a.d.Hq / a.d.Hkv;
  if (G > 8) return cudaErrorInvalidValue;
  const bool small = G <= 2;
  switch (D) {
    case 64: return small ? launch<QT, KVT, 64, 2>(a, stream) : launch<QT, KVT, 64, 8>(a, stream);
    case 96: return small ? launch<QT, KVT, 96, 2>(a, stream) : launch<QT, KVT, 96, 8>(a, stream);
    case 128: return small ? launch<QT, KVT, 128, 2>(a, stream) : launch<QT, KVT, 128, 8>(a, stream);
    case 256: return small ? launch<QT, KVT, 256, 2>(a, stream) : launch<QT, KVT, 256, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32, 1 bfloat16, 2 int8
// (then k_scale / v_scale are required).  The output has q's type.
// `part` holds B x Hkv x splits records of split_stride(G, D) floats and
// `counters` B x Hkv int32 zeros (left zero); both are used only when
// splits > 1.  Returns the launch's cudaError_t (0 on success).
extern "C" int paged_decode(const void* q, const void* k_cache, const void* v_cache,
                            const float* k_scale, const float* v_scale,
                            const int* block_tables, const int* seq_lens, void* out,
                            float* part, int* counters, int B, int Hq, int Hkv, int D,
                            int page_size, int max_pages, int splits, int part_pages,
                            float scale, int window, float softcap, int q_dtype,
                            int kv_dtype, void* stream) {
  if (B == 0) return 0;
  if (splits < 1 || part_pages < 1 || splits > 65535) return cudaErrorInvalidValue;
  Args a{{q, k_cache, v_cache, k_scale, v_scale, block_tables, out, Hq, Hkv, page_size,
          max_pages, scale, window, softcap},
         {part, counters, splits, part_pages},
         seq_lens, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return by_shape<float, float>(a, D, s);
  if (q_dtype == 1 && kv_dtype == 1) return by_shape<__nv_bfloat16, __nv_bfloat16>(a, D, s);
  if (q_dtype == 0 && kv_dtype == 2) return by_shape<float, int8_t>(a, D, s);
  if (q_dtype == 1 && kv_dtype == 2) return by_shape<__nv_bfloat16, int8_t>(a, D, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one block (kv_dtype as above), for reports.
extern "C" int paged_decode_smem_bytes(int kv_dtype, int D, int part_pages) {
  switch (kv_dtype * 1000 + D) {
    case 64: return DecSmem<float, 64>::bytes(part_pages);
    case 96: return DecSmem<float, 96>::bytes(part_pages);
    case 128: return DecSmem<float, 128>::bytes(part_pages);
    case 256: return DecSmem<float, 256>::bytes(part_pages);
    case 1064: return DecSmem<__nv_bfloat16, 64>::bytes(part_pages);
    case 1096: return DecSmem<__nv_bfloat16, 96>::bytes(part_pages);
    case 1128: return DecSmem<__nv_bfloat16, 128>::bytes(part_pages);
    case 1256: return DecSmem<__nv_bfloat16, 256>::bytes(part_pages);
    case 2064: return DecSmem<int8_t, 64>::bytes(part_pages);
    case 2096: return DecSmem<int8_t, 96>::bytes(part_pages);
    case 2128: return DecSmem<int8_t, 128>::bytes(part_pages);
    case 2256: return DecSmem<int8_t, 256>::bytes(part_pages);
    default: return -1;
  }
}
