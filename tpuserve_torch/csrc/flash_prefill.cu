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
// Design (simple first kernels, not yet fast):
// - Both kernels: a block owns a tile of query rows of one head and walks
//   K/V tiles itself (the TPU kernel's sequential grid axis becomes a loop),
//   skipping whole tiles past the causal limit, past prompt_len, or before
//   the earliest row's window; a block wholly past prompt_len reads no key
//   and writes zeros.  V rows at or past prompt_len are stored as
//   0 (a fresh cache may hold NaN, and 0 * NaN would poison the sum); masked
//   keys contribute exactly 0, and a row with no key writes 0.  The running
//   max, sum and output accumulator are float32.
// - bfloat16 (the serving path): 4 warps x 16 query rows, 64-key tiles.
//   QK^T and PV run on the tensor cores as 16x16x16 WMMA products from
//   shared memory with float32 sums.  Each warp keeps its own rows' scores,
//   probabilities (rounded to bf16 for PV, as the plain version does) and
//   output in shared memory, so only the K/V tile loads need the whole
//   block to synchronise.  111 KB of shared memory at D=128 (two blocks an
//   SM), 191 KB at D=256.  wgmma, TMA and double buffering are the next
//   steps.
// - float32: the tensor cores' bf16 or TF32 products would miss the float32
//   tolerance, so QK^T and PV run on the CUDA cores from shared memory,
//   32 query rows and 32 keys a step (54 KB at D=128, 103 KB at D=256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// first key tile any of rows [q0, ...) may attend
__device__ __forceinline__ int first_tile(int q0, int window, int bk) {
  return window > 0 ? max(0, q0 - window + 1) / bk * bk : 0;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (WMMA)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBq = 64;   // query rows per block: 4 warps x 16
constexpr int kBk = 64;   // keys per tile
constexpr int kWm = 16;   // WMMA tile edge

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
  static constexpr int k = q + kBq * ldh * 2;
  static constexpr int v = k + kBk * ldh * 2;
  static constexpr int s = v + kBk * ldh * 2;
  static constexpr int p = s + kBq * lds * 4;
  static constexpr int o = p + kBq * ldp * 2;
  static constexpr int stats = o + kBq * ldo * 4;
  static constexpr int bytes = stats + 3 * kBq * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_bf16(Args a) {
  using L = Smem<D>;
  constexpr int kVecs = D / 8;             // 16-byte vectors per row
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem + L::q);
  bf16* ks = reinterpret_cast<bf16*>(tc_smem + L::k);
  bf16* vs = reinterpret_cast<bf16*>(tc_smem + L::v);
  float* ss = reinterpret_cast<float*>(tc_smem + L::s);
  bf16* ps = reinterpret_cast<bf16*>(tc_smem + L::p);
  float* os = reinterpret_cast<float*>(tc_smem + L::o);
  float* row_m = reinterpret_cast<float*>(tc_smem + L::stats);
  float* row_l = row_m + kBq;
  float* row_alpha = row_l + kBq;

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  bf16* out = static_cast<bf16*>(a.out);

  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wr = (tid / 32) * kWm;         // this warp's first row in the tile
  const int r0 = q0 + wr;                  // ... and in the sequence
  const int plen = min(a.prompt_lens[b], a.T);

  for (int idx = tid; idx < kBq * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * 8;
    const int row = q0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < a.T)
      val = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * a.T + row) * a.Hq + h) * D + c);
    *reinterpret_cast<uint4*>(qs + r * L::ldh + c) = val;
  }
  for (int idx = tid; idx < kBq * D; idx += kThreads) os[(idx / D) * L::ldo + idx % D] = 0.f;
  if (tid < kBq) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  // this warp has work only for rows inside the prompt, and a block wholly
  // past it reads no key at all (its rows are unspecified: they get 0)
  const bool warp_live = r0 < plen;
  const int kv_end = q0 < plen ? min(q0 + kBq, plen) : 0;
  for (int k0 = first_tile(q0, a.window, kBk); k0 < kv_end; k0 += kBk) {
    __syncthreads();   // the previous tile's K / V are consumed
    for (int idx = tid; idx < kBk * kVecs; idx += kThreads) {
      const int r = idx / kVecs, c = (idx % kVecs) * 8;
      const int key = k0 + r;
      const size_t off = ((static_cast<size_t>(b) * a.T + key) * a.Hkv + hk) * D + c;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < a.T) kv = *reinterpret_cast<const uint4*>(k + off);
      if (key < plen) vv = *reinterpret_cast<const uint4*>(v + off);
      *reinterpret_cast<uint4*>(ks + r * L::ldh + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * L::ldh + c) = vv;
    }
    __syncthreads();
    // skip a tile wholly after this warp's rows or before their window
    if (!warp_live || k0 > r0 + kWm - 1) continue;
    if (a.window > 0 && k0 + kBk - 1 <= r0 - a.window) continue;

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
      const int row = q0 + r;
      float x[2];
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        ok[c] = key_ok(k0 + col, row, plen, a.window);
        x[c] = ok[c] ? score(ss[r * L::lds + col], a) : kNegInf;
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

  for (int idx = lane; idx < kWm * D; idx += 32) {
    const int r = wr + idx / D, d = idx % D;
    const int row = q0 + r;
    if (row >= a.T) break;
    const float l = row_l[r];
    out[((static_cast<size_t>(b) * a.T + row) * a.Hq + h) * D + d] =
        __float2bfloat16(l > 0.f ? os[r * L::ldo + d] / l : 0.f);
  }
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kBq - 1) / kBq, a.Hq, a.B);
  flash_prefill_bf16<D><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

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

  const int kv_end = q0 < plen ? min(q0 + kBq, plen) : 0;   // as in tc::
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
  if (dtype == 1) return tc::launch<D>(a, stream);
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
    case 128: return by_dtype<128>(a, dtype, s);
    case 256: return by_dtype<256>(a, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}
