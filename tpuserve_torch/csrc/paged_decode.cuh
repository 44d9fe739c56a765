// Split-K paged decode: one query row against its paged K/V, for the
// G = Hq / Hkv query heads that share one KV head.  The body of
// paged_decode.cu's kernel, shared with ragged_paged.cu's decode rows, so
// both compute the same per-row math.
//
// A row's key range is cut into `splits` partitions of `part_pages` whole
// pages (SplitK; the host's rule is ops/paged_decode.py `decode_splits`,
// mirrored here by `decode_splits` for the ragged kernel, which learns its
// decode-row count on the device).  One block of kDecThreads threads serves
// one (row, KV head, partition):
// - It reads only keys in [win_start, seq_len) inside its partition.  A
//   block whose partition holds none exits having read nothing but the
//   length; for seq_len == 0 partition 0 writes zeros.  Pages before the
//   window and unwritten (possibly NaN) slots never reach a sum.
// - It loads its partition's block-table entries into shared memory (one
//   read a page), then streams K/V through a ring of kDecStages stages of
//   kBk keys (8 KB of K and 8 KB of V a stage) with 16-byte cp.async copies
//   that complete on one mbarrier a stage.  The first kDecStages stages are
//   requested at once and a stage is refilled as soon as every warp is done
//   with it, so up to 48 KB a block, and 192 KB an SM, are in flight.
// - The math runs on the CUDA cores (about one FLOP a byte at G = 2): a
//   lane group of DP / 8 lanes holds 8 elements of a row (DP =
//   padded_dim(D): at D = 96 the stage rows and q hold 128 columns, 96-127
//   zero, so a row is 16 lanes as at 128), scores a batch of
//   rows (shuffles over the group), then updates a float32 online softmax
//   (running max m, sum l, accumulator acc) once for the batch; int8 rows
//   are scaled and rounded to q's type, as the plain version does.
// - The lane groups merge by shuffles, the warps through shared memory.  A
//   row whose keys lie in one partition is written by its one block.
//   Otherwise each block writes (acc, m, l) to float32 scratch, bumps an
//   int32 counter of its (row, KV head), and the block that finds itself
//   last merges the partials with log-sum-exp weights, writes the output
//   and sets the counter back to 0 for the next launch.
#pragma once

#include "attn_tile.cuh"

namespace {

struct DecodeArgs {
  const void* q;            // row b's heads at q + b * Hq * D
  const void* k_cache;
  const void* v_cache;
  const float* k_scale;     // null unless the cache is int8
  const float* v_scale;
  const int* block_tables;  // row b at block_tables + b * max_pages
  void* out;                // same layout as q
  int Hq, Hkv, page_size, max_pages;
  float scale;
  int window;               // 0 = none
  float softcap;            // 0 = none
};

struct SplitK {
  float* part;       // one record of split_stride(G, D) floats a (row, KV head, split)
  int* counters;     // one a (row, KV head): blocks done; 0 between launches
  int splits;        // partitions a row
  int part_pages;    // whole pages a partition
};

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecStages = 3;      // 48 KB of ring: four blocks an SM
constexpr int kDecWaves = 8;       // decode_splits aims at this many blocks an SM,
constexpr int kDecMinKeys = 128;   // with partitions of at least this many keys

// Floats of one partial record: acc (G x D), m (G), l (G), padded to 16 bytes.
__host__ __device__ __forceinline__ int split_stride(int G, int D) {
  return G * D + (2 * G + 3) / 4 * 4;
}

// ops/paged_decode.py decode_splits: enough partitions for kDecWaves blocks
// an SM over rows x Hkv (row, KV head) pairs, but none under kDecMinKeys
// keys, each a whole number of pages.
__host__ __device__ __forceinline__ void decode_splits(int rows, int Hkv, int max_pages,
                                                       int page, int num_sms, int& splits,
                                                       int& part_pages) {
  const int mp = max(max_pages, 1);
  const int pairs = max(rows * Hkv, 1);
  const int by_blocks = (kDecWaves * num_sms + pairs - 1) / pairs;
  const int by_keys = mp * page / kDecMinKeys;
  const int want = min(max(min(by_blocks, by_keys), 1), mp);
  part_pages = (mp + want - 1) / want;
  splits = (mp + part_pages - 1) / part_pages;
}

// Byte offsets into the block's dynamic shared memory.  Stage rows are
// padded_dim(D) wide (D = 96: 128, columns 96-127 zero).
template <typename KVT, int D>
struct DecSmem {
  static constexpr bool kInt8 = sizeof(KVT) == 1;
  static constexpr int kTile = 8192;                              // one K or V stage
  static constexpr int kBk = kTile / (padded_dim(D) * static_cast<int>(sizeof(KVT)));  // keys a stage
  static constexpr int kv = 0;                                    // [stage][K, V]
  static constexpr int scl = kv + kDecStages * 2 * kTile;         // int8: [stage][K, V] kBk f32
  static constexpr int bar = scl + (kInt8 ? kDecStages * 2 * kBk * 4 : 0);  // [stage] mbarrier
  static constexpr int bt = bar + kDecStages * 8;                 // the partition's pages
  // the merge reuses the ring: its partial sums, then one weight a (split, head)
  static constexpr int kWeights = (kDecStages * 2 * kTile - 16 * kDecThreads) / 4;
  static __host__ __device__ constexpr int bytes(int part_pages) { return bt + 4 * part_pages; }
};

// N elements of T (8 or 16 bytes) from shared memory at p, as floats.
template <typename T, int N>
__device__ __forceinline__ void lds(const unsigned char* p, float* out) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else {
    static_assert(N * sizeof(T) == 8, "8 or 16 bytes");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  }
}

// Partition `split` of row b, KV head kvh (see the note at the top).  Runs
// on kDecThreads threads with DecSmem<KVT, D>::bytes(sk.part_pages) bytes of
// dynamic shared memory at `smem` (16-byte aligned).
template <typename QT, typename KVT, int D, int MAXG>
__device__ __forceinline__ void split_decode(const DecodeArgs& a, const SplitK& sk, int b,
                                             int kvh, int split, int seq_len,
                                             unsigned char* smem) {
  using L = DecSmem<KVT, D>;
  constexpr int DP = padded_dim(D);                     // a stage row's width
  constexpr int kBk = L::kBk;
  constexpr int kEpl = 8;                               // elements of a row a lane holds
  constexpr int kLpr = DP / kEpl;                       // lanes a row: 8, 16 or 32
  constexpr int kRpw = 32 / kLpr;                       // rows a warp takes at once
  constexpr int kVec = sizeof(KVT) == 4 ? 4 : 8;        // elements a shared-memory load
  constexpr int kVpl = kEpl / kVec;                     // loads a lane a row
  constexpr int kRows = kDecWarps * kRpw;               // rows the block takes at once
  constexpr int kSteps = kBk / kRows;                   // ... a stage
  constexpr int kBatch0 = MAXG > 2 ? 2 : 4;             // rows scored before a softmax update
  constexpr int kBatch = kBatch0 < kSteps ? kBatch0 : kSteps;
  constexpr int kRowBytes = DP * static_cast<int>(sizeof(KVT));   // a stage row
  constexpr int kChunks = D * static_cast<int>(sizeof(KVT)) / 16;  // 16-byte copies a row
  constexpr int kCopies = kBk * kChunks / kDecThreads;  // a thread's copies of a K or V stage
  static_assert(kSteps * kRows == kBk && kSteps % kBatch == 0, "rows split evenly");
  static_assert(kCopies * kDecThreads == kBk * kChunks, "copies split evenly");
  static_assert((kDecWarps * MAXG * (DP + 2) + 1) * 4 <= L::scl, "the warps merge in the ring");

  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / kLpr, li = lane % kLpr;
  QT* out = static_cast<QT*>(a.out) + (static_cast<size_t>(b) * a.Hq + kvh * G) * D;

  const int part_keys = sk.part_pages * a.page_size;
  seq_len = min(seq_len, sk.splits * part_keys);
  if (seq_len <= 0) {
    if (split == 0)
      for (int i = tid; i < G * D; i += kDecThreads) out[i] = from_float<QT>(0.f);
    return;
  }
  const int win = a.window > 0 ? max(seq_len - a.window, 0) : 0;
  const int first = win / part_keys, last = (seq_len - 1) / part_keys;
  if (split < first || split > last) return;
  const int lo = max(win, split * part_keys);           // this block's keys [lo, hi)
  const int hi = min(seq_len, (split + 1) * part_keys);
  const int n_stages = (hi - lo + kBk - 1) / kBk;
  const int p0 = split * sk.part_pages;

  const KVT* kc = static_cast<const KVT*>(a.k_cache);
  const KVT* vc = static_cast<const KVT*>(a.v_cache);
  const int* bt = a.block_tables + static_cast<size_t>(b) * a.max_pages;
  int* sbt = reinterpret_cast<int*>(smem + L::bt);     // page p at sbt[p - p0]
  const uint32_t base = at::smem_u32(smem);
  for (int p = lo / a.page_size + tid; p <= (hi - 1) / a.page_size; p += kDecThreads)
    sbt[p - p0] = bt[p];
  if constexpr (DP != D) {
    // the stage rows' columns past D: zero once, never copied into
    constexpr int kPad = (DP - D) * static_cast<int>(sizeof(KVT)) / 16;
    for (int idx = tid; idx < kDecStages * 2 * kBk * kPad; idx += kDecThreads)
      *reinterpret_cast<uint4*>(smem + L::kv + idx / kPad * kRowBytes + kChunks * 16 +
                                idx % kPad * 16) = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < kDecStages; ++s) at::mbar_init(base + L::bar + 8 * s, kDecThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // keys lo + j kBk .. into stage j % kDecStages; rows at or past hi are
  // zero-filled and read nothing
  auto fetch = [&](int j) {
    const int s = j % kDecStages;
    const int k0 = lo + j * kBk;
#pragma unroll
    for (int u = 0; u < kCopies; ++u) {
      const int idx = tid + u * kDecThreads;
      const int r = idx / kChunks, c = idx % kChunks;
      const int key = k0 + r;
      const bool ok = key < hi;
      const size_t row =
          ok ? (static_cast<size_t>(sbt[key / a.page_size - p0]) * a.page_size +
                key % a.page_size) * a.Hkv + kvh
             : 0;
      const size_t off = row * D + c * (16 / sizeof(KVT));
      const uint32_t dst = base + L::kv + 2 * s * L::kTile + r * kRowBytes + c * 16;
      at::cp_async16(dst, kc + off, ok);
      at::cp_async16(dst + L::kTile, vc + off, ok);
      if constexpr (L::kInt8) {
        if (c == 0) {
          const uint32_t sd = base + L::scl + (2 * s * kBk + r) * 4;
          at::cp_async4(sd, a.k_scale + row, ok);
          at::cp_async4(sd + kBk * 4, a.v_scale + row, ok);
        }
      }
    }
    at::cp_async_arrive(base + L::bar + 8 * s);
  };
  for (int j = 0; j < kDecStages && j < n_stages; ++j) fetch(j);

  // this lane's dims: d = (v * kLpr + li) * kVec + i
  const QT* q = static_cast<const QT*>(a.q) + (static_cast<size_t>(b) * a.Hq + kvh * G) * D;
  float qr[MAXG][kEpl], acc[MAXG][kEpl], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int v = 0; v < kVpl; ++v)
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        acc[g][v * kVec + i] = 0.f;
        const int d = (v * kLpr + li) * kVec + i;
        qr[g][v * kVec + i] = g < G && d < D ? to_float(q[g * D + d]) : 0.f;
      }
  }

  for (int j = 0; j < n_stages; ++j) {
    const int s = j % kDecStages;
    const int k0 = lo + j * kBk;
    at::mbar_wait(base + L::bar + 8 * s, (j / kDecStages) & 1);
    const unsigned char* kt = smem + L::kv + 2 * s * L::kTile;
    const unsigned char* vt = kt + L::kTile;
    const float* ksc = reinterpret_cast<const float*>(smem + L::scl) + 2 * s * kBk;
#pragma unroll
    for (int st0 = 0; st0 < kSteps; st0 += kBatch) {
      float p[kBatch][MAXG];       // scores, then probabilities
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = (st0 + u) * kRows + warp * kRpw + sub;
        float kf[kEpl];
#pragma unroll
        for (int v = 0; v < kVpl; ++v)
          lds<KVT, kVec>(kt + r * kRowBytes + (v * kLpr + li) * kVec * sizeof(KVT),
                         kf + v * kVec);
        if constexpr (L::kInt8) {
          const float sc = ksc[r];
#pragma unroll
          for (int i = 0; i < kEpl; ++i) kf[i] = round_to<QT>(kf[i] * sc);
        }
        const bool ok = k0 + r < hi;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          float x = 0.f;
#pragma unroll
          for (int i = 0; i < kEpl; ++i) x += qr[g][i] * kf[i];
#pragma unroll
          for (int off = kLpr / 2; off > 0; off /= 2) x += __shfl_xor_sync(kFull, x, off);
          x *= a.scale;
          if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
          p[u][g] = ok ? x : -INFINITY;
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) mx = fmaxf(mx, p[u][g]);
        const float mu = mx == -INFINITY ? 0.f : mx;    // no key yet
        const float alpha = expf(m[g] - mu);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          p[u][g] = expf(p[u][g] - mu);
          sum += p[u][g];
        }
        l[g] = l[g] * alpha + sum;
        m[g] = mx;
#pragma unroll
        for (int i = 0; i < kEpl; ++i) acc[g][i] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = (st0 + u) * kRows + warp * kRpw + sub;
        float vf[kEpl];
#pragma unroll
        for (int v = 0; v < kVpl; ++v)
          lds<KVT, kVec>(vt + r * kRowBytes + (v * kLpr + li) * kVec * sizeof(KVT),
                         vf + v * kVec);
        if constexpr (L::kInt8) {
          const float sc = ksc[kBk + r];
#pragma unroll
          for (int i = 0; i < kEpl; ++i) vf[i] = round_to<QT>(vf[i] * sc);
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
#pragma unroll
          for (int i = 0; i < kEpl; ++i) acc[g][i] += p[u][g] * vf[i];
        }
      }
    }
    __syncthreads();   // every warp is done with stage s: refill it
    if (j + kDecStages < n_stages) fetch(j + kDecStages);
  }

  // merge the lane groups of each warp (same li, other sub)
#pragma unroll
  for (int off = kLpr; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo_ = __shfl_xor_sync(kFull, l[g], off);
      const float mm = fmaxf(m[g], mo);
      const float mu = mm == -INFINITY ? 0.f : mm;
      const float sa = expf(m[g] - mu), so = expf(mo - mu);
      l[g] = l[g] * sa + lo_ * so;
#pragma unroll
      for (int i = 0; i < kEpl; ++i) {
        const float ao = __shfl_xor_sync(kFull, acc[g][i], off);
        acc[g][i] = acc[g][i] * sa + ao * so;
      }
      m[g] = mm;
    }
  }
  // then the warps, through the (now idle) ring
  float* sm_acc = reinterpret_cast<float*>(smem);       // [warp][MAXG][DP]
  float* sm_m = sm_acc + kDecWarps * MAXG * DP;         // [warp][MAXG]
  float* sm_l = sm_m + kDecWarps * MAXG;
  int* sm_last = reinterpret_cast<int*>(sm_l + kDecWarps * MAXG);
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int v = 0; v < kVpl; ++v)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          sm_acc[(warp * MAXG + g) * DP + (v * kLpr + li) * kVec + i] = acc[g][v * kVec + i];
      if (li == 0) {
        sm_m[warp * MAXG + g] = m[g];
        sm_l[warp * MAXG + g] = l[g];
      }
    }
  }
  __syncthreads();
  const bool direct = first == last;
  const int stride = split_stride(G, D);
  const int pair = b * a.Hkv + kvh;
  float* rec = sk.part + (static_cast<size_t>(pair) * sk.splits + split) * stride;
  for (int idx = tid; idx < G * D; idx += kDecThreads) {
    const int g = idx / D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mm = fmaxf(mm, sm_m[w * MAXG + g]);
    const float mu = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float sw = expf(sm_m[w * MAXG + g] - mu);
      ll += sm_l[w * MAXG + g] * sw;
      o += sm_acc[(w * MAXG + g) * DP + idx % D] * sw;
    }
    if (direct) {
      out[idx] = from_float<QT>(ll > 0.f ? o / ll : 0.f);
    } else {
      rec[idx] = o;
      if (idx % D == 0) {
        rec[G * D + g] = mm;
        rec[G * D + G + g] = ll;
      }
    }
  }
  if (direct) return;

  // the last block of the row to finish merges every partition's partial
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const bool is_last = atomicAdd(sk.counters + pair, 1) == last - first;
    if (is_last) sk.counters[pair] = 0;               // ready for the next launch
    __threadfence();
    *sm_last = is_last;
  }
  __syncthreads();
  if (!*sm_last) return;

  const int n = last - first + 1;
  const float* rec0 = sk.part + (static_cast<size_t>(pair) * sk.splits + first) * stride;
  float4* sums = reinterpret_cast<float4*>(smem);                    // [kDecThreads]
  float* wt = reinterpret_cast<float*>(smem + 16 * kDecThreads);     // [n][G]: exp(m_i - M) / L
  __syncthreads();   // everyone has read sm_last before the ring is reused
  for (int g = warp; g < G; g += kDecWarps) {          // one warp a head
    float mm = -INFINITY;
    for (int i = lane; i < n; i += 32) mm = fmaxf(mm, __ldcg(rec0 + i * stride + G * D + g));
    mm = warp_max(mm);
    const float mu = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float w = expf(__ldcg(rec0 + i * stride + G * D + g) - mu);
      wt[i * G + g] = w;
      ll += __ldcg(rec0 + i * stride + G * D + G + g) * w;
    }
    ll = warp_sum(ll);
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    for (int i = lane; i < n; i += 32) wt[i * G + g] *= inv;
  }
  __syncthreads();
  // out = sum_i acc_i w_i, four floats a thread; when the output has fewer
  // than kDecThreads quads, `nsub` threads share one over the partitions
  const int nq = G * D / 4;
  const int nsub = nq >= kDecThreads ? 1 : kDecThreads / nq;
  for (int q0 = 0; q0 < nq; q0 += kDecThreads) {
    const int qi = q0 + tid % nq, su = tid / nq;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < nq && su < nsub) {
      const int g = qi * 4 / D;
#pragma unroll 4
      for (int i = su; i < n; i += nsub) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(rec0 + i * stride) + qi);
        const float w = wt[i * G + g];
        o.x += x.x * w;
        o.y += x.y * w;
        o.z += x.z * w;
        o.w += x.w * w;
      }
    }
    if (nsub > 1) {
      sums[tid] = o;
      __syncthreads();
      if (tid < nq) {
        for (int t = 1; t < nsub; ++t) {
          const float4 x = sums[t * nq + tid];
          o.x += x.x;
          o.y += x.y;
          o.z += x.z;
          o.w += x.w;
        }
      }
    }
    if (qi < nq && su == 0) {
      out[4 * qi] = from_float<QT>(o.x);
      out[4 * qi + 1] = from_float<QT>(o.y);
      out[4 * qi + 2] = from_float<QT>(o.z);
      out[4 * qi + 3] = from_float<QT>(o.w);
    }
  }
}

}  // namespace
