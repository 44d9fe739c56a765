// The attention tile of the bf16 kernels on Hopper (sm_90a): the device
// code flash_prefill.cu, paged_window.cu and ragged_paged.cu's prefill
// blocks run, on the tensor cores through wgmma.
//
// A tile holds kRows = 64 * NWG query rows: up to bq = kRows / G
// consecutive query positions of one sequence times the G = Hq / Hkv query
// heads that share KV head `kvh`.  Row r is position r / G, head
// kvh * G + r % G, so each K/V tile loaded serves all G heads.  Query
// position i sits at key position pos0 + i and attends every written key at
// or before it (causal on top of the context before the tile), within the
// sliding window; scores are scaled and soft-capped first.  The block walks
// K/V tiles over [kv_start, kv_end): from the window start of its first
// row (or 0) to the causal limit of its last valid row.  Only those keys
// are read: keys outside are zero-filled in shared memory and masked, so
// NaN in unwritten slots or padding never reaches the sum.  Rows in
// [n_valid, n_write) and rows with no key write 0; a tile with no query
// only writes its zeros.
//
// Warp roles: NWG consumer warpgroups (4 warps each), 64 rows apiece, and
// no producer warp: every thread starts its share of the next tile's
// asynchronous copies, so the loads run under the tensor-core work.
// Per K/V tile of kBk keys, each warpgroup:
//   S = Q K^T     wgmma m64n{kBk}k16, Q and K from shared memory (K-major);
//   softmax       on the S accumulator in registers: a row's kBk / 4 values
//                 a thread, its max over the 4 threads of a quad by
//                 shuffles, exp2 with the scale folded in; the row sum is
//                 kept per thread and summed over the quad once, at the end;
//                 per-element masks only on tiles that cross the causal
//                 diagonal, the window edge, kv_start or kv_end;
//   O += P V      wgmma m64n{64,128}k16 with P from registers (the S
//                 accumulator rounded to bf16 in place: its fragment layout
//                 is the A operand's) and V from shared memory through the
//                 transpose bit (V rows are MN-major for this product); O
//                 lives in registers (D / 2 floats a thread) and is rescaled
//                 there.
// No S, P or O tile exists in shared memory.
//
// K/V ring: kStages = 2 stages of (K, V), filled with 16-byte cp.async
// copies (zero-filled outside [kv_start, kv_end)) that complete on the
// stage's mbarrier (cp.async.mbarrier.arrive.noinc, one arrival a thread).
// Tile j + 2 is requested once every warpgroup is done with tile j (one block
// barrier a tile), so it loads while tile j + 1 computes.  The tile's
// block-table entries are read once per warp per tile (one coalesced load,
// then shuffles), not once per 16-byte vector.  int8 pages are copied as
// int8 with their f32 row scales into a staging ring, then scaled and
// rounded to bf16 into the operand buffers (the rounding the plain version
// and the other kernels apply).  Shared memory is 128-byte swizzled, the
// layout wgmma reads.
//
// Sizes (tile_keys, Smem): kBk = 128 keys where two warpgroups share bf16
// K/V at D <= 128, else 64.  Shared memory (+ 1 KB to align to the 1 KB
// swizzle period): Q kRows x D bf16 + 2 x (K + V) kBk x D bf16 [+ int8
// staging 2 x (K + V) 64 x D + scales]: D=128, two warpgroups: 32 + 128 =
// 160 KB (int8: 32 + 64 + 32 KB); D=256, one warpgroup: 32 + 128 KB (int8
// +64 KB); D=128, one warpgroup (ragged): 16 + 64 KB, two blocks an SM.
// Registers: a thread holds O (D / 2 floats), S (kBk / 2) and P (kBk / 4
// words): ~255 at D=128 with 128 keys (no spills, one block an SM), so
// D=256 takes one warpgroup and 64 keys.  D=96 (Phi-3) runs D=128's tile:
// Q and the K/V operands hold 128 columns, 96-127 zero in shared memory
// (zeroed once; the copies fill only 0-95), and only 96 are written.
#pragma once

#include "attn_common.cuh"

namespace {

struct WindowArgs {        // what every tile of a launch shares
  const void* k_cache;     // paged: (num_blocks, page_size, Hkv, D); dense: (B, T, Hkv, D)
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
  const int* bt;           // the sequence's block-table row (paged caches)
  int pos0;                // key position of query position 0
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

namespace at {

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;       // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int warpgroups() { return padded_dim(D) > 128 ? 1 : 2; }

// Keys per K/V tile: 128 (S = m64n128k16) where two warpgroups share bf16
// K/V at D <= 128; 64 where registers (D=256) or shared memory (int8
// staging, ragged_paged.cu's two blocks an SM) are short.
template <typename KVT, int D, int NWG>
__host__ __device__ constexpr int tile_keys() {
  return NWG == 2 && padded_dim(D) <= 128 && sizeof(KVT) == 2 ? 128 : 64;
}

// Byte offsets into the (1 KB aligned) shared memory, at the padded width
// DP (D = 96 is held as 128 columns, 96-127 zero).  Every bf16 operand
// is stored as column blocks of 64 elements (128-byte rows), each block
// 128-byte swizzled: the 16-byte chunk c of row r sits at chunk c ^ (r % 8).
template <typename KVT, int D, int NWG>
struct Smem {
  static constexpr bool kInt8 = sizeof(KVT) == 1;
  static constexpr int DP = padded_dim(D);
  static constexpr int kBk = tile_keys<KVT, D, NWG>();
  static constexpr int kRows = 64 * NWG;
  static constexpr int kTile = kBk * DP * 2;                // one bf16 K or V tile
  static constexpr int q = 0;
  static constexpr int kv = q + kRows * DP * 2;             // [stage][K, V]
  static constexpr int raw = kv + kStages * 2 * kTile;      // int8: [stage][K, V] kBk x DP
  static constexpr int scl = raw + (kInt8 ? kStages * 2 * kBk * DP : 0);  // int8: f32 scales
  static constexpr int bar = scl + (kInt8 ? kStages * 2 * kBk * 4 : 0);  // [stage] mbarrier
  static constexpr int bytes = bar + kStages * 8 + 1024;
  static_assert(bytes <= 232448, "fits a block's shared memory");
};

// Offset of the 16-byte chunk c (8 bf16) of row r in a swizzled operand of
// `rows` rows.
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (c / 8) * (rows * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`:
// `lbo` / `sbo` are the leading / stride byte offsets.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// 16 (or 4) bytes from global `src` to shared `dst`; zeros, reading
// nothing, when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
// The mbarrier `bar` gets one arrival once this thread's copies so far land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// Order this thread's shared-memory traffic with the async proxy (wgmma).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving register reads or writes across a wgmma
// boundary (the product writes its accumulator asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[32] (+)= A[64x16] . B[16x64]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] (+)= A[64x16] . B[16x128]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A[64x16] . B[16x64]: A from registers (a), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A[64x16] . B[16x128]: A from registers (a), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128_t(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// K/V sources: the flat cache row of key `key` (an index into rows of D
// values, and into the int8 scales).  `at(k0, kv_end, keys)` is called by every
// lane of a warp once per tile; `row` by every lane together.

// Paged cache (num_blocks, page_size, Hkv, D) through a block-table row.
struct PagedSrc {
  const int* bt;
  int page, Hkv, kvh;
  struct Rows {            // one warp's view of one tile's pages
    const PagedSrc* s;
    int p0, n;             // first page, pages the tile reads (<= 128)
    int e[4];              // lane l holds entries p0 + l, p0 + 32 + l, ...
    __device__ __forceinline__ size_t row(int key) const {
      const int po = key / s->page - p0;
      int blk = __shfl_sync(kFull, e[0], po % 32);
      if (n > 32) {        // pages of fewer than 4 keys (warp-uniform)
#pragma unroll
        for (int k = 1; k < 4; ++k) {
          const int bk = __shfl_sync(kFull, e[k], po % 32);
          if (po / 32 == k) blk = bk;
        }
      }
      return (static_cast<size_t>(blk) * s->page + key % s->page) * s->Hkv + s->kvh;
    }
  };
  __device__ __forceinline__ Rows at(int k0, int kv_end, int keys) const {
    const int lane = threadIdx.x % 32;
    Rows r{this, k0 / page, (min(k0 + keys, kv_end) - 1) / page - k0 / page + 1, {0, 0, 0, 0}};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (32 * k + lane < r.n) r.e[k] = bt[r.p0 + 32 * k + lane];
    return r;
  }
};

// Dense (B, T, Hkv, D) keys of one sequence: row0 = b * T * Hkv + kvh.
struct DenseSrc {
  size_t row0;
  int Hkv;
  struct Rows {
    size_t row0;
    int Hkv;
    __device__ __forceinline__ size_t row(int key) const {
      return row0 + static_cast<size_t>(key) * Hkv;
    }
  };
  __device__ __forceinline__ Rows at(int, int, int) const { return Rows{row0, Hkv}; }
};

// The tile: see the note at the top.  Runs on NWG * 128 threads, with
// Smem<KVT, D, NWG>::bytes of dynamic shared memory at `smem_raw`.
template <typename KVT, int D, int NWG, class Src>
__device__ void attn_tile(const WindowArgs& a, const Tile& t, const Src& src,
                          unsigned char* smem_raw) {
  using L = Smem<KVT, D, NWG>;
  constexpr int DP = L::DP;                   // the products' width: D padded
  constexpr int kThreads = NWG * 128;
  constexpr int kRows = L::kRows;
  constexpr int kON = DP == 64 ? 64 : 128;    // N of one P.V product
  constexpr int kOH = DP / kON;               // P.V products per 16 keys
  constexpr int kChunks = D * sizeof(KVT) / 16;          // 16-byte copies per K/V row
  constexpr int kBk = L::kBk;
  constexpr int kAll = kBk * kChunks;                    // copies of a K or V tile
  constexpr int kCopies = (kAll + kThreads - 1) / kThreads;   // per thread (the last may idle)
  static_assert(D % 16 == 0, "K/V rows are whole 16-byte copies");

  const int G = a.Hq / a.Hkv;
  const int nq = min(kRows / G, t.n_valid);  // valid positions in the tile
  const int tid = threadIdx.x;
  bf16* out = static_cast<bf16*>(t.out);
  if (nq <= 0) {   // no query: write rows [0, n_write) as 0 (a position's G heads are contiguous)
    const int n = min(kRows / G, t.n_write) * G * D / 8;
    for (int idx = tid; idx < n; idx += kThreads) {
      const int i = idx / (G * D / 8), e = idx % (G * D / 8);
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(i) * a.Hq + t.kvh * G) * D + e * 8) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_base);

  const bf16* q = static_cast<const bf16*>(t.q);
  const KVT* kc = static_cast<const KVT*>(a.k_cache);
  const KVT* vc = static_cast<const KVT*>(a.v_cache);

  const int wg = tid / 128;
  const int lane = tid % 32;
  const int rA = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;   // this thread's rows rA, rA + 8
  const int posA = t.pos0 + rA / G, posB = t.pos0 + (rA + 8) / G;
  // the warpgroup's valid positions [i_lo, i_hi]
  const int i_lo = wg * 64 / G;
  const int i_hi = min((wg * 64 + 63) / G, nq - 1);
  const int kv_start = tile_kv_start(t, a);
  const int kv_end = tile_kv_end(t);
  const int k_first = kv_start / kBk * kBk;
  const int n_tiles = kv_end > k_first ? (kv_end - k_first + kBk - 1) / kBk : 0;

  // tile j's K and V into stage j % kStages
  auto fetch = [&](int j) {
    const int s = j % kStages;
    const int k0 = k_first + j * kBk;
    const auto rows = src.at(k0, kv_end, kBk);
#pragma unroll
    for (int u = 0; u < kCopies; ++u) {
      const int idx = tid + u * kThreads;
      // past the tile's copies (D = 96, int8): every lane still takes part
      // in the row lookup's shuffles, but issues no copy
      const bool mine = kCopies * kThreads == kAll || idx < kAll;
      const int r = mine ? idx / kChunks : 0, c = idx % kChunks;
      const int key = k0 + r;
      const bool ok = key >= kv_start && key < kv_end;
      const size_t row = rows.row(key);
      if (!mine) continue;
      const size_t off = ok ? row * D + c * (16 / sizeof(KVT)) : 0;
      if constexpr (L::kInt8) {
        const uint32_t dst = base + L::raw + 2 * s * kBk * DP + r * DP + c * 16;
        cp_async16(dst, kc + off, ok);
        cp_async16(dst + kBk * DP, vc + off, ok);
        if (c == 0) {
          const uint32_t sd = base + L::scl + (2 * s * kBk + r) * 4;
          cp_async4(sd, a.k_scale + (ok ? row : 0), ok);
          cp_async4(sd + kBk * 4, a.v_scale + (ok ? row : 0), ok);
        }
      } else {
        const uint32_t dst = base + L::kv + 2 * s * L::kTile + swz(r, c, kBk);
        cp_async16(dst, kc + off, ok);
        cp_async16(dst + L::kTile, vc + off, ok);
      }
    }
    cp_async_arrive(base + L::bar + 8 * s);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(base + L::bar + 8 * s, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first K/V tiles load while Q is stored (rows of positions >= nq,
  // and columns past D, as 0)
  for (int j = 0; j < kStages && j < n_tiles; ++j) fetch(j);
  for (int idx = tid; idx < kRows * (DP / 8); idx += kThreads) {
    const int r = idx / (DP / 8), c = idx % (DP / 8);
    const int i = r / G;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (i < nq && c < D / 8)
      val = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(i) * a.Hq + t.kvh * G + r % G) * D + c * 8);
    *reinterpret_cast<uint4*>(smem + L::q + swz(r, c, kRows)) = val;
  }
  if constexpr (DP != D) {
    // the K/V operands' columns past D: zero once, never copied into
    for (int idx = tid; idx < 2 * kStages * kBk * ((DP - D) / 8); idx += kThreads) {
      const int buf = idx / (kBk * ((DP - D) / 8));
      const int r = idx / ((DP - D) / 8) % kBk, c = D / 8 + idx % ((DP - D) / 8);
      *reinterpret_cast<uint4*>(smem + L::kv + buf * L::kTile + swz(r, c, kBk)) =
          make_uint4(0, 0, 0, 0);
    }
  }
  fence_async_smem();
  __syncthreads();

  float o[kOH][kON / 2];
#pragma unroll
  for (int h = 0; h < kOH; ++h)
#pragma unroll
    for (int i = 0; i < kON / 2; ++i) o[h][i] = 0.f;
  float mA = -INFINITY, mB = -INFINITY;      // running max (log2 units) of rows rA, rA + 8
  float lA = 0.f, lB = 0.f;                  // this thread's share of their running sums
  const float qk_scale = a.softcap > 0.f ? a.scale / a.softcap : a.scale * kLog2e;
  const float cap = a.softcap * kLog2e;

  const uint32_t q_desc_base = base + L::q + wg * 64 * 128;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int k0 = k_first + j * kBk;
    const uint32_t k_tile = base + L::kv + 2 * s * L::kTile;
    const uint32_t v_tile = k_tile + L::kTile;
    mbar_wait(base + L::bar + 8 * s, (j / kStages) & 1);
    __syncwarp();   // reconverge the warp after the spin, before warpgroup-wide ops
    if constexpr (L::kInt8) {
      // scale and round the staged int8 rows into the bf16 operand buffers
      for (int idx = tid; idx < 2 * kBk * (D / 16); idx += kThreads) {
        const int kv = idx / (kBk * (D / 16));
        const int r = idx / (D / 16) % kBk, c = idx % (D / 16);
        const int buf = 2 * s + kv;
        const uint4 raw = *reinterpret_cast<const uint4*>(smem + L::raw + buf * kBk * DP +
                                                          r * DP + c * 16);
        const float sc = reinterpret_cast<const float*>(smem + L::scl)[buf * kBk + r];
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
        uint4 lo, hi;
        uint32_t* l32 = reinterpret_cast<uint32_t*>(&lo);
        uint32_t* h32 = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          l32[x] = pack_bf16(static_cast<float>(e[2 * x]) * sc, static_cast<float>(e[2 * x + 1]) * sc);
          h32[x] = pack_bf16(static_cast<float>(e[8 + 2 * x]) * sc,
                             static_cast<float>(e[9 + 2 * x]) * sc);
        }
        unsigned char* dst = smem + L::kv + buf * L::kTile;
        *reinterpret_cast<uint4*>(dst + swz(r, 2 * c, kBk)) = lo;
        *reinterpret_cast<uint4*>(dst + swz(r, 2 * c + 1, kBk)) = hi;
      }
      fence_async_smem();
      __syncthreads();
    } else {
      fence_async_smem();
    }

    // this warpgroup skips a tile wholly after its rows or before their windows
    const bool live = i_lo <= i_hi && k0 <= t.pos0 + i_hi &&
                      (a.window <= 0 || k0 + kBk - 1 > t.pos0 + i_lo - a.window);
    if (live) {
      float sc[kBk / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        // K-major: 16 values are 32 bytes along a swizzled row, 4 per column block
        const uint32_t off = (kk % 4) * 32;
        const uint64_t dq = desc(q_desc_base + (kk / 4) * kRows * 128 + off, 16, 1024);
        const uint64_t dk = desc(k_tile + (kk / 4) * kBk * 128 + off, 16, 1024);
        if constexpr (kBk == 64)
          wgmma_ss_n64(sc, dq, dk, kk > 0);
        else
          wgmma_ss_n128(sc, dq, dk, kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(sc);

      // scores in log2 units; masks only where the tile crosses an edge
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i)
        sc[i] = a.softcap > 0.f ? cap * tanhf(sc[i] * qk_scale) : sc[i] * qk_scale;
      const bool edge = k0 < kv_start || k0 + kBk > kv_end || k0 + kBk - 1 > t.pos0 + i_lo ||
                        (a.window > 0 && k0 <= t.pos0 + i_hi - a.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kBk / 2; ++i) {
          const int key = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
          const int pos = (i / 2) % 2 ? posB : posA;
          if (!(key >= kv_start && key < kv_end && key <= pos &&
                (a.window <= 0 || key > pos - a.window)))
            sc[i] = -INFINITY;
        }
      }
      float xA = -INFINITY, xB = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i) {
        if ((i / 2) % 2) xB = fmaxf(xB, sc[i]);
        else xA = fmaxf(xA, sc[i]);
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        xA = fmaxf(xA, __shfl_xor_sync(kFull, xA, off));
        xB = fmaxf(xB, __shfl_xor_sync(kFull, xB, off));
      }
      const float nA = fmaxf(mA, xA), nB = fmaxf(mB, xB);
      const float uA = nA == -INFINITY ? 0.f : nA;      // a row with no key yet
      const float uB = nB == -INFINITY ? 0.f : nB;
      const float alphaA = exp2f(mA - uA), alphaB = exp2f(mB - uB);
      mA = nA;
      mB = nB;
      float sA = 0.f, sB = 0.f;
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i) {
        if ((i / 2) % 2) {
          sc[i] = exp2f(sc[i] - uB);
          sB += sc[i];
        } else {
          sc[i] = exp2f(sc[i] - uA);
          sA += sc[i];
        }
      }
      lA = lA * alphaA + sA;
      lB = lB * alphaB + sB;
#pragma unroll
      for (int h = 0; h < kOH; ++h)
#pragma unroll
        for (int i = 0; i < kON / 2; ++i) o[h][i] *= (i / 2) % 2 ? alphaB : alphaA;

      // P (bf16) as the A operand: keys 16 kk .. 16 kk + 15 are S registers 8 kk .. 8 kk + 7
      uint32_t p[kBk / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) p[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
#pragma unroll
      for (int h = 0; h < kOH; ++h) fence_regs(o[h]);
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) fence_regs(p[kk]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk)
#pragma unroll
        for (int h = 0; h < kOH; ++h) {
          // V MN-major: 64-column blocks 8 KB apart (lbo), 8-key groups 1 KB apart (sbo)
          const uint64_t dv = desc(v_tile + h * (kON / 64) * kBk * 128 + kk * 16 * 128,
                                   kBk * 128, 1024);
          if constexpr (kON == 64)
            wgmma_rs_n64_t(o[h], p[kk], dv);
          else
            wgmma_rs_n128_t(o[h], p[kk], dv);
        }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int h = 0; h < kOH; ++h) fence_regs(o[h]);
    }
    __syncthreads();   // every warpgroup is done with stage s: refill it
    if (j + kStages < n_tiles) fetch(j + kStages);
  }

  // the quad's shares of each row sum, then O / l
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    lA += __shfl_xor_sync(kFull, lA, off);
    lB += __shfl_xor_sync(kFull, lB, off);
  }
  const int nw = min(kRows / G, t.n_write);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rA + 8 * half;
    const int i = r / G;
    if (i >= nw) continue;
    const float l = half ? lB : lA;
    const float inv = i < nq && l > 0.f ? 1.f / l : 0.f;
    bf16* dst = out + (static_cast<size_t>(i) * a.Hq + t.kvh * G + r % G) * D + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < kOH; ++h)
#pragma unroll
      for (int c = 0; c < kON / 8; ++c)
        if (h * kON + c * 8 < D)      // columns past D (padding) are not written
          *reinterpret_cast<uint32_t*>(dst + h * kON + c * 8) =
              pack_bf16(o[h][4 * c + 2 * half] * inv, o[h][4 * c + 2 * half + 1] * inv);
  }
}

}  // namespace at

}  // namespace
