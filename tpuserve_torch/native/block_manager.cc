// Native paged KV-cache block manager — C++ core with a C ABI for ctypes.
//
// Drop-in replacement for the bookkeeping in
// tpuserve_torch/runtime/block_manager.py (same semantics: free-list allocation,
// refcounted prefix sharing, chained block hashing, LRU eviction of freed
// hashed blocks).  The reference delegates this logic to vLLM's C++/Python
// block manager inside the deployed container (reference:
// kubernetes-single-node.yaml:14, llm-d-deploy.yaml:140-193); here it is a
// first-class native component on the scheduler hot path, where Python dict
// and list churn shows up at high request rates.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC (tpuserve_torch/native/__init__.py
// build_c_abi).  The primary Python binding is the CPython extension
// (block_manager_ext.cc); this C ABI is for non-Python hosts and is
// exercised via ctypes in tests/test_torch_native.py to keep it in sync.

#include "block_manager.hh"

using tpuserve::BlockManager;


extern "C" {

void* bm_create(int32_t num_blocks, int32_t block_size, int enable_prefix) {
  return new BlockManager(num_blocks, block_size, enable_prefix != 0);
}
void bm_destroy(void* h) { delete static_cast<BlockManager*>(h); }

int32_t bm_num_free_blocks(void* h) {
  return static_cast<BlockManager*>(h)->num_free_blocks();
}
int32_t bm_num_seqs(void* h) {
  return static_cast<BlockManager*>(h)->num_seqs();
}
int64_t bm_blocks_needed(void* h, int64_t n) {
  return static_cast<BlockManager*>(h)->blocks_needed(n);
}
int bm_can_allocate(void* h, int64_t n) {
  return static_cast<BlockManager*>(h)->can_allocate(n);
}
int64_t bm_prefix_hits(void* h) {
  return static_cast<BlockManager*>(h)->prefix_hits();
}
int64_t bm_prefix_queries(void* h) {
  return static_cast<BlockManager*>(h)->prefix_queries();
}
int64_t bm_lookup_prefix(void* h, const int32_t* tokens, int64_t n,
                         int32_t* out, int64_t max_out) {
  return static_cast<BlockManager*>(h)->lookup_prefix(tokens, n, out, max_out);
}
int64_t bm_allocate(void* h, const char* seq_id, const int32_t* tokens,
                    int64_t n, const int32_t* shared, int64_t nshared,
                    int32_t* out, int64_t max_out) {
  return static_cast<BlockManager*>(h)->allocate(seq_id, tokens, n, shared,
                                                 nshared, out, max_out);
}
int bm_needs_new_block(void* h, const char* seq_id) {
  return static_cast<BlockManager*>(h)->needs_new_block(seq_id);
}
int bm_can_append(void* h, const char* seq_id) {
  return static_cast<BlockManager*>(h)->can_append(seq_id);
}
int64_t bm_append_slot(void* h, const char* seq_id) {
  return static_cast<BlockManager*>(h)->append_slot(seq_id);
}
int64_t bm_slot_for_token(void* h, const char* seq_id, int64_t idx) {
  return static_cast<BlockManager*>(h)->slot_for_token(seq_id, idx);
}
int64_t bm_block_table(void* h, const char* seq_id, int32_t* out,
                       int64_t max_out) {
  return static_cast<BlockManager*>(h)->block_table(seq_id, out, max_out);
}
void bm_free_seq(void* h, const char* seq_id) {
  static_cast<BlockManager*>(h)->free_seq(seq_id);
}
void bm_free_seq_uncached(void* h, const char* seq_id) {
  static_cast<BlockManager*>(h)->free_seq(seq_id, /*cache_blocks=*/false);
}

// ---- per-cycle batched ops (see block_manager.hh) -----------------------

int64_t bm_decode_shortfall(void* h, const char* const* seq_ids,
                            int64_t n) {
  return static_cast<BlockManager*>(h)->decode_shortfall(seq_ids, n);
}
int64_t bm_charge_decode(void* h, const char* const* seq_ids, int64_t n,
                         int32_t* slots_out) {
  return static_cast<BlockManager*>(h)->charge_decode(seq_ids, n, slots_out);
}
int64_t bm_fill_block_tables(void* h, const char* const* seq_ids, int64_t n,
                             int32_t* out, int64_t stride) {
  return static_cast<BlockManager*>(h)->fill_block_tables(seq_ids, n, out,
                                                          stride);
}
int64_t bm_reserve_batch(void* h, const char* const* seq_ids, int64_t n,
                         const int64_t* totals) {
  return static_cast<BlockManager*>(h)->reserve_batch(seq_ids, n, totals);
}
int64_t bm_advance_batch(void* h, const char* const* seq_ids, int64_t n,
                         int64_t steps) {
  return static_cast<BlockManager*>(h)->advance_batch(seq_ids, n, steps);
}
void bm_admit_prefill(void* h, const int32_t* counts, int64_t n,
                      int64_t max_seats, int64_t max_prefill_tokens,
                      int32_t min_bucket, int64_t* picked_out,
                      int64_t* bucket_out) {
  static_cast<BlockManager*>(h)->admit_prefill(counts, n, max_seats,
                                               max_prefill_tokens, min_bucket,
                                               picked_out, bucket_out);
}

// ---- tiered KV cache: eviction log + restore (see block_manager.hh) -----

void bm_set_record_evictions(void* h, int on) {
  static_cast<BlockManager*>(h)->set_record_evictions(on != 0);
}
int64_t bm_num_evictions(void* h) {
  return static_cast<BlockManager*>(h)->num_evictions();
}
int64_t bm_take_evictions(void* h, int32_t* blocks_out, uint64_t* hashes_out,
                          int64_t max_out) {
  return static_cast<BlockManager*>(h)->take_evictions(blocks_out, hashes_out,
                                                       max_out);
}
int64_t bm_prefix_chain(void* h, const int32_t* tokens, int64_t n,
                        uint64_t* out, int64_t max_out) {
  return static_cast<BlockManager*>(h)->prefix_chain(tokens, n, out, max_out);
}
int bm_prefix_resolvable(void* h, uint64_t hash) {
  return static_cast<BlockManager*>(h)->prefix_resolvable(hash);
}
int64_t bm_begin_restore(void* h, const uint64_t* hashes, int64_t n,
                         int32_t* blocks_out) {
  return static_cast<BlockManager*>(h)->begin_restore(hashes, n, blocks_out);
}
int64_t bm_commit_restore(void* h, const uint64_t* hashes,
                          const int32_t* blocks, int64_t n) {
  return static_cast<BlockManager*>(h)->commit_restore(hashes, blocks, n);
}
void bm_abort_restore(void* h, const int32_t* blocks, int64_t n) {
  static_cast<BlockManager*>(h)->abort_restore(blocks, n);
}
int32_t bm_num_cached_blocks(void* h) {
  return static_cast<BlockManager*>(h)->num_cached_blocks();
}

}  // extern "C"
