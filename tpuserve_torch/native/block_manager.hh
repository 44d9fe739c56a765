// Native paged KV-cache block manager core (see block_manager.cc for the
// C ABI and block_manager_ext.cc for the CPython extension binding).
#pragma once

#include <cstdint>
#include <cstring>
#include <list>
#include <string>
#include <unordered_map>
#include <vector>

namespace tpuserve {

// FNV-1a over the token chunk, chained through the previous hash.  Only
// internal consistency matters (lookup vs. register); this never has to
// match Python's hash().
inline uint64_t chain_hash(uint64_t prev, const int32_t* tokens, int64_t n) {
  uint64_t h = 1469598103934665603ull ^ prev;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t v = static_cast<uint64_t>(static_cast<uint32_t>(tokens[i]));
    h ^= v;
    h *= 1099511628211ull;
  }
  // never return 0 so "no hash" can be the empty sentinel
  return h ? h : 1;
}

// Sentinel for a leading block returned by the sliding-window rolling
// buffer (release_out_of_window); mirrors runtime/block_manager.py.
constexpr int32_t kReleased = -1;

struct SeqAlloc {
  std::vector<int32_t> blocks;
  int64_t num_tokens = 0;
  int64_t released_upto = 0;
};

class BlockManager {
 public:
  BlockManager(int32_t num_blocks, int32_t block_size, bool enable_prefix)
      : num_blocks_(num_blocks),
        block_size_(block_size),
        enable_prefix_(enable_prefix) {
    free_.reserve(num_blocks);
    for (int32_t b = num_blocks - 1; b >= 0; --b) free_.push_back(b);
  }

  int32_t num_free_blocks() const {
    return static_cast<int32_t>(free_.size() + cached_lru_.size());
  }
  int32_t num_seqs() const { return static_cast<int32_t>(seqs_.size()); }
  int64_t blocks_needed(int64_t num_tokens) const {
    return (num_tokens + block_size_ - 1) / block_size_;
  }
  bool can_allocate(int64_t num_tokens) const {
    return blocks_needed(num_tokens) <= num_free_blocks();
  }
  int64_t prefix_hits() const { return prefix_hits_; }
  int64_t prefix_queries() const { return prefix_queries_; }
  int32_t num_cached_blocks() const {
    return static_cast<int32_t>(cached_lru_.size());
  }
  int32_t num_restoring_blocks() const {
    return static_cast<int32_t>(restoring_.size());
  }

  // Longest cached whole-block prefix; at least one token stays uncached.
  int64_t lookup_prefix(const int32_t* tokens, int64_t n, int32_t* out,
                        int64_t max_out, bool count_stats = true) {
    if (!enable_prefix_) return 0;
    if (count_stats) ++prefix_queries_;
    int64_t max_full = (n - 1) / block_size_;
    uint64_t h = 0;
    int64_t got = 0;
    for (int64_t i = 0; i < max_full && got < max_out; ++i) {
      h = chain_hash(h, tokens + i * block_size_, block_size_);
      auto it = prefix_.find(h);
      if (it == prefix_.end()) break;
      out[got++] = it->second;
    }
    if (got > 0 && count_stats) ++prefix_hits_;
    return got;
  }

  // Chain hashes of every full prompt block (at least one token stays
  // uncached), residency-independent — the tier-store keys the engine
  // probes lower tiers with.  Mirrors Python prefix_chain.
  int64_t prefix_chain(const int32_t* tokens, int64_t n, uint64_t* out,
                       int64_t max_out) const {
    if (!enable_prefix_) return 0;
    int64_t max_full = (n - 1) / block_size_;
    uint64_t h = 0;
    int64_t got = 0;
    for (int64_t i = 0; i < max_full && got < max_out; ++i) {
      h = chain_hash(h, tokens + i * block_size_, block_size_);
      out[got++] = h;
    }
    return got;
  }

  // Whether a chain hash currently resolves in HBM (the engine's demote
  // drain filters out hashes re-registered since their eviction).
  bool prefix_resolvable(uint64_t h) const { return prefix_.count(h) != 0; }

  // ---- tiered KV cache: eviction log + restore state machine ----------
  // Mirrors runtime/block_manager.py (the Python twin is the semantic
  // reference; tests/test_torch_native.py drives both with one op trace).

  void set_record_evictions(bool on) { record_evictions_ = on; }
  bool record_evictions() const { return record_evictions_; }

  // Drain the (block, chain-hash) eviction log into caller arrays;
  // returns entries written (the log is cleared regardless — the engine
  // sizes the buffers from num_evictions() first).
  int64_t num_evictions() const {
    return static_cast<int64_t>(evicted_.size());
  }
  int64_t take_evictions(int32_t* blocks_out, uint64_t* hashes_out,
                         int64_t max_out) {
    int64_t n = 0;
    for (const auto& e : evicted_) {
      if (n >= max_out) break;
      blocks_out[n] = e.first;
      hashes_out[n] = e.second;
      ++n;
    }
    evicted_.clear();
    return n;
  }

  // Claim one free block per hash for an in-flight host->HBM restore;
  // the blocks leave every pool until commit_restore.  Returns the count
  // (== n) or -1 without mutating when the pool can't cover it.
  int64_t begin_restore(const uint64_t* hashes, int64_t n,
                        int32_t* blocks_out) {
    if (n > num_free_blocks()) return -1;
    for (int64_t i = 0; i < n; ++i) {
      int32_t b = pop_free_block();
      restoring_[b] = hashes[i];
      blocks_out[i] = b;
    }
    return n;
  }

  // Publish restored blocks as cached-pool prefix entries (MRU); a hash
  // re-registered meanwhile returns its redundant block to the free
  // list.  Returns prefix entries published.
  int64_t commit_restore(const uint64_t* hashes, const int32_t* blocks,
                         int64_t n) {
    int64_t published = 0;
    for (int64_t i = 0; i < n; ++i) {
      int32_t b = blocks[i];
      uint64_t h = hashes[i];
      restoring_.erase(b);
      if (prefix_.count(h) || block_hash_.count(b)) {
        free_.push_back(b);
        continue;
      }
      prefix_[h] = b;
      block_hash_[b] = h;
      cached_lru_.push_back(b);
      cached_pos_[b] = std::prev(cached_lru_.end());
      ++published;
    }
    return published;
  }

  void abort_restore(const int32_t* blocks, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      restoring_.erase(blocks[i]);
      free_.push_back(blocks[i]);
    }
  }

  // Returns block count, or -1 OOM, -2 seq exists.
  int64_t allocate(const std::string& seq_id, const int32_t* tokens,
                   int64_t n, const int32_t* shared, int64_t nshared,
                   int32_t* out, int64_t max_out) {
    if (seqs_.count(seq_id)) return -2;
    int64_t need = blocks_needed(n) - nshared;
    int64_t revivable = 0;
    for (int64_t i = 0; i < nshared; ++i)
      if (cached_pos_.count(shared[i])) ++revivable;
    if (need > num_free_blocks() - revivable) return -1;
    SeqAlloc alloc;
    alloc.blocks.reserve(blocks_needed(n));
    for (int64_t i = 0; i < nshared; ++i) {
      int32_t b = shared[i];
      auto it = cached_pos_.find(b);
      if (it != cached_pos_.end()) {  // revive: refcount was 0
        cached_lru_.erase(it->second);
        cached_pos_.erase(it);
        refcount_[b] = 1;
      } else {
        ++refcount_[b];
      }
      alloc.blocks.push_back(b);
    }
    for (int64_t i = 0; i < (need > 0 ? need : 0); ++i) {
      int32_t b = pop_free_block();
      refcount_[b] = 1;
      alloc.blocks.push_back(b);
    }
    alloc.num_tokens = n;
    register_prefix_blocks(alloc, tokens, n);
    int64_t total = static_cast<int64_t>(alloc.blocks.size());
    for (int64_t i = 0; i < total && i < max_out; ++i) out[i] = alloc.blocks[i];
    seqs_.emplace(seq_id, std::move(alloc));
    return total;
  }

  int needs_new_block(const std::string& seq_id) const {
    auto it = seqs_.find(seq_id);
    if (it == seqs_.end()) return -1;
    return needs_new_block_alloc(it->second);
  }

  int can_append(const std::string& seq_id) const {
    int nb = needs_new_block(seq_id);
    if (nb < 0) return -1;
    return !nb || num_free_blocks() >= 1;
  }

  // Flat slot id, or -1 OOM, -2 unknown seq.
  int64_t append_slot(const std::string& seq_id) {
    auto it = seqs_.find(seq_id);
    if (it == seqs_.end()) return -2;
    return append_slot_alloc(it->second);
  }

  // Grow the block table to hold total_tokens slots without advancing the
  // written-token counter.  Returns 0, or -1 OOM, -2 unknown seq.
  int64_t reserve(const std::string& seq_id, int64_t total_tokens) {
    auto it = seqs_.find(seq_id);
    if (it == seqs_.end()) return -2;
    return reserve_alloc(it->second, total_tokens);
  }

  // Commit n written tokens.  Returns 0, or -2 unknown seq, -3 beyond
  // reserved capacity.
  int64_t advance(const std::string& seq_id, int64_t n) {
    auto it = seqs_.find(seq_id);
    if (it == seqs_.end()) return -2;
    return advance_alloc(it->second, n);
  }

  int64_t slot_for_token(const std::string& seq_id, int64_t idx) const {
    auto it = seqs_.find(seq_id);
    if (it == seqs_.end()) return -2;
    const SeqAlloc& a = it->second;
    if (idx < 0 || idx / block_size_ >= static_cast<int64_t>(a.blocks.size()))
      return -3;
    int32_t b = a.blocks[idx / block_size_];
    if (b == kReleased) return -3;  // window-released: no writable slot
    return static_cast<int64_t>(b) * block_size_ + idx % block_size_;
  }

  int64_t block_table(const std::string& seq_id, int32_t* out,
                      int64_t max_out) const {
    auto it = seqs_.find(seq_id);
    if (it == seqs_.end()) return -2;
    return block_table_alloc(it->second, out, max_out);
  }

  // Sliding-window rolling buffer: return blocks holding only positions
  // before first_needed_token to the pool.  Returns blocks released, or
  // -2 unknown seq.
  int64_t release_out_of_window(const std::string& seq_id,
                                int64_t first_needed_token) {
    auto it = seqs_.find(seq_id);
    if (it == seqs_.end()) return -2;
    SeqAlloc& a = it->second;
    // never release the newest written position's block (or beyond): the
    // next append / spec-verify rewrite targets it (mirrors Python)
    int64_t newest = a.num_tokens > 0 ? a.num_tokens - 1 : 0;
    if (first_needed_token > newest) first_needed_token = newest;
    int64_t first_block = first_needed_token / block_size_;
    if (first_block > static_cast<int64_t>(a.blocks.size()))
      first_block = static_cast<int64_t>(a.blocks.size());
    int64_t released = 0;
    for (int64_t i = a.released_upto; i < first_block; ++i) {
      int32_t b = a.blocks[i];
      if (b == kReleased) continue;
      release_block(b, /*cache_blocks=*/true);
      a.blocks[i] = kReleased;
      ++released;
    }
    if (first_block > a.released_upto) a.released_upto = first_block;
    return released;
  }

  // ---- per-cycle batched ops (the host hot path) ---------------------
  //
  // The engine's decode cycle used to make 2-3 Python->native calls PER
  // ROW (needs_new_block, append_slot, block_table); at production
  // stream counts that per-request churn is the dominant host cost once
  // the device loop is pipelined.  These batch the whole cycle's
  // admission / charge / table fill into ONE boundary crossing each.

  // Non-mutating capacity probe: blocks missing for one decode append
  // across these rows (0 = the charge below will succeed).  The engine's
  // preemption loop polls this until the pool fits.  -2 unknown seq.
  int64_t decode_shortfall(const char* const* seq_ids, int64_t n) {
    std::vector<SeqAlloc*> allocs;
    if (!resolve(seq_ids, n, &allocs)) return -2;
    int64_t need = 0;
    for (SeqAlloc* a : allocs) need += needs_new_block_alloc(*a);
    int64_t s = need - num_free_blocks();
    return s > 0 ? s : 0;
  }

  // Decode charge: either the pool covers every row's potential fresh
  // block (then append a slot for each row, writing flat slot ids into
  // slots_out[i]) or NOTHING is mutated and the shortfall in blocks is
  // returned (the engine preempts and retries).  Returns 0 on success,
  // the positive shortfall on capacity miss, -1 on a mid-batch append
  // OOM, -2 on an unknown sequence.  The no-mutation guarantee holds
  // for DISTINCT seq ids (the engine's batches always are): a
  // duplicated id can defeat the pre-count and hit the -1 path with
  // earlier rows charged — exactly the partial state a per-request
  // append_slot loop (the Python manager) leaves before raising.
  int64_t charge_decode(const char* const* seq_ids, int64_t n,
                        int32_t* slots_out) {
    std::vector<SeqAlloc*> allocs;
    if (!resolve(seq_ids, n, &allocs)) return -2;
    int64_t need = 0;
    for (SeqAlloc* a : allocs) need += needs_new_block_alloc(*a);
    if (need > num_free_blocks()) return need - num_free_blocks();
    for (int64_t i = 0; i < n; ++i) {
      int64_t s = append_slot_alloc(*allocs[static_cast<size_t>(i)]);
      if (s == -1) return -1;  // duplicate-id OOM, see above
      slots_out[i] = static_cast<int32_t>(s);
    }
    return 0;
  }

  // Write each sequence's block table into row i of a caller-owned
  // (n, stride) int32 buffer (only the first len(blocks) entries of a
  // row are touched; callers pass zeroed padding buffers).  Returns the
  // longest table written, or -2 on an unknown sequence (rows already
  // written stay written — the caller treats -2 as fatal).
  int64_t fill_block_tables(const char* const* seq_ids, int64_t n,
                            int32_t* out, int64_t stride) {
    std::vector<SeqAlloc*> allocs;
    if (!resolve(seq_ids, n, &allocs)) return -2;
    int64_t longest = 0;
    for (int64_t i = 0; i < n; ++i) {
      int64_t len = block_table_alloc(*allocs[static_cast<size_t>(i)],
                                      out + i * stride, stride);
      if (len > longest) longest = len;
    }
    return longest;
  }

  // Batched reserve (fused decode windows / spec drafts): reserve each
  // sequence's table up to totals[i] slots.  On OOM returns -1 with
  // earlier rows' reservations kept — the same semantics as the Python
  // loop in Engine._try_reserve_window (over-reserved blocks stay
  // attached and are used as the sequence grows).  -2 unknown seq.
  int64_t reserve_batch(const char* const* seq_ids, int64_t n,
                        const int64_t* totals) {
    std::vector<SeqAlloc*> allocs;
    if (!resolve(seq_ids, n, &allocs)) return -2;
    for (int64_t i = 0; i < n; ++i) {
      int64_t r = reserve_alloc(*allocs[static_cast<size_t>(i)], totals[i]);
      if (r != 0) return r;
    }
    return 0;
  }

  // Batched advance (window flush commits S written tokens per row).
  // 0 ok; -2 unknown; -3 beyond reserved capacity (nothing after the
  // offending row is advanced).
  int64_t advance_batch(const char* const* seq_ids, int64_t n,
                        int64_t steps) {
    std::vector<SeqAlloc*> allocs;
    if (!resolve(seq_ids, n, &allocs)) return -2;
    for (SeqAlloc* a : allocs) {
      int64_t r = advance_alloc(*a, steps);
      if (r != 0) return r;
    }
    return 0;
  }

  // Scheduler admission (one call per cycle): greedy head-of-queue pick
  // over candidate prompt lengths with the scheduler's own arithmetic —
  // shared power-of-2 length bucket, token-budget charge
  // bucket*(picked+1), and a +1-block decode headroom charge per pick
  // against the CURRENT free pool.  counts[] is the waiting queue's
  // head segment (the caller truncates at the first chunk-route or
  // over-seat candidate).  Writes the number of admissible requests and
  // their shared padded bucket.
  void admit_prefill(const int32_t* counts, int64_t n, int64_t max_seats,
                     int64_t max_prefill_tokens, int32_t min_bucket,
                     int64_t* picked_out, int64_t* bucket_out) {
    int64_t picked = 0, bucket = 0, reserved = 0;
    int64_t free = num_free_blocks();
    for (int64_t i = 0; i < n && picked < max_seats; ++i) {
      int64_t b = next_pow2(counts[i]);
      if (b < min_bucket) b = min_bucket;
      int64_t cand = bucket > b ? bucket : b;
      if (cand * (picked + 1) > max_prefill_tokens && picked) break;
      int64_t need = blocks_needed(counts[i]) + 1;
      if (reserved + need > free) break;
      ++picked;
      reserved += need;
      bucket = cand;
    }
    *picked_out = picked;
    *bucket_out = bucket;
  }

  static int64_t next_pow2(int64_t n) {
    int64_t p = 1;
    while (p < n) p <<= 1;
    return p;
  }

  // cache_blocks=false drops the blocks' prefix hashes instead of parking
  // them in the cached pool — for sequences whose KV was never fully
  // written (e.g. a chunked prefill aborted mid-prompt).
  void free_seq(const std::string& seq_id, bool cache_blocks = true) {
    auto it = seqs_.find(seq_id);
    if (it == seqs_.end()) return;
    for (int32_t b : it->second.blocks) {
      if (b == kReleased) continue;  // already back in the pool
      release_block(b, cache_blocks);
    }
    seqs_.erase(it);
  }

 private:
  // ---- alloc-based twins of the per-seq ops ---------------------------
  // The batched cycle ops resolve each sequence's SeqAlloc ONCE (with a
  // reused key buffer) and then work through these, so "one boundary
  // crossing per cycle" doesn't hide per-row std::string construction
  // and repeated hash lookups inside the call.

  int needs_new_block_alloc(const SeqAlloc& a) const {
    return a.num_tokens % block_size_ == 0 &&
           a.num_tokens / block_size_ ==
               static_cast<int64_t>(a.blocks.size());
  }

  int64_t append_slot_alloc(SeqAlloc& a) {
    int64_t offset = a.num_tokens % block_size_;
    if (a.num_tokens % block_size_ == 0 &&
        a.num_tokens / block_size_ == static_cast<int64_t>(a.blocks.size())) {
      if (num_free_blocks() == 0) return -1;
      int32_t b = pop_free_block();
      refcount_[b] = 1;
      a.blocks.push_back(b);
    }
    int32_t block = a.blocks[a.num_tokens / block_size_];
    ++a.num_tokens;
    return static_cast<int64_t>(block) * block_size_ + offset;
  }

  int64_t reserve_alloc(SeqAlloc& a, int64_t total_tokens) {
    int64_t need = blocks_needed(total_tokens) -
                   static_cast<int64_t>(a.blocks.size());
    if (need > num_free_blocks()) return -1;
    for (int64_t i = 0; i < need; ++i) {
      int32_t b = pop_free_block();
      refcount_[b] = 1;
      a.blocks.push_back(b);
    }
    return 0;
  }

  int64_t advance_alloc(SeqAlloc& a, int64_t n) {
    if (a.num_tokens + n >
        static_cast<int64_t>(a.blocks.size()) * block_size_)
      return -3;
    a.num_tokens += n;
    return 0;
  }

  int64_t block_table_alloc(const SeqAlloc& a, int32_t* out,
                            int64_t max_out) const {
    int64_t n = static_cast<int64_t>(a.blocks.size());
    for (int64_t i = 0; i < n && i < max_out; ++i) {
      int32_t b = a.blocks[i];
      // released entries report block 0 (valid id; those positions are
      // masked/skipped by every attention impl) — mirrors the Python side
      out[i] = b == kReleased ? 0 : b;
    }
    return n;
  }

  // Resolve a batch of seq ids to their allocs with ONE reused key
  // buffer; false when any id is unknown.
  bool resolve(const char* const* seq_ids, int64_t n,
               std::vector<SeqAlloc*>* out) {
    out->resize(static_cast<size_t>(n));
    std::string key;
    for (int64_t i = 0; i < n; ++i) {
      key.assign(seq_ids[i]);
      auto it = seqs_.find(key);
      if (it == seqs_.end()) return false;
      (*out)[static_cast<size_t>(i)] = &it->second;
    }
    return true;
  }

  void release_block(int32_t b, bool cache_blocks) {
    auto rc = refcount_.find(b);
    int32_t count = (rc == refcount_.end() ? 1 : rc->second) - 1;
    if (count > 0) {
      refcount_[b] = count;
      return;
    }
    if (rc != refcount_.end()) refcount_.erase(rc);
    if (!cache_blocks) drop_hash(b);
    if (block_hash_.count(b)) {  // keep KV for prefix reuse, LRU order
      auto pos = cached_pos_.find(b);
      if (pos != cached_pos_.end()) cached_lru_.erase(pos->second);
      cached_lru_.push_back(b);
      cached_pos_[b] = std::prev(cached_lru_.end());
    } else {
      free_.push_back(b);
    }
  }

  int32_t pop_free_block() {
    if (!free_.empty()) {
      int32_t b = free_.back();
      free_.pop_back();
      return b;
    }
    // evict the LRU cached block; its prefix entry dies with it — or is
    // demoted by the engine when eviction recording is armed
    int32_t b = cached_lru_.front();
    cached_lru_.pop_front();
    cached_pos_.erase(b);
    if (record_evictions_) {
      auto it = block_hash_.find(b);
      if (it != block_hash_.end()) {
        auto p = prefix_.find(it->second);
        if (p != prefix_.end() && p->second == b)
          evicted_.emplace_back(b, it->second);
      }
    }
    drop_hash(b);
    return b;
  }

  void drop_hash(int32_t block) {
    auto it = block_hash_.find(block);
    if (it == block_hash_.end()) return;
    auto p = prefix_.find(it->second);
    if (p != prefix_.end() && p->second == block) prefix_.erase(p);
    block_hash_.erase(it);
  }

  void register_prefix_blocks(const SeqAlloc& alloc, const int32_t* tokens,
                              int64_t n) {
    if (!enable_prefix_) return;
    uint64_t h = 0;
    int64_t full = n / block_size_;
    for (int64_t i = 0; i < full; ++i) {
      h = chain_hash(h, tokens + i * block_size_, block_size_);
      int32_t phys = alloc.blocks[i];
      if (!prefix_.count(h) && !block_hash_.count(phys)) {
        prefix_[h] = phys;
        block_hash_[phys] = h;
      }
    }
  }

  int32_t num_blocks_;
  int32_t block_size_;
  bool enable_prefix_;
  std::vector<int32_t> free_;
  std::list<int32_t> cached_lru_;  // oldest first
  std::unordered_map<int32_t, std::list<int32_t>::iterator> cached_pos_;
  std::unordered_map<std::string, SeqAlloc> seqs_;
  std::unordered_map<int32_t, int32_t> refcount_;
  std::unordered_map<uint64_t, int32_t> prefix_;
  std::unordered_map<int32_t, uint64_t> block_hash_;
  int64_t prefix_hits_ = 0;
  int64_t prefix_queries_ = 0;
  // tiered KV cache (mirrors the Python twin's tier state)
  bool record_evictions_ = false;
  std::vector<std::pair<int32_t, uint64_t>> evicted_;
  std::unordered_map<int32_t, uint64_t> restoring_;
};

}  // namespace tpuserve
