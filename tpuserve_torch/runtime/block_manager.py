"""Paged KV-cache block manager with hash-based prefix caching.

Python implementation of the block-table bookkeeping that vLLM does inside
the container the reference deploys (the reference delegates the whole
engine: kubernetes-single-node.yaml:14, llm-d-deploy.yaml:140-193).
The port's own copy of the JAX package's Python block manager, without
what the port does not run yet: the C++ drop-in replacement (ROADMAP.md,
"native block manager"), the KV-tier eviction log and restores, and the
sliding-window rolling buffer.

Design: physical blocks of ``block_size`` token slots; per-sequence block
tables map logical block index -> physical block id.  Full prompt blocks are
content-hashed (chained, so a hash identifies the whole prefix) for
copy-free prefix reuse.  Freed hashed blocks move to an LRU "cached" pool:
still holding their KV contents, reusable by a later request with the same
prefix, evicted only when fresh blocks run out.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

from tpuserve_torch.utils import cdiv, next_power_of_2


@dataclasses.dataclass
class SeqAlloc:
    blocks: list[int]
    num_tokens: int                  # tokens written so far


class BlockManager:
    """Allocates physical cache blocks to sequences; optional prefix cache."""

    def __init__(self, num_blocks: int, block_size: int, enable_prefix_caching: bool = True):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        # freed-but-hashed blocks, LRU order (oldest first), KV still valid
        self._cached: OrderedDict[int, None] = OrderedDict()
        self._seqs: dict[str, SeqAlloc] = {}
        self._refcount: dict[int, int] = {}
        self._prefix: dict[int, int] = {}       # chain-hash -> physical block
        self._block_hash: dict[int, int] = {}   # physical block -> chain-hash
        self.prefix_hits = 0
        self.prefix_queries = 0

    # ---- capacity -------------------------------------------------------

    @property
    def num_free_blocks(self) -> int:
        """Blocks available for allocation (fresh + evictable cached)."""
        return len(self._free) + len(self._cached)

    def blocks_needed(self, num_tokens: int) -> int:
        return cdiv(num_tokens, self.block_size)

    def _pop_free_block(self) -> int:
        if self._free:
            return self._free.pop()
        # evict the LRU cached block: its prefix entry dies with it
        block, _ = self._cached.popitem(last=False)
        self._drop_hash(block)
        return block

    def _drop_hash(self, block: int) -> None:
        h = self._block_hash.pop(block, None)
        if h is not None and self._prefix.get(h) == block:
            del self._prefix[h]

    # ---- prefix cache ---------------------------------------------------

    @staticmethod
    def _chain_hash(prev_hash: int, tokens: tuple[int, ...]) -> int:
        return hash((prev_hash, tokens))

    def lookup_prefix(self, token_ids: list[int],
                      count_stats: bool = True) -> tuple[list[int], int]:
        """Longest cached prefix: returns (physical blocks, num cached tokens).

        Only whole blocks are reusable, and at least one token must remain
        un-cached so prefill has something to compute.
        ``count_stats=False`` for routing peeks (the scheduler probes the
        cache to pick a prefill path; only the engine's real lookup should
        move the hit-rate metrics).
        """
        if not self.enable_prefix_caching:
            return [], 0
        if count_stats:
            self.prefix_queries += 1
        blocks: list[int] = []
        h = 0
        max_full = (len(token_ids) - 1) // self.block_size
        for i in range(max_full):
            chunk = tuple(token_ids[i * self.block_size:(i + 1) * self.block_size])
            h = self._chain_hash(h, chunk)
            phys = self._prefix.get(h)
            if phys is None:
                break
            blocks.append(phys)
        if blocks and count_stats:
            self.prefix_hits += 1
        return blocks, len(blocks) * self.block_size

    def _register_prefix_blocks(self, seq_id: str, token_ids: list[int]) -> None:
        """Hash and publish this sequence's fully-written prompt blocks."""
        if not self.enable_prefix_caching:
            return
        alloc = self._seqs[seq_id]
        h = 0
        for i in range(len(token_ids) // self.block_size):
            chunk = tuple(token_ids[i * self.block_size:(i + 1) * self.block_size])
            h = self._chain_hash(h, chunk)
            phys = alloc.blocks[i]
            if h not in self._prefix and phys not in self._block_hash:
                self._prefix[h] = phys
                self._block_hash[phys] = h

    # ---- allocation -----------------------------------------------------

    def allocate(self, seq_id: str, prompt_token_ids: list[int],
                 shared_blocks: Optional[list[int]] = None) -> SeqAlloc:
        """Allocate blocks for a prompt; ``shared_blocks`` are prefix-cache
        hits (revived / ref-counted, never copied).

        Sharing dedups KV memory across identical prefixes.  The batched
        prefill path still rewrites identical KV into shared blocks (one
        shared padded shape, no per-request skip); the chunked path starts
        at the cached offset and skips the recompute entirely
        (engine._run_prefill_chunk)."""
        assert seq_id not in self._seqs, f"{seq_id} already allocated"
        shared_blocks = shared_blocks or []
        need = self.blocks_needed(len(prompt_token_ids)) - len(shared_blocks)
        # shared blocks sitting in the cached pool don't count as consumable
        free_after_revive = (self.num_free_blocks
                             - sum(1 for b in shared_blocks if b in self._cached))
        if need > free_after_revive:
            raise MemoryError(f"out of KV blocks (need {need}, free {free_after_revive})")
        for b in shared_blocks:
            if b in self._cached:           # revive: refcount was 0
                del self._cached[b]
                self._refcount[b] = 1
            else:
                self._refcount[b] = self._refcount.get(b, 0) + 1
        fresh = [self._pop_free_block() for _ in range(max(need, 0))]
        for b in fresh:
            self._refcount[b] = 1
        alloc = SeqAlloc(blocks=shared_blocks + fresh,
                         num_tokens=len(prompt_token_ids))
        self._seqs[seq_id] = alloc
        self._register_prefix_blocks(seq_id, prompt_token_ids)
        return alloc

    def needs_new_block(self, seq_id: str) -> bool:
        """True when the next append_slot will have to grab a fresh block."""
        alloc = self._seqs[seq_id]
        return (alloc.num_tokens % self.block_size == 0
                and alloc.num_tokens // self.block_size == len(alloc.blocks))

    def append_slot(self, seq_id: str) -> int:
        """Reserve the next token slot; returns the flat slot id
        (block * block_size + offset).  Grows the block table as needed."""
        alloc = self._seqs[seq_id]
        offset = alloc.num_tokens % self.block_size
        if self.needs_new_block(seq_id):
            if self.num_free_blocks == 0:
                raise MemoryError("out of KV blocks on append")
            b = self._pop_free_block()
            self._refcount[b] = 1
            alloc.blocks.append(b)
        block = alloc.blocks[alloc.num_tokens // self.block_size]
        alloc.num_tokens += 1
        return block * self.block_size + offset

    def reserve(self, seq_id: str, total_tokens: int) -> None:
        """Grow the block table to hold ``total_tokens`` slots WITHOUT
        advancing the written-token counter (speculative decoding writes a
        draft window first and only commits the accepted length)."""
        alloc = self._seqs[seq_id]
        need = self.blocks_needed(total_tokens) - len(alloc.blocks)
        if need > self.num_free_blocks:
            raise MemoryError("out of KV blocks on reserve")
        for _ in range(need):
            b = self._pop_free_block()
            self._refcount[b] = 1
            alloc.blocks.append(b)

    def advance(self, seq_id: str, n: int) -> None:
        """Commit ``n`` written tokens (slots must already be reserved)."""
        alloc = self._seqs[seq_id]
        if alloc.num_tokens + n > len(alloc.blocks) * self.block_size:
            raise ValueError("advance beyond reserved capacity")
        alloc.num_tokens += n

    def block_table(self, seq_id: str) -> list[int]:
        """Physical block ids by logical index."""
        return list(self._seqs[seq_id].blocks)

    def _release_block(self, b: int, cache_blocks: bool = True) -> None:
        rc = self._refcount.get(b, 1) - 1
        if rc > 0:
            self._refcount[b] = rc
            return
        self._refcount.pop(b, None)
        if not cache_blocks:
            self._drop_hash(b)
        if b in self._block_hash:       # keep KV around for prefix reuse
            self._cached[b] = None
            self._cached.move_to_end(b)
        else:
            self._free.append(b)

    def free(self, seq_id: str, cache_blocks: bool = True) -> None:
        """Release a sequence's blocks.  ``cache_blocks=False`` drops their
        prefix-cache hashes instead of parking them in the cached pool — for
        sequences whose KV was never fully written (e.g. a chunked prefill
        aborted mid-prompt), whose blocks would otherwise be served as
        cached prefixes full of garbage."""
        alloc = self._seqs.pop(seq_id, None)
        if alloc is None:
            return
        for b in alloc.blocks:
            self._release_block(b, cache_blocks)

    def num_seqs(self) -> int:
        return len(self._seqs)

    # ---- per-cycle batched ops ------------------------------------------
    # One call per engine cycle instead of 2-3 per request: the boundary
    # the JAX package's C++ manager implements, so a native manager can
    # slot in behind the same calls.

    def decode_shortfall(self, seq_ids) -> int:
        """Non-mutating capacity probe: blocks missing for one decode
        append across these rows (0 = charge_decode will succeed); the
        engine preempts while this is positive."""
        need = sum(self.needs_new_block(s) for s in seq_ids)
        return max(need - self.num_free_blocks, 0)

    def charge_decode(self, seq_ids, slots_out) -> int:
        """Charge one decode append per sequence: either every row fits
        (slots written into ``slots_out[i]``, returns 0) or NOTHING is
        mutated and the block shortfall is returned — the engine preempts
        and retries."""
        need = sum(self.needs_new_block(s) for s in seq_ids)
        short = need - self.num_free_blocks
        if short > 0:
            return short
        for i, s in enumerate(seq_ids):
            slots_out[i] = self.append_slot(s)
        return 0

    def fill_block_tables(self, seq_ids, out) -> int:
        """Write each sequence's block table into row i of ``out`` (a
        zeroed (n, max_blocks_per_seq) int32 array); returns the longest
        table written."""
        longest = 0
        for i, s in enumerate(seq_ids):
            bt = self.block_table(s)
            out[i, :len(bt)] = bt
            if len(bt) > longest:
                longest = len(bt)
        return longest

    def reserve_batch(self, seq_ids, totals) -> bool:
        """Reserve each sequence up to ``totals[i]`` slots; False on OOM
        with earlier reservations KEPT (Engine._try_reserve_window
        semantics: over-reserved blocks stay attached and get used as the
        sequence grows)."""
        try:
            for s, t in zip(seq_ids, totals):
                self.reserve(s, t)
        except MemoryError:
            return False
        return True

    def advance_batch(self, seq_ids, steps: int) -> None:
        for s in seq_ids:
            self.advance(s, steps)

    def admit_prefill(self, counts, max_seats: int,
                      max_prefill_tokens: int,
                      min_bucket: int) -> tuple[int, int]:
        """Scheduler admission arithmetic over the waiting queue's head
        segment (prompt token counts): greedy pick sharing one power-of-2
        length bucket, charging bucket*(picked+1) against the token
        budget and blocks_needed+1 decode headroom against the free pool.
        Returns (picked, bucket)."""
        picked = bucket = reserved = 0
        free = self.num_free_blocks
        for c in counts:
            if picked >= max_seats:
                break
            cand = max(bucket, max(next_power_of_2(c), min_bucket))
            if cand * (picked + 1) > max_prefill_tokens and picked:
                break
            need = self.blocks_needed(c) + 1
            if reserved + need > free:
                break
            picked += 1
            reserved += need
            bucket = cand
        return picked, bucket

    def check_integrity(self, expected_seq_ids=None) -> None:
        """Verify the block accounting invariants the engine relies on,
        raising RuntimeError with every violation found: double-free,
        refcount drift, orphaned sequences, leaked blocks.

        ``expected_seq_ids``: when given, the exact set of sequence ids
        that should currently hold allocations (the engine passes its
        live running + mid-chunk requests) — a sequence holding blocks
        with no live request is a leak; a live request without blocks is
        corruption.
        """
        problems: list[str] = []
        owned: dict[int, int] = {}
        for sid, alloc in self._seqs.items():
            for b in alloc.blocks:
                owned[b] = owned.get(b, 0) + 1
        free_set = set(self._free)
        cached_set = set(self._cached)
        if len(free_set) != len(self._free):
            problems.append("duplicate block ids in the free list")
        if free_set & cached_set:
            problems.append(
                f"blocks in BOTH free and cached: {sorted(free_set & cached_set)}")
        for b, n in sorted(owned.items()):
            rc = self._refcount.get(b, 0)
            if rc != n:
                problems.append(
                    f"block {b}: refcount {rc} != {n} owning sequence(s)")
            if b in free_set:
                problems.append(
                    f"block {b} owned by a live sequence AND free")
            if b in cached_set:
                problems.append(
                    f"block {b} owned by a live sequence AND cached")
        for b, rc in sorted(self._refcount.items()):
            if b not in owned:
                problems.append(
                    f"block {b} has refcount {rc} but no owning sequence")
        accounted = free_set | cached_set | set(owned)
        if len(accounted) != self.num_blocks:
            lost = self.num_blocks - len(accounted)
            problems.append(
                f"{lost} block(s) leaked: in neither the free list, the "
                "cached pool, nor any sequence table")
        for h, b in self._prefix.items():
            if self._block_hash.get(b) != h:
                problems.append(
                    f"prefix hash {h} maps to block {b} but the reverse "
                    "mapping disagrees")
        if expected_seq_ids is not None:
            extra = set(self._seqs) - set(expected_seq_ids)
            missing = set(expected_seq_ids) - set(self._seqs)
            if extra:
                problems.append(
                    "sequences holding blocks with no live request "
                    f"(leak): {sorted(extra)}")
            if missing:
                problems.append(
                    "live requests without block allocations "
                    f"(corruption): {sorted(missing)}")
        if problems:
            raise RuntimeError(
                "KV block integrity violated: "
                + "; ".join(problems))

