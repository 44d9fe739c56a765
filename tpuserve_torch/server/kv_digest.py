"""Prefix-affinity digest: what a replica has cached, across tiers: the
port of ``tpuserve/server/kv_digest.py``.

A gateway's rendezvous prefix affinity maps a prompt-prefix key onto the
backend ring by hashing alone: it predicts where a prefix SHOULD live, not
where it does.  After failovers, load diversions, scale events, or a long
retention in the tiered KV cache (runtime/kv_tiers.py), the replica that
really holds a conversation's KV can be another one.  So each server
tracks the affinity keys of the prompts it served in a bounded LRU sized
to its cache reach across all three tiers, and advertises a bloom digest
of them on ``/healthz``, which a gateway folds into backend selection
(the JAX package's ``server/gateway.py``; the port's gateway is a
ROADMAP.md item).

The key derivation is the JAX package's, byte for byte (``affinity_key``:
the gateway calls it on the raw body, the server on the parsed one), so a
JAX gateway reads the port's digest.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from typing import Optional

#: digest width in bits; advertised alongside the digest so a gateway and
#: a backend built at different versions still interoperate
DIGEST_BITS = 1024

#: prompt prefix characters hashed into the affinity key — must match
#: GatewayConfig.affinity_prefix_chars' default (the gateway passes its
#: configured value; the server uses this default)
AFFINITY_PREFIX_CHARS = 256


def affinity_key(payload: dict, prefix_chars: int = AFFINITY_PREFIX_CHARS
                 ) -> Optional[str]:
    """Stable affinity key for one request payload (completions prompt or
    chat messages) — ONE derivation for the gateway's routing hash, the
    gateway's digest probe, and the server's digest tracker."""
    try:
        prompt = payload.get("prompt")
        if isinstance(prompt, list):
            prompt = "".join(map(str, prompt[:64]))
        if not prompt and isinstance(payload.get("messages"), list):
            prompt = json.dumps(payload["messages"])[:512]
        if not isinstance(prompt, str) or not prompt:
            return None
        return hashlib.sha256(prompt[:prefix_chars].encode()).hexdigest()
    except Exception:
        return None


def digest_bit(key: str, bits: int = DIGEST_BITS) -> int:
    """Bloom bit index for an affinity key (single hash function: at the
    fleet's key counts a 1-in-1024 false positive merely costs one
    suboptimal routing choice, not correctness)."""
    return int(hashlib.sha256(key.encode()).hexdigest()[:16], 16) % bits


class PrefixDigestTracker:
    """Bounded LRU of affinity keys this replica has served, rendered as
    a bloom digest for ``/healthz``.  Thread-safe (HTTP handler threads
    note keys; the health probe renders).

    ``capacity`` approximates the replica's cache reach: the tiered KV
    cache retains prefixes across HBM + host + PVC, so the server resizes
    the window to the total tier capacity as it grows (see
    OpenAIServer.healthz_payload) — with tiers off it stays near the HBM
    cached-pool size and the digest decays accordingly.
    """

    def __init__(self, capacity: int = 4096, bits: int = DIGEST_BITS):
        self.capacity = capacity
        self.bits = bits
        # key -> precomputed bloom bit: the sha256 runs ONCE at note()
        # time on the request path's own key, so digest_hex (called per
        # health probe while holding the same lock note() needs) is a
        # pure OR-loop instead of O(window) hashing under the lock
        self._keys: OrderedDict[str, int] = OrderedDict()
        self._lock = threading.Lock()

    def note(self, key: Optional[str]) -> None:
        if not key:
            return
        bit = digest_bit(key, self.bits)
        with self._lock:
            self._keys[key] = bit
            self._keys.move_to_end(key)
            while len(self._keys) > self.capacity:
                self._keys.popitem(last=False)

    #: bloom-width ceiling: 1<<17 bits renders as a 32 KiB hex string on
    #: /healthz — chunky but bounded; past ~16k tracked keys the digest
    #: accepts a rising false-positive rate instead of growing further
    MAX_BITS = 1 << 17

    def resize(self, capacity: int) -> None:
        """Grow the window to the replica's cache reach — and the bloom
        WIDTH with it (~8 bits per tracked key, capped), or a tiered
        replica's thousands of keys would saturate a fixed 1024-bit
        digest and 'hit' on every probe, silently degrading cache-aware
        routing back to the static ring."""
        capacity = max(64, int(capacity))
        bits = 1 << max(DIGEST_BITS.bit_length() - 1,
                        (8 * capacity - 1).bit_length())
        bits = min(bits, self.MAX_BITS)
        with self._lock:
            self.capacity = capacity
            if bits != self.bits:
                self.bits = bits
                for k in self._keys:        # one-time per growth step
                    self._keys[k] = digest_bit(k, bits)
            while len(self._keys) > self.capacity:
                self._keys.popitem(last=False)

    def __len__(self) -> int:
        return len(self._keys)

    def digest_hex(self) -> str:
        """The bloom digest as a fixed-width hex string (bits/4 chars)."""
        with self._lock:
            mask = 0
            for bit in self._keys.values():
                mask |= 1 << bit
        return format(mask, f"0{self.bits // 4}x")


def digest_has(digest_hex: str, bits: int, key: str) -> bool:
    """Membership probe against an advertised digest (gateway side)."""
    if not digest_hex or not bits:
        return False
    try:
        mask = int(digest_hex, 16)
    except ValueError:
        return False
    return bool(mask >> digest_bit(key, bits) & 1)
