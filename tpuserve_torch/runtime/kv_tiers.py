"""Host-DRAM and spill-directory tiers under the card's prefix cache: the
port of ``tpuserve/runtime/kv_tiers.py``.

The card's prefix cache (runtime/block_manager.py) keeps freed-but-hashed
blocks until fresh blocks run out; a cold ``_pop_free_block`` then evicts
the LRU cached block.  With the tiers on, the engine copies that block's
pages to this store before anything overwrites them, and a later prompt
whose prefix resolves here gets its blocks copied back ahead of admission
and prefills only the suffix.

- tier ``host``: one block's pages per entry, under a byte budget.  On the
  card each entry is one pinned record (``kv_cache.BlockPages``), so the
  restore's host-to-device copy runs asynchronously; int8 pages stay
  about half the size of bf16 ones, because the dtype rides through.
- tier ``spill``: ``.npz`` files in a directory, absorbing the host
  budget's overflow.  Files are written by a background thread (the
  engine loop never waits on the disk between scheduling and a dispatch);
  an entry is resolvable from memory the moment it is queued.  On start
  the directory is rescanned, so the files outlive the process.  The
  format is the JAX store's: raw bytes plus the dtype tag in the key for
  bfloat16 (``"{layer}.{key}@bfloat16"``), so either package reads the
  other's files.

A hash lives in EXACTLY ONE tier: the card (the block manager's prefix
map), host, or spill.  ``put`` demotes out of the card, host-budget
pressure moves host entries to spill, and ``take`` (the restore path)
removes the entry as its pages go back.  ``TPUSERVE_STRICT_BLOCKS`` checks
this every engine cycle (``Engine._check_block_integrity``).

Threads: the engine loop (put/take/drop) and the spill writer (pending ->
file).  The writer only ever holds numpy arrays, copied to pageable
memory on the loop thread: it makes no CUDA call, and in particular never
frees pinned memory, which would be one (the engine captures CUDA graphs
in the global capture mode, where no other thread may touch CUDA).
Shared maps are guarded by one lock held only for dict surgery, never for
file I/O.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from collections import OrderedDict

import numpy as np
import torch

logger = logging.getLogger("tpuserve_torch.kv_tiers")

# Spill-tier entry cap: a backstop against unbounded growth of the spill
# directory when the workload never reuses what it demotes.  Oldest
# entries are dropped past it, at rescan too.
DEFAULT_MAX_SPILL_ENTRIES = 1 << 16

# dtypes a spill file carries as raw bytes plus a tag (numpy has no
# bfloat16; the JAX store writes the ml_dtypes name)
_TAGGED = {torch.bfloat16: "bfloat16"}
_UNTAG = {tag: dt for dt, tag in _TAGGED.items()}
_NUMPY = {torch.float32: np.float32, torch.float16: np.float16, torch.int8: np.int8}


def pages_nbytes(pages: list[dict]) -> int:
    """Host bytes one block's per-layer page dict holds."""
    n = getattr(pages, "nbytes", None)        # a kv_cache.BlockPages knows
    if n is not None:
        return n
    return sum(int(a.nbytes) for layer in pages for a in layer.values())


def _encode(pages: list[dict]) -> dict[str, np.ndarray]:
    """A block's pages as ``np.savez`` arrays in pageable memory: the JAX
    store's keys (``"{layer}.{key}"``, ``@bfloat16`` for raw bf16 bytes).
    A ``kv_cache.BlockPages`` is copied once, as its whole record, and its
    arrays are numpy views of that copy; other pages array by array."""
    flat = {}
    layout = getattr(pages, "layout", None)
    if layout is not None:
        buf = pages.record.numpy().copy()
        for li, k, dt, shape, o, nb in layout:
            if dt in _TAGGED:
                flat[f"{li}.{k}@{_TAGGED[dt]}"] = buf[o:o + nb].reshape(*shape[:-1], -1)
            else:
                flat[f"{li}.{k}"] = buf[o:o + nb].view(_NUMPY[dt]).reshape(shape)
        return flat
    for li, layer in enumerate(pages):
        for k, a in layer.items():
            if a.dtype in _TAGGED:
                flat[f"{li}.{k}@{_TAGGED[a.dtype]}"] = a.contiguous().view(
                    torch.uint8).numpy().copy()
            else:
                flat[f"{li}.{k}"] = a.numpy().copy()
    return flat


def _decode(flat: dict[str, np.ndarray]) -> list[dict]:
    """``_encode``'s inverse: per-layer dicts of CPU tensors.  ValueError
    on a key or tag it cannot read."""
    n_layers = 1 + max(int(k.split(".", 1)[0]) for k in flat)
    pages: list[dict] = [{} for _ in range(n_layers)]
    for k, a in flat.items():
        li, key = k.split(".", 1)
        key, _, tag = key.partition("@")
        t = torch.from_numpy(np.ascontiguousarray(a))
        if tag:
            if tag not in _UNTAG:
                raise ValueError(f"unknown page dtype tag {tag!r}")
            t = t.view(torch.uint8).view(_UNTAG[tag])
        pages[int(li)][key] = t
    return pages


class TieredPageStore:
    """Chain-hash-keyed KV block pages in host DRAM with spill overflow.

    ``pages`` values are ``list[dict[str, Tensor]]``: one dict per model
    layer, the keys of the card's cache entries ("k"/"v" plus "ks"/"vs"
    scales under int8; an MLA model's "k" and, under int8, its two-slice
    "ks"), each a block's ``(block_size, kv_heads, head_dim)`` page (a
    ``(block_size, kv_heads)`` or ``(block_size, 2)`` scale page).
    """

    def __init__(self, host_bytes: int, spill_dir: str | None = None,
                 max_spill_entries: int = DEFAULT_MAX_SPILL_ENTRIES):
        self.host_budget_bytes = int(host_bytes)
        self.spill_dir = spill_dir
        self.max_spill_entries = max_spill_entries
        # hash -> (pages, nbytes); LRU order, oldest first.  Loop thread
        # only: no lock
        self._host: OrderedDict[int, tuple[list, int]] = OrderedDict()
        # spill tier, by write progress; BOTH under _lock:
        #   _spill_pending: hash -> encoded arrays, queued for the writer
        #   _spill:         hash -> path, on disk
        self._spill_pending: OrderedDict[int, dict] = OrderedDict()
        self._spill: OrderedDict[int, str] = OrderedDict()
        self._lock = threading.Lock()
        self._writeq: "queue.Queue[int | None]" = queue.Queue()
        self._writer: threading.Thread | None = None
        self.host_bytes_used = 0
        # cumulative flow counters (the engine mirrors them into
        # EngineStats for the server's metrics)
        self.spilled_blocks = 0     # host -> spill demotions (at enqueue)
        self.dropped_blocks = 0     # fell off the last tier (KV lost)
        # arrays the writer found that were not numpy (a tensor there could
        # be pinned, and its release a CUDA call off the loop thread): 0
        self.writer_tensor_pages = 0
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            self._rescan_spill_dir()

    # ---- introspection --------------------------------------------------

    @property
    def host_count(self) -> int:
        return len(self._host)

    @property
    def spill_count(self) -> int:
        with self._lock:
            return len(self._spill) + len(self._spill_pending)

    def __len__(self) -> int:
        return len(self._host) + self.spill_count

    def has(self, h: int) -> bool:
        if h in self._host:
            return True
        with self._lock:
            return h in self._spill or h in self._spill_pending

    def where(self, h: int) -> str | None:
        if h in self._host:
            return "host"
        with self._lock:
            if h in self._spill or h in self._spill_pending:
                return "spill"
        return None

    def hashes(self):
        """Every resolvable hash across both tiers (host first)."""
        yield from list(self._host)
        with self._lock:
            snap = list(self._spill_pending) + list(self._spill)
        yield from snap

    # ---- spill writer ---------------------------------------------------

    def _spill_path(self, h: int) -> str:
        # masked to the uint64 domain, so negative and native-style hashes
        # both name files injectively (the JAX store's names)
        return os.path.join(self.spill_dir,
                            f"kvt_{h & 0xFFFFFFFFFFFFFFFF:016x}.npz")

    def _rescan_spill_dir(self) -> None:
        """Adopt existing spill files (a restart), keyed back from the
        filename, oldest first so the cap drops the stalest.  A name with
        the top bit set is ambiguous between a uint64 hash and a negative
        Python hash: both keys map to the file, and the alias that never
        matches is shed as a read miss if it is ever probed."""
        try:
            ents = []
            for name in os.listdir(self.spill_dir):
                if not (name.startswith("kvt_") and name.endswith(".npz")):
                    continue
                path = os.path.join(self.spill_dir, name)
                try:
                    ents.append((os.path.getmtime(path), name, path))
                except OSError:
                    continue
            ents.sort()
            for _, _, path in ents[:-self.max_spill_entries or None]:
                self._drop_spill_file(path)
            for _, name, path in ents[-self.max_spill_entries:]:
                try:
                    v = int(name[4:20], 16)
                except ValueError:
                    continue
                self._spill[v] = path
                if v >= 1 << 63:
                    self._spill[v - (1 << 64)] = path
            if self._spill:
                logger.info("adopted %d spill-tier entr(ies) from %s",
                            len(self._spill), self.spill_dir)
        except OSError:
            pass

    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(target=self._writer_loop, daemon=True,
                                            name="tpuserve-torch-kv-spill")
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            h = self._writeq.get()
            try:
                if h is None:
                    return
                with self._lock:
                    flat = self._spill_pending.get(h)
                if flat is None:
                    continue             # taken/dropped before the write
                self.writer_tensor_pages += sum(
                    not isinstance(a, np.ndarray) for a in flat.values())
                ok = self._write_spill_file(h, flat)
                victims: list[str] = []
                with self._lock:
                    if self._spill_pending.pop(h, None) is None:
                        # taken/dropped DURING the write: orphaned file
                        if ok:
                            victims.append(self._spill_path(h))
                    elif ok:
                        self._spill[h] = self._spill_path(h)
                        while len(self._spill) > self.max_spill_entries:
                            _, p = self._spill.popitem(last=False)
                            victims.append(p)
                            self.dropped_blocks += 1
                    else:
                        self.dropped_blocks += 1
                for p in victims:
                    self._drop_spill_file(p)
            finally:
                self._writeq.task_done()

    def _write_spill_file(self, h: int, flat: dict) -> bool:
        path = self._spill_path(h)
        try:
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(f, **flat)
            os.replace(tmp, path)       # atomic publish
            return True
        except OSError as e:
            logger.warning("KV spill write failed (%s); dropping block", e)
            return False

    def _spill_one(self, h: int, pages: list[dict]) -> bool:
        """Move one block's pages to the spill tier: encoded to pageable
        numpy here on the loop thread (the pinned originals are released
        here too), resolvable from the pending map at once, written to
        disk by the writer thread."""
        if not self.spill_dir:
            return False
        flat = _encode(pages)
        with self._lock:
            self._spill_pending[h] = flat
        self.spilled_blocks += 1
        self._ensure_writer()
        self._writeq.put(h)
        return True

    def _drop_spill_file(self, path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass

    def flush(self) -> None:
        """Block until queued spill writes have landed (tests, shutdown)."""
        self._writeq.join()

    # ---- demote ---------------------------------------------------------

    def put(self, h: int, pages: list[dict]) -> None:
        """Demote one evicted block's pages under hash ``h``.  Host-budget
        overflow cascades the LRU host entry to the spill tier (or drops
        it when there is no spill directory)."""
        if self.has(h):                 # already demoted (the card held the
            return                      # hash until now: should not happen)
        nbytes = pages_nbytes(pages)
        if nbytes > self.host_budget_bytes:
            # one block larger than the whole host budget goes straight to
            # spill (a degenerate config, but stay correct)
            if not self._spill_one(h, pages):
                self.dropped_blocks += 1
            return
        self._host[h] = (pages, nbytes)
        self.host_bytes_used += nbytes
        while self.host_bytes_used > self.host_budget_bytes and self._host:
            old, (old_pages, old_n) = self._host.popitem(last=False)
            self.host_bytes_used -= old_n
            if not self._spill_one(old, old_pages):
                self.dropped_blocks += 1

    # ---- restore --------------------------------------------------------

    def take(self, h: int) -> list | None:
        """Remove and return the pages of ``h`` (the restore path: the hash
        is about to resolve on the card again, and a block lives in exactly
        one tier).  None when unresolvable or the spill file is unreadable
        (the caller recomputes; the loss is counted: that KV is gone)."""
        ent = self._host.pop(h, None)
        if ent is not None:
            self.host_bytes_used -= ent[1]
            return ent[0]
        with self._lock:
            pending = self._spill_pending.pop(h, None)
            if pending is None:
                path = self._spill.pop(h, None)
        if pending is not None:
            return _decode(pending)     # the writer skips or cleans the file
        if path is None:
            return None
        try:
            with np.load(path) as z:
                flat = {k: z[k] for k in z.files}
            pages = _decode(flat)
        except (OSError, ValueError, KeyError) as e:
            logger.warning("KV spill read failed for %s (%s); treating as "
                           "a miss", path, e)
            self._drop_spill_file(path)
            self.dropped_blocks += 1    # the KV is LOST, not restored
            return None
        self._drop_spill_file(path)
        return pages

    def drop(self, h: int) -> None:
        ent = self._host.pop(h, None)
        if ent is not None:
            self.host_bytes_used -= ent[1]
            return
        with self._lock:
            if self._spill_pending.pop(h, None) is not None:
                return                  # the writer cleans any half-born file
            path = self._spill.pop(h, None)
        if path is not None:
            self._drop_spill_file(path)

    def clear(self) -> None:
        with self._lock:
            self._spill_pending.clear()
            paths = list(self._spill.values())
            self._spill.clear()
        for path in paths:
            self._drop_spill_file(path)
        self._host.clear()
        self.host_bytes_used = 0
