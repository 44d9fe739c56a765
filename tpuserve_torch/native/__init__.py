"""The port's native (C++) block manager.

``NativeBlockManager`` is an API-compatible drop-in for
``tpuserve_torch.runtime.block_manager.BlockManager`` backed by
``block_manager.hh`` in this directory: free-list allocation, refcounted
prefix sharing, chained block hashes (FNV-1a), LRU eviction of freed
hashed blocks, the tiered KV cache's eviction log and restore state
machine, and the sliding-window rolling buffer.  The binding is a CPython
extension (``_tpuserve_torch_native``, from ``block_manager_ext.cc``; a
ctypes call would cost microseconds, more than these operations), built
with g++ at first use into ``build/tpuserve_torch/`` at the repository
root and published with an atomic rename, so concurrent processes never
load a half-written library.  Without g++ (or with ``impl="python"`` in
``create_block_manager``) the engine keeps the pure-Python manager.

The batched calls (``charge_decode``, ``fill_block_tables``) write into
caller-owned int32 buffers through the buffer protocol: the engine passes
the numpy views of its pinned staging tensor (``runtime/graphs.py``
``Staging``), C-contiguous rows of one larger block, which the extension
fills in place, so the asynchronous copy to the card reads what it wrote.

``block_manager.cc`` is the same core behind a C ABI for hosts that are not
Python (``build_c_abi``).
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import logging
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

from tpuserve_torch.runtime.block_manager import SeqAlloc

logger = logging.getLogger("tpuserve_torch.native")

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "build" / "tpuserve_torch"
MODULE = "_tpuserve_torch_native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
_lock = threading.Lock()
_ext = None
_ext_tried = False


def _out_path(source: str, stem: str, suffix: str) -> Path:
    """The build of ``source`` (and the header), named by a hash of both and
    the flags: an edited source rebuilds, an unchanged one loads."""
    data = (SRC_DIR / source).read_bytes() + (SRC_DIR / "block_manager.hh").read_bytes()
    digest = hashlib.sha256(data + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / digest / f"{stem}{suffix}"


def _compile(source: str, out: Path, extra: tuple = ()) -> bool:
    if out.is_file():
        return True
    if shutil.which("g++") is None:
        logger.info("no g++: the native block manager is not built")
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private path and rename into place: the publish is
    # atomic, so a concurrent process (a pytest-xdist worker, a second
    # server) never loads a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, *extra, "-o", str(tmp), str(SRC_DIR / source)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        logger.info("built %s", out)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        stderr = getattr(e, "stderr", b"") or b""
        logger.warning("native build failed (%s%s); using the Python block manager",
                       e, stderr.decode(errors="replace")[:500])
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def ext_path() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return _out_path("block_manager_ext.cc", MODULE, suffix)


def _load():
    global _ext, _ext_tried
    with _lock:
        if _ext_tried:
            return _ext
        _ext_tried = True
        out = ext_path()
        if not _compile("block_manager_ext.cc", out,
                        (f"-I{sysconfig.get_paths()['include']}",)):
            return None
        try:
            loader = importlib.machinery.ExtensionFileLoader(MODULE, str(out))
            spec = importlib.util.spec_from_file_location(MODULE, str(out), loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _ext = mod
        except ImportError as e:
            logger.warning("cannot import %s: %s", MODULE, e)
            _ext = None
        return _ext


def native_available() -> bool:
    """Whether the extension is built (building it now if need be)."""
    return _load() is not None


def build_c_abi() -> Path | None:
    """Build ``block_manager.cc`` (the C ABI) and return its path, or None
    without g++."""
    out = _out_path("block_manager.cc", "libtpuserve_torch_native", ".so")
    return out if _compile("block_manager.cc", out) else None


def ngram_propose(ids, k: int, max_ngram: int = 3, min_ngram: int = 1,
                  max_lookback: int = 1024):
    """The C++ n-gram prompt-lookup proposer (``runtime/spec.py``
    ``ngram_propose``'s twin); raises ``RuntimeError`` when unbuilt."""
    ext = _load()
    if ext is None:
        raise RuntimeError("native extension unavailable")
    return ext.ngram_propose(ids, k, max_ngram=max_ngram, min_ngram=min_ngram,
                             max_lookback=max_lookback)


class NativeBlockManager:
    """Drop-in for ``runtime.block_manager.BlockManager`` (see that module
    for the semantics; ``block_manager.hh`` mirrors them).  It has no
    sequence-table introspection: the engine's strict integrity check
    skips it."""

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_caching: bool = True):
        ext = _load()
        if ext is None:
            raise RuntimeError("native extension unavailable")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self._core = ext.BlockManagerCore(num_blocks, block_size,
                                          enable_prefix_caching=enable_prefix_caching)
        self._record_evictions = False

    # ---- capacity -------------------------------------------------------

    @property
    def num_free_blocks(self) -> int:
        return self._core.num_free_blocks()

    def blocks_needed(self, num_tokens: int) -> int:
        return self._core.blocks_needed(num_tokens)

    def can_allocate(self, num_tokens: int) -> bool:
        return self._core.can_allocate(num_tokens)

    @property
    def prefix_hits(self) -> int:
        return self._core.prefix_hits()

    @property
    def prefix_queries(self) -> int:
        return self._core.prefix_queries()

    # ---- prefix cache ---------------------------------------------------

    def lookup_prefix(self, token_ids, count_stats: bool = True) -> tuple[list[int], int]:
        blocks = self._core.lookup_prefix(list(token_ids), count_stats)
        return blocks, len(blocks) * self.block_size

    def prefix_chain(self, token_ids) -> list[int]:
        return self._core.prefix_chain(list(token_ids))

    def prefix_resolvable(self, h: int) -> bool:
        return self._core.prefix_resolvable(int(h))

    # ---- tiered KV cache: eviction log and restore state machine --------

    @property
    def record_evictions(self) -> bool:
        return self._record_evictions

    @record_evictions.setter
    def record_evictions(self, on: bool) -> None:
        self._record_evictions = bool(on)
        self._core.set_record_evictions(bool(on))

    def take_evictions(self) -> list[tuple[int, int]]:
        return self._core.take_evictions()

    def begin_restore(self, hashes):
        return self._core.begin_restore([int(h) for h in hashes])

    def commit_restore(self, hashes, blocks) -> int:
        return self._core.commit_restore([int(h) for h in hashes], [int(b) for b in blocks])

    def abort_restore(self, blocks) -> None:
        self._core.abort_restore([int(b) for b in blocks])

    @property
    def num_restoring_blocks(self) -> int:
        return self._core.num_restoring_blocks()

    @property
    def num_cached_blocks(self) -> int:
        return self._core.num_cached_blocks()

    # ---- allocation -----------------------------------------------------

    def allocate(self, seq_id: str, prompt_token_ids, shared_blocks=None) -> SeqAlloc:
        blocks = self._core.allocate(seq_id, list(prompt_token_ids), list(shared_blocks or []))
        return SeqAlloc(blocks=blocks, num_tokens=len(prompt_token_ids))

    def needs_new_block(self, seq_id: str) -> bool:
        return self._core.needs_new_block(seq_id)

    def can_append(self, seq_id: str) -> bool:
        return self._core.can_append(seq_id)

    def append_slot(self, seq_id: str) -> int:
        return self._core.append_slot(seq_id)

    def reserve(self, seq_id: str, total_tokens: int) -> None:
        self._core.reserve(seq_id, total_tokens)

    def advance(self, seq_id: str, n: int) -> None:
        self._core.advance(seq_id, n)

    def slot_for_token(self, seq_id: str, token_idx: int) -> int:
        return self._core.slot_for_token(seq_id, token_idx)

    def block_table(self, seq_id: str) -> list[int]:
        return self._core.block_table(seq_id)

    def release_out_of_window(self, seq_id: str, first_needed_token: int) -> int:
        return self._core.release_out_of_window(seq_id, first_needed_token)

    def free(self, seq_id: str, cache_blocks: bool = True) -> None:
        self._core.free(seq_id, cache_blocks)

    def num_seqs(self) -> int:
        return self._core.num_seqs()

    # ---- per-cycle batched calls (one crossing a cycle; results land in
    # caller-owned int32 buffers through the buffer protocol) -------------

    def decode_shortfall(self, seq_ids) -> int:
        return self._core.decode_shortfall(list(seq_ids))

    def charge_decode(self, seq_ids, slots_out) -> int:
        return self._core.charge_decode(list(seq_ids), slots_out)

    def fill_block_tables(self, seq_ids, out) -> int:
        return self._core.fill_block_tables(list(seq_ids), out)

    def reserve_batch(self, seq_ids, totals) -> bool:
        return self._core.reserve_batch(list(seq_ids), [int(t) for t in totals])

    def advance_batch(self, seq_ids, steps: int) -> None:
        self._core.advance_batch(list(seq_ids), steps)

    def admit_prefill(self, counts, max_seats: int, max_prefill_tokens: int,
                      min_bucket: int) -> tuple[int, int]:
        return self._core.admit_prefill([int(c) for c in counts], max_seats,
                                        max_prefill_tokens, min_bucket)
