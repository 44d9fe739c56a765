"""Host and spill tiers for model WEIGHT trees — the port of
``tpuserve/modelpool/tiers.py`` on torch tensors.

A replica that swaps its served model should not re-read the checkpoint
(or re-draw random weights) when the outgoing weights were resident
seconds ago.  This store pages whole parameter trees (nested dicts and
lists of tensors):

- tier ``host``: CPU tensors in pinned memory under a byte budget
  (``TPUSERVE_WEIGHT_HOST_BYTES``), so a restore is one asynchronous
  copy a leaf to the card;
- tier ``spill``: one ``.npy`` file a leaf plus a manifest in a directory
  (``TPUSERVE_WEIGHT_SPILL_DIR``), written on a background thread, leaf by
  leaf; an entry resolves from memory the moment it enters the write
  queue.  bfloat16 has no numpy dtype: its leaves are written as their
  ``int16`` bits and tagged, and come back bit for bit.  On start the
  directory is rescanned, so spilled weights survive a restart.

A model lives in EXACTLY ONE tier here (callers hold the card-resident
sets themselves): ``put`` demotes off the card (a model larger than the
host budget goes straight to the spill tier, in pageable memory), host
pressure moves the least recently used host entry to spill, ``take``
removes the entry as its leaves go back to the card.  ``prefetch``
promotes spill to host on a background thread, so a drain and a spill
read overlap (not for a model larger than the host budget, which the host
tier could not keep).

Writers: the pool on the engine loop (put/take/drop) and the spill-writer
thread; the shared maps are guarded by one lock held only for dict
surgery, never for file or device I/O.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import shutil
import threading
from collections import OrderedDict

import numpy as np
import torch

from tpuserve_torch.models.weights import map_leaves

logger = logging.getLogger("tpuserve_torch.modelpool.tiers")

_STREAM_MANIFEST = "manifest.json"
# torch dtypes numpy lacks: stored as the bits of a same-width integer
_BITS = {torch.bfloat16: (torch.int16, "bfloat16")}
_FROM_TAG = {tag: (dt, bits) for dt, (bits, tag) in _BITS.items()}

# Spill-tier model cap: a backstop against unbounded PVC growth when a
# catalog churns through models it never reuses (the PVC also holds
# checkpoints, KV spill files and compile caches).  Oldest dirs are
# dropped past it — at init-rescan time too.
DEFAULT_MAX_SPILL_MODELS = 16


def iter_param_leaves(params, prefix: str = ""):
    """``(dotted_path, leaf)`` of a parameter tree, depth first (list
    indices are path components: ``layers.0.wq``)."""
    if isinstance(params, dict):
        for k in params:
            yield from iter_param_leaves(params[k], f"{prefix}{k}.")
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from iter_param_leaves(v, f"{prefix}{i}.")
    elif params is not None:
        yield prefix[:-1], params


def tree_host_nbytes(params) -> int:
    """Bytes of a parameter tree's leaves."""
    return sum(int(a.numel() * a.element_size()) for _, a in iter_param_leaves(params))


def stream_params_to_dir(params, out_dir: str) -> int:
    """Write a tree leaf by leaf into ``out_dir``: one ``.npy`` a leaf and
    a ``manifest.json`` written last (a directory without one is
    incomplete).  A dtype numpy lacks (bfloat16) is written as its
    integer bits and tagged.  Returns the leaf bytes written."""
    os.makedirs(out_dir, exist_ok=True)
    leaves = []
    total = 0
    for idx, (path, leaf) in enumerate(iter_param_leaves(params)):
        t = leaf.detach().cpu()
        ent = {"path": path, "file": f"{idx:05d}.npy", "shape": list(t.shape)}
        if t.dtype in _BITS:
            bits, ent["dtype"] = _BITS[t.dtype]
            t = t.view(bits)
        a = t.contiguous().numpy()
        fpath = os.path.join(out_dir, ent["file"])
        tmp = f"{fpath}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.save(f, a)
        os.replace(tmp, fpath)
        total += int(a.nbytes)
        leaves.append(ent)
        del a, t
    mpath = os.path.join(out_dir, _STREAM_MANIFEST)
    tmp = f"{mpath}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "total_bytes": total, "leaves": leaves}, f)
    os.replace(tmp, mpath)
    return total


def stream_dir_nbytes(in_dir: str) -> int | None:
    """Leaf bytes of a written directory's manifest; None without one."""
    try:
        with open(os.path.join(in_dir, _STREAM_MANIFEST)) as f:
            return int(json.load(f)["total_bytes"])
    except (OSError, ValueError, KeyError):
        return None


def load_params_from_dir(in_dir: str):
    """The tree :func:`stream_params_to_dir` wrote, as CPU tensors
    (``FileNotFoundError`` without a manifest)."""
    with open(os.path.join(in_dir, _STREAM_MANIFEST)) as f:
        manifest = json.load(f)
    root: dict = {}
    for ent in manifest["leaves"]:
        t = torch.from_numpy(np.load(os.path.join(in_dir, ent["file"])))
        tag = ent.get("dtype")
        if tag:
            t = t.view(_FROM_TAG[tag][0])
        t = t.reshape(ent["shape"])
        parts = ent["path"].split(".")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = t

    def _listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [_listify(node[str(i)]) for i in range(len(node))]
        return {k: _listify(v) for k, v in node.items()}

    return _listify(root)


def _safe_name(name: str) -> str:
    """Filesystem-safe token for a model name (slashes in HF ids)."""
    return re.sub(r"[^A-Za-z0-9._-]", "_", name)


class WeightTiers:
    """Model-name-keyed weight trees in pinned host memory with a spill
    directory behind it.

    Values are trees of CPU tensors (``put`` copies the card's leaves to
    the host one at a time); ``take`` hands the host tree back and the
    caller moves it to the card leaf by leaf.
    """

    def __init__(self, host_bytes: int, spill_dir: str | None = None,
                 max_spill_models: int = DEFAULT_MAX_SPILL_MODELS):
        self.host_budget_bytes = int(host_bytes)
        self.spill_dir = spill_dir
        self.max_spill_models = max_spill_models
        # name -> (host tree, nbytes); LRU order, oldest first
        self._host: OrderedDict[str, tuple] = OrderedDict()
        # spill tier, split by write progress:
        #   _spill_pending: name -> host tree, queued for the writer
        #   _spill:         name -> (dir path, nbytes), durably on disk
        self._spill_pending: OrderedDict[str, object] = OrderedDict()
        self._spill: OrderedDict[str, tuple] = OrderedDict()
        self._lock = threading.Lock()
        self._writeq: "queue.Queue[str | None]" = queue.Queue()
        self._writer: threading.Thread | None = None
        # name -> in-flight spill->host prefetch thread
        self._prefetches: dict[str, threading.Thread] = {}
        self.host_bytes_used = 0
        # cumulative flow counters (the pool mirrors these into
        # EngineStats so server/runner.py can export them)
        self.spilled_models = 0     # host -> PVC demotions (at enqueue)
        self.dropped_models = 0     # fell off the last tier (weights lost)
        self.prefetched_models = 0  # spill -> host promotions completed
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            self._rescan_spill_dir()

    # ---- introspection --------------------------------------------------

    def has(self, name: str) -> bool:
        return self.where(name) is not None

    def where(self, name: str) -> str | None:
        with self._lock:
            if name in self._host:
                return "host"
            if name in self._spill or name in self._spill_pending:
                return "spill"
        return None

    def names(self) -> dict[str, str]:
        """name -> tier for everything resolvable (host wins)."""
        with self._lock:
            out = {n: "spill" for n in list(self._spill)
                   + list(self._spill_pending)}
            out.update({n: "host" for n in self._host})
        return out

    def bytes_by_tier(self) -> dict[str, int]:
        with self._lock:
            spill = sum(nb for _, nb in self._spill.values())
            spill += sum(tree_host_nbytes(t)
                         for t in self._spill_pending.values())
            return {"host": self.host_bytes_used, "spill": spill}

    # ---- spill writer ---------------------------------------------------

    def _spill_path(self, name: str) -> str:
        return os.path.join(self.spill_dir, f"wt_{_safe_name(name)}")

    def _rescan_spill_dir(self) -> None:
        """Adopt pre-existing spilled models (pod restart / crashed
        sibling), oldest-first so cap trimming drops the stalest.  A dir
        without a complete manifest is a half-written corpse — removed."""
        try:
            ents = []
            for entry in os.listdir(self.spill_dir):
                if not entry.startswith("wt_"):
                    continue
                path = os.path.join(self.spill_dir, entry)
                if not os.path.isdir(path):
                    continue
                nbytes = stream_dir_nbytes(path)
                meta = self._read_meta(path)
                if nbytes is None or meta is None:
                    self._drop_spill_tree(path)
                    continue
                try:
                    ents.append((os.path.getmtime(path), meta, path, nbytes))
                except OSError:
                    continue
            ents.sort(key=lambda e: e[0])
            for _, _, path, _ in ents[:-self.max_spill_models or None]:
                self._drop_spill_tree(path)
            for _, meta, path, nbytes in ents[-self.max_spill_models:]:
                self._spill[meta] = (path, nbytes)
            if self._spill:
                logger.info("adopted %d spilled model(s) from %s: %s",
                            len(self._spill), self.spill_dir,
                            sorted(self._spill))
        except OSError:
            pass

    @staticmethod
    def _read_meta(path: str) -> str | None:
        """The original (un-sanitised) model name, stored beside the
        streamed leaves so rescans key entries correctly."""
        try:
            with open(os.path.join(path, "model.json")) as f:
                return json.load(f)["model"]
        except (OSError, ValueError, KeyError):
            return None

    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(target=self._writer_loop,
                                            daemon=True,
                                            name="tpuserve-torch-weight-spill")
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            name = self._writeq.get()
            try:
                if name is None:
                    return
                with self._lock:
                    tree = self._spill_pending.get(name)
                if tree is None:
                    continue            # taken/dropped before the write
                ok, nbytes = self._write_spill_tree(name, tree)
                victims: list[str] = []
                with self._lock:
                    if self._spill_pending.pop(name, None) is None:
                        # taken/dropped DURING the write: orphaned dir
                        if ok:
                            victims.append(self._spill_path(name))
                    elif ok:
                        self._spill[name] = (self._spill_path(name), nbytes)
                        while len(self._spill) > self.max_spill_models:
                            _, (p, _) = self._spill.popitem(last=False)
                            victims.append(p)
                            self.dropped_models += 1
                    else:
                        self.dropped_models += 1
                for p in victims:
                    self._drop_spill_tree(p)
            finally:
                self._writeq.task_done()

    def _write_spill_tree(self, name: str, tree) -> tuple[bool, int]:
        path = self._spill_path(name)
        try:
            nbytes = stream_params_to_dir(tree, path)
            with open(os.path.join(path, "model.json"), "w") as f:
                json.dump({"model": name}, f)
            return True, nbytes
        except OSError as e:
            logger.warning("weight spill write failed for %s (%s); "
                           "dropping", name, e)
            self._drop_spill_tree(path)
            return False, 0

    def _spill_one(self, name: str, tree) -> bool:
        """Move one model's tree to the spill tier — resolvable from the
        pending map immediately; the streamed file writes happen on the
        writer thread so a swap never blocks on PVC latency."""
        if not self.spill_dir:
            return False
        with self._lock:
            self._spill_pending[name] = tree
        self.spilled_models += 1
        self._ensure_writer()
        self._writeq.put(name)
        return True

    @staticmethod
    def _drop_spill_tree(path: str) -> None:
        shutil.rmtree(path, ignore_errors=True)

    def flush(self) -> None:
        """Block until queued spill writes have landed (tests/shutdown)."""
        self._writeq.join()
        for t in list(self._prefetches.values()):
            t.join()

    # ---- demote ---------------------------------------------------------

    def put(self, name: str, params) -> str:
        """Demote one model's weights off the card, a leaf at a time.
        Host pressure cascades the least recently used host entry to the
        spill tier (or drops it without a spill directory); a model
        larger than the whole host budget goes straight to spill, in
        pageable memory.  Returns the tier it landed in ("host"/"spill")
        or "dropped"."""
        if self.has(name):
            self.drop(name)             # the caller's tree is the fresher one
        nbytes = tree_host_nbytes(params)
        if nbytes > self.host_budget_bytes:
            if self._spill_one(name, self._hostify(params, pinned=False)):
                return "spill"
            self.dropped_models += 1
            return "dropped"
        tree = self._hostify(params, pinned=True)
        with self._lock:
            self._host[name] = (tree, nbytes)
            self.host_bytes_used += nbytes
            evict = []
            while (self.host_bytes_used > self.host_budget_bytes
                   and self._host):
                old, (old_tree, old_n) = self._host.popitem(last=False)
                self.host_bytes_used -= old_n
                evict.append((old, old_tree))
        for old, old_tree in evict:
            if not self._spill_one(old, old_tree):
                self.dropped_models += 1
        return "host"

    @staticmethod
    def _hostify(params, pinned: bool):
        """The tree on the host, one leaf at a time (pinned memory for the
        host tier, pageable for a tree bound for the spill files)."""
        def leaf(a):
            if a.device.type == "cpu" and (a.is_pinned() or not pinned):
                return a
            out = torch.empty(a.shape, dtype=a.dtype, device="cpu",
                              pin_memory=pinned and torch.cuda.is_available())
            return out.copy_(a)
        return map_leaves(leaf, params)

    # ---- restore --------------------------------------------------------

    def prefetch(self, name: str) -> bool:
        """Begin promoting ``name`` from spill to host on a background
        thread (restore-ahead-of-admission: runs while the engine drains
        toward its swap window).  No-op unless the entry is spill-only,
        and for a model larger than the whole host budget, which the host
        tier could never keep (its swap reads the spill files).  Returns
        True when a prefetch is running (or already resolved to host)."""
        with self._lock:
            if name in self._host:
                return True
            if name in self._spill_pending:
                return True             # still in memory; take() is cheap
            if name not in self._spill or self._spill[name][1] > self.host_budget_bytes:
                return False
            t = self._prefetches.get(name)
            if t is not None and t.is_alive():
                return True
            t = threading.Thread(target=self._prefetch_one, args=(name,),
                                 daemon=True,
                                 name=f"tpuserve-torch-weight-prefetch-{_safe_name(name)}")
            self._prefetches[name] = t
        t.start()
        return True

    def _prefetch_one(self, name: str) -> None:
        with self._lock:
            ent = self._spill.get(name)
        if ent is None:
            return
        path, _ = ent
        try:
            tree = load_params_from_dir(path)
        except (OSError, ValueError, KeyError) as e:
            logger.warning("weight prefetch failed for %s (%s)", name, e)
            return
        nbytes = tree_host_nbytes(tree)
        with self._lock:
            if self._spill.pop(name, None) is None:
                return                  # taken/dropped while reading
            self._host[name] = (tree, nbytes)
            self.host_bytes_used += nbytes
            self.prefetched_models += 1
            evict = []
            while (self.host_bytes_used > self.host_budget_bytes
                   and len(self._host) > 1):
                old, (old_tree, old_n) = self._host.popitem(last=False)
                if old == name:         # never evict what we just fetched
                    self._host[old] = (old_tree, old_n)
                    self._host.move_to_end(old, last=False)
                    break
                self.host_bytes_used -= old_n
                evict.append((old, old_tree))
        self._drop_spill_tree(path)
        for old, old_tree in evict:
            if not self._spill_one(old, old_tree):
                self.dropped_models += 1

    def take(self, name: str) -> tuple | None:
        """Remove and return ``(host tree, source tier)`` for ``name``
        (the weights are about to become HBM-resident again and a model
        lives in exactly one tier).  Joins an in-flight prefetch first so
        overlap work is never duplicated.  None when unresolvable or the
        spill dir is unreadable (the caller falls back to a cold load)."""
        t = self._prefetches.pop(name, None)
        if t is not None and t.is_alive():
            t.join()
        with self._lock:
            ent = self._host.pop(name, None)
            if ent is not None:
                self.host_bytes_used -= ent[1]
                return ent[0], "host"
            pending = self._spill_pending.pop(name, None)
            if pending is not None:
                return pending, "host"  # never hit the PVC: host-speed
            ent = self._spill.pop(name, None)
        if ent is None:
            return None
        path, _ = ent
        try:
            tree = load_params_from_dir(path)
        except (OSError, ValueError, KeyError) as e:
            logger.warning("weight spill read failed for %s (%s); "
                           "treating as a miss", name, e)
            self._drop_spill_tree(path)
            self.dropped_models += 1    # the weights are LOST — cold load
            return None
        self._drop_spill_tree(path)
        return tree, "spill"

    def drop(self, name: str) -> None:
        t = self._prefetches.pop(name, None)
        if t is not None and t.is_alive():
            t.join()
        with self._lock:
            ent = self._host.pop(name, None)
            if ent is not None:
                self.host_bytes_used -= ent[1]
                return
            if self._spill_pending.pop(name, None) is not None:
                return                  # writer cleans any half-born dir
            ent = self._spill.pop(name, None)
        if ent is not None:
            self._drop_spill_tree(ent[0])

    def clear(self) -> None:
        with self._lock:
            self._spill_pending.clear()
            paths = [p for p, _ in self._spill.values()]
            self._spill.clear()
            self._host.clear()
            self.host_bytes_used = 0
        for path in paths:
            self._drop_spill_tree(path)
