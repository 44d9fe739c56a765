"""Lockstep ranks: the port of ``tpuserve/parallel/multihost.py``.

Every rank of a tensor / expert parallel grid (``parallel/mesh.py``) must
run the same step with the same shapes, or its collectives deadlock.  Only
rank 0 (the coordinator) runs the server, the scheduler, the block manager
and the sampler's host state; it sends a step descriptor to the follower
ranks before it runs each step, and every rank then runs the same step on
its own slice of the weights and cache, its collectives included.

The JAX header carries one op a step kind (prefill, decode, chunk, sample,
decode window) with fixed-shape arrays.  The port's descriptor is generic:
every device step of the port is an ``Executable`` of ``runtime/graphs.py``
with static input buffers, so the descriptor is the executable's key and
the one packed int32 tensor of its inputs (the staging a dispatch copies
into the buffers), plus a decode step's penalties arrays.  The followers
copy that into their own executable's buffers and replay its graph (NCCL)
or run it eagerly (gloo).  Ops:

- ``OP_MAKE`` key: make (on the card: capture) the executable, which on a
  captured rank runs once on padding rows first, collectives included;
- ``OP_WARMUP`` keys: ``StepGraphs.warmup`` of the keys, in its one order;
- ``OP_RUN`` key, steps, staging[, extras]: load and run ``steps`` steps
  (0: one eager step whose logits the coordinator reads);
- ``OP_NOOP``: the coordinator's heartbeat after a quarter of the mesh's
  collective timeout idle, so a follower's wait stays inside it;
- ``OP_STOP``: the followers return.

A guided window's grammar tables ride the ``OP_RUN`` that first reads
them (``grammar``: the bucket and the masks, token classes and
transitions), so a grammar crosses the group once, when rank 0's
``StepGraphs.load_grammar`` actually loads it; the followers load them
untagged before the replay.  The host-side FSM mirror, the character
acceptors and the synchronous sampler stay on rank 0.  The KV tiers'
page copies and the cache-less trunks have ops of their own, each sent
where rank 0 does that work:

- ``OP_DEMOTE`` blocks, hashes: each rank gathers its own slice of those
  pages into its own ``TieredPageStore`` (``runtime/kv_tiers.py``; spill
  files in a subdirectory a rank), before the next step overwrites them;
- ``OP_RESTORE`` hashes: each rank takes its pages of the span out of its
  store, and every rank then agrees on the shortest intact prefix (a MIN
  over the group, sent and reduced under one lock, so no heartbeat falls
  between); past it each rank drops the span's hashes, and rank 0 aborts
  those blocks;
- ``OP_SCATTER`` blocks: each rank writes the agreed pages in place;
- ``OP_DROP`` hashes: superseded store entries leave every rank's store;
- ``OP_TRUNK`` kind, tokens, lengths: a batch of the cache-less trunk
  (embeddings or prompt scoring), run on every rank's slice with its tp
  sums; only rank 0 reads the result.

Rank 0's block manager makes every tier decision; the stores only follow,
so every rank holds the same hashes in the same tier (budgets in blocks).
A KV migration (disaggregation, ``parallel/disagg.py`` and
``disagg_net.py``) moves one card's whole pages on rank 0 and each rank's
heads of them (``sharding.cut_pages`` / ``join_pages``) on the others:

- ``OP_ADOPT`` blocks: rank 0 cuts the whole pages it was given (from the
  wire) to each rank's heads and scatters the slices over the control
  group, under one lock with the descriptor; each rank writes its slice in
  place into the blocks rank 0's block manager allocated.  Rank 0 checked
  the migration first (format, shapes, room, id): a refused one sends
  nothing, and a follower that fails anyway is fatal (``watch_ranks``);
- ``OP_EXTRACT`` blocks: each rank gathers its slice of those pages to the
  host, rank 0 gathers them over the control group (sent and gathered
  under one lock, so no heartbeat falls between) and joins them;
- ``OP_HANDOFF`` src, src blocks, dst blocks: the in-process pair's
  migration, each rank copying its slice from its prefill engine's cache
  into its decode engine's on its own card, nothing crossing ranks.

Every descriptor but the heartbeat and the stop names its engine
(``meta["eng"]``) where two share a rank (the pair: "prefill", "decode");
a single engine's carry no tag.  The engines of rank 0 share one channel
(one lock, one sequence number, one heartbeat), and ``follower_loop``
runs each descriptor on the engine of its tag.

Pipeline stages (``parallel/pipeline.py``) follow the same way: each
runs the executable on its own layers and passes the activations on, and
only rank 0, which holds the head, samples; a later stage's windows carry
no tokens (its ``out`` stays zeros).

Descriptors ride a gloo group over every rank (``RankMesh.ctrl_group``), on
the host, whatever the collectives' backend.  Sampling needs no op: the
logits are gathered to every rank inside the step, so the coordinator
samples alone, and a decode window samples inside the step on every rank
with the same keyed noise (``ops/sampling.py`` ``keyed_gumbel``), so every
rank holds the same tokens (``Lockstep.record`` / ``follower_loop(record=
True)`` keep them for the tests to compare).  The engine routes every
executable, page copy and trunk through its ``_exec_*`` hooks, which call
this module (``tests/test_torch_multihost.py`` holds that by AST).

Pipelined decode is off under a mesh, as under the JAX lockstep (a
descriptor is built from the host's tokens).  Multi-LoRA and
``swap_model`` are refused as the JAX engine refuses them.  Under several
nodes (``--multihost``) the JAX engine's multi-process refusals stay: the
intake refusal of ``SamplingParams.multihost_unsupported``, embeddings and
scoring, the tiers off, and no disaggregation (its coordinator cannot
mirror a pair across processes; the server refuses ``--disagg`` and
``--role`` there).

:func:`spawn_ranks` starts follower processes on one node (the server's
``--tp N`` and ``chip_smoke.py``'s phase ``tp``): one a card, logs to files
(a pipe nobody drains can block a rank), a ``file://`` store, and every
rank stopped when one fails.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import subprocess
import sys
import threading
import time
import types
from typing import Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger("tpuserve_torch.multihost")

OP_STOP, OP_MAKE, OP_RUN, OP_WARMUP, OP_NOOP = 0, 1, 2, 3, 4
OP_DEMOTE, OP_RESTORE, OP_SCATTER, OP_DROP, OP_TRUNK = 5, 6, 7, 8, 9
OP_ADOPT, OP_EXTRACT, OP_HANDOFF = 10, 11, 12
OP_NAMES = {OP_STOP: "stop", OP_MAKE: "make", OP_RUN: "run", OP_WARMUP: "warmup",
            OP_NOOP: "noop", OP_DEMOTE: "demote", OP_RESTORE: "restore",
            OP_SCATTER: "scatter", OP_DROP: "drop", OP_TRUNK: "trunk",
            OP_ADOPT: "adopt", OP_EXTRACT: "extract", OP_HANDOFF: "handoff"}
HEADER = 4                       # int64: op, body words, steps, sequence number


def _encode(meta: dict, arrays: Sequence[np.ndarray]) -> tuple[dict, torch.Tensor]:
    """One int32 body: the JSON of ``meta`` (with each array's dtype and
    shape), padded to a word, then each array's bytes, padded to a word."""
    meta = dict(meta, arrays=[[a.dtype.str, list(a.shape)] for a in arrays])
    text = json.dumps(meta).encode()
    parts = [np.asarray([len(text)], np.int32),
             np.frombuffer(text + b"\0" * (-len(text) % 4), np.int32)]
    for a in arrays:
        raw = np.ascontiguousarray(a).view(np.uint8).ravel()
        parts.append(np.frombuffer(raw.tobytes() + b"\0" * (-raw.size % 4), np.int32))
    return meta, torch.from_numpy(np.concatenate(parts))


def _decode(body: np.ndarray) -> tuple[dict, list]:
    n = int(body[0])
    words = 1 + (n + 3) // 4
    meta = json.loads(body[1:words].view(np.uint8)[:n].tobytes())
    raw = body[words:].view(np.uint8)
    arrays, off = [], 0
    for dtype, shape in meta["arrays"]:
        dt = np.dtype(dtype)
        size = int(np.prod(shape)) * dt.itemsize
        arrays.append(raw[off:off + size].view(dt).reshape(shape).copy())
        off += size + (-size % 4)
    return meta, arrays


class _Channel:
    """What every engine of rank 0 on one mesh shares (an in-process
    pair's two engines): the control group, the lock each descriptor is
    sent under (with the collective that follows it, where one does), one
    sequence number, one heartbeat, the descriptors sent by op name
    (``sent``) and what ``record`` kept (``tokens``)."""

    def __init__(self, mesh):
        self.group = mesh.ctrl_group
        # a quarter of the collectives' timeout: a follower's wait for the
        # next descriptor never reaches it
        self.heartbeat_s = mesh.timeout_s / 4
        self.record = False
        self.tokens: list = []
        self.sent = collections.Counter()
        self.lock = threading.Lock()
        self.stopped = False
        self._seq = 0
        self._last = time.monotonic()
        self._hb_stop = threading.Event()
        self._hb = threading.Thread(target=self._heartbeat, name="lockstep-heartbeat",
                                    daemon=True)
        self._hb.start()

    def send(self, op: int, meta: Optional[dict] = None, arrays=(), steps: int = 0) -> None:
        with self.lock:
            self.send_locked(op, meta, arrays, steps)

    def send_locked(self, op: int, meta: Optional[dict], arrays, steps: int) -> None:
        import torch.distributed as dist
        body = _encode(meta, arrays)[1] if meta is not None else None
        if self.stopped:
            raise RuntimeError("the lockstep has stopped: its followers are gone")
        hdr = torch.tensor([op, 0 if body is None else body.numel(), steps, self._seq],
                           dtype=torch.int64)
        self._seq += 1
        dist.broadcast(hdr, 0, group=self.group)
        if body is not None:
            dist.broadcast(body, 0, group=self.group)
        self._last = time.monotonic()
        self.sent[OP_NAMES[op]] += 1

    def _heartbeat(self) -> None:
        while not self._hb_stop.wait(self.heartbeat_s / 4):
            if time.monotonic() - self._last < self.heartbeat_s:
                continue
            try:
                self.send(OP_NOOP)
            except Exception:       # a follower is gone: the next step raises
                logger.exception("lockstep heartbeat failed")
                return

    def stop(self) -> None:
        self._hb_stop.set()
        if self.stopped:
            return
        try:
            self.send(OP_STOP)
        finally:
            self.stopped = True


def _channel_of(mesh) -> _Channel:
    """Rank 0's channel on ``mesh``: the one its engines share until the
    stop, then a new one for the engines built after it."""
    if mesh.lockstep is None or mesh.lockstep.stopped:
        mesh.lockstep = _Channel(mesh)
    return mesh.lockstep


@contextlib.contextmanager
def making(mesh):
    """Rank 0 makes several engines on ``mesh`` (an in-process pair) under
    this: the channel the first one opens sends no heartbeat until the last
    is made, since making an engine runs collectives on the control group
    (the spill entries' agreement) that a heartbeat would fall between.  A
    no-op elsewhere."""
    if mesh is None or mesh.world == 1 or not mesh.is_coordinator:
        yield
        return
    ch = _channel_of(mesh)
    with ch.lock:
        yield
        ch._last = time.monotonic()


class Lockstep:
    """The coordinator's side for one engine: sends each step's descriptor
    to the follower ranks (the engine's ``_exec_*`` hooks call it), tagged
    ``tag`` (``meta["eng"]``) where several engines share the rank (None: a
    single engine, whose descriptors carry no tag), over the mesh's one
    channel (:class:`_Channel`: one lock, sequence and heartbeat for every
    engine of the rank), and the stop.  ``record``: keep each decode run's
    (B, steps) tokens and each verify's and draft's outputs (``tokens``),
    for comparison with the followers'."""

    def __init__(self, mesh, tag: Optional[str] = None):
        self.mesh = mesh
        self.tag = tag
        self.group = mesh.ctrl_group
        self.channel = _channel_of(mesh)

    @property
    def heartbeat_s(self) -> float:
        return self.channel.heartbeat_s

    @property
    def sent(self) -> collections.Counter:
        """Descriptors by op name, over every engine of the channel."""
        return self.channel.sent

    @property
    def tokens(self) -> list:
        return self.channel.tokens

    @property
    def record(self) -> bool:
        return self.channel.record

    @record.setter
    def record(self, on: bool) -> None:
        self.channel.record = on

    def _meta(self, meta: dict) -> dict:
        return meta if self.tag is None else dict(meta, eng=self.tag)

    def _send(self, op: int, meta: dict, arrays=(), steps: int = 0) -> None:
        self.channel.send(op, self._meta(meta), arrays, steps)

    def make(self, key: tuple) -> None:
        self._send(OP_MAKE, {"key": list(key)})

    def warmup(self, keys) -> None:
        self._send(OP_WARMUP, {"keys": [list(k) for k in keys]})

    def run(self, key: tuple, staging, steps: int, extras=None, grammar=None) -> None:
        """``staging``: the dispatch's ``graphs.Staging``; ``extras``: a
        decode step's ``load_extras`` arrays; ``grammar``: (bucket, masks,
        tok_class, class_next) when rank 0 loads a grammar's tables for
        this run (tok_class and class_next None for per-row tables);
        ``steps`` 0: one eager step."""
        arrays = [staging.tensor.numpy()] + [np.asarray(a) for a in extras or ()]
        meta = {"key": list(key), "extras": len(extras or ())}
        if grammar is not None:
            bucket, *tables = grammar
            meta["grammar"] = [list(bucket), [t is not None for t in tables]]
            arrays += [t.cpu().numpy() for t in tables if t is not None]
            # a window's grammar, or a single step's per-row masks
            self.sent["grammar" if tables[1] is not None else "grammar_rows"] += 1
        self._send(OP_RUN, meta, arrays, steps)

    def demote(self, blocks: list, hashes: list) -> None:
        self._send(OP_DEMOTE, {"blocks": list(blocks), "hashes": list(hashes)})

    def restore(self, hashes: list, intact: int) -> int:
        """Send the span and agree on it: the least ``intact`` over every
        rank (each rank's count of the span's pages it took whole), sent
        and reduced under the lock so that no heartbeat falls between."""
        with self.channel.lock:
            self.channel.send_locked(OP_RESTORE, self._meta({"hashes": list(hashes)}), (), 0)
            return agree_min(self.group, intact)

    def scatter(self, blocks: list) -> None:
        self._send(OP_SCATTER, {"blocks": list(blocks)})

    def drop(self, hashes: list) -> None:
        self._send(OP_DROP, {"hashes": list(hashes)})

    def trunk(self, kind: str, tokens: np.ndarray, lens: np.ndarray, **meta) -> None:
        """One batch of the cache-less trunk (``kind`` "embed" or
        "score"; ``meta``: its pooling or top_n)."""
        self._send(OP_TRUNK, dict(meta, kind=kind), [np.asarray(tokens), np.asarray(lens)])

    def adopt(self, blocks: list, seq_kv: list, cache: list, parts: int) -> list:
        """A migration's whole host pages into ``blocks`` on every rank:
        each rank's head slice (``sharding.cut_pages`` of ``parts``: rank r
        takes slice r mod tp, the whole where the cache is replicated),
        packed in its cache's dtypes, scattered over the control group
        under the lock with the descriptor.  Returns rank 0's slice."""
        import torch.distributed as dist
        from tpuserve_torch.parallel.sharding import cut_pages
        slices = [cut_pages(seq_kv, parts, i) for i in range(parts)]
        packed = [pack_pages(s, cache) for s in slices]
        mine = torch.empty_like(packed[0])
        with self.channel.lock:
            self.channel.send_locked(OP_ADOPT, self._meta(
                {"blocks": list(blocks), "n": int(seq_kv[0]["k"].shape[0])}), (), 0)
            dist.scatter(mine, [packed[r % parts] for r in range(self.mesh.world)], src=0,
                         group=self.group)
        return slices[0]

    def extract(self, blocks: list, mine: torch.Tensor) -> list:
        """Every rank's packed slice of ``blocks``' pages (``pack_pages``;
        ``mine`` rank 0's), gathered over the control group under the lock
        with the descriptor, by rank."""
        import torch.distributed as dist
        bufs = [torch.empty_like(mine) for _ in range(self.mesh.world)]
        with self.channel.lock:
            self.channel.send_locked(OP_EXTRACT, self._meta({"blocks": list(blocks)}), (), 0)
            dist.gather(mine, bufs, dst=0, group=self.group)
        return bufs

    def handoff(self, src_tag: Optional[str], src_blocks: list, dst_blocks: list) -> None:
        """An in-process pair's migration: every rank copies its slice of
        ``src_blocks`` from engine ``src_tag``'s cache into this engine's
        ``dst_blocks``."""
        self._send(OP_HANDOFF, {"src": src_tag, "src_blocks": list(src_blocks),
                                "dst_blocks": list(dst_blocks)})

    def after_run(self, exe, steps: int) -> None:
        if self.record:
            rec = _record_of(exe, steps)
            if rec is not None:
                self.tokens.append(rec)

    def stop(self) -> None:
        """Send the stop (once); the followers return from their loop."""
        self.channel.stop()


def pack_pages(seq_kv: list, cache: list) -> torch.Tensor:
    """Per-layer pages as one flat uint8 host tensor, each array in
    ``cache``'s key order and dtype (a bf16 page as its bytes)."""
    parts = [torch.as_tensor(moved[key]).to(device="cpu", dtype=dst.dtype)
             .contiguous().flatten().view(torch.uint8)
             for layer, moved in zip(cache, seq_kv) for key, dst in layer.items()]
    return torch.cat(parts)


def pack_size(cache: list, n: int) -> int:
    """Bytes :func:`pack_pages` makes of ``n`` blocks of ``cache``."""
    return n * sum(dst[0].numel() * dst.element_size()
                   for layer in cache for dst in layer.values())


def unpack_pages(buf: torch.Tensor, cache: list, n: int) -> list:
    """The inverse of :func:`pack_pages`: ``n`` blocks' pages in the shapes
    and dtypes of ``cache``'s (views into ``buf``)."""
    out, off = [], 0
    for layer in cache:
        pages = {}
        for key, dst in layer.items():
            shape = (n, *dst.shape[1:])
            size = int(np.prod(shape)) * dst.element_size()
            pages[key] = buf[off:off + size].view(dst.dtype).view(shape)
            off += size
        out.append(pages)
    return out


def _record_of(exe, steps: int):
    """What a run leaves for ``record``: a decode run's (B, steps) tokens, a
    verify pass's predictions or a draft's proposals; None for the rest."""
    if exe.key[0] == "decode":
        return exe.state.out[:, :steps].cpu().numpy()
    if exe.key[0] in ("verify", "draft"):
        return exe.out[0].cpu().numpy()
    return None


def agree_min(group, value: int) -> int:
    """The least ``value`` over every rank of ``group`` (the tier restore's
    agreed span)."""
    import torch.distributed as dist
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return int(t)


def follower_loop(engine, record: bool = False) -> list:
    """Run on ranks 1..N-1: mirror the coordinator's steps until the stop.

    ``engine`` must be built as the coordinator's (the same config, model,
    seed and mesh), so its weights, cache and executables match slice for
    slice; it never schedules.  A topology of several engines on the rank
    (an in-process pair, ``parallel/disagg.py``) gives them by tag in its
    ``lockstep_engines``; each descriptor runs on the engine of its tag.
    Returns what each run left for ``record`` (``_record_of``; else [])."""
    import torch.distributed as dist
    engines = getattr(engine, "lockstep_engines", None) or {None: engine}
    mesh = next(iter(engines.values())).mesh
    if mesh is None or mesh.world == 1:
        logger.info("follower_loop: one rank, nothing to follow")
        return []
    tokens = []
    restored: dict = {}          # the pages OP_RESTORE took, by tag, until OP_SCATTER
    logger.info("follower %d/%d entering the lockstep loop", mesh.rank, mesh.world)
    while True:
        hdr = torch.zeros(HEADER, dtype=torch.int64)
        dist.broadcast(hdr, 0, group=mesh.ctrl_group)
        op, n, steps, _seq = (int(x) for x in hdr)
        meta, arrays = {}, []
        if n:
            body = torch.empty(n, dtype=torch.int32)
            dist.broadcast(body, 0, group=mesh.ctrl_group)
            meta, arrays = _decode(body.numpy())
        if op == OP_STOP:
            logger.info("follower %d: stop", mesh.rank)
            return tokens
        if op == OP_NOOP:
            continue
        tag = meta.get("eng")
        eng = engines[tag]
        graphs = eng.graphs
        if op == OP_MAKE:
            graphs.get(*meta["key"])
        elif op == OP_WARMUP:
            graphs.warmup([tuple(k) for k in meta["keys"]])
        elif op == OP_RUN:
            exe = graphs.get(*meta["key"])
            exe.load(types.SimpleNamespace(tensor=torch.from_numpy(arrays[0])))
            n_extras = meta["extras"]
            if n_extras:
                exe.load_extras(*arrays[1:1 + n_extras])
            if "grammar" in meta:
                bucket, present = meta["grammar"]
                tables = iter(arrays[1 + n_extras:])
                graphs.load_grammar(tuple(bucket), None, *(
                    torch.from_numpy(next(tables)).to(eng.device) if p else None
                    for p in present))
            if steps == 0:
                exe.step()
            else:
                exe.run(steps)
                rec = _record_of(exe, steps) if record else None
                if rec is not None:
                    tokens.append(rec)
        elif op == OP_DEMOTE:
            eng._exec_demote(meta["blocks"], meta["hashes"])
        elif op == OP_RESTORE:
            restored[tag] = eng._exec_restore(meta["hashes"])
        elif op == OP_SCATTER:
            eng._exec_scatter(meta["blocks"], restored.pop(tag, [])[:len(meta["blocks"])])
        elif op == OP_DROP:
            eng._exec_drop(meta["hashes"])
        elif op == OP_TRUNK:
            if meta["kind"] == "embed":
                eng._exec_embed(arrays[0], arrays[1], meta["pooling"])
            else:
                eng._exec_score(arrays[0], arrays[1], meta["top_n"])
        elif op == OP_ADOPT:
            buf = torch.empty(pack_size(eng.kv_cache, meta["n"]), dtype=torch.uint8)
            dist.scatter(buf, None, src=0, group=mesh.ctrl_group)
            eng._exec_adopt(meta["blocks"], unpack_pages(buf, eng.kv_cache, meta["n"]))
        elif op == OP_EXTRACT:
            mine = pack_pages(eng._exec_extract(meta["blocks"]), eng.kv_cache)
            dist.gather(mine, None, dst=0, group=mesh.ctrl_group)
        elif op == OP_HANDOFF:
            eng._exec_handoff(engines[meta["src"]], meta["src_blocks"], meta["dst_blocks"])
        else:
            raise RuntimeError(f"follower {mesh.rank}: unknown lockstep op {op}")


# --------------------------------------------------------------------------
# Launching ranks on one node
# --------------------------------------------------------------------------

def rank_env(rank: int, world: int, init_method: str, extra: Optional[dict] = None) -> dict:
    """The environment of rank ``rank`` of a one-node grid: torchrun's
    variables, the store (``TPUSERVE_INIT_METHOD``), and loopback
    interfaces for gloo and NCCL, whose defaults may find no route on a
    machine without a network."""
    env = dict(os.environ)
    env.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                "LOCAL_WORLD_SIZE": str(world), "TPUSERVE_INIT_METHOD": init_method})
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.update(extra or {})
    return env


def spawn_ranks(cmd: Sequence[str], world: int, log_dir: str, init_method: str,
                ranks: Optional[Sequence[int]] = None,
                extra_env: Optional[dict] = None) -> dict:
    """Start ``cmd`` (argv, ``sys.executable`` first when None is given as
    its head) once for each of ``ranks`` (default 1..world-1: the caller is
    rank 0), each with :func:`rank_env` and its output in
    ``log_dir/rank<r>.log``.  Returns rank -> ``Popen``."""
    os.makedirs(log_dir, exist_ok=True)
    cmd = [sys.executable if c is None else c for c in cmd]
    procs = {}
    for r in (range(1, world) if ranks is None else ranks):
        log = open(os.path.join(log_dir, f"rank{r}.log"), "w")
        try:
            procs[r] = subprocess.Popen(cmd, env=rank_env(r, world, init_method, extra_env),
                                        stdout=log, stderr=subprocess.STDOUT,
                                        stdin=subprocess.DEVNULL)
        finally:
            log.close()          # the child holds its own descriptor
    return procs


def watch_ranks(procs: dict, on_failure, interval_s: float = 0.5) -> threading.Event:
    """A thread that calls ``on_failure(rank, returncode)`` once when any
    process of ``procs`` exits non-zero before the returned event is set
    (set it before stopping the ranks on purpose)."""
    done = threading.Event()

    def loop():
        while not done.wait(interval_s):
            for r, p in procs.items():
                rc = p.poll()
                if rc not in (None, 0):
                    done.set()
                    on_failure(r, rc)
                    return
    threading.Thread(target=loop, name="rank-watch", daemon=True).start()
    return done


def stop_ranks(procs: dict, timeout_s: float = 30.0) -> dict:
    """Wait up to ``timeout_s`` for every process, then kill the rest.
    Returns rank -> return code (a killed one's negative signal)."""
    deadline = time.monotonic() + timeout_s
    for p in procs.values():
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
    return {r: p.returncode for r, p in procs.items()}
