"""Decode executables: the port of the JAX engine's per-bucket decode
executables and the decode rungs of its warmup ladder
(``tpuserve/runtime/engine.py``, ``_warmup``).

The JAX engine compiles ``decode_multi`` once per (padded batch, sampling
mode, steps) and runs that executable for every dispatch of its shape.  On
the card the counterpart is a captured CUDA graph.  A
:class:`DecodeExecutable` owns the static buffers of one (padded batch B,
mode) and a graph of ONE decode iteration (``transformer.decode_state_step``)
over them; a fused window replays it S times, a single step once.  A
dispatch fills the buffers with one host-to-device copy from pinned
staging and, for rows that continue an in-flight dispatch, one select of
that dispatch's last tokens on the device (the JAX ``_select_tokens``);
its (B, S) tokens come back with one device-to-host copy into pinned
memory behind an event, read when the engine flushes the dispatch.

An engine's graphs share one memory pool and one capture stream, largest
bucket first.  Before a capture the step runs once on the capture stream,
so the cuBLAS handles, the kernel libraries and the split-K decode
workspace (made for the largest bucket, outside any capture, and held here
as long as the graphs) all exist first.  A replay never calls the kernel
wrappers, so each executable records the launches its capture made and
adds them to the wrappers' ``LAUNCHES`` counts on every replay.  A capture
that fails raises: the engine never runs a bucket eagerly in its place.

On the CPU, and on the card with ``capture=False``, there is no graph: the
same object runs the step eagerly on the same buffers.
"""

from __future__ import annotations

import gc
import time
import weakref

import numpy as np
import torch

from tpuserve_torch.models import transformer
from tpuserve_torch.ops import flash_prefill, paged_decode, paged_window, ragged_paged

KERNEL_MODULES = (flash_prefill, paged_decode, paged_window, ragged_paged)
# per-row int32 fields of the packed state, after the block tables
_FIELDS = ("tokens", "positions", "seq_lens", "active", "salt", "step",
           "temperature", "use_host", "gather")


def _name(mod) -> str:
    return mod.__name__.rsplit(".", 1)[-1]


def pool_bytes_bound(cfg, buckets) -> int:
    """The most device memory the decode graphs of one engine can reserve,
    from shapes: each executable of ``buckets`` in both modes keeps its
    (B, V) float32 logits; one step's transients stay under eight (B, V)
    int64 tensors of the largest bucket (the keyed noise's); and 256 MiB
    for the layer activations, the capture stream's cuBLAS workspace and
    the allocator's rounding.  The engine leaves this much free when it
    sizes its cache to the card."""
    V = cfg.vocab_size
    return (len(transformer.DECODE_MODES) * sum(buckets) * V * 4
            + 8 * max(buckets) * V * 8 + (256 << 20))


def _launch_counts() -> dict:
    """Each kernel wrapper's ``LAUNCHES``, by kernel name."""
    return {_name(m): m.LAUNCHES for m in KERNEL_MODULES}


class Staging:
    """One dispatch's packed inputs on the host, as numpy views of one
    int32 tensor (pinned on the card, so its copy to the card is
    asynchronous; the caching host allocator reuses it only after that
    copy ran).  ``block_tables`` (B, max_blocks) first, then the per-row
    fields of :data:`_FIELDS` (``temperature`` as float32, ``salt`` and
    ``step`` as uint32), then ``col``.  Padding rows: length 1, inactive,
    greedy, token from the host."""

    def __init__(self, B: int, max_blocks: int, pinned: bool):
        n = B * max_blocks + len(_FIELDS) * B + 1
        self.tensor = torch.zeros(n, dtype=torch.int32, pin_memory=pinned)
        a = self.tensor.numpy()
        self.block_tables = a[:B * max_blocks].reshape(B, max_blocks)
        off = B * max_blocks
        for name in _FIELDS:
            setattr(self, name, a[off:off + B])
            off += B
        self.temperature = self.temperature.view(np.float32)
        self.salt = self.salt.view(np.uint32)
        self.step = self.step.view(np.uint32)
        self.seq_lens[:] = 1
        self.use_host[:] = 1


class DecodeExecutable:
    """The static buffers and (on the card) the captured graph of one
    (padded batch ``B``, ``mode``) decode iteration."""

    def __init__(self, owner: "DecodeGraphs", B: int, mode: str):
        # a weak reference: the owner holds its executables, and a cycle
        # would outlive the engine until a garbage collection, which could
        # then destroy these graphs inside a later capture and invalidate it
        self.owner = weakref.proxy(owner)
        self.B, self.mode = B, mode
        dev, MB = owner.device, owner.max_blocks
        self.buf = torch.zeros(B * MB + len(_FIELDS) * B + 1, dtype=torch.int32,
                               device=dev)
        field = {}
        off = B * MB
        for name in _FIELDS:
            field[name] = self.buf[off:off + B]
            off += B
        self.use_host, self.gather = field["use_host"], field["gather"]
        self.state = transformer.DecodeState(
            tokens=field["tokens"], positions=field["positions"],
            seq_lens=field["seq_lens"], active=field["active"], salt=field["salt"],
            step=field["step"], temperature=field["temperature"].view(torch.float32),
            block_tables=self.buf[:B * MB].view(B, MB),
            out=torch.zeros((B, owner.steps), dtype=torch.int32, device=dev),
            col=self.buf[off:off + 1])
        self.graph = None
        self.logits = None           # the last iteration's (B, V) logits
        self.launches: dict = {}     # kernel launches one replay makes

    def step(self) -> torch.Tensor:
        o = self.owner
        return transformer.decode_state_step(o.params, o.cfg, self.state, o.kv_cache,
                                             mode=self.mode, attn_impl=o.attn_impl)

    def stage(self) -> Staging:
        return Staging(self.B, self.owner.max_blocks, self.owner.device.type == "cuda")

    def load(self, staging: Staging, chain=None) -> None:
        """Copy ``staging`` into the buffers; ``chain`` = (executable,
        steps) of the in-flight dispatch whose last tokens feed the rows
        with ``use_host`` 0 (row ``gather`` of its output)."""
        self.buf.copy_(staging.tensor, non_blocking=True)
        if chain is not None:
            prev, steps = chain
            last = prev.state.out[:, steps - 1][self.gather.long()]
            self.state.tokens.copy_(torch.where(self.use_host != 0, self.state.tokens, last))

    def run(self, steps: int) -> None:
        """``steps`` iterations: graph replays on the card, else eager."""
        if self.graph is None:
            for _ in range(steps):
                self.logits = self.step()
            return
        for _ in range(steps):
            self.graph.replay()
        for mod in KERNEL_MODULES:
            mod.LAUNCHES += self.launches[_name(mod)] * steps
        self.owner.replays += steps

    def fetch(self, steps: int):
        """The first ``steps`` columns of the output, copied to the host
        behind the work enqueued so far: (host tensor, event or None)."""
        out = self.state.out[:, :steps]
        if self.owner.device.type != "cuda":
            return out.clone(), None
        host = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event


class DecodeGraphs:
    """One engine's decode executables, keyed by (padded batch, mode), made
    (and on the card captured) on first use or by :meth:`warmup`.
    ``steps``: the widest dispatch (the engine's ``multi_step``);
    ``max_batch``: the largest bucket, for which the decode workspace is
    made."""

    def __init__(self, params: dict, cfg, kv_cache: list, *, device: torch.device,
                 attn_impl: str, max_blocks: int, steps: int, max_batch: int,
                 capture: bool):
        if capture and device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.params, self.cfg, self.kv_cache = params, cfg, kv_cache
        self.device, self.attn_impl = device, attn_impl
        self.max_blocks, self.steps, self.max_batch = max_blocks, steps, max_batch
        self.capture = capture
        self.executables: dict = {}
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.stream = torch.cuda.Stream(device) if capture else None
        self.workspace = None        # held as long as the graphs
        self.capture_s = 0.0         # wall seconds spent capturing
        self.replays = 0

    def get(self, B: int, mode: str) -> DecodeExecutable:
        exe = self.executables.get((B, mode))
        if exe is None:
            transformer.check_decode_mode(mode)
            exe = DecodeExecutable(self, B, mode)
            if self.capture:
                self._capture(exe)
            self.executables[(B, mode)] = exe
        return exe

    def pool_bytes(self) -> int:
        """Device memory the graphs' shared pool holds: the sizes of its
        allocator segments."""
        if self.pool is None:
            return 0
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory_snapshot(mempool_id=self.pool))

    def warmup(self, buckets, modes=transformer.DECODE_MODES) -> None:
        """Make every (bucket, mode) executable, largest bucket first."""
        for B in sorted(set(buckets), reverse=True):
            for mode in modes:
                self.get(B, mode)

    def _decode_workspace(self, B: int):
        """The capture stream's split-K workspace, made once for the
        largest bucket; checks that it holds bucket ``B``'s partitions,
        which depend on the bucket and the cache's shape alone."""
        k = self.kv_cache[0]["k"]
        _, page, Hkv, D = k.shape
        sms = paged_decode.num_sms(k.device)

        def size(n):
            return paged_decode.decode_workspace_size(n, self.cfg.num_heads, Hkv, D, page,
                                                      self.max_blocks, sms)
        if self.workspace is None:
            # keyed as the wrapper keys it: the cache's device (with its
            # index) and the capture stream
            self.workspace = paged_decode.workspace(k.device, self.stream.cuda_stream,
                                                    *size(max(self.max_batch, B)))
        need = size(B)
        if self.workspace[0].numel() < need[0] or self.workspace[1].numel() < need[1]:
            raise RuntimeError(f"decode workspace too small for bucket {B}: {need}")

    def _capture(self, exe: DecodeExecutable) -> None:
        t0 = time.perf_counter()
        if self.attn_impl == "cuda":
            self._decode_workspace(exe.B)
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            # every row padding: the KV writes leave the cache as it was
            exe.buf.zero_()
            exe.step()
        main.wait_stream(self.stream)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a finalizer that frees
        # CUDA objects (another engine's graphs, pinned memory) there would
        # invalidate it
        collect = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                logits = exe.step()
        finally:
            if collect:
                gc.enable()
        after = _launch_counts()
        # the capture recorded these launches; the replays make them
        exe.launches = {name: after[name] - before[name] for name in after}
        for mod in KERNEL_MODULES:
            mod.LAUNCHES -= exe.launches[_name(mod)]
        exe.graph, exe.logits = graph, logits
        self.capture_s += time.perf_counter() - t0
