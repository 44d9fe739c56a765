"""Disaggregated prefill/decode serving with a KV-cache handoff: the port
of ``tpuserve/parallel/disagg.py``.

The prefill engine only ever runs prefill steps; a finished prefill hands
its KV pages and first sampled token to the decode engine, which runs the
continuous decode batch.  Both engines sit on one card by default, as the
JAX server builds them (``--disagg``), each sizing its cache to half the
card when both auto-size; a ``decode_device`` (another card) makes the page
copy a peer copy.  The pages move with one indexed gather from the prefill
cache and one in-place indexed copy into blocks the decode pool allocated
(the cache's tensors keep their addresses, which the captured graphs
hold), on the card, with no host round trip; an int8 cache moves its scale
pages with its values.  Engines in one process capture their graphs one at
a time (``runtime/graphs.py``), while the other replays.

On a tp / ep mesh (``parallel/mesh.py``: one process a card) every rank
builds the same pair on its card, rank 0 schedules both engines, and one
lockstep carries both engines' descriptors, each tagged with its engine
(``parallel/multihost.py``); a migration is ``Engine._exec_handoff``: each
rank copies its own heads from its prefill cache into its decode cache,
with nothing crossing ranks.  A pipeline (pp) mesh is refused, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tpuserve_torch.models.weights import to_device
from tpuserve_torch.parallel import multihost
from tpuserve_torch.parallel.mesh import RankMesh
from tpuserve_torch.runtime.engine import Engine, EngineConfig
from tpuserve_torch.runtime.request import Request, RequestOutput, SamplingParams
from tpuserve_torch.utils import next_power_of_2


def _pad_blocks(blocks: Sequence[int]) -> list[int]:
    """Pad the block list to a power-of-two bucket (the JAX package's
    bounded recompiles; here one wire shape a bucket); padding repeats the
    first block, and rewriting identical data is a no-op."""
    blocks = [int(b) for b in blocks]
    return blocks + [blocks[0]] * (next_power_of_2(len(blocks)) - len(blocks))


def extract_seq_kv(cache: list[dict], blocks: Sequence[int]) -> list[dict]:
    """One sequence's KV pages: per layer ``{key: (bucketed blocks, page,
    heads, width)}`` (with ``ks`` / ``vs`` scale pages on an int8 cache),
    gathered on the cache's device.  The JAX function also returns the
    donated cache; this one leaves the cache as it was."""
    idx = torch.tensor(_pad_blocks(blocks), dtype=torch.long, device=cache[0]["k"].device)
    return [{key: layer[key].index_select(0, idx) for key in layer} for layer in cache]


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def check_kv_format(cache: list[dict], seq_kv: list[dict]) -> None:
    """Raise ``ValueError`` on a cache format mismatch between pools: an
    int8 prefill pool handing pages to a bf16 decode pool (or the reverse)
    would otherwise write raw codes as values and drop the scales."""
    if not (seq_kv and cache):
        return
    src_keys, dst_keys = set(seq_kv[0]), set(cache[0])
    if src_keys != dst_keys:
        raise ValueError(
            f"KV cache format mismatch between pools: transferred pages "
            f"carry {sorted(src_keys)} but this pool stores "
            f"{sorted(dst_keys)} — both pools must use the same "
            "--kv-cache-dtype")
    src_dt = _as_tensor(seq_kv[0]["k"]).dtype
    dst_dt = cache[0]["k"].dtype
    if (src_dt == torch.int8) != (dst_dt == torch.int8):
        raise ValueError(
            f"KV cache dtype mismatch between pools: transferred pages "
            f"are {src_dt}, this pool stores {dst_dt} — both pools "
            "must use the same --kv-cache-dtype")


def check_seq_kv(cache: list[dict], seq_kv: list[dict], blocks: Sequence[int],
                 parts: int = 1) -> None:
    """Raise ``ValueError`` unless ``seq_kv`` are whole pages this cache can
    take into ``blocks``: its format (:func:`check_kv_format`), its layers,
    and each array's shape, the padded block count and one card's geometry
    (a cache that holds 1 of ``parts`` head slices, ``sharding.cut_pages``,
    takes ``parts`` times its heads)."""
    check_kv_format(cache, seq_kv)
    if len(seq_kv) != len(cache):
        raise ValueError(f"{len(seq_kv)} layers of transferred pages for "
                         f"{len(cache)} in this pool")
    n = len(_pad_blocks(blocks))
    for layer, moved in zip(cache, seq_kv):
        for key, dst in layer.items():
            want = [n, *dst.shape[1:]]
            if parts > 1:
                want[2] *= parts
            got = list(_as_tensor(moved[key]).shape)
            if got != want:
                raise ValueError(f"transferred {key!r} pages of shape {got} for "
                                 f"{want} (padded blocks, page, heads, width)")


def insert_seq_kv(cache: list[dict], seq_kv: list[dict], blocks: Sequence[int],
                  device=None) -> list[dict]:
    """Write transferred pages into the cache's allocated ``blocks``, in
    place; ``device``: the cache's device when the pages come from another
    (the copy to it rides the peer link).  Raises ``ValueError`` on a cache
    format mismatch between pools (:func:`check_kv_format`)."""
    check_kv_format(cache, seq_kv)
    dev = cache[0]["k"].device if cache else device
    idx = torch.tensor(_pad_blocks(blocks), dtype=torch.long, device=dev)
    for layer, moved in zip(cache, seq_kv):
        for key, dst in layer.items():
            src = _as_tensor(moved[key]).to(device=dev, dtype=dst.dtype, non_blocking=True)
            if src.shape[0] != idx.numel():
                raise ValueError(f"{src.shape[0]} transferred blocks for "
                                 f"{idx.numel()} allocated (padded)")
            dst.index_copy_(0, idx, src)
    return cache


@dataclasses.dataclass
class DisaggStats:
    kv_transfers: int = 0
    kv_bytes_transferred: int = 0
    transfer_time_s: float = 0.0
    # the decode engine's ``EngineStats``: any other field (what a server's
    # metrics read of the pair) is read from it
    engine: object = dataclasses.field(default=None, repr=False, compare=False)

    def __getattr__(self, name):
        eng = self.__dict__.get("engine")
        if eng is None:
            raise AttributeError(name)
        return getattr(eng, name)


class DisaggregatedEngine:
    """Prefill pool + decode pool with a KV handoff, as the JAX package's.

    ``params``: one weight tree both engines serve (the port shares it on
    the card; the JAX pair loads it twice); None loads or draws it once
    here for both.  ``device``: the prefill engine's (and, without
    ``decode_device``, the decode engine's) device.  Other attributes an
    engine's server reads (the tokenizer, stats, scheduler) are the decode
    engine's."""

    def __init__(self, prefill_config: EngineConfig, decode_config: EngineConfig,
                 decode_device=None, mesh=None, *, params=None, model_cfg=None,
                 device="cuda"):
        if prefill_config.lora_modules or decode_config.lora_modules:
            # the migrated request does not carry its adapter index, and the
            # pools' adapter banks could differ
            raise ValueError("multi-LoRA (lora_modules) is not supported "
                             "on disaggregated topologies; use "
                             "merge-at-load lora_dir")
        if isinstance(mesh, RankMesh) and mesh.cfg.pp > 1:
            # the JAX refusal: the pages move as per-layer lists, a stage
            # holds a slice of the layers
            raise ValueError("disaggregation is not supported on pipeline (pp) meshes; "
                             "use tp or plain engines")
        if mesh is not None and decode_device is not None:
            raise ValueError("a pair on a mesh shares each rank's card: "
                             "decode_device is not taken there")
        if decode_device is None:
            # colocated: both engines on one card; split the auto-sizing
            # budget, or each would claim all of it
            def _halved(cfg: EngineConfig) -> EngineConfig:
                if cfg.cache.num_blocks == 0 and cfg.hbm_share == 1.0:
                    return dataclasses.replace(cfg, hbm_share=0.5)
                return cfg
            prefill_config = _halved(prefill_config)
            decode_config = _halved(decode_config)
        # The prefill side must never window-release: migration ships its
        # block_table() pages, and released entries would transfer block
        # 0's unrelated KV into the decode pool's prefix cache.
        prefill_config = dataclasses.replace(prefill_config, window_release=False)
        # under a mesh both engines lead (rank 0) or follow (the others)
        # one lockstep, their descriptors tagged
        with multihost.making(mesh):
            self.prefill = Engine(prefill_config, params=params, model_cfg=model_cfg,
                                  mesh=mesh, device=device, lockstep_tag="prefill")
            # one tree on one card (under a mesh: the rank's slice); a
            # merge-at-load adapter is merged by each engine into its own copy
            shared = params
            if shared is None and decode_device is None and not decode_config.lora_dir:
                shared = self.prefill.params
            elif shared is not None and decode_device is not None:
                shared = to_device(shared, decode_device)
            self.decode = Engine(decode_config, params=shared, model_cfg=model_cfg,
                                 mesh=mesh, lockstep_tag="decode",
                                 device=device if decode_device is None else decode_device)
        self.decode_device = decode_device
        self.stats = DisaggStats(engine=self.decode.stats)
        # prefilled requests whose KV still lives in the prefill cache,
        # waiting for decode-pool capacity (admission-controlled migration)
        self._ready: list[Request] = []

    def __getattr__(self, name):
        # what a server or test reads beyond the pair's own surface:
        # the decode engine's (the pool that streams the tokens)
        if name in ("prefill", "decode"):
            raise AttributeError(name)
        return getattr(self.decode, name)

    @property
    def lockstep_engines(self) -> dict:
        """The pair's engines by lockstep tag (``multihost.follower_loop``
        follows both on a follower rank)."""
        return {"prefill": self.prefill, "decode": self.decode}

    def stop_followers(self) -> None:
        """Under a mesh, rank 0's stop to the follower ranks (once, for both
        engines: they share the lockstep)."""
        self.decode.stop_followers()

    def add_request(self, prompt: str | None = None,
                    prompt_token_ids: Optional[Sequence[int]] = None,
                    params: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None,
                    deadline: Optional[float] = None, **kw) -> str:
        params = params or SamplingParams()
        # validate against BOTH pools at intake: a prompt the decode pool
        # can never admit is refused here, not found in step() after its
        # prefill
        if prompt_token_ids is None:
            if prompt is None:
                raise ValueError("need prompt or prompt_token_ids")
            prompt_token_ids = self.prefill.tokenizer.encode(prompt)
            prompt = None
        n = len(prompt_token_ids)
        # max_tokens == 1 finishes at prefill and never migrates
        if params.max_tokens > 1 and n >= self.decode.max_seq_len:
            raise ValueError(
                f"prompt of {n} tokens exceeds the decode pool capacity "
                f"({self.decode.max_seq_len} tokens)")
        rid = self.prefill.add_request(prompt=prompt, prompt_token_ids=prompt_token_ids,
                                       params=params, request_id=request_id,
                                       deadline=deadline, **kw)
        # mirror the record decode-side at once: every request is claimed
        # from (and popped off) decode.requests wherever it ends
        self.decode.requests[rid] = self.prefill.requests[rid]
        return rid

    def _decode_has_capacity(self, req: Request) -> bool:
        dst = self.decode
        if dst.scheduler.num_running >= dst.config.scheduler.max_num_seqs:
            return False
        # prompt blocks + 1 headroom block for the first decode append
        need = dst.block_manager.blocks_needed(req.num_prompt_tokens) + 1
        return need <= dst.block_manager.num_free_blocks

    def _migrate(self, req: Request) -> None:
        """Move a prefilled sequence, KV pages and state, to the decode
        pool; the caller has checked its capacity."""
        rid = req.request_id
        src_blocks = self.prefill.block_manager.block_table(rid)
        dst = self.decode
        t0 = time.monotonic()
        dst_alloc = dst.block_manager.allocate(rid, req.prompt_token_ids)
        try:
            # as an adoption: the allocate may have evicted cached blocks
            # that the copy overwrites, so the tiers act on them first
            dst._drop_superseded_tier_entries(req.prompt_token_ids)
            dst._demote_evicted()
            seq_kv = dst._exec_handoff(self.prefill, src_blocks, dst_alloc.blocks,
                                       device=self.decode_device)
        except Exception:
            # the pages never landed: without this the decode pool leaks the
            # allocation (the request is not registered decode-side yet)
            dst.block_manager.free(rid, cache_blocks=False)
            raise
        self.stats.transfer_time_s += time.monotonic() - t0
        self.stats.kv_transfers += 1
        # one card's pages: under a mesh the tp ranks moved a slice each
        self.stats.kv_bytes_transferred += sum(
            t.numel() * t.element_size() for layer in seq_kv for t in layer.values()
        ) * len(src_blocks) * dst._page_parts // max(1, seq_kv[0]["k"].shape[0])
        # adopt the request into the decode engine mid-flight
        dst.requests[rid] = req
        dst._detok[rid] = self.prefill._detok.pop(rid)
        salt = self.prefill._salts.pop(rid, None)
        if salt is not None:
            dst._salts[rid] = salt           # the same sampling stream
        for table in ("_guided", "_guided_fsm", "_guided_plan"):
            # the acceptor, the FSM mirror and a committed canonical-suffix
            # plan follow the request, or the constraint stops at the pools'
            # boundary (the decode engine uploads its own grammar tables)
            state = getattr(self.prefill, table).pop(rid, None)
            if state is not None:
                getattr(dst, table)[rid] = state
        if dst._adaptive_window and (dst.scheduler.running
                                     or dst._pending_window is not None):
            # a migration into a busy decode pool is an arrival
            dst._last_busy_arrival = time.monotonic()
        dst.scheduler.running.append(req)
        self.prefill.block_manager.free(rid)
        self.prefill.requests.pop(rid, None)

    def _try_migrations(self) -> bool:
        """Migrate every parked request the decode pool can admit."""
        migrated = False
        still_ready = []
        for req in self._ready:
            if self._decode_has_capacity(req):
                self._migrate(req)
                migrated = True
            else:
                still_ready.append(req)
        self._ready = still_ready
        return migrated

    def step(self) -> list[RequestOutput]:
        """One iteration: drain ready migrations under decode admission
        control, run prefill intake, then the decode batch."""
        outputs: list[RequestOutput] = []
        self._try_migrations()
        if self.prefill.scheduler.num_waiting:
            outputs.extend(self.prefill.step())
            # park freshly prefilled requests for migration, out of the
            # prefill scheduler so that it never decodes them
            for req in list(self.prefill.scheduler.running):
                self.prefill.scheduler.running.remove(req)
                self._ready.append(req)
            self._try_migrations()
            # requests that finished at prefill (max_tokens=1) never
            # migrate: their records go decode-side for claiming
            for out in outputs:
                if out.finished and out.request_id in self.prefill.requests:
                    self.decode.requests[out.request_id] = \
                        self.prefill.requests.pop(out.request_id)
        # the engine's has_work, not the scheduler's: a pipelined window
        # whose rows all finished still owes its flush
        if self.decode.has_work():
            outputs.extend(self.decode.step())
        if self._ready and not self.decode.scheduler.has_work():
            # decode went idle: its free blocks are at their most, so one
            # more attempt is decisive
            if not self._try_migrations():
                req = self._ready[0]
                raise MemoryError(
                    f"decode pool cannot admit request {req.request_id} "
                    f"({req.num_prompt_tokens} prompt tokens): needs "
                    f"{self.decode.block_manager.blocks_needed(req.num_prompt_tokens) + 1}"
                    f" blocks / 1 seq slot, pool has "
                    f"{self.decode.cache_cfg.num_blocks} blocks total")
        return outputs

    def has_work(self) -> bool:
        return bool(self._ready) or self.prefill.has_work() or self.decode.has_work()

    @property
    def requests(self) -> dict:
        """Request records, mirrored into the decode engine's dict from
        intake (one real dict to look up and pop from)."""
        return self.decode.requests

    def abort_request(self, request_id: str) -> bool:
        aborted = False
        for req in list(self._ready):
            if req.request_id == request_id:
                self._ready.remove(req)
                self.prefill.block_manager.free(request_id)
                self.prefill._detok.pop(request_id, None)
                aborted = True
        if not aborted:
            aborted = (self.prefill.abort_request(request_id)
                       or self.decode.abort_request(request_id))
        if aborted:
            self.prefill.requests.pop(request_id, None)
            self.decode.requests.pop(request_id, None)
        return aborted

    def drain_request_errors(self) -> list:
        return self.prefill.drain_request_errors() + self.decode.drain_request_errors()

    def salvage_requeue(self) -> list:
        return self.prefill.salvage_requeue() + self.decode.salvage_requeue()

    def warmup(self, *a, **kw) -> None:
        self.prefill.warmup(*a, **kw)
        self.decode.warmup(*a, **kw)

    def generate(self, prompts, params=None) -> list[Request]:
        if params is None:
            params = SamplingParams()
        if isinstance(params, SamplingParams):
            params = [params] * len(prompts)
        if len(params) != len(prompts):
            raise ValueError("prompts/params length mismatch")
        rids = []
        for prompt, p in zip(prompts, params):
            if isinstance(prompt, str):
                rids.append(self.add_request(prompt=prompt, params=p))
            else:
                rids.append(self.add_request(prompt_token_ids=prompt, params=p))
        while self.has_work():
            self.step()
        return [self.decode.requests.pop(rid) for rid in rids]
