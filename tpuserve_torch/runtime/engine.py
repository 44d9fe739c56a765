"""The serving engine: continuous batching over a paged KV cache, in
PyTorch — the port of ``tpuserve/runtime/engine.py``'s phase-split,
chunked-prefill and mixed ragged paths.

Each ``step`` is one of:
- a batched prefill (``transformer.prefill``: the flash prefill kernel on
  the card);
- one chunk of a long or prefix-hit prompt (``transformer.prefill_chunk``:
  the paged window kernel), starting at the prefix cache's cached offset;
  the request re-queues between chunks;
- a mixed step (``mixed_batching=True``): every running stream's decode row
  plus prefill-chunk rows in one flat stream (``transformer.forward_ragged``:
  the ragged paged kernel);
- a decode dispatch: a fused window of ``multi_step`` tokens (fewer while
  arrivals land in a busy engine: ``adaptive_multi_step``), or a single
  step when ``multi_step`` is 1 or the window's cache slots cannot be
  reserved;
- with ``speculative`` set, a speculative step for a decode batch without
  penalties, bias, an active floor, logprobs or guided rows: k draft
  tokens a row from n-gram lookup or a draft model
  (``transformer.draft_propose``, the flash prefill kernel on the card),
  verified in one pass (``transformer.decode_verify`` /
  ``decode_verify_sampled``: the paged window kernel), emitting 1..k+1
  tokens a row; an adaptive governor pauses it while acceptance is below
  break-even (``runtime/spec.py``).  With ``pipeline_decode`` (on with a card) a dispatch stays in
  flight while the next is dispatched from its last tokens on the device
  (``PendingDecode`` / ``PendingWindow``), and the host reads it back only
  then, as the JAX engine pipelines its decode.
Every kind runs an executable of ``runtime/graphs.py``, one a kind and
padded shape, as the JAX engine runs one compiled executable a bucket: on
the card a captured CUDA graph (for decode, of one iteration, replayed once
a token step), filled by one pinned copy a dispatch.  The prefill, chunk
and mixed steps then sample synchronously: the sampled tokens' copy to the
host is the step's one host read.
Sampling (``ops/sampling.py``) is greedy, temperature or full (top-k /
top-p / min-p), each row's noise keyed by (salt, step), with the
presence / frequency / repetition penalties, ``logit_bias``, the
``min_tokens`` floor and logprobs: inside the decode executables for
windows and single steps (an executable a sampling mode and extras), and
in the synchronous sampler of the prefill, chunk and mixed steps, in the
JAX order (penalties, bias, floor, grammar mask, sample, logprobs).
Stop strings, stop ids, ``ignore_eos`` and ``max_tokens`` are host logic,
as in the JAX engine.

Guided decoding (``response_format``, ``guided_regex``,
``guided_choice``), as the JAX engine's: a spec that compiles to a
token-level FSM (``runtime/grammar/``) is served by true logit masking,
its state carried on the card inside the fused windows (one grammar a
window; the tables in the executables' static buffers) and mirrored on
the host at emission; a spec that does not (or every spec, with
``guided_fsm=False``) runs per step through the substitution path, which
checks each sampled token's text against a character-level acceptor and
substitutes the best legal candidate.

The tiered KV cache, as the JAX engine's (on whenever prefix caching is,
unless ``kv_tiers=False`` or ``TPUSERVE_KV_TIERS=0``): a cached prefix
block evicted from the card is demoted to a host-DRAM tier and from there
to a spill directory (``runtime/kv_tiers.py``); its pages are copied out
right before the next dispatch that writes KV, and a waiting prompt whose
prefix resolves in a lower tier has its blocks copied back in place
(``kv_cache.scatter_block_pages``) ahead of its admission, overlapping the
step dispatched meanwhile, then prefills only the suffix.

The flight recorder (``runtime/flight.py``), on by default as in the JAX
engine: every request's lifecycle events and every cycle's step record,
with the cycle's host phases (``runtime/hostprof.py``: schedule, block,
dispatch, flush, detokenize), all stamped in host code around the
replays, from host-known values; ``flight=False`` removes it.

Embeddings (``embed``) and prompt scoring (``score_prompts``) run the
cache-less trunk (``transformer.embed_forward`` / ``score_prompt``: the
flash prefill kernel on the card) eagerly, outside the step loop, batched
under the JAX engine's attention-score budget; a server calls them on its
loop thread between steps (``server/runner.py``).

Model breadth, as the JAX engine's: an MLA model (DeepSeek) runs its
latent cache on the plain attention (``attn_impl`` "cuda" is downgraded to
"reference", logged, before anything launches); ``quantization="int8"``
quantizes the weights a layer at a time as they are made or loaded;
``lora_dir`` merges one PEFT adapter into the weights before that;
``lora_modules`` stacks several, selected per request (``add_request(...,
adapter=name)``), after quantization, with prefix caching (and so the
tiers) off, since cached KV is adapter-specific.

The KV block manager is the C++ one of ``tpuserve_torch.native`` when g++
builds it (``create_block_manager``; ``TPUSERVE_BLOCK_MANAGER=python``
picks the Python one, and so does ``TPUSERVE_STRICT_BLOCKS``, whose
per-cycle integrity check reads the Python one's sequence table).
The device profiler (``runtime/devprof.py``, on by default as in the JAX
engine; ``devprof=False`` or ``TPUSERVE_DEVPROF=0`` removes it) brackets
each dispatch with CUDA events, read at the existing flushes, registers
each executable's making in its ladder and keeps the HBM watermark.
``swap_model`` replaces the served model in place for the model pool
(``modelpool/``), releasing the outgoing graphs and cache first.

Under a mesh (``parallel/mesh.py`` ``RankMesh``: one process a card) the
engine is one rank of a tensor / expert parallel grid: it holds its slice
of the weights (``parallel/sharding.py``) and a cache of its kv heads, and
its transformer sums over the ranks where GSPMD inserted collectives in the
JAX package.  On a pure ``pp`` grid it is one pipeline stage
(``parallel/pipeline.py``): its layers' weights and cache pages (stage 0
also the head), every step run through the stages, with the JAX
pipeline engine's gates (no chunked prefill or mixed steps, its
prompt-score budget at intake, no speculation, MLA, MoE, per-layer
windows, embeddings, scoring, tiers or adoption).  Rank 0 schedules and
mirrors every executable it makes or runs, every tier page copy and every
trunk batch to the follower ranks through its ``_exec_*`` hooks
(``parallel/multihost.py``), which run ``follower_loop`` on engines built
the same way (``lockstep_tag`` names an engine's descriptors where two
share a rank: the in-process pair).  On a tp / ep grid the engine serves what it serves on one
card: the KV tiers (a store a rank, holding its slice of each page, its
budget in blocks, the restored span agreed over the ranks), guided
decoding (a grammar's tables sent once, with the run that first reads
them), embeddings and scoring (every rank runs the trunk on its slice) and
speculation (each rank holds its slice of a draft model), and KV adoption
and extraction (``adopt_prefilled`` and the pair's and a prefill pod's
page copies: rank 0 alone checks a migration and holds one card's whole
pages, each rank writes or reads its own heads of them).  The JAX
engine's refusals under a mesh stay: multi-LoRA, ``swap_model``, and
across nodes (``--multihost``) ``multihost_unsupported`` at intake,
embeddings, scoring and the tiers.  Decode runs unpipelined under a mesh,
as the JAX lockstep does.  ``params`` given under a mesh are the rank's slice
(``sharding.shard_params`` of the whole tree, an int8 tree quantized whole
first); an engine that loads or draws its own keeps each layer's slice as
it is made.  ``adopt_prefilled`` takes a sequence prefilled by
another engine (``parallel/disagg.py``) or pod (``disagg_net.py``), and
``hbm_share`` splits a card between engines.

The engine runs on ``device="cuda"`` unless the caller passes
``device="cpu"`` (the tests do); it never falls back to the CPU on its own.
Options of the JAX engine that this slice does not carry raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import json
import logging
import os
import string
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from tpuserve_torch.models import transformer
from tpuserve_torch.models.config import ModelConfig, get_model_config
from tpuserve_torch.models.tokenizer import IncrementalDetokenizer, load_tokenizer
from tpuserve_torch.models.weights import (
    apply_lora, is_quantized, load_lora_stack, load_or_init, param_nbytes, quantize_layer_int8,
    quantize_params_int8, to_device)
from tpuserve_torch.ops import sampling as sampling_ops
from tpuserve_torch.ops.ragged_paged import ragged_block, ragged_layout
from tpuserve_torch.parallel.mesh import RankMesh
from tpuserve_torch.parallel.multihost import Lockstep, agree_min, pack_pages, unpack_pages
from tpuserve_torch.parallel.sharding import (
    RankSlicer, draft_rank_config, join_pages, page_parts, rank_config, shard_params)
from tpuserve_torch.runtime import grammar
from tpuserve_torch.runtime import spec as spec_mod
from tpuserve_torch.runtime.block_manager import create_block_manager
from tpuserve_torch.runtime.graphs import (
    DECODE_EXTRAS, MAX_LOGPROBS, VERIFY_MODES, DecodeExecutable, StepGraphs,
    pool_bytes_bound, sizing_of)
from tpuserve_torch.runtime.guided import (
    JsonStateMachine, SchemaJsonStateMachine, compile_schema)
from tpuserve_torch.runtime.guided_choice import ChoiceStateMachine, compile_choices
from tpuserve_torch.runtime.guided_regex import RegexStateMachine, compile_regex
from tpuserve_torch.runtime.clock import MONOTONIC
from tpuserve_torch.runtime.devprof import DeviceProfiler, dispatch_kind
from tpuserve_torch.runtime.faults import FaultInjector
from tpuserve_torch.runtime.flight import FlightRecorder
from tpuserve_torch.runtime.hostprof import PROF
from tpuserve_torch.runtime.kv_cache import (
    CacheConfig, PageStaging, bytes_per_block, create_kv_cache, gather_block_pages,
    num_blocks_for_budget, scatter_block_pages)
from tpuserve_torch.runtime.kv_tiers import TieredPageStore
from tpuserve_torch.runtime.request import (
    FinishReason, Request, RequestOutput, RequestState, SamplingParams, check_stop)
from tpuserve_torch.runtime.scheduler import ScheduledBatch, Scheduler, SchedulerConfig
from tpuserve_torch.runtime.slo import ShedError, SloConfig, SloController, class_rank
from tpuserve_torch.runtime.spec import SpecConfig
from tpuserve_torch.utils import env_flag, next_power_of_2

logger = logging.getLogger("tpuserve_torch.engine")

# blocks a round of the tier page copies moves (PageStaging's rows)
PAGE_STAGING_BLOCKS = 32
# host-tier records warmup pins ahead (up to the tier's budget); past it
# a demote pins its records as it makes them
PIN_RECORDS_MAX_BYTES = 2 << 30
# Engine.warmup's sample_modes default: the JAX engine's
SAMPLE_MODES = ("greedy", "temperature", "full", "logprobs", "penalties", "bias",
                "min_tokens")


@dataclasses.dataclass
class EngineConfig:
    model: str = "Qwen/Qwen3-0.6B"
    checkpoint_dir: Optional[str] = None      # HF safetensors dir; None = random init
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    attn_impl: str = "auto"                   # "auto" | "reference" | "cuda"
    enable_prefix_caching: bool = True
    seed: int = 0
    # Sliding-window rolling buffer (Engine._release_window_blocks), on as
    # in the JAX engine: a uniformly windowed model's cache grows with the
    # window, not the context.
    window_release: bool = True
    # Tokens per fused decode window (transformer.decode_multi).  None =
    # auto: 32 on the card (the JAX engine's accelerator value, not yet
    # measured on this card), 1 on the CPU where tests expect per-token
    # steps.
    multi_step: Optional[int] = None
    # Adaptive window sizing, as the JAX engine's: when a request arrives
    # while decode is busy, the following windows shrink to
    # ``min_multi_step`` tokens for ``adaptive_window_hold_s`` seconds, so
    # an arrival waits out one short window, not a full one; arrivals into
    # an idle engine and arrival-free steady state keep the full window.
    # On only when multi_step > min_multi_step.
    adaptive_multi_step: bool = True
    min_multi_step: int = 4
    adaptive_window_hold_s: float = 0.5
    # Keep a decode dispatch in flight while the next is dispatched from its
    # last tokens on the device, reading it back only then.  None = on with
    # a card, off on the CPU (the JAX engine's rule, keyed on the device).
    pipeline_decode: Optional[bool] = None
    # Replay captured CUDA graphs for every step kind: prefill, chunk,
    # mixed and decode (None = on with a card; the CPU has none).  False
    # runs the same executables eagerly, for comparison.
    cuda_graphs: Optional[bool] = None
    # Injectable monotonic-time source (runtime/clock.py): None = the
    # shared real clock; tests pass a VirtualClock.
    clock: Optional[object] = None
    # Grammar-FSM guided decoding (runtime/grammar/): compile guided specs
    # to token-level FSMs whose masks ride the fused decode windows; specs
    # the compiler cannot bound, and every spec when False, run per step
    # through candidate substitution.
    guided_fsm: bool = True
    # Tiered KV cache (runtime/kv_tiers.py), as the JAX engine's: an
    # evicted cached prefix block is demoted to a host-DRAM tier (a byte
    # budget) and from there to a spill directory instead of lost; a later
    # prompt whose prefix resolves in a lower tier is restored ahead of
    # admission and prefills only the uncached suffix.  None = on whenever
    # prefix caching is on, unless TPUSERVE_KV_TIERS is 0 (off, as in the
    # JAX engine, under pp and across nodes).
    kv_tiers: Optional[bool] = None
    # host-DRAM tier byte budget; 0 = TPUSERVE_KV_HOST_BYTES or 1 GiB
    kv_host_bytes: int = 0
    # spill directory (third tier); None = TPUSERVE_KV_SPILL_DIR (unset: no
    # spill tier, the host budget's overflow is dropped)
    kv_spill_dir: Optional[str] = None
    # SLO class scheduling and overload robustness (runtime/slo.py), as the
    # JAX engine's: classes (interactive/standard/batch) order admission,
    # reserve prefill/mixed budget for strict classes, preempt batch rows
    # for interactive arrivals (a token-identical re-prefill), and walk a
    # hysteretic brownout ladder (batch max_tokens cap, then shed with 429)
    # under sustained overload.  None = TPUSERVE_SLO_CLASSES (default on;
    # 0 restores classless FIFO).
    slo_classes: Optional[bool] = None
    # the ladder's and the estimator's knobs; None = SloConfig() defaults
    slo: Optional[SloConfig] = None
    # Deterministic fault injection (runtime/faults.py): a spec such as
    # "decode_dispatch:raise:0.02" arms the injection sites before each
    # dispatch.  None = TPUSERVE_FAULTS; empty or unset = disabled.
    faults: Optional[str] = None
    # Hang watchdog (server/runner.py): a step that blocks longer than this
    # is declared stuck and salvaged as a step that raised (scaled up for
    # the first steps).  0 disables.
    step_watchdog_s: float = 0.0
    # Flight recorder (runtime/flight.py), as the JAX engine's: a ring of
    # request lifecycle events and one of per-cycle step records (with
    # the host phases of runtime/hostprof.py, which it switches on), read
    # at /debug/requests/{id} and /debug/engine, exported as OTLP child
    # spans and written as post-mortem bundles.  None = TPUSERVE_FLIGHT
    # (default on; 0 removes the recorder and the profiler).
    flight: Optional[bool] = None
    # Speculative decoding (runtime/spec.py): n-gram or draft-model drafts
    # verified in one pass; None = off
    speculative: Optional[SpecConfig] = None
    # weight-only quantization: None or "int8" (weights.quantize_params_int8)
    quantization: Optional[str] = None
    # a PEFT LoRA adapter directory merged into the weights at load
    lora_dir: Optional[str] = None
    # multi-LoRA: adapter name -> PEFT directory, stacked and selected per
    # request by add_request(adapter=name)
    lora_modules: Optional[dict] = None
    # Device telemetry (runtime/devprof.py), as the JAX engine's: device
    # time from CUDA events read at the engine's existing syncs, the
    # executable ladder with each key's capture wall, and the HBM
    # watermark.  None = TPUSERVE_DEVPROF (default on); False removes it
    # with serving unchanged.
    devprof: Optional[bool] = None
    # The share of the card's memory this engine may hold (weights, cache
    # and graphs), as the JAX engine's: engines sharing a card (the
    # colocated disaggregated pair, parallel/disagg.py) split it.
    hbm_share: float = 1.0

    def resolve_attn_impl(self, device: torch.device) -> str:
        if self.attn_impl != "auto":
            return self.attn_impl
        return "cuda" if device.type == "cuda" else "reference"

    def resolve_multi_step(self, device: torch.device) -> int:
        if self.multi_step is not None:
            return max(1, self.multi_step)
        return 32 if device.type == "cuda" else 1

    def resolve_pipeline_decode(self, device: torch.device) -> bool:
        if self.pipeline_decode is not None:
            return self.pipeline_decode
        return device.type == "cuda"

    def resolve_cuda_graphs(self, device: torch.device, mesh=None) -> bool:
        """On with a card, unless the ranks' collectives run on gloo, which
        a CUDA graph cannot capture."""
        gloo = mesh is not None and mesh.backend == "gloo"
        if self.cuda_graphs is None:
            return device.type == "cuda" and not gloo
        if self.cuda_graphs and device.type != "cuda":
            raise ValueError("cuda_graphs=True needs device='cuda'")
        if self.cuda_graphs and gloo:
            raise ValueError("cuda_graphs=True needs the nccl backend: gloo's "
                             "collectives cannot be captured")
        return self.cuda_graphs


@dataclasses.dataclass
class EngineStats:
    num_prefill_steps: int = 0       # batched prefills, chunks and mixed steps with chunks
    num_chunk_steps: int = 0         # prefill_chunk dispatches
    num_decode_steps: int = 0        # decode tokens computed per row (S per window)
    num_decode_windows: int = 0      # fused windows dispatched
    prompt_tokens: int = 0
    generated_tokens: int = 0
    preemptions: int = 0
    requests_finished: int = 0
    # fused windows: tokens computed past a request's stop point, dropped
    window_overrun_tokens: int = 0
    num_mixed_steps: int = 0
    # rows computed vs rows dispatched (padding included) by the prefill,
    # chunk and mixed paths
    actual_tokens_total: int = 0
    padded_tokens_total: int = 0
    ttft_sum: float = 0.0
    ttft_count: int = 0
    last_step_time: float = 0.0
    guided_fallbacks: int = 0        # substitution steps that left the top-K
    guided_plans: int = 0            # committed canonical-suffix completions
    guided_fsm_requests: int = 0     # requests served by grammar-FSM masks
    guided_fsm_windows: int = 0      # fused windows that carried FSM masks
    # tiered KV cache: blocks demoted from the card into the host tier;
    # host -> spill moves; blocks dropped off the last tier (KV lost);
    # blocks restored to the card; restores begun.  restore_latencies:
    # begin -> commit seconds of recent restores (the server's runner
    # drains them into tpuserve_kv_restore_latency_seconds; bounded)
    kv_demoted_blocks: int = 0
    kv_spilled_blocks: int = 0
    kv_tier_dropped_blocks: int = 0
    kv_restored_blocks: int = 0
    kv_restores: int = 0
    restore_latencies: list = dataclasses.field(default_factory=list)
    # the last dispatch's real and padded token counts (a replayed decode
    # bucket's padded tokens are its rows times the window's steps)
    step_actual_tokens: int = 0
    step_padded_tokens: int = 0
    # crash-only recovery (server/runner.py): requests re-queued through
    # the re-prefill path after a faulted or stuck step; requests isolated
    # as poison (or out of salvage budget) and failed alone; watchdog
    # trips; whole-engine fail-all fallbacks
    requests_salvaged: int = 0
    requests_poisoned: int = 0
    watchdog_trips: int = 0
    engine_restarts: int = 0
    # overload (runtime/slo.py): requests shed at intake or evicted from a
    # full queue (429 + Retry-After); batch rows preempted for stricter
    # arrivals (also in ``preemptions``); the brownout level now
    requests_shed: int = 0
    slo_preemptions: int = 0
    brownout_level: int = 0
    # flight recorder post-mortem bundles written (server/runner.py)
    flight_postmortems: int = 0
    # speculative decoding (runtime/spec.py): verify steps; draft tokens
    # offered to the verifier and accepted; adaptive governor pauses
    spec_steps: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_pauses: int = 0
    released_blocks: int = 0         # rolling-buffer KV blocks recycled
    # model pool hot-swaps (Engine.swap_model): total, by source tier, and
    # recent (tier, seconds) the server's runner drains
    model_swaps: int = 0
    model_swaps_by_outcome: dict = dataclasses.field(default_factory=dict)
    swap_latencies: list = dataclasses.field(default_factory=list)
    latency_windows: int = 0         # fused windows shrunk for arrivals


@dataclasses.dataclass
class PendingDecode:
    """An in-flight single decode step: its (B, 1) tokens are on their way
    to ``toks`` (host memory, complete once ``event`` has fired); append,
    detokenize, stop checks and emission wait for the next engine step."""
    reqs: list
    exe: DecodeExecutable            # whose output holds the tokens on the card
    toks: torch.Tensor
    event: Optional[torch.cuda.Event]
    steps: int = 1
    lp: Optional[tuple] = None       # host (chosen, ids, values) with logprobs


@dataclasses.dataclass
class PendingWindow:
    """An in-flight fused window (pipelined): the NEXT window is dispatched
    from its last column on the device, so the host read that ends every
    window overlaps the next window's device time."""
    reqs: list
    exe: DecodeExecutable
    toks: torch.Tensor               # (B, steps) int32 on the host
    event: Optional[torch.cuda.Event]
    steps: int
    lp: Optional[tuple] = None       # host (chosen, ids, values) with logprobs


def _read(p) -> tuple:
    """A pending dispatch's tokens on the host, and its logprobs (None
    without): the one read that waits on the card."""
    if p.event is not None:
        p.event.synchronize()
    return p.toks.numpy(), (None if p.lp is None else tuple(t.numpy() for t in p.lp))


def _check_mesh_config(config: EngineConfig, mesh) -> None:
    """The JAX engine's refusals under a mesh (the pipeline engine's first,
    with its messages; ``make_mesh`` refuses a pp grid beside tp or ep, or
    across nodes)."""
    if mesh.shape.get("pp", 1) > 1 and config.speculative:
        raise ValueError("speculative decoding is not supported on the pipeline "
                         "engine (the verify window would serialise through every "
                         "stage)")
    if config.lora_modules:
        raise ValueError("multi-LoRA with a tp/ep/pp mesh is not supported (the "
                         "stacked factors have no shardings); use merge-at-load "
                         "lora_dir under TP")


def _decode_key(B: int, mode: str, extras: str = "", bucket: tuple = ()) -> tuple:
    """A decode executable's key; ``bucket``: a guided one's grammar
    (states, classes) bucket."""
    return ("decode", B, mode) + ((extras,) if extras else ()) + tuple(bucket)


class Engine:
    """Serving engine of one model on one device, or one rank of a tensor /
    expert parallel grid (``mesh``, ``parallel/mesh.py``)."""

    def __init__(self, config: EngineConfig | None = None, *, params=None,
                 model_cfg: ModelConfig | None = None, mesh=None,
                 device: str | torch.device = "cuda", lockstep_tag: Optional[str] = None):
        config = config or EngineConfig()
        self.config = config
        self.device = torch.device(device)
        if mesh is not None and not isinstance(mesh, RankMesh):
            # the JAX engine's single-process mesh (GSPMD over several
            # devices) has no PyTorch counterpart: a port mesh is one
            # process a card (parallel/mesh.py)
            raise NotImplementedError(
                "a mesh here is a parallel.mesh.RankMesh, one process a card; "
                "a single-process multi-device mesh is not ported (ROADMAP.md A10)")
        if mesh is not None:
            # one process a card: the rank's device (the CPU for gloo ranks
            # on the CPU), never another type than asked for
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh's device {mesh.device} is not a "
                                 f"{self.device.type} device")
            self.device = mesh.device
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the engine on the CPU")
        self.mesh = mesh
        if mesh is not None:
            _check_mesh_config(config, mesh)
        # the card's bytes outside the caching allocator before this
        # engine made anything: the HBM watermark counts what it adds
        self._outside_base = self._outside_allocator_bytes()
        if config.quantization not in (None, "int8"):
            # refused before the (possibly many-GB) weights are made
            raise ValueError(f"unknown quantization {config.quantization!r};"
                             " supported: int8")
        if config.lora_modules and config.speculative:
            raise ValueError("multi-LoRA cannot combine with speculative "
                             "decoding (the verify trunk doesn't thread "
                             "adapter weights)")
        self.clock = config.clock or MONOTONIC
        self.model_cfg = model_cfg or get_model_config(config.model)
        # under a mesh the weights are made from the model's whole config
        # and sliced, and everything else runs the rank's (its heads,
        # columns, experts and collectives)
        whole_cfg = self.model_cfg
        slicer = None
        # pipeline stages (parallel/pipeline.py): one a rank, pp > 1
        self._pp = mesh.shape.get("pp", 1) if mesh is not None else 1
        if self._pp > 1 and (whole_cfg.is_mla or whole_cfg.moe_first_k_dense):
            raise ValueError(
                "pipeline parallelism is not supported for DeepSeek models yet: the "
                "staged trunk runs uniform layers over {'k','v'} pages, which MLA's "
                "latent cache and first_k_dense_replace's mixed layers both break — "
                "use tp instead")
        if mesh is not None:
            slicer = RankSlicer(mesh, num_layers=whole_cfg.num_layers)
            self.model_cfg = rank_config(self.model_cfg, mesh)
        self.attn_impl = config.resolve_attn_impl(self.device)
        if self.attn_impl not in transformer.ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{transformer.ATTN_IMPLS} (or 'auto')")
        if self.model_cfg.is_mla and self.attn_impl == "cuda":
            # MLA attends in latent space against a one-head latent cache
            # 576 wide, values narrower than keys: no kernel takes that.
            # The JAX engine keeps MLA off its Pallas kernels the same way
            logger.info("MLA model: attn_impl=cuda not supported yet; "
                        "using the reference attention path")
            self.attn_impl = "reference"
        # a checkpoint's own tokenizer files first, as the JAX engine
        self.tokenizer = load_tokenizer(config.checkpoint_dir or config.model,
                                        vocab_size=self.model_cfg.vocab_size)
        logger.info("tokenizer: %s", type(self.tokenizer).__name__)
        int8 = config.quantization == "int8"
        own = params is None
        if own:
            # int8 without a merge: each layer is quantized as it is made
            # or loaded, so the model never exists whole in its dtype;
            # under a mesh each rank keeps its slice of each layer (a merge
            # needs the whole tree first: it is sliced after)
            params = load_or_init(whole_cfg, config.checkpoint_dir, config.seed,
                                  self.device,
                                  quantize_layer_int8 if int8 and not config.lora_dir else None,
                                  shard=None if config.lora_dir else slicer)
        if config.lora_dir:
            # before quantization: the merge targets the model-dtype kernels
            params = apply_lora(params, whole_cfg, config.lora_dir)
            logger.info("merged LoRA adapter from %s", config.lora_dir)
        if int8 and not is_quantized(params):
            if own and config.lora_dir:
                # the engine's own merged tree, a layer at a time in place:
                # one merged float layer beside the int8 ones at most
                layers = params["layers"]
                for i in range(len(layers)):
                    layers[i] = quantize_layer_int8(layers[i])
            params = quantize_params_int8(params)
        if own and config.lora_dir and mesh is not None:
            params = shard_params(params, whole_cfg, mesh)
        self._lora_names: Optional[list] = None
        self._lora_index: dict = {}
        if config.lora_modules:
            # after quantization on purpose: the stacked deltas add after the
            # dequantizing product, so int8 base weights and model-dtype
            # adapters compose (unlike the merge)
            self._lora_names = load_lora_stack(params, self.model_cfg, config.lora_modules)
            self._lora_index = {n: i for i, n in enumerate(self._lora_names)}
            logger.info("loaded %d LoRA adapter(s): %s", len(self._lora_names),
                        self._lora_names)
        self.params = params
        # speculative decoding, as the JAX engine's: the governor's rolling
        # (proposed, accepted) window and the decode step at which a paused
        # spec path probes again; a draft model's weights beside the
        # target's (before the cache is sized to what the weights left)
        self._spec: Optional[SpecConfig] = config.speculative
        self._spec_window = [0, 0]
        self._spec_resume_step = 0
        self._draft_params = None
        self._draft_cfg: Optional[ModelConfig] = None
        if self._spec is not None and self._spec.draft_model:
            self._draft_cfg = get_model_config(self._spec.draft_model)
            if self._draft_cfg.vocab_size != self.model_cfg.vocab_size:
                raise ValueError(
                    f"draft model {self._spec.draft_model!r} vocab "
                    f"{self._draft_cfg.vocab_size} != target vocab "
                    f"{self.model_cfg.vocab_size} — draft tokens must be "
                    "target tokens")
            ddir = self._spec.draft_checkpoint_dir
            if ddir and not glob.glob(os.path.join(ddir, "*.safetensors")):
                # load_or_init would silently random-init: a garbage draft
                # degrades to ~0 acceptance with no error
                raise ValueError(
                    f"draft checkpoint dir {ddir!r} has no "
                    "*.safetensors — a typo here would silently "
                    "serve a random-weights draft")
            whole_draft = self._draft_cfg
            if mesh is not None:
                # a rank holds its slice of the draft as of the target, and
                # the draft's trunk sums over the ranks as the target's
                self._draft_cfg = draft_rank_config(whole_draft, mesh)
            self._draft_params = load_or_init(
                whole_draft, ddir, config.seed, self.device,
                shard=None if mesh is None else RankSlicer(
                    mesh, num_layers=whole_draft.num_layers))
        # embeddings and prompt scoring: one trunk batch at a time
        self._embed_lock = threading.Lock()
        # Mixed batching: the flat-row block is the ragged kernel's grid
        # block AND the host packing's alignment (one source,
        # ragged_paged.ragged_block); the descriptor width is fixed so the
        # flat-token bucket is the only shape that varies.
        sched_cfg = config.scheduler
        self._ragged_blk = ragged_block(device=self.device)
        self._ragged_seqs = next_power_of_2(sched_cfg.max_num_seqs)
        if sched_cfg.mixed_batching:
            # the row budget must cover the full decode region plus one
            # aligned chunk, or a full decode batch would starve admissions
            blk = self._ragged_blk
            floor = -(-sched_cfg.max_num_seqs // blk) * blk + blk
            if sched_cfg.mixed_token_budget < floor:
                logger.warning(
                    "mixed_token_budget %d cannot cover max_num_seqs %d "
                    "decode rows plus one %d-row chunk; raising to %d",
                    sched_cfg.mixed_token_budget, sched_cfg.max_num_seqs,
                    blk, floor)
                sched_cfg = dataclasses.replace(sched_cfg,
                                                mixed_token_budget=floor)
        if self._pp > 1:
            # the stages have no ragged or chunk trunk: phase-split
            # scheduling, and every prefill batched (the flag closes all
            # three chunk routes), as the JAX pipeline engine
            if sched_cfg.mixed_batching:
                logger.warning("mixed ragged batching is not served by the pipeline "
                               "engine; falling back to phase-split scheduling")
            sched_cfg = dataclasses.replace(sched_cfg, mixed_batching=False,
                                            allow_chunked_prefill=False)
        self._multi_step = config.resolve_multi_step(self.device)
        self.cache_cfg = config.cache
        if self.cache_cfg.num_blocks == 0:
            blocks = self._auto_num_blocks(sched_cfg)
            if self._pp > 1:
                # every stage pages the same block ids: the fewest any stage
                # can hold (stage 0 also holds the head)
                import torch.distributed as dist
                t = torch.tensor([blocks], dtype=torch.int64)
                dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.ctrl_group)
                blocks = int(t)
            self.cache_cfg = dataclasses.replace(self.cache_cfg, num_blocks=blocks)
            logger.info("auto-sized KV cache: %d blocks of %d tokens",
                        self.cache_cfg.num_blocks, self.cache_cfg.block_size)
        self.kv_cache = create_kv_cache(self.model_cfg, self.cache_cfg,
                                        self.device)
        prefix_caching = config.enable_prefix_caching
        if prefix_caching and config.lora_modules:
            # cached KV is adapter-specific: a prefix hit across adapters (or
            # from the base model) would serve KV made under other weights
            logger.info("multi-LoRA: prefix caching disabled (cached KV "
                        "is adapter-specific)")
            prefix_caching = False
        self.block_manager = create_block_manager(
            self.cache_cfg.num_blocks, self.cache_cfg.block_size,
            enable_prefix_caching=prefix_caching)
        # Tiered KV cache (runtime/kv_tiers.py): demote evicted prefix
        # blocks to host DRAM / a spill directory instead of losing the KV;
        # restore them ahead of admission
        self._kv_tiers: Optional[TieredPageStore] = None
        self._restores: dict[str, tuple] = {}   # rid -> (hashes, blocks, t0)
        self._page_staging: Optional[PageStaging] = None
        tiers_on = config.kv_tiers
        if tiers_on is None:
            tiers_on = env_flag("TPUSERVE_KV_TIERS")
        if tiers_on and mesh is not None and (self._pp > 1 or mesh.multihost):
            # as the JAX engine: off under pp (a stage's pages are its
            # layers') and across nodes (several processes)
            logger.info("KV tiers are off under %s", "pp" if self._pp > 1 else
                        "several nodes")
            tiers_on = False
        if tiers_on and prefix_caching:
            host_bytes = config.kv_host_bytes or int(
                os.environ.get("TPUSERVE_KV_HOST_BYTES", 0) or (1 << 30))
            spill = config.kv_spill_dir or os.environ.get("TPUSERVE_KV_SPILL_DIR") or None
            if mesh is not None:
                # each rank files its own slice of a page: the budget in
                # blocks of one card's whole pages, so every rank's store
                # holds the same hashes in the same tier as one card's
                # would; spill files a subdirectory a rank
                host_bytes = (host_bytes // bytes_per_block(whole_cfg, self.cache_cfg)
                              * bytes_per_block(self.model_cfg, self.cache_cfg))
                if spill:
                    spill = os.path.join(spill, f"rank{mesh.rank}")
            self._kv_tiers = TieredPageStore(host_bytes, spill_dir=spill)
            if mesh is not None and mesh.world > 1:
                self._agree_spill_entries()
            self.block_manager.record_evictions = True
        # debug strict mode: block and tier accounting checked every cycle
        self._strict_blocks = bool(os.environ.get("TPUSERVE_STRICT_BLOCKS"))
        self.scheduler = Scheduler(sched_cfg, self.block_manager,
                                   max_model_len=self.cache_cfg.max_model_len,
                                   ragged_align=self._ragged_blk)
        self.scheduler.clock = self.clock
        # SLO classes and the brownout ladder (runtime/slo.py): consulted at
        # intake (shed, max_tokens cap), by the scheduler (class-ordered
        # queue, budget reserve, class-aware victims) and once a cycle
        # (tick).  Off, the controller is None and every consumer runs
        # classless FIFO.
        slo_on = config.slo_classes
        if slo_on is None:
            slo_on = env_flag("TPUSERVE_SLO_CLASSES")
        self._slo = (SloController(config.slo or SloConfig(),
                                   sched_cfg.resolve_max_waiting(), clock=self.clock)
                     if slo_on else None)
        self.scheduler.slo = self._slo
        self.stats = EngineStats()
        # terminal errors for QUEUED requests decided engine-side (deadline
        # expiry, queue-full class eviction): (rid, exc) pairs the server's
        # runner drains and routes to the waiting clients
        # (drain_request_errors)
        self._error_outbox: list = []
        # fault injection (runtime/faults.py): every dispatch site runs
        # self.faults.check(site, rids); _dispatch_rids names the requests
        # of the dispatch being built, which the runner's salvage charges
        spec = config.faults if config.faults is not None else os.environ.get(
            "TPUSERVE_FAULTS")
        self.faults = FaultInjector.from_spec(spec, seed=config.seed)
        self._dispatch_rids: tuple = ()
        # flight recorder (runtime/flight.py): written on this engine's loop
        # thread, snapshot-read by serving threads; the hot sites test the
        # cached bool, so TPUSERVE_FLIGHT=0 costs an attribute load a site
        self.flight = FlightRecorder(enabled=config.flight, clock=self.clock)
        self._flight_on = self.flight.enabled
        self._step_kind = "idle"
        # engine facts ride every bundle, so a replay sizes a comparable engine
        self.flight.note_engine_facts(
            model=config.model, max_num_seqs=sched_cfg.max_num_seqs,
            num_blocks=self.cache_cfg.num_blocks, block_size=self.cache_cfg.block_size,
            max_model_len=self.cache_cfg.max_model_len,
            mixed_batching=sched_cfg.mixed_batching, multi_step=self._multi_step,
            slo_classes=self._slo is not None)
        self.scheduler.flight = self.flight if self._flight_on else None
        if self._slo is not None:
            self._slo.flight = self.flight if self._flight_on else None
        # device telemetry (runtime/devprof.py): CUDA events around each
        # dispatch, read at the existing syncs; the executable ladder; the
        # HBM watermark.  Off, every bracket is a shared no-op
        self.devprof = DeviceProfiler(enabled=config.devprof,
                                      cuda=self.device.type == "cuda")
        self.flight.devprof = self.devprof if self.devprof.enabled else None
        if self._flight_on:
            # every step record carries its host phases (two perf_counter
            # reads a phase); a firing fault rule lands in the timelines
            PROF.enabled = True
            self.faults.on_fire = self.flight.fault_hook
        self.requests: dict[str, Request] = {}   # live + finished-unclaimed
        self._detok: dict[str, IncrementalDetokenizer] = {}
        self._salts: dict[str, int] = {}      # sampling-key salt a request
        # guided decoding, as the JAX engine's: rid -> [TokenFSM, host state]
        # for requests served by FSM masks; rid -> character acceptor for
        # the substitution path, and its committed canonical suffixes
        self._guided_fsm: dict[str, list] = {}
        self._guided: dict[str, object] = {}
        self._guided_plan: dict[str, list[int]] = {}
        self._guided_fallback_ids: Optional[list[int]] = None
        # compiled FSMs by (mode, spec), None for a spec that does not
        # compile (FIFO, MAX_FSM_CACHE); their device tables by id; the
        # token-text table and the tokenizer fingerprint, made once
        self._fsm_cache: dict[tuple, object] = {}
        self._fsm_stats = {"hits": 0, "misses": 0, "disk_hits": 0}
        self._fsm_device: dict[int, tuple] = {}
        self._fsm_texts: Optional[dict] = None
        self._fsm_tok_fp: Optional[str] = None
        # False only to plant a fault in a check: FSM rows then sample
        # unmasked (their host state still advances, and drops on the
        # first illegal token)
        self.guided_mask_enabled = True
        self._min_multi_step = min(max(1, config.min_multi_step), self._multi_step)
        self._adaptive_window = (config.adaptive_multi_step
                                 and self._multi_step > self._min_multi_step)
        self._last_busy_arrival = float("-inf")
        # off under a mesh, as under the JAX engine's multihost lockstep: a
        # dispatch's descriptor is built from the host's tokens, so windows
        # cannot run ahead of the host
        self._pipeline_decode = (config.resolve_pipeline_decode(self.device)
                                 and mesh is None)
        self._pending: Optional[PendingDecode] = None
        self._pending_window: Optional[PendingWindow] = None
        self.graphs = StepGraphs(
            self.params, self.model_cfg, self.kv_cache, device=self.device,
            attn_impl=self.attn_impl, max_blocks=self.cache_cfg.max_blocks_per_seq,
            steps=self._multi_step, max_batch=self._ragged_seqs,
            ragged_blk=self._ragged_blk,
            capture=config.resolve_cuda_graphs(self.device, mesh),
            draft_params=self._draft_params, draft_cfg=self._draft_cfg,
            n_adapters=len(self._lora_names or ()))
        if self.devprof.enabled:
            # each executable made (on the card: captured) is a ladder entry
            self.graphs.on_make = self.devprof.note_executable
        # under a mesh rank 0 leads the lockstep: it mirrors every step to
        # the follower ranks (parallel/multihost.py), which run
        # ``follower_loop`` on engines built the same way
        # (``lockstep_tag`` names this engine's descriptors where several
        # engines share the rank: an in-process pair)
        self._lockstep: Optional[Lockstep] = (
            Lockstep(mesh, lockstep_tag)
            if mesh is not None and mesh.world > 1 and mesh.is_coordinator else None)
        # a migration's whole pages are this many of the rank's head slices
        self._page_parts = page_parts(whole_cfg, mesh)
        self._req_counter = itertools.count()
        self._seed_counter = itertools.count()
        self._eos_ids = set(self.tokenizer.eos_token_ids)
        if self.model_cfg.eos_token_id is not None:
            self._eos_ids.add(self.model_cfg.eos_token_id)
        # per-sequence cache capacity, model position range, and total
        # cache size minus one block of headroom
        self.max_seq_len = min(
            self.cache_cfg.max_model_len,
            self.model_cfg.max_position_embeddings,
            (self.cache_cfg.num_blocks - 1) * self.cache_cfg.block_size)
        # the HBM watermark, once the weights and the cache exist; other
        # models' weights kept on the card count in it (the model pool)
        self._coresident_bytes = 0
        self.note_hbm()

    def swap_model(self, config: EngineConfig, *, params=None,
                   source_tier: str = "cold") -> tuple:
        """Replace the served model in place: the model pool's hot-swap
        (``modelpool/pool.py`` drives it), as the JAX engine's.

        The engine must be drained (``has_work()`` False: the runner swaps
        only at its idle boundary) and single-card (no mesh).  The
        outgoing model's captured graphs, their memory pool, its KV cache
        and staging are released first, so two ladders of graph pools
        never sit on the card together; the engine is then rebuilt for
        ``config`` around ``params`` (tier-restored weights, on the host or
        the card: host ones move to the card only once the outgoing state
        is released, so they do not land in its cached blocks; None loads
        or draws them: a cold swap), and the incoming graphs are captured
        on first use.  The flight recorder, the device profiler,
        the stats and the clock carry across.  Returns ``(old model name,
        old params)``: the caller demotes the outgoing weights."""
        if self.has_work():
            raise RuntimeError("swap_model needs a drained engine (has_work() is True)")
        if self.mesh is not None:
            raise ValueError("model hot-swap is single-card, meshless only "
                             "(weights aren't re-sharded)")
        if self.graphs.capture and self.graphs.capturing_since:
            raise RuntimeError("swap_model during a graph capture")
        t0 = self.clock.monotonic()
        old_model, old_params = self.config.model, self.params
        flight, devprof, stats = self.flight, self.devprof, self.stats
        coresident = self._coresident_bytes
        # finished records a handler has not claimed yet, and the id
        # counters, so no new request reuses an id still held
        requests, counters = self.requests, (self._req_counter, self._seed_counter)
        # release the outgoing model's device state before the incoming
        # one allocates: graphs (and their pool), cache, staging, draft
        self.params = None
        self.graphs.release()
        self.graphs = self.kv_cache = self._page_staging = None
        self._draft_params = None
        self._pending = self._pending_window = None
        self._fsm_device.clear()
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        if params is not None:
            params = to_device(params, self.device)
        self.__init__(dataclasses.replace(config, clock=self.clock), params=params,
                      device=self.device)
        # the replica-lifetime objects the rebuild replaced
        self.flight = flight
        self._flight_on = flight.enabled
        self.scheduler.flight = flight if self._flight_on else None
        if self._slo is not None:
            self._slo.flight = flight if self._flight_on else None
        if self._flight_on:
            self.faults.on_fire = flight.fault_hook
        self.devprof = devprof
        flight.devprof = devprof if devprof.enabled else None
        self.graphs.on_make = devprof.note_executable if devprof.enabled else None
        self.stats = stats
        self.requests.update(requests)
        self._req_counter, self._seed_counter = counters
        flight.note_engine_facts(
            model=config.model, max_num_seqs=self.scheduler.cfg.max_num_seqs,
            num_blocks=self.cache_cfg.num_blocks, block_size=self.cache_cfg.block_size,
            max_model_len=self.cache_cfg.max_model_len,
            mixed_batching=self.scheduler.cfg.mixed_batching, multi_step=self._multi_step,
            slo_classes=self._slo is not None)
        self.note_hbm(coresident)
        dt = self.clock.monotonic() - t0
        stats.model_swaps += 1
        stats.model_swaps_by_outcome[source_tier] = (
            stats.model_swaps_by_outcome.get(source_tier, 0) + 1)
        stats.swap_latencies.append((source_tier, dt))
        del stats.swap_latencies[:-256]
        if self._flight_on:
            flight.req_event(f"swap:{old_model}->{config.model}", "SWAP",
                             source_tier=source_tier, seconds=round(dt, 4))
        logger.info("model swap %s -> %s (%s, %.2fs)", old_model, config.model,
                    source_tier, dt)
        return old_model, old_params

    def _device_hbm_limit(self) -> int:
        """This engine's share (``hbm_share``) of the card's memory in bytes
        (``TPUSERVE_HBM_BYTES`` overrides the card's size); of the 1 GiB
        budget the cache is sized to on the CPU."""
        env = os.environ.get("TPUSERVE_HBM_BYTES")
        if env:
            limit = int(env)
        elif self.device.type == "cuda":
            limit = int(torch.cuda.mem_get_info(self.device)[1])
        else:
            limit = 1 << 30
        return int(limit * self.config.hbm_share)

    def _outside_allocator_bytes(self) -> int:
        """The card's used bytes outside the caching allocator's segments
        (the CUDA context, graph executables, library handles); 0 on the
        CPU."""
        if self.device.type != "cuda":
            return 0
        free, total = torch.cuda.mem_get_info(self.device)
        return total - free - torch.cuda.memory_reserved(self.device)

    def note_hbm(self, coresident_bytes: Optional[int] = None) -> None:
        """Refresh the device profiler's HBM watermark: the weights (the
        draft's and, when given, ``coresident_bytes`` of other models kept
        on the card), the KV cache's reservation, and as ``other`` what
        the graphs and the tiers' page staging hold in the allocator
        (``StepGraphs.device_bytes``) plus what the card gained outside
        the allocator since the engine was made (the graphs' executables);
        0 on the CPU.  Weights and KV are counted on their own, not as a
        remainder of the card's used bytes.  Loop thread only: CUDA
        calls."""
        if coresident_bytes is not None:
            self._coresident_bytes = coresident_bytes
        if not self.devprof.enabled:
            return
        weights = (param_nbytes(self.params) + self._coresident_bytes
                   + (param_nbytes(self._draft_params) if self._draft_params is not None
                      else 0))
        kv = sum(t.numel() * t.element_size() for layer in self.kv_cache for t in layer.values())
        other = 0
        if self.device.type == "cuda":
            other = (self.graphs.device_bytes()
                     + (self._page_staging.buf.numel() if self._page_staging is not None else 0)
                     + max(0, self._outside_allocator_bytes() - self._outside_base))
        n = self.cache_cfg.num_blocks
        self.devprof.set_hbm(weights=weights, kv_reserved=kv, limit=self._device_hbm_limit(),
                             num_blocks=n, block_bytes=kv // n if n else 0, other=other)
        # activations scale with tokens x hidden: three float32 buffers of
        # the hidden width a token, a rough estimate
        self.devprof.set_model_hints(act_bytes_per_token=int(self.model_cfg.hidden_size) * 4 * 3)

    def _decode_ladder(self) -> list[int]:
        """Every padded batch a decode dispatch can take
        (``Scheduler.decode_bucket`` of 1 .. ``max_num_seqs``)."""
        sched = self.config.scheduler
        top = next_power_of_2(sched.max_num_seqs)
        return sorted({min(max(next_power_of_2(n), sched.min_decode_bucket), top)
                       for n in range(1, sched.max_num_seqs + 1)})

    def _step_keys(self, sched: SchedulerConfig, max_len: int,
                   guided: bool = False) -> list[tuple]:
        """Every executable key (``runtime/graphs.py``) a dispatch can take
        under ``sched`` with sequences of at most ``max_len`` tokens: the
        decode ladder in every sampling mode and extras (the guided extras
        only with ``guided``, at a (1, 1) grammar bucket: a guided key's
        bucket follows its grammar, and its memory in the graph pool does
        not depend on it, so these stand for every bucket); with mixed
        batching the flat-token ladder (``ragged_block`` doubling up to the
        budget's power of two); else every (batch, length) pair a batched prefill pads to
        and every chunk length.  With ``speculative`` set, the verify step
        of every decode bucket in both modes and, with a draft model, its
        step at every power-of-two batch.  The scheduler's prefill admission charges
        each picked prompt at the batch's bucket, so a batch of n prompts
        at length L, padded to B = next_power_of_2(n), has n * L within
        the token budget (or n = 1)."""
        keys = [_decode_key(B, m, x, (1, 1) if "guided" in x else ())
                for B in self._decode_ladder() for m in transformer.DECODE_MODES
                for x in ("",) + DECODE_EXTRAS if guided or "guided" not in x]
        keys += self._spec_keys(VERIFY_MODES)
        if sched.mixed_batching:
            T = self._ragged_blk
            while T <= next_power_of_2(sched.mixed_token_budget):
                keys.append(("mixed", T))
                T *= 2
            return keys
        lo, chunk = sched.min_prefill_bucket, sched.prefill_chunk_size
        top = chunk if sched.allow_chunked_prefill else max_len
        lengths = {max(next_power_of_2(n), lo) for n in range(1, top + 1)}
        seqs = next_power_of_2(min(sched.max_prefill_seqs, sched.max_num_seqs))
        keys += [("prefill", B, L) for L in sorted(lengths)
                 for B in (1 << i for i in range(seqs.bit_length()))
                 if B == 1 or (B // 2 + 1) * L <= sched.max_prefill_tokens]
        if sched.allow_chunked_prefill:
            keys += [("chunk", C) for C in sorted(
                {min(chunk, max(next_power_of_2(n), lo)) for n in range(1, max_len + 1)})]
        return keys

    def _spec_keys(self, verify_modes) -> list[tuple]:
        """The speculative steps' executables (none without ``speculative``):
        the verify step of every decode bucket in ``verify_modes``; with a
        draft model, the draft step of every power-of-two batch up to the
        largest bucket (``_draft_propose`` pads the batch so)."""
        if self._spec is None:
            return []
        K = self._spec.num_draft_tokens + 1
        keys = [("verify", B, K, m) for B in self._decode_ladder() for m in verify_modes]
        if self._draft_params is not None:
            k = self._spec.num_draft_tokens
            top = next_power_of_2(self.config.scheduler.max_num_seqs)
            keys += [("draft", 1 << i, self._spec.draft_window + k, k)
                     for i in range(top.bit_length())]
        return keys

    def _auto_num_blocks(self, sched: SchedulerConfig) -> int:
        """Size the cache to the memory the weights left free (the vLLM
        ``gpu_memory_utilization`` analog): ``torch.cuda.mem_get_info`` on
        the card, less the most the graphs of every step the engine can
        dispatch can reserve (``graphs.pool_bytes_bound``: the cache is
        made before them, since they write into it); a 1 GiB budget less
        the weights on the CPU."""
        own = param_nbytes(self.params) + (param_nbytes(self._draft_params)
                                           if self._draft_params is not None else 0)
        if self.device.type == "cuda":
            free, _total = torch.cuda.mem_get_info(self.device)
            # an engine sharing the card holds at most its share of it
            free = min(free, self._device_hbm_limit() - own)
            if self.config.resolve_cuda_graphs(self.device, self.mesh):
                max_len = min(self.cache_cfg.max_model_len,
                              self.model_cfg.max_position_embeddings)
                free -= pool_bytes_bound(self.model_cfg,
                                         self._step_keys(sched, max_len, guided=True),
                                         self._ragged_seqs, self._draft_cfg,
                                         sizing_of(self.params, self.cache_cfg.max_model_len,
                                                   self._ragged_blk))
        else:
            free = int((1 << 30) * self.config.hbm_share) - param_nbytes(self.params)
        blocks = num_blocks_for_budget(self.model_cfg, self.cache_cfg, free)
        # past what the scheduler can ever address, memory is waste
        addressable = sched.max_num_seqs * (self.cache_cfg.max_blocks_per_seq + 1)
        return min(blocks, addressable, 1 << 17)

    # ------------------------------------------------------------------
    # Request intake
    # ------------------------------------------------------------------

    def add_request(self, prompt: str | None = None,
                    prompt_token_ids: Optional[Sequence[int]] = None,
                    params: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None,
                    deadline: Optional[float] = None,
                    adapter: Optional[str] = None) -> str:
        """Queue a request.  ``deadline`` (the engine clock's seconds): a
        request still queued past it is aborted before any prefill is spent
        on it (``_expire_queued_deadlines``).  ``adapter``: the name of a
        loaded ``lora_modules`` adapter to serve it with (None: the base
        model)."""
        params = params or SamplingParams()
        # the id first, so that intake events (SHED, BROWNOUT_CLAMPED) are
        # recorded under the id the caller looks up
        request_id = request_id or f"req-{next(self._req_counter)}"
        rank = class_rank(params.slo_class)       # junk class: ValueError
        if request_id in self.requests:
            raise ValueError(f"request {request_id} already exists")
        if self._slo is not None:
            # SLO intake policy, before tokenization so a shed costs
            # nothing: shed the classes the ladder turns away (retryable),
            # clamp batch max_tokens at level 2+; the gate reads the live
            # queue depth, not the last tick's
            self._slo._waiting = self.scheduler.num_waiting
            retry_after = self._slo.shed_retry_after(rank)
            if retry_after is not None:
                self.stats.requests_shed += 1
                self._slo.shed_total += 1
                self.flight.req_event(request_id, "SHED", slo_class=params.slo_class,
                                      level=self._slo.level, retry_after_s=retry_after)
                raise ShedError(
                    f"overloaded (brownout level {self._slo.level}): "
                    f"{params.slo_class} work is shed; retry in "
                    f"{retry_after:.0f}s", retry_after_s=retry_after)
            cap = self._slo.max_tokens_cap(rank)
            if cap is not None and params.max_tokens > cap:
                params = dataclasses.replace(params, max_tokens=cap)
                self.flight.req_event(request_id, "BROWNOUT_CLAMPED", max_tokens=cap,
                                      level=self._slo.level)
        caller_ids = prompt_token_ids is not None
        adapter_idx = None
        if adapter is not None:
            if not self._lora_names:
                raise ValueError(f"adapter {adapter!r} requested but no "
                                 "lora_modules are loaded")
            adapter_idx = self._lora_index.get(adapter)
            if adapter_idx is None:
                raise ValueError(f"unknown adapter {adapter!r}; loaded: "
                                 f"{self._lora_names}")
        if prompt_token_ids is None:
            if prompt is None:
                raise ValueError("need prompt or prompt_token_ids")
            prompt_token_ids = self.tokenizer.encode(prompt)
        prompt_token_ids = list(prompt_token_ids)
        if caller_ids and not all(
                isinstance(t, (int, np.integer))
                and 0 <= t < self.model_cfg.vocab_size for t in prompt_token_ids):
            raise ValueError("prompt token ids must be integers in [0, "
                             f"{self.model_cfg.vocab_size})")
        prompt_token_ids = [int(t) for t in prompt_token_ids]
        if params.truncate_prompt_tokens is not None:
            if params.truncate_prompt_tokens < 1:
                raise ValueError("truncate_prompt_tokens must be >= 1")
            prompt_token_ids = prompt_token_ids[-params.truncate_prompt_tokens:]
        if not prompt_token_ids:
            raise ValueError("empty prompt")
        if self.mesh is not None and self.mesh.multihost and params.multihost_unsupported():
            # several nodes: the JAX engine's intake refusal, kept (the API
            # edge 400s these first)
            raise ValueError(
                f"{', '.join(params.multihost_unsupported())} not "
                "supported in multi-host serving mode")
        if len(prompt_token_ids) >= self.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt_token_ids)} exceeds max sequence "
                f"length {self.max_seq_len} (min of cache capacity "
                f"{self.cache_cfg.max_model_len} and model position range "
                f"{self.model_cfg.max_position_embeddings})")
        if self._pp > 1:
            self._pp_prompt_budget(len(prompt_token_ids), params.max_tokens)
        acceptor = fsm = None
        if params.guided is not None:
            if params.guided not in ("json", "json_schema", "regex", "choice"):
                raise ValueError(f"unsupported guided mode {params.guided!r}"
                                 " (only 'json' / 'json_schema' / 'regex' / 'choice')")
            if params.logprobs is not None:
                # the substitution path replaces tokens after the logprobs
                # were taken: they would not match the emitted ones
                raise ValueError("logprobs cannot be combined with response_format")
            # the character acceptor first, so that a bad schema, pattern
            # or choice list raises its ValueError whether or not the FSM
            # then compiles
            acceptor = self._make_guided(params)
            fsm = self._fsm_for(params)
        req = Request(request_id=request_id, prompt_token_ids=prompt_token_ids,
                      params=params, prompt=prompt, deadline=deadline,
                      arrival_time=self.clock.monotonic(), adapter_idx=adapter_idx)
        try:
            self.scheduler.add(req)
        except MemoryError:
            # queue full: evict the loosest-class waiting request (a 429 to
            # ITS client) to seat a stricter arrival; with no such victim
            # the MemoryError (503) stands
            if not self._shed_queue_victim(rank):
                raise
            self.scheduler.add(req)
        if fsm is not None:
            self._guided_fsm[request_id] = [fsm, fsm.start]
            self.stats.guided_fsm_requests += 1
        elif acceptor is not None:
            self._guided[request_id] = acceptor
        self._detok[request_id] = IncrementalDetokenizer(self.tokenizer)
        self.requests[request_id] = req
        # max_tokens, so that a replay rebuilds the budget of requests the
        # recording never finished
        self.flight.req_event(request_id, "QUEUED", slo_class=params.slo_class,
                              prompt_tokens=len(prompt_token_ids),
                              max_tokens=params.max_tokens)
        self._assign_salt(request_id, params)
        if self._adaptive_window and (self.scheduler.running
                                      or self._pending_window is not None):
            # an arrival into a BUSY engine predicts more: the next windows
            # shrink so arrivals stop waiting out a full one.  Stamped only
            # once the scheduler accepted the request: a flood rejected by
            # a full queue must not pin the streams at min_multi_step.
            self._last_busy_arrival = self.clock.monotonic()
        self.stats.prompt_tokens += len(prompt_token_ids)
        return request_id

    def stop_followers(self) -> None:
        """Under a mesh, rank 0's stop to the follower ranks (once): they
        return from ``follower_loop``.  A no-op elsewhere."""
        if self._lockstep is not None:
            self._lockstep.stop()

    def _assign_salt(self, request_id: str, params: SamplingParams) -> None:
        """The salt of a sampled request's keys (salt, step): its stream
        depends on its seed alone, not on the batches, batch positions or
        windows it lands in.  Unseeded requests take the engine seed and a
        counter (the JAX engine hashes the request id, which Python salts
        anew in each process)."""
        if not params.greedy:
            seed = (params.seed if params.seed is not None
                    else self.config.seed * 1_000_003 + next(self._seed_counter))
            self._salts[request_id] = seed & 0xFFFFFFFF

    def adopt_prefilled(self, request_id: str, prompt_token_ids: Sequence[int],
                        first_token: int, params: SamplingParams, seq_kv: list,
                        guided_plan: Optional[Sequence[int]] = None) -> str:
        """Adopt a sequence prefilled by another engine or pod
        (``parallel/disagg.py``, ``disagg_net.py``), as the JAX engine's:
        allocate blocks, scatter the transferred KV pages into this cache
        (``disagg.insert_seq_kv``: the format check, then an in-place
        indexed copy), and drop the request straight into the running
        decode batch, with no recompute.

        ``seq_kv``: per-layer ``{key: pages}`` as ``disagg.extract_seq_kv``
        makes them (a power-of-two padded block count), tensors or numpy
        arrays.  The first token's text was emitted by the prefill side; it
        seeds the detokenizer here and is not emitted again.  A guided
        request takes the token-level FSM advanced by the first token, or,
        when the prefill side left the FSM for a committed canonical-suffix
        plan (``guided_plan``), the character acceptor fed the first
        token's text with that plan.  Raises ``MemoryError`` when the pool
        lacks blocks or a sequence slot (the server's 503), ``ValueError``
        on pages this cache cannot take (``disagg.check_seq_kv``: their
        format, layers and shapes).

        Under a tp / ep mesh rank 0 alone decides: every check above runs on
        it before any op goes out, so a refused migration raises there with
        one card's error and the followers go on serving.  Then, as on one
        card, the superseded tier entries drop and the evicted blocks demote
        (``OP_DROP``, ``OP_DEMOTE``), and each rank writes its heads of the
        whole pages (``_exec_adopt``)."""
        from tpuserve_torch.parallel.disagg import check_seq_kv
        prompt_token_ids = [int(t) for t in prompt_token_ids]
        if self._pp > 1:
            raise ValueError("KV adoption (disaggregation) is not supported on the "
                             "pipeline engine — the transferred per-layer pages don't "
                             "match a stage's cache")
        if request_id in self.requests:
            raise ValueError(f"request {request_id} already exists")
        if len(prompt_token_ids) >= self.max_seq_len:
            raise ValueError(f"prompt length {len(prompt_token_ids)} exceeds max "
                             f"sequence length {self.max_seq_len}")
        need = self.block_manager.blocks_needed(len(prompt_token_ids)) + 1
        if (need > self.block_manager.num_free_blocks
                or self.scheduler.num_running >= self.config.scheduler.max_num_seqs):
            raise MemoryError("decode pool at capacity")
        req = Request(request_id=request_id, prompt_token_ids=prompt_token_ids,
                      params=params, arrival_time=self.clock.monotonic())
        alloc = self.block_manager.allocate(request_id, prompt_token_ids)
        try:
            # between the allocate and the registration below a raise would
            # leak the blocks: nothing else could find them.  The pages are
            # checked against one card's geometry before any op goes out
            check_seq_kv(self.kv_cache, seq_kv, alloc.blocks, self._page_parts)
            self._drop_superseded_tier_entries(prompt_token_ids)
            # the allocate may have evicted cached blocks that the scatter
            # overwrites: demote them first
            self._demote_evicted()
            self._exec_adopt(alloc.blocks, seq_kv)
            req.output_token_ids.append(int(first_token))
            req.state = RequestState.RUNNING
            req.first_token_time = self.clock.monotonic()
            detok = IncrementalDetokenizer(self.tokenizer)
            first_text = detok.add(int(first_token))
            self._detok[request_id] = detok
            if params.guided is not None:
                fsm = self._fsm_for(params)
                if fsm is not None and not guided_plan:
                    ns = fsm.advance(fsm.start, int(first_token))
                    if ns >= 0:
                        self._guided_fsm[request_id] = [fsm, ns]
                        self.stats.guided_fsm_requests += 1
                if request_id not in self._guided_fsm:
                    st = self._make_guided(params)
                    try:
                        st.feed(first_text)
                        self._guided[request_id] = st
                        if guided_plan:
                            # keep emitting the plan the first token opened,
                            # or the partial rune in the context never
                            # completes
                            self._guided_plan[request_id] = [int(t) for t in guided_plan]
                    except ValueError:
                        pass                # already off-grammar: unconstrained
        except Exception:
            # the pages never fully landed: the blocks are suspect, kept
            # out of the prefix pool
            self.block_manager.free(request_id, cache_blocks=False)
            for d in (self._detok, self._guided, self._guided_fsm, self._guided_plan):
                d.pop(request_id, None)
            raise
        self._assign_salt(request_id, params)
        self.requests[request_id] = req
        self.flight.req_event(request_id, "QUEUED", migrated=True,
                              prompt_tokens=len(prompt_token_ids))
        self.flight.req_event(request_id, "ADMITTED", migrated=True)
        if self._adaptive_window and (self.scheduler.running
                                      or self._pending_window is not None):
            # a migration into a busy pool is an arrival
            self._last_busy_arrival = self.clock.monotonic()
        self.scheduler.running.append(req)
        self.stats.prompt_tokens += len(prompt_token_ids)
        return request_id

    def abort_request(self, request_id: str) -> bool:
        req = self.scheduler.abort(request_id)
        if req is None:
            # in neither queue: unknown, finished, or orphaned mid-dispatch
            req = self.requests.get(request_id)
            if req is None or req.finished:
                return False
            self.block_manager.free(request_id, cache_blocks=False)
        else:
            # a request mid-way through a chunked prefill (holding blocks
            # but not RUNNING) has blocks whose KV was never written:
            # parking them in the prefix cache would serve garbage to the
            # next identical prefix.  Once RUNNING, every prompt block is
            # written.
            partial = (req.state != RequestState.RUNNING
                       and req.num_prefilled > 0)
            self.block_manager.free(request_id, cache_blocks=not partial)
        req.state = RequestState.FINISHED
        req.finish_reason = FinishReason.ABORT
        self._release(request_id)
        self.flight.req_event(request_id, "FINISHED", cause="abort")
        return True

    def _expire_queued_deadlines(self) -> None:
        """Abort WAITING requests whose admission deadline has passed, as
        the JAX engine does: their client's timeout fails them anyway.
        Only requests with no progress expire: a preempted stream with
        delivered tokens or a prompt mid-chunk is work already paid for."""
        sched = self.scheduler
        if not sched.waiting:
            return
        now = self.clock.monotonic()
        expired = [r for r in sched.waiting
                   if r.deadline is not None and now > r.deadline
                   and r.state == RequestState.WAITING
                   and r.num_prefilled == 0 and not r.output_token_ids]
        for r in expired:
            self.abort_request(r.request_id)
            self._error_outbox.append((r.request_id, TimeoutError(
                "request deadline expired before admission (engine "
                "overloaded); aborted queue-side")))

    def drain_request_errors(self) -> list:
        """(rid, exception) pairs for queued requests the engine ended
        itself (deadline expiry, queue-full eviction); the runner fails
        their clients."""
        out, self._error_outbox = self._error_outbox, []
        return out

    # ---- overload (runtime/slo.py) ------------------------------------

    def _shed_queue_victim(self, rank: int) -> bool:
        """Queue-full class eviction: abort the tail-most waiting request
        of a class strictly looser than ``rank`` that has no prefill
        progress and no output (that work is paid for), and answer its
        client with a retryable ShedError through the error outbox."""
        if self._slo is None:
            return False
        for victim in reversed(self.scheduler.waiting):
            if (class_rank(victim.params.slo_class) > rank
                    and victim.num_prefilled == 0
                    and not victim.output_token_ids
                    and victim.state == RequestState.WAITING):
                self.flight.req_event(victim.request_id, "SHED",
                                      cause="queue_full_eviction")
                self.abort_request(victim.request_id)
                self.stats.requests_shed += 1
                self._slo.shed_total += 1
                ra = self._slo.cfg.shed_retry_after_s
                self._error_outbox.append((victim.request_id, ShedError(
                    "shed from a full queue for higher-priority "
                    f"admission; retry in {ra:.0f}s", retry_after_s=ra)))
                return True
        return False

    def _slo_preempt_for_admission(self) -> list[RequestOutput]:
        """Priority preemption, as the JAX engine's: when the waiting head
        is of a stricter class than running rows and cannot be admitted for
        seats or blocks, preempt the loosest-class most recent running rows
        (bounded a cycle and by each victim's budget) through the
        token-identical re-prefill path.  Both in-flight dispatches are
        flushed first: a victim with tokens in flight would append them
        twice at its replay."""
        slo, sched = self._slo, self.scheduler
        if slo is None or not sched.waiting or not sched.running:
            return []
        head = sched.waiting[0]
        if head.state == RequestState.RESTORING:
            return []
        rank = class_rank(head.params.slo_class)
        budget = slo.cfg.preempt_budget

        def victims():
            # loosest class first, the most recent admission breaking ties
            return [r for _, _, r in sorted(
                (class_rank(r.params.slo_class), i, r)
                for i, r in enumerate(sched.running)
                if class_rank(r.params.slo_class) > rank
                and r.num_preemptions < budget)]

        def shortfall() -> bool:
            # the head's own admission arithmetic: preempting when it would
            # be admitted anyway burns a re-prefill for nothing; only the
            # mixed path charges a slot a decode row against the free pool
            seats = len(sched.running) >= sched.cfg.max_num_seqs
            need = self.block_manager.blocks_needed(head.num_tokens) + 1
            headroom = len(sched.running) if sched.cfg.mixed_batching else 0
            return seats or need > self.block_manager.num_free_blocks - headroom

        if not victims() or not shortfall():
            return []
        outputs = self._flush_pending() + self._flush_window()
        for _ in range(slo.cfg.max_preempt_per_cycle):
            cand = victims()
            if not cand or not shortfall():
                break
            sched.preempt_for_class(cand[-1])       # most recent loosest row
            self.stats.preemptions += 1
            self.stats.slo_preemptions += 1
        return outputs

    # ---- crash-only salvage (server/runner.py) ------------------------

    def salvage_requeue(self) -> list[str]:
        """Crash-only salvage after a faulted or stuck step, as the JAX
        engine's: drop both in-flight dispatches and re-queue every live
        request through the preemption re-prefill path.  A request keeps
        its prompt and its emitted tokens, so greedy and seeded replays
        continue token-identically (a row's sampling key is its salt and
        the count of tokens it has sampled; a guided row's host state
        mirrors the tokens it emitted; penalty buffers are rebuilt from
        the history before every replay).  Freed blocks are NOT parked in
        the prefix cache (``cache_blocks=False``): a faulted dispatch
        leaves their contents suspect.

        A dropped window may still run on the card: its KV writes land in
        blocks freed here, before any later dispatch that reuses them
        (one stream, in order), and its pinned host output buffers return
        to the caching host allocator only once its copy has run.  Tier
        restores in flight stay (``has_work`` counts them; their requests
        wait in the queue, RESTORING, and are not re-queued again).

        Also rescues the requests a fault orphaned: a prefill batch or a
        chunk is popped from the waiting queue before its dispatch and
        marked running only after it.  Returns the re-queued request ids,
        queue head first."""
        self._pending = None
        self._pending_window = None
        cohort = list(self.scheduler.running)
        self.scheduler.running.clear()
        seen = ({r.request_id for r in cohort}
                | {r.request_id for r in self.scheduler.waiting})
        cohort += [r for r in self.requests.values()
                   if not r.finished and r.request_id not in seen]
        for r in cohort:
            self.block_manager.free(r.request_id, cache_blocks=False)
            r.state = RequestState.PREEMPTED
            r.num_prefilled = 0
            self.flight.req_event(r.request_id, "SALVAGED",
                                  output_tokens=len(r.output_token_ids))
        for r in self.scheduler.waiting:
            if r.num_prefilled > 0:
                # a prompt mid-chunk holds blocks whose KV is suspect too
                self.block_manager.free(r.request_id, cache_blocks=False)
                r.num_prefilled = 0
        for r in reversed(cohort):
            self.scheduler.waiting.appendleft(r)
        return [r.request_id for r in cohort]

    def _release(self, request_id: str) -> None:
        """Drop a finished or aborted request's host state (a preempted one
        keeps it: its re-prefill continues the same stream)."""
        self._detok.pop(request_id, None)
        self._salts.pop(request_id, None)
        self._guided.pop(request_id, None)
        self._guided_fsm.pop(request_id, None)
        self._guided_plan.pop(request_id, None)

    def has_work(self) -> bool:
        # a dispatch still in flight is work: its tokens are not emitted
        # yet; so is a tier restore, which must reach its commit even if
        # every request was aborted, or its blocks would stay claimed
        return (self.scheduler.has_work() or self._pending is not None
                or self._pending_window is not None or bool(self._restores))

    # ------------------------------------------------------------------
    # Step
    # ------------------------------------------------------------------

    def step(self) -> list[RequestOutput]:
        """Run one engine iteration: one prefill batch, one prefill chunk,
        one mixed step, or one decode dispatch (a fused window or a single
        step).  Queued requests past their deadline leave first; with the
        tiers on, last cycle's restores commit and new ones begin before
        scheduling.  Under ``TPUSERVE_STRICT_BLOCKS`` every cycle then
        cross-checks the block and tier accounting.  With the flight
        recorder on, each successful cycle leaves a step record and the
        control scalars."""
        t_cycle = self.clock.monotonic()
        outputs = self._step_inner()
        if self._flight_on:
            dispatched = bool(self._dispatch_rids)
            self.flight.note_step(
                self._step_kind, len(self._dispatch_rids),
                self.stats.step_actual_tokens if dispatched else 0,
                self.stats.step_padded_tokens if dispatched else 0,
                self.clock.monotonic() - t_cycle)
        if self._slo is not None:
            # the estimator's tick once a successful cycle drives the
            # ladder; the level is mirrored into stats for the gauge
            self._slo.tick(self.scheduler.num_waiting)
            self.stats.brownout_level = self._slo.level
        if self._flight_on:
            # the level and per-class delay EWMAs as plain numbers, and the
            # queue depths even with the classes off
            self.flight.note_control(
                **(self._slo.snapshot() if self._slo is not None
                   else {"brownout_level": 0}),
                waiting=self.scheduler.num_waiting,
                running=len(self.scheduler.running))
        if self._strict_blocks:
            self._check_block_integrity()
        return outputs

    def _check_block_integrity(self) -> None:
        chk = getattr(self.block_manager, "check_integrity", None)
        if chk is None:              # the C++ manager: no introspection
            return
        holders = {r.request_id for r in self.scheduler.running}
        holders |= {r.request_id for r in self.scheduler.waiting if r.num_prefilled > 0}
        tier_hashes = (list(self._kv_tiers.hashes())
                       if self._kv_tiers is not None else None)
        chk(expected_seq_ids=holders, tier_hashes=tier_hashes)

    def _step_inner(self) -> list[RequestOutput]:
        self._dispatch_rids = ()
        self._step_kind = "idle"
        PROF.bump_cycle()
        self.devprof.bump_cycle()
        # before scheduling: deadline-expired queued requests leave, and a
        # stricter-class waiting head may preempt running batch rows
        self._expire_queued_deadlines()
        pre = self._slo_preempt_for_admission()
        if self._kv_tiers is not None:
            # commit FIRST: last cycle's restored prefixes become the card's
            # prefix entries, so their requests admit THIS cycle with the
            # restored span as shared blocks; then start new restores,
            # whose copies overlap the step dispatched below
            self._commit_tier_restores()
            self._begin_tier_restores()
        with PROF.phase("schedule"):
            batch = self.scheduler.schedule()
        if batch is None:
            # nothing schedulable, but a decode result may be in flight
            return pre + self._flush_pending() + self._flush_window()
        t0 = self.clock.monotonic()
        if batch.kind == "prefill":
            outputs = self._run_prefill(batch)
        elif batch.kind == "prefill_chunk":
            outputs = self._run_prefill_chunk(batch)
        elif batch.kind == "mixed":
            outputs = self._run_mixed(batch)
        elif batch.kind == "decode" and self._spec_eligible(batch.requests):
            # sampled batches speculate too: rejection-sampling acceptance
            # runs on the device (decode_verify_sampled)
            outputs = self._run_decode_spec(batch)
        elif batch.kind == "decode":
            if self._multi_step > 1:
                outputs = self._run_decode_multi(batch)
            else:
                outputs = self._run_decode(batch)
        else:
            raise RuntimeError(f"unexpected batch kind {batch.kind!r}")
        self.stats.last_step_time = self.clock.monotonic() - t0
        self._release_window_blocks()
        return pre + outputs

    def _release_window_blocks(self) -> None:
        """Sliding-window rolling buffer, after every dispatch (a spec
        step's too): blocks whose every position fell behind the attention
        window go back to the pool, so a windowed model's cache footprint
        scales with the WINDOW, not the context.  Safe against work in
        flight on the card: one stream runs the dispatches in order, so a
        reuse of a released block comes after the steps that attended it."""
        W = self.model_cfg.sliding_window
        if not W or not self.config.window_release:
            return
        if not self.model_cfg.uniform_window:
            # mixed-layer models (Gemma-2's alternation, Gemma-3's 5:1)
            # keep full-attention layers that need every position's KV
            return
        bm = self.block_manager
        for r in self.scheduler.running:
            self.stats.released_blocks += bm.release_out_of_window(
                r.request_id, max(0, r.num_tokens - W))
        for r in self.scheduler.waiting:
            # mid-chunk long prompts free their tail-window backlog too
            if r.num_prefilled > 0:
                self.stats.released_blocks += bm.release_out_of_window(
                    r.request_id, max(0, r.num_prefilled - W))

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _stage_adapters(self, st, reqs: list[Request], rows=None) -> None:
        """Each request's adapter index into ``st.adapter`` (a LoRA stack
        only; -1, the staging's fill, is the base model and padding):
        request i at row i, or at ``rows[i]`` (a row or a slice)."""
        if not self._lora_names:
            return
        for i, r in enumerate(reqs):
            if r.adapter_idx is not None:
                st.adapter[i if rows is None else rows[i]] = r.adapter_idx

    def _run_prefill(self, batch: ScheduledBatch) -> list[RequestOutput]:
        reqs = batch.requests
        self._dispatch_rids = tuple(r.request_id for r in reqs)
        self._step_kind = "prefill"
        L = batch.padded_len
        B = next_power_of_2(len(reqs))
        exe = self._exec_get("prefill", B, L)
        st = exe.stage()
        for i, req in enumerate(reqs):
            ids = self._prefill_tokens(req)
            self.faults.check("kv_alloc", (req.request_id,))
            shared, _cached = self.block_manager.lookup_prefix(ids)
            self.block_manager.allocate(req.request_id, ids, shared_blocks=shared)
            self._drop_superseded_tier_entries(ids)
            st.tokens[i, :len(ids)] = ids
            st.prompt_lens[i] = len(ids)
            st.slot_ids[i, :len(ids)] = self._token_slots(req.request_id, 0, len(ids))
            if self._flight_on:
                self.flight.req_event(req.request_id, "PREFILL", tokens=len(ids),
                                      replay=bool(req.output_token_ids))
        self._stage_adapters(st, reqs)
        self._demote_evicted()
        self.faults.check("prefill_dispatch", self._dispatch_rids)
        with PROF.phase("dispatch"), self.devprof.dispatch("prefill", exe.key):
            self._exec_run(exe, st)
        self.scheduler.mark_running(reqs)
        self.stats.num_prefill_steps += 1
        self._note_step_tokens(int(st.prompt_lens[:len(reqs)].sum()), B * L)
        new_tokens = self._sample(exe.logits, reqs, B)
        self._first_token(reqs)
        with PROF.phase("detokenize"):
            return [self._emit_one(r, int(t), from_prefill=True)
                    for r, t in zip(reqs, new_tokens)]

    @staticmethod
    def _prefill_tokens(req: Request) -> list[int]:
        """Tokens to prefill: the prompt plus, after a preemption,
        everything generated so far (the cache was dropped)."""
        return req.prompt_token_ids + req.output_token_ids

    def _token_slots(self, request_id: str, start: int, n: int,
                     block_table=None) -> np.ndarray:
        """Flat cache slots of token indices [start, start + n); pass
        ``block_table`` when the caller already fetched it."""
        bs = self.cache_cfg.block_size
        if n:
            # a window-released entry reads as block 0, someone else's: the
            # manager raises for a write there (released blocks lead the
            # table, so the first token's block decides)
            self.block_manager.slot_for_token(request_id, start)
        if block_table is None:
            block_table = self.block_manager.block_table(request_id)
        bt = np.asarray(block_table, np.int64)
        t = np.arange(start, start + n)
        return (bt[t // bs] * bs + t % bs).astype(np.int32)

    def _note_step_tokens(self, actual: int, padded: int) -> None:
        """One dispatch's real and padded token counts, one home for every
        dispatch kind; the padding waste feeds the overload estimator."""
        self.stats.step_actual_tokens = actual
        self.stats.step_padded_tokens = padded
        self.stats.actual_tokens_total += actual
        self.stats.padded_tokens_total += padded
        if self._slo is not None:
            self._slo.note_step(actual, padded)

    def _first_token(self, reqs: list[Request]) -> None:
        """Record TTFT for requests sampling their first token (not a
        re-prefill after preemption)."""
        now = self.clock.monotonic()
        for req in reqs:
            if req.first_token_time is None:
                req.first_token_time = now
                self.stats.ttft_sum += now - req.arrival_time
                self.stats.ttft_count += 1

    def _run_prefill_chunk(self, batch: ScheduledBatch) -> list[RequestOutput]:
        """One fixed-size chunk of a long or prefix-hit prompt against the
        cache.  The first chunk allocates and starts at the prefix cache's
        cached offset (the shared blocks already hold that KV, so it is not
        recomputed).  The request re-enters the head of the waiting queue
        until its last chunk, which samples the first token."""
        req = batch.requests[0]
        self._dispatch_rids = (req.request_id,)
        self._step_kind = "prefill_chunk"
        C = batch.padded_len
        ids = self._prefill_tokens(req)
        if req.num_prefilled == 0:
            self.faults.check("kv_alloc", (req.request_id,))
            shared, cached = self.block_manager.lookup_prefix(ids)
            self.block_manager.allocate(req.request_id, ids, shared_blocks=shared)
            self._drop_superseded_tier_entries(ids)
            req.num_prefilled = cached
        done = req.num_prefilled
        n = len(ids[done:done + C])
        if self._flight_on:
            self.flight.req_event(req.request_id, "PREFILL_CHUNK", done=done, tokens=n,
                                  total=len(ids))
        exe = self._exec_get("chunk", C)
        st = exe.stage()
        st.tokens[0, :n] = ids[done:done + n]
        bt = self.block_manager.block_table(req.request_id)
        st.slot_ids[0, :n] = self._token_slots(req.request_id, done, n, block_table=bt)
        st.block_tables[0, :len(bt)] = bt
        st.ctx_lens[0], st.chunk_lens[0] = done, n
        self._stage_adapters(st, [req])
        self._demote_evicted()
        self.faults.check("prefill_dispatch", self._dispatch_rids)
        with PROF.phase("dispatch"), self.devprof.dispatch("prefill_chunk", exe.key):
            self._exec_run(exe, st)
        req.num_prefilled = done + n
        self.stats.num_prefill_steps += 1
        self.stats.num_chunk_steps += 1
        self._note_step_tokens(n, C)
        if req.num_prefilled < len(ids):
            self.scheduler.waiting.appendleft(req)      # more chunks to go
            return []
        self.scheduler.mark_running([req])
        new_tokens = self._sample(exe.logits, [req], 1)
        self._first_token([req])
        with PROF.phase("detokenize"):
            return [self._emit_one(req, int(new_tokens[0]), from_prefill=True)]

    def _run_mixed(self, batch: ScheduledBatch) -> list[RequestOutput]:
        """One mixed step: every running stream's decode row plus the
        scheduled prefill-chunk rows as ONE flat stream through
        ``transformer.forward_ragged``, so decode streams get a token on
        every cycle while prompts are admitted.

        Layout (the ragged kernel's contract, ops/ragged_paged.py): decode
        rows first (flat row = sequence index), the decode region padded
        to the ragged block, each prefill chunk starting block-aligned;
        sequences ordered decode, completing chunks, continuing chunks, so
        the rows that sample a token this step form a prefix.  Both
        pipelined dispatches are flushed first: the step reads every
        decode row's last token on the host."""
        outputs = self._flush_pending() + self._flush_window()
        self._step_kind = "mixed"
        decode_reqs, slots, _ = self._charge_decode_rows(
            [r for r in batch.requests if not r.finished])
        bm = self.block_manager
        # prefill chunks: a first chunk allocates (with the prefix-cache
        # compute skip); one whose blocks no longer fit goes back to the head
        chunks = []                       # (req, ids, done, take)
        for req, n in batch.prefill_chunks:
            ids = self._prefill_tokens(req)
            if req.num_prefilled == 0:
                self.faults.check("kv_alloc", (req.request_id,))
                try:
                    shared, cached = bm.lookup_prefix(ids)
                    bm.allocate(req.request_id, ids, shared_blocks=shared)
                except MemoryError:
                    self.scheduler.waiting.appendleft(req)
                    continue
                self._drop_superseded_tier_entries(ids)
                req.num_prefilled = cached
            done = req.num_prefilled
            take = min(n, len(ids) - done)
            chunks.append((req, ids, done, take))
            if self._flight_on:
                self.flight.req_event(req.request_id, "PREFILL_CHUNK", done=done, tokens=take,
                                      total=len(ids), mixed=True)
        if not decode_reqs and not chunks:
            return outputs
        self._dispatch_rids = tuple([r.request_id for r in decode_reqs]
                                    + [c[0].request_id for c in chunks])
        comp = [c for c in chunks if c[2] + c[3] == len(c[1])]
        cont = [c for c in chunks if c[2] + c[3] < len(c[1])]
        blk = self._ragged_blk
        n_dec = len(decode_reqs)
        starts, T, meta, blk_seq = ragged_layout(
            n_dec, [c[3] for c in comp + cont], blk)
        B = self._ragged_seqs
        exe = self._exec_get("mixed", T)
        st = exe.stage()
        dec = np.arange(n_dec)
        for i, r in enumerate(decode_reqs):
            st.tokens[i] = r.output_token_ids[-1]
            st.kv_lens[i] = r.num_tokens
        st.positions[:n_dec] = st.kv_lens[:n_dec] - 1
        st.slot_ids[:n_dec] = slots
        st.row_seq[:n_dec] = st.q_starts[:n_dec] = st.last_rows[:n_dec] = dec
        st.q_lens[:n_dec] = 1
        if self._flight_on and decode_reqs:
            self.flight.req_event_many(tuple(r.request_id for r in decode_reqs), "WINDOW",
                                       steps=1, mixed=True)
        with PROF.phase("block"):
            bm.fill_block_tables([r.request_id for r in decode_reqs], st.block_tables)
        for si, ((req, ids, done, take), start) in enumerate(
                zip(comp + cont, starts), start=n_dec):
            rows = slice(start, start + take)
            st.tokens[rows] = ids[done:done + take]
            st.positions[rows] = done + np.arange(take)
            bt = bm.block_table(req.request_id)
            st.slot_ids[rows] = self._token_slots(req.request_id, done, take, block_table=bt)
            st.row_seq[rows] = si
            st.kv_lens[si] = done + take
            st.q_starts[si] = start
            st.q_lens[si] = take
            st.last_rows[si] = start + take - 1
            st.block_tables[si, :len(bt)] = bt
        st.meta[:], st.blk_seq[:] = meta, blk_seq
        # each valid row its sequence's adapter; padding rows stay -1 (the
        # base model), not sequence 0's through row_seq
        self._stage_adapters(st, decode_reqs)
        self._stage_adapters(st, [c[0] for c in comp + cont],
                             [slice(s, s + c[3]) for c, s in zip(comp + cont, starts)])
        self._demote_evicted()
        self.faults.check("mixed_dispatch", self._dispatch_rids)
        with PROF.phase("dispatch"), self.devprof.dispatch("mixed", exe.key):
            self._exec_run(exe, st)
        self.stats.num_mixed_steps += 1
        if decode_reqs:
            self.stats.num_decode_steps += 1
        if chunks:
            self.stats.num_prefill_steps += 1
        self._note_step_tokens(n_dec + sum(c[3] for c in chunks), T)
        # chunk progress, continuations back to the head, completions to
        # running, all before emit (a finish removes from running)
        for req, _, done, take in chunks:
            req.num_prefilled = done + take
        for req, _, _, _ in reversed(cont):
            self.scheduler.waiting.appendleft(req)
        comp_reqs = [c[0] for c in comp]
        self.scheduler.mark_running(comp_reqs)
        emit = decode_reqs + comp_reqs
        if not emit:
            return outputs
        new_tokens = self._sample(exe.logits, emit, B)
        self._first_token(comp_reqs)
        with PROF.phase("detokenize"):
            return (outputs
                    + [self._emit_one(r, int(t)) for r, t in zip(decode_reqs, new_tokens)]
                    + [self._emit_one(r, int(t), from_prefill=True)
                       for r, t in zip(comp_reqs, new_tokens[n_dec:])])

    def _salt(self, req: Request) -> int:
        return self._salts.get(req.request_id, 0)

    # ---- device work ----------------------------------------------------
    # Every executable the engine makes or runs, and every cache-less trunk,
    # goes through these hooks: under a mesh, rank 0 mirrors each one to the
    # follower ranks before it runs it (parallel/multihost.py), so every
    # rank enters the same step and its collectives.  The JAX engine's AST
    # guard has its counterpart in tests/test_torch_multihost.py: no other
    # method of the engine runs one.

    def _exec_get(self, *key):
        """The executable of ``key``, made (on the card: captured) on first
        use on every rank."""
        if self._lockstep is not None and key not in self.graphs.executables:
            self._lockstep.make(key)
        return self.graphs.get(*key)

    def _exec_run(self, exe, st, steps: int = 1, *, chain=None, extras=None, grammar=None,
                  eager: bool = False):
        """Load the staging ``st`` into ``exe``'s buffers (a decode
        executable: with ``chain``, ``DecodeExecutable.load``), build the
        penalties' buffers from ``extras`` (``load_extras``' five arrays),
        load a grammar's tables (``grammar``: ``StepGraphs.load_grammar``'s
        arguments), then run ``steps`` steps; with ``eager`` run one step
        eagerly and return its logits.  The followers get a grammar's
        tables only when they load here (a new grammar in the bucket)."""
        if self._lockstep is not None:
            tables = None
            if grammar is not None and not self.graphs.grammar_loaded(*grammar[:2]):
                tables = (grammar[0], *(tuple(grammar[2:]) + (None, None))[:3])
            self._lockstep.run(exe.key, st, 0 if eager else steps, extras, tables)
        if isinstance(exe, DecodeExecutable):
            exe.load(st, chain=chain)
        else:
            exe.load(st)
        if extras is not None:
            exe.load_extras(*extras)
        if grammar is not None:
            self.graphs.load_grammar(*grammar)
        if eager:
            return exe.step()
        exe.run(steps)
        if self._lockstep is not None:
            self._lockstep.after_run(exe, steps)
        return None

    def _exec_warmup(self, keys) -> None:
        """Make every executable of ``keys`` (``StepGraphs.warmup``) on
        every rank, in one order."""
        if self._lockstep is not None:
            self._lockstep.warmup(keys)
        self.graphs.warmup(keys)

    def _exec_embed(self, tokens: np.ndarray, lens: np.ndarray, pooling: str) -> np.ndarray:
        """One batch of the embeddings trunk, on the host (every rank runs
        it on its slice; rank 0 reads it)."""
        if self._lockstep is not None:
            self._lockstep.trunk("embed", tokens, lens, pooling=pooling)
        return transformer.embed_forward(
            self.params, self.model_cfg, self._tensor(tokens), self._tensor(lens),
            pooling=pooling, attn_impl=self.attn_impl).cpu().numpy()

    def _exec_score(self, tokens: np.ndarray, lens: np.ndarray, top_n: int) -> tuple:
        """One batch of the scoring trunk: (chosen, ranks, top ids, top
        logprobs) on the host."""
        if self._lockstep is not None:
            self._lockstep.trunk("score", tokens, lens, top_n=top_n)
        return tuple(x.cpu().numpy() for x in transformer.score_prompt(
            self.params, self.model_cfg, self._tensor(tokens), self._tensor(lens),
            top_n=top_n, attn_impl=self.attn_impl))

    # The tiered KV cache's page copies (runtime/kv_tiers.py): rank 0's block
    # manager decides, and each rank files its own slice of the pages.

    def _exec_demote(self, blocks: list, hashes: list) -> None:
        """Gather ``blocks``' pages into the tier store under ``hashes``."""
        if self._lockstep is not None:
            self._lockstep.demote(blocks, hashes)
        pages = gather_block_pages(self.kv_cache, blocks, self._staging())
        for h, p in zip(hashes, pages):
            self._kv_tiers.put(h, p)

    def _exec_restore(self, span: list) -> list:
        """Take ``span``'s pages out of the tier store up to the first it
        cannot read (an unreadable spill entry mid-chain: only the intact
        prefix is restored).  Under a mesh every rank takes its own, they
        agree on the shortest intact prefix, and each drops the span's
        hashes past it, so that every store keeps the same hashes."""
        store = self._kv_tiers
        pages = []
        for h in span:
            p = store.take(h)
            if p is None:
                break
            pages.append(p)
        if self.mesh is not None and self.mesh.world > 1:
            n = (self._lockstep.restore(span, len(pages)) if self._lockstep is not None
                 else agree_min(self.mesh.ctrl_group, len(pages)))
            for h in span[n:]:
                store.drop(h)
            pages = pages[:n]
        return pages

    def _exec_scatter(self, blocks: list, pages: list) -> None:
        """Write restored pages into ``blocks`` in place."""
        if self._lockstep is not None:
            self._lockstep.scatter(blocks)
        scatter_block_pages(self.kv_cache, blocks, pages, self._staging())

    def _exec_drop(self, hashes: list) -> None:
        """Drop superseded tier store entries."""
        if self._lockstep is not None:
            self._lockstep.drop(hashes)
        for h in hashes:
            self._kv_tiers.drop(h)

    # A migration's page copies (parallel/disagg.py, disagg_net.py): rank 0
    # holds or wants one card's whole pages, and each rank writes or reads
    # its own heads of them (sharding.cut_pages, join_pages).

    def _exec_adopt(self, blocks: list, seq_kv: list) -> None:
        """Write a migration's pages into ``blocks`` in place.  Under a mesh
        rank 0 is given one card's whole pages and sends each rank its
        heads (``OP_ADOPT``); a follower is given the slice it received."""
        from tpuserve_torch.parallel.disagg import insert_seq_kv
        if self._lockstep is not None:
            whole = [{k: torch.as_tensor(v).cpu() for k, v in layer.items()}
                     for layer in seq_kv]
            seq_kv = self._lockstep.adopt(blocks, whole, self.kv_cache, self._page_parts)
        insert_seq_kv(self.kv_cache, seq_kv, blocks)

    def _exec_extract(self, blocks: list) -> list:
        """``blocks``' pages on the host (``disagg.extract_seq_kv``: a
        power-of-two padded count).  Under a mesh every rank gathers its
        heads and rank 0 joins them into one card's pages (``OP_EXTRACT``);
        a follower returns its own."""
        from tpuserve_torch.parallel.disagg import extract_seq_kv
        mine = [{k: t.cpu() for k, t in layer.items()}
                for layer in extract_seq_kv(self.kv_cache, blocks)]
        if self._lockstep is None or self._page_parts == 1:
            return mine
        n = mine[0]["k"].shape[0]
        bufs = self._lockstep.extract(blocks, pack_pages(mine, self.kv_cache))
        return join_pages([unpack_pages(b, self.kv_cache, n)
                           for b in bufs[:self._page_parts]])

    def _exec_handoff(self, src: "Engine", src_blocks: list, dst_blocks: list,
                      device=None) -> list:
        """Copy a sequence's pages from ``src``'s cache (the in-process
        pair's prefill engine) into this cache's ``dst_blocks`` on the card
        (``device``: this cache's, when ``src`` is on another).  Under a
        mesh every rank copies its own heads (``OP_HANDOFF``), after rank 0
        checked the pools' formats.  Returns the pages moved."""
        from tpuserve_torch.parallel.disagg import (check_kv_format, extract_seq_kv,
                                                    insert_seq_kv)
        if self._lockstep is not None:
            check_kv_format(self.kv_cache, src.kv_cache)
            self._lockstep.handoff(src._lockstep.tag, src_blocks, dst_blocks)
        seq_kv = extract_seq_kv(src.kv_cache, src_blocks)
        insert_seq_kv(self.kv_cache, seq_kv, dst_blocks, device=device)
        return seq_kv

    def _agree_spill_entries(self) -> None:
        """At start under a mesh: keep only the spill entries every rank's
        store adopted from an earlier run, so that every rank holds the
        same hashes (a file one rank lacks is dropped on all)."""
        import torch.distributed as dist
        store = self._kv_tiers
        mine = list(store.hashes())
        every = [None] * self.mesh.world
        dist.all_gather_object(every, mine, group=self.mesh.ctrl_group)
        common = set(mine).intersection(*map(set, every))
        for h in mine:
            if h not in common:
                store.drop(h)

    # ---- sampling -----------------------------------------------------

    MAX_LOGPROBS = MAX_LOGPROBS

    def _sample(self, logits: torch.Tensor, reqs: list[Request],
                B: int) -> np.ndarray:
        """The synchronous sampler of the prefill, chunk and mixed steps, as
        the JAX ``_sample``: penalties from each row's history, bias, the
        ``min_tokens`` floor, each FSM row's grammar mask, then the
        cheapest mode covering the rows, with each row's key (salt, tokens
        it has sampled so far), as the decode executables step it; logprobs
        of the logits sampled from (before temperature) are recorded for
        the rows that asked; substitution-path rows get their token
        checked and, where illegal, replaced on the host."""
        with self.devprof.dispatch("sample"):
            toks, logits = self._exec_sample(logits, reqs, B)
        n = len(reqs)
        with PROF.phase("flush"), self.devprof.sync("sample"):
            # the synchronous sampler's one wait on the card
            toks_np = toks.cpu().numpy()[:n].copy()
        if any(r.params.logprobs is not None for r in reqs):
            top_n = min(max(r.params.logprobs or 0 for r in reqs) or 1, self.MAX_LOGPROBS)
            chosen, ids, lps = (x.cpu().numpy() for x in
                                sampling_ops.compute_logprobs(logits, toks, top_n))
            for i, r in enumerate(reqs):
                if r.params.logprobs is not None:
                    self._append_logprob_entry(r, int(toks_np[i]), chosen[i], ids[i], lps[i])
        if any(r.request_id in self._guided for r in reqs):
            self._apply_guided(logits, toks_np, reqs)
        return toks_np

    def _exec_sample(self, logits: torch.Tensor, reqs: list[Request], B: int) -> tuple:
        """``_sample``'s device part: the (B,) sampled tokens on the card and
        the logits they were sampled from (after penalties, bias, floor
        and mask).  Under a mesh it runs on rank 0 alone: every rank holds
        the step's whole gathered logits, so no collective is left to mirror
        (the JAX lockstep mirrors its sampler, a jit over mesh-global
        logits)."""
        V = logits.shape[1]
        t = self._tensor
        if any(r.params.needs_penalties for r in reqs):
            out_tokens, mask, presence, frequency, repetition = self._penalty_arrays(reqs, B)
            logits = sampling_ops.apply_logit_penalties(
                logits, t(out_tokens), t(mask), t(presence), t(frequency), t(repetition))
        if any(r.params.needs_logit_bias for r in reqs):
            ids, vals = self._logit_bias_arrays(reqs, B, V)
            logits = sampling_ops.apply_logit_bias(logits, t(ids), t(vals))
        if any(self._floor_active(r) for r in reqs):
            ids, vals, _ = self._min_tokens_arrays(reqs, B, V)
            logits = sampling_ops.apply_logit_bias(logits, t(ids), t(vals))
        if any(r.request_id in self._guided_fsm for r in reqs):
            logits = self._apply_fsm_mask(logits, reqs, B)
        mode = self._sample_mode(reqs)
        if mode == "greedy":
            toks = sampling_ops.sample_tokens(logits, mode="greedy")
        else:
            temperature = np.zeros((B,), np.float32)
            salt = np.zeros((B,), np.int64)
            step = np.zeros((B,), np.int64)
            for i, r in enumerate(reqs):
                temperature[i] = r.params.temperature
                salt[i] = self._salt(r)
                step[i] = len(r.output_token_ids)
            top_k, top_p, min_p = self._truncation_arrays(reqs, B)
            toks = sampling_ops.sample_tokens(
                logits, t(temperature), mode=mode,
                gumbel=lambda: sampling_ops.keyed_gumbel(t(salt), t(step), V),
                top_k=t(top_k), top_p=t(top_p), min_p=t(min_p))
        return toks, logits

    # ---- guided decoding ------------------------------------------------

    GUIDED_TOP_K = 32
    MAX_FSM_CACHE = 64

    @staticmethod
    def _make_guided(params: SamplingParams):
        """The character-level acceptor of the request's spec: JSON,
        schema-constrained JSON (the compiled schema travels as JSON text
        in ``guided_schema``), a regex or a choice list."""
        if params.guided == "json_schema":
            return SchemaJsonStateMachine(compile_schema(json.loads(params.guided_schema)))
        if params.guided == "regex":
            return RegexStateMachine(compile_regex(params.guided_schema))
        if params.guided == "choice":
            return ChoiceStateMachine(compile_choices(json.loads(params.guided_schema)))
        return JsonStateMachine()

    def _fsm_for(self, params: SamplingParams):
        """The token-level FSM of the request's spec, compiled once per
        (mode, spec) and memoised, or None when ``guided_fsm`` is off or
        the spec cannot be bounded (the request then runs the substitution
        path; failures are memoised too).  With a cache directory
        (``TPUSERVE_FSM_CACHE_DIR``, else beside the checkpoint) a
        compiled FSM is loaded from or saved to disk, keyed by the spec
        and the tokenizer's fingerprint, as the JAX engine's."""
        if not self.config.guided_fsm:
            return None
        key = (params.guided, params.guided_schema)
        if key in self._fsm_cache:
            self._fsm_stats["hits"] += 1
            return self._fsm_cache[key]
        self._fsm_stats["misses"] += 1
        disk_dir = grammar.resolve_cache_dir(self.config.checkpoint_dir)
        if disk_dir is not None:
            if self._fsm_tok_fp is None:
                self._fsm_tok_fp = grammar.tokenizer_fingerprint(
                    self.tokenizer, self.model_cfg.vocab_size, self._eos_ids)
            fsm = grammar.load_fsm(disk_dir, params.guided, params.guided_schema,
                                   self._fsm_tok_fp)
            if fsm is not None:
                self._fsm_stats["disk_hits"] += 1
                self._memoise_fsm(key, fsm)
                return fsm
        if self._fsm_texts is None:
            # token id -> standalone text depends on the tokenizer alone
            self._fsm_texts = grammar.token_text_table(self.tokenizer,
                                                       self.model_cfg.vocab_size)
        try:
            fsm = grammar.fsm_for_spec(params.guided, params.guided_schema, self.tokenizer,
                                       self.model_cfg.vocab_size, self._eos_ids,
                                       texts=self._fsm_texts)
        except (grammar.FsmCompileError, ValueError) as e:
            logger.info("guided spec not FSM-compilable (%s); using the per-step "
                        "substitution path", e)
            fsm = None
        if fsm is not None and disk_dir is not None:
            # failures are not persisted: they depend on budgets a
            # deployment may raise
            grammar.save_fsm(disk_dir, params.guided, params.guided_schema,
                             self._fsm_tok_fp, fsm)
        self._memoise_fsm(key, fsm)
        return fsm

    def compile_cache_stats(self) -> dict:
        """Hits, misses and size of the engine's two compile caches, the
        grammar-FSM memo and the executable ladder (``runtime/graphs.py``:
        a miss makes an executable, on the card a captured graph), in the
        JAX engine's shape; /debug/engine reports them."""
        g, dp = self.graphs, self.devprof
        # the making of each executable (its capture on the card), as the
        # device profiler's ladder timed it, else the captures alone
        made_s = dp.compile_s if dp.enabled else g.capture_s
        return {
            "fsm": {"hits": self._fsm_stats["hits"], "misses": self._fsm_stats["misses"],
                    "disk_hits": self._fsm_stats["disk_hits"], "size": len(self._fsm_cache)},
            "ladder": {"hits": g.hits, "misses": len(g.executables),
                       "size": len(g.executables),
                       "compile_ms": round(made_s * 1000.0, 3), "tracked": True},
        }

    def _memoise_fsm(self, key: tuple, fsm) -> None:
        """The FIFO memo of compiled FSMs, evicting one entry (and its
        device tables) at a time."""
        if len(self._fsm_cache) >= self.MAX_FSM_CACHE:
            old = self._fsm_cache.pop(next(iter(self._fsm_cache)))
            if old is not None:
                self._fsm_device.pop(id(old), None)
        self._fsm_cache[key] = fsm

    def _fsm_device_tables(self, fsm) -> tuple:
        """``fsm``'s (masks, tok_class, class_next) on the engine's device,
        int32, padded to a power-of-two (states, classes) bucket (masks
        with zero rows, transitions with -1), uploaded once per grammar
        (FIFO, MAX_FSM_CACHE).  Each entry holds the fsm, so its id cannot
        be reused while the entry lives."""
        ent = self._fsm_device.get(id(fsm))
        if ent is None:
            n, vw = fsm.masks.shape
            c = fsm.class_next.shape[1]
            np_, cp = next_power_of_2(n), next_power_of_2(c)
            masks = np.zeros((np_, vw), np.int32)
            masks[:n] = fsm.masks.view(np.int32)
            nxt = np.full((np_, cp), -1, np.int32)
            nxt[:n, :c] = fsm.class_next
            if len(self._fsm_device) >= self.MAX_FSM_CACHE:
                self._fsm_device.pop(next(iter(self._fsm_device)))
            ent = (fsm, self._tensor(masks),
                   self._tensor(fsm.tok_class.astype(np.int32)), self._tensor(nxt))
            self._fsm_device[id(fsm)] = ent
        return ent[1:]

    def _fsm_rows(self, reqs: list[Request], B: int) -> tuple[np.ndarray, np.ndarray]:
        """Each FSM row's packed mask at its host state, (B, ceil(V/32))
        int32, and (B,) whether the row is masked."""
        vw = (self.model_cfg.vocab_size + 31) // 32
        packed = np.zeros((B, vw), np.int32)
        enabled = np.zeros((B,), bool)
        for i, r in enumerate(reqs):
            ent = self._guided_fsm.get(r.request_id)
            if ent is not None and self.guided_mask_enabled:
                packed[i] = ent[0].mask_row(ent[1]).view(np.int32)
                enabled[i] = True
        return packed, enabled

    def _apply_fsm_mask(self, logits: torch.Tensor, reqs: list[Request],
                        B: int) -> torch.Tensor:
        """The synchronous sampler's grammar mask: each FSM row's allow
        bits at its host state, after the penalties, bias and floor, as the
        JAX ``_apply_fsm_mask``."""
        packed, enabled = self._fsm_rows(reqs, B)
        return sampling_ops.apply_token_mask(logits, self._tensor(packed),
                                             self._tensor(enabled))

    def _apply_guided(self, logits: torch.Tensor, toks_np: np.ndarray,
                      reqs: list[Request]) -> None:
        """The substitution path, in place on ``toks_np``: keep a row's
        sampled token when its text keeps the document valid, else take
        the most likely legal one of the top ``GUIDED_TOP_K``, then of a
        fallback set (``_guided_pick``).  Synchronous by design: the next
        step's input token comes from the host."""
        k = min(self.GUIDED_TOP_K, logits.shape[-1])
        # ties in index order, as the JAX top_k
        with self.devprof.sync("guided"):
            ids_h = torch.sort(-logits.float(), dim=-1, stable=True)[1][:, :k].cpu().numpy()
        for i, r in enumerate(reqs):
            st = self._guided.get(r.request_id)
            if st is not None:
                toks_np[i] = self._guided_pick(r, st, int(toks_np[i]),
                                               [int(t) for t in ids_h[i]])

    @staticmethod
    def _guided_text_of(tokenizer, ctx: list, base: str, tok: int) -> str:
        """Text a candidate token would add after ``ctx`` (whose decoding
        is ``base``), by decoding the two and taking the difference; a
        trailing U+FFFD (a rune still incomplete) is not text yet."""
        full = tokenizer.decode(ctx + [tok])
        d = full[len(base):] if full.startswith(base) else tokenizer.decode([tok])
        return d.rstrip("\ufffd")

    def _guided_pick(self, r: Request, st, sampled: int, candidates: list[int]) -> int:
        """One substitution-path token, as the JAX ``_guided_pick``: the
        next token of a committed plan; else the sampled token or the first
        of ``candidates`` that the acceptor allows (EOS only where it can
        finish; a token with no text yet only inside a string); else one of
        the fallback set; else, for acceptors that enumerate their legal
        continuations, the first token of the tokenizer's own encoding of
        one, the rest committed as a plan; else the sampled token."""
        plan = self._guided_plan.get(r.request_id)
        if plan:
            tok = plan.pop(0)
            if not plan:
                self._guided_plan.pop(r.request_id, None)
            return tok
        ctx = (r.prompt_token_ids + r.output_token_ids)[-8:]
        base = self.tokenizer.decode(ctx)
        for tok in [sampled] + candidates:
            if tok in self._eos_ids:
                if st.can_finish:
                    return tok
                continue
            txt = self._guided_text_of(self.tokenizer, ctx, base, tok)
            if txt:
                if st.allows(txt):
                    return tok
            elif st.in_string:
                return tok
        for tok in self._guided_fallback():
            txt = self._guided_text_of(self.tokenizer, ctx, base, tok)
            if txt and st.allows(txt):
                self.stats.guided_fallbacks += 1
                return tok
        suffixes = getattr(st, "viable_suffixes", None)
        if suffixes is not None:
            anchor = None
            for suffix in suffixes():
                def in_context(ids, suffix=suffix):
                    # the plan's tokens follow ctx: check what they decode
                    # to there
                    return ids and self.tokenizer.decode(ctx + ids) == base + suffix

                ids = self.tokenizer.encode(suffix)
                if not in_context(ids):
                    # a tokenizer that marks the start of a sequence: take
                    # the mid-text encoding of the suffix
                    if anchor is None:
                        anchor = self.tokenizer.encode("x")
                    mid = self.tokenizer.encode("x" + suffix)
                    ids = (mid[len(anchor):] if anchor and mid[:len(anchor)] == anchor
                           else [])
                    if not in_context(ids):
                        continue
                if len(ids) > 1:
                    self._guided_plan[r.request_id] = ids[1:]
                self.stats.guided_plans += 1
                return ids[0]
        # nothing legal exists: give up on the constraint for this step
        self.stats.guided_fallbacks += 1
        return sampled

    def _guided_fallback(self) -> list[int]:
        """Single-token encodings of JSON's structural strings, then of
        every printable ASCII character: the substitution path's candidates
        when the whole top-K is illegal."""
        if self._guided_fallback_ids is None:
            ids, seen = [], set()
            tier1 = ('"', "}", "]", ":", ",", "{", "[", " ", "0", "1", "2", "7", "a", "k",
                     "true", "false", "null", "-", ".", "e")
            for text in tier1 + tuple(string.printable):
                enc = self.tokenizer.encode(text)
                if len(enc) == 1 and enc[0] not in seen:
                    seen.add(enc[0])
                    ids.append(enc[0])
            self._guided_fallback_ids = ids
        return self._guided_fallback_ids

    @staticmethod
    def _sample_mode(reqs: list[Request]) -> str:
        """The cheapest sampler covering ``reqs``: greedy if every row is,
        else temperature unless a row truncates, else full."""
        if all(r.params.greedy for r in reqs):
            return "greedy"
        return "full" if any(r.params.needs_truncation for r in reqs) else "temperature"

    @staticmethod
    def _floor_active(r: Request) -> bool:
        """Whether the row's ``min_tokens`` mask is still in force."""
        return r.params.needs_min_tokens and r.params.min_tokens_active(
            len(r.output_token_ids))

    def _truncation_arrays(self, reqs: list[Request], B: int):
        """Per-row top_k/top_p/min_p of the full sampler, one home for the
        decode executables and the synchronous sampler; top_k is clamped to
        the vocabulary (and to -1 below), so any value fits int32."""
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        min_p = np.zeros((B,), np.float32)
        for i, r in enumerate(reqs):
            top_k[i] = max(min(r.params.top_k, self.model_cfg.vocab_size), -1)
            top_p[i] = r.params.top_p
            min_p[i] = r.params.min_p
        return top_k, top_p, min_p

    @staticmethod
    def _penalty_arrays(reqs: list[Request], B: int):
        """Per-row token history (padded to a power of two, at least 8) with
        its mask, and the penalty coefficients."""
        T = max(next_power_of_2(max(len(r.output_token_ids) for r in reqs)), 8)
        out_tokens = np.zeros((B, T), np.int32)
        mask = np.zeros((B, T), bool)
        presence = np.zeros((B,), np.float32)
        frequency = np.zeros((B,), np.float32)
        repetition = np.ones((B,), np.float32)
        for i, r in enumerate(reqs):
            ids = r.output_token_ids[-T:]
            out_tokens[i, :len(ids)] = ids
            mask[i, :len(ids)] = True
            presence[i] = r.params.presence_penalty
            frequency[i] = r.params.frequency_penalty
            repetition[i] = r.params.repetition_penalty
        return out_tokens, mask, presence, frequency, repetition

    @staticmethod
    def _logit_bias_arrays(reqs: list[Request], B: int, V: int):
        """Per-row (ids, values) of ``logit_bias``, padded with id V (dropped)
        to a power-of-two width."""
        K = next_power_of_2(max(len(r.params.logit_bias or {}) for r in reqs) or 1)
        ids = np.full((B, K), V, np.int32)
        vals = np.zeros((B, K), np.float32)
        for i, r in enumerate(reqs):
            for j, (tid, b) in enumerate(r.params.logit_bias_items()):
                ids[i, j] = int(tid)
                vals[i, j] = float(b)
        return ids, vals

    def _min_tokens_arrays(self, reqs: list[Request], B: int, V: int):
        """The ``min_tokens`` mask's (ids, values) and each row's remaining
        floor: every EOS id (unless ``ignore_eos``) and stop id of a row
        still below its floor at -1e9 (not -inf: a row masked whole must
        not turn NaN under softmax); the width is taken over masked rows
        only."""
        eos = sorted(self._eos_ids)
        rows = {}
        remaining = np.zeros((B,), np.int32)
        for i, r in enumerate(reqs):
            if self._floor_active(r):
                rows[i] = ([] if r.params.ignore_eos else eos) + list(r.params.stop_token_ids)
                remaining[i] = r.params.min_tokens - len(r.output_token_ids)
        K = next_power_of_2(max((len(v) for v in rows.values()), default=1) or 1)
        ids = np.full((B, K), V, np.int32)
        vals = np.zeros((B, K), np.float32)
        for i, row in rows.items():
            ids[i, :len(row)] = row
            vals[i, :len(row)] = -1e9
        return ids, vals, remaining

    @staticmethod
    def _append_logprob_entry(r: Request, tok: int, chosen_lp, top_ids, top_lps) -> None:
        """One token's logprob record, the JAX engine's shape: its id, its
        logprob and the request's top ``logprobs`` (id, logprob) pairs, cut
        from the wider ``top_ids``/``top_lps``."""
        k = min(r.params.logprobs, len(top_ids))
        r.logprobs.append({"token_id": tok, "logprob": float(chosen_lp),
                           "top": [(int(t), float(lp))
                                   for t, lp in zip(top_ids[:k], top_lps[:k])]})

    def _charge_decode_rows(self, reqs: list[Request]):
        """Append one KV slot per decoding request, preempting the most
        recent admissions until the appends fit; an in-flight single step
        is flushed before anyone is evicted (some rows may have finished
        in it).  Returns the requests left, their slots and the flushed
        step's outputs."""
        bm = self.block_manager
        outputs = []
        while self._decode_shortfall(reqs) > 0:
            if self._pending is not None:
                outputs += self._flush_pending()
                reqs = [r for r in reqs if not r.finished]
                continue
            victim = self.scheduler.preempt_last()
            self.stats.preemptions += 1
            if victim is None:
                raise MemoryError("KV cache exhausted with a single sequence")
            reqs = [r for r in reqs if r is not victim]
        self._dispatch_rids = tuple(r.request_id for r in reqs)
        self.faults.check("kv_alloc", self._dispatch_rids)
        slots = np.empty((len(reqs),), np.int32)
        with PROF.phase("block"):
            if bm.charge_decode([r.request_id for r in reqs], slots):
                raise MemoryError("out of KV blocks on append")
        return reqs, slots, outputs

    def _decode_shortfall(self, reqs: list[Request]) -> int:
        with PROF.phase("block"):
            return self.block_manager.decode_shortfall([r.request_id for r in reqs])

    # ---- decode -------------------------------------------------------

    def _dispatch(self, reqs: list[Request], steps: int, extra: int, chain_idx: dict,
                  pending, window: bool = False, need_logits: bool = False):
        """Run ``steps`` decode iterations for ``reqs`` on the executable
        of their bucket, sampling mode and extras, and start their copy to
        the host.  Rows in ``chain_idx`` (request id -> row of ``pending``)
        continue the in-flight dispatch ``pending``, ``extra`` tokens ahead
        of the host: their input token is that dispatch's last, selected on
        the card.  Extras, as the JAX window's: logprobs if a row asked for
        them; penalties (with the bias and the floor, neutral where unused)
        if a row has penalties, a bias or a floor in force, their (B, V)
        buffers built on the card from the host history before the
        replay; guided if a row is served by an FSM.  A guided ``window``
        reads its one grammar's tables (loaded into its bucket's buffers
        unless already there) and each row's state, the host mirror or,
        for a chained row, the in-flight dispatch's on the card; a guided
        single step reads per-row tables, each row's mask at its host
        state.  ``need_logits``: run the iteration eagerly and return its
        logits too (the substitution path reads them).  Returns (the
        executable, host tokens, host logprobs or None, event or None,
        logits or None)."""
        B = self.scheduler.decode_bucket(len(reqs))
        V = self.model_cfg.vocab_size
        self._dispatch_rids = tuple(r.request_id for r in reqs)
        lp = any(r.params.logprobs is not None for r in reqs)
        pen = any(r.params.needs_penalties or r.params.needs_logit_bias
                  or self._floor_active(r) for r in reqs)
        fsms = [self._guided_fsm[r.request_id] for r in reqs
                if r.request_id in self._guided_fsm]
        extras = "+".join(x for x, on in (("logprobs", lp), ("penalties", pen),
                                          ("guided", bool(fsms))) if on)
        tables = bucket = ()
        if fsms and window:
            tables = self._fsm_device_tables(fsms[0][0])
            bucket = (tables[0].shape[0], tables[2].shape[1])
        elif fsms:
            bucket = (B, 1)
        exe = self._exec_get(*_decode_key(B, self._sample_mode(reqs), extras, bucket))
        st = exe.stage()
        for i, r in enumerate(reqs):
            pi = chain_idx.get(r.request_id)
            ahead = 0 if pi is None else extra
            nt = r.num_tokens + ahead
            if pi is None:
                st.tokens[i] = r.output_token_ids[-1]
            else:
                st.use_host[i] = 0
                st.gather[i] = pi
            st.positions[i] = nt - 1
            st.seq_lens[i] = nt
            st.active[i] = 1
            st.salt[i] = self._salt(r)
            st.step[i] = len(r.output_token_ids) + ahead
            st.temperature[i] = r.params.temperature
            ent = self._guided_fsm.get(r.request_id)
            if ent is not None and self.guided_mask_enabled:
                # a chained row's state comes from the card (load)
                st.gstate[i] = ent[1] if window else i
        st.top_k[:], st.top_p[:], st.min_p[:] = self._truncation_arrays(reqs, B)
        self._stage_adapters(st, reqs)
        if pen:
            out_tokens, mask, st.presence[:], st.frequency[:], st.repetition[:] = \
                self._penalty_arrays(reqs, B)
            f_ids, f_vals, st.floor_remaining[:] = self._min_tokens_arrays(reqs, B, V)
        with PROF.phase("block"):
            self.block_manager.fill_block_tables([r.request_id for r in reqs],
                                                 st.block_tables)
        self._demote_evicted()
        self.faults.check("decode_dispatch", self._dispatch_rids)
        with PROF.phase("dispatch"), self.devprof.dispatch(
                "decode_multi" if window else "decode", exe.key):
            grammar = None
            if tables:
                grammar = (bucket, fsms[0][0], *tables)
            elif fsms:
                grammar = (bucket, None, self._tensor(self._fsm_rows(reqs, B)[0]))
            # with need_logits the iteration runs eagerly on the buffers,
            # captured or not: its (B, V) logits, extras and mask applied
            logits = self._exec_run(
                exe, st, steps, chain=(pending.exe, pending.steps) if chain_idx else None,
                extras=(np.where(mask, out_tokens, V), *self._logit_bias_arrays(reqs, B, V),
                        f_ids, f_vals) if pen else None,
                grammar=grammar, eager=need_logits)
            toks, lps, event = exe.fetch(steps)
        self.stats.num_decode_steps += steps
        self._note_step_tokens(len(reqs) * steps, B * steps)
        return exe, toks, lps, event, logits

    def _run_decode(self, batch: ScheduledBatch) -> list[RequestOutput]:
        """One decode token step.  Resolves any in-flight window first
        (this path appends slots and may preempt, which must see its
        finishes); with ``pipeline_decode`` the step stays in flight and
        the previous one is flushed after it is dispatched."""
        outputs = self._flush_window()
        reqs = [r for r in batch.requests if not r.finished]
        # penalties, logprobs, a floor and guided rows read the host's
        # history, length or grammar state, one step stale under the
        # pipeline (and the substitution path replaces tokens on the host):
        # such batches run synchronously (a bias is static, so it stays
        # pipelined)
        pipeline_ok = self._pipeline_decode and not any(
            r.params.needs_penalties or r.params.logprobs is not None
            or r.params.guided is not None
            or (r.params.needs_min_tokens
                and r.params.min_tokens_active(len(r.output_token_ids), slack=1))
            for r in reqs)
        if self._pending is not None and not pipeline_ok:
            outputs += self._flush_pending()
            reqs = [r for r in reqs if not r.finished]
        pending = self._pending
        pend_idx: dict[str, int] = {}
        if pending is not None:
            pend_idx = {r.request_id: i for i, r in enumerate(pending.reqs)}
            # host-known length rules: a request whose in-flight token
            # completes max_tokens / max_seq_len runs no further step
            reqs = [r for r in reqs
                    if r.request_id not in pend_idx
                    or (len(r.output_token_ids) + 1 < r.params.max_tokens
                        and r.num_tokens + 1 < self.max_seq_len)]
        if not reqs:
            return outputs + self._flush_pending()
        # the executable writes each row's KV at the slot charged here:
        # the block table's entry for its position
        reqs, _, flushed = self._charge_decode_rows(reqs)
        outputs += flushed
        if not reqs:
            return outputs + self._flush_pending()
        self._step_kind = "decode"
        chain = ({r.request_id: pend_idx[r.request_id] for r in reqs
                  if r.request_id in pend_idx} if self._pending is not None else {})
        if self._flight_on:
            self.flight.req_event_many(self._dispatch_rids, "WINDOW", steps=1)
        sub = any(r.request_id in self._guided for r in reqs)
        exe, toks, lps, event, logits = self._dispatch(reqs, 1, 1, chain, pending,
                                                       need_logits=sub)
        if sub:
            if event is not None:
                event.synchronize()
            self._apply_guided(logits, toks.numpy()[:, 0], reqs)
        step = PendingDecode(reqs=list(reqs), exe=exe, toks=toks, event=event, lp=lps)
        if pipeline_ok:
            # resolve the PREVIOUS step while this one runs on the card
            outputs += self._flush_pending()
            self._pending = step
            return outputs
        self._pending = step
        return outputs + self._flush_pending()

    def _try_reserve_window(self, reqs: list[Request], window: int) -> bool:
        """Reserve ``window`` KV slots past each request's written tokens.
        On failure the over-reserved blocks of earlier requests stay
        attached; they are used as the sequence grows or freed with it."""
        cap = self.cache_cfg.max_blocks_per_seq * self.cache_cfg.block_size
        if any(r.num_tokens - 1 + window > cap for r in reqs):
            return False
        with PROF.phase("block"):
            return self.block_manager.reserve_batch(
                [r.request_id for r in reqs], [r.num_tokens - 1 + window for r in reqs])

    def _window_steps(self) -> int:
        """The next window's size: ``multi_step`` in steady state,
        ``min_multi_step`` while arrivals land in a busy engine
        (``EngineConfig.adaptive_multi_step``), so a new request waits out
        one short window.  The decode executable replays one iteration a
        token, so a short window needs no executable of its own."""
        if self._adaptive_window and (
                self.clock.monotonic() - self._last_busy_arrival
                < self.config.adaptive_window_hold_s):
            return self._min_multi_step
        return self._multi_step

    def _run_decode_multi(self, batch: ScheduledBatch) -> list[RequestOutput]:
        """A decode window of ``_window_steps()`` tokens in one dispatch:
        sampled tokens feed the next iteration on the card; the host reads
        the (B, S) window once.  Tokens past a request's stop point (EOS,
        max_tokens, stop string mid-window) are dropped at the flush.
        With ``pipeline_decode`` the window stays in flight and the
        previous one is flushed after this one is dispatched.  Falls back
        to a single step when the cache cannot reserve the window, and
        runs single steps for a batch with a substitution-path guided row
        or with more than one grammar (a window carries one grammar's
        tables), as the JAX engine."""
        if any(r.request_id in self._guided for r in batch.requests) or len(
                {id(self._guided_fsm[r.request_id][0]) for r in batch.requests
                 if r.request_id in self._guided_fsm}) > 1:
            return self._run_decode(batch)
        S = self._window_steps()
        outputs = self._flush_pending()
        pw = self._pending_window
        if (pw is not None and pw.exe.state.gstate is None
                and any(r.request_id in self._guided_fsm for r in pw.reqs)):
            # a guided row in flight in a window that carried no FSM
            # states: resolve it, so this dispatch reads its host state
            outputs += self._flush_window()
        if self._pending_window is not None and any(
                r.params.needs_penalties
                or (r.params.needs_min_tokens and r.params.min_tokens_active(
                    len(r.output_token_ids), slack=self._pending_window.steps))
                for r in batch.requests):
            # the counts and the floor come from the host's history and
            # length, which lag the in-flight window: resolve it first (a
            # bias is static, so it may chain)
            outputs += self._flush_window()
        p = self._pending_window
        reqs = [r for r in batch.requests if not r.finished]
        pend_idx: dict[str, int] = {}
        if p is not None:
            pend_idx = {r.request_id: i for i, r in enumerate(p.reqs)}
            # a request whose in-flight window reaches max_tokens /
            # max_seq_len gets no further window: it finishes at the flush
            reqs = [r for r in reqs
                    if r.request_id not in pend_idx
                    or (len(r.output_token_ids) + p.steps < r.params.max_tokens
                        and r.num_tokens + p.steps < self.max_seq_len)]
        if not reqs:
            return outputs + self._flush_window()
        self._dispatch_rids = tuple(r.request_id for r in reqs)
        self._step_kind = "window"
        self.faults.check("kv_alloc", self._dispatch_rids)
        # rows continuing the in-flight window need its steps too: its KV
        # commit has not run yet
        if not self._try_reserve_window(reqs, S + (p.steps if p is not None else 0)):
            # _run_decode flushes the in-flight window before preempting
            return outputs + self._run_decode(batch)
        chain = {r.request_id: pend_idx[r.request_id] for r in reqs
                 if r.request_id in pend_idx}
        if self._flight_on:
            # at the dispatch, as the JAX engine: a fault at the flush still
            # shows the window in the timeline; one entry for the batch
            self.flight.req_event_many(self._dispatch_rids, "WINDOW", steps=S)
        exe, toks, lps, event, _ = self._dispatch(reqs, S, p.steps if p is not None else 0,
                                                  chain, p, window=True)
        self.stats.num_decode_windows += 1
        if S < self._multi_step:
            # counted at the dispatch, not in _window_steps(): a batch that
            # falls back to single steps above shrank no window
            self.stats.latency_windows += 1
        if exe.state.gstate is not None:
            self.stats.guided_fsm_windows += 1
        window = PendingWindow(reqs=list(reqs), exe=exe, toks=toks, event=event, steps=S,
                               lp=lps)
        if self._pipeline_decode:
            # resolve the PREVIOUS window while this one runs on the card.
            # A request that finished inside it is already in this dispatch:
            # its rows write into blocks freed at that flush, which is safe
            # because the card runs dispatches in order, so a later owner of
            # those blocks overwrites them; its tokens drop at the next flush.
            outputs += self._flush_window()
            self._pending_window = window
            return outputs
        self._pending_window = window
        return outputs + self._flush_window()

    def _flush_window(self) -> list[RequestOutput]:
        """Read the in-flight window's tokens and run the deferred host
        bookkeeping: commit the written KV, then append, detokenize, check
        stops and emit.  Rows whose request finished while the window was
        in flight (a stop in the previous window, an abort) drop whole."""
        p, self._pending_window = self._pending_window, None
        if p is None:
            return []
        # a fault site of its own (the wait for the card's output): the
        # window is detached already, so a fault drops it for salvage
        self.faults.check("window_flush", tuple(r.request_id for r in p.reqs))
        with PROF.phase("flush"), self.devprof.sync("window"):
            toks_h, lp_h = _read(p)
        # commit the written KV before emitting (a finish frees blocks);
        # rows that finished in flight were freed already
        with PROF.phase("block"):
            self.block_manager.advance_batch(
                [r.request_id for r in p.reqs if not r.finished], p.steps)
        outputs = []
        with PROF.phase("detokenize"):
            for i, r in enumerate(p.reqs):
                if r.finished:
                    self.stats.window_overrun_tokens += p.steps
                    continue
                for s in range(p.steps):
                    if lp_h is not None and r.params.logprobs is not None:
                        # before the emit, and only for consumed tokens
                        self._append_logprob_entry(r, int(toks_h[i, s]), lp_h[0][i, s],
                                                   lp_h[1][i, s], lp_h[2][i, s])
                    out = self._emit_one(r, int(toks_h[i, s]))
                    outputs.append(out)
                    if out.finished:
                        self.stats.window_overrun_tokens += p.steps - 1 - s
                        break
        return outputs

    def _flush_pending(self) -> list[RequestOutput]:
        """Read the in-flight single step's tokens and run the host
        bookkeeping (append, detokenize, stop checks, emission); rows
        aborted in flight drop."""
        p, self._pending = self._pending, None
        if p is None:
            return []
        with PROF.phase("flush"), self.devprof.sync("decode"):
            toks_h, lp_h = _read(p)
        outputs = []
        with PROF.phase("detokenize"):
            for i, r in enumerate(p.reqs):
                if r.finished:
                    continue
                if lp_h is not None and r.params.logprobs is not None:
                    self._append_logprob_entry(r, int(toks_h[i, 0]), lp_h[0][i, 0],
                                               lp_h[1][i, 0], lp_h[2][i, 0])
                outputs.append(self._emit_one(r, int(toks_h[i, 0])))
        return outputs

    # ---- speculative decoding (runtime/spec.py) -------------------------

    def _spec_eligible(self, reqs: list[Request]) -> bool:
        """The JAX engine's gate: speculation is on and not paused by the
        governor (the resume step reached) or by the SLO controller's level
        1 (a batch-class row under queue pressure), and no row has
        penalties, a bias, an active ``min_tokens`` floor, logprobs or a
        guided spec (none of which the verify pass applies)."""
        return (self._spec is not None
                and self.stats.num_decode_steps >= self._spec_resume_step
                and not (self._slo is not None and self._slo.spec_paused_for(reqs))
                and all(not r.params.needs_penalties and not r.params.needs_logit_bias
                        and not self._floor_active(r) and r.params.logprobs is None
                        and r.params.guided is None for r in reqs))

    def _run_decode_spec(self, batch: ScheduledBatch) -> list[RequestOutput]:
        """A speculative decode step, as the JAX ``_run_decode_spec``: k
        draft tokens a row (n-gram lookup or the draft model), verified in
        one pass of the ``("verify", B, K, mode)`` executable (greedy
        argmax, or rejection sampling for a batch with sampled rows), read
        back synchronously; each row emits its accepted prefix plus one
        token.  Both in-flight dispatches are flushed first (a spec step
        reads every row's last token on the host).  Falls back to a single
        decode step when under ``min_batch_coverage`` of the rows have a
        draft or the K-token window cannot be reserved."""
        outputs = self._flush_pending() + self._flush_window()
        reqs = [r for r in batch.requests if not r.finished]
        if not reqs:
            return outputs
        self._dispatch_rids = tuple(r.request_id for r in reqs)
        self._step_kind = "spec"
        k = self._spec.num_draft_tokens
        K = k + 1
        if self._draft_params is not None:
            drafts = self._draft_propose(reqs, k)
        else:
            drafts = [spec_mod.ngram_propose(
                r.prompt_token_ids + r.output_token_ids, k, self._spec.max_ngram,
                self._spec.min_ngram, self._spec.max_lookback) for r in reqs]
        # the verify pass costs every row ~(k+1)x a decode step: it pays
        # only when enough of the batch has drafts to accept
        coverage = sum(1 for d in drafts if d) / len(drafts)
        if (coverage < self._spec.min_batch_coverage
                or not self._try_reserve_window(reqs, K)):
            return outputs + self._run_decode(batch)
        B = self.scheduler.decode_bucket(len(reqs))
        sampled = not all(r.params.greedy for r in reqs)
        exe = self._exec_get("verify", B, K, "sampled" if sampled else "greedy")
        st = exe.stage()
        with PROF.phase("block"):
            self.block_manager.fill_block_tables(self._dispatch_rids, st.block_tables)
        for i, r in enumerate(reqs):
            d = drafts[i]
            base = r.num_tokens - 1              # the input token's position
            st.tokens[i, 0] = r.output_token_ids[-1]
            st.tokens[i, 1:1 + len(d)] = d
            st.ctx_lens[i] = base
            st.chunk_lens[i] = 1 + len(d)
            # every token of the window sits inside the reserved table
            st.slot_ids[i] = self._token_slots(r.request_id, base, K,
                                               block_table=st.block_tables[i])
        if sampled:
            for i, r in enumerate(reqs):
                st.salt[i] = self._salt(r)
                st.step[i] = len(r.output_token_ids)
                st.temperature[i] = r.params.temperature
            st.top_k[:], st.top_p[:], st.min_p[:] = self._truncation_arrays(reqs, B)
        if self._flight_on:
            # K is the widest row's window; accepted counts show in the
            # FINISHED and output events
            self.flight.req_event_many(self._dispatch_rids, "WINDOW", steps=K, spec=True)
        self._demote_evicted()
        self.faults.check("decode_dispatch", self._dispatch_rids)
        with PROF.phase("dispatch"), self.devprof.dispatch(dispatch_kind(exe.key), exe.key):
            self._exec_run(exe, st)
        with PROF.phase("flush"), self.devprof.sync("verify"):
            # the step's one wait on the card: acceptance decides emission
            out = exe.fetch()
        pred_h, accept_h = out[0], (out[1] if sampled else None)
        self.stats.num_decode_steps += 1
        self.stats.spec_steps += 1
        self._note_step_tokens(int(st.chunk_lens[:len(reqs)].sum()), B * K)
        step_proposed = step_accepted = 0
        with PROF.phase("detokenize"):
            for i, r in enumerate(reqs):
                emitted = (spec_mod.accept_greedy(drafts[i], pred_h[i]) if accept_h is None
                           else spec_mod.accept_sampled(drafts[i], accept_h[i], pred_h[i]))
                step_proposed += len(drafts[i])
                step_accepted += len(emitted) - 1
                self.block_manager.advance(r.request_id, len(emitted))
                for tok in emitted:
                    o = self._emit_one(r, tok)
                    outputs.append(o)
                    if o.finished:
                        break
        self.stats.spec_proposed += step_proposed
        self.stats.spec_accepted += step_accepted
        self._spec_govern(step_proposed, step_accepted)
        return outputs

    def _draft_propose(self, reqs: list[Request], k: int) -> list[list[int]]:
        """Batched stateless draft proposals: each row's window is its last
        ``draft_window`` tokens, which the draft model extends by k greedy
        tokens in one ``("draft", B, W + k, k)`` executable, the batch
        padded to a power of two so repeat spec steps share it."""
        W = self._spec.draft_window
        B = next_power_of_2(len(reqs))
        exe = self._exec_get("draft", B, W + k, k)
        st = exe.stage()
        for i, r in enumerate(reqs):
            ids = (r.prompt_token_ids + r.output_token_ids)[-W:]
            st.tokens[i, :len(ids)] = ids
            st.lens[i] = len(ids)
        self.faults.check("decode_dispatch", self._dispatch_rids)
        with PROF.phase("dispatch"), self.devprof.dispatch("draft", exe.key):
            self._exec_run(exe, st)
        with PROF.phase("flush"), self.devprof.sync("draft"):
            # designated wait: the proposals feed this step's verify batch
            out = exe.fetch()[0]
        return [[int(t) for t in out[i]] for i in range(len(reqs))]

    def _spec_govern(self, proposed: int, accepted: int) -> None:
        """The adaptive governor (``SpecConfig.adaptive``), as the JAX
        engine's: accumulate a rolling acceptance window; once it holds
        ``adaptive_window_proposed`` proposals, pause the spec path for
        ``adaptive_pause_steps`` decode steps when acceptance is below
        break-even."""
        cfg = self._spec
        if cfg is None or not cfg.adaptive:
            return
        self._spec_window[0] += proposed
        self._spec_window[1] += accepted
        if self._spec_window[0] < cfg.adaptive_window_proposed:
            return
        acc = self._spec_window[1] / self._spec_window[0]
        self._spec_window = [0, 0]
        floor = cfg.effective_min_acceptance
        if acc < floor:
            self._spec_resume_step = self.stats.num_decode_steps + cfg.adaptive_pause_steps
            self.stats.spec_pauses += 1
            logger.info("speculation paused: rolling acceptance %.3f < %.3f; "
                        "re-probing after %d decode steps", acc, floor,
                        cfg.adaptive_pause_steps)

    # ---- tiered KV cache (runtime/kv_tiers.py) ------------------------
    # card -> host DRAM -> spill: evictions demote instead of destroying
    # KV, lower-tier hits restore ahead of admission.  kv_tiers=False (or
    # TPUSERVE_KV_TIERS=0) removes all of it: _kv_tiers is None and no path
    # below runs.

    def kv_tier_blocks(self) -> dict:
        """Prefix-cache blocks resident by tier: "hbm" the card's cached
        pool, "host" and "spill" the store's (the three partition every
        resolvable chain hash).  Counts only, safe from any thread."""
        store = self._kv_tiers
        return {"hbm": self.block_manager.num_cached_blocks,
                "host": store.host_count if store is not None else 0,
                "spill": store.spill_count if store is not None else 0}

    def _staging(self) -> PageStaging:
        """The page copies' staging buffer, made once (warmup makes it)."""
        if self._page_staging is None:
            self._page_staging = PageStaging(
                self.kv_cache, min(PAGE_STAGING_BLOCKS, self.cache_cfg.num_blocks))
        return self._page_staging

    def _demote_evicted(self) -> None:
        """Drain the block manager's eviction log and demote the evicted
        blocks' pages into the tier store.  MUST run before any dispatch
        that could overwrite them (every step kind calls it right before
        its executable's load, restores before their scatter): until then
        the pages still hold the evicted prefix's KV, so one batched
        gather and one host wait move the whole cycle's evictions.  The
        wait also waits out a pipelined window still in flight."""
        store = self._kv_tiers
        if store is None:
            return
        bm = self.block_manager
        # a hash re-registered since its eviction (a later allocation of
        # the same cycle recomputed the prefix) resolves on the card
        # again: demoting the stale block would put it in two tiers
        ev = [(b, h) for b, h in bm.take_evictions() if not bm.prefix_resolvable(h)]
        if not ev:
            return
        self._exec_demote([b for b, _ in ev], [h for _, h in ev])
        self.stats.kv_demoted_blocks += len(ev)
        self.stats.kv_spilled_blocks = store.spilled_blocks
        self.stats.kv_tier_dropped_blocks = store.dropped_blocks

    def _drop_superseded_tier_entries(self, ids: list[int]) -> None:
        """Called right after a first allocate: the request's prefill is
        about to (re)compute and register every full block of ``ids`` that
        the card did not serve, so store copies of those hashes are now
        superseded and must leave, or the hash is in two tiers once the
        recompute registers it (and the copies squat on the budget).
        Registration hashes len // block_size full blocks, one more than
        ``prefix_chain``'s lookup bound when the length is a block
        multiple: the appended token raises the bound to the registered
        chain without changing any hash."""
        store = self._kv_tiers
        if store is None or len(store) == 0:
            return
        hashes = [h for h in self.block_manager.prefix_chain(list(ids) + [0]) if store.has(h)]
        if hashes:
            self._exec_drop(hashes)

    def _begin_tier_restores(self) -> None:
        """Restore lower-tier prefix hits of the requests at the head of
        the queue: claim blocks (restore-in-flight: in no pool,
        unevictable), take the pages out of the store, and queue the
        host-to-card copy WITHOUT waiting on it; it overlaps whatever this
        cycle dispatches, and the request, held RESTORING for the cycle,
        admits next cycle with the restored span as a prefix-cache hit."""
        store = self._kv_tiers
        if not store or len(store) == 0 or not self.scheduler.waiting:
            return
        bm = self.block_manager
        seats = self.config.scheduler.max_prefill_seqs
        for req in list(self.scheduler.waiting)[:seats]:
            if req.state == RequestState.RESTORING or req.num_prefilled > 0:
                continue
            ids = self._prefill_tokens(req)
            hashes = bm.prefix_chain(ids)
            if not hashes:
                continue
            shared, _ = bm.lookup_prefix(ids, count_stats=False)
            k = len(shared)
            span: list[int] = []
            while k + len(span) < len(hashes) and store.has(hashes[k + len(span)]):
                span.append(hashes[k + len(span)])
            if not span:
                continue
            # the request's fresh-block demand does not depend on how much
            # is restored (restored blocks are revived as shared): all past
            # the card's hit plus decode headroom must fit, or the restore
            # would only thrash the cached pool
            if bm.blocks_needed(len(ids)) - k + 1 > bm.num_free_blocks:
                continue
            blocks = bm.begin_restore(span)
            if blocks is None:
                continue
            pages = self._exec_restore(span)
            if len(pages) < len(span):
                bm.abort_restore(blocks[len(pages):])
                blocks, span = blocks[:len(pages)], span[:len(pages)]
                self.stats.kv_tier_dropped_blocks = store.dropped_blocks
            if not blocks:
                continue
            # claiming restore blocks can itself evict cold cached blocks:
            # demote THEM before the scatter overwrites their pages
            self._demote_evicted()
            self._exec_scatter(blocks, pages)
            req.state = RequestState.RESTORING
            self.flight.req_event(req.request_id, "RESTORING", blocks=len(blocks))
            self._restores[req.request_id] = (span, blocks, self.clock.monotonic())
            self.stats.kv_restores += 1
            self.stats.kv_restored_blocks += len(blocks)

    def _commit_tier_restores(self) -> None:
        """Publish last cycle's restored blocks as the card's prefix entries
        and send their requests back to WAITING.  No wait is needed: any
        step that reads the restored pages is dispatched after the copies,
        on the same stream."""
        if not self._restores:
            return
        now = self.clock.monotonic()
        for rid, (span, blocks, t0) in self._restores.items():
            self.block_manager.commit_restore(span, blocks)
            req = self.requests.get(rid)
            if req is not None and req.state == RequestState.RESTORING:
                req.state = RequestState.WAITING
            if len(self.stats.restore_latencies) < 512:
                self.stats.restore_latencies.append(now - t0)
        self._restores.clear()

    # ---- bookkeeping --------------------------------------------------

    def _emit_one(self, req: Request, tok: int,
                  from_prefill: bool = False) -> RequestOutput:
        req.output_token_ids.append(tok)
        # progress resets the salvage budget: it bounds consecutive faulted
        # attempts, not the faults a long stream lives through
        req.num_salvages = 0
        self.stats.generated_tokens += 1
        raw_delta = delta = self._detok[req.request_id].add(tok)
        reason = None
        if req.params.stop and not req.params.min_tokens_active(len(req.output_token_ids)):
            # below the min_tokens floor stop strings are not matched (the
            # text still streams), as vLLM
            delta, stopped = self._match_stop(req, delta)  # mutates output_text
            if stopped:
                reason = FinishReason.STOP
        else:
            req.output_text += delta
        if req.params.guided is not None:
            reason = self._guided_advance(req, tok, raw_delta, reason)
        if reason is None:
            reason = check_stop(req, self._eos_ids, self.max_seq_len)
        finished = reason is not None
        if finished:
            if req.stop_held:
                # a held stop-prefix that never completed is real output
                req.output_text += req.stop_held
                delta += req.stop_held
                req.stop_held = ""
            req.finish_reason = reason
            req.finish_time = self.clock.monotonic()
            self.scheduler.finish(req)
            self.stats.requests_finished += 1
            self.flight.req_event(req.request_id, "FINISHED", cause=reason.value,
                                  output_tokens=len(req.output_token_ids))
            self._release(req.request_id)
        return RequestOutput(
            request_id=req.request_id, new_token_ids=[tok], new_text=delta,
            finished=finished, finish_reason=reason,
            num_prompt_tokens=req.num_prompt_tokens,
            num_output_tokens=len(req.output_token_ids),
            from_prefill=from_prefill)

    def _guided_advance(self, req: Request, tok: int, raw_delta: str,
                        reason: Optional[FinishReason]) -> Optional[FinishReason]:
        """A guided request's host state after emitting ``tok``, in the
        JAX engine's order: an FSM row advances its mirror by the token
        through the table the card used (an off-grammar token drops the
        constraint), and a substitution-path row feeds its acceptor the
        raw text (a rejected feed drops it); either reaching a complete
        state (the JSON root closed, an inextensible match) stops the
        request, unless it already stopped or the token is EOS (which
        ``check_stop`` finishes)."""
        rid = req.request_id
        ent = self._guided_fsm.get(rid)
        if ent is not None:
            fsm, state = ent
            ns = fsm.advance(state, tok)
            if ns < 0:
                self._guided_fsm.pop(rid, None)
            else:
                ent[1] = ns
                if fsm.complete[ns] and reason is None and tok not in self._eos_ids:
                    reason = FinishReason.STOP
        st = self._guided.get(rid)
        if st is not None:
            if raw_delta:
                try:
                    # the raw text: the acceptor tracks what was sampled,
                    # not what a stop-string hold-back emitted
                    st.feed(raw_delta)
                except ValueError:
                    self._guided.pop(rid, None)
                    self._guided_plan.pop(rid, None)
                    st = None
            if st is not None and st.complete and reason is None:
                reason = FinishReason.STOP
        return reason

    def _match_stop(self, req: Request, delta: str) -> tuple[str, bool]:
        """Stop-string search with prefix hold-back, as the JAX engine's
        ``_match_stop``: a tail that is a proper prefix of a stop string is
        withheld (``req.stop_held``) until it completes a match or the
        request finishes otherwise.  On a match the stop string is dropped,
        or kept with ``include_stop_str_in_output``.  Returns
        (emitted_delta, stopped)."""
        stops = req.params.stop
        if any(not s for s in stops):
            req.stop_held = ""
            return "", True
        max_stop = max(len(s) for s in stops)
        prev_tail = req.output_text[-(max_stop - 1):] if max_stop > 1 else ""
        base = len(prev_tail)
        text = prev_tail + req.stop_held + delta
        best = None
        for s in stops:
            start = 0
            while True:
                pos = text.find(s, start)
                if pos == -1:
                    break
                if pos + len(s) > base:
                    if best is None or pos < best[0]:
                        best = (pos, s)
                    break
                start = pos + 1
        if best is not None:
            keep_until = best[0]
            if req.params.include_stop_str_in_output:
                keep_until += len(best[1])
            req.stop_held = ""
            if keep_until >= base:
                emit = text[base:keep_until]
                req.output_text += emit
                return emit, True
            req.output_text = req.output_text[
                :len(req.output_text) - (base - keep_until)]
            return "", True
        held = 0
        for k in range(min(len(text) - base, max_stop - 1), 0, -1):
            if any(s.startswith(text[-k:]) for s in stops):
                held = k
                break
        emit = text[base:len(text) - held]
        req.stop_held = text[len(text) - held:] if held else ""
        req.output_text += emit
        return emit, False

    # ------------------------------------------------------------------
    # Warmup
    # ------------------------------------------------------------------

    def warmup(self, decode_buckets: Optional[Sequence[int]] = None,
               prefill_buckets: Optional[Sequence] = None,
               chunk_buckets: Optional[Sequence[int]] = None,
               mixed_buckets: Optional[Sequence[int]] = None,
               sample_modes: Sequence[str] = SAMPLE_MODES,
               embed_buckets: Sequence[tuple[int, int]] = ()) -> None:
        """Make the executables before serving, with the JAX engine's
        ``warmup`` defaults; on the card each one is a captured CUDA graph,
        largest transient first.  ``None`` derives a kind's buckets; an
        empty list warms none of it.

        - decode: ``decode_buckets``, by default the whole ladder
          (``min_decode_bucket`` to the bucket ``max_num_seqs`` pads to;
          the JAX engine warms only ``min_decode_bucket`` unless mixed
          batching is on), in the variants ``sample_modes`` names, as the
          JAX warmup: greedy always, "temperature" and "full" by name;
          each without extras, with logprobs ("logprobs") and with
          penalties (any of "penalties", "bias", "min_tokens"); logprobs
          and penalties together are made on first use;
        - prefill: each entry a padded length L (at batch 1) or a (batch,
          L) pair, by default ``min_prefill_bucket`` at batch 1;
        - chunk: ``chunk_buckets``, plus the full ``prefill_chunk_size``
          when a sequence can outgrow it; none when chunked prefill is off;
        - mixed batching: ``mixed_buckets`` rounded up to the ragged
          block, by default the flat-token ladder (the block, doubling up
          to the budget's power of two); prefill and chunk steps never run
          then, so none is warmed;
        - speculation: the greedy verify step of every decode bucket, and
          the sampled one when ``sample_modes`` names "temperature" or
          "full", as the JAX warmup; with a draft model its step at every
          power-of-two batch;
        - ``embed_buckets``: (B, T) pairs of the embeddings trunk, run once
          each on padding.  The trunks are eager, not engine steps, so this
          compiles and captures nothing: it only initialises the libraries
          a first trunk call would (the JAX engine compiles them here).

        With the tiers on, the page copies' staging buffer is made too (a
        round trip of block 0 onto itself), and host records for the host
        tier's budget (at most ``PIN_RECORDS_MAX_BYTES``) are pinned.

        Without capture each executable runs once on padding rows, which
        write nothing.  An executable not warmed is made on first use."""
        sched = self.scheduler.cfg
        prefill = ([sched.min_prefill_bucket] if prefill_buckets is None
                   else list(prefill_buckets))
        chunks = set(chunk_buckets or ()) if sched.allow_chunked_prefill else set()
        if (sched.allow_chunked_prefill and not sched.mixed_batching
                and self.max_seq_len > sched.prefill_chunk_size):
            chunks.add(sched.prefill_chunk_size)
        blk = self._ragged_blk
        if sched.mixed_batching:
            if mixed_buckets is None:
                mixed_buckets = [k[1] for k in self._step_keys(sched, self.max_seq_len)
                                 if k[0] == "mixed"]
            prefill, chunks = [], set()
        modes = [m for m in transformer.DECODE_MODES if m == "greedy" or m in sample_modes]
        extras = [""] + [x for x in ("logprobs", "penalties") if x in sample_modes
                         or (x == "penalties" and {"bias", "min_tokens"} & set(sample_modes))]
        keys = [_decode_key(B, m, x)
                for B in (self._decode_ladder() if decode_buckets is None else decode_buckets)
                for m in modes for x in extras]
        keys += [("prefill", *(b if isinstance(b, tuple) else (1, b))) for b in prefill]
        keys += [("chunk", C) for C in chunks]
        keys += [("mixed", -(-T // blk) * blk) for T in mixed_buckets or ()]
        keys += self._spec_keys(["greedy"] + (["sampled"] if {"temperature", "full"}
                                              & set(sample_modes) else []))
        with self.faults.suspended():
            self._exec_warmup(keys)
        for B, T in embed_buckets:
            self._exec_embed(np.zeros((B, T), np.int32), np.ones((B,), np.int32), "mean")
        if self._kv_tiers is not None:
            # the tier page copies' staging, and a round's host records
            # (a round trip of block 0 onto itself), so that the first
            # eviction burst allocates no staging
            st = self._staging()
            blocks = [0] * st.rows
            scatter_block_pages(self.kv_cache, blocks,
                                gather_block_pages(self.kv_cache, blocks, st), st)
            st.pin_records(min(self._kv_tiers.host_budget_bytes, PIN_RECORDS_MAX_BYTES)
                           // st.record_bytes)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # the graph pools and staging now exist: the watermark counts them
        self.note_hbm()

    # ------------------------------------------------------------------
    # Embeddings and prompt scoring: the cache-less trunk, no KV cache
    # ------------------------------------------------------------------

    MAX_EMBED_BATCH = 128
    # The JAX engine's budget for the (B, H, T, T) float32 scores its plain
    # attention materialises in these trunks (~1 GiB): the batch is chunked
    # under it, and a single input too long for it alone is refused.  The
    # flash kernel materialises no such tensor, but the port keeps the same
    # budget, so that it batches the same inputs together and refuses the
    # same over-long input with the same error.
    EMBED_SCORE_BUDGET_BYTES = 1 << 30
    # the pipeline engine's intake guard (add_request): the most float32
    # attention-score bytes one batched prefill could make on the plain
    # attention, kept so that the same requests are refused as in the JAX
    # package (the stages' flash kernel makes no score tensor)
    PP_PREFILL_SCORE_BUDGET_BYTES = 1 << 30

    def _pp_prompt_budget(self, prompt_len: int, max_tokens) -> None:
        """The JAX pipeline engine's intake guard: chunked prefill is closed
        under pp, so budget the largest re-prefill this request can grow
        to (prompt + max_tokens at its bucket, after a preemption) times
        the rows the scheduler could batch at that bucket."""
        worst = min(prompt_len + (max_tokens or 0), self.max_seq_len)
        L = next_power_of_2(worst)
        scfg = self.scheduler.cfg
        rows = min(scfg.max_prefill_seqs, max(1, scfg.max_prefill_tokens // L))
        score = rows * self.model_cfg.num_heads * L * L * 4
        if score > self.PP_PREFILL_SCORE_BUDGET_BYTES:
            raise ValueError(
                f"prompt length {prompt_len} + max_tokens {max_tokens} exceeds the "
                "pipeline engine's prompt budget: chunked prefill is unavailable "
                f"under pp and a (re-)prefill at bucket {L} would need "
                f"{score / 2**30:.1f} GiB of attention scores (budget "
                f"{self.PP_PREFILL_SCORE_BUDGET_BYTES / 2**30:.0f} GiB); lower "
                "max_tokens or use tp instead of pp")

    def _refuse_pp(self, what: str) -> None:
        if self._pp > 1:
            raise ValueError(f"{what} not supported on the pipeline engine; route to a "
                             "non-pp replica")

    def _embed_max_rows(self, T: int) -> int:
        per_row = self.model_cfg.num_heads * T * T * 4
        return max(int(self.EMBED_SCORE_BUDGET_BYTES // max(per_row, 1)), 0)

    def score_prompts(self, ids_list: Sequence[Sequence[int]], top_n: int = 0) -> list:
        """Prompt logprobs (OpenAI ``echo`` + ``logprobs``, vLLM
        ``prompt_logprobs``): log p(t_i | t_<i) per token with its
        1-based full-vocabulary rank and the top ``top_n`` alternatives,
        from the cache-less scoring trunk (``transformer.score_prompt``,
        the unembedding in slices).  Returns one entry list a prompt in
        ``Request.logprobs``' shape; the first token's logprob and rank are
        None (no conditional), as OpenAI reports it."""
        if self.mesh is not None and self.mesh.multihost:
            raise ValueError("prompt scoring not supported by this multi-host deployment")
        self._refuse_pp("prompt scoring")
        top_n = min(max(int(top_n), 0), self.MAX_LOGPROBS)
        prepared = []
        for ids in ids_list:
            ids = [int(t) for t in ids]
            if not ids:
                raise ValueError("prompts must be non-empty")
            limit = self.model_cfg.max_position_embeddings
            if len(ids) > limit:
                raise ValueError(f"prompt length {len(ids)} exceeds model "
                                 f"position range {limit}")
            if self._embed_max_rows(max(next_power_of_2(len(ids)), 16)) < 1:
                raise ValueError(
                    f"prompt length {len(ids)} exceeds the scoring "
                    "attention budget for this model; shorten the input")
            prepared.append(ids)
        with self._embed_lock:
            return self._score_locked(prepared, top_n)

    def _trunk_batches(self, ids_list, min_t: int):
        """The JAX engine's greedy (B, T) batching of the cache-less
        trunks: the longest run of inputs whose padded shape (T a power of
        two, at least ``min_t``) fits the attention-score budget and
        ``MAX_EMBED_BATCH``, B padded to a power of two where padding rows
        still fit.  Yields (group, tokens (B, T), lens (B,))."""
        i = 0
        while i < len(ids_list):
            T = max(next_power_of_2(len(ids_list[i])), min_t)
            j = i + 1
            while j < len(ids_list):
                T2 = max(T, next_power_of_2(len(ids_list[j])), min_t)
                if j + 1 - i > min(self._embed_max_rows(T2), self.MAX_EMBED_BATCH):
                    break
                T = T2
                j += 1
            group = ids_list[i:j]
            B = next_power_of_2(len(group))
            if B > self._embed_max_rows(T):     # padding rows count too
                B = max(len(group), 1)
            tokens = np.zeros((B, T), dtype=np.int32)
            lens = np.ones((B,), dtype=np.int32)   # padding rows: length 1
            for k, ids in enumerate(group):
                tokens[k, :len(ids)] = ids
                lens[k] = len(ids)
            yield group, tokens, lens
            i = j

    def _score_locked(self, ids_list, top_n):
        results = []
        for group, tokens, lens in self._trunk_batches(ids_list, 16):
            chosen, ranks, top_ids, top_lps = self._exec_score(tokens, lens, top_n)
            for k, ids in enumerate(group):
                entries = [{"token_id": ids[0], "logprob": None, "rank": None, "top": []}]
                for p in range(1, len(ids)):
                    # position p-1's distribution scores token p
                    entries.append({
                        "token_id": ids[p], "logprob": float(chosen[k, p - 1]),
                        "rank": int(ranks[k, p - 1]),
                        "top": [(int(t), float(lp)) for t, lp in
                                zip(top_ids[k, p - 1], top_lps[k, p - 1])]})
                results.append(entries)
        return results

    def embed(self, inputs: Sequence[str] | Sequence[Sequence[int]], pooling: str = "mean"):
        """Sentence embeddings for /v1/embeddings: tokenise, pad to
        power-of-two (B, T) buckets (``_trunk_batches``) and run the
        cache-less trunk (``transformer.embed_forward``) a batch at a time.
        Returns (float32 ndarray (n, H), token counts)."""
        if self.mesh is not None and self.mesh.multihost:
            raise ValueError("embeddings not supported by this multi-host deployment; "
                             "route to a single-host replica")
        self._refuse_pp("embeddings")
        if pooling not in transformer.POOLINGS:
            raise ValueError("pooling must be 'mean' or 'last'")
        if not inputs:
            raise ValueError("input must be non-empty")
        if len(inputs) > self.MAX_EMBED_BATCH:
            raise ValueError(f"at most {self.MAX_EMBED_BATCH} inputs per request")
        ids_list = []
        for x in inputs:
            ids = self.tokenizer.encode(x) if isinstance(x, str) else [int(t) for t in x]
            if not ids:
                raise ValueError("input texts must be non-empty")
            limit = self.model_cfg.max_position_embeddings
            if len(ids) > limit:
                raise ValueError(f"input length {len(ids)} exceeds model "
                                 f"position range {limit}")
            if self._embed_max_rows(max(next_power_of_2(len(ids)), 8)) < 1:
                raise ValueError(
                    f"input length {len(ids)} exceeds the embeddings "
                    "attention budget for this model; shorten the input")
            ids_list.append(ids)
        with self._embed_lock:
            outs = []
            for group, tokens, lens in self._trunk_batches(ids_list, 8):
                outs.append(self._exec_embed(tokens, lens, pooling)[:len(group)])
            return np.concatenate(outs, axis=0), [len(x) for x in ids_list]

    def generate(self, prompts: Sequence[str] | Sequence[Sequence[int]],
                 params: SamplingParams | Sequence[SamplingParams] | None = None,
                 ) -> list[Request]:
        if params is None:
            params = SamplingParams()
        if isinstance(params, SamplingParams):
            params = [params] * len(prompts)
        if len(params) != len(prompts):
            raise ValueError(f"got {len(prompts)} prompts but {len(params)} "
                             "sampling params")
        rids = []
        for prompt, p in zip(prompts, params):
            if isinstance(prompt, str):
                rids.append(self.add_request(prompt=prompt, params=p))
            else:
                rids.append(self.add_request(prompt_token_ids=prompt, params=p))
        while self.has_work():
            self.step()
        return [self.requests.pop(rid) for rid in rids]
