"""The serving engine: continuous batching over a paged KV cache, in
PyTorch — the phase-split slice of ``tpuserve/runtime/engine.py``.

Each ``step`` is one batched prefill (``transformer.prefill``: the flash
prefill kernel on the card) or one decode dispatch: a fused window of
``multi_step`` tokens (``transformer.decode_multi``: the paged decode
kernel on every token, one host read per window), or a single step when
``multi_step`` is 1 or the window's cache slots cannot be reserved.
Sampling is greedy or temperature; stop strings, stop ids, ``ignore_eos``
and ``max_tokens`` are host logic, as in the JAX engine.

The engine runs on ``device="cuda"`` unless the caller passes
``device="cpu"`` (the tests do); it never falls back to the CPU on its own.
Options of the JAX engine that this slice does not carry raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from typing import Optional, Sequence

import numpy as np
import torch

from tpuserve_torch.models import transformer
from tpuserve_torch.models.config import ModelConfig, get_model_config
from tpuserve_torch.models.tokenizer import IncrementalDetokenizer, load_tokenizer
from tpuserve_torch.models.weights import init_params, param_nbytes
from tpuserve_torch.ops import sampling as sampling_ops
from tpuserve_torch.ops.attention import PAD_SLOT
from tpuserve_torch.runtime.block_manager import BlockManager
from tpuserve_torch.runtime.clock import MONOTONIC
from tpuserve_torch.runtime.kv_cache import (
    CacheConfig, create_kv_cache, num_blocks_for_budget)
from tpuserve_torch.runtime.request import (
    FinishReason, Request, RequestOutput, RequestState, SamplingParams, check_stop)
from tpuserve_torch.runtime.scheduler import ScheduledBatch, Scheduler, SchedulerConfig
from tpuserve_torch.runtime.slo import class_rank
from tpuserve_torch.utils import next_power_of_2

logger = logging.getLogger("tpuserve_torch.engine")

# the engine's own options that select a path this slice does not port
_UNPORTED_CONFIG = (
    ("quantization", "int8 weights (ROADMAP.md A8, model breadth)"),
    ("lora_dir", "LoRA (ROADMAP.md A8, model breadth)"),
    ("lora_modules", "multi-LoRA (ROADMAP.md A8, model breadth)"),
    ("speculative", "speculative decoding (ROADMAP.md A7, engine slice 3)"),
    ("checkpoint_dir", "checkpoint loading (ROADMAP.md A2)"),
)


@dataclasses.dataclass
class EngineConfig:
    model: str = "Qwen/Qwen3-0.6B"
    checkpoint_dir: Optional[str] = None      # None = random init
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    attn_impl: str = "auto"                   # "auto" | "reference" | "cuda"
    enable_prefix_caching: bool = True
    seed: int = 0
    # Tokens per fused decode window (transformer.decode_multi).  None =
    # auto: 32 on the card (the JAX engine's accelerator value, not yet
    # measured on this card), 1 on the CPU where tests expect per-token
    # steps.
    multi_step: Optional[int] = None
    # JAX engine options not ported yet: any value but None raises
    quantization: Optional[str] = None
    lora_dir: Optional[str] = None
    lora_modules: Optional[dict] = None
    speculative: Optional[object] = None

    def resolve_attn_impl(self, device: torch.device) -> str:
        if self.attn_impl != "auto":
            return self.attn_impl
        return "cuda" if device.type == "cuda" else "reference"

    def resolve_multi_step(self, device: torch.device) -> int:
        if self.multi_step is not None:
            return max(1, self.multi_step)
        return 32 if device.type == "cuda" else 1


@dataclasses.dataclass
class EngineStats:
    num_prefill_steps: int = 0
    num_decode_steps: int = 0        # decode tokens computed per row (S per window)
    num_decode_windows: int = 0      # fused windows dispatched
    prompt_tokens: int = 0
    generated_tokens: int = 0
    preemptions: int = 0
    requests_finished: int = 0
    # fused windows: tokens computed past a request's stop point, dropped
    window_overrun_tokens: int = 0
    ttft_sum: float = 0.0
    ttft_count: int = 0
    last_step_time: float = 0.0


class Engine:
    """Single-device serving engine (one model)."""

    def __init__(self, config: EngineConfig | None = None, *, params=None,
                 model_cfg: ModelConfig | None = None, mesh=None,
                 device: str | torch.device = "cuda"):
        config = config or EngineConfig()
        self.config = config
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the engine on the CPU")
        if mesh is not None:
            raise NotImplementedError(
                "tp/pp meshes are not ported yet (ROADMAP.md A10, multi-GPU)")
        for field, item in _UNPORTED_CONFIG:
            if getattr(config, field) is not None:
                raise NotImplementedError(f"EngineConfig.{field}: {item}")
        if config.scheduler.mixed_batching:
            raise NotImplementedError(
                "mixed batching is not ported yet (ROADMAP.md A7, engine "
                "slice 3: ragged_paged_attention)")
        self.clock = MONOTONIC
        self.model_cfg = model_cfg or get_model_config(config.model)
        self.attn_impl = config.resolve_attn_impl(self.device)
        if self.attn_impl not in transformer.ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{transformer.ATTN_IMPLS} (or 'auto')")
        self.tokenizer = load_tokenizer(config.model,
                                        vocab_size=self.model_cfg.vocab_size)
        if params is None:
            params = init_params(self.model_cfg, config.seed, self.device)
        self.params = params
        self.cache_cfg = config.cache
        if self.cache_cfg.num_blocks == 0:
            self.cache_cfg = dataclasses.replace(
                self.cache_cfg, num_blocks=self._auto_num_blocks())
            logger.info("auto-sized KV cache: %d blocks of %d tokens",
                        self.cache_cfg.num_blocks, self.cache_cfg.block_size)
        self.kv_cache = create_kv_cache(self.model_cfg, self.cache_cfg,
                                        self.device)
        self.block_manager = BlockManager(
            self.cache_cfg.num_blocks, self.cache_cfg.block_size,
            enable_prefix_caching=config.enable_prefix_caching)
        # Chunked prefill needs paged_window_attention (the next slice):
        # with the flag off every scheduler chunk route is closed, so every
        # prompt — prefix-cache hits included — takes the batched route.
        sched_cfg = dataclasses.replace(config.scheduler,
                                        allow_chunked_prefill=False)
        self.scheduler = Scheduler(sched_cfg, self.block_manager,
                                   max_model_len=self.cache_cfg.max_model_len)
        self.scheduler.clock = self.clock
        self.stats = EngineStats()
        self.requests: dict[str, Request] = {}   # live + finished-unclaimed
        self._detok: dict[str, IncrementalDetokenizer] = {}
        self._generators: dict[str, torch.Generator] = {}
        self._multi_step = config.resolve_multi_step(self.device)
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

    def _auto_num_blocks(self) -> int:
        """Size the cache to the memory the weights left free (the vLLM
        ``gpu_memory_utilization`` analog): ``torch.cuda.mem_get_info`` on
        the card; a 1 GiB budget less the weights on the CPU."""
        if self.device.type == "cuda":
            free, _total = torch.cuda.mem_get_info(self.device)
        else:
            free = (1 << 30) - param_nbytes(self.params)
        blocks = num_blocks_for_budget(self.model_cfg, self.cache_cfg, free)
        # past what the scheduler can ever address, memory is waste
        sched = self.config.scheduler
        addressable = sched.max_num_seqs * (self.cache_cfg.max_blocks_per_seq + 1)
        return min(blocks, addressable, 1 << 17)

    # ------------------------------------------------------------------
    # Request intake
    # ------------------------------------------------------------------

    @staticmethod
    def _reject_unported(params: SamplingParams) -> None:
        checks = (
            (params.guided is not None,
             "guided decoding (ROADMAP.md A6, apply_token_mask)"),
            (params.needs_truncation,
             "top_k/top_p/min_p (ROADMAP.md A6, the full sampler)"),
            (params.needs_penalties,
             "presence/frequency/repetition penalties (ROADMAP.md A6)"),
            (params.logprobs is not None, "logprobs (ROADMAP.md A6)"),
            (params.needs_logit_bias, "logit_bias (ROADMAP.md A6)"),
            (params.min_tokens > 0, "min_tokens (ROADMAP.md A6)"),
        )
        for used, item in checks:
            if used:
                raise NotImplementedError(f"not ported yet: {item}")

    def add_request(self, prompt: str | None = None,
                    prompt_token_ids: Optional[Sequence[int]] = None,
                    params: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None) -> str:
        params = params or SamplingParams()
        self._reject_unported(params)
        class_rank(params.slo_class)              # junk class: ValueError
        request_id = request_id or f"req-{next(self._req_counter)}"
        if request_id in self.requests:
            raise ValueError(f"request {request_id} already exists")
        caller_ids = prompt_token_ids is not None
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
        if len(prompt_token_ids) >= self.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt_token_ids)} exceeds max sequence "
                f"length {self.max_seq_len} (min of cache capacity "
                f"{self.cache_cfg.max_model_len} and model position range "
                f"{self.model_cfg.max_position_embeddings})")
        req = Request(request_id=request_id, prompt_token_ids=prompt_token_ids,
                      params=params, prompt=prompt,
                      arrival_time=self.clock.monotonic())
        self.scheduler.add(req)                   # MemoryError: queue full
        self._detok[request_id] = IncrementalDetokenizer(self.tokenizer)
        self.requests[request_id] = req
        if not params.greedy:
            # one generator per request: its stream depends on its seed
            # alone, not on the batches or windows it lands in
            seed = (params.seed if params.seed is not None
                    else self.config.seed * 1_000_003 + next(self._seed_counter))
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed & 0xFFFFFFFFFFFF)
            self._generators[request_id] = gen
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
            # prompts are written whole (no chunked prefill), so a held
            # block's KV is complete and may stay in the prefix cache
            self.block_manager.free(request_id)
        req.state = RequestState.FINISHED
        req.finish_reason = FinishReason.ABORT
        self._release(request_id)
        return True

    def _release(self, request_id: str) -> None:
        self._detok.pop(request_id, None)
        self._generators.pop(request_id, None)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    # ------------------------------------------------------------------
    # Step
    # ------------------------------------------------------------------

    def step(self) -> list[RequestOutput]:
        """Run one engine iteration: one prefill batch or one decode
        dispatch (a fused window or a single step)."""
        batch = self.scheduler.schedule()
        if batch is None:
            return []
        t0 = self.clock.monotonic()
        if batch.kind == "prefill":
            outputs = self._run_prefill(batch)
        elif batch.kind == "decode":
            outputs = None
            if self._multi_step > 1:
                outputs = self._run_decode_multi(batch)   # None = no room
            if outputs is None:
                outputs = self._run_decode(batch)
        else:
            raise RuntimeError(f"unexpected batch kind {batch.kind!r} "
                               "(chunked and mixed routes are closed)")
        self.stats.last_step_time = self.clock.monotonic() - t0
        return outputs

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _run_prefill(self, batch: ScheduledBatch) -> list[RequestOutput]:
        reqs = batch.requests
        L = batch.padded_len
        B = next_power_of_2(len(reqs))
        tokens = np.zeros((B, L), np.int32)
        slot_ids = np.full((B, L), PAD_SLOT, np.int32)
        prompt_lens = np.ones((B,), np.int32)
        for i, req in enumerate(reqs):
            ids = req.prompt_token_ids + req.output_token_ids
            shared, _cached = self.block_manager.lookup_prefix(ids)
            self.block_manager.allocate(req.request_id, ids, shared_blocks=shared)
            tokens[i, :len(ids)] = ids
            prompt_lens[i] = len(ids)
            slot_ids[i, :len(ids)] = self._token_slots(req.request_id, len(ids))
        logits, self.kv_cache = transformer.prefill(
            self.params, self.model_cfg, self._tensor(tokens),
            self._tensor(prompt_lens), self._tensor(slot_ids), self.kv_cache,
            attn_impl=self.attn_impl)
        self.scheduler.mark_running(reqs)
        self.stats.num_prefill_steps += 1
        new_tokens = self._sample(logits, reqs, B)
        now = self.clock.monotonic()
        for req in reqs:
            if req.first_token_time is None:      # not a re-prefill
                req.first_token_time = now
                self.stats.ttft_sum += now - req.arrival_time
                self.stats.ttft_count += 1
        return [self._emit_one(r, int(t), from_prefill=True)
                for r, t in zip(reqs, new_tokens)]

    def _token_slots(self, request_id: str, n: int) -> np.ndarray:
        """Flat cache slots of token indices [0, n)."""
        bs = self.cache_cfg.block_size
        bt = np.asarray(self.block_manager.block_table(request_id), np.int64)
        t = np.arange(n)
        return (bt[t // bs] * bs + t % bs).astype(np.int32)

    def _sampling_inputs(self, reqs: list[Request], B: int):
        """(mode, temperature (B,) on the device, generators (B,) with None
        for greedy and padding rows)."""
        if all(r.params.greedy for r in reqs):
            return "greedy", None, None
        temperature = np.zeros((B,), np.float32)
        gens = [None] * B
        for i, r in enumerate(reqs):
            temperature[i] = r.params.temperature
            gens[i] = self._generators.get(r.request_id)
        return "temperature", self._tensor(temperature), gens

    def _sample(self, logits: torch.Tensor, reqs: list[Request],
                B: int) -> np.ndarray:
        mode, temperature, gens = self._sampling_inputs(reqs, B)
        noise = (None if mode == "greedy" else
                 sampling_ops.gumbel_noise(gens, logits.shape[-1], self.device))
        toks = sampling_ops.sample_tokens(logits, temperature, mode=mode,
                                          gumbel=noise)
        return toks.cpu().numpy()[:len(reqs)]

    def _run_decode(self, batch: ScheduledBatch) -> list[RequestOutput]:
        outputs: list[RequestOutput] = []
        reqs = [r for r in batch.requests if not r.finished]
        bm = self.block_manager
        ids = [r.request_id for r in reqs]
        while bm.decode_shortfall(ids) > 0:
            victim = self.scheduler.preempt_last()
            self.stats.preemptions += 1
            if victim is None:
                raise MemoryError("KV cache exhausted with a single sequence")
            reqs = [r for r in reqs if r is not victim]
            ids = [r.request_id for r in reqs]
            if not reqs:
                return outputs
        B = self.scheduler.decode_bucket(len(reqs))
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        slot_arr = np.full((B,), PAD_SLOT, np.int32)
        seq_lens = np.ones((B,), np.int32)
        block_tables = np.zeros((B, self.cache_cfg.max_blocks_per_seq), np.int32)
        if bm.charge_decode(ids, slot_arr):
            raise MemoryError("out of KV blocks on append")
        bm.fill_block_tables(ids, block_tables)
        for i, req in enumerate(reqs):
            tokens[i] = req.output_token_ids[-1]
            positions[i] = req.num_tokens - 1
            seq_lens[i] = req.num_tokens
        logits, self.kv_cache = transformer.decode_step(
            self.params, self.model_cfg, self._tensor(tokens),
            self._tensor(positions), self._tensor(slot_arr),
            self._tensor(block_tables), self._tensor(seq_lens), self.kv_cache,
            attn_impl=self.attn_impl)
        self.stats.num_decode_steps += 1
        new_tokens = self._sample(logits, reqs, B)
        return outputs + [self._emit_one(r, int(t))
                          for r, t in zip(reqs, new_tokens)]

    def _run_decode_multi(self, batch: ScheduledBatch
                          ) -> Optional[list[RequestOutput]]:
        """A ``multi_step``-token decode window in one dispatch: sampled
        tokens feed the next iteration on the device and the host reads the
        (B, S) window once.  Tokens past a request's stop point (EOS,
        max_tokens, stop string mid-window) are dropped at emit.  Returns
        None, before any side effect, when the cache cannot reserve the
        window (the caller then runs a single step, which may preempt)."""
        S = self._multi_step
        reqs = [r for r in batch.requests if not r.finished]
        cap = self.cache_cfg.max_blocks_per_seq * self.cache_cfg.block_size
        if any(r.num_tokens - 1 + S > cap for r in reqs):
            return None
        ids = [r.request_id for r in reqs]
        if not self.block_manager.reserve_batch(
                ids, [r.num_tokens - 1 + S for r in reqs]):
            return None
        B = self.scheduler.decode_bucket(len(reqs))
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        seq_lens = np.ones((B,), np.int32)
        active = np.zeros((B,), bool)
        block_tables = np.zeros((B, self.cache_cfg.max_blocks_per_seq), np.int32)
        for i, r in enumerate(reqs):
            tokens[i] = r.output_token_ids[-1]
            positions[i] = r.num_tokens - 1
            seq_lens[i] = r.num_tokens
            active[i] = True
        self.block_manager.fill_block_tables(ids, block_tables)
        mode, temperature, gens = self._sampling_inputs(reqs, B)
        if temperature is None:
            temperature = self._tensor(np.zeros((B,), np.float32))
        toks, self.kv_cache = transformer.decode_multi(
            self.params, self.model_cfg, self._tensor(tokens),
            self._tensor(positions), self._tensor(block_tables),
            self._tensor(seq_lens), self._tensor(active), temperature,
            self.kv_cache, steps=S, mode=mode, generators=gens,
            attn_impl=self.attn_impl)
        toks_h = toks.cpu().numpy()              # the window's one host read
        self.stats.num_decode_steps += S
        self.stats.num_decode_windows += 1
        # commit the written KV before emitting (a finish frees blocks)
        self.block_manager.advance_batch(ids, S)
        outputs = []
        for i, r in enumerate(reqs):
            for s in range(S):
                out = self._emit_one(r, int(toks_h[i, s]))
                outputs.append(out)
                if out.finished:
                    self.stats.window_overrun_tokens += S - 1 - s
                    break
        return outputs

    # ---- bookkeeping --------------------------------------------------

    def _emit_one(self, req: Request, tok: int,
                  from_prefill: bool = False) -> RequestOutput:
        req.output_token_ids.append(tok)
        self.stats.generated_tokens += 1
        delta = self._detok[req.request_id].add(tok)
        reason = None
        if req.params.stop:
            delta, stopped = self._match_stop(req, delta)  # mutates output_text
            if stopped:
                reason = FinishReason.STOP
        else:
            req.output_text += delta
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
            self._release(req.request_id)
        return RequestOutput(
            request_id=req.request_id, new_token_ids=[tok], new_text=delta,
            finished=finished, finish_reason=reason,
            num_prompt_tokens=req.num_prompt_tokens,
            num_output_tokens=len(req.output_token_ids),
            from_prefill=from_prefill)

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
