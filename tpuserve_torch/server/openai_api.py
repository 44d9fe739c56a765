"""OpenAI-compatible HTTP server over the port's engine: the port of
``tpuserve/server/openai_api.py`` (stdlib HTTP, no web framework).

Serves ``GET /v1/models``, ``/v1/models/{id}``, ``/metrics``, ``/healthz``
(liveness, with the brownout level, ``cold_start_s`` and the JAX server's
cache-affinity fields: KV blocks by tier and the prefix digest,
``server/kv_digest.py``), ``/readyz`` and the flight recorder's
``/debug/engine``, ``/debug/engine/dump`` and ``/debug/requests/{id}``
(``runtime/flight.py``; 404 with the recorder off); ``POST
/v1/completions`` and ``/v1/chat/completions``, streamed (SSE) or not,
``/v1/embeddings`` and ``/tokenize`` / ``/detokenize``.  Each API request is one span
(``server/tracing.py``: OTLP when an exporter is configured), its parent
the incoming ``traceparent``, its engine timeline the child spans.

Every sampling option of the JAX server is served: top_k/top_p/min_p, the
penalties, ``logit_bias``, ``min_tokens``, ``logprobs``/``top_logprobs``
(in the completions and chat shapes, full or streamed), ``best_of > n``
(candidates ranked by cumulative logprob) and guided decoding
(``response_format`` json_object / json_schema, ``guided_regex``,
``guided_choice``; a bad schema, pattern or choice list is a 400 with the
JAX server's message) and tool calls (``tools`` / ``tool_choice`` on the
chat route, full and streamed: ``server/tool_calls.py``), and the prompt's
own logprobs: prompt scoring (``max_tokens=0`` with ``echo`` and
``logprobs``), vLLM's ``prompt_logprobs`` and ``echo`` with ``logprobs``,
full and streamed.  ``/v1/embeddings`` takes a string, a list of strings,
token ids or lists of them, ``encoding_format`` float or base64 and
``dimensions`` (truncated and re-normalised).

Multi-LoRA (``--lora-modules NAME=DIR``), as the JAX server: ``/v1/models``
lists each adapter with the base model as its ``parent``; a completion or
chat request whose ``model`` names an adapter is served by it and the
response's ``model`` echoes it; embeddings, ``prompt_logprobs`` and prompt
scoring refuse an adapter with a 400 (their trunks are the base model's).

SLO classes (``slo_class`` in the body, the ``X-SLO-Class`` header, or the
tenant's default) reach the engine's controller (``runtime/slo.py``): a
request the brownout ladder sheds, or one evicted from a full queue for a
stricter arrival, is answered 429 with ``Retry-After`` (type
``overloaded``), streamed or not.

The JAX server's services around one card, as its own:
- tenants (``server/tenants.py``, ``--tenant-config``): an API key or a
  LoRA adapter is a tenant; a request is charged its estimated tokens at
  intake (429 ``rate_limit_exceeded`` with ``Retry-After`` when its token
  bucket is short) and settled with what was served; an
  ``X-TPUServe-Canary`` probe is neither charged nor in any SLI;
- in-process SLO burn rates (``obs/``, ``--slo-objectives``,
  ``--no-slo-burn``): the runner's evaluator, ``tpuserve_slo_*`` on
  ``/metrics`` and ``slo`` on ``/debug/engine``;
- ``/debug/profile?seconds=S`` (GET or POST): a ``torch.profiler`` trace
  (``server/tracing.py``), 409 while another runs;
- the card's gauges from NVML (``server/gpu_metrics.py``,
  ``ServerConfig.tpu_metrics``);
- the model pool (``modelpool/``, ``--model-catalog``): a request whose
  ``model`` names another registered model parks until the engine swaps to
  it at an idle boundary (``--swap-policy swap``) or gets a 503 with
  ``Retry-After`` (``reject``); ``/v1/models`` lists the catalog with each
  model's tier, ``/debug/engine`` the pool's ``modelpool`` state.

Handler threads make no CUDA call: they tokenize, queue and write JSON.
Every step, graph capture and device copy runs on the runner's loop thread
(``server/runner.py``); embeddings and prompt scoring run there too, between
two steps (``AsyncEngineRunner.call``).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import math
import os
import queue
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import unquote

import numpy as np

from tpuserve_torch.models.tokenizer import default_chat_template
from tpuserve_torch.runtime.request import SamplingParams
from tpuserve_torch.runtime.slo import SLO_CLASSES, ShedError
from tpuserve_torch.server.kv_digest import (
    AFFINITY_PREFIX_CHARS, PrefixDigestTracker, affinity_key)
from tpuserve_torch.server.metrics import ServerMetrics
from tpuserve_torch.server.runner import AsyncEngineRunner
from tpuserve_torch.server.tenants import TenantRegistry, estimate_cost
from tpuserve_torch.server.tool_calls import ToolContext, normalize_messages
from tpuserve_torch.server.tracing import emit_timeline_spans, extract_context, get_tracer
from tpuserve_torch.utils import env_flag

logger = logging.getLogger("tpuserve_torch.server")


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's default accept backlog is 5: a burst of simultaneous
    # connects (batch arrivals) would be reset before a handler runs
    request_queue_size = 128


@dataclasses.dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 8000
    served_model_name: Optional[str] = None     # defaults to the engine's model
    max_tokens_cap: int = 4096
    request_timeout_s: float = 600.0
    # Jinja chat-template text overriding the tokenizer's
    chat_template: Optional[str] = None
    # Retry-After seconds on the drain-time 503
    drain_retry_after_s: int = 1
    # tool-call parser ("hermes", "mistral", "llama3_json"); None infers it
    # from the model family (server/tool_calls.py)
    tool_call_parser: Optional[str] = None
    # (B, T) embeddings-trunk buckets run at startup (--warmup-embed)
    warmup_embed: tuple = ()
    # the card's own gauges on /metrics (server/gpu_metrics.py, NVML under
    # the DCGM exporter's names); the JAX field's name, kept
    tpu_metrics: bool = True
    # per-tenant metering and rate limits (server/tenants.py): inline JSON
    # or a file path; None = TPUSERVE_TENANTS (unset: metering only, all
    # under tenant "default")
    tenant_config: Optional[str] = None
    # the in-process SLO burn-rate evaluator (obs/); TPUSERVE_SLO_BURN=0
    # also removes it
    slo_burn: bool = True
    # objectives override (obs/objectives.py): inline JSON or a file path;
    # None = TPUSERVE_SLO_OBJECTIVES, else the defaults.  Validated here
    slo_objectives: Optional[str] = None
    # the model pool (modelpool/): a catalog (JSON object of name ->
    # checkpoint dir, or a comma-separated name list); None =
    # TPUSERVE_MODEL_CATALOG; none means no pool
    model_catalog: Optional[str] = None
    swap_policy: str = "swap"              # "swap" | "reject"
    max_resident_models: int = 1           # weight sets on the card at once
    weight_host_bytes: int = 0             # 0 = TPUSERVE_WEIGHT_HOST_BYTES or 2 GiB
    weight_spill_dir: Optional[str] = None  # None = TPUSERVE_WEIGHT_SPILL_DIR
    # Retry-After seconds of swap_policy="reject" 503s
    swap_retry_after_s: int = 5
    # accept KV migrations from prefill pods on POST /internal/migrate and
    # their aborts on /internal/abort (parallel/disagg_net.py); off unless
    # the pod is a decode pool (--role decode)
    allow_kv_migration: bool = False


def _num(body: dict, key: str, default, cast):
    """A numeric field; null falls back to the default; junk -> ValueError."""
    val = body.get(key)
    if val is None:
        return default
    try:
        return cast(val)
    except (TypeError, ValueError, OverflowError):
        # OverflowError: int(float('inf')); json.loads accepts Infinity
        raise ValueError(f"'{key}' must be a number, got {val!r}") from None


def _sampling_from_request(body: dict, cap: int) -> SamplingParams:
    """The request's SamplingParams, validated as the JAX server validates
    them (the same 400s): a guided spec is compiled here once (its
    schema, pattern or choice list), so that an unsupported one is a 400
    before any work is queued."""
    stop = body.get("stop") or ()
    if isinstance(stop, str):
        stop = (stop,)
    if not isinstance(stop, (list, tuple)) or not all(isinstance(s, str) for s in stop):
        raise ValueError("'stop' must be a string or list of strings")
    n_logprobs = body.get("logprobs")
    if isinstance(n_logprobs, bool):            # chat API sends a bool
        n_logprobs = _num(body, "top_logprobs", 5, int) if n_logprobs else None
    elif n_logprobs is not None:
        n_logprobs = _num(body, "logprobs", None, int)
    seed = body.get("seed")
    if seed is not None:
        seed = _num(body, "seed", None, int)
    bias = body.get("logit_bias")
    if bias is not None:
        if not isinstance(bias, dict) or len(bias) > 300:
            raise ValueError("'logit_bias' must be a {token_id: bias} object with at "
                             "most 300 entries")
        try:
            bias = {int(k): float(v) for k, v in bias.items()}
        except (TypeError, ValueError):
            raise ValueError("'logit_bias' keys must be token ids and values "
                             "numbers") from None
        if any(k < 0 or k >= 2**31 for k in bias):
            raise ValueError("'logit_bias' token ids must be in [0, 2**31)")
        if any(math.isnan(v) or math.isinf(v) for v in bias.values()):
            raise ValueError("'logit_bias' values must be finite")
        bias = {k: max(-100.0, min(100.0, v)) for k, v in bias.items()}
    stop_ids = body.get("stop_token_ids") or ()
    if stop_ids:
        if (not isinstance(stop_ids, (list, tuple)) or len(stop_ids) > 64
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           and 0 <= t < 2**31 for t in stop_ids)):
            raise ValueError("'stop_token_ids' must be a list of at most 64 token ids "
                             "in [0, 2**31)")
    min_p = _num(body, "min_p", 0.0, float)
    if not 0.0 <= min_p <= 1.0:                 # NaN fails both comparisons too
        raise ValueError("'min_p' must be in [0, 1]")
    temperature = _num(body, "temperature", 1.0, float)
    if not 0.0 <= temperature <= 100.0:
        raise ValueError("'temperature' must be in [0, 100]")
    top_k = _num(body, "top_k", 0, int)
    if not -(2**31) <= top_k < 2**31:
        raise ValueError("'top_k' must be a 32-bit integer (<=0 disables)")
    top_p = _num(body, "top_p", 1.0, float)
    if not 0.0 <= top_p <= 1.0:
        raise ValueError("'top_p' must be in [0, 1]")
    penalties = {}
    for pen, default in (("presence_penalty", 0.0), ("frequency_penalty", 0.0),
                         ("repetition_penalty", 1.0)):
        v = _num(body, pen, default, float)
        if not -1e6 <= v <= 1e6:
            raise ValueError(f"'{pen}' must be a finite number")
        penalties[pen] = v
    if n_logprobs is not None and not 0 <= n_logprobs <= 2**31 - 1:
        raise ValueError("'logprobs' must be a non-negative 32-bit integer")
    priority = _num(body, "priority", 0, int)
    if not -(2**31) <= priority < 2**31:
        raise ValueError("'priority' must be a 32-bit integer")
    slo_class = body.get("slo_class")
    if slo_class is not None and slo_class not in SLO_CLASSES:
        raise ValueError(f"'slo_class' must be one of {'/'.join(SLO_CLASSES)}, "
                         f"got {slo_class!r}")
    guided = guided_schema = None
    rf = body.get("response_format")
    if rf is not None:
        if not isinstance(rf, dict) or not isinstance(rf.get("type"), str):
            raise ValueError("'response_format' must be an object with a 'type'")
        if rf["type"] == "json_object":
            guided = "json"
        elif rf["type"] == "json_schema":
            js = rf.get("json_schema")
            if not isinstance(js, dict) or not isinstance(js.get("schema"), dict):
                raise ValueError("response_format json_schema needs a 'json_schema' "
                                 "object with a 'schema'")
            from tpuserve_torch.runtime.guided import SchemaError, compile_schema
            try:
                compile_schema(js["schema"])          # 400 on unsupported keywords
            except SchemaError as e:
                raise ValueError(f"unsupported json_schema: {e}") from None
            guided = "json_schema"
            guided_schema = json.dumps(js["schema"])
        elif rf["type"] != "text":
            raise ValueError(f"unknown response_format type {rf['type']!r}")
    if body.get("guided_regex") is not None:
        if guided is not None:
            raise ValueError("'guided_regex' cannot be combined with response_format "
                             "json modes")
        if not isinstance(body["guided_regex"], str):
            raise ValueError("'guided_regex' must be a string pattern")
        from tpuserve_torch.runtime.guided_regex import RegexError, compile_regex
        try:
            compile_regex(body["guided_regex"])       # 400 on unsupported syntax
        except RegexError as e:
            raise ValueError(f"unsupported guided_regex: {e}") from None
        guided, guided_schema = "regex", body["guided_regex"]
    if body.get("guided_choice") is not None:
        if guided is not None:
            raise ValueError("'guided_choice' cannot be combined with other guided modes")
        from tpuserve_torch.runtime.guided_choice import ChoiceError, compile_choices
        try:
            choices = compile_choices(body["guided_choice"])     # 400 on bad lists
        except ChoiceError as e:
            raise ValueError(f"unsupported guided_choice: {e}") from None
        guided, guided_schema = "choice", json.dumps(list(choices))
    tpt = _num(body, "truncate_prompt_tokens", None, int)
    if tpt is not None and tpt < 1:
        raise ValueError("'truncate_prompt_tokens' must be >= 1")
    plp = _num(body, "prompt_logprobs", None, int)
    if plp is not None and plp < 0:
        raise ValueError("'prompt_logprobs' must be >= 0")
    max_tokens = min(_num(body, "max_tokens", 16, int), cap)
    if max_tokens < 0:
        raise ValueError("'max_tokens' must be >= 0 (0 only for prompt scoring: "
                         "completions with echo + logprobs)")
    return SamplingParams(
        max_tokens=max_tokens,
        min_tokens=max(0, min(_num(body, "min_tokens", 0, int), max_tokens)),
        temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
        presence_penalty=penalties["presence_penalty"],
        frequency_penalty=penalties["frequency_penalty"],
        repetition_penalty=penalties["repetition_penalty"],
        stop=tuple(stop), ignore_eos=bool(body.get("ignore_eos", False)),
        include_stop_str_in_output=bool(body.get("include_stop_str_in_output", False)),
        seed=seed, logprobs=n_logprobs, logit_bias=bias,
        stop_token_ids=tuple(stop_ids), guided=guided, guided_schema=guided_schema,
        priority=priority,
        slo_class=slo_class or "standard", truncate_prompt_tokens=tpt)


class OpenAIServer:
    """HTTP front end over an AsyncEngineRunner."""

    MAX_CHOICES = 8

    def __init__(self, engine, config: ServerConfig | None = None,
                 metrics: ServerMetrics | None = None):
        self.config = config or ServerConfig()
        self.model_name = self.config.served_model_name or engine.config.model
        # multi-LoRA adapter names (the engine's stack), served as models
        self.lora_names = list(getattr(engine, "_lora_names", None) or [])
        self.metrics = metrics or ServerMetrics(self.model_name)
        self.runner = AsyncEngineRunner(engine, self.metrics)
        self.engine = engine
        # affinity keys of the prompts served, advertised on /healthz
        self.kv_digest = PrefixDigestTracker()
        # tenants: an empty registry still meters everything as "default"
        # and resolves LoRA adapters as tenants
        self.tenants = TenantRegistry.load(self.config.tenant_config) or TenantRegistry()
        # the burn-rate evaluator, validated at boot: bad objectives fail
        # the server, not the alert
        if self.config.slo_burn and env_flag("TPUSERVE_SLO_BURN"):
            from tpuserve_torch.obs import BurnRateEvaluator, load_objectives
            self.runner.slo_eval = BurnRateEvaluator(
                load_objectives(self.config.slo_objectives), clock=self.runner._clock)
        # the model pool: no catalog (or TPUSERVE_MODELPOOL=0) makes none,
        # and every consumer checks for None
        self.pool = None
        from tpuserve_torch.modelpool import (ModelPool, ModelPoolConfig, parse_catalog,
                                              pool_enabled)
        catalog = parse_catalog(self.config.model_catalog
                                or os.environ.get("TPUSERVE_MODEL_CATALOG"))
        if catalog and pool_enabled():
            if not hasattr(engine, "config"):
                raise ValueError("--model-catalog needs a plain single engine")
            self.pool = ModelPool(engine.config, ModelPoolConfig(
                catalog=catalog, max_resident=self.config.max_resident_models,
                swap_policy=self.config.swap_policy,
                host_bytes=self.config.weight_host_bytes,
                spill_dir=self.config.weight_spill_dir,
                retry_after_s=self.config.swap_retry_after_s))
            self.runner.pool = self.pool
            logger.info("model pool: catalog=%s max_resident=%d policy=%s",
                        self.pool.models(), self.config.max_resident_models,
                        self.config.swap_policy)
        self.gpu_exporter = None
        if self.config.tpu_metrics:
            from tpuserve_torch.server.gpu_metrics import GpuMetricsExporter
            try:
                self.gpu_exporter = GpuMetricsExporter(self.metrics)
                self.runner.on_step_time = self.gpu_exporter.record_busy
            except OSError as e:
                logger.info("card metrics off: NVML unavailable (%s)", e)
        self.ready = threading.Event()
        self.draining = False          # drain(): reject new work, finish old
        # live POST handlers: drain() waits for delivery, not only for the
        # engine to queue the last token
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._chat_template = None
        if self.config.chat_template:
            import jinja2
            self._chat_template = jinja2.Template(self.config.chat_template)

    # ---- lifecycle -----------------------------------------------------

    def start(self, warmup: bool = False) -> int:
        """Start the engine loop, warm the engine's executables (on this
        thread, before any request can arrive) and open the listener;
        returns the bound port."""
        self.runner.start()
        if self.gpu_exporter is not None:
            self.gpu_exporter.start()
        if warmup:
            # embed buckets opt-in, as the JAX server's
            self.engine.warmup(embed_buckets=self.config.warmup_embed)
        server = self

        class Handler(_Handler):
            ctx = server

        self._httpd = _HTTPServer((self.config.host, self.config.port), Handler)
        self._serve_thread = threading.Thread(target=self._httpd.serve_forever,
                                              daemon=True, name="tpuserve-torch-http")
        self._serve_thread.start()
        self.ready.set()
        port = self._httpd.server_address[1]
        logger.info("serving %s on %s:%d", self.model_name, self.config.host, port)
        return port

    def _handler_enter(self) -> None:
        with self._inflight_lock:
            self._inflight += 1

    def _handler_exit(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    def drain(self, timeout_s: float = 25.0) -> bool:
        """Graceful shutdown: /readyz turns 503, new requests get a
        retryable 503, in-flight ones finish, then everything stops.
        Returns True when all drained inside the timeout."""
        self.draining = True
        self.ready.clear()
        deadline = time.monotonic() + timeout_s
        drained = False
        while time.monotonic() < deadline:
            if self.runner.idle() and self._inflight == 0:
                drained = True
                break
            time.sleep(0.05)
        if not drained:
            logger.warning("drain timed out with work in flight")
        self.shutdown()
        return drained

    def shutdown(self) -> None:
        self.ready.clear()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.runner.shutdown()
        if self.gpu_exporter is not None:
            self.gpu_exporter.stop()

    def healthz_payload(self) -> dict:
        """Liveness plus the cache-affinity advertisement, the JAX
        ``_healthz_payload``'s fields: KV blocks by tier and the prefix
        digest, whose window grows with the replica's cache reach across
        the tiers.  Reads counts only (no block state the loop owns) and
        never fails liveness on them."""
        out: dict = {"status": "ok"}
        try:
            out["brownout_level"] = self.engine.stats.brownout_level
            out["cold_start_s"] = self.runner.cold_start_s
            tiers = self.engine.kv_tier_blocks()
            out["kv_tier_blocks"] = tiers
            # reach is in blocks; a tracked key is a whole prompt prefix
            # (several blocks), so the window approximates conversations
            reach = self.engine.block_manager.num_blocks + tiers["host"] + tiers["spill"]
            self.kv_digest.resize(max(4096, reach // 4))
            out["kv_digest"] = self.kv_digest.digest_hex()
            out["kv_digest_bits"] = self.kv_digest.bits
            # the prefix length the keys were hashed with: a gateway probes
            # membership with this server's value
            out["kv_digest_chars"] = AFFINITY_PREFIX_CHARS
            if self.pool is not None:
                # the catalog with each model's tier (the gateway's routing)
                out["models"] = self.pool.catalog_status()
                out["model_current"] = self.pool.current
        except Exception:
            logger.exception("healthz telemetry")
        return out

    # ---- request parsing (handler threads) -----------------------------

    def parse_n(self, body: dict) -> int:
        n = body.get("n", 1)
        if not isinstance(n, int) or not 1 <= n <= self.MAX_CHOICES:
            raise ValueError(f"'n' must be an integer in 1..{self.MAX_CHOICES}")
        return n

    def parse_best_of(self, body: dict, n: int, chat: bool, params) -> int:
        """OpenAI completions ``best_of``, validated as the JAX server does:
        ``best_of`` candidates are sampled and the top n by cumulative
        logprob of their tokens are returned (the vLLM ranking); greedy
        candidates would be identical, so that is refused."""
        best_of = body.get("best_of")
        if best_of is None:
            return n
        if chat:
            raise ValueError("'best_of' is a completions parameter (not supported on chat)")
        if not isinstance(best_of, int) or not n <= best_of <= self.MAX_CHOICES:
            raise ValueError(f"'best_of' must be an integer in n..{self.MAX_CHOICES}")
        if best_of > n:
            if body.get("stream"):
                raise ValueError("cannot stream with best_of > n: ranking needs every "
                                 "candidate finished")
            if params.greedy:
                raise ValueError("best_of > n requires sampling (temperature > 0); greedy "
                                 "candidates would be identical")
            if params.guided is not None:
                raise ValueError("best_of > n cannot be combined with response_format "
                                 "(ranking records logprobs, which guided decoding forbids)")
        return best_of

    def handle_completion(self, body: dict, chat: bool):
        """(prompt text or token ids, SamplingParams, ToolContext or None).
        A chat request's tools ride its template; a forced call
        (``tool_choice`` required or named) appends the parser's prefix to
        the prompt, and the same prefix is put back before the output is
        parsed."""
        toolctx = None
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                raise ValueError("'messages' must be a non-empty list")
            messages = normalize_messages(messages)
            toolctx = ToolContext.from_body(body, self.model_name,
                                            self.config.tool_call_parser)
            tools = toolctx.raw_tools if toolctx else None
            tok = self.engine.tokenizer
            if self._chat_template is not None:
                prompt = self._chat_template.render(messages=messages,
                                                    add_generation_prompt=True, tools=tools)
            elif hasattr(tok, "apply_chat_template"):
                prompt = tok.apply_chat_template(messages, tools=tools)
            else:
                instr = (toolctx.parser.prompt_instruction(json.dumps(tools))
                         if toolctx else None)
                prompt = default_chat_template(messages, tools=tools, tool_instruction=instr)
            if toolctx is not None and toolctx.forced:
                prompt += toolctx.forced
        else:
            prompt = body.get("prompt")
            if isinstance(prompt, list):
                if prompt and isinstance(prompt[0], int):
                    return (prompt, _sampling_from_request(body, self.config.max_tokens_cap),
                            None)
                if len(prompt) != 1:
                    raise ValueError("batched prompt lists are not supported; send one "
                                     "request per prompt")
                prompt = prompt[0]
            if not isinstance(prompt, str) or not prompt:
                raise ValueError("'prompt' must be a non-empty string")
        return prompt, _sampling_from_request(body, self.config.max_tokens_cap), toolctx

    # ---- the flight recorder's views (handler threads: snapshots only) --

    def debug_engine_payload(self) -> dict:
        """/debug/engine: the recorder's snapshot (recent step records with
        their host phases, recent request ids, client SLIs, control
        scalars, post-mortem pointers), ``cold_start_s`` and the compile
        caches; ``{"enabled": False}`` with the recorder off."""
        flights = self.runner._flights()
        if not flights:
            out = {"enabled": False}
            if self.pool is not None:
                out["modelpool"] = self.pool.status()
            return out
        out = flights[0].engine_snapshot()
        out["cold_start_s"] = self.runner.cold_start_s
        ev = self.runner.slo_eval
        if ev is not None:
            # the loop thread's last published state
            out["slo"] = dict(ev.last_state)
        out["compile_caches"] = self.engine.compile_cache_stats()
        if self.pool is not None:
            out["modelpool"] = self.pool.status()
        return out

    def emit_engine_spans(self, rids) -> None:
        """Each request's flight timeline as child spans of the current
        request span; a no-op unless an OTLP exporter is configured."""
        tracer = get_tracer()
        if not tracer.active:
            return
        for fl in self.runner._flights():
            for rid in rids:
                timeline = fl.request_timeline(rid)
                if timeline:
                    emit_timeline_spans(tracer, timeline, fl.wall_of)


def _status_of(exc: Exception) -> tuple[int, str, Optional[dict]]:
    """HTTP status, error type and headers of a request's failure."""
    if isinstance(exc, (ValueError, NotImplementedError)):
        return 400, "invalid_request_error", None
    if isinstance(exc, ShedError):
        # a brownout shed or a queue-full class eviction: retryable, with
        # the ladder's own backoff
        return 429, "overloaded", {"Retry-After": str(int(exc.retry_after_s) + 1)}
    if isinstance(exc, MemoryError):
        # admission backpressure (a full waiting queue): retryable
        return 503, "server_error", {"Retry-After": "1"}
    if isinstance(exc, TimeoutError):
        return 504, "server_error", None
    return 500, "server_error", None


class _Handler(BaseHTTPRequestHandler):
    # per-token SSE events are small writes: no Nagle delay
    disable_nagle_algorithm = True
    ctx: OpenAIServer
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        logger.debug("%s " + fmt, self.address_string(), *args)

    # ---- helpers -------------------------------------------------------

    def _json(self, code: int, payload: dict, headers: Optional[dict] = None) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _error(self, code: int, message: str, etype: str = "invalid_request_error",
               headers: Optional[dict] = None) -> None:
        self._json(code, {"error": {"message": message, "type": etype}}, headers=headers)

    def _fail(self, exc: Exception) -> None:
        code, etype, headers = _status_of(exc)
        self._error(code, str(exc), etype, headers=headers)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            raise ValueError("missing request body")
        if length > 10 * 1024 * 1024:
            # the unread body would be parsed as the next request line
            self.close_connection = True
            raise ValueError("request body too large")
        body = json.loads(self.rfile.read(length))
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        return body

    # ---- routes --------------------------------------------------------

    def do_GET(self):
        ctx = self.ctx
        eng = ctx.engine
        if self.path == "/v1/models":
            now = int(time.time())
            # loaded LoRA adapters are selectable models, their parent the
            # base (vLLM's --lora-modules listing)
            data = [{"id": ctx.model_name, "object": "model", "created": now,
                     "owned_by": "tpuserve", "max_model_len": eng.max_seq_len,
                     "quantization": eng.config.quantization,
                     "kv_cache_dtype": eng.cache_cfg.dtype}]
            data += [{"id": name, "object": "model", "created": now, "owned_by": "tpuserve",
                      "parent": ctx.model_name} for name in ctx.lora_names]
            if ctx.pool is not None:
                # the catalog, each with its tier (serving, resident, host,
                # spill, cold)
                data += [{"id": name, "object": "model", "created": now,
                          "owned_by": "tpuserve", "tier": ctx.pool.tier_of(name)}
                         for name in ctx.pool.models() if name != ctx.model_name]
            self._json(200, {"object": "list", "data": data})
        elif self.path.startswith("/v1/models/"):
            # ids may contain '/', e.g. Qwen/Qwen3-0.6B: match the raw suffix
            wanted = unquote(self.path[len("/v1/models/"):])
            if wanted == ctx.model_name:
                self._json(200, {"id": wanted, "object": "model",
                                 "created": int(time.time()), "owned_by": "tpuserve"})
            elif wanted in ctx.lora_names:
                self._json(200, {"id": wanted, "object": "model",
                                 "created": int(time.time()), "owned_by": "tpuserve",
                                 "parent": ctx.model_name})
            elif ctx.pool is not None and ctx.pool.is_registered(wanted):
                self._json(200, {"id": wanted, "object": "model",
                                 "created": int(time.time()), "owned_by": "tpuserve",
                                 "tier": ctx.pool.tier_of(wanted)})
            else:
                self._error(404, f"model {wanted!r} not found")
        elif self.path == "/metrics":
            data = ctx.metrics.render()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif self.path == "/healthz":
            self._json(200, ctx.healthz_payload())
        elif self.path == "/readyz":
            if ctx.ready.is_set():
                self._json(200, {"status": "ready"})
            else:
                self._error(503, "not ready", "server_error")
        elif self.path == "/debug/engine":
            self._json(200, ctx.debug_engine_payload())
        elif self.path == "/debug/engine/dump":
            # a replay-ready bundle on demand, in the post-mortems' format;
            # snapshot reads only, the engine keeps serving
            flights = ctx.runner._flights()
            if not flights:
                self._error(404, "flight recorder disabled (TPUSERVE_FLIGHT=0): nothing to dump")
            else:
                bundle = flights[0].dump_bundle("on_demand")
                ctx.metrics.replay_dumps.inc()
                self._json(200, bundle)
        elif self.path.startswith("/debug/requests/"):
            rid = unquote(self.path[len("/debug/requests/"):])
            flights = ctx.runner._flights()
            timeline = flights[0].request_timeline(rid) if flights else []
            if timeline:
                self._json(200, {"request_id": rid, "events": timeline})
            elif not flights:
                self._error(404, "flight recorder disabled (TPUSERVE_FLIGHT=0)")
            else:
                self._error(404, f"no recorded events for {rid!r} (the ring holds the "
                                 "most recent TPUSERVE_FLIGHT_EVENTS events)")
        elif self.path.startswith("/debug/profile"):
            self._handle_profile()
        else:
            self._error(404, f"no route {self.path}")

    def _handle_profile(self) -> None:
        """A ``torch.profiler`` trace of ``seconds`` (default 2) of live
        serving: this handler waits, the engine keeps stepping, and the
        profiler starts and stops on the loop thread.  One capture at a
        time a process (409 otherwise); the trace lands under
        ``TPUSERVE_FLIGHT_DIR`` when set and is recorded on the engine's
        device profiler, so bundles name it."""
        from urllib.parse import parse_qs, urlparse
        from tpuserve_torch.server.tracing import CaptureBusy, capture_profile_locked
        ctx = self.ctx
        try:
            q = parse_qs(urlparse(self.path).query)
            seconds = float(q.get("seconds", ["2"])[0])
            self._json(200, capture_profile_locked(
                seconds, reason="manual", profilers=[getattr(ctx.engine, "devprof", None)],
                call=ctx.runner.call))
        except CaptureBusy as e:
            self._error(409, str(e), "server_error")
        except ValueError as e:
            self._error(400, str(e))
        except Exception as e:
            logger.exception("profile capture failed")
            self._error(500, f"profile capture failed: {e}", "server_error")

    def do_POST(self):
        # enter BEFORE the draining check, or a thread descheduled between
        # the two could submit into an engine loop drain() already stopped
        self.ctx._handler_enter()
        # tenant accounting of this request (a keep-alive connection reuses
        # the handler)
        self._tenant = self._charged = None
        try:
            if self.ctx.draining:
                self._error(503, "server is draining; retry another replica",
                            "server_error", headers={
                                "Retry-After": str(self.ctx.config.drain_retry_after_s)})
                return
            self._do_post_inner()
        finally:
            # a request that failed before serving refunds its whole charge
            # (settling is once only: served paths settled already)
            self._settle_tenant(0)
            self.ctx._handler_exit()

    # ---- cross-pod disaggregation (the decode pool's side) ---------------

    MAX_MIGRATION_BYTES = 1 << 30      # KV pages for one long sequence

    def _handle_migrate(self):
        """Adopt a sequence prefilled by a prefill pod and stream its
        remaining tokens back as JSON lines over a close-delimited response
        (``parallel/disagg_net.py`` is the peer), as the JAX server."""
        ctx = self.ctx
        if not ctx.config.allow_kv_migration:
            self._error(403, "this pod is not a decode pool (start with --role decode)")
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            if not 0 < length <= self.MAX_MIGRATION_BYTES:
                self.close_connection = True
                raise ValueError(f"bad migration payload size {length}")
            from tpuserve_torch.parallel.disagg_net import deserialize_migration
            meta, seq_kv = deserialize_migration(self.rfile.read(length))
        except ValueError as e:
            self._error(400, str(e))
            return
        try:
            rid, q = ctx.runner.submit_prefilled(meta, seq_kv)
        except MemoryError as e:
            self._error(503, str(e), "server_error")   # the pool is full: back off
            return
        except Exception as e:
            self._error(400, str(e))
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        deadline = time.monotonic() + ctx.config.request_timeout_s
        try:
            while True:
                try:
                    item = q.get(timeout=max(deadline - time.monotonic(), 0.001))
                except queue.Empty:
                    ctx.runner.abort(rid)
                    break
                if item is None or isinstance(item, Exception):
                    break
                line = json.dumps({
                    "new_token_ids": item.new_token_ids, "new_text": item.new_text,
                    "finished": item.finished,
                    "finish_reason": item.finish_reason.value if item.finish_reason else None,
                }) + "\n"
                self.wfile.write(line.encode())
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            # the prefill pod went away (its client aborted): stop generating
            ctx.runner.abort(rid)
        finally:
            ctx.engine.requests.pop(rid, None)

    def _handle_internal_abort(self):
        """Drop an adopted request: a prefill pod's cleanup after an
        ambiguous migration (its 200 lost in flight), before it decodes the
        request itself, so that no request is decoded on both pods."""
        ctx = self.ctx
        if not ctx.config.allow_kv_migration:
            self._error(403, "this pod is not a decode pool (start with --role decode)")
            return
        try:
            rid = self._read_body()["request_id"]
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._error(400, f"bad abort request: {e}")
            return
        aborted = rid in ctx.engine.requests
        ctx.runner.abort(rid)
        ctx.engine.requests.pop(rid, None)
        self._json(200, {"request_id": rid, "aborted": bool(aborted)})

    def _settle_tenant(self, actual: int) -> None:
        """Settle the tenant's rate-limit charge against the tokens served
        and meter them; the first call of a request wins."""
        charged, tenant = self._charged, self._tenant
        if tenant is None or charged is None:
            return
        self._charged = None
        self.ctx.tenants.settle(tenant, charged, actual)
        if actual:
            self.ctx.metrics.tenant_tokens.labels(model_name=self.ctx.model_name,
                                                  tenant=tenant).inc(actual)

    def _do_post_inner(self):
        if self.path == "/internal/migrate":
            self._handle_migrate()
            return
        if self.path == "/internal/abort":
            self._handle_internal_abort()
            return
        if self.path.startswith("/debug/profile"):
            self._handle_profile()
            return
        if self.path in ("/tokenize", "/detokenize"):
            self._handle_tokenize(self.path == "/tokenize")
            return
        if self.path == "/v1/embeddings":
            self._handle_embeddings()
            return
        chat = self.path == "/v1/chat/completions"
        if self.path not in ("/v1/completions", "/v1/chat/completions"):
            self._error(404, f"no route {self.path}")
            return
        ctx = self.ctx
        try:
            body = self._read_body()
            if not chat and body.get("suffix") is not None:
                raise ValueError("'suffix' is not supported")
            prompt, params, toolctx = ctx.handle_completion(body, chat)
            n = ctx.parse_n(body)
            best_of = ctx.parse_best_of(body, n, chat, params)
            stream = bool(body.get("stream", False))
            if "stream_options" in body and not isinstance(body.get("stream_options"),
                                                           dict):
                raise ValueError("'stream_options' must be an object")
            # a synthetic canary probe (obs/canary.py) is served like any
            # request of its class but never charged to a tenant, noted in
            # the affinity digest or counted in an SLI
            from tpuserve_torch.obs.canary import is_canary_header
            canary = is_canary_header(self.headers.get("X-TPUServe-Canary"))
            if canary:
                params = dataclasses.replace(params, canary=True)
            tenant = None if canary else ctx.tenants.resolve(
                self.headers.get("Authorization"), body.get("model"), tuple(ctx.lora_names))
            self._tenant = tenant
            if body.get("slo_class") is None:
                # body field > X-SLO-Class header > tenant default > standard
                cls = self.headers.get("X-SLO-Class") or ctx.tenants.slo_class_for(tenant)
                if cls is not None:
                    if cls not in SLO_CLASSES:
                        raise ValueError(f"X-SLO-Class must be one of "
                                         f"{'/'.join(SLO_CLASSES)}, got {cls!r}")
                    params = dataclasses.replace(params, slo_class=cls)
            if body.get("prompt_logprobs") is not None and stream:
                raise ValueError("prompt_logprobs is not supported with stream=true; use "
                                 "echo+logprobs for streamed prompt logprobs")
            if params.max_tokens == 0 and (
                    chat or stream or not body.get("echo") or params.logprobs is None
                    or n != 1 or body.get("prompt_logprobs") is not None):
                raise ValueError("max_tokens=0 is prompt scoring: requires completions "
                                 "with echo=true and logprobs, non-streaming, n=1 (and "
                                 "not combined with prompt_logprobs — it would be "
                                 "redundant)")
        except (ValueError, NotImplementedError, json.JSONDecodeError) as e:
            self._error(400, str(e))
            return
        cost = estimate_cost(body)
        retry = None if canary else ctx.tenants.charge(tenant, cost)
        if retry is not None:
            ctx.metrics.tenant_rate_limited.labels(model_name=ctx.model_name,
                                                   tenant=tenant).inc()
            self._error(429, f"tenant {tenant!r} token rate limit exceeded; retry in "
                             f"{retry:.1f}s", "rate_limit_exceeded",
                        headers={"Retry-After": str(int(retry) + 1)})
            return
        self._charged = None if canary else cost
        # the affinity key is noted only once every validation passed: a
        # 400 caches no KV and must not steer a gateway here
        if not canary:
            ctx.kv_digest.note(affinity_key(body))
        kwargs = ({"prompt_token_ids": prompt} if isinstance(prompt, list)
                  else {"prompt": prompt})
        # multi-LoRA routing (vLLM semantics): "model" naming a loaded
        # adapter selects it; the base name (or any other alias) serves base
        adapter = body.get("model")
        if (isinstance(adapter, str) and adapter != ctx.model_name
                and adapter in ctx.lora_names):
            kwargs["adapter"] = adapter
            # the scoring trunk has no adapter threading: base-model prompt
            # logprobs beside adapter completions would be wrong
            if body.get("prompt_logprobs") is not None:
                self._error(400, "prompt_logprobs is served by the base model; drop "
                                 f"it or use model={ctx.model_name!r}")
                return
            if not chat and body.get("echo") and params.logprobs is not None:
                self._error(400, "echo+logprobs (prompt scoring) is served by the "
                                 "base model; drop echo or use "
                                 f"model={ctx.model_name!r}")
                return
        elif ctx.pool is not None and isinstance(adapter, str):
            # the catalog: another registered model parks for a swap
            # ("swap") or gets a retryable 503 ("reject"); an unregistered
            # name serves whatever is current, as without a pool.  Demand is
            # noted either way (it starts a spill -> host prefetch)
            verdict = ctx.pool.route(adapter)
            if verdict in ("swap", "reject"):
                ctx.pool.note_demand(adapter)
            if verdict == "swap":
                kwargs["model"] = adapter
            elif verdict == "reject":
                ctx.pool.rejects += 1
                self._error(503, f"model {adapter!r} is registered but not resident on "
                                 "this replica; retry (routing prefers a warm replica)",
                            "server_error",
                            headers={"Retry-After": str(ctx.pool.cfg.retry_after_s)})
                return
        if "model" in kwargs and (params.max_tokens == 0 or body.get("echo")
                                  or body.get("prompt_logprobs") is not None):
            # scoring runs on the engine as it is: it cannot park for a swap
            self._error(400, "prompt scoring is served by the model now resident; retry "
                             f"once it is serving {kwargs['model']!r}")
            return
        if params.max_tokens == 0:
            # OpenAI prompt scoring: the prompt's own logprobs, no generation
            try:
                self._score_only_response(params, kwargs)
            except Exception as e:                    # scoring faults need a status too
                logger.exception("prompt scoring failed")
                self._fail(e)
            return
        try:
            # one span a request, its parent the incoming W3C traceparent
            with get_tracer().request_span(
                    self.path, context=extract_context(self.headers),
                    **{"gen_ai.request.model": ctx.model_name,
                       "gen_ai.request.max_tokens": params.max_tokens,
                       "tpuserve.stream": stream}):
                if stream:
                    # _stream_response owns its errors: once SSE headers are
                    # out, a second status line would corrupt the stream
                    self._stream_response(body, params, chat, kwargs, n, toolctx)
                else:
                    self._full_response(body, params, chat, kwargs, n, best_of, toolctx)
        except BrokenPipeError:
            pass
        except Exception as e:               # engine-side failure, pre-headers
            logger.exception("request failed")
            if not stream:
                try:
                    self._error(500, str(e), "server_error")
                except OSError:
                    pass

    def _handle_tokenize(self, encode: bool):
        """vLLM's /tokenize and /detokenize against the server's tokenizer."""
        eng = self.ctx.engine
        try:
            body = self._read_body()
            if encode:
                prompt = body.get("prompt")
                if not isinstance(prompt, str):
                    raise ValueError("'prompt' must be a string")
                ids = eng.tokenizer.encode(prompt)
                self._json(200, {"tokens": ids, "count": len(ids),
                                 "max_model_len": eng.max_seq_len})
            else:
                tokens = body.get("tokens")
                vocab = eng.model_cfg.vocab_size
                if (not isinstance(tokens, list)
                        or not all(isinstance(t, int) and not isinstance(t, bool)
                                   and 0 <= t < vocab for t in tokens)):
                    raise ValueError("'tokens' must be a list of token ids "
                                     f"in [0, {vocab})")
                self._json(200, {"prompt": eng.tokenizer.decode(tokens)})
        except (ValueError, json.JSONDecodeError) as e:
            self._error(400, str(e))

    def _handle_embeddings(self):
        """OpenAI /v1/embeddings, as the JAX server's: input str | [str] |
        [ids] | [[ids]]; ``encoding_format`` float (default) or base64;
        ``dimensions`` truncates and re-normalises.  Pooled from the
        cache-less trunk's final hidden states (``Engine.embed``), run on
        the loop thread."""
        ctx = self.ctx
        eng = ctx.engine
        try:
            body = self._read_body()
            if body.get("model") in ctx.lora_names:
                # /v1/models lists adapters, but the embed trunk has no
                # adapter threading: a base-model 200 would be wrong vectors
                raise ValueError(
                    f"model {body.get('model')!r} is a LoRA adapter; "
                    "embeddings are served by the base model only — "
                    f"use model={ctx.model_name!r}")
            raw = body.get("input")
            if isinstance(raw, str):
                inputs = [raw]
            elif isinstance(raw, list) and raw and all(
                    isinstance(t, int) and not isinstance(t, bool) for t in raw):
                inputs = [raw]                       # one token-id prompt
            elif isinstance(raw, list) and raw:
                inputs = raw
            else:
                raise ValueError("'input' must be a string, list of strings, or "
                                 "list(s) of token ids")
            vocab = eng.model_cfg.vocab_size
            for x in inputs:
                if isinstance(x, list) and not all(
                        isinstance(t, int) and not isinstance(t, bool) and 0 <= t < vocab
                        for t in x):
                    raise ValueError(f"token ids must be ints in [0, {vocab})")
                elif not isinstance(x, (str, list)):
                    raise ValueError("'input' items must be strings or token-id lists")
            fmt = body.get("encoding_format", "float")
            if fmt not in ("float", "base64"):
                raise ValueError("encoding_format must be 'float' or 'base64'")
            dims = body.get("dimensions")
            if dims is not None and (not isinstance(dims, int) or isinstance(dims, bool)
                                     or dims < 1):
                raise ValueError("'dimensions' must be a positive integer")
            vecs, counts = ctx.runner.call(lambda: eng.embed(inputs))
            if dims is not None:
                if dims > vecs.shape[1]:
                    raise ValueError(f"'dimensions' {dims} exceeds model embedding width "
                                     f"{vecs.shape[1]}")
                vecs = vecs[:, :dims]
                vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=-1, keepdims=True), 1e-12)
            data = []
            for i, v in enumerate(vecs):
                emb = (base64.b64encode(v.astype("<f4").tobytes()).decode() if fmt == "base64"
                       else [float(x) for x in v])
                data.append({"object": "embedding", "index": i, "embedding": emb})
            total = sum(counts)
            self._json(200, {"object": "list", "data": data, "model": ctx.model_name,
                             "usage": {"prompt_tokens": total, "total_tokens": total}})
        except (ValueError, json.JSONDecodeError) as e:
            self._error(400, str(e))
        except Exception as e:
            # an engine-side failure: a JSON 500, not a dropped connection
            logger.exception("embeddings failed")
            self._error(500, str(e), "server_error")

    def _prompt_ids(self, kwargs, params) -> list:
        """The prompt's token ids as the engine serves them: truncated to
        ``truncate_prompt_tokens``, so scoring sees the same context."""
        ids = (list(kwargs["prompt_token_ids"]) if "prompt_token_ids" in kwargs
               else list(self.ctx.engine.tokenizer.encode(kwargs["prompt"])))
        if params.truncate_prompt_tokens:
            ids = ids[-params.truncate_prompt_tokens:]
        return ids

    def _score_prompt(self, ids: list, top_n: int) -> list:
        """``Engine.score_prompts`` of one prompt, on the loop thread."""
        eng = self.ctx.engine
        return self.ctx.runner.call(lambda: eng.score_prompts([ids], top_n=top_n))[0]

    @staticmethod
    def _vllm_prompt_logprobs(pent, plp: int, tok) -> list:
        """vLLM's prompt_logprobs shape from scoring entries: one element a
        prompt token, None first (no conditional), then {token_id:
        {logprob, rank, decoded_token}} over the top ``plp`` alternatives
        and the chosen token, with full-vocabulary ranks."""
        out = [None]
        for e in pent[1:]:
            el = {}
            for i, (tid, lp) in enumerate(e["top"][:plp]):
                el[str(tid)] = {"logprob": lp, "rank": i + 1, "decoded_token": tok(tid)}
            el[str(e["token_id"])] = {"logprob": e["logprob"], "rank": e["rank"],
                                      "decoded_token": tok(e["token_id"])}
            out.append(el)
        return out

    def _score_only_response(self, params, kwargs):
        """OpenAI prompt scoring (completions, ``max_tokens=0``, ``echo``,
        ``logprobs``): the prompt's own logprobs, no generation."""
        ctx = self.ctx
        ids = self._prompt_ids(kwargs, params)
        try:
            entries = self._score_prompt(ids, params.logprobs)
        except ValueError as e:
            self._error(400, str(e))
            return
        text = kwargs.get("prompt")
        if text is None or params.truncate_prompt_tokens:
            # truncation: echo what actually conditioned the scoring
            text = ctx.engine.tokenizer.decode(ids)
        choice = {"index": 0, "text": text, "finish_reason": "length",
                  "logprobs": self._completions_logprobs(entries)}
        self._json(200, {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}", "object": "text_completion",
            "created": int(time.time()), "model": ctx.model_name, "choices": [choice],
            "usage": {"prompt_tokens": len(ids), "completion_tokens": 0,
                      "total_tokens": len(ids)}})

    # ---- response shapes ------------------------------------------------

    def _served(self, kwargs) -> str:
        """The model name a response carries: the adapter or catalog model
        the request selected, else the one serving now."""
        ctx = self.ctx
        return (kwargs.get("model") or kwargs.get("adapter")
                or (ctx.pool.current if ctx.pool is not None else ctx.model_name))

    @staticmethod
    def _choice_params(params, i: int, n: int):
        """Choice i of a seeded n > 1 request samples with seed + i;
        unseeded choices already differ by their salts."""
        if n == 1 or params.seed is None:
            return params
        return dataclasses.replace(params, seed=params.seed + i)

    def _submit_choices(self, params, kwargs, n):
        """Submit the n per-choice requests; if one is refused, abort those
        already accepted so they do not generate to max_tokens."""
        ctx = self.ctx
        submits = []
        # a request this handler would time out anyway is aborted by the
        # engine while still queued (Engine._expire_queued_deadlines)
        deadline = ctx.runner._clock.monotonic() + ctx.config.request_timeout_s
        try:
            for i in range(n):
                submits.append(ctx.runner.submit(params=self._choice_params(params, i, n),
                                                 deadline=deadline, **kwargs))
        except Exception:
            for rid, _ in submits:
                ctx.runner.abort(rid)
                ctx.engine.requests.pop(rid, None)
            raise
        return submits

    @staticmethod
    def _completions_logprobs(entries) -> dict:
        """OpenAI completions logprobs shape (parallel lists)."""
        return {"token_logprobs": [e["logprob"] for e in entries],
                "tokens": [e["token_id"] for e in entries],
                "top_logprobs": [dict(e["top"]) for e in entries]}

    def _chat_logprobs(self, entries) -> dict:
        """OpenAI chat logprobs shape: per-token content entries with
        vocabulary-level token strings (``id_to_token`` keeps the special
        tokens and markers plain decoding strips) and top alternatives."""
        tok = self.ctx.engine.tokenizer.id_to_token
        return {"content": [
            {"token": tok(e["token_id"]), "logprob": e["logprob"],
             "top_logprobs": [{"token": tok(t), "logprob": lp} for t, lp in e["top"]]}
            for e in entries]}

    def _echo_text(self, body, chat, kwargs, params):
        """OpenAI completions ``echo``: the prompt text to prepend (the
        truncated prompt under truncate_prompt_tokens), or None."""
        if chat or not body.get("echo"):
            return None
        tok = self.ctx.engine.tokenizer
        if params.truncate_prompt_tokens:
            return tok.decode(self._prompt_ids(kwargs, params))
        if "prompt" in kwargs:
            return kwargs["prompt"]
        return tok.decode(kwargs["prompt_token_ids"])

    def _full_response(self, body, params, chat, kwargs, n=1, best_of=None, toolctx=None):
        """The whole answer in one body.  ``best_of > n``: ``best_of``
        candidates are sampled and the n of highest cumulative logprob
        kept (a stable sort: ties keep submission order); without
        ``logprobs`` the ranking records chosen-token logprobs
        (``logprobs=0``), stripped from the response.  With tools, a
        parsed call is the message's ``tool_calls`` and a ``stop`` finish
        becomes ``tool_calls``."""
        ctx = self.ctx
        best_of = best_of or n
        rank_params, internal_logprobs = params, False
        if best_of > n and params.logprobs is None:
            rank_params, internal_logprobs = dataclasses.replace(params, logprobs=0), True
        submits = self._submit_choices(rank_params, kwargs, best_of)
        deadline = time.monotonic() + ctx.config.request_timeout_s

        def fail(exc):
            for rid, _ in submits:
                ctx.runner.abort(rid)
                ctx.engine.requests.pop(rid, None)
            self._fail(exc)

        cands = []
        prompt_tokens = completion_tokens = 0
        echo_text = self._echo_text(body, chat, kwargs, params)
        # one scoring pass feeds both prompt-logprob shapes: vLLM's
        # prompt_logprobs field and the OpenAI echo + logprobs arrays
        prompt_lp_field = prompt_entries = None
        plp = body.get("prompt_logprobs")
        want_echo_entries = not chat and echo_text is not None and params.logprobs is not None
        if plp is not None or want_echo_entries:
            try:
                pent = self._score_prompt(self._prompt_ids(kwargs, params),
                                          max(int(plp or 0), params.logprobs or 0))
            except Exception as e:
                # the submitted generations are aborted too
                if not isinstance(e, ValueError):
                    logger.exception("prompt scoring failed")
                fail(e)
                return
            if want_echo_entries:
                prompt_entries = [dict(e, top=e["top"][:params.logprobs]) for e in pent]
            if plp is not None:
                prompt_lp_field = self._vllm_prompt_logprobs(
                    pent, int(plp), ctx.engine.tokenizer.id_to_token)
        for rid, q in submits:
            text_parts, n_tokens, finish_reason = [], 0, "stop"
            while True:
                try:
                    item = q.get(timeout=max(deadline - time.monotonic(), 0.001))
                except queue.Empty:
                    fail(TimeoutError("request timed out"))
                    return
                if item is None:
                    break
                if isinstance(item, Exception):
                    fail(item)
                    return
                text_parts.append(item.new_text)
                n_tokens += len(item.new_token_ids)
                if item.finish_reason is not None:
                    finish_reason = item.finish_reason.value
            req = ctx.engine.requests.pop(rid, None)
            entries = []
            if req is not None:
                prompt_tokens = req.num_prompt_tokens
                if rank_params.logprobs is not None:
                    entries = req.logprobs
            completion_tokens += n_tokens            # usage bills every candidate
            text = "".join(text_parts)
            if echo_text is not None:
                text = echo_text + text
            cands.append((text, entries, finish_reason))
        if best_of > n:
            cands.sort(key=lambda c: -sum(e["logprob"] for e in c[1]))
            cands = cands[:n]
        choices = []
        for idx, (text, entries, finish_reason) in enumerate(cands):
            if internal_logprobs:
                entries = []
            if prompt_entries is not None:
                entries = prompt_entries + entries
            if chat:
                message = {"role": "assistant", "content": text}
                if toolctx is not None:
                    content, tool_calls = toolctx.postprocess(text)
                    if tool_calls:
                        message = {"role": "assistant", "content": content,
                                   "tool_calls": tool_calls}
                        if finish_reason == "stop":
                            finish_reason = "tool_calls"
                choice = {"index": idx, "message": message, "finish_reason": finish_reason}
                if entries:
                    choice["logprobs"] = self._chat_logprobs(entries)
            else:
                choice = {"index": idx, "text": text, "finish_reason": finish_reason}
                if entries:
                    choice["logprobs"] = self._completions_logprobs(entries)
            if prompt_lp_field is not None:
                choice["prompt_logprobs"] = prompt_lp_field
            choices.append(choice)
        ctx.emit_engine_spans([rid for rid, _ in submits])
        self._settle_tenant(prompt_tokens + completion_tokens)
        self._json(200, {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()), "model": self._served(kwargs),
            "choices": choices,
            "usage": {"prompt_tokens": prompt_tokens,
                      "completion_tokens": completion_tokens,
                      "total_tokens": prompt_tokens + completion_tokens}})

    def _stream_response(self, body, params, chat, kwargs, n=1, toolctx=None):
        ctx = self.ctx
        # the adapter or catalog model the request selected
        served = self._served(kwargs)
        # vLLM extension: each chunk's token ids, so clients count tokens
        # exactly (a fused decode window emits several chunks at once)
        ret_ids = bool(body.get("return_token_ids"))
        try:
            submits = self._submit_choices(params, kwargs, n)
        except Exception as e:
            self._fail(e)
            return
        oid = f"cmpl-{uuid.uuid4().hex[:24]}"

        def abort_all():
            for rid, _ in submits:
                ctx.runner.abort(rid)

        # HOLD the 200 until every choice produced its first item: an
        # intake rejection (400, 503 backpressure) must be a real status
        # line, not an SSE chunk inside a 200
        deadline = time.monotonic() + ctx.config.request_timeout_s
        firsts, err = [], None
        for rid, q in submits:
            try:
                item = q.get(timeout=max(deadline - time.monotonic(), 0.001))
            except queue.Empty:
                err = TimeoutError("request timed out")
                break
            firsts.append(item)
            if isinstance(item, Exception):
                err = item
                break
        if err is not None:
            abort_all()
            for rid, _ in submits:
                ctx.engine.requests.pop(rid, None)
            self._fail(err)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        # chunks gather in ``buf`` and leave in one write a drained batch
        # (a window's outputs arrive together); the buffer is flushed
        # before any wait on the queue, so nothing ready is held back
        buf = bytearray()

        def send_chunk(payload: dict):
            data = b"data: " + json.dumps(payload).encode() + b"\n\n"
            buf.extend(hex(len(data))[2:].encode() + b"\r\n" + data + b"\r\n")

        def flush_chunks():
            if buf:
                self.wfile.write(bytes(buf))
                buf.clear()
                self.wfile.flush()

        def end_stream():
            flush_chunks()
            done = b"data: [DONE]\n\n"
            self.wfile.write(hex(len(done))[2:].encode() + b"\r\n" + done + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

        # n > 1: the choices' queues merge into one, tagged with the choice
        # index; the first items read above re-enter ahead of the rest
        if n == 1:
            merged = None
        else:
            merged = queue.Queue()
            for i, item in enumerate(firsts):
                merged.put((i, item))

            def pump(idx, q):
                while True:
                    item = q.get()
                    merged.put((idx, item))
                    if item is None or isinstance(item, Exception):
                        return
            for i, (_, q) in enumerate(submits):
                threading.Thread(target=pump, args=(i, q), daemon=True).start()
        prompt_toks = completion_toks = 0
        try:
            # OpenAI sends "usage": null on every chunk but the last
            include_usage = bool((body.get("stream_options") or {}).get("include_usage"))
            obj = "chat.completion.chunk" if chat else "text_completion"
            if chat:
                for i in range(n):
                    chunk = {"id": oid, "object": obj, "model": served,
                             "choices": [{"index": i, "delta": {"role": "assistant"},
                                          "finish_reason": None}]}
                    if include_usage:
                        chunk["usage"] = None
                    send_chunk(chunk)
            echo_text = self._echo_text(body, chat, kwargs, params)
            if echo_text is not None:
                # with logprobs the echo chunk carries the prompt's arrays
                # (first entry null), aligned with the echoed tokens
                prompt_lp = None
                if params.logprobs is not None:
                    try:
                        prompt_lp = self._completions_logprobs(self._score_prompt(
                            self._prompt_ids(kwargs, params), params.logprobs))
                    except Exception as e:      # headers are out: an error chunk
                        logger.exception("prompt scoring failed")
                        abort_all()
                        send_chunk({"error": {"message": str(e)}})
                        end_stream()
                        return
                for i in range(n):
                    choice = {"index": i, "text": echo_text, "finish_reason": None}
                    if prompt_lp is not None:
                        choice["logprobs"] = prompt_lp
                    if ret_ids:
                        choice["token_ids"] = []
                    chunk = {"id": oid, "object": obj, "created": int(time.time()),
                             "model": served, "choices": [choice]}
                    if include_usage:
                        chunk["usage"] = None
                    send_chunk(chunk)
            errored = False
            lp_cursor = [0] * n        # each choice's logprob entries sent so far
            # tools: marker text is held out of each choice's content
            # deltas; the parsed calls leave as a trailing tool_calls delta
            filters = ([toolctx.stream_filter() for _ in range(n)]
                       if chat and toolctx is not None else None)
            live = n
            # a sentinel, not None: a first item of None (the finish marker
            # of an instant abort) must still be delivered
            consumed = object()
            held = firsts[0] if merged is None else consumed
            while live:
                try:
                    if held is not consumed:
                        idx, item, held = 0, held, consumed
                    else:
                        src = submits[0][1] if merged is None else merged
                        try:
                            got = src.get_nowait()
                        except queue.Empty:
                            flush_chunks()
                            got = src.get(timeout=max(deadline - time.monotonic(), 0.001))
                        idx, item = (0, got) if merged is None else got
                except queue.Empty:
                    abort_all()
                    send_chunk({"error": {"message": "request timed out"}})
                    errored = True
                    break
                if item is None:
                    live -= 1
                    continue
                if isinstance(item, Exception):
                    send_chunk({"error": {"message": str(item)}})
                    errored = True
                    live -= 1
                    continue
                finish = item.finish_reason.value if item.finish_reason else None
                tc_deltas = None
                if chat:
                    text_out = item.new_text
                    if filters is not None:
                        text_out = filters[idx].feed(item.new_text)
                        if finish is not None:
                            tail, calls = filters[idx].finish()
                            text_out += tail
                            if calls:
                                tc_deltas = [dict(c.as_openai(), index=ci)
                                             for ci, c in enumerate(calls)]
                                if finish == "stop":
                                    finish = "tool_calls"
                    delta = {"content": text_out} if text_out else {}
                    choice = {"index": idx, "delta": delta,
                              "finish_reason": None if tc_deltas else finish}
                else:
                    choice = {"index": idx, "text": item.new_text, "finish_reason": finish}
                if params.logprobs is not None and item.new_token_ids:
                    # this chunk's slice of the request's entries (appended
                    # before its tokens are emitted, and only appended to)
                    req = ctx.engine.requests.get(submits[idx][0])
                    if req is not None:
                        lo = lp_cursor[idx]
                        entries = req.logprobs[lo:lo + len(item.new_token_ids)]
                        lp_cursor[idx] = lo + len(entries)
                        if entries:
                            choice["logprobs"] = (self._chat_logprobs(entries) if chat
                                                  else self._completions_logprobs(entries))
                if ret_ids:
                    choice["token_ids"] = list(item.new_token_ids)
                completion_toks += len(item.new_token_ids)
                # the prompt is shared across the n choices: counted once
                prompt_toks = item.num_prompt_tokens
                chunk = {"id": oid, "object": obj, "created": int(time.time()),
                         "model": served, "choices": [choice]}
                if include_usage:
                    chunk["usage"] = None
                send_chunk(chunk)
                if tc_deltas:
                    # the parsed calls and the real finish reason (the content
                    # chunk above sent None)
                    tchunk = {"id": oid, "object": obj, "created": int(time.time()),
                              "model": served,
                              "choices": [{"index": idx, "delta": {"tool_calls": tc_deltas},
                                           "finish_reason": finish}]}
                    if include_usage:
                        tchunk["usage"] = None
                    send_chunk(tchunk)
            if include_usage and not errored:
                send_chunk({"id": oid, "object": obj, "created": int(time.time()),
                            "model": served, "choices": [],
                            "usage": {"prompt_tokens": prompt_toks,
                                      "completion_tokens": completion_toks,
                                      "total_tokens": prompt_toks + completion_toks}})
            self._settle_tenant(prompt_toks + completion_toks)
            end_stream()
        except (BrokenPipeError, ConnectionResetError):
            abort_all()                 # the client went away mid-stream
        except Exception:
            logger.exception("streaming failed")
            abort_all()
        finally:
            # tokens already written were served: a client that drops the
            # socket before [DONE] is still charged for them
            self._settle_tenant(prompt_toks + completion_toks)
            # still inside the request span: the engine's child spans
            # attach under it, on the client-gone paths too
            ctx.emit_engine_spans([rid for rid, _ in submits])
            for rid, _ in submits:
                ctx.engine.requests.pop(rid, None)


def build_parser():
    """The JAX server's CLI (``tpuserve/server/openai_api.py`` ``main``),
    plus ``--device``."""
    import argparse
    ap = argparse.ArgumentParser("tpuserve_torch.server")
    ap.add_argument("--model", default="Qwen/Qwen3-0.6B")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="HF safetensors directory (random init when it holds none)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the engine's device; the CPU runs the kernels' plain versions")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000, help="0 binds a free port")
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--num-blocks", type=int, default=2048,
                    help="KV cache blocks; 0 sizes the cache to the memory left free")
    ap.add_argument("--max-blocks-per-seq", type=int, default=64)
    ap.add_argument("--max-num-seqs", type=int, default=64)
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="reject (HTTP 503) requests beyond this many waiting "
                         "(0 = 4x max-num-seqs; -1 disables)")
    ap.add_argument("--mixed-batching", action="store_true",
                    help="decode rows and prefill chunks in one flat-token step")
    ap.add_argument("--mixed-token-budget", type=int, default=512)
    ap.add_argument("--interleave-batched-prefill", action="store_true")
    ap.add_argument("--attn-impl", default="auto")
    ap.add_argument("--multi-step", type=int, default=None,
                    help="fused decode window size (default: 32 on the card, 1 on the CPU)")
    ap.add_argument("--no-adaptive-window", action="store_true")
    ap.add_argument("--min-multi-step", type=int, default=4)
    ap.add_argument("--kv-cache-dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8"])
    ap.add_argument("--lora", default=None, metavar="DIR",
                    help="PEFT LoRA adapter directory merged into the weights at load "
                         "(one adapter an engine, no cost a step)")
    ap.add_argument("--lora-modules", default=None, nargs="+", metavar="NAME=DIR",
                    help="multi-LoRA serving (vLLM flag): adapters loaded as a stack; a "
                         "request selects one by sending its NAME as the 'model' field, "
                         "mixed-adapter batches run in one step; composes with "
                         "--quantization int8")
    ap.add_argument("--quantization", default=None, choices=["int8"],
                    help="weight-only int8 quantization (half the weights' memory)")
    ap.add_argument("--no-kv-tiers", action="store_true",
                    help="disable the tiered KV cache (HBM -> host-DRAM -> spill prefix "
                         "offload; runtime/kv_tiers.py): evicted prefix blocks are "
                         "destroyed instead of demoted (TPUSERVE_KV_TIERS=0 is the env twin)")
    ap.add_argument("--kv-host-bytes", type=int, default=0,
                    help="host-DRAM KV tier byte budget (0 = TPUSERVE_KV_HOST_BYTES or 1 GiB)")
    ap.add_argument("--kv-spill-dir", default=None, metavar="DIR",
                    help="spill directory for the third KV tier (default: "
                         "TPUSERVE_KV_SPILL_DIR; unset = no spill tier, host overflow "
                         "is dropped)")
    ap.add_argument("--pipeline", dest="pipeline", action="store_true", default=None,
                    help="force pipelined decode (default: on with a card)")
    ap.add_argument("--no-pipeline", dest="pipeline", action="store_false")
    ap.add_argument("--chat-template", default=None,
                    help="path to a Jinja chat template overriding the tokenizer's")
    ap.add_argument("--tool-call-parser", default=None,
                    choices=["hermes", "mistral", "llama3_json"],
                    help="tool-call output format (default: inferred from the model family)")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--warmup-embed", default=None,
                    help="comma-separated BxT embed buckets to run at startup "
                         "(e.g. '8x128,1x512'); the trunks are eager, so this only "
                         "initialises the libraries a first embedding call would")
    ap.add_argument("--speculative-k", type=int, default=0,
                    help="speculative decoding with k draft tokens (0 disables); "
                         "proposals come from n-gram prompt lookup, or a draft model "
                         "with --speculative-draft-model")
    ap.add_argument("--speculative-draft-model", default=None,
                    help="registered model name proposing the draft tokens (stateless "
                         "truncated-window drafts); needs the target's vocab")
    ap.add_argument("--speculative-draft-dir", default=None,
                    help="checkpoint dir for the draft model (default: random init)")
    ap.add_argument("--drain-timeout", type=float, default=25.0,
                    help="graceful-drain budget on SIGTERM, seconds")
    ap.add_argument("--no-slo-classes", action="store_true",
                    help="disable SLO class scheduling and the brownout ladder "
                         "(runtime/slo.py): classless FIFO, no class-aware admission, "
                         "preemption or shedding (TPUSERVE_SLO_CLASSES=0 is the env twin)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="deterministic fault injection (runtime/faults.py), e.g. "
                         "'decode_dispatch:raise:0.02'; TPUSERVE_FAULTS is the env twin")
    ap.add_argument("--step-watchdog-s", type=float, default=0.0,
                    help="hang watchdog: a step blocking longer than this is declared "
                         "stuck and its requests salvaged as if it had raised (0 "
                         "disables; scaled up for the first steps)")
    ap.add_argument("--tenant-config", default=None, metavar="JSON|PATH",
                    help="per-tenant token metering and rate limits (server/tenants.py); "
                         "inline JSON or a file path (default: TPUSERVE_TENANTS)")
    ap.add_argument("--no-slo-burn", action="store_true",
                    help="disable the in-process SLO burn-rate evaluator (obs/; "
                         "TPUSERVE_SLO_BURN=0 is the env twin)")
    ap.add_argument("--no-devprof", action="store_true",
                    help="disable device telemetry (runtime/devprof.py): no CUDA-event "
                         "device time, executable ladder or HBM watermark "
                         "(TPUSERVE_DEVPROF=0 is the env twin); serving is unchanged")
    ap.add_argument("--slo-objectives", default=None, metavar="JSON|PATH",
                    help="SLO objectives override (obs/objectives.py); inline JSON list or "
                         "a file path (default: TPUSERVE_SLO_OBJECTIVES, else the "
                         "defaults); validated at boot")
    ap.add_argument("--model-catalog", default=None, metavar="JSON|LIST",
                    help="model-pool catalog (modelpool/): a JSON object of name -> "
                         "checkpoint dir, or comma-separated names; a request naming a "
                         "registered model swaps the engine to it at the next idle "
                         "boundary (default: TPUSERVE_MODEL_CATALOG; TPUSERVE_MODELPOOL=0 "
                         "disables the pool)")
    ap.add_argument("--swap-policy", default="swap", choices=["swap", "reject"],
                    help="requests for a registered model not serving: 'swap' parks them "
                         "for a swap, 'reject' answers 503 with Retry-After")
    ap.add_argument("--max-resident-models", type=int, default=1,
                    help="how many models' weights stay on the card at once")
    ap.add_argument("--weight-host-bytes", type=int, default=0,
                    help="pinned host weight tier budget for demoted models "
                         "(0 = TPUSERVE_WEIGHT_HOST_BYTES or 2 GiB)")
    ap.add_argument("--weight-spill-dir", default=None, metavar="DIR",
                    help="spill directory of the third weight tier (default: "
                         "TPUSERVE_WEIGHT_SPILL_DIR; unset = host overflow means a cold "
                         "load next time)")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor parallel ranks (0 or 1: none): one process a card, in "
                         "lockstep over torch.distributed (NCCL on the card, gloo with "
                         "--device cpu); this command starts the N-1 follower ranks "
                         "itself and rank 0 serves HTTP")
    ap.add_argument("--pp", type=int, default=0,
                    help="pipeline stages (0 or 1: none): one process a card, stage s "
                         "holding layers s*L/N..(s+1)*L/N and their KV pages "
                         "(parallel/pipeline.py); this command starts the N-1 later "
                         "stages itself and rank 0 (stage 0, the head) serves HTTP")
    ap.add_argument("--multihost", action="store_true",
                    help="join torch.distributed from torchrun's environment (RANK, "
                         "WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK): rank 0 "
                         "serves, the others follow its steps; tp = --tp or the world")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill/decode engines in process, a KV page "
                         "copy between their caches on the card (parallel/disagg.py)")
    ap.add_argument("--role", default=None, choices=["prefill", "decode"],
                    help="cross-pod disaggregation (parallel/disagg_net.py): 'prefill' "
                         "prefills locally and migrates KV to the decode pool at "
                         "--decode-url; 'decode' accepts migrations on /internal/migrate")
    ap.add_argument("--decode-url", default=None,
                    help="decode-pool base URL (required with --role prefill)")
    return ap


def engine_config(args):
    """The EngineConfig of parsed CLI ``args``, as the JAX server's
    ``main`` builds it."""
    from tpuserve_torch.runtime import CacheConfig, EngineConfig, SchedulerConfig
    from tpuserve_torch.runtime.spec import SpecConfig

    return EngineConfig(
        model=args.model, checkpoint_dir=args.checkpoint_dir,
        lora_dir=args.lora, lora_modules=lora_modules_of(args),
        quantization=args.quantization,
        cache=CacheConfig(block_size=args.block_size, num_blocks=args.num_blocks,
                          max_blocks_per_seq=args.max_blocks_per_seq,
                          dtype=args.kv_cache_dtype),
        scheduler=SchedulerConfig(
            max_num_seqs=args.max_num_seqs, max_waiting=args.max_waiting,
            mixed_batching=args.mixed_batching,
            mixed_token_budget=args.mixed_token_budget,
            interleave_batched_prefill=args.interleave_batched_prefill),
        attn_impl=args.attn_impl, multi_step=args.multi_step,
        pipeline_decode=args.pipeline, adaptive_multi_step=not args.no_adaptive_window,
        min_multi_step=args.min_multi_step,
        kv_tiers=False if args.no_kv_tiers else None,
        kv_host_bytes=args.kv_host_bytes, kv_spill_dir=args.kv_spill_dir,
        slo_classes=False if args.no_slo_classes else None,
        faults=args.faults, step_watchdog_s=args.step_watchdog_s,
        devprof=False if args.no_devprof else None,
        speculative=(SpecConfig(num_draft_tokens=args.speculative_k,
                                draft_model=args.speculative_draft_model,
                                draft_checkpoint_dir=args.speculative_draft_dir)
                     if args.speculative_k > 0 else None))


def server_config(args, chat_template: Optional[str] = None,
                  warmup_embed: tuple = ()) -> ServerConfig:
    """The ServerConfig of parsed CLI ``args``, as the JAX server's
    ``main`` builds it."""
    return ServerConfig(
        host=args.host, port=args.port, chat_template=chat_template,
        tool_call_parser=args.tool_call_parser, warmup_embed=warmup_embed,
        tenant_config=args.tenant_config, slo_burn=not args.no_slo_burn,
        slo_objectives=args.slo_objectives, model_catalog=args.model_catalog,
        swap_policy=args.swap_policy, max_resident_models=args.max_resident_models,
        weight_host_bytes=args.weight_host_bytes, weight_spill_dir=args.weight_spill_dir,
        allow_kv_migration=args.role == "decode")


def lora_modules_of(args) -> Optional[dict]:
    """``--lora-modules NAME=DIR ...`` as the engine's name -> directory
    map (None without the flag); a malformed entry, an adapter named as the
    base model or a name given twice raises ``ValueError``."""
    if not args.lora_modules:
        return None
    modules = {}
    for spec_str in args.lora_modules:
        name, sep, path = spec_str.partition("=")
        if not sep or not name or not path:
            raise ValueError(f"--lora-modules entries must be NAME=DIR, got {spec_str!r}")
        if name == args.model:
            raise ValueError(f"adapter name {name!r} collides with the base model name")
        if name in modules:
            raise ValueError(f"duplicate adapter name {name!r} in --lora-modules")
        modules[name] = path
    return modules


def _check_topology(ap, args) -> None:
    """The JAX server's checks of ``--tp``, ``--pp``, ``--multihost``,
    ``--disagg``, ``--role`` and ``--decode-url``; ``--disagg`` and
    ``--role`` run on a ``--tp`` mesh (one node), not across processes."""
    if args.pp > 1 and args.tp > 1:
        ap.error("--pp and --tp are mutually exclusive (tp-within-stage composition "
                 "is future work)")
    if args.pp > 1 and (args.disagg or args.role or args.multihost):
        ap.error("--pp is a single-node colocated topology; drop "
                 "--disagg/--role/--multihost")
    if args.role and (args.disagg or args.multihost):
        ap.error("--role prefill/decode is its own topology; drop --disagg/--multihost")
    if args.role == "prefill" and not args.decode_url:
        ap.error("--role prefill requires --decode-url")
    if args.disagg and args.multihost:
        # the JAX server cannot serve it either: its multi-process
        # coordinator reads the engine's mesh, which its pair lacks
        ap.error("--disagg under --multihost is not served: the multi-process "
                 "coordinator cannot mirror an in-process prefill/decode pair across "
                 "processes; use --disagg with --tp on one node")


def _join_ranks(args, argv: list):
    """Under ``--tp N``, ``--pp N`` or ``--multihost``: join the process
    group and make this rank's mesh.  A ``--tp`` or ``--pp`` command without
    ``RANK`` in its environment is rank 0 of one node: it starts ranks
    1..N-1 (this command
    again, with torchrun's variables and a ``file://`` store under a
    temporary directory, logs beside it).  Returns (mesh, follower
    processes, their directory)."""
    import tempfile

    from tpuserve_torch.parallel import multihost
    from tpuserve_torch.parallel.mesh import MeshConfig, make_mesh, multihost_initialize
    procs, run_dir = {}, None
    if args.multihost:
        multihost_initialize(args.device,
                             init_method=os.environ.get("TPUSERVE_INIT_METHOD", "env://"))
    else:
        ranks = max(args.tp, args.pp)
        if "RANK" not in os.environ:
            run_dir = tempfile.mkdtemp(prefix="tpuserve-tp-")
            init = f"file://{os.path.join(run_dir, 'store')}"
            procs = multihost.spawn_ranks([None, "-m", "tpuserve_torch.server", *argv],
                                          ranks, run_dir, init)
            logger.info("started %d follower rank(s); logs under %s", len(procs), run_dir)
            rank, world = 0, ranks
        else:
            init = os.environ["TPUSERVE_INIT_METHOD"]
            rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        multihost_initialize(args.device, init_method=init, rank=rank, world_size=world)
    import torch.distributed as dist
    grid = (MeshConfig(pp=args.pp) if args.pp > 1
            else MeshConfig(tp=args.tp or dist.get_world_size()))
    mesh = make_mesh(grid, device_type=args.device, multihost=args.multihost)
    return mesh, procs, run_dir


def _build_engine(args, ecfg, mesh):
    from tpuserve_torch.runtime import Engine
    if args.role == "prefill":
        from tpuserve_torch.parallel.disagg_net import PrefillHandoffEngine
        return PrefillHandoffEngine(ecfg, args.decode_url, mesh=mesh, device=args.device)
    if args.disagg:
        from tpuserve_torch.parallel.disagg import DisaggregatedEngine
        return DisaggregatedEngine(ecfg, ecfg, mesh=mesh, device=args.device)
    return Engine(ecfg, mesh=mesh, device=args.device)


def main(argv=None):
    """``python -m tpuserve_torch.server``: build the engine, warm it,
    serve until SIGTERM, then drain.  Under ``--tp`` / ``--pp`` /
    ``--multihost`` rank 0 does that and the other ranks follow its steps
    (``parallel/multihost.py``) until it stops them."""
    ap = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    _check_topology(ap, args)
    if args.speculative_k <= 0 and args.speculative_draft_model:
        ap.error("--speculative-draft-model needs --speculative-k > 0")
    if args.speculative_draft_dir and not args.speculative_draft_model:
        ap.error("--speculative-draft-dir needs --speculative-draft-model "
                 "(the dir would be silently ignored)")
    warmup_embed = ()
    if args.warmup_embed:
        try:
            warmup_embed = tuple(
                (int(b.lower().split("x")[0]), int(b.lower().split("x")[1]))
                for b in args.warmup_embed.split(","))
        except (ValueError, IndexError):
            ap.error("--warmup-embed must be comma-separated BxT pairs, "
                     "e.g. '8x128,1x512'")
    logging.basicConfig(level=logging.INFO)
    chat_template = None
    if args.chat_template:
        with open(args.chat_template) as f:
            chat_template = f.read()
    try:
        ecfg = engine_config(args)
    except ValueError as e:
        ap.error(str(e))
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():       # no card, and no --device cpu
            sys.exit("tpuserve_torch.server: no CUDA device is available; pass "
                     "device='cpu' to run the engine on the CPU")
    mesh, procs, run_dir = (_join_ranks(args, argv)
                            if args.tp > 1 or args.pp > 1 or args.multihost
                            else (None, {}, None))
    engine = _build_engine(args, ecfg, mesh)
    if mesh is not None and not mesh.is_coordinator:
        # a follower never serves: it mirrors rank 0's steps until the stop
        # (rank 0 stops it when it drains: a SIGTERM or Ctrl-C sent to the
        # whole process group must not end it first)
        import signal
        from tpuserve_torch.parallel.multihost import follower_loop
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        follower_loop(engine)
        import torch.distributed as dist
        dist.destroy_process_group()
        return
    import signal
    stop = threading.Event()
    failed = []
    watch = None
    if procs:
        from tpuserve_torch.parallel.multihost import watch_ranks

        def on_failure(rank, rc):
            # a follower died: rank 0 stops with an error, never waits in a
            # collective for it (a stuck loop thread gets a bounded grace)
            logger.error("follower rank %d exited with %s; logs under %s", rank, rc, run_dir)
            failed.append((rank, rc))
            stop.set()
            threading.Timer(30.0, lambda: os._exit(1)).start()
        watch = watch_ranks(procs, on_failure)
    try:
        server = OpenAIServer(engine, server_config(args, chat_template, warmup_embed))
        port = server.start(warmup=not args.no_warmup)
        print(f"tpuserve_torch listening on {args.host}:{port}", flush=True)
        # SIGTERM drains (readyz 503, new work 503, in-flight work finishes)
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        try:
            stop.wait()
            logger.info("SIGTERM: draining")
        except KeyboardInterrupt:
            pass
        if not failed:
            server.drain(timeout_s=args.drain_timeout)
    finally:
        if mesh is not None:
            if watch is not None:
                watch.set()
            if not failed:
                engine.stop_followers()
            from tpuserve_torch.parallel.multihost import stop_ranks
            rcs = stop_ranks(procs)
            if any(rcs.values()):
                failed.append(rcs)
    if failed:
        sys.exit(f"tpuserve_torch.server: a follower rank failed: {failed}")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
