"""Cross-pod disaggregated prefill/decode, the KV handoff over the network:
the port of ``tpuserve/parallel/disagg_net.py``.

- **Prefill pod** (:class:`PrefillHandoffEngine`): prefills locally, then
  serialises the sequence's KV pages and POSTs them to the decode pool's
  ``/internal/migrate``; the decode pod streams the remaining tokens back
  over the same response, and the prefill pod relays them to its caller.
  To the server's runner it looks like one engine.
- **Decode pod**: a server started with ``--role decode``;
  ``Engine.adopt_prefilled`` writes the transferred pages into its own
  cache and drops the request into the running decode batch.

Either pod may be a tp / ep mesh of lockstep ranks (``--tp N``): a prefill
pod's rank 0 joins its ranks' heads into one card's pages before they go on
the wire (``Engine._exec_extract``), and a decode pod's rank 0 sends each
rank its heads of them (``Engine._exec_adopt``), so the wire always carries
one card's pages, whatever either side's grid.

The wire format is the JAX package's, byte for byte (``MAGIC``, a
little-endian header length, the JSON header of the request's meta and
each layer's arrays, then the arrays, bf16 as its 16-bit patterns), so a
JAX prefill pod can hand off to a port decode pod and the reverse.  The
codec reads bf16 into torch without ``ml_dtypes``.

Fallbacks, as the JAX engine's: a full decode pool (HTTP 503) is retried a
bounded number of times and then decoded locally; an unreachable pool is
decoded locally; an ambiguous migration (the 200 lost in flight) aborts the
remote copy (``/internal/abort``) and decodes locally.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import struct
import threading
from typing import Sequence

import numpy as np
import torch

from tpuserve_torch.runtime.request import (FinishReason, RequestOutput, RequestState,
                                            SamplingParams)

logger = logging.getLogger("tpuserve_torch.disagg")

MAGIC = b"TPKV"
MIGRATION_CHUNK_BYTES = 8 << 20    # socket-write granularity for large KV


# --------------------------------------------------------------------------
# Wire codec: one binary blob = JSON meta + per-layer K/V page arrays
# --------------------------------------------------------------------------

def _host_array(x) -> tuple[str, np.ndarray]:
    """(wire dtype name, C-contiguous numpy array) of a page array: bf16
    tensors travel as their 16-bit patterns under the name "bfloat16", as
    the JAX codec writes them."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return "bfloat16", np.ascontiguousarray(x.view(torch.int16).numpy().view(np.uint16))
        return str(x.numpy().dtype), np.ascontiguousarray(x.numpy())
    arr = np.asarray(x)
    name = str(arr.dtype)
    if name == "bfloat16":                     # an ml_dtypes array (a JAX caller)
        arr = arr.view(np.uint16)
    return name, np.ascontiguousarray(arr)


def _unpack_array(blob: memoryview, spec: dict) -> torch.Tensor:
    dtype = spec["dtype"]
    raw = np.frombuffer(blob[spec["offset"]:spec["offset"] + spec["nbytes"]],
                        dtype=np.uint16 if dtype == "bfloat16" else dtype)
    arr = torch.from_numpy(raw.reshape(spec["shape"]).copy())
    return arr.view(torch.bfloat16) if dtype == "bfloat16" else arr


def migration_payload(meta: dict, seq_kv: list[dict],
                      chunk_bytes: int = MIGRATION_CHUNK_BYTES):
    """Streaming serializer: ``(total_bytes, make_chunks)``.  ``make_chunks()``
    yields the payload as bounded chunks (the header, then slices of each
    layer's pages), so a long prompt's KV is never one bytes object;
    it can be called again for each retry."""
    specs, arrays, off = [], [], 0
    for layer in seq_kv:
        spec = {}
        for kk in sorted(layer):       # k/v (+ ks/vs scales on int8 caches)
            dtype, arr = _host_array(layer[kk])
            spec[kk] = {"dtype": dtype, "shape": list(arr.shape),
                        "offset": off, "nbytes": arr.nbytes}
            off += arr.nbytes
            arrays.append(arr)
        specs.append(spec)
    header = json.dumps({"meta": meta, "layers": specs}).encode()
    prefix = MAGIC + struct.pack("<I", len(header)) + header
    total = len(prefix) + off

    def make_chunks():
        yield prefix
        for arr in arrays:
            mv = memoryview(arr).cast("B")
            for o in range(0, len(mv), chunk_bytes):
                yield mv[o:o + chunk_bytes]

    return total, make_chunks


def serialize_migration(meta: dict, seq_kv: list[dict]) -> bytes:
    """meta + per-layer page arrays -> one self-describing blob (the
    in-memory form of :func:`migration_payload`)."""
    _, make_chunks = migration_payload(meta, seq_kv)
    return b"".join(bytes(c) for c in make_chunks())


def deserialize_migration(blob: bytes) -> tuple[dict, list[dict]]:
    """The blob's meta and per-layer ``{key: tensor}`` pages (on the host)."""
    if blob[:4] != MAGIC:
        raise ValueError("not a KV migration payload")
    (hlen,) = struct.unpack("<I", blob[4:8])
    header = json.loads(blob[8:8 + hlen])
    view = memoryview(blob)[8 + hlen:]
    seq_kv = [{kk: _unpack_array(view, s) for kk, s in spec.items()}
              for spec in header["layers"]]
    return header["meta"], seq_kv


def sampling_to_dict(p: SamplingParams) -> dict:
    d = dataclasses.asdict(p)
    d["stop"] = list(d["stop"])
    return d


def sampling_from_dict(d: dict) -> SamplingParams:
    d = dict(d)
    d["stop"] = tuple(d.get("stop") or ())
    d["stop_token_ids"] = tuple(d.get("stop_token_ids") or ())
    if d.get("logit_bias"):
        # JSON object keys arrive as strings
        d["logit_bias"] = {int(k): float(v) for k, v in d["logit_bias"].items()}
    return SamplingParams(**d)


# --------------------------------------------------------------------------
# Prefill-pod engine facade
# --------------------------------------------------------------------------

class PrefillHandoffEngine:
    """Engine-compatible facade for the prefill pool.

    ``add_request`` / ``step`` / ``has_work`` / ``abort_request`` are what
    the server's runner drives.  Each request: local prefill (the first
    token is sampled here, so TTFT is a prefill-pod number), KV extraction,
    an HTTP migration, then a relay thread feeds the decode pod's token
    stream back through :meth:`step`'s return value.  Any other attribute
    is the local engine's."""

    MIGRATE_RETRIES = 3
    MIGRATE_RETRY_DELAY_S = 2.0

    def __init__(self, engine_config, decode_url: str, mesh=None, *, params=None,
                 model_cfg=None, device="cuda"):
        from tpuserve_torch.runtime.engine import Engine
        if engine_config.lora_modules:
            raise ValueError("multi-LoRA is not supported on disaggregated "
                             "topologies (adapter identity doesn't "
                             "migrate); use merge-at-load lora_dir")
        # never window-release on the prefill side: migration ships
        # block_table() pages (parallel/disagg.py)
        engine_config = dataclasses.replace(engine_config, window_release=False)
        self.prefill = Engine(engine_config, params=params, model_cfg=model_cfg,
                              mesh=mesh, device=device)
        self.decode_url = decode_url.rstrip("/")
        self._relayed: "queue.Queue[RequestOutput]" = queue.Queue()
        self._active_relays: dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        # block-manager and scheduler changes the relay threads ask for are
        # applied on the engine's loop thread in step() (("adopted" |
        # "release" | "fallback", req)): a relay never touches the engine
        self._pending_actions: "queue.Queue[tuple[str, object]]" = queue.Queue()
        # the decode pool's 503s (full), each retried or fallen back on
        self.refused = 0

    def __getattr__(self, name):
        if name == "prefill":
            raise AttributeError(name)
        return getattr(self.prefill, name)

    @property
    def requests(self):
        return self.prefill.requests

    @property
    def lockstep_engines(self) -> dict:
        """The engine a follower rank follows (``multihost.follower_loop``)."""
        return {None: self.prefill}

    def add_request(self, **kw) -> str:
        return self.prefill.add_request(**kw)

    def warmup(self, *a, **kw) -> None:
        self.prefill.warmup(*a, **kw)

    def has_work(self) -> bool:
        with self._lock:
            relays = bool(self._active_relays)
        return (relays or self.prefill.has_work() or not self._relayed.empty()
                or not self._pending_actions.empty())

    def abort_request(self, request_id: str) -> bool:
        with self._lock:
            ev = self._active_relays.get(request_id)
        if ev is not None:
            ev.set()          # the relay thread closes the decode pod's stream
            return True
        return self.prefill.abort_request(request_id)

    def step(self) -> list[RequestOutput]:
        outputs: list[RequestOutput] = []
        self._apply_pending_actions()
        # the engine's has_work: a local-decode fallback can leave a
        # pipelined window owed its flush
        if self.prefill.has_work():
            outputs.extend(self.prefill.step())
            # freshly prefilled requests leave the local scheduler (this pod
            # never decodes them) and are handed off; requests requeued by
            # the fallback decode here and never migrate again
            for req in list(self.prefill.scheduler.running):
                if getattr(req, "_local_decode", False):
                    continue
                self.prefill.scheduler.running.remove(req)
                if req.finished:
                    continue
                self._start_migration(req)
        while True:
            try:
                outputs.append(self._relayed.get_nowait())
            except queue.Empty:
                break
        if not outputs and not self.prefill.has_work():
            # only relays in flight: wait briefly for the next streamed
            # token, so that the runner's loop does not spin
            try:
                outputs.append(self._relayed.get(timeout=0.02))
            except queue.Empty:
                pass
        return outputs

    # -- migration ------------------------------------------------------

    def _apply_pending_actions(self) -> None:
        """The loop thread's side of the relays' outcomes: ``adopted`` (the
        decode pod's 200: only now are this pod's blocks freed),
        ``release`` (aborted before adoption), ``fallback`` (the migration
        failed: the KV is still here, so the request decodes locally)."""
        while True:
            try:
                kind, req = self._pending_actions.get_nowait()
            except queue.Empty:
                return
            rid = req.request_id
            if kind in ("adopted", "release") or req.state == RequestState.FINISHED:
                self.prefill.block_manager.free(rid)
                for table in (self.prefill._detok, self.prefill._guided,
                              self.prefill._guided_fsm, self.prefill._guided_plan,
                              self.prefill._salts):
                    table.pop(rid, None)
            else:
                req._local_decode = True
                self.prefill.scheduler.running.append(req)

    def _start_migration(self, req) -> None:
        rid = req.request_id
        blocks = self.prefill.block_manager.block_table(rid)
        # one card's pages on the host for the wire (under a mesh joined
        # from the ranks' heads); blocks stay allocated (and the
        # detokenizer seeded) until the decode pod adopts
        seq_kv = self.prefill._exec_extract(blocks)
        meta = {
            "request_id": rid,
            "prompt_token_ids": list(req.prompt_token_ids),
            "first_token": req.output_token_ids[-1],
            "num_valid_blocks": len(blocks),
            "params": sampling_to_dict(req.params),
        }
        plan = self.prefill._guided_plan.get(rid)
        if plan:
            # the first token opened a committed canonical-suffix plan: the
            # decode pod keeps emitting it
            meta["guided_plan"] = list(plan)
        total, make_chunks = migration_payload(meta, seq_kv)
        cancel = threading.Event()
        with self._lock:
            self._active_relays[rid] = cancel
        threading.Thread(target=self._relay, name=f"kv-relay-{rid}",
                         args=(req, total, make_chunks, cancel), daemon=True).start()

    def _abort_remote(self, rid: str) -> None:
        """Best-effort POST /internal/abort to the decode pool (an ambiguous
        outcome: the adoption may have landed though its response did not
        come back)."""
        import urllib.request
        try:
            http_req = urllib.request.Request(
                f"{self.decode_url}/internal/abort",
                data=json.dumps({"request_id": rid}).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(http_req, timeout=5).close()
        except OSError:
            pass          # the pool is unreachable: nothing adopted there

    def _relay(self, req, total: int, make_chunks, cancel: threading.Event) -> None:
        import urllib.error
        import urllib.request
        rid = req.request_id
        url = f"{self.decode_url}/internal/migrate"
        resp = None
        adopted = False
        try:
            for attempt in range(self.MIGRATE_RETRIES):
                if cancel.is_set():
                    self._pending_actions.put(("release", req))
                    return
                try:
                    http_req = urllib.request.Request(
                        url, data=make_chunks(),
                        headers={"Content-Type": "application/x-tpuserve-kv",
                                 "Content-Length": str(total)})
                    resp = urllib.request.urlopen(http_req, timeout=600)
                    adopted = True
                    self._pending_actions.put(("adopted", req))
                    break
                except urllib.error.HTTPError as e:
                    if e.code != 503:
                        raise
                    with self._lock:
                        self.refused += 1
                    if attempt < self.MIGRATE_RETRIES - 1:
                        cancel.wait(self.MIGRATE_RETRY_DELAY_S)
                        continue   # the decode pool is full: bounded retry
                    raise
            else:
                raise RuntimeError("decode pool rejected the migration")
            for line in resp:
                if cancel.is_set():
                    return
                if not line.strip():
                    continue
                msg = json.loads(line)
                reason = (FinishReason(msg["finish_reason"])
                          if msg.get("finish_reason") else None)
                req.output_token_ids.extend(msg["new_token_ids"])
                req.output_text += msg["new_text"]
                if msg["finished"]:
                    req.state = RequestState.FINISHED
                    req.finish_reason = reason
                self._relayed.put(RequestOutput(
                    request_id=rid, new_token_ids=msg["new_token_ids"],
                    new_text=msg["new_text"], finished=msg["finished"],
                    finish_reason=reason, num_prompt_tokens=req.num_prompt_tokens,
                    num_output_tokens=len(req.output_token_ids)))
        except Exception:        # a relay thread's boundary: report, fall back
            if not adopted:
                # the handoff never landed (or its 200 was lost): the KV is
                # still here, so serve locally, after telling the decode pool
                # to drop it in case the adoption did land
                logger.warning("KV migration for %s failed; falling back to local "
                               "decode", rid, exc_info=True)
                self._abort_remote(rid)
                self._pending_actions.put(("fallback", req))
            else:
                # the stream broke after adoption: the decode pod owned the
                # request (and this pod's copy is freed): abort it
                logger.exception("KV migration stream for %s broke after adoption", rid)
                req.state = RequestState.FINISHED
                req.finish_reason = FinishReason.ABORT
                self._relayed.put(RequestOutput(
                    request_id=rid, new_token_ids=[], new_text="", finished=True,
                    finish_reason=FinishReason.ABORT,
                    num_prompt_tokens=req.num_prompt_tokens,
                    num_output_tokens=len(req.output_token_ids)))
        finally:
            if resp is not None:
                try:
                    resp.close()
                except OSError:
                    pass
            with self._lock:
                self._active_relays.pop(rid, None)

    def generate(self, prompts: Sequence, params=None):
        import time
        if params is None:
            params = SamplingParams()
        if isinstance(params, SamplingParams):
            params = [params] * len(prompts)
        rids = []
        for prompt, p in zip(prompts, params):
            if isinstance(prompt, str):
                rids.append(self.add_request(prompt=prompt, params=p))
            else:
                rids.append(self.add_request(prompt_token_ids=prompt, params=p))
        while self.has_work():
            if not self.step():
                time.sleep(0.005)    # relays in flight, nothing drained
        return [self.requests.pop(rid) for rid in rids]


def adopt_meta(engine, meta: dict, seq_kv: list) -> str:
    """A decode pod's adoption of one migration (the server's runner calls
    it on its loop thread): ``Engine.adopt_prefilled`` from the wire's
    meta."""
    return engine.adopt_prefilled(
        meta["request_id"], meta["prompt_token_ids"], meta["first_token"],
        sampling_from_dict(meta["params"]), seq_kv, guided_plan=meta.get("guided_plan"))

