"""Step executables: the port of the JAX engine's per-bucket executables
and its warmup ladder (``tpuserve/runtime/engine.py``: ``_exec_prefill``,
``_exec_prefill_chunk``, ``_exec_forward_ragged``, the decode executables
and ``_warmup``).

The JAX engine compiles each kind of step once per shape and runs that
executable for every dispatch of the shape.  On the card the counterpart
is a captured CUDA graph.  An :class:`Executable` owns the static buffers
of one key (its step's integer inputs packed in one int32 tensor) and a
graph of the step over them:

- ``("prefill", B, L)``: ``transformer.prefill`` of a padded (B, L) batch;
- ``("chunk", C)``: ``transformer.prefill_chunk`` of one sequence's
  C-row chunk against the cache;
- ``("mixed", T)``: ``transformer.forward_ragged`` of a T-row flat stream,
  descriptors for the engine's fixed number of sequences;
- ``("decode", B, mode[, extras])``: ONE decode iteration
  (``transformer.decode_state_step``, a :class:`DecodeExecutable`) in
  sampling ``mode`` ("greedy", "temperature" or "full"), with ``extras``
  "logprobs" (the chosen token's and the top ``MAX_LOGPROBS``
  logprobs), "penalties" (penalties, ``logit_bias`` and the
  ``min_tokens`` floor) or "logprobs+penalties"; a fused window replays it
  S times, a single step once;
- ``("decode", B, mode, extras + "guided", N, C)``: the same iteration
  with the grammar-FSM mask and state carry, reading the grammar tables
  from the static buffers of its (N states, C classes) bucket
  (:meth:`StepGraphs.grammar_tables`).  The engine refuses a request
  that asks for both logprobs and guided decoding, but a batch may hold
  a guided row beside rows with logprobs;
- ``("verify", B, K, mode)``: ``transformer.decode_verify`` ("greedy":
  each row's argmax) or ``decode_verify_sampled`` ("sampled": rejection
  sampling on the device) of B speculative windows of K rows against the
  cache (a :class:`SpecExecutable`, whose small outputs the engine reads
  synchronously);
- ``("draft", B, T, k)``: ``transformer.draft_propose``, the k cache-less
  passes of the draft model over (B, T) windows in one graph.

With a multi-LoRA stack (``n_adapters`` > 0) the prefill, chunk, mixed
and decode executables stage one more int32 field, ``adapter``: each
row's adapter index (-1 for the base model and for padding), from which
the step makes its one-hot ``ad`` on the device; without a stack they
are made without it, as the JAX transformer compiles without the LoRA
contraction.  Keys do not change: the stack's size is fixed for an
engine.

Every KV write in them drops padding on the device
(``attention.pad_drop``), so no step reads anything back to the host.  A
dispatch fills the buffers with one host-to-device copy from pinned
staging (:class:`Staging`); the step's (B, V) logits are the graph's
output, overwritten by the executable's next replay, so the engine samples
from them before it dispatches the executable again.  A decode dispatch
also selects, for rows that continue an in-flight dispatch, that
dispatch's last tokens on the device (the JAX ``_select_tokens``), and its
(B, S) tokens come back with one device-to-host copy into pinned memory
behind an event, read when the engine flushes the dispatch, and so do its
logprobs.  A "penalties" executable reads three (B, V) float32 buffers
that do not ride the staging (at B = 64 on a 151,936-token vocabulary
they are 117 MB): the engine builds them on the card before the replay,
from each row's token history and its bias and floor ids, which come in
one pinned copy (:meth:`DecodeExecutable.load_extras`).  One set at the
largest bucket serves every executable, each reading its first B rows:
the card runs the engine's work in order, so a build never overtakes the
replay before it.  A guided executable reads its grammar's tables, padded
to a power-of-two (states, classes) bucket, from one set of buffers a
bucket shared by every executable of it; the engine refills them before a
replay only when its dispatch's grammar is not the one last loaded there,
with copies queued in order behind the replays that read the old one.  Its
FSM states are a carry of its own beside the packed buffer: a dispatch
stages each row's state, and a row continuing an in-flight guided
dispatch takes that dispatch's final state on the card, through the same
select as its input token.

An engine's graphs share one memory pool and one capture stream, largest
transient first at warmup.  Before a capture the step runs once on the
capture stream on padding rows, which write nothing, so the cuBLAS
handles, the kernel libraries and the split-K workspace (made once, before
the first capture, for the largest need of every decode and mixed bucket,
and held here as long as the graphs) all exist first.  A replay never
calls the kernel wrappers, so each executable records the launches its
capture made and adds them to the wrappers' ``LAUNCHES`` counts on every
replay; the padding run and the capture count nothing (the capturing
thread counts its launches apart, ``ops/_build.tally``).  A capture that
fails raises: the engine never runs a bucket eagerly in its place.

Every engine of a process captures under one lock, in the "thread_local"
capture error mode: two servers in one process (the fleet's replicas, a
prefill and a decode pod) each capture on first use while the other's
loop thread replays, reads back, allocates and launches on its own
stream; the lock covers captures only.  Without it a capture begun while
another engine's thread worked failed ("operation not permitted when
stream is capturing") and left the allocator recording into its pool, so
the next capture there raised "already recording" (F7).
``StepGraphs.replays_beside_capture`` counts an engine's replays made
while another thread captured.

On the CPU, and on the card with ``capture=False``, there is no graph: the
same object runs the step eagerly on the same buffers.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import math
import time
import threading
import weakref

import numpy as np
import torch

from tpuserve_torch.models import transformer
from tpuserve_torch.models.weights import is_quantized
from tpuserve_torch.ops import _build, flash_prefill, paged_decode, paged_window, ragged_paged
from tpuserve_torch.ops import sampling as sampling_ops
from tpuserve_torch.ops.attention import PAD_SLOT

KERNEL_MODULES = (flash_prefill, paged_decode, paged_window, ragged_paged)
# replays add to the wrappers' counts from every engine's loop thread (two
# servers in one process step at once), and the wrappers count their own
# launches under it: one lock keeps each sum whole
_COUNTS_LOCK = _build.LAUNCH_LOCK
# One capture at a time in the process (F7).  Every engine's graphs share
# the caching allocator, and a capture begun while another records, or one
# that fails, leaves the allocator recording into its pool: the next capture
# there raises "beginAllocateToPool: already recording".  Each capture runs
# in the "thread_local" error mode, so the other engines' loop threads may
# replay, read back and allocate on their own streams meanwhile.
_CAPTURE_LOCK = threading.RLock()
# the thread that holds it, while it captures
_capturing: "int | None" = None
KINDS = ("prefill", "chunk", "mixed", "decode", "verify", "draft")
SPEC_KINDS = ("verify", "draft")       # SpecExecutable's kinds
VERIFY_MODES = ("greedy", "sampled")
# a decode executable's extras, beside none
DECODE_EXTRAS = ("logprobs", "penalties", "logprobs+penalties", "guided",
                 "penalties+guided", "logprobs+guided", "logprobs+penalties+guided")
# the top logprobs a logprobs executable keeps a step (the JAX engine's
# MAX_LOGPROBS: one width, so no request makes a new executable)
MAX_LOGPROBS = 20


def _name(mod) -> str:
    return mod.__name__.rsplit(".", 1)[-1]


def layout(key, max_blocks: int, seqs: int, blk: int, adapters: int = 0) -> tuple:
    """The packed inputs of ``key``'s step: (name, shape, padding value[,
    host dtype]) a field, in buffer order.  The padding values make a step
    that computes nothing and writes nothing; ``seqs`` is the mixed
    descriptors' width and ``blk`` the ragged block; with ``adapters`` (a
    LoRA stack's size) the prefill, chunk, mixed and decode steps take
    each row's adapter index (-1: none)."""
    fields = _layout(key, max_blocks, seqs, blk)
    if adapters and key[0] in ("prefill", "chunk", "mixed", "decode"):
        rows = 1 if key[0] == "chunk" else key[1]
        fields += (("adapter", (rows,), -1),)
    return fields


def _layout(key, max_blocks: int, seqs: int, blk: int) -> tuple:
    kind, *shape = key
    MB = max_blocks
    if kind == "prefill":
        B, L = shape
        return (("tokens", (B, L), 0), ("slot_ids", (B, L), PAD_SLOT),
                ("prompt_lens", (B,), 1))
    if kind == "chunk":
        (C,) = shape
        return (("tokens", (1, C), 0), ("slot_ids", (1, C), PAD_SLOT),
                ("ctx_lens", (1,), 0), ("chunk_lens", (1,), 0),
                ("block_tables", (1, MB), 0))
    if kind == "mixed":
        (T,), B = shape, seqs
        return (("tokens", (T,), 0), ("positions", (T,), 0), ("slot_ids", (T,), PAD_SLOT),
                ("row_seq", (T,), 0), ("block_tables", (B, MB), 0), ("kv_lens", (B,), 0),
                ("q_starts", (B,), T), ("q_lens", (B,), 0), ("meta", (2,), 0),
                ("blk_seq", (T // blk,), -1), ("last_rows", (B,), 0))
    if kind == "decode":
        B = shape[0]
        # salt and step hold uint32 bit patterns; padding rows: length 1,
        # inactive, greedy, no truncation, neutral penalties, no floor,
        # token from the host
        return (("block_tables", (B, MB), 0), ("tokens", (B,), 0), ("positions", (B,), 0),
                ("seq_lens", (B,), 1), ("active", (B,), 0), ("salt", (B,), 0, np.uint32),
                ("step", (B,), 0, np.uint32), ("temperature", (B,), 0, np.float32),
                ("top_k", (B,), 0), ("top_p", (B,), 1.0, np.float32),
                ("min_p", (B,), 0, np.float32), ("presence", (B,), 0, np.float32),
                ("frequency", (B,), 0, np.float32), ("repetition", (B,), 1.0, np.float32),
                ("floor_remaining", (B,), 0), ("use_host", (B,), 1), ("gather", (B,), 0),
                ("col", (1,), 0)) + ((("gstate", (B,), -1),) if is_guided(key) else ())
    if kind == "verify":
        # padding rows: one row at position 0, its KV dropped, greedy
        B, K, mode = shape
        fields = (("tokens", (B, K), 0), ("slot_ids", (B, K), PAD_SLOT),
                  ("ctx_lens", (B,), 0), ("chunk_lens", (B,), 1),
                  ("block_tables", (B, MB), 0))
        if mode == "sampled":
            fields += (("salt", (B,), 0, np.uint32), ("step", (B,), 0, np.uint32),
                       ("temperature", (B,), 0, np.float32), ("top_k", (B,), 0),
                       ("top_p", (B,), 1.0, np.float32), ("min_p", (B,), 0, np.float32))
        return fields
    if kind == "draft":
        B, T, _k = shape
        return (("tokens", (B, T), 0), ("lens", (B,), 1))
    raise ValueError(f"unknown step kind {kind!r} (not in {KINDS})")


def decode_extras(key) -> str:
    """A decode key's extras ("" for none)."""
    return key[3] if len(key) > 3 else ""


def is_guided(key) -> bool:
    """Whether ``key`` is a guided decode executable (its grammar bucket
    (N, C) follows the extras)."""
    return key[0] == "decode" and "guided" in decode_extras(key)


def keeps_logits(key) -> bool:
    """Whether ``key``'s executable keeps its last logits: every kind but
    decode with extras, whose logits no one reads (the engine samples and
    takes logprobs inside the step), so their memory returns to the pool
    for the captures after it."""
    if key[0] in SPEC_KINDS:
        return False
    return key[0] != "decode" or not decode_extras(key)


def _rows(key) -> int:
    """Token rows one step (for the draft, one of its passes) of ``key``
    computes."""
    kind, *shape = key
    return shape[0] * shape[1] if kind in ("prefill", "verify", "draft") else shape[0]


def _out_rows(key, seqs: int) -> int:
    """Rows of the step's (rows, V) logits."""
    if key[0] == "chunk":
        return 1
    if key[0] == "mixed":
        return seqs
    return key[1] * key[2] if key[0] == "verify" else key[1]


def _width(cfg, rows: int) -> int:
    """Values a token row holds in a layer: the hidden, q/k/v and MLP
    widths.  An MoE layer's MLP is one expert group at ``rows`` rows
    (``transformer.moe_group``): its gate, up, activation and folded copy
    (twice the group's width covers them at four bytes a value, since
    they are in the model's dtype) and the router's float32 scores, sort,
    selection and combine (four times the expert count); a model with
    dense layers among its MoE ones counts the wider of the two."""
    mlp = cfg.intermediate_size
    if cfg.num_experts:
        moe = (2 * transformer.moe_group(cfg, rows) * cfg.expert_intermediate_size
               + 4 * cfg.num_experts)
        mlp = max(moe, mlp if cfg.moe_first_k_dense else 0)
    return cfg.hidden_size + cfg.q_size + 2 * cfg.kv_size + mlp


@dataclasses.dataclass(frozen=True)
class Sizing:
    """What a step's transients depend on beyond its key and model: ``ctx``
    the tokens one sequence's block table spans (MLA's plain attention
    gathers them all), ``blk`` the mixed layout's block, ``int8`` weights
    dequantized at each product, ``lora_rank`` the widest stacked adapter
    rank (0: no stack)."""
    ctx: int = 0
    blk: int = 8
    int8: bool = False
    lora_rank: int = 0


def sizing_of(params: dict, ctx: int, blk: int) -> Sizing:
    """The :class:`Sizing` of an engine's weights: int8 when the embedding
    carries a scale, the widest ``lora`` stack's rank."""
    rank = 0
    for lp in params["layers"]:
        for p in lp.values():
            if isinstance(p, dict) and "lora" in p:
                rank = max(rank, p["lora"]["A"].shape[-1])
    return Sizing(ctx=ctx, blk=blk, int8=is_quantized(params), lora_rank=rank)


def _mla_bytes(cfg, key, seqs: int, sz: Sizing) -> int:
    """MLA's plain attention (no kernel takes its shapes).  The naive
    prefill and draft paths: the decompressed per-head K and V with their
    float32 copies, and three (B, H, T, T) float32 score tensors (scores,
    their mask and softmax).  The absorbed paths: every gathered sequence's
    ``ctx`` latent pages, gathered as K and as V, with dequantized and
    float32 copies (16 bytes a value), and their float32 scores (three
    copies over the whole context for decode and mixed rows, four over a
    512-key segment for chunk and verify rows)."""
    kind, *shape = key
    H, lat = cfg.num_heads, cfg.mla_latent_dim
    if kind in ("prefill", "draft"):
        B, T = shape[0], shape[1]
        return (B * T * H * (2 * cfg.head_dim + cfg.mla_v_head_dim) * 8
                + 3 * B * H * T * T * 4)
    S = max(sz.ctx, 1)
    if kind == "decode":
        gathered, score_rows = shape[0], shape[0] * 3 * S
    elif kind == "mixed":
        T = shape[0]
        gathered, score_rows = min(seqs, T) + T // sz.blk, (min(seqs, T) + T) * 3 * S
    else:                                   # chunk (1, C) and verify (B, K)
        rows = shape[0] if kind == "chunk" else shape[0] * shape[1]
        gathered = 1 if kind == "chunk" else shape[0]
        score_rows = rows * 4 * min(512, S)
    return gathered * S * lat * 16 + score_rows * H * 4


def _weight_copy_bytes(cfg, rows: int, sz: Sizing) -> int:
    """The model-dtype copy an int8 product dequantizes: the largest dense
    kernel (the vocabulary-wide embedding or lm_head among them) or one
    expert group's projection (``transformer.moe_group``)."""
    if not sz.int8:
        return 0
    H = cfg.hidden_size
    widest = max(cfg.vocab_size, cfg.intermediate_size, cfg.q_size, cfg.kv_size)
    if cfg.num_experts:
        widest = max(widest, transformer.moe_group(cfg, rows) * cfg.expert_intermediate_size)
    itemsize = 4 if cfg.dtype == "float32" else 2
    return H * widest * itemsize


def _lora_bytes(cfg, key, sz: Sizing) -> int:
    """A LoRA stack's per-row factors (``transformer._lora_delta``): (in +
    out) x rank values a batch row of the widest targeted linear, with its
    temporaries (eight bytes a value)."""
    if not sz.lora_rank or key[0] not in ("prefill", "chunk", "mixed", "decode"):
        return 0
    rows = 1 if key[0] == "chunk" else key[1]
    width = cfg.hidden_size + max(cfg.intermediate_size, cfg.q_size, cfg.hidden_size)
    return rows * width * sz.lora_rank * 8


def transient_bytes(cfg, key, seqs: int, draft_cfg=None, sizing: Sizing | None = None) -> int:
    """:func:`_step_bytes` of ``key``, plus what the engine's weights and
    attention add to it (``sizing``): MLA's plain attention, an int8
    product's dequantized copy, a LoRA stack's per-row factors."""
    sz = sizing or Sizing()
    total = _step_bytes(cfg, key, seqs, draft_cfg)
    mc = (draft_cfg or cfg) if key[0] == "draft" else cfg
    if mc.is_mla:
        total += _mla_bytes(mc, key, seqs, sz)
    if key[0] != "draft":
        total += _weight_copy_bytes(cfg, _rows(key), sz) + _lora_bytes(cfg, key, sz)
    return total


def _step_bytes(cfg, key, seqs: int, draft_cfg=None) -> int:
    """An upper estimate of the memory one step of ``key`` holds beyond its
    output, from shapes: per token row, the layer's activations with
    float32 norm, qk-norm and RoPE temporaries (three copies of the
    hidden, q/k/v and MLP widths, four bytes each; :func:`_width`, an MoE
    layer's expert group and router included), a decode step's rows too;
    per output row, the unembedding's bf16 and float32 logits.  For
    decode, per (B, V) element: 64 bytes, eight int64 tensors of the
    keyed noise; in the full mode 24 more, the sorted logits and their
    int64 indices held through the noise (the sort itself, its keep mask
    and its softmax and cumsum are freed before the noise is drawn); with
    logprobs 16 more, the
    log-softmax and the top-k's buffers; with penalties 24 more, the
    penalized, biased and floored logits' temporaries; guided 16 more, the
    gathered mask words, their bit test and the masked logits.  A sampled
    verify adds, per (B, V) element of the position it samples, 120 bytes:
    the noise's 64, the truncation's sorted logits and indices (24) and the
    probabilities, the scattered masked logits and the drop mask (32).  A
    draft step's rows are those of one pass of the draft model
    (``draft_cfg``, the target's when None), whose output is each row's
    last-position logits."""
    V = cfg.vocab_size
    if key[0] == "decode":
        extras = decode_extras(key)
        per = (64 + 24 * (key[2] == "full") + 16 * ("logprobs" in extras)
               + 24 * ("penalties" in extras) + 16 * ("guided" in extras))
        return key[1] * V * per + key[1] * 3 * 4 * _width(cfg, key[1])
    if key[0] == "draft":
        dc = draft_cfg or cfg
        return _rows(key) * 3 * 4 * _width(dc, _rows(key)) + key[1] * V * 6
    base = _rows(key) * 3 * 4 * _width(cfg, _rows(key)) + _out_rows(key, seqs) * V * 6
    if key[0] == "verify" and key[3] == "sampled":
        base += key[1] * V * 120
    return base


def pool_bytes_bound(cfg, keys, seqs: int, draft_cfg=None,
                     sizing: Sizing | None = None) -> int:
    """The most device memory one engine's graphs can reserve, from
    shapes: every executable of ``keys`` that keeps its logits
    (:func:`keeps_logits`) holds its (rows, V) float32 logits; the
    largest step's transients (:func:`transient_bytes`) are reused by
    every later capture in the pool, counted twice for the allocator's
    splitting of them; and 256 MiB for the capture stream's cuBLAS
    workspace and the allocator's rounding.  A verify or draft executable
    keeps only its small outputs.  ``sizing`` as :func:`transient_bytes`.
    The engine leaves this much free when it sizes its cache to the card."""
    keys = list(keys)
    if not keys:
        return 0
    V = cfg.vocab_size
    logits = sum(_out_rows(k, seqs) for k in keys if keeps_logits(k)) * V * 4
    return logits + 2 * max(transient_bytes(cfg, k, seqs, draft_cfg, sizing)
                            for k in keys) + (256 << 20)


class Staging:
    """One dispatch's packed inputs on the host: a numpy view of one int32
    tensor a field, by name, holding the padding values (pinned on the
    card, so its copy to the card is asynchronous; the caching host
    allocator reuses it only after that copy ran)."""

    def __init__(self, fields: tuple, pinned: bool):
        n = sum(math.prod(f[1]) for f in fields)
        self.tensor = torch.empty(n, dtype=torch.int32, pin_memory=pinned)
        a = self.tensor.numpy()
        off = 0
        for name, shape, fill, *dtype in fields:
            size = math.prod(shape)
            view = a[off:off + size]
            if dtype:
                view = view.view(*dtype)
            view[:] = fill
            setattr(self, name, view.reshape(shape))
            off += size


def _ad(o, v):
    """The step's one-hot adapter weights from its ``adapter`` field, made
    on the device; None without a LoRA stack."""
    if "adapter" not in v:
        return None
    return transformer.adapter_rows(v["adapter"], o.n_adapters, torch.float32)


def _prefill(o, v):
    return transformer.prefill(o.params, o.cfg, v["tokens"], v["prompt_lens"], v["slot_ids"],
                               o.kv_cache, _ad(o, v), attn_impl=o.attn_impl)[0]


def _chunk(o, v):
    return transformer.prefill_chunk(o.params, o.cfg, v["tokens"], v["ctx_lens"],
                                     v["chunk_lens"], v["slot_ids"], v["block_tables"],
                                     o.kv_cache, _ad(o, v), attn_impl=o.attn_impl)[0]


def _mixed(o, v):
    return transformer.forward_ragged(
        o.params, o.cfg, v["tokens"], v["positions"], v["slot_ids"], v["row_seq"],
        v["block_tables"], v["kv_lens"], v["q_starts"], v["q_lens"], v["meta"],
        v["blk_seq"], v["last_rows"], o.kv_cache, _ad(o, v), ragged_blk=o.ragged_blk,
        attn_impl=o.attn_impl)[0]


def _verify(o, v):
    args = (o.params, o.cfg, v["tokens"], v["ctx_lens"], v["chunk_lens"], v["slot_ids"],
            v["block_tables"], o.kv_cache)
    if "salt" not in v:
        return (transformer.decode_verify(*args, attn_impl=o.attn_impl)[0],)
    keys = torch.stack([v["salt"], v["step"]], dim=1)
    accept, pred, _ = transformer.decode_verify_sampled(
        *args, keys, v["temperature"], v["top_k"], v["top_p"], v["min_p"],
        attn_impl=o.attn_impl)
    return pred, accept


def _draft(o, v, k):
    return (transformer.draft_propose(o.draft_params, o.draft_cfg, v["tokens"], v["lens"],
                                      k=k, attn_impl=o.attn_impl),)


_BODIES = {"prefill": _prefill, "chunk": _chunk, "mixed": _mixed}


class Executable:
    """The static buffers and (on the card) the captured graph of one
    prefill, chunk or mixed step (``key``); ``views`` names each field's
    tensor in ``buf``."""

    def __init__(self, owner: "StepGraphs", key: tuple):
        # a weak reference: the owner holds its executables, and a cycle
        # would outlive the engine until a garbage collection, which could
        # then destroy these graphs inside a later capture and invalidate it
        self.owner = weakref.proxy(owner)
        self.key = key
        self.fields = layout(key, owner.max_blocks, owner.max_batch, owner.ragged_blk,
                             owner.n_adapters)
        self.buf = torch.zeros(sum(math.prod(f[1]) for f in self.fields), dtype=torch.int32,
                               device=owner.device)
        self.views, off = {}, 0
        for name, shape, _fill, *dtype in self.fields:
            size = math.prod(shape)
            view = self.buf[off:off + size].view(shape)
            self.views[name] = view.view(torch.float32) if dtype == [np.float32] else view
            off += size
        self.graph = None
        self.logits = None           # the last run's (rows, V) float32 logits
        self.launches: dict = {}     # kernel launches one replay makes
        self.stage_counts = None     # a pipeline stage's counts one replay makes
        self.capture_s = 0.0         # wall seconds its capture took

    def step(self) -> torch.Tensor:
        return _BODIES[self.key[0]](self.owner, self.views)

    def stage(self) -> Staging:
        return Staging(self.fields, self.owner.device.type == "cuda")

    def load(self, staging: Staging) -> None:
        self.buf.copy_(staging.tensor, non_blocking=True)

    def pad_run(self) -> None:
        """One step on padding rows, which compute and write nothing."""
        self.load(self.stage())
        self.step()

    def run(self, steps: int = 1) -> None:
        """``steps`` steps: graph replays on the card, else eager."""
        self.owner.replays[self.key[0]] += steps
        if self.graph is None:
            for _ in range(steps):
                self.logits = self.step()
            return
        if _capturing not in (None, threading.get_ident()):
            self.owner.replays_beside_capture += steps
        for _ in range(steps):
            self.graph.replay()
        if self.stage_counts:
            self.owner.cfg.stage.counts.update(
                {k: v * steps for k, v in self.stage_counts.items()})
        with _COUNTS_LOCK:
            for mod in KERNEL_MODULES:
                mod.LAUNCHES += self.launches[_name(mod)] * steps


class DecodeExecutable(Executable):
    """One (padded batch ``B``, ``mode``, ``extras``) decode iteration over
    a :class:`transformer.DecodeState` made of the buffers, with a (B,
    steps) output written one column an iteration (and, with logprobs,
    (B, steps[, MAX_LOGPROBS]) logprob outputs)."""

    def __init__(self, owner: "StepGraphs", key: tuple):
        super().__init__(owner, key)
        self.B, self.mode, self.extras = key[1], key[2], decode_extras(key)
        if self.mode not in transformer.DECODE_MODES:
            raise ValueError(f"decode mode {self.mode!r} not in {transformer.DECODE_MODES}")
        if self.extras and self.extras not in DECODE_EXTRAS:
            raise ValueError(f"decode extras {self.extras!r} not in {DECODE_EXTRAS}")
        v, B, S, dev = self.views, self.B, owner.steps, owner.device
        self.use_host, self.gather = v["use_host"], v["gather"]
        self.state = transformer.DecodeState(
            tokens=v["tokens"], positions=v["positions"], seq_lens=v["seq_lens"],
            active=v["active"], salt=v["salt"], step=v["step"],
            temperature=v["temperature"], block_tables=v["block_tables"],
            out=torch.zeros((B, S), dtype=torch.int32, device=dev), col=v["col"],
            top_k=v["top_k"], top_p=v["top_p"], min_p=v["min_p"])
        if "penalties" in self.extras:
            counts, bias, floor_bias = owner.sampling_buffers()
            st = self.state
            st.counts, st.bias, st.floor_bias = counts[:B], bias[:B], floor_bias[:B]
            st.presence, st.frequency = v["presence"], v["frequency"]
            st.repetition, st.floor_remaining = v["repetition"], v["floor_remaining"]
        if is_guided(key):
            st = self.state
            st.gstate = torch.full((B,), -1, dtype=torch.int32, device=dev)
            st.gmasks, st.gclass, st.gnext = owner.grammar_tables(*key[4:6])
        if "logprobs" in self.extras:
            self.state.lp_chosen = torch.zeros((B, S), dtype=torch.float32, device=dev)
            self.state.lp_ids = torch.zeros((B, S, MAX_LOGPROBS), dtype=torch.int32,
                                            device=dev)
            self.state.lp_vals = torch.zeros((B, S, MAX_LOGPROBS), dtype=torch.float32,
                                             device=dev)

    def step(self) -> torch.Tensor:
        o = self.owner
        self.state.ad = _ad(o, self.views)
        return transformer.decode_state_step(o.params, o.cfg, self.state, o.kv_cache,
                                             mode=self.mode, attn_impl=o.attn_impl)

    def load(self, staging: Staging, chain=None) -> None:
        """Copy ``staging`` into the buffers; ``chain`` = (executable,
        steps) of the in-flight dispatch whose last tokens (and, when it
        carried them, final FSM states) feed the rows with ``use_host`` 0
        (row ``gather`` of its output)."""
        self.buf.copy_(staging.tensor, non_blocking=True)
        prev = None if chain is None else chain[0]
        if prev is not None:
            last = prev.state.out[:, chain[1] - 1][self.gather.long()]
            self.state.tokens.copy_(torch.where(self.use_host != 0, self.state.tokens, last))
        if self.state.gstate is not None:
            gstate = self.views["gstate"]
            if prev is not None and prev.state.gstate is not None:
                gstate = torch.where(self.use_host != 0, gstate,
                                     prev.state.gstate[self.gather.long()])
            self.state.gstate.copy_(gstate)

    def load_extras(self, history: np.ndarray, bias_ids: np.ndarray, bias_vals: np.ndarray,
                    floor_ids: np.ndarray, floor_vals: np.ndarray) -> None:
        """Build the penalties' (B, V) buffers on the device, in the work
        enqueued before the replay: the counts of each row's (B, T) token
        history (ids past the vocabulary are padding), the dense bias of
        (B, K) ids and values, and the floor mask of (B, K') ids and
        values.  The five arrays come in one pinned copy."""
        parts = [history.astype(np.int32), bias_ids.astype(np.int32),
                 bias_vals.astype(np.float32).view(np.int32), floor_ids.astype(np.int32),
                 floor_vals.astype(np.float32).view(np.int32)]
        sizes = [p.size for p in parts]
        host = torch.empty(sum(sizes), dtype=torch.int32,
                           pin_memory=self.owner.device.type == "cuda")
        host.numpy()[:] = np.concatenate([p.ravel() for p in parts])
        dev = host.to(self.owner.device, non_blocking=True)
        hist, b_ids, b_vals, f_ids, f_vals = (
            t.view(p.shape) for t, p in zip(torch.split(dev, sizes), parts))
        st = self.state
        sampling_ops.scatter_add_rows(st.counts.zero_(), hist,
                                      torch.ones(hist.shape, dtype=torch.float32,
                                                 device=hist.device))
        sampling_ops.scatter_add_rows(st.bias.zero_(), b_ids, b_vals.view(torch.float32))
        sampling_ops.scatter_add_rows(st.floor_bias.zero_(), f_ids,
                                      f_vals.view(torch.float32))

    def fetch(self, steps: int):
        """The first ``steps`` columns of the output, and with logprobs
        the (chosen, ids, values) of those steps, copied to the host behind
        the work enqueued so far: (host tokens, host logprobs or None,
        event or None)."""
        st = self.state
        outs = [st.out[:, :steps]]
        if st.lp_chosen is not None:
            outs += [st.lp_chosen[:, :steps], st.lp_ids[:, :steps], st.lp_vals[:, :steps]]
        if self.owner.device.type != "cuda":
            host, event = [t.clone() for t in outs], None
        else:
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs]
            for h, t in zip(host, outs):
                h.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return host[0], (tuple(host[1:]) if len(host) > 1 else None), event


class SpecExecutable(Executable):
    """A verify or draft step: its outputs are a few int32 (and bool)
    tensors, (B, K) predictions (and (B, K-1) acceptances) or (B, k) draft
    tokens, which the engine reads back synchronously: the host decides
    what a speculative step emits before the next dispatch."""

    def __init__(self, owner: "StepGraphs", key: tuple):
        if key[0] == "verify" and key[3] not in VERIFY_MODES:
            raise ValueError(f"verify mode {key[3]!r} not in {VERIFY_MODES}")
        if key[0] == "draft" and owner.draft_params is None:
            raise ValueError("a draft step needs StepGraphs.draft_params")
        super().__init__(owner, key)
        self.out: tuple = ()

    def step(self) -> tuple:
        if self.key[0] == "draft":
            return _draft(self.owner, self.views, self.key[3])
        return _verify(self.owner, self.views)

    def run(self, steps: int = 1) -> None:
        if self.graph is None:
            self.owner.replays[self.key[0]] += steps
            self.out = self.step()
            return
        super().run(steps)

    def fetch(self) -> tuple:
        """The outputs on the host as numpy arrays: waits on the card."""
        return tuple(t.cpu().numpy() for t in self.out)


class StepGraphs:
    """One engine's executables of every step kind, keyed as the module
    docstring says, made (and on the card captured) on first use or by
    :meth:`warmup`.  ``steps``: the widest decode dispatch (the engine's
    ``multi_step``); ``max_batch``: the largest decode bucket and the
    mixed descriptors' width; ``ragged_blk``: the mixed layout's block;
    ``n_adapters``: the size of the weights' LoRA stack (0: none)."""

    def __init__(self, params: dict, cfg, kv_cache: list, *, device: torch.device,
                 attn_impl: str, max_blocks: int, steps: int, max_batch: int,
                 capture: bool, ragged_blk: int | None = None,
                 draft_params: dict | None = None, draft_cfg=None, n_adapters: int = 0):
        if capture and device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.params, self.cfg, self.kv_cache = params, cfg, kv_cache
        self.n_adapters = n_adapters
        # the speculative draft model's weights and config (draft steps)
        self.draft_params, self.draft_cfg = draft_params, draft_cfg
        self.device, self.attn_impl = device, attn_impl
        self.max_blocks, self.steps, self.max_batch = max_blocks, steps, max_batch
        self.ragged_blk = ragged_blk or ragged_paged.ragged_block(device)
        page = kv_cache[0]["k"].shape[1] if kv_cache else 0
        self.sizing = sizing_of(params, max_blocks * page, self.ragged_blk)
        self.capture = capture
        self.executables: dict = {}
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.stream = torch.cuda.Stream(device) if capture else None
        self.workspace = None        # held as long as the graphs
        self.capture_s = 0.0         # wall seconds spent capturing
        # time.monotonic() at the start of the capture running now, else
        # None: the runner's watchdog discounts a step's capture time
        self.capturing_since: float | None = None
        # steps run by kind: graph replays on the card, eager runs otherwise
        self.replays = collections.Counter()
        # graph replays made while another thread captured (F7)
        self.replays_beside_capture = 0
        # called with (key, seconds) when an executable is made (on the
        # card: its capture wall), the device profiler's ladder hook
        self.on_make = None
        self.hits = 0                # get() calls that found their executable
        self._sampling_buffers = None
        # (N, C) grammar bucket -> [masks, tok_class, class_next, loaded tag]
        self._grammar: dict = {}

    def sampling_buffers(self) -> tuple:
        """The penalties executables' (max_batch, V) float32 counts, bias
        and floor mask, made on first use (outside any capture) and
        shared: each executable reads its first B rows."""
        if self._sampling_buffers is None:
            shape = (self.max_batch, self.cfg.vocab_size)
            self._sampling_buffers = tuple(
                torch.zeros(shape, dtype=torch.float32, device=self.device) for _ in range(3))
        return self._sampling_buffers

    def grammar_tables(self, N: int, C: int) -> tuple:
        """The guided executables' static grammar buffers of the (``N``
        states, ``C`` classes) bucket, made on first use (outside any
        capture) and shared by every executable of the bucket: (N,
        ceil(V/32)) int32 packed masks, (V,) int32 token classes and (N,
        C) int32 transitions, zeros until a grammar is loaded (every index
        they give stays in range)."""
        ent = self._grammar.get((N, C))
        if ent is None:
            V, dev = self.cfg.vocab_size, self.device
            ent = self._grammar[(N, C)] = [
                torch.zeros((N, (V + 31) // 32), dtype=torch.int32, device=dev),
                torch.zeros((V,), dtype=torch.int32, device=dev),
                torch.zeros((N, C), dtype=torch.int32, device=dev), None]
        return tuple(ent[:3])

    def load_grammar(self, bucket: tuple, tag, masks: torch.Tensor,
                     tok_class: torch.Tensor | None = None,
                     class_next: torch.Tensor | None = None) -> bool:
        """Fill ``bucket``'s grammar buffers before a replay, unless
        ``tag`` (a grammar, held here so that its identity is not reused)
        is the one loaded there last; ``tag`` None always loads.  Without
        ``tok_class`` / ``class_next`` every token is class 0 and every
        transition leads to state 0 (per-row tables whose states the host
        advances).  The copies are queued in order behind the replays
        that read the buffers' previous contents.  Returns whether it
        loaded."""
        ent = self._grammar[bucket]
        if tag is not None and ent[3] is tag:
            return False
        ent[0].copy_(masks, non_blocking=True)
        for buf, src in ((ent[1], tok_class), (ent[2], class_next)):
            if src is None:
                buf.zero_()
            else:
                buf.copy_(src, non_blocking=True)
        ent[3] = tag
        return True

    def grammar_loaded(self, bucket: tuple, tag) -> bool:
        """Whether ``bucket``'s buffers hold ``tag``'s tables already (so
        ``load_grammar`` would skip them)."""
        return tag is not None and self._grammar[bucket][3] is tag

    def get(self, *key) -> Executable:
        exe = self.executables.get(key)
        if exe is not None:
            self.hits += 1
        else:
            t0 = time.perf_counter()
            if key[0] == "decode":
                exe = DecodeExecutable(self, key)
            elif key[0] in SPEC_KINDS:
                exe = SpecExecutable(self, key)
            elif key[0] in _BODIES:
                exe = Executable(self, key)
            else:
                raise ValueError(f"unknown step kind {key[0]!r} (not in {KINDS})")
            if self.capture:
                self.capturing_since = time.monotonic()
                try:
                    self._capture(exe)       # adds to capture_s, then ...
                finally:
                    self.capturing_since = None   # ... the stamp goes
            self.executables[key] = exe
            if self.on_make is not None:
                self.on_make(key, time.perf_counter() - t0)
        return exe

    def release(self) -> None:
        """Drop every executable (on the card: the captured graphs, whose
        pool goes with the last of them) and the capture stream's split-K
        scratch, before the owner's engine is rebuilt around another
        model."""
        self.executables.clear()
        self._sampling_buffers = None
        self._grammar.clear()
        if self.stream is not None and self.workspace is not None:
            paged_decode.release_workspace(*self._workspace_key())
        self.workspace = None

    def pool_bound(self, keys) -> int:
        """:func:`pool_bytes_bound` of ``keys`` for these graphs' model,
        weights and cache."""
        return pool_bytes_bound(self.cfg, keys, self.max_batch, self.draft_cfg, self.sizing)

    def pool_bytes(self) -> int:
        """Device memory the graphs' shared pool holds: the sizes of its
        allocator segments."""
        if self.pool is None:
            return 0
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory_snapshot(mempool_id=self.pool))

    def device_bytes(self) -> int:
        """Device memory these graphs hold beyond the weights and the
        cache, as the allocator reports it: the pool's segments, the
        shared sampling and grammar buffers, the split-K scratch."""
        held = [t for t in (self._sampling_buffers or ())]
        held += [t for tabs in self._grammar.values() for t in tabs if torch.is_tensor(t)]
        held += list(self.workspace or ())
        return self.pool_bytes() + sum(t.numel() * t.element_size() for t in held)

    def warmup(self, keys) -> None:
        """Make every executable of ``keys``, the largest transient first,
        so later captures reuse its memory in the pool.  Without capture
        each runs once on padding rows, as a capture's first run does."""
        for key in self.warmup_order(keys):
            exe = self.get(*key)
            if exe.graph is None:
                exe.pad_run()

    def warmup_order(self, keys) -> list:
        """``keys`` without repeats, the largest transient first, ties by
        the key's text: one order in every process (lockstep ranks make
        their executables in step)."""
        return sorted(set(keys), key=lambda k: (-transient_bytes(
            self.cfg, k, self.max_batch, self.draft_cfg, self.sizing), repr(k)))

    def _workspace_key(self):
        k = self.kv_cache[0]["k"]
        return k.device, self.stream.cuda_stream

    def _make_workspace(self) -> None:
        """The capture stream's split-K workspace, made once before the
        first capture for the most any decode bucket (at most
        ``max_batch``) or mixed step (``max_batch`` descriptors) can
        need: ``ragged_decode_blocks`` is that most, over every decode-row
        count up to its argument.  Graphs bake its address in, so it must
        never grow afterwards."""
        if self.workspace is not None:
            return
        _, page, Hkv, D = self.kv_cache[0]["k"].shape
        blocks = paged_decode.ragged_decode_blocks(
            self.max_batch, Hkv, self.max_blocks, page, paged_decode.num_sms(self.device))
        self.workspace = paged_decode.workspace(
            *self._workspace_key(), blocks * paged_decode.split_stride(self.cfg.num_heads // Hkv, D),
            self.max_batch * Hkv)

    def _capture(self, exe: Executable) -> None:
        global _capturing
        t0 = time.perf_counter()
        with _CAPTURE_LOCK:
            outer, _capturing = _capturing, threading.get_ident()
            try:
                self._capture_locked(exe)
            finally:
                _capturing = outer
        exe.capture_s = time.perf_counter() - t0
        self.capture_s += exe.capture_s

    def _capture_locked(self, exe: Executable) -> None:
        if self.attn_impl == "cuda":
            self._make_workspace()
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        # the padding run and the capture serve no request: their launches
        # (and a pipeline stage's microbatches and transfers) are counted
        # apart, and the capture's become the replays' count
        stage = self.cfg.stage
        apart = stage.tally if stage is not None else contextlib.nullcontext
        with _build.tally(), apart(), torch.cuda.stream(self.stream):
            exe.pad_run()
        main.wait_stream(self.stream)
        if self.workspace is not None and paged_decode.workspace(
                *self._workspace_key(), 0, 0)[0] is not self.workspace[0]:
            raise RuntimeError(f"{exe.key}: the split-K workspace grew past its size")
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a finalizer that frees
        # CUDA objects (another engine's graphs, pinned memory) there would
        # invalidate it
        collect = gc.isenabled()
        gc.disable()
        try:
            with _build.tally() as made, apart() as moved, torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                logits = exe.step()
        finally:
            if collect:
                gc.enable()
        exe.launches = {_name(mod): made[_name(mod)] for mod in KERNEL_MODULES}
        exe.stage_counts = moved
        exe.graph, exe.logits = graph, (logits if keeps_logits(exe.key) else None)
        if isinstance(exe, SpecExecutable):
            exe.out = logits
