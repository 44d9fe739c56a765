"""Portable, versioned replay-workload files.

The port's own copy of ``tpuserve/replay/workload.py``: the same schema,
and the same synthesized prompt ids for the same workload.

A workload file is the incident, minus the machine it happened on: the
arrival process (per-request offsets from workload start), prompt and
generation lengths, SLO-class and tenant mix, conversation/prefix reuse
(requests in one ``prefix_group`` share a deterministic prompt prefix,
so the prefix cache and the tiered KV store see the same reuse the
incident saw), and the fault schedule (a ``runtime/faults.py`` spec
string — replay re-arms the exact injection machinery the chaos drills
use).  Everything else — token ids, engine sizing — is synthesized
deterministically at replay time from ``seed``, which is what makes the
file portable across models and hosts: the same file replays against
the tiny CPU model in CI and against a real checkpoint on a chip.

Sources: flight-recorder bundles (post-mortems and on-demand
``/debug/engine/dump`` exports) via ``tpuserve_torch/replay/extract.py``, and
bench traces (which also store exact prompt token ids, since they have
them).

Schema versioning is loud by design: a missing/foreign ``kind``, a
missing ``schema_version``, or a version newer than this build refuses
to load — a replay that silently half-understood its workload would
publish SLI diffs measuring nothing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import random
from typing import Optional

logger = logging.getLogger("tpuserve_torch.replay")

WORKLOAD_KIND = "tpuserve-replay-workload"
WORKLOAD_SCHEMA_VERSION = 1


@dataclasses.dataclass
class WorkloadRequest:
    """One request of the recorded workload (everything the engine's
    admission + scheduling policy can react to, nothing it can't)."""

    request_id: str
    arrival_s: float                     # offset from workload start
    prompt_tokens: int                   # prompt length (ids synthesized)
    max_tokens: int                      # generation budget
    slo_class: str = "standard"
    tenant: Optional[str] = None
    temperature: float = 0.0
    top_p: float = 1.0
    seed: Optional[int] = 0              # SamplingParams.seed
    ignore_eos: bool = True              # random weights rarely emit EOS;
    #                                      length-bounded replay keeps the
    #                                      recorded generation counts
    # conversation / prefix reuse: requests sharing a prefix_group share
    # their first prefix_tokens prompt ids (deterministic from the group
    # name), so prefix caching and tier restores engage like the incident
    prefix_group: Optional[str] = None
    prefix_tokens: int = 0
    # exact ids when the source had them (bench traces); replay prefers
    # these (modulo the target vocab) over synthesized ids
    prompt_token_ids: Optional[list] = None
    # terminal state observed at the source, for the replay report's
    # accounting diff: "length"/"stop"/"abort" (FINISHED cause), "shed",
    # "unfinished" (in flight when the incident was captured), None
    source_outcome: Optional[str] = None

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}


@dataclasses.dataclass
class Workload:
    requests: list
    seed: int = 0
    faults: Optional[str] = None         # runtime/faults.py spec string
    meta: dict = dataclasses.field(default_factory=dict)
    schema_version: int = WORKLOAD_SCHEMA_VERSION

    # ---- derived -------------------------------------------------------

    def duration_s(self) -> float:
        """Span of the arrival process (virtual seconds)."""
        if not self.requests:
            return 0.0
        return max(r.arrival_s for r in self.requests)

    def summary(self) -> dict:
        classes: dict = {}
        for r in self.requests:
            classes[r.slo_class] = classes.get(r.slo_class, 0) + 1
        return {
            "requests": len(self.requests),
            "arrival_span_s": round(self.duration_s(), 3),
            "classes": classes,
            "prompt_tokens_total": sum(r.prompt_tokens
                                       for r in self.requests),
            "max_tokens_total": sum(r.max_tokens for r in self.requests),
            "prefix_groups": len({r.prefix_group for r in self.requests
                                  if r.prefix_group}),
            "faults": self.faults,
        }

    # ---- prompt synthesis ---------------------------------------------

    def _rng(self, *salt: str) -> random.Random:
        """Deterministic per-salt RNG.  NOT builtin hash() — that is
        salted per process and would make replays machine-unique."""
        digest = hashlib.sha256(
            ":".join((str(self.seed),) + salt).encode()).digest()
        return random.Random(int.from_bytes(digest[:8], "big"))

    def prompt_ids(self, req: WorkloadRequest, vocab_size: int) -> list:
        """Synthesize the request's prompt ids for a target vocab:
        recorded ids when the source had them (folded into the vocab),
        else ``prefix_tokens`` ids deterministic from the prefix group
        followed by ids deterministic from the request id.  Ids stay in
        [1, vocab-2] like the bench's generator (no specials)."""
        hi = max(vocab_size - 2, 1)
        if req.prompt_token_ids:
            # ids already in range pass through UNCHANGED (a bench trace
            # replayed against its own model must send the recorded
            # prompts verbatim); only out-of-vocab ids fold
            return [int(t) if 1 <= int(t) <= hi else 1 + (int(t) % hi)
                    for t in req.prompt_token_ids]
        n = max(1, int(req.prompt_tokens))
        pfx = min(max(0, int(req.prefix_tokens)), n) \
            if req.prefix_group else 0
        ids = []
        if pfx:
            g = self._rng("prefix", req.prefix_group)
            ids += [g.randint(1, hi) for _ in range(pfx)]
        r = self._rng("req", req.request_id)
        ids += [r.randint(1, hi) for _ in range(n - len(ids))]
        return ids

    # ---- (de)serialization --------------------------------------------

    def as_dict(self) -> dict:
        return {
            "kind": WORKLOAD_KIND,
            "schema_version": self.schema_version,
            "seed": self.seed,
            "faults": self.faults,
            "meta": self.meta,
            "summary": self.summary(),      # informational (jq-friendly)
            "requests": [r.as_dict() for r in self.requests],
        }

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.as_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def from_dict(cls, data: dict) -> "Workload":
        if not isinstance(data, dict) or data.get("kind") != WORKLOAD_KIND:
            raise ValueError(
                f"not a replay workload file (kind="
                f"{data.get('kind') if isinstance(data, dict) else type(data)!r}"
                f"; want {WORKLOAD_KIND!r}) — did you pass a flight bundle?"
                " Convert it first: replay.workload_from_bundle(bundle)")
        sv = data.get("schema_version")
        if sv is None:
            raise ValueError("workload file carries no schema_version — "
                             "refusing to guess its layout")
        if int(sv) > WORKLOAD_SCHEMA_VERSION:
            raise ValueError(
                f"workload schema_version {sv} is newer than this build "
                f"understands ({WORKLOAD_SCHEMA_VERSION}) — upgrade the "
                "tree or re-extract the bundle with this version")
        known = {f.name for f in dataclasses.fields(WorkloadRequest)}
        reqs = []
        for i, rd in enumerate(data.get("requests", ())):
            if "request_id" not in rd or "arrival_s" not in rd:
                raise ValueError(f"request #{i} lacks request_id/arrival_s")
            reqs.append(WorkloadRequest(
                **{k: v for k, v in rd.items() if k in known}))
        reqs.sort(key=lambda r: (r.arrival_s, r.request_id))
        return cls(requests=reqs, seed=int(data.get("seed", 0)),
                   faults=data.get("faults") or None,
                   meta=dict(data.get("meta", {})), schema_version=int(sv))

    @classmethod
    def load(cls, path: str) -> "Workload":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))
