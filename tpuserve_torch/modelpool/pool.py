"""Model pool: the per-replica catalog and hot-swap controller — the port of
``tpuserve/modelpool/pool.py`` on torch tensors.

One replica, N registered models, <=K resident: the pool owns which
weights are where (HBM / host DRAM / PVC, via :class:`WeightTiers`),
routes per-request model names, and drives ``Engine.swap_model`` as a
first-class operation — drain to a window boundary (the runner calls
:meth:`maybe_swap` only when ``engine.has_work()`` is False), demote the
outgoing weights through the tiers, restore the incoming set from the
warmest tier onto the card, and rebuild the engine around it.  The
outgoing engine's captured graphs, their memory pool and its KV cache are
released before the incoming ones are made (``Engine.swap_model``), and
the incoming model's graphs are captured on first use.

Swap policy (``swap_policy``):
- ``"swap"``: a request for a registered-but-cold model parks at intake
  and triggers a swap at the next idle boundary;
- ``"reject"``: the API edge answers 503 + Retry-After and the gateway's
  catalog tags steer the retry toward a replica already holding the
  weights.

Co-serving small models is weight co-residency: up to ``max_resident``
param sets stay live in HBM (subject to the device budget), so flipping
between them skips the host-to-card copy.  The demand
ledger (:meth:`note_demand`) doubles as the autoscaler's per-model
scale-from-zero signal and kicks spill->host prefetch while the engine
drains — restore-ahead-of-admission.

Kill switch: ``TPUSERVE_MODELPOOL=0`` (or an empty catalog) means no
pool object exists at all — runner/openai_api/gateway consult
``pool is not None`` exactly like the SLO controller, so today's
one-model behaviour is byte-identical.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
from collections import OrderedDict
from typing import Optional

logger = logging.getLogger("tpuserve_torch.modelpool")


def pool_enabled() -> bool:
    """The TPUSERVE_MODELPOOL kill switch (default on; the catalog being
    empty is the real gate — no catalog, no pool)."""
    from tpuserve_torch.utils import env_flag
    return env_flag("TPUSERVE_MODELPOOL")


def parse_catalog(spec) -> "dict[str, Optional[str]]":
    """Parse a model catalog spec into ``{name: checkpoint_dir | None}``.

    Accepts a dict (already parsed), a JSON object string
    (``{"qwen3-0.6b": "/models/qwen", "opt-125m": null}``), or a plain
    comma-separated name list (``qwen3-0.6b,opt-125m`` — all random-init
    / resolved by name).  This is the ``TPUSERVE_MODEL_CATALOG`` format
    (provision/config.py wires it through the manifests)."""
    if not spec:
        return {}
    if isinstance(spec, dict):
        return {str(k): (str(v) if v else None) for k, v in spec.items()}
    spec = spec.strip()
    if spec.startswith("{") or spec.startswith("["):
        try:
            obj = json.loads(spec)
        except ValueError as e:
            raise ValueError(f"TPUSERVE_MODEL_CATALOG is not valid JSON: "
                             f"{e}") from None
        if not isinstance(obj, dict):
            raise ValueError("TPUSERVE_MODEL_CATALOG JSON must be an "
                             "object of name -> checkpoint dir")
        return {str(k): (str(v) if v else None) for k, v in obj.items()}
    return {name.strip(): None for name in spec.split(",") if name.strip()}


@dataclasses.dataclass
class ModelPoolConfig:
    # name -> HF checkpoint dir (None = random-init / resolve by name);
    # the currently-served model is auto-registered
    catalog: dict = dataclasses.field(default_factory=dict)
    # how many param sets may stay live in HBM at once (>=1; the served
    # model always counts) — the co-serving knob
    max_resident: int = 1
    # "swap" = drain + hot-swap on demand; "reject" = 503 + Retry-After
    # (the gateway retries against a replica already holding the weights)
    swap_policy: str = "swap"
    # pinned host tier byte budget; 0 = TPUSERVE_WEIGHT_HOST_BYTES or 2 GiB
    host_bytes: int = 0
    # PVC spill directory; None = TPUSERVE_WEIGHT_SPILL_DIR (unset: no
    # spill tier — host-budget overflow drops to cold loads)
    spill_dir: Optional[str] = None
    # Retry-After seconds on swap_policy="reject" 503s
    retry_after_s: int = 5

    def validate(self) -> None:
        if self.swap_policy not in ("swap", "reject"):
            raise ValueError(f"swap_policy must be 'swap' or 'reject', "
                             f"got {self.swap_policy!r}")
        if self.max_resident < 1:
            raise ValueError("max_resident must be >= 1")


class ModelPool:
    """Catalog + residency manager for one engine.

    Thread model: routing reads (``route``/``note_demand``/``status``)
    come from HTTP handler threads; ``maybe_swap`` runs ONLY on the
    engine loop thread (the runner's idle branch).  The lock guards the
    pending/demand/resident maps; swap execution itself is single-
    threaded by construction.
    """

    def __init__(self, base_config, cfg: ModelPoolConfig):
        cfg.validate()
        from tpuserve_torch.modelpool.tiers import WeightTiers
        self.cfg = cfg
        self.base_config = base_config
        self.current: str = base_config.model
        self.catalog: dict = dict(cfg.catalog)
        self.catalog.setdefault(self.current, base_config.checkpoint_dir)
        host_bytes = cfg.host_bytes or int(
            os.environ.get("TPUSERVE_WEIGHT_HOST_BYTES", 0) or (2 << 30))
        spill = (cfg.spill_dir
                 or os.environ.get("TPUSERVE_WEIGHT_SPILL_DIR") or None)
        self.tiers = WeightTiers(host_bytes, spill_dir=spill)
        self._lock = threading.Lock()
        # co-resident param sets still live on the card (name -> tree),
        # LRU order; the CURRENT model's params live in the engine, not
        # here — so len(_resident) <= max_resident - 1
        self._resident: OrderedDict[str, object] = OrderedDict()
        self._pending: Optional[str] = None
        # demand ledger: name -> requests seen since the last drain
        # (routing parks + swaps on it; the autoscaler's per-model
        # scale-from-zero signal reads the same shape gateway-side)
        self.demand: dict[str, int] = {}
        self.swaps = 0
        self.rejects = 0

    # ---- routing --------------------------------------------------------

    def models(self) -> list[str]:
        return sorted(self.catalog)

    def is_registered(self, name: str) -> bool:
        return name in self.catalog

    def route(self, name: Optional[str]) -> str:
        """Classify a request's model name: "current" (serve it),
        "swap" (park + trigger a swap), "reject" (503 + Retry-After),
        "unknown" (404 — not in the catalog)."""
        if not name or name == self.current:
            return "current"
        if name not in self.catalog:
            return "unknown"
        return "swap" if self.cfg.swap_policy == "swap" else "reject"

    def note_demand(self, name: str) -> None:
        """Record demand for a registered model and start warming it:
        spill->host prefetch runs WHILE the engine drains toward its
        swap boundary, so the restore the swap pays is host-speed."""
        with self._lock:
            self.demand[name] = self.demand.get(name, 0) + 1
        if name != self.current and name not in self._resident:
            self.tiers.prefetch(name)

    def request_swap(self, name: str) -> bool:
        """Target the pool at ``name`` (idempotent).  The swap executes
        on the engine loop thread at the next idle boundary."""
        if name not in self.catalog:
            return False
        with self._lock:
            if name != self.current:
                self._pending = name
        return True

    @property
    def pending(self) -> Optional[str]:
        return self._pending

    # ---- swap execution (engine loop thread only) -----------------------

    def build_config(self, name: str):
        """EngineConfig for a catalog entry: the base config with the
        model identity swapped in.  Adapter config never carries over —
        LoRA banks are model-specific."""
        return dataclasses.replace(
            self.base_config, model=name,
            checkpoint_dir=self.catalog.get(name),
            lora_dir=None, lora_modules=None)

    def maybe_swap(self, engine) -> Optional[str]:
        """Execute the pending swap if the engine is idle.  Called from
        the engine loop's idle branch (server/runner.py), so the drain-
        to-window-boundary precondition holds by construction.  Returns
        the source-tier outcome ("resident"/"host"/"spill"/"cold") when
        a swap ran, else None."""
        with self._lock:
            target = self._pending
        if target is None or target == self.current:
            with self._lock:
                self._pending = None
            return None
        if engine.has_work():
            return None
        outcome = self._swap_to(engine, target)
        with self._lock:
            if self._pending == target:
                self._pending = None
            self.demand.pop(target, None)
        return outcome

    def _swap_to(self, engine, target: str) -> str:
        params = None
        with self._lock:
            resident = self._resident.pop(target, None)
        if resident is not None:
            params, outcome = resident, "resident"
        else:
            got = self.tiers.take(target)
            if got is not None:
                # the host tree: swap_model moves it to the card once the
                # outgoing engine's state is released
                params, outcome = got
            else:
                outcome = "cold"        # checkpoint load / random init
        old_model, old_params = engine.swap_model(
            self.build_config(target), params=params, source_tier=outcome)
        self.current = target
        self.swaps += 1
        self._retire(old_model, old_params)
        del old_params
        if engine.device.type == "cuda":
            # the demoted weights' blocks back to the card, so its memory
            # reads as this model's alone
            import gc
            import torch
            gc.collect()
            torch.cuda.empty_cache()
        # co-resident sets count in the device profiler's HBM watermark
        engine.note_hbm(coresident_bytes=self.resident_nbytes())
        return outcome

    def _retire(self, name: str, params) -> None:
        """Keep the outgoing weights as warm as budgets allow: HBM
        co-residency first (max_resident), then the host/spill tiers."""
        if params is None:
            return
        with self._lock:
            keep_hot = len(self._resident) < self.cfg.max_resident - 1
            if keep_hot:
                self._resident[name] = params
        if not keep_hot:
            self.tiers.put(name, params)

    def resident_nbytes(self) -> int:
        """Bytes of co-resident (non-serving) param sets still in HBM —
        the pool's share of the tpuserve_weight_tier_bytes{tier="hbm"}
        gauge (the runner adds the engine's own params)."""
        from tpuserve_torch.models.weights import param_nbytes
        with self._lock:
            return sum(param_nbytes(p) for p in self._resident.values())

    # ---- surfaces -------------------------------------------------------

    def tier_of(self, name: str) -> str:
        """Warmth tag for one catalog entry: "serving" (the live model),
        "resident" (HBM co-resident), "host"/"spill" (tiered), "cold"."""
        if name == self.current:
            return "serving"
        with self._lock:
            if name in self._resident:
                return "resident"
        return self.tiers.where(name) or "cold"

    def catalog_status(self) -> list[dict]:
        """The /healthz ``models`` payload: every registered model with
        its warmth tag — what the gateway's catalog routing keys on."""
        return [{"name": n, "tier": self.tier_of(n)} for n in self.models()]

    def status(self) -> dict:
        """The /debug/engine ``modelpool`` block."""
        with self._lock:
            demand = dict(self.demand)
            pending = self._pending
        t = self.tiers
        return {
            "current": self.current,
            "catalog": self.catalog_status(),
            "max_resident": self.cfg.max_resident,
            "swap_policy": self.cfg.swap_policy,
            "pending_swap": pending,
            "demand": demand,
            "swaps": self.swaps,
            "rejects": self.rejects,
            "weight_tier_bytes": t.bytes_by_tier(),
            "spilled_models": t.spilled_models,
            "dropped_models": t.dropped_models,
            "prefetched_models": t.prefetched_models,
        }
