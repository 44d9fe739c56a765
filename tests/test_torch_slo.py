"""SLO classes and the brownout ladder in the port, on the CPU, against the
JAX package (the repair of ROADMAP.md F3: the port accepted ``slo_class``
and then ran classless FIFO).

- The port's ``SloController`` and the JAX one, fed the same seeded event
  sequences (admissions, steps, ticks at explicit times), give the same
  levels, pressures (atol 1e-12), caps, Retry-After values, spec pauses
  and snapshots.
- The scheduler's class policy (ordering, the preempted-stream barrier,
  class victims, the budget reserve, one class a prefill batch) on both
  packages' schedulers.
- tests/test_slo.py's engine cases on the port's engine and the JAX
  engine, classes on (their default), on float32 tiny-qwen3 with the same
  weights, the same event script under a ``VirtualClock``: terminal
  outcomes, tokens, ``requests_shed``, ``slo_preemptions``, the order in
  which requests finish and the brownout level after every step must be
  equal; an overload burst walks the ladder up to shedding batch and back
  down.  ``TPUSERVE_SLO_CLASSES=0`` / ``slo_classes=False`` /
  ``--no-slo-classes`` restore classless FIFO.
- Through the runner: an interactive arrival preempts a batch stream,
  which resumes token-identically; a seeded overload soak in which every
  request reaches exactly one terminal state.
- Over HTTP, on the port's server and the JAX server: ``slo_class`` and
  ``X-SLO-Class`` validated alike, a shed answered 429 with the same
  Retry-After, and the metric families.
"""

import dataclasses
import json
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve.runtime import block_manager as jax_bm
from tpuserve.runtime import clock as jax_clock
from tpuserve.runtime import request as jax_req
from tpuserve.runtime import scheduler as jax_sched
from tpuserve.runtime import slo as jax_slo
from tpuserve_torch import runtime as port_rt
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime import block_manager as port_bm
from tpuserve_torch.runtime import clock as port_clock
from tpuserve_torch.runtime import request as port_req
from tpuserve_torch.runtime import scheduler as port_sched
from tpuserve_torch.runtime import slo as port_slo
from tpuserve_torch.runtime.slo import ShedError, SloConfig, SloController
from tpuserve_torch.server.runner import AsyncEngineRunner

PACKAGES = {"port": (port_rt, port_slo, port_sched, port_bm, port_req, port_clock),
            "jax": (jax_rt, jax_slo, jax_sched, jax_bm, jax_req, jax_clock)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _strict_blocks(monkeypatch):
    """Class preemption, deadline aborts and queue eviction all free KV:
    the block cross-check runs every cycle."""
    monkeypatch.setenv("TPUSERVE_STRICT_BLOCKS", "1")
    monkeypatch.delenv("TPUSERVE_SLO_CLASSES", raising=False)


@pytest.fixture(scope="module")
def model(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


# ---------------------------------------------------------------------------
# the controller, against the JAX controller
# ---------------------------------------------------------------------------

def _reqs(mod, classes):
    return [mod.Request(request_id=f"r{i}", prompt_token_ids=[1, 2],
                        params=mod.SamplingParams(slo_class=c))
            for i, c in enumerate(classes)]


def _controller_trace(pkg: str, seed: int) -> list:
    """A seeded sequence of admissions, steps and ticks on one package's
    controller; every observable after each event."""
    _, slo, _, _, req_mod, clock_mod = PACKAGES[pkg]
    rng = np.random.default_rng(seed)
    cfg = slo.SloConfig(hold_s=float(rng.choice([0.0, 0.5, 3.0])),
                        ewma_alpha=float(rng.choice([0.2, 0.5])),
                        shed_min_queue_frac=float(rng.choice([0.0, 0.125])))
    clock = clock_mod.VirtualClock(100.0)
    ctl = slo.SloController(cfg, max_waiting=int(rng.integers(4, 40)), clock=clock)
    probe = _reqs(req_mod, ["interactive", "standard", "batch"])
    out = []
    for _ in range(120):
        ev = rng.integers(0, 4)
        if ev == 0:
            ctl.note_admission(int(rng.integers(0, 3)), float(rng.exponential(1.5)))
        elif ev == 1:
            padded = int(rng.integers(1, 512))
            ctl.note_step(int(rng.integers(0, padded + 1)), padded)
        elif ev == 2:
            clock.advance(float(rng.exponential(1.0)))
            ctl.tick(int(rng.integers(0, 2 * ctl.max_waiting)))
        else:
            ctl.tick(int(rng.integers(0, ctl.max_waiting)), now=clock.advance(0.25))
        out.append((ctl.level, ctl.pressure(), ctl.snapshot(),
                    [ctl.shed_retry_after(r) for r in range(3)],
                    [ctl.max_tokens_cap(r) for r in range(3)],
                    [ctl.spec_paused_for([p]) for p in probe],
                    ctl.shed_total, len(ctl.delay_obs)))
    out.append(ctl.drain_delay_obs())
    return out


@pytest.mark.parametrize("seed", range(8))
def test_controller_matches_jax_over_seeded_events(seed):
    ours, ref = _controller_trace("port", seed), _controller_trace("jax", seed)
    assert len(ours) == len(ref)
    levels = set()
    for a, b in zip(ours[:-1], ref[:-1]):
        assert abs(a[1] - b[1]) <= 1e-12
        assert a[:1] + a[2:] == b[:1] + b[2:]
        levels.add(a[0])
    assert ours[-1] == ref[-1]
    assert len(levels) > 1                       # the ladder moved


def test_slo_config_defaults_match_jax():
    assert dataclasses.asdict(SloConfig()) == dataclasses.asdict(jax_slo.SloConfig())
    assert port_slo.SLO_CLASSES == jax_slo.SLO_CLASSES
    assert (port_slo.INTERACTIVE, port_slo.STANDARD, port_slo.BATCH) == (0, 1, 2)


def test_class_rank_validates():
    for mod in (port_slo, jax_slo):
        assert [mod.class_rank(c) for c in ("interactive", "standard", "batch")] == [0, 1, 2]
        with pytest.raises(ValueError):
            mod.class_rank("turbo")


def test_brownout_enters_immediately_and_exits_hysteretically():
    cfg = SloConfig(enter_levels=(0.5, 0.75, 0.9, 1.2), exit_margin=0.15, hold_s=10.0)
    ctl = SloController(cfg, max_waiting=10)
    t = 1000.0
    ctl.tick(waiting=0, now=t)
    assert ctl.level == 0
    ctl.tick(waiting=10, now=t + 1)       # pressure 1.0 >= 0.9: straight to 3
    assert ctl.level == 3
    ctl.tick(waiting=0, now=t + 2)        # under the exit threshold, inside hold
    assert ctl.level == 3
    ctl.tick(waiting=0, now=t + 13)       # one level a hold period
    assert ctl.level == 2
    ctl.tick(waiting=0, now=t + 14)
    assert ctl.level == 2
    ctl.tick(waiting=0, now=t + 24)
    assert ctl.level == 1


def test_brownout_policy_by_level():
    ctl = SloController(SloConfig(), max_waiting=10)
    ctl._waiting = 10
    ctl.level = 1
    assert ctl.shed_retry_after(port_slo.BATCH) is None
    assert ctl.max_tokens_cap(port_slo.BATCH) is None
    ctl.level = 2
    assert ctl.max_tokens_cap(port_slo.BATCH) == SloConfig().batch_max_tokens_cap
    assert ctl.max_tokens_cap(port_slo.INTERACTIVE) is None
    ctl.level = 3
    assert ctl.shed_retry_after(port_slo.BATCH) is not None
    assert ctl.shed_retry_after(port_slo.STANDARD) is None
    ctl.level = 4
    assert ctl.shed_retry_after(port_slo.STANDARD) is not None
    assert ctl.shed_retry_after(port_slo.INTERACTIVE) is None
    # every degradation bites only with a real queue
    ctl._waiting = 0
    assert ctl.shed_retry_after(port_slo.BATCH) is None
    assert ctl.max_tokens_cap(port_slo.BATCH) is None


def test_spec_pause_is_ported_with_no_consumer_yet():
    """Level 1's speculation pause (its consumer, the engine's spec gate,
    is held in tests/test_torch_spec.py)."""
    ctl = SloController(SloConfig(), max_waiting=10)
    ctl._waiting, ctl.level = 10, 1
    batch, std = _reqs(port_req, ["batch", "standard"])
    assert ctl.spec_paused_for([std, batch]) and not ctl.spec_paused_for([std])
    ctl._waiting = 0
    assert not ctl.spec_paused_for([batch])


def test_empty_queue_decays_delay_ewma():
    ctl = SloController(SloConfig(hold_s=0.0, exit_margin=0.1, ewma_alpha=0.5), max_waiting=10)
    ctl.note_admission(1, 30.0)
    ctl.tick(waiting=1, now=100.0)
    assert ctl.level == 4
    t = 101.0
    while ctl.level and t < 200.0:
        ctl.tick(waiting=0, now=t)
        t += 1.0
    assert ctl.level == 0


def test_padding_waste_inflates_pressure():
    ctl = SloController(SloConfig(ewma_alpha=1.0), max_waiting=10)
    ctl._waiting = 5
    base = ctl.pressure()
    ctl.note_step(actual=25, padded=100)
    assert ctl.pressure() > base


# ---------------------------------------------------------------------------
# the scheduler's class policy, on both packages
# ---------------------------------------------------------------------------

def _mk_sched(pkg, slo_on=True, **kw):
    _, slo, sched, bm_mod, _, _ = PACKAGES[pkg]
    cfg = sched.SchedulerConfig(**{**dict(max_num_seqs=4, max_prefill_tokens=64,
                                          max_prefill_seqs=4, min_prefill_bucket=8,
                                          min_decode_bucket=2), **kw})
    bm = bm_mod.BlockManager(num_blocks=64, block_size=4)
    s = sched.Scheduler(cfg, bm, max_model_len=256,
                        ragged_align=kw.get("mixed_batching") and 8 or 1)
    s.slo = slo.SloController(slo.SloConfig(), max_waiting=16) if slo_on else None
    return s, bm


def _sreq(pkg, rid, cls, n=8, out=0):
    mod = PACKAGES[pkg][4]
    r = mod.Request(request_id=rid, prompt_token_ids=list(range(1, n + 1)),
                    params=mod.SamplingParams(max_tokens=8, temperature=0.0,
                                              ignore_eos=True, slo_class=cls))
    r.output_token_ids = list(range(out))
    return r


def _policy(pkg) -> dict:
    state = PACKAGES[pkg][4].RequestState
    out = {}
    s, _ = _mk_sched(pkg)
    for rid, cls in (("b", "batch"), ("s", "standard"), ("i", "interactive")):
        s.add(_sreq(pkg, rid, cls))
    out["ordered"] = [r.request_id for r in s.waiting]
    s, _ = _mk_sched(pkg, slo_on=False)
    for rid, cls in (("b", "batch"), ("s", "standard"), ("i", "interactive")):
        s.add(_sreq(pkg, rid, cls))
    out["fifo"] = [r.request_id for r in s.waiting]
    s, _ = _mk_sched(pkg)
    victim = _sreq(pkg, "victim", "batch", out=3)
    victim.state = state.PREEMPTED
    s.waiting.append(victim)
    s.add(_sreq(pkg, "i", "interactive"))
    s.add(_sreq(pkg, "b2", "batch"))
    out["barrier"] = [r.request_id for r in s.waiting]
    s, _ = _mk_sched(pkg)
    s.add(_sreq(pkg, "i", "interactive"))
    s.add(_sreq(pkg, "b_fresh", "batch"))
    victim = _sreq(pkg, "victim", "batch", out=2)
    victim.state = state.PREEMPTED
    s.reinsert_preempted(victim)
    out["reinsert"] = [r.request_id for r in s.waiting]
    for slo_on in (True, False):
        s, bm = _mk_sched(pkg, slo_on=slo_on)
        for rid, cls in (("i", "interactive"), ("b", "batch"), ("s", "standard")):
            r = _sreq(pkg, rid, cls)
            bm.allocate(r.request_id, r.prompt_token_ids)
            s.running.append(r)
        out[f"victim_{slo_on}"] = s.preempt_last().request_id
    for cls in ("batch", "interactive"):
        s, _ = _mk_sched(pkg, mixed_batching=True, mixed_token_budget=64)
        s.add(_sreq(pkg, cls[0], cls, n=64))
        batch = s.schedule()
        out[f"mixed_{cls}"] = (batch.kind, batch.prefill_chunks[0][1])
    s, _ = _mk_sched(pkg)
    for rid, cls in (("i1", "interactive"), ("i2", "interactive"), ("b1", "batch")):
        s.add(_sreq(pkg, rid, cls, n=5))
    batch = s.schedule()
    out["one_class"] = (batch.kind, sorted(r.request_id for r in batch.requests))
    return out


def test_scheduler_class_policy_matches_jax():
    ours = _policy("port")
    assert ours == _policy("jax")
    assert ours["ordered"] == ["i", "s", "b"] and ours["fifo"] == ["b", "s", "i"]
    assert ours["barrier"] == ["i", "victim", "b2"]
    assert ours["reinsert"] == ["i", "victim", "b_fresh"]
    assert ours["victim_True"] == "b" and ours["victim_False"] == "s"
    assert ours["mixed_batch"] == ("mixed", 48) and ours["mixed_interactive"] == ("mixed", 64)
    assert ours["one_class"] == ("prefill", ["i1", "i2"])


# ---------------------------------------------------------------------------
# the engine, against the JAX engine, under a VirtualClock
# ---------------------------------------------------------------------------

PROMPT = [7, 11, 13, 17, 19]
CACHE = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16, dtype="float32")
DT = 0.05                     # virtual seconds a step


def _engine(pkg, model, slo=None, **sched_kw):
    rt, _, _, _, _, clock_mod = PACKAGES[pkg]
    jcfg, jparams, cfg, params = model
    sched = {**dict(max_num_seqs=4, min_prefill_bucket=8, min_decode_bucket=2), **sched_kw}
    conf = rt.EngineConfig(model="tiny-qwen3", cache=rt.CacheConfig(**CACHE),
                           scheduler=rt.SchedulerConfig(**sched), attn_impl="reference",
                           multi_step=1, slo=slo, seed=0, clock=clock_mod.VirtualClock(50.0))
    if pkg == "jax":
        return jax_rt.Engine(conf, params=jparams, model_cfg=jcfg)
    return port_rt.Engine(conf, params=params, model_cfg=cfg, device="cpu")


class _Script:
    """One event script's bookkeeping on one package's engine: terminal
    outcomes, the order requests finish in, and the level after each
    step."""

    def __init__(self, pkg, eng):
        self.pkg, self.eng = pkg, eng
        self.rt = PACKAGES[pkg][0]
        self.finished, self.errors, self.levels = [], {}, []

    def params(self, cls, n=8, **kw):
        return self.rt.SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True,
                                      slo_class=cls, **kw)

    def add(self, rid, cls, n=8, prompt=PROMPT, **kw):
        try:
            self.eng.add_request(prompt_token_ids=prompt, params=self.params(cls, n),
                                 request_id=rid, **kw)
        except (MemoryError, PACKAGES[self.pkg][1].ShedError) as e:
            self.errors[rid] = (type(e).__name__, getattr(e, "retry_after_s", None))

    def step(self):
        self.eng.clock.advance(DT)
        for out in self.eng.step():
            if out.finished:
                self.finished.append(out.request_id)
        for rid, exc in self.eng.drain_request_errors():
            self.errors[rid] = (type(exc).__name__, getattr(exc, "retry_after_s", None))
        self.levels.append(self.eng.stats.brownout_level)

    def until(self, cond, limit=500):
        for _ in range(limit):
            if cond():
                return
            self.step()
        raise AssertionError("condition never held")

    def drain(self):
        while self.eng.has_work():
            self.step()

    def result(self) -> dict:
        eng = self.eng
        toks = {rid: r.output_token_ids for rid, r in eng.requests.items()}
        caps = {rid: r.params.max_tokens for rid, r in eng.requests.items()}
        assert eng.block_manager.num_seqs() == 0
        return {"finished": self.finished, "errors": self.errors, "tokens": toks,
                "max_tokens": caps, "levels": self.levels,
                "shed": eng.stats.requests_shed, "slo_preemptions": eng.stats.slo_preemptions,
                "preemptions": eng.stats.preemptions, "prompt_tokens": eng.stats.prompt_tokens}


def _has_tokens(sc, rid):
    return lambda: bool(sc.eng.requests[rid].output_token_ids)


def _case(pkg, model, name) -> dict:
    slo_mod = PACKAGES[pkg][1]
    if name == "preempt":
        # an interactive arrival preempts a running batch stream, which
        # replays token-identically and finishes after it
        sc = _Script(pkg, _engine(pkg, model, max_num_seqs=1))
        sc.add("victim", "batch", 16)
        sc.until(_has_tokens(sc, "victim"))
        sc.add("vip", "interactive", 4, prompt=[3, 5, 2])
        sc.drain()
    elif name == "budget":
        # preempt_budget=1 bounds the batch stream's preemptions
        sc = _Script(pkg, _engine(pkg, model, slo=slo_mod.SloConfig(preempt_budget=1),
                                  max_num_seqs=1))
        sc.add("victim", "batch", 24)
        sc.until(_has_tokens(sc, "victim"))
        for i in range(3):
            sc.add(f"vip-{i}", "interactive", 3, prompt=[3 + i, 5, 2])
            sc.step()
        sc.drain()
    elif name == "deadline":
        # a queued request past its deadline leaves without prefill
        sc = _Script(pkg, _engine(pkg, model, max_num_seqs=1))
        sc.add("hog", "batch", 32)
        sc.until(_has_tokens(sc, "hog"))
        sc.add("late", "batch", 4, prompt=[2, 4, 6], deadline=sc.eng.clock.monotonic())
        sc.drain()
    elif name == "queue_full":
        # a full queue sheds its tail batch request for an interactive one
        sc = _Script(pkg, _engine(pkg, model, max_num_seqs=1, max_waiting=2))
        sc.add("hog", "batch", 32)
        sc.until(_has_tokens(sc, "hog"))
        sc.add("bw-0", "batch", 2, prompt=[2, 3, 4])
        sc.add("bw-1", "batch", 2, prompt=[3, 4, 5])
        sc.add("vip", "interactive", 2, prompt=[5, 6, 7])      # evicts bw-1
        sc.add("std", "standard", 2, prompt=[6, 7, 8])         # evicts bw-0
        sc.add("std2", "standard", 2, prompt=[7, 8, 9])        # nothing looser: 503
        sc.drain()
    elif name in ("shed", "cap"):
        # the ladder pinned at 3 (shed batch) or 2 (cap batch max_tokens)
        sc = _Script(pkg, _engine(pkg, model, slo=slo_mod.SloConfig(
            shed_min_queue_frac=0.0, batch_max_tokens_cap=5)))
        sc.eng._slo.level = 3 if name == "shed" else 2
        sc.eng._slo._level_changed = sc.eng.clock.monotonic() + 3600
        sc.add("b", "batch", 64)
        sc.add("i", "interactive", 6)
        sc.add("s", "standard", 6)
        sc.drain()
    elif name == "overload":
        # a burst fills the queue: the ladder climbs to shedding batch on
        # the queue term alone, a stricter arrival evicts batch work, and
        # the level steps down one hold at a time once the queue drains
        sc = _Script(pkg, _engine(pkg, model, max_num_seqs=2, max_waiting=8))
        for i in range(8):
            sc.add(f"b-{i}", "batch", 6, prompt=[10 + i, 11, 12, 13])
        sc.step()
        sc.add("b-late", "batch", 6, prompt=[30, 31, 32])
        sc.add("s-0", "standard", 6, prompt=[40, 41, 42])
        sc.add("i-0", "interactive", 6, prompt=[50, 51, 52])
        sc.drain()
        for _ in range(int(4 * 3.0 / DT) + 10):     # idle ticks of the holds
            sc.step()
    else:
        raise ValueError(name)
    return sc.result()


CASES = ["preempt", "budget", "deadline", "queue_full", "shed", "cap", "overload"]


@pytest.mark.parametrize("name", CASES)
def test_engine_slo_case_matches_jax_engine(name, model):
    ours = _case("port", model, name)
    ref = _case("jax", model, name)
    assert ours == ref
    fin, err, st = ours["finished"], ours["errors"], ours
    if name == "preempt":
        assert fin == ["vip", "victim"] and st["slo_preemptions"] >= 1
        assert len(ours["tokens"]["victim"]) == 16
    elif name == "budget":
        assert st["slo_preemptions"] <= 1 and len(ours["tokens"]["victim"]) == 24
    elif name == "deadline":
        assert err == {"late": ("TimeoutError", None)} and ours["tokens"]["late"] == []
        assert "late" not in fin
    elif name == "queue_full":
        assert [err[r][0] for r in ("bw-1", "bw-0", "std2")] == [
            "ShedError", "ShedError", "MemoryError"]
        assert err["bw-1"][1] > 0 and st["shed"] == 2
        assert {"vip", "std", "hog"} <= set(fin)
    elif name == "shed":
        assert err == {"b": ("ShedError", 6.0)} and st["shed"] == 1
    elif name == "cap":
        assert ours["max_tokens"] == {"b": 5, "i": 6, "s": 6} and not err
    elif name == "overload":
        assert max(ours["levels"]) >= 3 and ours["levels"][-1] == 0
        assert err["b-late"][0] == "ShedError"
        assert fin[:2] == ["i-0", "s-0"] and st["shed"] == 1      # classes first
        assert sorted(set(ours["levels"])) == [0, 1, 2, 3]           # down one a hold


def test_default_engine_runs_classes_and_the_kill_switch_restores_fifo(model, monkeypatch):
    """F3: a default port engine runs the controller, as the JAX engine;
    TPUSERVE_SLO_CLASSES=0 or slo_classes=False leave it out."""
    from tpuserve_torch.server.openai_api import build_parser, engine_config
    assert _engine("port", model)._slo is not None
    assert engine_config(build_parser().parse_args([])).slo_classes is None
    assert engine_config(build_parser().parse_args(["--no-slo-classes"])).slo_classes is False
    monkeypatch.setenv("TPUSERVE_SLO_CLASSES", "0")
    eng = _engine("port", model)
    assert eng._slo is None and eng.scheduler.slo is None
    monkeypatch.delenv("TPUSERVE_SLO_CLASSES")
    _, _, cfg, params = model
    eng = port_rt.Engine(port_rt.EngineConfig(model="tiny-qwen3", slo_classes=False,
                                              cache=port_rt.CacheConfig(**CACHE)),
                         params=params, model_cfg=cfg, device="cpu")
    assert eng._slo is None


def test_classless_engine_keeps_fifo_like_jax(model, monkeypatch):
    """With classes off both engines serve the same script in arrival
    order: no class preemption, no shed."""
    monkeypatch.setenv("TPUSERVE_SLO_CLASSES", "0")
    ours = _case("port", model, "preempt")
    assert ours == _case("jax", model, "preempt")
    assert ours["finished"] == ["victim", "vip"] and ours["slo_preemptions"] == 0


# ---------------------------------------------------------------------------
# through the runner
# ---------------------------------------------------------------------------

def _drain(q, timeout=120):
    toks, errs = [], []
    deadline = time.monotonic() + timeout
    while True:
        item = q.get(timeout=max(deadline - time.monotonic(), 0.001))
        if item is None:
            return toks, errs
        if isinstance(item, Exception):
            errs.append(item)
            continue
        toks.extend(item.new_token_ids)


def _runner_engine(model, **sched_kw):
    _, _, cfg, params = model
    sched = {**dict(max_num_seqs=4, min_prefill_bucket=8, min_decode_bucket=2), **sched_kw}
    return port_rt.Engine(port_rt.EngineConfig(
        model="tiny-qwen3", cache=port_rt.CacheConfig(**CACHE),
        scheduler=port_rt.SchedulerConfig(**sched), seed=0), params=params, model_cfg=cfg,
        device="cpu")


def test_runner_interactive_preempts_batch_token_identical(model):
    ref = _case("jax", model, "preempt")["tokens"]["victim"]
    eng = _runner_engine(model, max_num_seqs=1)
    runner = AsyncEngineRunner(eng)
    runner.start()
    sp = lambda cls, n: port_rt.SamplingParams(max_tokens=n, temperature=0.0,  # noqa: E731
                                               ignore_eos=True, slo_class=cls)
    _, bq = runner.submit(prompt_token_ids=PROMPT, params=sp("batch", 16), request_id="victim")
    deadline = time.monotonic() + 30
    while not eng.requests["victim"].output_token_ids:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    _, iq = runner.submit(prompt_token_ids=[3, 5, 2], params=sp("interactive", 4),
                          request_id="vip")
    i_toks, i_errs = _drain(iq)
    b_toks, b_errs = _drain(bq)
    victim, vip = eng.requests.pop("victim"), eng.requests.pop("vip")
    runner.shutdown()
    assert not i_errs and not b_errs and len(i_toks) == 4
    assert b_toks == ref
    assert eng.stats.slo_preemptions >= 1 and vip.finish_time < victim.finish_time
    assert eng.block_manager.num_seqs() == 0


def test_overload_soak_every_request_reaches_one_terminal_state(model):
    """A seeded overload through the runner, short queue and deadlines:
    every request ends in exactly one of completed, shed (429 / 503) or
    expired in the queue, and no KV leaks."""
    rng = np.random.default_rng(23)
    eng = _runner_engine(model, max_num_seqs=4, max_waiting=6)
    eng._slo.cfg = SloConfig(target_queue_delay_s=0.05, hold_s=0.5)
    runner = AsyncEngineRunner(eng)
    runner.start()
    classes = ("interactive", "standard", "batch")
    subs = []
    for i in range(48):
        cls = classes[int(rng.integers(0, 3))]
        sp = port_rt.SamplingParams(max_tokens=int(rng.integers(2, 12)), temperature=0.0,
                                    ignore_eos=True, slo_class=cls)
        subs.append((cls, runner.submit(
            prompt_token_ids=[int(x) for x in rng.integers(1, 500, size=4)], params=sp,
            request_id=f"soak-{i}", deadline=time.monotonic() + 3.0)))
        time.sleep(float(rng.exponential(0.003)))
    completed = shed = expired = 0
    for cls, (rid, q) in subs:
        toks, errs = _drain(q, timeout=240)
        assert len(errs) <= 1, (rid, errs)
        if errs:
            assert isinstance(errs[0], (ShedError, MemoryError, TimeoutError)), errs
            if isinstance(errs[0], TimeoutError):
                expired += 1
            else:
                shed += 1
        else:
            assert toks, f"{rid} finished with no tokens and no error"
            completed += 1
        eng.requests.pop(rid, None)
    runner.shutdown()
    assert completed + shed + expired == len(subs) and completed > 0
    assert shed + expired > 0
    assert eng.block_manager.num_seqs() == 0 and eng.scheduler.num_waiting == 0


# ---------------------------------------------------------------------------
# over HTTP, against the JAX server
# ---------------------------------------------------------------------------

def _servers(model, slo):
    from tpuserve.server.openai_api import OpenAIServer as JaxServer
    from tpuserve.server.openai_api import ServerConfig as JaxServerConfig
    from tpuserve_torch.server import OpenAIServer, ServerConfig
    port = OpenAIServer(_engine("port", model, slo=slo),
                        ServerConfig(host="127.0.0.1", port=0))
    jsrv = JaxServer(_engine("jax", model, slo=slo),
                     JaxServerConfig(host="127.0.0.1", port=0, tpu_metrics=False,
                                     slo_burn=False))
    return {"port": (port, f"http://127.0.0.1:{port.start(warmup=False)}"),
            "jax": (jsrv, f"http://127.0.0.1:{jsrv.start(warmup=False)}")}


def _post(url, payload, headers=None):
    """(status, body, headers); never raises on 4xx/5xx."""
    req = urllib.request.Request(url + "/v1/completions", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null"), dict(e.headers)


def test_http_slo_class_header_body_and_shed_like_jax(model):
    srvs = _servers(model, SloConfig(shed_min_queue_frac=0.0))
    try:
        got = {}
        for k, (srv, url) in srvs.items():
            out = []
            out.append(_post(url, {"prompt": "x", "max_tokens": 1,
                                   "slo_class": "turbo"})[0])
            out.append(_post(url, {"prompt": "x", "max_tokens": 1},
                             headers={"X-SLO-Class": "turbo"})[0])
            srv.engine._slo.level = 3
            srv.engine._slo._level_changed = srv.engine.clock.monotonic() + 3600
            for stream in (False, True):
                for headers, extra in (({"X-SLO-Class": "batch"}, {}),
                                       (None, {"slo_class": "batch"})):
                    status, body, hdrs = _post(url, {"prompt": "x", "max_tokens": 1,
                                                     "temperature": 0, "stream": stream,
                                                     **extra}, headers=headers)
                    out.append((status, hdrs.get("Retry-After"), body["error"]["type"]))
            status, body, _ = _post(url, {"prompt": "x", "max_tokens": 2, "temperature": 0,
                                          "ignore_eos": True, "slo_class": "interactive"})
            out.append((status, body["usage"]["completion_tokens"]))
            out.append(srv.engine.stats.requests_shed)
            got[k] = out
        assert got["port"] == got["jax"]
        assert got["port"][:2] == [400, 400]
        assert got["port"][2] == (429, "7", "overloaded")
        assert got["port"][-2:] == [(200, 2), 4]
    finally:
        for srv, _ in srvs.values():
            srv.shutdown()


def test_http_queue_delay_and_brownout_metrics_present(model):
    srvs = _servers(model, None)
    try:
        for k, (srv, url) in srvs.items():
            assert _post(url, {"prompt": "x", "max_tokens": 2, "temperature": 0,
                               "ignore_eos": True})[0] == 200
            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                metrics = r.read().decode()
            for fam in ("tpuserve_brownout_level", "tpuserve_queue_delay_seconds",
                        'slo_class="standard"', "tpuserve_requests_shed_total",
                        "tpuserve_requests_preempted_total", "tpuserve_ttft_seconds",
                        "tpuserve_itl_seconds", "tpuserve_requests_salvaged_total",
                        "tpuserve_requests_poisoned_total",
                        "tpuserve_engine_watchdog_trips_total",
                        "tpuserve_engine_restarts_total"):
                assert fam in metrics, (k, fam)
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                assert json.loads(r.read())["brownout_level"] == 0
    finally:
        for srv, _ in srvs.values():
            srv.shutdown()
