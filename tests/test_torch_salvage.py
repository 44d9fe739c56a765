"""Crash-only salvage, poison bisection, the hang watchdog and fault
injection in the port, on the CPU, against the JAX package.

The cases of tests/test_faults.py, test_salvage.py, test_watchdog.py and
test_runner_fault.py run on the port's injector, engine and runner with
``TPUSERVE_STRICT_BLOCKS=1`` (block and tier accounting checked every
successful cycle): a poison request fails alone, a transient fault or a
released hang fails no one, and the survivors' greedy tokens equal a
fault-free port run and the JAX engine's on the same float32 tiny-qwen3
weights.  The injector itself is held against the JAX one: the same spec
parses to the same rules and the same seed fires the same sequence.

Cases on the port's own state: a fault while a pipelined window is in
flight, with a guided (json_object) row and a repetition-penalty row among
the survivors; a fault inside a chunked re-prefill; and a fault while a
tier restore is in flight, whose request is re-queued once.
"""

import dataclasses
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve.runtime import faults as jax_faults
from tpuserve_torch import runtime as port_rt
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime import faults as port_faults
from tpuserve_torch.runtime.faults import FaultInjector, FaultRule, InjectedFault
from tpuserve_torch.runtime.guided import JsonStateMachine
from tpuserve_torch.runtime.request import RequestState
from tpuserve_torch.server.runner import AsyncEngineRunner


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
    """Every recovery path runs with the block and tier cross-check armed:
    a leak or a double free fails the cycle it happens in."""
    monkeypatch.setenv("TPUSERVE_STRICT_BLOCKS", "1")
    monkeypatch.delenv("TPUSERVE_FAULTS", raising=False)


CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16, dtype="float32")
SCHED = dict(max_num_seqs=8, min_prefill_bucket=8, min_decode_bucket=2)
GREEDY = dict(max_tokens=10, temperature=0.0, ignore_eos=True)
PROMPTS = [[5, 6, 7], [9, 10, 11], [12, 13, 14], [20, 21, 22]]


@pytest.fixture(scope="module")
def model(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _port(model, faults=None, cache=CACHE, sched=None, **kw):
    _, _, cfg, params = model
    kw.setdefault("multi_step", 4)
    kw.setdefault("pipeline_decode", True)
    conf = port_rt.EngineConfig(model="tiny-qwen3", cache=port_rt.CacheConfig(**cache),
                                scheduler=port_rt.SchedulerConfig(**(sched or SCHED)),
                                faults=faults, seed=0, **kw)
    return port_rt.Engine(conf, params=params, model_cfg=cfg, device="cpu")


def _jax_tokens(model, prompts, params_list, cache=CACHE, sched=None, **kw):
    """The JAX engine's token streams (its defaults, classes and tiers on)."""
    jcfg, jparams, _, _ = model
    conf = jax_rt.EngineConfig(model="tiny-qwen3", cache=jax_rt.CacheConfig(**cache),
                               scheduler=jax_rt.SchedulerConfig(**(sched or SCHED)),
                               attn_impl="reference", multi_step=1, seed=0, **kw)
    eng = jax_rt.Engine(conf, params=jparams, model_cfg=jcfg)
    return [r.output_token_ids
            for r in eng.generate(prompts, [jax_rt.SamplingParams(**p) for p in params_list])]


def _runner(eng):
    r = AsyncEngineRunner(eng)
    r.start()
    return r


def _run_all(runner, submits, timeout=120):
    """Drain every submit: ({rid: tokens}, {rid: error})."""
    tokens, errors = {}, {}
    deadline = time.monotonic() + timeout
    for rid, q in submits:
        toks = []
        while True:
            item = q.get(timeout=max(deadline - time.monotonic(), 0.001))
            if item is None:
                break
            if isinstance(item, Exception):
                errors[rid] = item
                continue
            toks.extend(item.new_token_ids)
        tokens[rid] = toks
        runner.engine.requests.pop(rid, None)
    return tokens, errors


def _submit(runner, prompts=PROMPTS, params=None, prefix="req"):
    sp = port_rt.SamplingParams(**(params or GREEDY))
    return [runner.submit(prompt_token_ids=p, params=sp, request_id=f"{prefix}-{i}")
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def reference(model):
    """Fault-free greedy tokens of PROMPTS on the port's runner, which must
    equal the JAX engine's."""
    runner = _runner(_port(model))
    tokens, errors = _run_all(runner, _submit(runner))
    runner.shutdown()
    assert not errors
    jax_toks = _jax_tokens(model, PROMPTS, [GREEDY] * len(PROMPTS))
    assert [tokens[f"req-{i}"] for i in range(len(PROMPTS))] == jax_toks
    assert all(len(t) == GREEDY["max_tokens"] for t in jax_toks)
    return tokens


# ---------------------------------------------------------------------------
# the injector (tests/test_faults.py), held against the JAX one
# ---------------------------------------------------------------------------

def test_spec_disabled_by_default():
    inj = FaultInjector.from_spec(None)
    assert not inj.enabled
    inj.check("decode_dispatch", ("r1",))     # no-op
    assert port_faults.SITES == jax_faults.SITES and port_faults.MODES == jax_faults.MODES


def test_spec_parses_rules_and_options_as_jax():
    spec = ("decode_dispatch:raise:0.5:count=3:match=poison,"
            "kv_alloc:delay:1.0:delay_s=0.01,"
            "prefill_dispatch:hang:1.0:max_hang_s=2,seed=7")
    inj = FaultInjector.from_spec(spec)
    assert inj.enabled
    sites = {r.site: r for r in inj.rules}
    assert sites["decode_dispatch"].count == 3
    assert sites["decode_dispatch"].match == "poison"
    assert sites["kv_alloc"].delay_s == 0.01
    assert sites["prefill_dispatch"].max_hang_s == 2
    ref = jax_faults.FaultInjector.from_spec(spec)
    assert [dataclasses.asdict(r) for r in inj.rules] == \
        [dataclasses.asdict(r) for r in ref.rules]


@pytest.mark.parametrize("bad", [
    "decode_dispatch:raise",              # missing prob
    "nosite:raise:1.0",                   # unknown site
    "decode_dispatch:explode:1.0",        # unknown mode
    "decode_dispatch:raise:2.0",          # prob out of range
    "decode_dispatch:raise:1.0:bogus=1",  # unknown option
    "decode_dispatch:raise:nan0",         # junk prob
])
def test_spec_rejects_malformed_as_jax(bad):
    with pytest.raises(ValueError) as ours:
        FaultInjector.from_spec(bad)
    with pytest.raises(ValueError) as ref:
        jax_faults.FaultInjector.from_spec(bad)
    assert str(ours.value) == str(ref.value)


def _pattern(mod, seed, spec="decode_dispatch:raise:0.3", n=200):
    inj = mod.FaultInjector.from_spec(spec, seed=seed)
    fired = []
    for i in range(n):
        try:
            inj.check("decode_dispatch", (f"r{i % 3}",))
            fired.append(0)
        except mod.InjectedFault:
            fired.append(1)
    return fired


@pytest.mark.parametrize("seed", [0, 5, 6, 11])
def test_seeded_sequence_matches_jax(seed):
    a = _pattern(port_faults, seed)
    assert a == _pattern(port_faults, seed)          # same seed, same faults
    assert a == _pattern(jax_faults, seed)           # and the JAX injector's
    assert a != _pattern(port_faults, seed + 100)
    assert 20 < sum(a) < 120
    spec = "decode_dispatch:raise:0.5:match=r1:count=7"
    assert _pattern(port_faults, seed, spec) == _pattern(jax_faults, seed, spec)


def test_count_caps_total_fires():
    inj = FaultInjector.from_spec("kv_alloc:raise:1.0:count=2")
    for _ in range(2):
        with pytest.raises(InjectedFault):
            inj.check("kv_alloc")
    inj.check("kv_alloc")               # exhausted: a no-op from now on


def test_match_restricts_to_marked_requests():
    inj = FaultInjector.from_spec("decode_dispatch:raise:1.0:match=poison")
    inj.check("decode_dispatch", ("req-0", "req-1"))
    with pytest.raises(InjectedFault):
        inj.check("decode_dispatch", ("req-0", "poison-1"))


def test_suspended_context():
    inj = FaultInjector.from_spec("decode_dispatch:raise:1.0")
    with inj.suspended():
        inj.check("decode_dispatch", ("r",))
    with pytest.raises(InjectedFault):
        inj.check("decode_dispatch", ("r",))


def test_release_hangs_turns_hang_into_fault():
    inj = FaultInjector([FaultRule(site="decode_dispatch", mode="hang", prob=1.0,
                                   max_hang_s=30.0)])
    t0 = time.monotonic()
    threading.Timer(0.1, inj.release_hangs).start()
    with pytest.raises(InjectedFault, match="released"):
        inj.check("decode_dispatch", ("r",))
    assert time.monotonic() - t0 < 5


# ---------------------------------------------------------------------------
# the engine's sites and salvage_requeue
# ---------------------------------------------------------------------------

def test_engine_kv_alloc_site_fires_and_salvages(model):
    eng = _port(model, faults="kv_alloc:raise:1.0:count=1")
    rid = eng.add_request(prompt_token_ids=[5, 6, 7],
                          params=port_rt.SamplingParams(**dict(GREEDY, max_tokens=6)))
    with pytest.raises(InjectedFault):
        while eng.has_work():
            eng.step()
    eng.salvage_requeue()
    while eng.has_work():
        eng.step()
    assert len(eng.requests.pop(rid).output_token_ids) == 6
    assert eng.block_manager.num_seqs() == 0


def test_engine_window_flush_site_fires(model, reference):
    eng = _port(model, faults="window_flush:raise:1.0:count=1")
    rid = eng.add_request(prompt_token_ids=PROMPTS[0], params=port_rt.SamplingParams(**GREEDY))
    with pytest.raises(InjectedFault):
        while eng.has_work():
            eng.step()
    # the window was detached before the fault: salvage replays the request
    assert eng._pending_window is None
    eng.salvage_requeue()
    while eng.has_work():
        eng.step()
    assert eng.requests.pop(rid).output_token_ids == reference["req-0"]


def test_warmup_is_fault_suspended(model):
    eng = _port(model, faults="prefill_dispatch:raise:1.0", multi_step=1,
                pipeline_decode=False)
    eng.warmup(decode_buckets=[2], sample_modes=("greedy",))
    eng.add_request(prompt_token_ids=[5, 6, 7], params=port_rt.SamplingParams(**GREEDY))
    with pytest.raises(InjectedFault):
        eng.step()


def test_engine_env_var_arms_injector(model, monkeypatch):
    monkeypatch.setenv("TPUSERVE_FAULTS", "decode_dispatch:raise:1.0")
    assert _port(model).faults.enabled
    monkeypatch.delenv("TPUSERVE_FAULTS")
    assert not _port(model, faults="").faults.enabled


def test_salvage_requeue_rescues_orphaned_prefill_batch(model, reference):
    """A prefill batch sits in neither queue between the scheduler's pop
    and mark_running: a fault there must not leak it."""
    eng = _port(model, faults="prefill_dispatch:raise:1.0:count=1")
    rids = [eng.add_request(prompt_token_ids=p, params=port_rt.SamplingParams(**GREEDY),
                            request_id=f"req-{i}") for i, p in enumerate(PROMPTS[:2])]
    with pytest.raises(InjectedFault):
        eng.step()
    assert eng.scheduler.num_running == 0 and eng.scheduler.num_waiting == 0
    assert set(eng.salvage_requeue()) == set(rids)
    while eng.has_work():
        eng.step()
    for rid in rids:
        assert eng.requests.pop(rid).output_token_ids == reference[rid]
    assert eng.block_manager.num_seqs() == 0


# ---------------------------------------------------------------------------
# the runner (tests/test_salvage.py, test_runner_fault.py)
# ---------------------------------------------------------------------------

def test_one_shot_fault_salvages_every_stream(model, reference):
    eng = _port(model, faults="decode_dispatch:raise:1.0:count=1")
    runner = _runner(eng)
    tokens, errors = _run_all(runner, _submit(runner))
    runner.shutdown()
    assert not errors
    assert tokens == reference
    assert eng.stats.requests_salvaged > 0 and eng.stats.requests_poisoned == 0
    assert eng.block_manager.num_seqs() == 0


def test_poison_request_isolated_by_bisection(model, reference):
    eng = _port(model, faults="decode_dispatch:raise:1.0:match=poison")
    runner = _runner(eng)
    prid, pq = runner.submit(prompt_token_ids=[30, 31, 32],
                             params=port_rt.SamplingParams(**GREEDY), request_id="poison-0")
    tokens, errors = _run_all(runner, _submit(runner) + [(prid, pq)])
    runner.shutdown()
    assert set(errors) == {prid}
    assert "poison" in str(errors[prid])
    assert {rid: tokens[rid] for rid in reference} == reference
    assert eng.stats.requests_poisoned == 1 and eng.stats.requests_salvaged > 0
    assert eng.block_manager.num_seqs() == 0


def test_mixed_dispatch_fault_salvages(model, reference):
    eng = _port(model, faults="mixed_dispatch:raise:1.0:count=1", multi_step=1,
                pipeline_decode=False, sched=dict(SCHED, mixed_batching=True))
    runner = _runner(eng)
    tokens, errors = _run_all(runner, _submit(runner))
    runner.shutdown()
    assert not errors
    assert tokens == reference
    assert eng.stats.requests_salvaged > 0 and eng.stats.num_mixed_steps > 0


def test_fault_storm_falls_back_to_fail_all(model):
    eng = _port(model, faults="decode_dispatch:raise:1.0")
    runner = _runner(eng)
    runner.MAX_FAULTS_PER_WINDOW = 0          # every fault is one too many
    _, q = runner.submit(prompt_token_ids=[5, 6, 7], params=port_rt.SamplingParams(**GREEDY))
    items = []
    while (item := q.get(timeout=60)) is not None:
        items.append(item)
    runner.shutdown()
    assert any(isinstance(i, Exception) for i in items)
    assert eng.stats.engine_restarts >= 1 and eng.stats.requests_salvaged == 0
    assert eng.block_manager.num_seqs() == 0


def test_salvage_budget_bounds_retry_loops(model):
    eng = _port(model, faults="kv_alloc:raise:1.0:count=1")
    runner = _runner(eng)
    runner.max_salvages = 0
    _, q = runner.submit(prompt_token_ids=[5, 6, 7], params=port_rt.SamplingParams(**GREEDY))
    err = None
    while (item := q.get(timeout=60)) is not None:
        if isinstance(item, Exception):
            err = item
    runner.shutdown()
    assert err is not None and "salvage budget" in str(err)
    assert eng.stats.requests_poisoned == 1
    assert eng.block_manager.num_seqs() == 0


class _EveryNth(FaultInjector):
    """Raises at every ``n``-th check of ``site``, ``fires`` times in all."""

    def __init__(self, site: str, n: int, fires: int):
        super().__init__()
        self.site, self.n, self.left, self.calls = site, n, fires, 0

    def check(self, site, rids=()):
        if site != self.site or self.left == 0:
            return
        self.calls += 1
        if self.calls % self.n == 0:
            self.left -= 1
            raise InjectedFault(f"injected fault at {site}")


def test_salvage_budget_resets_on_progress(model):
    """The budget bounds consecutive faulted attempts, not the faults a
    stream lives through: five faults, tokens emitted between them, under
    a budget of two, and the stream completes with the fault-free tokens
    (the port's and the JAX engine's)."""
    params = dict(GREEDY, max_tokens=32)
    sp = port_rt.SamplingParams(**params)
    ref = _port(model, multi_step=1, pipeline_decode=False).generate(
        [PROMPTS[0]], sp)[0].output_token_ids
    assert ref == _jax_tokens(model, [PROMPTS[0]], [params])[0]
    eng = _port(model, multi_step=1, pipeline_decode=False)
    eng.faults = _EveryNth("decode_dispatch", 5, 5)
    runner = _runner(eng)
    runner.max_salvages = 2
    tokens, errors = _run_all(runner, [runner.submit(prompt_token_ids=PROMPTS[0], params=sp,
                                                     request_id="long-0")])
    runner.shutdown()
    assert not errors
    assert eng.faults.left == 0 and eng.stats.requests_salvaged == 5
    assert eng.stats.requests_poisoned == 0
    assert tokens["long-0"] == ref
    assert eng.block_manager.num_seqs() == 0


def test_runner_fault_mid_window_fails_request_and_recovers(model):
    """A persistent decode fault armed while a pipelined window is in
    flight: the request re-faults every probe, is isolated and failed,
    the dropped window leaks nothing, and the runner serves on once the
    fault is gone."""
    eng = _port(model)
    runner = _runner(eng)
    _, q = runner.submit(prompt_token_ids=[5, 6, 7],
                         params=port_rt.SamplingParams(max_tokens=400, temperature=0.0,
                                                       ignore_eos=True))
    deadline = time.monotonic() + 30
    while eng._pending_window is None and time.monotonic() < deadline:
        time.sleep(0.001)
    assert eng._pending_window is not None
    eng.faults = FaultInjector.from_spec("decode_dispatch:raise:1.0")
    items = []
    while (item := q.get(timeout=60)) is not None:
        items.append(item)
    assert any(isinstance(i, Exception) for i in items)
    eng.faults = FaultInjector.from_spec(None)
    deadline = time.monotonic() + 10
    while eng.has_work() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng._pending_window is None and eng.block_manager.num_seqs() == 0
    outs, _ = runner.generate_sync(prompt_token_ids=[9, 10, 11],
                                   params=port_rt.SamplingParams(max_tokens=6,
                                                                 temperature=0.0,
                                                                 ignore_eos=True),
                                   timeout=60)
    runner.shutdown()
    assert sum(len(o.new_token_ids) for o in outs) == 6
    assert eng.stats.requests_poisoned == 1


# ---------------------------------------------------------------------------
# the hang watchdog (tests/test_watchdog.py)
# ---------------------------------------------------------------------------

def test_injected_hang_trips_watchdog_and_salvages(model, reference):
    eng = _port(model, faults="decode_dispatch:hang:1.0:count=1:match=hangme:max_hang_s=60",
                step_watchdog_s=0.4)
    runner = _runner(eng)
    runner.generate_sync(prompt_token_ids=[1, 2, 3], params=port_rt.SamplingParams(**GREEDY))
    runner.WATCHDOG_WARMUP_STEPS = 0
    assert eng.stats.watchdog_trips == 0
    t0 = time.monotonic()
    rid, q = runner.submit(prompt_token_ids=PROMPTS[0], params=port_rt.SamplingParams(**GREEDY),
                           request_id="hangme-0")
    tokens, errors = _run_all(runner, [(rid, q)])
    elapsed = time.monotonic() - t0
    runner.shutdown()
    assert not errors and tokens[rid] == reference["req-0"]
    assert eng.stats.watchdog_trips == 1 and eng.stats.requests_salvaged >= 1
    assert elapsed < 20
    assert eng.block_manager.num_seqs() == 0


def test_unreleasable_hang_fails_clients_not_strands_them(model):
    """A wedged step the injector cannot release: the watchdog's second
    stage fails the waiting client and counts an engine restart; once the
    step returns, the loop reconciles and serves again."""
    eng = _port(model, step_watchdog_s=0.3)
    runner = _runner(eng)
    runner.generate_sync(prompt_token_ids=[1, 2, 3], params=port_rt.SamplingParams(**GREEDY))
    runner.WATCHDOG_WARMUP_STEPS = 0
    release = threading.Event()
    orig = eng._dispatch

    def wedged(*a, **k):
        release.wait(timeout=60)           # a dispatch that never returns
        raise RuntimeError("wedged dispatch released")

    eng._dispatch = wedged
    try:
        _, q = runner.submit(prompt_token_ids=[5, 6, 7],
                             params=port_rt.SamplingParams(**GREEDY))
        t0 = time.monotonic()
        err = None
        while (item := q.get(timeout=30)) is not None:
            if isinstance(item, Exception):
                err = item
        assert err is not None and "watchdog" in str(err)
        assert time.monotonic() - t0 < 20
        assert eng.stats.watchdog_trips >= 1 and eng.stats.engine_restarts >= 1
    finally:
        release.set()
        eng._dispatch = orig
    outs, _ = runner.generate_sync(prompt_token_ids=[9, 10, 11],
                                   params=port_rt.SamplingParams(**GREEDY), timeout=120)
    runner.shutdown()
    assert sum(len(o.new_token_ids) for o in outs) == GREEDY["max_tokens"]


# the threshold and the stalls below, in units of 0.4 s: at 5 the stall
# outside a capture leaves the real dispatch 1 s before the second stage
# (twice the threshold), and every later step 2 s before a second trip, so
# a loaded host's slow step cannot add a restart or a trip
WATCHDOG_CASE_SCALE = 5.0


@pytest.mark.parametrize("capturing,stall_s,trips", [(True, 1.5, 0), (False, 0.6, 1)])
def test_watchdog_discounts_a_first_use_capture(model, reference, capturing, stall_s, trips):
    """Past the warmup steps, a bucket's first use captures its graph
    inside a step: that time counts at 1/WATCHDOG_WARMUP_SCALE, so a
    capture of almost four thresholds trips nothing, where a stall of one
    and a half outside a capture trips once (and fails no one).  The
    threshold and the stall are scaled together (``WATCHDOG_CASE_SCALE``)."""
    stall_s *= WATCHDOG_CASE_SCALE
    eng = _port(model, step_watchdog_s=0.4 * WATCHDOG_CASE_SCALE)
    runner = _runner(eng)
    runner.generate_sync(prompt_token_ids=[1, 2, 3], params=port_rt.SamplingParams(**GREEDY))
    runner.WATCHDOG_WARMUP_STEPS = 0
    orig, graphs = eng._dispatch, eng.graphs
    c0 = graphs.capture_s

    def first_use(*a, **k):
        eng._dispatch = orig
        if capturing:
            graphs.capturing_since = time.monotonic()
        time.sleep(stall_s)
        if capturing:
            graphs.capture_s += stall_s
            graphs.capturing_since = None
        return orig(*a, **k)

    eng._dispatch = first_use
    tokens, errors = _run_all(runner, _submit(runner, prompts=PROMPTS[:1]))
    runner.shutdown()
    assert eng._dispatch == orig
    assert not errors and tokens["req-0"] == reference["req-0"]
    assert eng.stats.watchdog_trips == trips and eng.stats.engine_restarts == 0
    assert graphs.capture_s - c0 == (stall_s if capturing else 0.0)


def test_watchdog_disabled_by_default(model):
    eng = _port(model)
    runner = _runner(eng)
    assert runner._watchdog_thread is None
    runner.generate_sync(prompt_token_ids=[1, 2, 3], params=port_rt.SamplingParams(**GREEDY))
    runner.shutdown()
    assert eng.stats.watchdog_trips == 0


# ---------------------------------------------------------------------------
# the port's own state
# ---------------------------------------------------------------------------

ROW_PROMPTS = [[5 + 3 * i, 6 + 3 * i, 7 + 3 * i] for i in range(8)]


def _rows(penalty_tokens):
    """Six greedy rows, a guided json_object row and a repetition-penalty
    row of ``penalty_tokens`` tokens."""
    return [dict(GREEDY, max_tokens=24)] * 6 + [
        dict(GREEDY, max_tokens=24, guided="json"),
        dict(GREEDY, max_tokens=penalty_tokens, repetition_penalty=1.3)]


def _rows_run(model, rows, spec=None, arm=None):
    """The eight rows on a pipelined windowed engine, salvaging faults as
    the runner does; ``spec`` (a one-shot rule) is armed at the first
    step that begins with a window in flight and ``arm(eng)`` true.
    Returns (tokens, texts, engine, the dropped window's requests, its host
    tokens when dropped and now, faults seen)."""
    eng = _port(model)
    rids = [eng.add_request(prompt_token_ids=p, params=port_rt.SamplingParams(**sp),
                            request_id=f"row-{i}")
            for i, (p, sp) in enumerate(zip(ROW_PROMPTS, rows))]
    dropped = None
    faults_seen = 0
    while eng.has_work():
        pw = eng._pending_window
        if spec and dropped is None and pw is not None and arm(eng):
            dropped = ([r.request_id for r in pw.reqs if not r.finished], pw.toks.clone(),
                       pw.toks)
            eng.faults = FaultInjector.from_spec(spec)
        try:
            eng.step()
        except InjectedFault:
            faults_seen += 1
            eng.salvage_requeue()
            assert eng._pending_window is None and eng._pending is None
    reqs = [eng.requests.pop(r) for r in rids]
    assert eng.block_manager.num_seqs() == 0
    return ([r.output_token_ids for r in reqs],
            [(r.output_text, r.finish_reason.value) for r in reqs], eng, dropped, faults_seen)


def _json_legal(text: str, reason: str) -> bool:
    """A legal json_object prefix, and a whole document if it stopped."""
    try:
        JsonStateMachine().feed(text)
        if reason == "stop":
            json.loads(text)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("site", ["decode_dispatch", "window_flush"])
def test_fault_with_a_window_in_flight_keeps_guided_and_penalty_rows(model, site):
    """A one-shot fault while a pipelined window is in flight; the window
    is dropped unread and every row re-prefills.  A live penalty row makes
    each dispatch resolve the window first (its counts read the host
    history), so at ``decode_dispatch`` the fault meets an unread window
    once the penalty row has finished (8 tokens), while at
    ``window_flush`` it meets the window holding the guided and penalty
    rows.  The dropped window's host buffer is not reused by the replays
    that follow; the guided row's FSM state comes back from the tokens it
    kept and the penalty row's counts from its history: every row ends
    with the fault-free run's tokens and the JAX engine's, and the guided
    output is a legal json_object prefix (a whole document if it
    stopped)."""
    if site == "decode_dispatch":
        rows = _rows(8)
        arm = lambda eng: eng.requests["row-7"].finished          # noqa: E731
    else:
        rows = _rows(24)
        arm = lambda eng: True                                      # noqa: E731
    clean, clean_texts, _, _, _ = _rows_run(model, rows)
    toks, texts, eng, dropped, faults_seen = _rows_run(
        model, rows, f"{site}:raise:1.0:count=1", arm)
    assert faults_seen == 1 and eng.stats.guided_fsm_windows > 0
    in_window, when_dropped, buf = dropped
    assert "row-6" in in_window and ("row-7" in in_window) == (site == "window_flush")
    assert torch.equal(buf, when_dropped)
    assert toks == clean and texts == clean_texts
    assert _json_legal(*texts[6])
    assert toks == _jax_tokens(model, ROW_PROMPTS, rows)


def test_fault_during_a_chunked_re_prefill(model):
    """A decode fault once every stream holds 4+ tokens re-queues streams
    whose prompt plus output outgrow the chunk size, so their re-prefill
    runs chunk by chunk; a second fault lands on the chunk after the first
    one (the prompt mid-chunk holds blocks, freed as suspect).  Tokens
    equal the fault-free run's and the JAX engine's."""
    sched = dict(SCHED, prefill_chunk_size=8)
    prompts = [list(range(2 + i, 8 + i)) for i in range(3)]
    params = [dict(GREEDY, max_tokens=16)] * 3

    def run(inject):
        eng = _port(model, sched=sched)
        rids = [eng.add_request(prompt_token_ids=p, params=port_rt.SamplingParams(**sp))
                for p, sp in zip(prompts, params)]
        reqs = [eng.requests[r] for r in rids]
        phase, faults = 0, 0
        while eng.has_work():
            if inject and phase == 0 and all(len(r.output_token_ids) >= 4 for r in reqs):
                eng.faults = FaultInjector.from_spec("decode_dispatch:raise:1.0:count=1")
                phase = 1
            elif inject and phase == 1 and eng.stats.num_chunk_steps == 1:
                eng.faults = FaultInjector.from_spec("prefill_dispatch:raise:1.0:count=1")
                phase = 2
            try:
                eng.step()
            except InjectedFault:
                faults += 1
                eng.salvage_requeue()
        assert eng.block_manager.num_seqs() == 0
        return [eng.requests.pop(r).output_token_ids for r in rids], eng, faults

    clean, _, _ = run(False)
    toks, eng, faults = run(True)
    assert faults == 2 and eng.stats.num_chunk_steps > 1
    assert toks == clean
    assert toks == _jax_tokens(model, prompts, params, sched=sched)


def test_fault_while_a_tier_restore_is_in_flight(model):
    """A fault in the cycle that begins a tier restore: the restoring
    request is in the waiting queue once (not re-queued again), the
    restore commits, and its tokens equal a twin's that never evicted
    the prefix."""
    cache = dict(CACHE, num_blocks=24)
    sched = dict(SCHED, max_num_seqs=4)
    shared = list(range(2, 26))
    sp = port_rt.SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)
    eng = _port(model, cache=cache, sched=sched, multi_step=1, pipeline_decode=False)
    eng.generate([shared + [30]], sp)
    eng.generate([[100 + i] * 40 for i in range(3)], sp)          # churn the prefix out
    assert eng.stats.kv_demoted_blocks > 0
    running = eng.add_request(prompt_token_ids=[3, 4, 5], params=sp, request_id="other")
    eng.step()                                                    # other: prefill
    rid = eng.add_request(prompt_token_ids=shared + [77], params=sp, request_id="restored")
    eng.faults = FaultInjector.from_spec("decode_dispatch:raise:1.0:count=1")
    with pytest.raises(InjectedFault):
        eng.step()                       # begins the restore, then the decode faults
    assert eng.requests[rid].state == RequestState.RESTORING and eng._restores
    requeued = eng.salvage_requeue()
    assert requeued == [running]
    assert [r.request_id for r in eng.scheduler.waiting].count(rid) == 1
    while eng.has_work():
        eng.step()
    assert eng.stats.kv_restores == 1 and eng.block_manager.num_restoring_blocks == 0
    got = eng.requests.pop(rid).output_token_ids
    twin = _port(model, cache=dict(CACHE, num_blocks=128), sched=sched, multi_step=1,
                 pipeline_decode=False)
    assert got == twin.generate([shared + [77]], sp)[0].output_token_ids
    assert eng.requests.pop(running).output_token_ids == \
        twin.generate([[3, 4, 5]], sp)[0].output_token_ids
