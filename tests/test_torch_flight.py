"""The flight recorder and the host-phase profiler in the port, on the CPU,
against the JAX package.

The recorder's units (tests/test_flight.py) run on both packages' modules:
the removed recorder, the bounded ring, the clock discipline.  Then the
same requests go into a port engine and a JAX engine over the same seeded
float32 tiny-qwen3 weights: the main path in 4-token windows, a chunked
prompt, a prefix hit, an abort, an SLO shed (and a brownout clamp) and a
step faulted at its dispatch and salvaged.  For each case every request's
timeline must have the JAX timeline's event names in order, each event
the same detail keys, the same FINISHED causes, and the step records the
same (kind, rows, actual tokens, padded tokens) in order.  Timestamps and
phase ms are host readings of each run and are not compared.

The server twin (the port's server and the JAX server, both under
``TPUSERVE_DEVPROF=0`` and without the burn-rate evaluator: the device
profiler's sections are compared in tests/test_torch_devprof.py) answers
``/debug/engine``, ``/debug/engine/dump``, ``/debug/requests/{id}`` (a
known and an unknown id) and ``/healthz`` with the same status codes and
key sets, with the recorder on and off.  A poison request through each
package's runner leaves one ``flight-poison-*.json`` bundle with the same
keys, and the port's loads through the JAX replay extractor.
"""

import ast
import dataclasses
import json
import os
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve.runtime import faults as jax_faults
from tpuserve.runtime import flight as jax_flight
from tpuserve.runtime import slo as jax_slo
from tpuserve.server.openai_api import OpenAIServer as JaxServer
from tpuserve.server.openai_api import ServerConfig as JaxServerConfig
from tpuserve.server.runner import AsyncEngineRunner as JaxRunner
from tpuserve_torch import runtime as port_rt
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime import faults as port_faults
from tpuserve_torch.runtime import flight as port_flight
from tpuserve_torch.runtime import hostprof as port_hostprof
from tpuserve_torch.runtime import slo as port_slo
from tpuserve_torch.server import OpenAIServer, ServerConfig
from tpuserve_torch.server.runner import AsyncEngineRunner

ROOT = Path(__file__).resolve().parent.parent
CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16, dtype="float32")
SCHED = dict(max_num_seqs=8, min_prefill_bucket=8, min_decode_bucket=2)
GREEDY = dict(max_tokens=10, temperature=0.0, ignore_eos=True)
PROMPTS = [[5, 6, 7], [9, 10, 11, 12], [20, 21, 22, 23, 24]]
# (runtime, faults, flight, slo) of each package
PACKAGES = {"port": (port_rt, port_faults, port_flight, port_slo),
            "jax": (jax_rt, jax_faults, jax_flight, jax_slo)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("TPUSERVE_FLIGHT", "TPUSERVE_FLIGHT_DIR", "TPUSERVE_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    # both packages' device profilers off (tests/test_torch_devprof.py
    # compares them)
    monkeypatch.setenv("TPUSERVE_DEVPROF", "0")


@pytest.fixture(scope="module")
def model(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _engine(pkg, model, sched=None, **kw):
    rt = PACKAGES[pkg][0]
    jcfg, jparams, cfg, params = model
    kw = dict(dict(multi_step=4, pipeline_decode=True, attn_impl="reference", seed=0), **kw)
    conf = rt.EngineConfig(model="tiny-qwen3", cache=rt.CacheConfig(**CACHE),
                           scheduler=rt.SchedulerConfig(**dict(SCHED, **(sched or {}))), **kw)
    if pkg == "jax":
        return jax_rt.Engine(conf, params=jparams, model_cfg=jcfg)
    return port_rt.Engine(conf, params=params, model_cfg=cfg, device="cpu")


# ---------------------------------------------------------------------------
# the recorder's units (tests/test_flight.py), on both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_recorder_disabled_is_removed(model, pkg):
    """``EngineConfig(flight=False)``: no events, no step records, no
    scheduler or SLO hooks, no post-mortem."""
    eng = _engine(pkg, model, flight=False)
    assert not eng.flight.enabled
    assert eng.scheduler.flight is None and eng._slo.flight is None
    eng.generate([[1, 2, 3]], PACKAGES[pkg][0].SamplingParams(max_tokens=1, temperature=0.0,
                                                              ignore_eos=True))
    snap = eng.flight.engine_snapshot()
    assert snap["events_recorded"] == 0 and snap["steps_recorded"] == 0
    assert eng.flight.postmortem("test") is None


def test_recorder_and_profiler_are_on_by_default_and_env_removes_them(model, monkeypatch):
    port_hostprof.PROF.enabled = False
    eng = _engine("port", model)
    assert eng.flight.enabled and eng._flight_on and port_hostprof.PROF.enabled
    assert eng.scheduler.flight is eng.flight and eng._slo.flight is eng.flight
    assert eng.faults.on_fire == eng.flight.fault_hook
    port_hostprof.PROF.enabled = False
    monkeypatch.setenv("TPUSERVE_FLIGHT", "0")
    off = _engine("port", model)
    assert not off.flight.enabled and not port_hostprof.PROF.enabled
    assert off.scheduler.flight is None and off.faults.on_fire is None
    # greedy tokens do not depend on the recorder
    sp = port_rt.SamplingParams(**GREEDY)
    assert ([r.output_token_ids for r in eng.generate(PROMPTS, sp)]
            == [r.output_token_ids for r in off.generate(PROMPTS, sp)])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_event_ring_bounded(pkg):
    fr = PACKAGES[pkg][2].FlightRecorder(enabled=True, events=16, steps=4)
    for i in range(100):
        fr.req_event(f"r{i}", "QUEUED")
    snap = fr.engine_snapshot()
    assert snap["events_recorded"] == 100
    assert fr.request_timeline("r0") == []
    assert fr.request_timeline("r99")
    assert len(fr.recent_request_ids(limit=64)) <= 16
    for i in range(10):
        fr.note_step("window", 2, 8, 16, 0.001)
    assert len(fr.steps_snapshot()) == 4


def test_recorder_constants_are_the_jax_recorders():
    for name in ("FLIGHT_SCHEMA_VERSION", "EVENTS", "SLI_KINDS", "MAX_POSTMORTEMS"):
        assert getattr(port_flight, name) == getattr(jax_flight, name), name


_CLOCK_PIN_FILES = ["tpuserve_torch/runtime", "tpuserve_torch/server/runner.py",
                    "tpuserve_torch/server/metrics.py", "tpuserve_torch/server/kv_digest.py",
                    "tpuserve_torch/server/tracing.py"]


def test_no_wall_clock_deltas_engine_side():
    """As tests/test_flight.py pins the JAX tree: the only ``time.time()``
    engine-side is the recorder's export anchor, tagged wall-anchor-ok."""
    offenders = []
    for rel in _CLOCK_PIN_FILES:
        p = ROOT / rel
        for path in (sorted(p.rglob("*.py")) if p.is_dir() else [p]):
            src = path.read_text(encoding="utf-8")
            lines = src.splitlines()
            for node in ast.walk(ast.parse(src)):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "time" and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "time"
                        and "wall-anchor-ok" not in lines[node.lineno - 1]):
                    offenders.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not offenders, offenders


def _walk_host_values(x) -> bool:
    """Only str, int, float, bool, None, tuples and dicts of those."""
    if x is None or isinstance(x, (str, int, float, bool)):
        return True
    if isinstance(x, tuple):
        return all(_walk_host_values(v) for v in x)
    if isinstance(x, dict):
        return all(isinstance(k, str) and _walk_host_values(v) for k, v in x.items())
    return False


# ---------------------------------------------------------------------------
# engine timelines and step records, against the JAX engine
# ---------------------------------------------------------------------------

LONG = list(range(30, 70))                   # 40 tokens: chunks of 16
BASE = list(range(100, 124))                 # 24 tokens: six cached blocks


def _steps(eng, limit=400):
    for _ in range(limit):
        if not eng.has_work():
            return
        eng.step()
    raise AssertionError("engine did not drain")


def _drive(pkg, eng, case) -> list:
    """Run ``case`` on ``eng``; returns the request ids it used."""
    rt, faults, _, slo = PACKAGES[pkg]
    sp = lambda **kw: rt.SamplingParams(**dict(GREEDY, **kw))        # noqa: E731
    if case == "main":
        for i, p in enumerate(PROMPTS):
            eng.add_request(prompt_token_ids=p, params=sp(), request_id=f"r{i}")
        _steps(eng)
        return [f"r{i}" for i in range(len(PROMPTS))]
    if case == "chunked":
        eng.add_request(prompt_token_ids=PROMPTS[0], params=sp(), request_id="short")
        eng.add_request(prompt_token_ids=LONG, params=sp(max_tokens=6), request_id="long")
        _steps(eng)
        return ["short", "long"]
    if case == "prefix_hit":
        eng.add_request(prompt_token_ids=BASE + [7], params=sp(max_tokens=4),
                        request_id="first")
        _steps(eng)
        eng.add_request(prompt_token_ids=BASE + [8, 9], params=sp(max_tokens=4),
                        request_id="hit")
        _steps(eng)
        return ["first", "hit"]
    if case == "abort":
        for i, p in enumerate(PROMPTS[:2]):
            eng.add_request(prompt_token_ids=p, params=sp(max_tokens=24), request_id=f"r{i}")
        for _ in range(3):
            eng.step()
        assert eng.abort_request("r1")
        eng.add_request(prompt_token_ids=PROMPTS[2], params=sp(), request_id="queued")
        assert eng.abort_request("queued")
        _steps(eng)
        return ["r0", "r1", "queued"]
    if case == "shed":
        eng._slo.level = 3
        with pytest.raises(slo.ShedError):
            eng.add_request(prompt_token_ids=PROMPTS[0], params=sp(slo_class="batch"),
                            request_id="shed-0")
        eng._slo.level = 2
        eng.add_request(prompt_token_ids=PROMPTS[1],
                        params=sp(slo_class="batch", max_tokens=200),
                        request_id="clamped")
        eng._slo.level = 0
        eng.add_request(prompt_token_ids=PROMPTS[2], params=sp(), request_id="served")
        _steps(eng)
        return ["shed-0", "clamped", "served"]
    if case == "salvage":
        for i, p in enumerate(PROMPTS):
            eng.add_request(prompt_token_ids=p, params=sp(), request_id=f"r{i}")
        faulted = 0
        while eng.has_work():
            try:
                eng.step()
            except faults.InjectedFault:
                faulted += 1
                eng.salvage_requeue()
        assert faulted == 1
        return [f"r{i}" for i in range(len(PROMPTS))]
    raise ValueError(case)


CASES = {
    "main": {},
    "chunked": dict(sched=dict(prefill_chunk_size=16)),
    "prefix_hit": {},
    "abort": {},
    "shed": dict(slo_cfg=dict(shed_min_queue_frac=0.0)),
    # window_flush: a site both engines check at the same point (the JAX
    # engine's sampler is also a decode_dispatch site: see
    # test_decode_dispatch_fires_at_the_jax_samplers_site_too)
    "salvage": dict(faults="window_flush:raise:1.0:count=1"),
}


def _record(pkg, model, case):
    kw = dict(CASES[case])
    if "slo_cfg" in kw:
        kw["slo"] = PACKAGES[pkg][3].SloConfig(**kw.pop("slo_cfg"))
    eng = _engine(pkg, model, **kw)
    rids = _drive(pkg, eng, case)
    fl = eng.flight
    timelines = {rid: [(e["event"], tuple(sorted(e.get("detail") or {})),
                        (e.get("detail") or {}).get("cause") if e["event"] == "FINISHED"
                        else None) for e in fl.request_timeline(rid)] for rid in rids}
    steps = [(s["kind"], s["rows"], s["actual_tokens"], s["padded_tokens"])
             for s in fl.steps_snapshot(limit=10 ** 6)]
    # the whole ring, intake events before QUEUED included
    ring = [(r, ev, tuple(sorted(d or {}))) for _t, r, ev, d in fl._events.snapshot()]
    return eng, timelines, steps, ring


@pytest.mark.parametrize("case", list(CASES))
def test_timelines_and_step_records_match_the_jax_engine(model, case):
    eng, ours, our_steps, our_ring = _record("port", model, case)
    _, ref, ref_steps, ref_ring = _record("jax", model, case)
    assert ours == ref
    assert our_steps == ref_steps
    assert our_ring == ref_ring
    names = {rid: [e[0] for e in tl] for rid, tl in ours.items()}
    expected = {
        "main": ("r0", ["QUEUED", "ADMITTED", "PREFILL", "WINDOW", "FINISHED"]),
        "chunked": ("long", ["QUEUED", "ADMITTED", "PREFILL_CHUNK", "WINDOW", "FINISHED"]),
        "prefix_hit": ("hit", ["QUEUED", "ADMITTED", "PREFILL_CHUNK", "WINDOW", "FINISHED"]),
        "abort": ("queued", ["QUEUED", "FINISHED"]),
        "shed": ("shed-0", ["SHED"]),
        "salvage": ("r0", ["QUEUED", "ADMITTED", "PREFILL", "WINDOW", "FAULT", "SALVAGED",
                           "PREFILL", "WINDOW", "FINISHED"]),
    }[case]
    got = [n for i, n in enumerate(names[expected[0]])
           if i == 0 or n != names[expected[0]][i - 1]]        # a run of one event as one
    assert got == expected[1], names
    if case == "chunked":
        assert names["long"].count("PREFILL_CHUNK") == 3
    if case == "shed":
        # the clamp is recorded at intake, before the request's QUEUED
        assert ("clamped", "BROWNOUT_CLAMPED", ("level", "max_tokens")) in our_ring
    if case == "abort":
        assert ours["r1"][-1][2] == "abort"
    # every ring entry holds host values only (no tensor: no wait on a card)
    assert all(_walk_host_values(e) for e in eng.flight._events.snapshot())
    assert all(_walk_host_values(s) for s in eng.flight._steps.snapshot())
    assert {s[0] for s in our_steps} <= {"idle", "prefill", "prefill_chunk", "mixed",
                                         "window", "decode"}


def test_decode_dispatch_fires_at_the_jax_samplers_site_too(model):
    """A kept divergence (ROADMAP.md C): the JAX engine's synchronous
    sampler is a ``decode_dispatch`` fault site, so a one-shot rule fires
    at a prefill's sampling there, and at the first decode window in the
    port, whose sampler is no fault site.  Both salvage and finish every
    stream."""
    fault = dict(faults="decode_dispatch:raise:1.0:count=1")
    first = {}
    for pkg in ("port", "jax"):
        eng = _engine(pkg, model, **fault)
        _drive(pkg, eng, "salvage")
        tl = [e["event"] for e in eng.flight.request_timeline("r0")]
        first[pkg] = tl[tl.index("FAULT") - 1]
        assert tl[-1] == "FINISHED" and "SALVAGED" in tl
    assert first == {"port": "WINDOW", "jax": "PREFILL"}


def test_step_records_carry_host_phases(model):
    """Each record's phases are the profiler's: the five canonical names,
    and a window cycle's dispatch, flush and detokenize."""
    eng = _engine("port", model)
    eng.generate(PROMPTS, port_rt.SamplingParams(**GREEDY))
    steps = eng.flight.steps_snapshot()
    assert all(set(s.get("phase_ms", {})) <= set(port_hostprof.HostPhaseProfiler.PHASES)
               for s in steps)
    assert any({"dispatch", "flush", "detokenize"} <= set(s.get("phase_ms", {}))
               for s in steps if s["kind"] == "window")
    rep = port_hostprof.PROF.report()
    assert rep["cycles"] > 0 and set(rep["phases"]) >= set(port_hostprof.PROF.PHASES)


def test_mixed_steps_stamp_windows_and_chunks_like_the_jax_engine(model):
    sched = dict(mixed_batching=True, mixed_token_budget=16)

    def run(pkg):
        eng = _engine(pkg, model, sched=sched, multi_step=1, pipeline_decode=False)
        rt = PACKAGES[pkg][0]
        eng.add_request(prompt_token_ids=PROMPTS[0], params=rt.SamplingParams(**GREEDY),
                        request_id="a")
        eng.step()
        eng.add_request(prompt_token_ids=LONG, params=rt.SamplingParams(**GREEDY),
                        request_id="b")
        _steps(eng)
        tl = {r: [(e["event"], tuple(sorted(e.get("detail") or {})))
                  for e in eng.flight.request_timeline(r)] for r in ("a", "b")}
        return tl, [(s["kind"], s["rows"], s["actual_tokens"], s["padded_tokens"])
                    for s in eng.flight.steps_snapshot()]
    ours, ref = run("port"), run("jax")
    assert ours == ref
    assert ("PREFILL_CHUNK", ("done", "mixed", "tokens", "total")) in ours[0]["b"]
    assert any(k == "mixed" for k, *_ in ours[1])


# ---------------------------------------------------------------------------
# the server twin: /debug/*, /healthz
# ---------------------------------------------------------------------------

def _request(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _servers(model, **kw):
    port = OpenAIServer(_engine("port", model, multi_step=1, **kw),
                        ServerConfig(host="127.0.0.1", port=0, slo_burn=False))
    jsrv = JaxServer(_engine("jax", model, multi_step=1, **kw),
                     JaxServerConfig(host="127.0.0.1", port=0, tpu_metrics=False,
                                     slo_burn=False))
    urls = {"port": f"http://127.0.0.1:{port.start()}",
            "jax": f"http://127.0.0.1:{jsrv.start()}"}
    return urls, (port, jsrv)


def _keys(x):
    """A payload's key structure: dicts by their keys (recursively), lists
    by their first element's."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_keys(x[0])] if x and isinstance(x[0], (dict, list)) else []
    return None


def test_debug_routes_match_the_jax_server(model, tmp_path):
    urls, srvs = _servers(model)
    try:
        got = {}
        for k, url in urls.items():
            status, _ = _request(url + "/v1/completions",
                                 {"prompt": [5, 6, 7], "max_tokens": 4, "temperature": 0,
                                  "ignore_eos": True})
            assert status == 200
            s_eng, eng_snap = _request(url + "/debug/engine")
            rid = eng_snap["requests"][-1]
            s_req, tl = _request(url + f"/debug/requests/{rid}")
            s_unknown, unknown = _request(url + "/debug/requests/nope-404")
            s_dump, dump = _request(url + "/debug/engine/dump")
            s_health, health = _request(url + "/healthz")
            got[k] = dict(codes=(s_eng, s_req, s_unknown, s_dump, s_health),
                          snap=eng_snap, tl=tl, unknown=unknown, dump=dump, health=health)
        p, j = got["port"], got["jax"]
        assert p["codes"] == j["codes"] == (200, 200, 404, 200, 200)
        # the snapshot's keys, with a step record's, the SLI summary's and the
        # compile caches'
        for key in ("snap", "tl", "dump"):
            assert _keys(p[key]) == _keys(j[key]), key
        assert p["unknown"]["error"]["message"] == j["unknown"]["error"]["message"]
        assert [e["event"] for e in p["tl"]["events"]] == [e["event"] for e in j["tl"]["events"]]
        assert p["dump"]["schema"] == j["dump"]["schema"] == 2
        assert set(p["dump"]["rings"]["events"]) == {"cursor", "capacity", "dropped", "torn"}
        assert p["snap"]["cold_start_s"] > 0 and p["health"]["cold_start_s"] > 0
        assert set(p["health"]) == set(j["health"])
        assert set(p["snap"]["sli"]["standard"]) == {"ttft", "itl", "e2e"}
        metrics = urllib.request.urlopen(urls["port"] + "/metrics", timeout=30).read().decode()
        assert "tpuserve_replay_dumps_total" in metrics
        assert "tpuserve_flight_postmortems_total" in metrics
        assert 'tpuserve_e2e_seconds_count{model_name="tiny-qwen3",slo_class="standard"}' \
            in metrics
    finally:
        for s in srvs:
            s.shutdown()


def test_debug_routes_with_the_recorder_off_match_the_jax_server(model):
    urls, srvs = _servers(model, flight=False)
    try:
        got = {k: [_request(url + path) for path in ("/debug/engine", "/debug/engine/dump",
                                                      "/debug/requests/x")]
               for k, url in urls.items()}
        assert [s for s, _ in got["port"]] == [s for s, _ in got["jax"]] == [200, 404, 404]
        assert got["port"][0][1] == got["jax"][0][1] == {"enabled": False}
        for (_, p), (_, j) in zip(got["port"][1:], got["jax"][1:]):
            assert p["error"]["message"] == j["error"]["message"]
    finally:
        for s in srvs:
            s.shutdown()


# ---------------------------------------------------------------------------
# post-mortems
# ---------------------------------------------------------------------------

def _poison_bundle(pkg, model, flight_dir, monkeypatch):
    monkeypatch.setenv("TPUSERVE_FLIGHT_DIR", str(flight_dir))
    eng = _engine(pkg, model, multi_step=1, faults="decode_dispatch:raise:1.0:match=poison")
    runner = (AsyncEngineRunner if pkg == "port" else JaxRunner)(eng)
    runner.start()
    sp = PACKAGES[pkg][0].SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
    try:
        subs = [runner.submit(prompt_token_ids=p, params=sp, request_id=f"ok-{i}")
                for i, p in enumerate(PROMPTS[:2])]
        subs.append(runner.submit(prompt_token_ids=[30, 31, 32], params=sp,
                                  request_id="poison-0"))
        errors = {}
        deadline = time.monotonic() + 120
        for rid, q in subs:
            while (item := q.get(timeout=max(deadline - time.monotonic(), 0.001))) is not None:
                if isinstance(item, Exception):
                    errors[rid] = item
    finally:
        runner.shutdown()
    assert set(errors) == {"poison-0"}
    files = sorted(flight_dir.glob("flight-poison-*.json"))
    assert len(files) == 1 and eng.stats.flight_postmortems == 1
    assert not list(flight_dir.glob("*.tmp"))
    return files[0], json.loads(files[0].read_text())


def test_poison_postmortem_written_by_both_packages(model, tmp_path, monkeypatch):
    path, ours = _poison_bundle("port", model, tmp_path / "port", monkeypatch)
    _, ref = _poison_bundle("jax", model, tmp_path / "jax", monkeypatch)
    assert sorted(ours) == sorted(ref)
    assert ours["reason"] == ref["reason"] == "poison"
    assert list(ours["requests"]) == list(ref["requests"]) == ["poison-0"]
    # the faults land at other points of the two timelines (the JAX
    # sampler's decode_dispatch site): their shape is compared, not the order
    for bundle in (ours, ref):
        tl = bundle["requests"]["poison-0"]
        assert tl[0]["event"] == "QUEUED" and tl[-1]["event"] == "FINISHED"
        assert tl[-1]["detail"]["cause"] == "abort"
        assert {"FAULT", "SALVAGED"} <= {e["event"] for e in tl}
    assert ours["engine"] == ref["engine"]
    assert _keys(ours["rings"]) == _keys(ref["rings"])
    assert path.name.startswith(f"flight-poison-{os.getpid()}-1-")


def test_port_bundle_loads_through_the_jax_replay_extractor(model, tmp_path, monkeypatch):
    from tpuserve.replay.extract import load_bundle, workload_from_bundle
    path, _ = _poison_bundle("port", model, tmp_path, monkeypatch)
    bundle = load_bundle(str(path))
    wl = workload_from_bundle(bundle)
    assert [(r.request_id, r.prompt_tokens, r.max_tokens) for r in wl.requests] == \
        [("poison-0", 3, 12)]
    assert wl.meta["source_schema"] == 2 and wl.meta["source_reason"] == "poison"
    # an on-demand dump of a healthy engine replays whole
    eng = _engine("port", model)
    _drive("port", eng, "main")
    wl = workload_from_bundle(json.loads(json.dumps(eng.flight.dump_bundle("on_demand"))))
    assert len(wl.requests) == len(PROMPTS)


def test_postmortem_cap_and_failed_writes_leave_the_count_true(tmp_path):
    fr = port_flight.FlightRecorder(enabled=True, dirpath=str(tmp_path))
    fr.req_event("r", "QUEUED")
    for _ in range(port_flight.MAX_POSTMORTEMS + 3):
        fr.postmortem("fault_storm")
    assert fr.postmortems == port_flight.MAX_POSTMORTEMS
    assert len(list(tmp_path.glob("flight-fault_storm-*.json"))) == port_flight.MAX_POSTMORTEMS
    blocked = tmp_path / "file"
    blocked.write_text("x")
    bad = port_flight.FlightRecorder(enabled=True, dirpath=str(blocked / "sub"))
    assert bad.postmortem("poison") is None and bad.postmortems == 0
