"""The port's device profiler (``runtime/devprof.py``) on the CPU, against
the JAX package's.

On the CPU there are no CUDA events: a sync kind's seconds are the host
seconds blocked in it, as in the JAX profiler, and a ladder entry's
capture wall is the time its executable took to make.  The JAX
``tests/test_devprof.py`` cases run on the port's server and engine
(float32 tiny-qwen3, the JAX engine's weights): step records carry ``dev``
deltas, the ladder has one entry per executable and a warm re-serve adds
hits but no entry, ``compile_caches`` reads it, the HBM watermark
reconciles the cache and the weights, ``/debug/profile`` writes a
``torch.profiler`` trace that the dump names, a capture racing another
gets 409, the profiler off leaves tokens unchanged and records nothing,
``TPUSERVE_DEVPROF`` resolves as the JAX flag, and an interleaved on/off
run gives the same tokens (its tok/s are read on the card, in
``chip_smoke.py``, not gated on a shared CPU).  Against the JAX package:
the same call sequence, on a clock both modules read, gives both
profilers the same report; the report's, the ladder rows' and the HBM
section's keys are the JAX ones; the engines' tokens with the profiler on
and off equal the JAX engine's; a port bundle carries a ``devprof`` section
with the JAX bundle's keys and loads through the JAX replay extractor.
"""

import dataclasses
import json
import os
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve.runtime import devprof as jax_devprof
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import param_nbytes, params_from_numpy
from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SamplingParams
from tpuserve_torch.runtime import SchedulerConfig
from tpuserve_torch.runtime import devprof as port_devprof
from tpuserve_torch.server import OpenAIServer, ServerConfig
from tpuserve_torch.server import tracing

CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16, dtype="float32")
SCHED = dict(max_num_seqs=8, min_prefill_bucket=8, min_decode_bucket=2)
GREEDY = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [40, 41, 42, 43, 44, 45, 46, 47, 48]]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(fp32_tiny_qwen3):
    jparams = jax_weights.init_params(fp32_tiny_qwen3, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    return fp32_tiny_qwen3, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _port(model, **kw):
    _, _, cfg, params = model
    return Engine(EngineConfig(model="tiny-qwen3", cache=CacheConfig(**CACHE),
                               scheduler=SchedulerConfig(**SCHED),
                               **dict(dict(multi_step=4, seed=0), **kw)),
                  params=params, model_cfg=cfg, device="cpu")


def _jax(model, **kw):
    jcfg, jparams, _, _ = model
    return jax_rt.Engine(jax_rt.EngineConfig(
        model="tiny-qwen3", cache=jax_rt.CacheConfig(**CACHE),
        scheduler=jax_rt.SchedulerConfig(**SCHED), attn_impl="reference",
        **dict(dict(multi_step=4, seed=0, pipeline_decode=False), **kw)),
        params=jparams, model_cfg=jcfg)


@pytest.fixture(scope="module")
def server(model, tmp_path_factory):
    flight_dir = str(tmp_path_factory.mktemp("devprof-flight"))
    old = os.environ.get("TPUSERVE_FLIGHT_DIR")
    os.environ["TPUSERVE_FLIGHT_DIR"] = flight_dir
    try:
        eng = _port(model)
        srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0))
        url = f"http://127.0.0.1:{srv.start()}"
        yield srv, url, flight_dir, eng
        srv.shutdown()
    finally:
        if old is None:
            os.environ.pop("TPUSERVE_FLIGHT_DIR", None)
        else:
            os.environ["TPUSERVE_FLIGHT_DIR"] = old


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, data=b""):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _serve_one(url, prompt="devprof", max_tokens=6):
    req = urllib.request.Request(
        url + "/v1/completions", method="POST",
        data=json.dumps({"prompt": prompt, "max_tokens": max_tokens, "temperature": 0,
                         "ignore_eos": True}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _keys(x):
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_keys(x[0])] if x and isinstance(x[0], (dict, list)) else []
    return None


# ---- the profiler's units against the JAX profiler ------------------------

def test_the_same_calls_give_the_jax_profilers_report(monkeypatch):
    """One call sequence on both profilers, with both modules' clock a
    counter that ticks 1 ms a read: the reports are equal."""
    ticks = {"t": 0.0}

    def clock():
        ticks["t"] += 0.001
        return ticks["t"]
    for mod in (port_devprof, jax_devprof):
        monkeypatch.setattr(mod.time, "perf_counter", clock)
    profs = [port_devprof.DeviceProfiler(enabled=True), jax_devprof.DeviceProfiler(enabled=True)]
    deltas = [[], []]
    for i, dp in enumerate(profs):
        ticks["t"] = 0.0
        dp.set_model_hints(act_bytes_per_token=96)
        key = ((4, 16),)                       # the JAX key shape (dims first)
        for step in range(5):
            dp.bump_cycle()
            with dp.dispatch("decode", key):
                pass
            with dp.sync("window"):
                pass
            if step % 2:
                with dp.dispatch("prefill", ((1, 32),)):
                    pass
                with dp.sync("sample"):
                    pass
            deltas[i].append(dp.step_delta())
        dp.set_hbm(weights=1000, kv_reserved=4096, limit=1 << 20, num_blocks=64,
                   block_bytes=64, in_use=6000)
        for n in range(20):
            dp.note_capture(f"/t/{n}", "manual", 0.5)
    ours, ref = (dp.report() for dp in profs)
    # the port's ladder key is its executable key; the JAX one is its shape
    assert [r["bucket"] for r in ours["ladder"]["executables"]] == \
        [r["bucket"] for r in ref["ladder"]["executables"]]
    assert ours == ref and deltas[0] == deltas[1]
    assert ours["hbm"]["other_bytes"] == 904 and len(ours["captures"]) == 16


def test_the_removed_profiler_is_the_shared_noop():
    dp = port_devprof.DeviceProfiler(enabled=False, cuda=True)
    assert not dp.cuda
    assert dp.dispatch("decode", ("decode", 4, "greedy")) is port_devprof._NOOP
    assert dp.sync("window") is port_devprof._NOOP
    dp.note_executable(("decode", 4, "greedy"), 1.0)
    dp.bump_cycle()
    assert dp.cycles == 0 and not dp.ladder and dp.step_delta() is None


def test_env_flag_resolution(monkeypatch):
    """TPUSERVE_DEVPROF is --no-devprof's env twin, as the JAX flag: default
    on, 0 off, the config's value over the env."""
    for mod in (port_devprof, jax_devprof):
        monkeypatch.delenv("TPUSERVE_DEVPROF", raising=False)
        assert mod.DeviceProfiler().enabled
        monkeypatch.setenv("TPUSERVE_DEVPROF", "0")
        assert not mod.DeviceProfiler().enabled
        assert mod.DeviceProfiler(enabled=True).enabled
        monkeypatch.setenv("TPUSERVE_DEVPROF", "1")
        assert not mod.DeviceProfiler(enabled=False).enabled


# ---- the server (the JAX tests/test_devprof.py cases) ---------------------

def test_step_records_carry_device_attribution(server):
    srv, url, _, eng = server
    _serve_one(url)
    status, snap = _get(url + "/debug/engine")
    assert status == 200
    devs = [s["dev"] for s in snap["steps"] if s.get("dev")]
    assert devs and any(d.get("device_ms", 0) > 0 for d in devs)
    dp = snap["devprof"]
    assert dp["enabled"] and dp["cycles"] > 0 and dp["device_ms_per_cycle"] >= 0
    assert {"prefill", "decode_multi"} <= set(dp["dispatch"])
    assert "window" in dp["device"] and "sample" in dp["device"]
    assert dp["hbm"]["limit_bytes"] == 1 << 30


def test_ladder_registry_correctness(server):
    srv, url, _, eng = server
    _serve_one(url)
    dp = eng.devprof
    # one entry an executable, made once each
    assert dp.compiles == len(dp.ladder) == len(eng.graphs.executables) > 0
    assert dp.compile_s > 0
    compiles = dp.compiles
    hits = sum(ent[1] for ent in dp.ladder.values())
    _serve_one(url)                          # the same shapes: warm
    assert dp.compiles == compiles
    assert sum(ent[1] for ent in dp.ladder.values()) > hits
    snap = dp.ladder_snapshot()
    assert snap["retained"] == len(dp.ladder) and snap["truncated"] == 0
    rows = snap["executables"]
    hit_counts = [r["hits"] for r in rows]
    assert hit_counts == sorted(hit_counts, reverse=True)
    assert {r["kind"] for r in rows} <= {"prefill", "prefill_chunk", "decode", "decode_multi",
                                         "verify", "verify_sampled", "draft", "mixed",
                                         "sample"}
    assert all(r["compile_ms"] > 0 for r in rows) and any(r["est_bytes"] > 0 for r in rows)


def test_debug_engine_surfaces_compile_cache_stats(server):
    srv, url, _, eng = server
    _serve_one(url)
    _, snap = _get(url + "/debug/engine")
    caches = snap["compile_caches"]
    assert set(caches) == {"fsm", "ladder"}
    lad = caches["ladder"]
    assert lad["tracked"] is True and lad["hits"] > 0 and lad["compile_ms"] > 0
    assert lad["size"] == len(eng.devprof.ladder) == len(eng.graphs.executables)


def test_hbm_watermark_reconciles_the_cache_and_the_weights(server):
    srv, url, _, eng = server
    hbm = eng.devprof.hbm_snapshot()
    kv = sum(t.numel() * t.element_size() for layer in eng.kv_cache for t in layer.values())
    assert hbm["kv_reserved_bytes"] == kv
    assert hbm["num_blocks"] * hbm["block_bytes"] == kv
    assert hbm["num_blocks"] == eng.config.cache.num_blocks
    assert hbm["weights_bytes"] == param_nbytes(eng.params)
    assert hbm["other_bytes"] == 0                 # the CPU records zeros
    assert hbm["headroom_bytes"] == hbm["limit_bytes"] - hbm["weights_bytes"] - kv
    assert hbm["limit_bytes"] == eng._device_hbm_limit()
    ref = jax_devprof.DeviceProfiler(enabled=True)
    ref.set_hbm(weights=1, kv_reserved=1, limit=4, num_blocks=1, block_bytes=1)
    assert set(hbm) == set(ref.hbm_snapshot())


def test_hbm_other_counted_apart_is_not_a_remainder():
    # the engine counts the bytes beyond weights and KV on their own (the
    # allocator's), so a miscounted weight or KV part shows in the sum
    dp = port_devprof.DeviceProfiler(enabled=True)
    dp.set_hbm(weights=1000, kv_reserved=4096, limit=1 << 20, num_blocks=64,
               block_bytes=64, in_use=6000, other=300)
    hbm = dp.hbm_snapshot()
    assert hbm["other_bytes"] == 300
    assert hbm["headroom_bytes"] == (1 << 20) - 1000 - 4096 - 300


def test_graphs_device_bytes_count_their_buffers(server):
    _, _, _, eng = server
    assert eng.graphs.pool is None                 # no capture on the CPU
    counts, bias, floor = eng.graphs.sampling_buffers()
    assert eng.graphs.device_bytes() == 3 * counts.numel() * 4


def test_profile_capture_writes_a_trace_the_dump_names(server):
    srv, url, flight_dir, eng = server
    status, out = _post(url + "/debug/profile?seconds=0.2")
    assert status == 200 and out["reason"] == "manual" and out["seconds"] == 0.2
    assert out["trace_dir"].startswith(flight_dir)
    trace = json.load(open(out["trace"]))
    assert "traceEvents" in trace
    assert eng.devprof.captures_total >= 1
    _, bundle = _get(url + "/debug/engine/dump")
    assert any(c["trace_dir"] == out["trace_dir"] and c["reason"] == "manual"
               for c in bundle["devprof"]["captures"])
    assert _metric(url, 'tpuserve_profile_captures_total{model_name="tiny-qwen3"}') >= 1


def _get_text(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read().decode()


def _metric(url, series: str, timeout_s: float = 10.0) -> float:
    """A series' value on /metrics, polled until the runner's idle tick has
    exported something for it (0.0 if it never does)."""
    deadline = time.monotonic() + timeout_s
    value = 0.0
    while time.monotonic() < deadline:
        _, text = _get_text(url + "/metrics")
        for ln in text.splitlines():
            if ln.startswith(series + " "):
                value = float(ln.split()[-1])
        if value:
            return value
        time.sleep(0.05)
    return value


def test_profile_capture_busy_is_409(server):
    srv, url, _, _ = server
    assert tracing._capture_lock.acquire(blocking=False)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                url + "/debug/profile?seconds=0.1", data=b"", method="POST"), timeout=60)
        assert ei.value.code == 409
    finally:
        tracing._capture_lock.release()


def test_metrics_export_the_device_families(server):
    srv, url, _, eng = server
    _serve_one(url)
    assert _metric(url, 'tpuserve_executables_retained{model_name="tiny-qwen3"}') == \
        len(eng.devprof.ladder)
    _, text = _get_text(url + "/metrics")
    for line in ('tpuserve_device_seconds_total{kind="window",model_name="tiny-qwen3"}',
                 'tpuserve_hbm_bytes{kind="kv",model_name="tiny-qwen3"}',
                 'tpuserve_executables_retained{model_name="tiny-qwen3"}',
                 'tpuserve_executable_compiles_total{model_name="tiny-qwen3"}'):
        assert line in text, line


# ---- the engine against the JAX engine ------------------------------------

def test_devprof_off_is_removed_and_tokens_are_unchanged(model):
    on, off = _port(model, devprof=True), _port(model, devprof=False)
    on_toks = [r.output_token_ids for r in on.generate(PROMPTS, SamplingParams(**GREEDY))]
    assert not off.devprof.enabled and off.flight.devprof is None
    off_toks = [r.output_token_ids for r in off.generate(PROMPTS, SamplingParams(**GREEDY))]
    ref = [r.output_token_ids
           for r in _jax(model).generate(PROMPTS, jax_rt.SamplingParams(**GREEDY))]
    assert on_toks == off_toks == ref
    assert off.devprof.cycles == 0 and not off.devprof.ladder
    snap = off.flight.engine_snapshot()
    assert "devprof" not in snap and all("dev" not in s for s in snap["steps"])
    assert on.devprof.cycles > 0 and on.devprof.ladder
    assert all("dev" in s for s in on.flight.engine_snapshot()["steps"]
               if s["kind"] in ("prefill", "window"))


def test_interleaved_on_off_rounds_give_the_same_tokens(model):
    """The on/off A/B of the JAX overhead guard, on one warm engine with the
    profiler switched into its removed state a round: the same tokens each
    round (the rates are read on the card)."""
    eng = _port(model, multi_step=8)
    prompts = [[int(x) for x in np.random.default_rng(7).integers(1, 500, size=8)]
               for _ in range(16)]
    sp = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
    first = [r.output_token_ids for r in eng.generate(prompts, sp)]
    cycles = []
    for enabled in (True, False, True, False):
        eng.devprof.enabled = enabled
        eng.flight.devprof = eng.devprof if enabled else None
        before = eng.devprof.cycles
        assert [r.output_token_ids for r in eng.generate(prompts, sp)] == first
        cycles.append(eng.devprof.cycles - before)
    assert cycles[0] > 0 and cycles[1] == 0 and cycles[2] == cycles[0] and cycles[3] == 0


def test_the_bundle_carries_the_jax_devprof_section(model):
    from tpuserve.replay.extract import workload_from_bundle
    ours, ref = _port(model), _jax(model)
    ours.generate(PROMPTS, SamplingParams(**GREEDY))
    ref.generate(PROMPTS, jax_rt.SamplingParams(**GREEDY))
    b_ours = json.loads(json.dumps(ours.flight.dump_bundle("on_demand")))
    b_ref = json.loads(json.dumps(ref.flight.dump_bundle("on_demand")))
    assert _keys(b_ours["devprof"]) == _keys(b_ref["devprof"])
    assert set(b_ours["devprof"]["device"]) == set(b_ref["devprof"]["device"])
    assert all("dev" in s for s in b_ours["steps"])
    assert {k for s in b_ours["steps"] for k in s["dev"]} <= {"device_ms", "dispatch_ms",
                                                              "compiles"}
    wl = workload_from_bundle(b_ours)
    assert len(wl.requests) == len(PROMPTS)
