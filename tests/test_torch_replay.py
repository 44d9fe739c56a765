"""Trace replay and the alert backtest in the port, on the CPU, against the
JAX package.

Every engine either harness builds here is patched to the same seeded
float32 tiny-qwen3 weights with a float32 KV cache and the plain attention,
on the CPU (``_fp32_engines``), so both packages replay one model.  Then:

- the same ``Workload`` synthesizes the same prompt ids, and round-trips
  through either package's file format;
- the same flight bundle (a replay's own capture, hand-built recorder
  bundles with faults, truncation and a legacy schema, a two-engine dump,
  and a real fault-storm post-mortem of the port's runner) extracts to
  the same workload in both packages;
- a greedy workload replays through both harnesses to equal token
  streams, outcomes, counters and SLI summaries (exact: both run under a
  ``VirtualClock`` and the same cycles);
- a fault-storm post-mortem replays to equal outcome counts (its
  timeline may differ: the port's sampler is no fault site, so a one-shot
  decode rule fires one step later there);
- the port's determinism pin: two replays with equal digests;
- ``backtest`` gives the JAX alert timeline, twice.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from tpuserve import replay as jax_replay
from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve.obs import backtest as jax_backtest
from tpuserve.obs.burnrate import BurnWindow as JaxBurnWindow
from tpuserve.runtime import flight as jax_flight
from tpuserve_torch import replay as port_replay
from tpuserve_torch import runtime as port_rt
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.obs import backtest as port_backtest
from tpuserve_torch.obs.burnrate import BurnWindow
from tpuserve_torch.runtime import flight as port_flight
from tpuserve_torch.server.runner import AsyncEngineRunner

PACKAGES = {"port": port_replay, "jax": jax_replay}
CLASSES = ("interactive", "standard", "batch")


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
    monkeypatch.setenv("TPUSERVE_DEVPROF", "0")


@pytest.fixture(scope="module")
def fp32(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module", autouse=True)
def _fp32_engines(fp32):
    """Both harnesses' engines on the shared float32 weights and cache: the
    harnesses import ``Engine`` from their package's ``runtime`` at call
    time, so patching the attribute reaches them."""
    jcfg, jparams, cfg, shared = fp32
    jax_engine, port_engine = jax_rt.Engine, port_rt.Engine

    def fp32_conf(conf):
        return dataclasses.replace(conf, attn_impl="reference",
                                   cache=dataclasses.replace(conf.cache, dtype="float32"))

    def make_jax(conf, **kw):
        return jax_engine(fp32_conf(conf), params=jparams, model_cfg=jcfg)

    def make_port(conf, params=None, device="cuda", **kw):
        return port_engine(fp32_conf(conf), params=params if params is not None else shared,
                           model_cfg=cfg, device=device)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_rt, "Engine", make_jax)
    mp.setattr(port_rt, "Engine", make_port)
    yield
    mp.undo()


def _requests(pkg, n=6, span_s=75.0, prefix_group=None, max_tokens=4,
              prompt_tokens=6, classes=True):
    wr = PACKAGES[pkg].WorkloadRequest
    return [wr(request_id=f"wl-{i}",
               arrival_s=round(i * span_s / max(1, n - 1), 3) if n > 1 else 0.0,
               prompt_tokens=prompt_tokens + (i % 3), max_tokens=max_tokens,
               slo_class=CLASSES[i % 3] if classes else "standard", seed=i,
               prefix_group=prefix_group if prefix_group and i % 2 else None,
               prefix_tokens=4 if prefix_group and i % 2 else 0)
            for i in range(n)]


def _workload(pkg, seed=5, faults=None, **kw):
    return PACKAGES[pkg].Workload(requests=_requests(pkg, **kw), seed=seed, faults=faults)


def _port_opts(**kw):
    return port_replay.ReplayOptions(device="cpu", **kw)


# ---------------------------------------------------------------------------
# workload files: prompt ids and the schema (no engines)
# ---------------------------------------------------------------------------

ID_CASES = {
    "synthesized": dict(prompt_tokens=12),
    "prefix_group": dict(prompt_tokens=20, prefix_group="conv-a", prefix_tokens=9),
    "prefix_longer_than_prompt": dict(prompt_tokens=5, prefix_group="conv-b",
                                      prefix_tokens=40),
    "recorded_in_vocab": dict(prompt_tokens=4, prompt_token_ids=[3, 9, 27, 81]),
    "recorded_out_of_vocab": dict(prompt_tokens=5,
                                  prompt_token_ids=[0, 510, 511, 100000, -3]),
}


@pytest.mark.parametrize("vocab", [512, 151936])
@pytest.mark.parametrize("case", sorted(ID_CASES))
def test_prompt_ids_equal_jax(case, vocab):
    """The same workload request synthesizes the same prompt ids in both
    packages (sha256-seeded ``random.Random``, not the process hash)."""
    ids = {}
    for pkg, mod in PACKAGES.items():
        wl = mod.Workload(requests=[mod.WorkloadRequest(
            request_id="req-7", arrival_s=0.0, max_tokens=4, **ID_CASES[case])], seed=13)
        ids[pkg] = wl.prompt_ids(wl.requests[0], vocab)
    assert ids["port"] == ids["jax"]
    assert all(1 <= t <= vocab - 2 for t in ids["port"])


def test_workload_files_cross_load():
    """A workload written by either package loads in the other to the same
    requests, summary and file."""
    wl = _workload("port", faults="decode_dispatch:raise:1.0:count=1,seed=5",
                   prefix_group="conv")
    wl.meta["source_engine"] = {"max_num_seqs": 4}
    jwl = jax_replay.Workload.from_dict(json.loads(json.dumps(wl.as_dict())))
    assert jwl.as_dict() == wl.as_dict()
    back = port_replay.Workload.from_dict(json.loads(json.dumps(jwl.as_dict())))
    assert back.as_dict() == wl.as_dict()
    assert back.summary() == jwl.summary()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_workload_schema_guards(pkg):
    mod = PACKAGES[pkg]
    data = _workload(pkg, n=2).as_dict()
    with pytest.raises(ValueError, match="not a replay workload"):
        mod.Workload.from_dict({"kind": "something-else"})
    with pytest.raises(ValueError, match="schema_version"):
        mod.Workload.from_dict({k: v for k, v in data.items() if k != "schema_version"})
    with pytest.raises(ValueError, match="newer"):
        mod.Workload.from_dict(dict(data, schema_version=99))
    with pytest.raises(ValueError, match="request_id"):
        mod.Workload.from_dict(dict(data, requests=[{"arrival_s": 0.0}]))


# ---------------------------------------------------------------------------
# extraction: the same bundle gives the same workload
# ---------------------------------------------------------------------------

def _recorder_bundle(kind: str) -> dict:
    """A hand-built bundle from the port's recorder (the JAX extractor reads
    the port's bundles, tests/test_torch_flight.py)."""
    fr = port_flight.FlightRecorder(enabled=True, events=8 if kind == "truncated" else 256,
                                    steps=16)
    if kind == "truncated":
        for i in range(12):                      # overflow the 8-slot ring
            fr.req_event(f"r{i}", "QUEUED", slo_class="standard", prompt_tokens=4,
                         max_tokens=2)
        fr.req_event("r0", "FINISHED", cause="length", output_tokens=2)
        return fr.dump_bundle("test")
    fr.req_event("r1", "QUEUED", slo_class="interactive", prompt_tokens=7, max_tokens=5)
    fr.req_event("r1", "FAULT", site="decode_dispatch", mode="raise")
    fr.req_event("r1", "FAULT", site="decode_dispatch", mode="raise")
    fr.req_event("r1", "FINISHED", cause="length", output_tokens=5)
    fr.req_event("r2", "QUEUED", slo_class="batch", prompt_tokens=9, max_tokens=3)
    fr.req_event("r2", "FAULT", site="prefill_dispatch", mode="hang")
    fr.req_event("r2", "FAULT", site="decode_dispatch", mode="delay")
    fr.req_event("r3", "SHED", slo_class="batch", prompt_tokens=11)
    fr.note_step("prefill", 2, 16, 16, 0.0035)
    fr.note_step("decode", 2, 2, 2, 0.0015)
    bundle = fr.dump_bundle("test")
    if kind == "legacy":
        bundle = {k: v for k, v in bundle.items() if k not in ("schema", "rings", "engine")}
    elif kind == "two_engines":
        other = port_flight.FlightRecorder(enabled=True, events=64, steps=16)
        other.req_event("r1", "ADMITTED", slot=0)
        other.req_event("r9", "QUEUED", slo_class="standard", prompt_tokens=3, max_tokens=2)
        bundle = {"engines": [bundle, other.dump_bundle("test")]}
    return bundle


@pytest.mark.parametrize("kind", ["faults", "legacy", "truncated", "two_engines"])
def test_extract_recorder_bundle_equals_jax(kind):
    bundle = _recorder_bundle(kind)
    port = port_replay.workload_from_bundle(json.loads(json.dumps(bundle)), seed=3)
    jax_wl = jax_replay.workload_from_bundle(json.loads(json.dumps(bundle)), seed=3)
    assert port.as_dict() == jax_wl.as_dict()
    if kind == "faults":
        # the hang is re-armed as a raise, the delay dropped, both noted
        assert port.faults.startswith("decode_dispatch:raise:1.0:count=2:match=r1")
        assert port.meta["fault_hangs_as_raise"] == 1
        assert port.meta["fault_delays_dropped"] == 1
        assert {r.request_id: r.source_outcome for r in port.requests} == {
            "r1": "length", "r2": "unfinished", "r3": "shed"}
    if kind == "truncated":
        assert port.meta["truncated"] and port.meta["partial_requests"] >= 1


def test_extract_schema_guards():
    bundle = _recorder_bundle("faults")
    with pytest.raises(ValueError, match="newer"):
        port_replay.workload_from_bundle(
            dict(bundle, schema=port_flight.FLIGHT_SCHEMA_VERSION + 1))
    with pytest.raises(ValueError, match="already a workload"):
        port_replay.workload_from_bundle(_workload("port").as_dict())
    with pytest.raises(ValueError, match="not a flight bundle"):
        port_replay.workload_from_bundle({"steps": []})
    assert port_flight.FLIGHT_SCHEMA_VERSION == jax_flight.FLIGHT_SCHEMA_VERSION


def test_load_bundle_merges_engines(tmp_path):
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(_recorder_bundle("two_engines")))
    merged = port_replay.load_bundle(str(path))
    assert merged == jax_replay.load_bundle(str(path))
    events = merged["requests"]["r1"]
    assert "ADMITTED" in [e["event"] for e in events] and "r9" in merged["requests"]
    assert [e["t"] for e in events] == sorted(e["t"] for e in events)


# ---------------------------------------------------------------------------
# replay against the JAX harness
# ---------------------------------------------------------------------------

def _replay_both(jax_wl, port_wl, **opts):
    rj = jax_replay.replay(jax_wl, jax_replay.ReplayOptions(**opts))
    rp = port_replay.replay(port_wl, _port_opts(**opts))
    return rj, rp


@pytest.mark.parametrize("shape", ["sparse", "overload"])
def test_greedy_replay_equals_jax(shape):
    """A greedy workload replays through both harnesses to the same token
    streams, outcomes, counters and SLI summary (so the same digests).
    "overload" packs 12 requests onto 2 seats in one virtual second, so
    class admission order and the brownout estimator run too."""
    kw = (dict(n=8, span_s=7.0, prefix_group="conv", max_tokens=6) if shape == "sparse"
          else dict(n=12, span_s=1.0, max_tokens=8, prompt_tokens=10))
    opts = dict(max_num_seqs=2) if shape == "overload" else {}
    rj, rp = _replay_both(_workload("jax", **kw), _workload("port", **kw), **opts)
    assert any(rp["token_streams"].values())
    assert rp["token_streams"] == rj["token_streams"]
    assert rp["outcomes"] == rj["outcomes"]
    assert rp["counters"] == rj["counters"]
    assert rp["sli"] == rj["sli"]
    assert (rp["token_digest"], rp["sli_digest"]) == (rj["token_digest"], rj["sli_digest"])
    assert (rp["virtual_s"], rp["step_time_s"]) == (rj["virtual_s"], rj["step_time_s"])
    assert rp["workload"] == rj["workload"]
    if shape == "overload":
        assert rp["counters"]["engine_steps"] > 12


def test_replay_determinism_pin():
    """Same workload + same seed => identical token streams and SLI summary
    across two fresh port engines, with a fault rule armed and a shared
    prefix in the mix, the sparse 75 s span replaying >= 10x faster than
    the incident's."""
    wl = _workload("port", faults="decode_dispatch:raise:1.0:count=1:match=wl-3,seed=5",
                   prefix_group="conv")
    r1 = port_replay.replay(wl, _port_opts())
    r2 = port_replay.replay(wl, _port_opts())
    assert (r1["token_digest"], r1["sli_digest"]) == (r2["token_digest"], r2["sli_digest"])
    assert r1["token_streams"] == r2["token_streams"]
    assert any(r1["token_streams"].values())
    assert r1["counters"]["salvage_rounds"] == r2["counters"]["salvage_rounds"] >= 1
    assert set(r1["outcomes"]) == {r.request_id for r in wl.requests}
    assert set(r1["outcomes"].values()) == {"length"}
    assert r1["speedup"] >= 10, (r1["virtual_s"], r1["wall_s"])
    for cls in CLASSES:
        assert r1["sli"][cls]["ttft"]["n"] >= 1 and r1["sli"][cls]["e2e"]["n"] >= 1


def test_replay_engine_takes_the_given_params_and_sizing():
    """``ReplayOptions.params`` is the tree the engine serves (made once,
    not drawn again); sizing follows the options, then the source facts."""
    from tpuserve_torch.models.weights import init_params
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    tree = init_params(cfg, 1, "cpu")
    wl = _workload("port", n=2, span_s=1.0)
    wl.meta["source_engine"] = {"max_num_seqs": 3, "block_size": 8, "multi_step": 4}
    eng, clock = port_replay.build_replay_engine(wl, _port_opts(params=tree))
    assert eng.params is tree and eng.device.type == "cpu"
    assert eng.cache_cfg.block_size == 8 and eng.scheduler.cfg.max_num_seqs == 3
    assert eng._multi_step == 4 and eng.clock is clock
    eng, _ = port_replay.build_replay_engine(wl, _port_opts(block_size=32, max_num_seqs=2))
    assert eng.cache_cfg.block_size == 32 and eng.scheduler.cfg.max_num_seqs == 2


def test_replay_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_replay.replay(_workload("port", n=1), port_replay.ReplayOptions())


def test_bundle_roundtrip_extract_and_diff(tmp_path):
    """A port replay captures its own bundle; both packages extract it to
    the same workload, whose replay diffs against the bundle's SLIs."""
    src = _workload("port", n=4, span_s=30.0, seed=7)
    path = str(tmp_path / "bundle.json")
    r_src = port_replay.replay(src, _port_opts(dump_bundle_path=path))
    with open(path) as f:
        bundle = json.load(f)
    assert bundle["schema"] == port_flight.FLIGHT_SCHEMA_VERSION
    assert bundle["rings"]["events"]["dropped"] == 0
    wl = port_replay.workload_from_bundle(bundle, seed=7)
    assert wl.as_dict() == jax_replay.workload_from_bundle(bundle, seed=7).as_dict()
    by_id = {r.request_id: r for r in wl.requests}
    for r in src.requests:
        got = by_id[r.request_id]
        assert (got.prompt_tokens, got.max_tokens, got.slo_class, got.source_outcome) == (
            r.prompt_tokens, r.max_tokens, r.slo_class, "length")
        assert abs(got.arrival_s - r.arrival_s) <= 2 * r_src["step_time_s"] + 1e-6
    rep = port_replay.replay(wl, _port_opts())
    diff = port_replay.diff_report(rep, wl)
    for cls in CLASSES:
        e = diff["sli"][cls]["ttft"]
        assert e["source"] and e["replay"] and "ratio_p50" in e
    assert diff["replay_outcomes"] == diff["source_outcomes"] == {"length": 4}
    text = port_replay.render_diff(diff)
    assert "replay vs source incident" in text and "source outcomes" in text
    jdiff = jax_replay.diff_report(rep, jax_replay.Workload.from_dict(wl.as_dict()))
    assert {k: v for k, v in jdiff.items() if k != "replay"} == \
        {k: v for k, v in diff.items() if k != "replay"}


@pytest.fixture(scope="module")
def storm_bundle(fp32, tmp_path_factory):
    """A real fault-storm post-mortem of the port's runner: every decode
    dispatch raises, the storm fallback fails the clients and dumps."""
    jcfg, jparams, cfg, params = fp32
    flight_dir = tmp_path_factory.mktemp("storm")
    old = os.environ.get("TPUSERVE_FLIGHT_DIR")
    os.environ["TPUSERVE_FLIGHT_DIR"] = str(flight_dir)
    eng = port_rt.Engine(port_rt.EngineConfig(
        model="tiny-qwen3",
        cache=port_rt.CacheConfig(block_size=4, num_blocks=64, max_blocks_per_seq=16),
        scheduler=port_rt.SchedulerConfig(max_num_seqs=4, min_prefill_bucket=8,
                                          min_decode_bucket=2),
        faults="decode_dispatch:raise:1.0:count=40", seed=0), params=params, device="cpu")
    runner = AsyncEngineRunner(eng)
    runner.MAX_FAULTS_PER_WINDOW = 3
    runner.start()
    try:
        sp = port_rt.SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
        subs = [runner.submit(prompt_token_ids=[3 + i, 4, 5], params=sp,
                              request_id=f"storm-{i}") for i in range(4)]
        failures = 0
        for _, q in subs:
            while True:
                item = q.get(timeout=120)
                if item is None:
                    break
                failures += isinstance(item, Exception)
    finally:
        runner.shutdown()
        if old is None:
            os.environ.pop("TPUSERVE_FLIGHT_DIR", None)
        else:
            os.environ["TPUSERVE_FLIGHT_DIR"] = old
    assert failures >= 1
    dumps = sorted(f for f in os.listdir(flight_dir) if f.startswith("flight-fault_storm"))
    assert dumps, "the storm wrote no post-mortem"
    with open(flight_dir / dumps[0]) as f:
        return json.load(f)


def test_fault_storm_postmortem_replays_to_jax_outcomes(storm_bundle):
    """The post-mortem extracts to the same workload in both packages; its
    fault schedule re-fires and is salvaged through; both harnesses end
    every request in the same terminal state, and the port twice alike."""
    wl = port_replay.workload_from_bundle(storm_bundle, seed=3)
    jwl = jax_replay.workload_from_bundle(storm_bundle, seed=3)
    assert wl.as_dict() == jwl.as_dict()
    assert wl.faults and "decode_dispatch:raise" in wl.faults
    storm = {r.request_id for r in wl.requests if r.request_id.startswith("storm-")}
    assert storm == {f"storm-{i}" for i in range(4)}
    rj = jax_replay.replay(jwl, jax_replay.ReplayOptions())
    r1 = port_replay.replay(wl, _port_opts())
    r2 = port_replay.replay(wl, _port_opts())
    assert (r1["token_digest"], r1["sli_digest"]) == (r2["token_digest"], r2["sli_digest"])
    assert r1["counters"]["salvage_rounds"] >= 1 and not r1["aborted"]
    assert set(r1["outcomes"]) >= storm
    diff, jdiff = port_replay.diff_report(r1, wl), jax_replay.diff_report(rj, jwl)
    assert diff["replay_outcomes"] == jdiff["replay_outcomes"]
    assert diff["source_outcomes"] == jdiff["source_outcomes"]
    assert r1["outcomes"] == rj["outcomes"]


# ---------------------------------------------------------------------------
# the alert backtest
# ---------------------------------------------------------------------------

def _backtest(pkg):
    classes = CLASSES
    if pkg == "port":
        mod, run, win, opts = port_replay, port_backtest, BurnWindow, _port_opts
    else:
        mod, run, win, opts = jax_replay, jax_backtest, JaxBurnWindow, jax_replay.ReplayOptions
    wl = mod.Workload(requests=[mod.WorkloadRequest(
        request_id=f"bt-{i}", arrival_s=i * 0.05, prompt_tokens=8, max_tokens=4,
        slo_class=classes[i % 3]) for i in range(24)], seed=11)
    return run(wl, windows=(win("fast", 10.0, 2.0, 1.0, 1.0),),
               replay_opts=opts(step_time_s=0.5, include_token_streams=False), min_events=2)


def test_backtest_equals_jax_and_is_deterministic():
    """Same workload + same objectives => the same alert firing sequence,
    byte for byte, twice in the port and as the JAX backtest fires it."""
    from tpuserve_torch.obs import DEFAULT_OBJECTIVES, objectives_digest
    from tpuserve_torch.obs.backtest import render_backtest
    r1, r2, rj = _backtest("port"), _backtest("port"), _backtest("jax")
    assert json.dumps(r1["transitions"], sort_keys=True) == \
        json.dumps(r2["transitions"], sort_keys=True)
    assert r1["firing_digest"] == r2["firing_digest"] == rj["firing_digest"]
    assert r1["transitions"] == rj["transitions"]
    assert r1["alerts_fired"] == rj["alerts_fired"] and r1["alerts_fired"]
    assert r1["unresolved"] == rj["unresolved"]
    assert r1["objectives_digest"] == rj["objectives_digest"] == \
        objectives_digest(DEFAULT_OBJECTIVES)
    assert r1["counters"] == rj["counters"]
    assert all(t["t"] <= r1["replay"]["virtual_s"] + 1e-6 for t in r1["transitions"])
    assert not r1["replay"]["aborted"]
    assert "FIRING" in render_backtest(r1)


def test_backtest_leaves_the_callers_options_alone():
    opts = _port_opts(step_time_s=0.5, include_token_streams=False)
    wl = _workload("port", n=3, span_s=1.0)
    port_backtest(wl, replay_opts=opts, min_events=2)
    assert opts.observer is None
