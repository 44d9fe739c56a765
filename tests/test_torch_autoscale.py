"""The autoscaler in the port, on the CPU, against the JAX package.

- The policy: the JAX package's signal sequences go through both
  packages' ``AutoscalePolicy`` under a ``VirtualClock`` and give the
  same decisions (equal ``decisions_digest``).
- The signals: ``signals_from_debug`` and ``signals_from_metrics`` read a
  port server's ``/debug/engine`` and ``/metrics`` (and ``scrape_replica``
  reads it over HTTP), to the signals the JAX parsers read from the same
  text.
- The reconciler and ``AutoscalerMetrics``: the same decisions applied,
  reverted on a failed apply, and exported under the JAX family names,
  types and samples.
- ``pool_replay``: the same storm through both packages' pools, each
  replica an engine on the same seeded float32 tiny-qwen3 weights, gives
  the same decisions, tokens, SLIs and counters; twice in the port alike;
  and scale-from-zero restores a warm prefix from the spill tier.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpuserve import autoscale as jax_as
from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve.runtime.clock import VirtualClock as JaxVirtualClock
from tpuserve.server.metrics import AutoscalerMetrics as JaxAutoscalerMetrics
from tpuserve_torch import autoscale as port_as
from tpuserve_torch import runtime as port_rt
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime.clock import VirtualClock
from tpuserve_torch.server import OpenAIServer, ServerConfig
from tpuserve_torch.server.metrics import AutoscalerMetrics

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"port": (port_as, VirtualClock, AutoscalerMetrics),
            "jax": (jax_as, JaxVirtualClock, JaxAutoscalerMetrics)}


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
    """Both pools' replicas on the shared float32 weights and cache: the
    pools import ``Engine`` from their package's ``runtime`` at call time,
    so patching the attribute reaches them."""
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


# ---------------------------------------------------------------------------
# the policy (no engines): the JAX package's sequences through both
# ---------------------------------------------------------------------------

def _sig(mod, t, n=1, level=0, waiting=0, running=0, delay=None, booting=0,
         pending=0, ttft_p95=None, canary=False):
    reps = [mod.ReplicaSignals(
        name=f"r{i}", brownout_level=level, waiting=waiting, running=running,
        queue_delay_ewma={"interactive": delay} if delay is not None else {},
        sli=({"interactive": {"ttft": {"n": 9, "p50": ttft_p95 / 2, "p95": ttft_p95}}}
             if ttft_p95 is not None else {})) for i in range(n)]
    return mod.PoolSignals(t=t, replicas=reps, booting=booting, pending_demand=pending,
                           canary_breached=canary)


def _policy(mod, clock, **kw):
    base = dict(min_replicas=0, max_replicas=4, brownout_out_level=1,
                queue_delay_out_s=0.5, scale_out_cooldown_s=5.0,
                scale_in_cooldown_s=10.0, idle_in_s=4.0)
    base.update(kw)
    return mod.AutoscalePolicy(mod.PolicyConfig(**base), clock=clock)


# (t, signal kwargs) sequences and policy overrides, after the JAX tests
SEQUENCES = {
    "brownout": ([(0.0, dict(running=2)), (1.0, dict(level=1, waiting=3, running=2)),
                  (1.1, dict(n=0, booting=1, pending=3))], {}),
    "queue_delay_and_ttft": ([(0.0, dict(delay=0.9, running=1)),
                              (6.0, dict(n=2, ttft_p95=3.0, running=1)),
                              (12.0, dict(n=3, running=1))], dict(ttft_p95_out_s=2.0)),
    "canary": ([(0.0, dict(canary=True, running=1)), (1.0, dict(n=2, canary=True)),
                (7.0, dict(n=2, canary=True))], {}),
    "cooldown": ([(t * 0.5, dict(n=1 + (t > 2), level=2, waiting=4, running=2))
                  for t in range(16)], {}),
    "idle_scale_in": ([(t * 0.5, dict(n=3, running=(2 if t < 4 else 0),
                                      waiting=(1 if t == 10 else 0)))
                       for t in range(60)], dict(min_replicas=1)),
    "from_zero": ([(0.0, dict(n=0, pending=2)), (0.5, dict(n=0, booting=1, pending=3)),
                   (3.0, dict(n=1, running=1))], {}),
    "storm_and_drain": ([(t, dict(n=1 + int(t > 6), level=(2 if 2 <= t <= 6 else 0),
                                  waiting=(5 if 2 <= t <= 6 else 0),
                                  running=(2 if t < 8 else 0)))
                         for t in [x * 0.5 for x in range(40)]],
                        dict(idle_in_s=2.0, scale_in_cooldown_s=3.0)),
}


def _decide(pkg, name):
    mod, clock_cls, _ = PACKAGES[pkg]
    seq, kw = SEQUENCES[name]
    clock = clock_cls()
    pol = _policy(mod, clock, **kw)
    for t, sig in seq:
        clock.advance_to(t)
        pol.decide(_sig(mod, t, **sig))
    return pol.decisions


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_policy_decisions_equal_jax(name):
    port, jax_d = _decide("port", name), _decide("jax", name)
    assert [d.as_tuple() for d in port] == [d.as_tuple() for d in jax_d]
    assert port_as.decisions_digest(port) == jax_as.decisions_digest(jax_d)
    assert port_as.decisions_digest(port) == port_as.decisions_digest(_decide("port", name))


def test_policy_scales_before_the_shedding_rungs():
    """Rising brownout scales out at L1, before the ladder sheds; a booting
    replica counts as capacity; the pool scales in only when drained."""
    seq = _decide("port", "brownout")
    assert [(d.action, d.target) for d in seq] == [("scale_out", 2)]
    actions = [d.action for d in _decide("port", "storm_and_drain")]
    assert "scale_out" in actions and "scale_in" in actions
    assert actions.index("scale_out") < actions.index("scale_in")
    assert port_as.ACTIONS == jax_as.ACTIONS


# ---------------------------------------------------------------------------
# signals: a port server read by both packages' parsers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server(fp32):
    _, _, cfg, params = fp32
    eng = port_rt.Engine(port_rt.EngineConfig(
        model="tiny-qwen3",
        cache=port_rt.CacheConfig(block_size=4, num_blocks=64, max_blocks_per_seq=16,
                                  dtype="float32"),
        scheduler=port_rt.SchedulerConfig(max_num_seqs=4, min_prefill_bucket=8,
                                          min_decode_bucket=2)),
        params=params, model_cfg=cfg, device="cpu")
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0))
    url = f"http://127.0.0.1:{srv.start()}"
    body = json.dumps({"prompt": [5, 6, 7], "max_tokens": 4, "temperature": 0,
                       "ignore_eos": True, "slo_class": "interactive"}).encode()
    for _ in range(2):
        req = urllib.request.Request(url + "/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=60).read()
    yield url
    srv.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def test_signals_from_a_port_server(server):
    debug = json.loads(_get(server + "/debug/engine"))
    port = port_as.signals_from_debug("pod-1", debug)
    jax_sig = jax_as.signals_from_debug("pod-1", debug)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_sig)
    assert port.sli["interactive"]["ttft"]["n"] == 2
    assert port.brownout_level == 0 and port.cold_start_s is not None
    text = _get(server + "/metrics").decode()
    for name in ("tpuserve_brownout_level", "vllm_num_requests_waiting",
                 "vllm_num_requests_running"):
        assert re.search(rf"^{name}\{{", text, re.M), name
    port_m = port_as.signals_from_metrics("pod-1", text)
    assert dataclasses.asdict(port_m) == \
        dataclasses.asdict(jax_as.signals_from_metrics("pod-1", text))
    scraped = port_as.scrape_replica("pod-1", server)
    assert scraped.sli == port.sli and scraped.ready
    assert port_as.scrape_replica("gone", "http://127.0.0.1:1", timeout_s=0.5) is None


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_signals_parse_scalars_and_engine_lists(pkg):
    mod = PACKAGES[pkg][0]
    payload = {"control": {"brownout_level": 2,
                           "queue_delay_ewma": {"interactive": 0.8, "standard": None},
                           "waiting": 7, "running": 4},
               "sli": {"interactive": {"ttft": {"n": 5, "p50": 0.1, "p95": 0.9}}},
               "cold_start_s": 12.5}
    sig = mod.signals_from_debug("pod-1", payload)
    assert (sig.brownout_level, sig.queue_delay_ewma, sig.waiting, sig.running,
            sig.cold_start_s) == (2, {"interactive": 0.8}, 7, 4, 12.5)
    multi = {"engines": [
        {"control": {"brownout_level": 0, "waiting": 1, "running": 2}},
        {"control": {"brownout_level": 3, "waiting": 4, "running": 0,
                     "queue_delay_ewma": {"interactive": 1.5}}}]}
    m = mod.signals_from_debug("pod-2", multi)
    assert (m.brownout_level, m.waiting, m.running, m.queue_delay_ewma) == (
        3, 5, 2, {"interactive": 1.5})


# ---------------------------------------------------------------------------
# the reconciler and AutoscalerMetrics
# ---------------------------------------------------------------------------

class _FakePool:
    def __init__(self, mod, fail=0):
        self.mod = mod
        self.scaled = []
        self.sig = _sig(mod, 0.0, n=1)
        self.urls = ["http://10.0.0.1:8000"]
        self.cold = [7.5]
        self.fail = fail

    def signals(self):
        return self.sig

    def scale_to(self, n, reason):
        if self.fail:
            self.fail -= 1
            raise RuntimeError("kubectl: connection refused")
        self.scaled.append(n)

    def ready_urls(self):
        return list(self.urls)

    def drain_cold_starts(self):
        out, self.cold = self.cold, []
        return out


def _samples(text: str) -> dict:
    """Exposition samples without prometheus_client's ``_created`` series."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#") and "_created" not in line:
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def _families(text: str) -> dict:
    return {k: v for k, v in re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M)
            if not k.endswith("_created")}


def _reconcile(pkg, tmp_path, fail=0):
    mod, clock_cls, metrics_cls = PACKAGES[pkg]
    clock = clock_cls()
    pool = _FakePool(mod, fail=fail)
    metrics = metrics_cls()
    backends = tmp_path / f"{pkg}-backends.json"
    rec = mod.Reconciler(pool, _policy(mod, clock), metrics=metrics,
                         backends_file=str(backends), pool_name="tpuserve-engine")
    pool.sig = _sig(mod, 0.0, n=1, level=2, waiting=4, running=2)
    decisions = [rec.run_once()]
    first = metrics.render().decode()
    clock.advance(0.5)
    decisions.append(rec.run_once())
    return pool, rec, metrics.render().decode(), backends, decisions, first


@pytest.mark.parametrize("fail", [0, 1])
def test_reconciler_and_metrics_equal_jax(tmp_path, fail):
    """The same decisions applied (a failed apply reverted and retried on
    the next tick, its cooldown not burned), the backends file published,
    and the same families, types and samples exported."""
    port, jax_r = _reconcile("port", tmp_path, fail), _reconcile("jax", tmp_path, fail)
    assert port[0].scaled == jax_r[0].scaled == [2]
    assert [d.as_tuple() for d in port[1].policy.decisions] == \
        [d.as_tuple() for d in jax_r[1].policy.decisions]
    assert len(port[1].policy.decisions) == 1
    assert [d.action for d in port[4]] == [d.action for d in jax_r[4]]
    assert json.loads(port[3].read_text()) == json.loads(jax_r[3].read_text()) == port[0].urls
    assert _families(port[2]) == _families(jax_r[2])
    assert _samples(port[2]) == _samples(jax_r[2])
    assert _samples(port[5]) == _samples(jax_r[5])
    assert 'tpuserve_autoscaler_decisions_total{action="scale_out"} 1.0' in port[2]
    assert "tpuserve_cold_start_seconds_count 1.0" in port[2]
    if not fail:
        assert 'tpuserve_autoscaler_replicas{pool="tpuserve-engine"} 2.0' in port[5]


def test_autoscaler_metrics_help_equals_jax():
    port, jax_m = AutoscalerMetrics().render().decode(), JaxAutoscalerMetrics().render().decode()
    helps = lambda t: dict(re.findall(r"^# HELP (\S+) (.*)$", t, re.M))  # noqa: E731
    assert helps(port) == {k: v for k, v in helps(jax_m).items() if not k.endswith("_created")}
    assert _families(port) == _families(jax_m)


def test_autoscaler_entry_point_exists():
    """``python -m tpuserve_torch.autoscale`` parses its flags (the loop itself
    needs kubectl and a cluster)."""
    res = subprocess.run([sys.executable, "-m", "tpuserve_torch.autoscale", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--namespace" in res.stdout and "--backends-file" in res.stdout


def test_kube_pool_reads_kubectl_json(tmp_path, monkeypatch, server):
    """``KubePool`` shells out to ``kubectl`` as the JAX one does: a fake
    kubectl on PATH lists one ready pod (the port server) and records
    ``scale``; both packages make the same calls and read the same
    signals off the pod."""
    log = tmp_path / "calls.log"
    pods = {"items": [{"metadata": {"name": "engine-0"},
                       "status": {"podIP": "127.0.0.1",
                                  "conditions": [{"type": "Ready", "status": "True"}]}}]}
    fake = tmp_path / "kubectl"
    fake.write_text(f"""#!{sys.executable}
import sys
open({str(log)!r}, "a").write(" ".join(sys.argv[1:]) + "\\n")
if "pods" in sys.argv:
    print({json.dumps(json.dumps(pods))})
""")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    port = int(server.rsplit(":", 1)[1])
    calls, sigs = {}, {}
    for pkg in ("port", "jax"):
        mod = PACKAGES[pkg][0]
        log.write_text("")
        pool = mod.KubePool("ns", deployment="tpuserve-engine", port=port)
        sig = pool.signals()
        pool.scale_to(3, "test")
        calls[pkg] = log.read_text()
        sigs[pkg] = ([dataclasses.asdict(r) for r in sig.replicas], sig.booting,
                     pool.ready_urls(), pool.drain_cold_starts())
    assert calls["port"] == calls["jax"]
    assert "--replicas=3" in calls["port"] and "get pods" in calls["port"]
    assert sigs["port"] == sigs["jax"]
    assert sigs["port"][2] == [server] and len(sigs["port"][0]) == 1


# ---------------------------------------------------------------------------
# pool replay (engines)
# ---------------------------------------------------------------------------

STORM_OPTS = dict(step_time_s=0.05, control_interval_s=0.25, cold_start_s=1.0,
                  initial_replicas=1, max_num_seqs=2, max_waiting=12)
STORM_POLICY = dict(min_replicas=1, max_replicas=3, scale_out_cooldown_s=2.0,
                    scale_in_cooldown_s=20.0, idle_in_s=10.0)


def _pool(pkg, n=28, **opts):
    mod = PACKAGES[pkg][0]
    wl = mod.make_storm_workload(n=n, ramp_s=3.0, span_s=6.0, max_tokens=16)
    kw = dict(STORM_OPTS, **opts)
    if pkg == "port":
        kw["device"] = "cpu"
    return wl, mod.pool_replay(wl, mod.PoolReplayOptions(**kw),
                               mod.PolicyConfig(**STORM_POLICY))


def test_make_storm_workload_equals_jax():
    for kw in (dict(), dict(n=60, prompt_tokens=512, max_tokens=32),
               dict(n=9, prefix_group="sys", prefix_tokens=5)):
        assert port_as.make_storm_workload(**kw).as_dict() == \
            jax_as.make_storm_workload(**kw).as_dict()


def test_pool_replay_equals_jax_and_scales_before_shed():
    """The same storm and policy through both pools: the same decisions at
    the same virtual times, tokens, SLIs, counters and outcomes; twice in
    the port alike; the first scale-out before the first L3 entry or shed."""
    wl, r1 = _pool("port")
    _, r2 = _pool("port")
    _, rj = _pool("jax")
    assert r1["decision_digest"] == r2["decision_digest"] == rj["decision_digest"]
    assert r1["decisions"] == rj["decisions"]
    assert r1["token_digest"] == r2["token_digest"] == rj["token_digest"]
    for key in ("sli", "counters", "outcomes", "events", "first_scale_out_t",
                "first_shed_t", "first_l3_t", "replicas_peak", "cold_starts_observed_s",
                "virtual_s"):
        assert r1[key] == rj[key], key
    assert not r1["aborted"] and r1["replicas_peak"] > 1
    assert r1["first_scale_out_t"] is not None
    for shed_t in (r1["first_l3_t"], r1["first_shed_t"]):
        if shed_t is not None:
            assert r1["first_scale_out_t"] < shed_t
    assert r1["cold_starts_observed_s"]
    assert all(v >= STORM_OPTS["cold_start_s"] for v in r1["cold_starts_observed_s"])
    assert set(r1["outcomes"]) == {r.request_id for r in wl.requests}
    assert r1["counters"]["completed"] >= len(wl.requests) - 2


def test_pool_static_topology_equals_jax():
    """``policy_cfg=None`` pins the pool at its initial replicas (the A/B
    baseline): no decisions, the same outcomes as the JAX pool."""
    mod_p, mod_j = port_as, jax_as
    wl = mod_p.make_storm_workload(n=12, ramp_s=1.0, span_s=2.0, max_tokens=8)
    rp = mod_p.pool_replay(wl, mod_p.PoolReplayOptions(device="cpu", **STORM_OPTS))
    rj = mod_j.pool_replay(mod_j.make_storm_workload(n=12, ramp_s=1.0, span_s=2.0,
                                                     max_tokens=8),
                           mod_j.PoolReplayOptions(**STORM_OPTS))
    assert rp["mode"] == "static" and rp["decision_digest"] is None
    assert rp["replicas_peak"] == 1 and rp["decisions"] == []
    assert (rp["token_digest"], rp["outcomes"], rp["sli"]) == \
        (rj["token_digest"], rj["outcomes"], rj["sli"])


def test_pool_replay_scale_from_zero_with_warm_prefix(tmp_path, fp32):
    """A pool at zero replicas takes demand, the policy boots one, and it
    serves its first token with a prefix restored from the spill tier that
    an earlier replica left; ``tpuserve_cold_start_seconds`` reports it."""
    spill = str(tmp_path / "spill")
    shared = list(range(2, 26))
    eng = port_rt.Engine(port_rt.EngineConfig(
        model="tiny-qwen3",
        cache=port_rt.CacheConfig(block_size=4, num_blocks=24, max_blocks_per_seq=16),
        scheduler=port_rt.SchedulerConfig(max_num_seqs=4, max_prefill_tokens=256,
                                          min_prefill_bucket=8, min_decode_bucket=2),
        enable_prefix_caching=True, kv_tiers=True, kv_host_bytes=3000,
        kv_spill_dir=spill), device="cpu")
    p = port_rt.SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
    eng.generate([shared + [30]], p)
    eng.generate([[100 + i] * 40 for i in range(3)], p)
    eng._kv_tiers.flush()
    assert eng.stats.kv_spilled_blocks > 0
    del eng
    from tpuserve_torch.replay.workload import Workload, WorkloadRequest
    wl = Workload(requests=[WorkloadRequest(
        request_id=f"cold-{i}", arrival_s=0.2 * i, prompt_tokens=len(shared) + 1,
        prompt_token_ids=shared + [30 + i], max_tokens=4, slo_class="interactive", seed=i)
        for i in range(4)], seed=3)
    metrics = AutoscalerMetrics()
    rep = port_as.pool_replay(
        wl, port_as.PoolReplayOptions(initial_replicas=0, cold_start_s=1.0,
                                      control_interval_s=0.1, kv_spill_dir=spill,
                                      kv_host_bytes=3000, device="cpu"),
        port_as.PolicyConfig(min_replicas=0, max_replicas=1), metrics=metrics)
    assert rep["replicas_peak"] == 1
    assert "scale-from-zero" in rep["decisions"][0]["reason"]
    assert rep["counters"]["completed"] == 4
    assert rep["counters"]["kv_restored_blocks"] > 0
    assert len(rep["cold_starts_observed_s"]) == 1 and rep["cold_starts_observed_s"][0] >= 1.0
    text = metrics.render().decode()
    assert "tpuserve_cold_start_seconds_count 1.0" in text
    assert 'tpuserve_autoscaler_decisions_total{action="scale_out"} 1.0' in text
    assert 'tpuserve_autoscaler_replicas{pool="simpool"} 1.0' in text


def test_pool_replicas_take_the_given_params_and_device(fp32):
    _, _, cfg, params = fp32
    wl = port_as.make_storm_workload(n=2, ramp_s=0.1, span_s=0.2, max_tokens=2)
    clock = VirtualClock()
    from tpuserve_torch.autoscale.pool import _build_pool_engine
    eng = _build_pool_engine(wl, port_as.PoolReplayOptions(device="cpu", params=params,
                                                           block_size=32), clock)
    assert eng.params is params and eng.device.type == "cpu"
    assert eng.cache_cfg.block_size == 32 and eng.clock is clock
