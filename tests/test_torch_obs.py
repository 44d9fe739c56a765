"""Tenants, SLO burn rates and canaries in the port, on the CPU, against
the JAX package.

Units: one seeded stream of SLI samples and outcomes, on a virtual clock,
goes into the port's and the JAX ``BurnRateEvaluator``: the states and the
transitions after every evaluation are equal; the compiled PromQL
(``promql_burn_expr``, ``promql_events_expr``) and the generated
``alert_rules`` are the same text; objectives load and are refused as the
JAX ones; one seeded sequence of tenant resolutions, charges, settles and
refills on the port's and the JAX ``TenantRegistry`` gives the same
Retry-After values, buckets and usage.

Through the port's server (float32 tiny-qwen3 on the CPU): a tenant whose
token rate is below its traffic gets 429 with ``Retry-After`` and the other
tenant does not, and ``/metrics`` counts both; a canary probe is served but
neither metered nor in any SLI histogram, and the port's canary prober
reads a round; an objective that the traffic breaches fires, shows in
``/metrics`` (``tpuserve_slo_alerts_firing``, a transition) and in
``/debug/engine``, and its fast-burn auto-capture writes a trace.  The
CLI parses every A9 flag, and ``--no-devprof`` / ``--no-slo-burn`` take
effect.
"""

import dataclasses
import json
import random
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tpuserve.obs import burnrate as jax_burn
from tpuserve.obs import objectives as jax_obj
from tpuserve.runtime.clock import VirtualClock as JaxVirtualClock
from tpuserve.server import tenants as jax_tenants
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.obs import burnrate, objectives
from tpuserve_torch.obs.canary import CanaryConfig, CanaryProber, is_canary_header
from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SchedulerConfig
from tpuserve_torch.runtime.clock import VirtualClock
from tpuserve_torch.server import OpenAIServer, ServerConfig, tenants
from tpuserve_torch.server.openai_api import build_parser, engine_config, server_config

WINDOWS = [(m.BurnWindow("fast", 60.0, 10.0, 2.0, 5.0), m.BurnWindow("slow", 600.0, 60.0, 1.0,
                                                                     0.5))
           for m in (burnrate, jax_burn)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- the evaluator and the compiled rules --------------------------------

def _events(seed: int, n: int = 900):
    """(dt, op, class, kind, value) with phases of good, breaching and
    failing traffic."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        phase = (i // 150) % 3
        cls = rng.choice(("interactive", "standard", "batch"))
        if rng.random() < 0.2:
            out.append((rng.uniform(0.1, 0.6), "outcome", cls, None,
                        phase != 2 or rng.random() < 0.3))
        else:
            kind = rng.choice(("ttft", "itl", "e2e"))
            value = rng.uniform(0.001, 0.05) if phase == 0 else rng.uniform(0.2, 40.0)
            out.append((rng.uniform(0.1, 0.6), "sli", cls, kind, value))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_event_stream_gives_the_jax_evaluators_state(seed):
    clocks = [VirtualClock(), JaxVirtualClock()]
    evs = [mod.BurnRateEvaluator(objmod.DEFAULT_OBJECTIVES, windows=w, clock=c, min_events=4)
           for mod, objmod, w, c in ((burnrate, objectives, WINDOWS[0], clocks[0]),
                                     (jax_burn, jax_obj, WINDOWS[1], clocks[1]))]
    for i, (dt, op, cls, kind, value) in enumerate(_events(seed)):
        for ev, clock in zip(evs, clocks):
            clock.advance(dt)
            if op == "sli":
                ev.observe(cls, kind, value)
            else:
                ev.observe_outcome(cls, value)
        if i % 7 == 0:
            got = [ev.evaluate() for ev in evs]
            assert got[0] == got[1], i
            assert evs[0].state() == evs[1].state(), i
    assert evs[0].transitions == evs[1].transitions and evs[0].transitions
    assert evs[0].last_state == evs[1].last_state


def test_the_compiled_promql_and_alert_rules_are_the_jax_text():
    objs = objectives.DEFAULT_OBJECTIVES
    for o, jo in zip(objs, jax_obj.DEFAULT_OBJECTIVES):
        for w in (300.0, 3600.0, 21600.0):
            assert burnrate.promql_burn_expr(o, w) == jax_burn.promql_burn_expr(jo, w)
            assert burnrate.promql_events_expr(o, w) == jax_burn.promql_events_expr(jo, w)
    assert burnrate.alert_rules(objs) == jax_burn.alert_rules(jax_obj.DEFAULT_OBJECTIVES)
    assert objectives.objectives_digest(objs) == jax_obj.objectives_digest(
        jax_obj.DEFAULT_OBJECTIVES)


def test_objectives_load_and_refuse_as_the_jax_ones():
    spec = json.dumps([{"name": "a", "slo_class": "interactive", "sli": "ttft",
                        "objective": 0.95, "window_s": 600, "threshold_s": 0.25}])
    assert [dataclasses.asdict(o) for o in objectives.load_objectives(spec)] == \
        [dataclasses.asdict(o) for o in jax_obj.load_objectives(spec)]
    assert objectives.load_objectives(None) == objectives.DEFAULT_OBJECTIVES
    for bad in ("[]", json.dumps([{"name": "a", "slo_class": "interactive", "sli": "ttft",
                                   "objective": 0.95, "window_s": 600, "threshold_s": 0.3}]),
                json.dumps([{"name": "a", "slo_class": "nope", "sli": "ttft",
                             "objective": 0.95, "window_s": 600, "threshold_s": 0.25}])):
        with pytest.raises(ValueError) as ours:
            objectives.load_objectives(bad)
        with pytest.raises(ValueError) as ref:
            jax_obj.load_objectives(bad)
        assert str(ours.value) == str(ref.value)


def test_the_sli_edges_are_the_jax_servers():
    from tpuserve.server.metrics import SLI_BUCKETS as JAX_SLI
    from tpuserve_torch.server.metrics import SLI_BUCKETS
    assert SLI_BUCKETS == JAX_SLI


# ---- tenants --------------------------------------------------------------

CONFIG = {"default": {"rate_tps": 0},
          "tenants": {"acme": {"rate_tps": 50, "burst": 200, "slo_class": "interactive",
                               "api_keys": ["sk-acme"]},
                      "beta": {"rate_tps": 5, "burst": 30},
                      "free": {}}}


def test_tenant_sequences_equal_the_jax_registry():
    regs = [m.TenantRegistry.from_config(CONFIG) for m in (tenants, jax_tenants)]
    rng = random.Random(3)
    now = 0.0
    for i in range(600):
        now += rng.uniform(0.0, 0.4)
        auth = rng.choice((None, "Bearer sk-acme", "Bearer nope"))
        model = rng.choice((None, "acme", "beta", "free", "lora-x"))
        who = [r.resolve(auth, model, ("lora-x",)) for r in regs]
        assert who[0] == who[1], i
        assert regs[0].slo_class_for(who[0]) == regs[1].slo_class_for(who[1])
        body = {"prompt": "x" * rng.randrange(1, 400), "max_tokens": rng.randrange(1, 120)}
        cost = tenants.estimate_cost(body)
        assert cost == jax_tenants.estimate_cost(body)
        retry = [r.charge(who[0], cost, now=now) for r in regs]
        assert retry[0] == retry[1], i
        if retry[0] is None and rng.random() < 0.8:
            actual = rng.randrange(0, cost + 40)
            for r in regs:
                r.settle(who[0], cost, actual, now=now + 0.01)
        assert regs[0]._buckets == regs[1]._buckets, i
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].snapshot()["rate_limited"].get("beta", 0) > 0


def test_tenant_configs_load_and_refuse_as_the_jax_ones(tmp_path):
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps(CONFIG))
    assert tenants.TenantRegistry.load(str(path)).limits == \
        {k: tenants.TenantLimit(**dataclasses.asdict(v))
         for k, v in jax_tenants.TenantRegistry.load(str(path)).limits.items()}
    for bad in ({"tenants": {"a": {"rate_tps": -1}}}, {"x": 1},
                {"tenants": {"a": {"slo_class": "gold"}}},
                {"tenants": {"a": {"api_keys": ["k"]}, "b": {"api_keys": ["k"]}}}):
        with pytest.raises(ValueError) as ours:
            tenants.TenantRegistry.from_config(bad)
        with pytest.raises(ValueError) as ref:
            jax_tenants.TenantRegistry.from_config(bad)
        assert str(ours.value) == str(ref.value)


def test_the_canary_tag_is_token_gated(monkeypatch):
    monkeypatch.delenv("TPUSERVE_CANARY_TOKEN", raising=False)
    assert is_canary_header("1") and not is_canary_header(None)
    monkeypatch.setenv("TPUSERVE_CANARY_TOKEN", "s3cret")
    assert not is_canary_header("1") and is_canary_header("s3cret")


# ---- the server -----------------------------------------------------------

TENANTS = json.dumps({"tenants": {"slow": {"rate_tps": 1, "burst": 40, "api_keys": ["sk-slow"]},
                                  "fast": {"rate_tps": 100000, "api_keys": ["sk-fast"]}}})
# one objective the traffic below breaches: a standard request done in 25
# ms, which 64 engine steps on the CPU never are
OBJECTIVES = json.dumps([{"name": "std-e2e", "slo_class": "standard", "sli": "e2e",
                          "objective": 0.99, "window_s": 3600, "threshold_s": 0.025}])


@pytest.fixture(scope="module")
def server(fp32_tiny_qwen3, tmp_path_factory):
    from tpuserve.models import weights as jax_weights
    import os
    jparams = jax_weights.init_params(fp32_tiny_qwen3, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    flight_dir = str(tmp_path_factory.mktemp("obs-flight"))
    old = os.environ.get("TPUSERVE_FLIGHT_DIR")
    os.environ["TPUSERVE_FLIGHT_DIR"] = flight_dir
    eng = Engine(EngineConfig(model="tiny-qwen3",
                              cache=CacheConfig(block_size=4, num_blocks=128,
                                                max_blocks_per_seq=16, dtype="float32"),
                              scheduler=SchedulerConfig(max_num_seqs=8, min_prefill_bucket=8,
                                                        min_decode_bucket=2), seed=0),
                 params=params, model_cfg=cfg, device="cpu")
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0, tenant_config=TENANTS,
                                         slo_objectives=OBJECTIVES))
    # the test's windows: a minute's fast window fires on a few requests
    srv.runner.slo_eval = burnrate.BurnRateEvaluator(
        objectives.load_objectives(OBJECTIVES), windows=WINDOWS[0][:1],
        clock=srv.runner._clock, min_events=4)
    srv.runner.AUTO_CAPTURE_SECONDS = 0.2
    url = f"http://127.0.0.1:{srv.start()}"
    yield srv, url, flight_dir
    srv.shutdown()
    if old is None:
        os.environ.pop("TPUSERVE_FLIGHT_DIR", None)
    else:
        os.environ["TPUSERVE_FLIGHT_DIR"] = old


def _post(url, payload, headers=None):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null"), dict(e.headers)


def _scrape(url):
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        return r.read().decode()


def _sample(text, family, **labels):
    for line in text.splitlines():
        if not line.startswith(family) or line[len(family):][:1] not in ("{", " "):
            continue
        if all(f'{k}="{v}"' in line for k, v in labels.items()):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def _poll(url, family, want, timeout_s=15.0, **labels):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        v = _sample(_scrape(url), family, **labels)
        if want(v):
            return v
        time.sleep(0.1)
    return _sample(_scrape(url), family, **labels)


def test_a_rate_limited_tenant_gets_429_and_the_other_does_not(server):
    srv, url, _ = server
    body = {"prompt": [5, 6, 7, 8], "max_tokens": 8, "temperature": 0}
    codes = {"slow": [], "fast": []}
    for _ in range(4):
        for who in ("slow", "fast"):
            status, out, headers = _post(url + "/v1/completions", body,
                                         {"Authorization": f"Bearer sk-{who}"})
            codes[who].append(status)
            if status == 429:
                assert out["error"]["type"] == "rate_limit_exceeded"
                assert int(headers["Retry-After"]) >= 1
    assert codes["fast"] == [200] * 4
    assert codes["slow"][0] == 200 and 429 in codes["slow"]
    text = _scrape(url)
    assert _sample(text, "tpuserve_tenant_rate_limited_total", tenant="slow") == \
        codes["slow"].count(429)
    assert _sample(text, "tpuserve_tenant_rate_limited_total", tenant="fast") == 0
    # settled with what was served: the prompt and the generated tokens
    assert _sample(text, "tpuserve_tenant_tokens_total", tenant="fast") == 4 * (4 + 8)


def test_a_canary_is_served_but_not_metered_or_in_any_sli(server):
    srv, url, _ = server
    before = _scrape(url)
    status, out, _ = _post(url + "/v1/completions", {"prompt": "ping", "max_tokens": 2},
                           {"X-TPUServe-Canary": "1", "X-SLO-Class": "interactive",
                            "Authorization": "Bearer sk-slow"})
    assert status == 200 and out["choices"]
    after = _poll(url, "tpuserve_canary_requests_total",
                  lambda v: v > _sample(before, "tpuserve_canary_requests_total"))
    assert after == _sample(before, "tpuserve_canary_requests_total") + 1
    text = _scrape(url)
    for fam in ("tpuserve_ttft_seconds_count", "tpuserve_e2e_seconds_count"):
        assert _sample(text, fam, slo_class="interactive") == \
            _sample(before, fam, slo_class="interactive")
    for who in ("slow", "default"):
        assert _sample(text, "tpuserve_tenant_tokens_total", tenant=who) == \
            _sample(before, "tpuserve_tenant_tokens_total", tenant=who)
    # the port's prober reads a round through the same path
    prober = CanaryProber(url, CanaryConfig(interval_s=60.0, timeout_s=60.0))
    snap = prober.probe_once()
    assert snap["breached"] is False and all(v["ok"] for v in snap["last"].values())
    ptext = prober.metrics.render().decode()
    assert all(_sample(ptext, "tpuserve_canary_probes_total", slo_class=c) == 1.0
               for c in ("interactive", "standard", "batch"))


def test_a_breached_objective_fires_and_shows_in_metrics(server):
    srv, url, flight_dir = server
    for i in range(6):
        status, _, _ = _post(url + "/v1/completions",
                             {"prompt": [9, 10, 11 + i], "max_tokens": 64,
                              "ignore_eos": True}, {"Authorization": "Bearer sk-fast"})
        assert status == 200
    firing = _poll(url, "tpuserve_slo_alerts_firing", lambda v: v >= 1)
    with urllib.request.urlopen(url + "/debug/engine", timeout=30) as r:
        state = json.loads(r.read()).get("slo")
    assert firing >= 1, (state, srv.runner.slo_eval.transitions)
    text = _scrape(url)
    # the earlier tests' standard requests may have fired it already
    assert _sample(text, "tpuserve_slo_alert_transitions_total", objective="std-e2e",
                   window="fast", state="firing") >= 1
    assert _sample(text, "tpuserve_slo_burn_rate", objective="std-e2e", window="fast") > 2.0
    with urllib.request.urlopen(url + "/debug/engine", timeout=30) as r:
        slo = json.loads(r.read())["slo"]
    assert "std-e2e/fast" in slo["firing"]
    # the fast burn took a short trace beside the bundles
    assert _poll(url, "tpuserve_profile_captures_total", lambda v: v >= 1) >= 1
    caps = srv.engine.devprof.captures
    assert caps and caps[-1]["reason"] == "slo-std-e2e"
    assert caps[-1]["trace_dir"].startswith(flight_dir)


# ---- the CLI --------------------------------------------------------------

def test_every_a9_flag_parses_and_the_switches_take_effect(tmp_path):
    args = build_parser().parse_args([
        "--model", "tiny-qwen3", "--device", "cpu", "--block-size", "4", "--num-blocks", "64",
        "--max-blocks-per-seq", "16", "--no-devprof", "--no-slo-burn",
        "--tenant-config", TENANTS, "--slo-objectives", OBJECTIVES,
        "--model-catalog", "tiny-llama", "--swap-policy", "reject",
        "--max-resident-models", "2", "--weight-host-bytes", "12345",
        "--weight-spill-dir", str(tmp_path)])
    ecfg = engine_config(args)
    assert ecfg.devprof is False
    scfg = server_config(args)
    assert (scfg.tenant_config, scfg.slo_objectives, scfg.model_catalog) == (
        TENANTS, OBJECTIVES, "tiny-llama")
    assert (scfg.swap_policy, scfg.max_resident_models, scfg.weight_host_bytes,
            scfg.weight_spill_dir, scfg.slo_burn) == ("reject", 2, 12345, str(tmp_path), False)
    eng = Engine(ecfg, device="cpu")
    assert not eng.devprof.enabled and eng.flight.devprof is None
    srv = OpenAIServer(eng, scfg)
    assert srv.runner.slo_eval is None
    assert srv.pool is not None and srv.pool.models() == ["tiny-llama", "tiny-qwen3"]
    assert srv.tenants.resolve("Bearer sk-slow") == "slow"
    defaults = build_parser().parse_args(["--device", "cpu"])
    assert engine_config(defaults).devprof is None and server_config(defaults).slo_burn
    srv2 = OpenAIServer(Engine(dataclasses.replace(ecfg, devprof=None), device="cpu"),
                        server_config(defaults))
    assert srv2.runner.slo_eval is not None and srv2.engine.devprof.enabled
    assert srv2.pool is None


def test_the_new_modules_import_no_jax_and_no_optional_package():
    """The services' modules load on the card's machine: no JAX, nothing of
    the JAX package, no prometheus_client or pynvml."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "import tpuserve_torch.obs, tpuserve_torch.modelpool, tpuserve_torch.native\n"
            "import tpuserve_torch.runtime.devprof, tpuserve_torch.server.gpu_metrics\n"
            "import tpuserve_torch.server.tenants, tpuserve_torch.server.tracing\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpuserve',"
            " 'prometheus_client', 'pynvml')]\n"
            "assert not bad, bad\n"
            "print('clean')")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120, env={**__import__("os").environ, "PYTHONPATH": str(root)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
