"""The inference gateway in the port, on the CPU, against the JAX package.

- Routing without HTTP: both packages' ``Gateway`` over the same backend
  URLs pick the same backend for the same bodies (rendezvous affinity,
  the digest-hit subset, catalog warmth, the load-slack escape, failover
  exclusion).
- The port's gateway over two port servers (float32 tiny-qwen3 on the
  CPU, module-scoped): relay, streaming, an affinity prefix-cache hit,
  ``/gateway/status`` and ``/gateway/slo``, the probe's catalog and
  digest; and, over stub backends as the JAX tests use them, ejection on
  5xx with the jittered readmission backoff, connect failover, the
  dynamic backends file (zero dropped streams), the empty pool's 503,
  tenants and trace propagation.  A backend removed from the file while
  real port streams run on it finishes every stream.
- Across packages: a JAX gateway in front of a port server and a port
  gateway in front of a JAX server relay, stream and read the backend's
  ``/healthz`` digest.
"""

import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve.server import gateway as jax_gw
from tpuserve.server.openai_api import OpenAIServer as JaxServer
from tpuserve.server.openai_api import ServerConfig as JaxServerConfig
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SchedulerConfig
from tpuserve_torch.server import OpenAIServer, ServerConfig
from tpuserve_torch.server import gateway as port_gw
from tpuserve_torch.server.kv_digest import affinity_key, digest_has

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"port": port_gw, "jax": jax_gw}
CACHE = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16, dtype="float32")
SCHED = dict(max_num_seqs=8, min_prefill_bucket=8, min_decode_bucket=2)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _port_server(weights):
    _, _, cfg, params = weights
    eng = Engine(EngineConfig(model="tiny-qwen3", cache=CacheConfig(**CACHE),
                              scheduler=SchedulerConfig(**SCHED)),
                 params=params, model_cfg=cfg, device="cpu")
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0))
    return srv, f"http://127.0.0.1:{srv.start()}"


@pytest.fixture(scope="module")
def stack(weights):
    """Two port servers behind a port gateway, and one JAX server."""
    jcfg, jparams, _, _ = weights
    srv1, url1 = _port_server(weights)
    srv2, url2 = _port_server(weights)
    jeng = jax_rt.Engine(jax_rt.EngineConfig(
        model="tiny-qwen3", cache=jax_rt.CacheConfig(**CACHE),
        scheduler=jax_rt.SchedulerConfig(**SCHED), attn_impl="reference", multi_step=1),
        params=jparams, model_cfg=jcfg)
    jsrv = JaxServer(jeng, JaxServerConfig(host="127.0.0.1", port=0, tpu_metrics=False,
                                           slo_burn=False))
    jurl = f"http://127.0.0.1:{jsrv.start()}"
    gw = port_gw.Gateway([url1, url2], port_gw.GatewayConfig(
        host="127.0.0.1", port=0, health_interval_s=0.5))
    gport = gw.start()
    yield {"gw": gw, "url": f"http://127.0.0.1:{gport}", "servers": [srv1, srv2],
           "urls": [url1, url2], "jax_url": jurl}
    gw.shutdown()
    for s in (srv1, srv2, jsrv):
        s.shutdown()


def _drain(gw, timeout=10.0):
    """Wait for in-flight relay handlers to release their backends."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with gw._lock:
            if all(b.outstanding == 0 for b in gw.backends):
                return
        time.sleep(0.02)
    raise AssertionError(f"gateway backends never drained: {gw.status()['backends']}")


def _post(url, payload, timeout=120, headers=None):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _stream(url, payload, timeout=120):
    """A streamed completion: (status, token ids, ended with [DONE])."""
    req = urllib.request.Request(url, data=json.dumps(dict(payload, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read().decode()
        status = r.status
    ids = []
    for line in raw.splitlines():
        if line.startswith("data: {"):
            for ch in json.loads(line[6:])["choices"]:
                ids += ch.get("token_ids") or []
    return status, ids, raw.rstrip().endswith("data: [DONE]")


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# routing without HTTP: the same choices in both packages
# ---------------------------------------------------------------------------

URLS = [f"http://10.0.0.{i}:8000" for i in range(1, 5)]
BODIES = ([{"prompt": f"tenant-{i} shared context", "max_tokens": 1} for i in range(24)]
          + [{"prompt": list(range(i, i + 80)), "max_tokens": 1} for i in range(8)]
          + [{"messages": [{"role": "user", "content": f"hello {i}"}]} for i in range(8)]
          + [{"max_tokens": 1}])


def _gateways(setup):
    out = {}
    for pkg, mod in PACKAGES.items():
        gw = mod.Gateway(URLS, mod.GatewayConfig(host="127.0.0.1", port=0,
                                                 health_interval_s=3600))
        setup(gw)
        out[pkg] = gw
    return out


def _no_setup(gw):
    pass


def _digests(gw):
    # backend 2 advertises every even tenant's key in its digest
    from tpuserve_torch.server.kv_digest import PrefixDigestTracker
    tr = PrefixDigestTracker()
    for i in range(0, 24, 2):
        tr.note(affinity_key(BODIES[i]))
    b = gw.backends[2]
    b.kv_digest, b.kv_digest_bits = tr.digest_hex(), tr.bits


def _catalog(gw):
    for b, models in zip(gw.backends, [{"m": "cold"}, {"m": "host"}, {"m": "serving"}, {}]):
        b.models = dict(models)


def _loaded(gw):
    gw.backends[0].outstanding = gw.config.affinity_load_slack + 3
    gw.backends[1].healthy = False


ROUTING = {"rendezvous": _no_setup, "digest_hits": _digests, "catalog": _catalog,
           "load_slack_and_eject": _loaded}


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_routing_choices_equal_jax(case):
    gws = _gateways(ROUTING[case])
    bodies = [dict(b, model="m") for b in BODIES] if case == "catalog" else BODIES
    picks = {}
    for pkg, gw in gws.items():
        picks[pkg] = []
        for body in bodies:
            b = gw.pick_backend(json.dumps(body).encode())
            picks[pkg].append(b.url)
            gw.release(b, ok=True)
        b = gw.pick_backend(json.dumps(bodies[0]).encode(), exclude={picks[pkg][0]})
        picks[pkg].append(b.url)
        gw.release(b, ok=True)
    assert picks["port"] == picks["jax"]
    assert len(set(picks["port"])) >= 2 or case == "catalog"
    if case == "catalog":
        assert set(picks["port"][:-1]) == {URLS[2]}


def test_readmit_backoff_grows_exponentially():
    gw = port_gw.Gateway(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                         port_gw.GatewayConfig(host="127.0.0.1", port=0,
                                               eject_after_failures=1,
                                               readmit_backoff_base_s=2.0,
                                               readmit_jitter_frac=0.25))
    b = gw.backends[0]
    picked = gw.pick_backend(None)
    gw.release(b, ok=False)
    assert not b.healthy and b.eject_count == 1
    w1 = b.backoff_until - time.monotonic()
    assert 1.4 <= w1 <= 2.6
    with gw._lock:
        b.healthy = True
    gw.release(b, ok=False)
    w2 = b.backoff_until - time.monotonic()
    assert b.eject_count == 2 and 2.9 <= w2 <= 5.1 and w2 > w1
    gw.release(picked, ok=True)


def test_backend_source_rejects_garbage(tmp_path):
    bf = tmp_path / "backends.json"
    bf.write_text(json.dumps(["http://127.0.0.1:9"]))
    gw = port_gw.Gateway([], port_gw.GatewayConfig(host="127.0.0.1", port=0,
                                                   health_interval_s=3600,
                                                   backends_file=str(bf)))
    assert [b.url for b in gw.backends] == ["http://127.0.0.1:9"]
    for garbage in ("<html>502 Bad Gateway</html>\n", json.dumps({"error": "nope"}),
                    "not a url\nalso not\n"):
        bf.write_text(garbage)
        assert gw.reload_backends() is False
        assert [b.url for b in gw.backends] == ["http://127.0.0.1:9"]
    bf.write_text("# fleet\nhttp://127.0.0.1:19\n")
    assert gw.reload_backends() is True
    assert [b.url for b in gw.backends] == ["http://127.0.0.1:19"]
    bf.write_text("[]")
    assert gw.reload_backends() is True and gw.backends == []


# ---------------------------------------------------------------------------
# the port's gateway over port servers
# ---------------------------------------------------------------------------

def test_relay_models_completion_and_stream(stack):
    body = _get_json(stack["url"] + "/v1/models")
    assert body["data"][0]["id"] == "tiny-qwen3"
    status, out = _post(stack["url"] + "/v1/completions",
                        {"prompt": [5, 6, 7], "max_tokens": 4, "temperature": 0,
                         "ignore_eos": True})
    assert status == 200 and out["usage"]["completion_tokens"] == 4
    status, ids, done = _stream(stack["url"] + "/v1/completions",
                                {"prompt": [5, 6, 7], "max_tokens": 4, "temperature": 0,
                                 "ignore_eos": True, "return_token_ids": True})
    assert status == 200 and done and len(ids) == 4
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(stack["url"] + "/v1/completions", {"prompt": ""})
    assert ei.value.code == 400


def test_affinity_lands_on_the_rendezvous_target_and_hits(stack):
    """Every request of one prefix lands on the backend rendezvous hashing
    predicts, and the repeats are prefix-cache hits there."""
    gw = stack["gw"]
    _drain(gw)
    prompt = list(range(40, 64))
    payload = {"prompt": prompt, "max_tokens": 2, "temperature": 0, "ignore_eos": True}
    want = port_gw.Gateway._rendezvous_target(affinity_key(payload), gw.backends).url
    srv = stack["servers"][stack["urls"].index(want)]
    before = [s.engine.block_manager.prefix_hits for s in stack["servers"]]
    finished = [s.engine.stats.requests_finished for s in stack["servers"]]
    for _ in range(3):
        _post(stack["url"] + "/v1/completions", payload)
    after = [s.engine.block_manager.prefix_hits for s in stack["servers"]]
    done = [s.engine.stats.requests_finished - f for s, f in zip(stack["servers"], finished)]
    assert done[stack["urls"].index(want)] == 3 and sum(done) == 3
    assert srv.engine.block_manager.prefix_hits - before[stack["urls"].index(want)] >= 2
    assert sum(after) - sum(before) >= 2


def test_affinity_agrees_across_gateway_replicas(stack):
    gw1 = stack["gw"]
    _drain(gw1)
    gw2 = port_gw.Gateway(stack["urls"], port_gw.GatewayConfig(host="127.0.0.1", port=0))
    jgw = jax_gw.Gateway(stack["urls"], jax_gw.GatewayConfig(host="127.0.0.1", port=0))
    picks = set()
    for i in range(32):
        body = json.dumps({"prompt": f"tenant-{i} shared context", "max_tokens": 1}).encode()
        a, b, c = gw1.pick_backend(body), gw2.pick_backend(body), jgw.pick_backend(body)
        for g, x in ((gw1, a), (gw2, b), (jgw, c)):
            g.release(x, ok=True)
        assert a.url == b.url == c.url
        picks.add(a.url)
    assert len(picks) == 2


def test_status_slo_and_probe(stack):
    gw = stack["gw"]
    _post(stack["url"] + "/v1/completions", {"prompt": [9, 9, 9], "max_tokens": 2})
    gw.probe_backends_once()
    st = _get_json(stack["url"] + "/gateway/status")
    assert len(st["backends"]) == 2
    for b in st["backends"]:
        assert b["healthy"] and b["last_probe_latency_s"] is not None
        assert b["probe_failures"] == 0
    for b in gw.backends:
        assert b.models == {} and b.model_current == ""
        assert b.kv_digest and b.kv_digest_bits
    slo = _get_json(stack["url"] + "/gateway/slo")
    assert set(slo["backends"]) == set(stack["urls"])
    for entry in slo["backends"].values():
        assert entry["healthy"] is True and "slo" in entry and "error" not in entry
    assert isinstance(slo["firing"], list) and isinstance(slo["sli_worst"], dict)
    lone = port_gw.Gateway(["http://127.0.0.1:9"], port_gw.GatewayConfig(
        host="127.0.0.1", port=0, health_timeout_s=0.2))
    lone.probe_backends_once()
    b = lone.status()["backends"][0]
    assert b["probe_failures"] == 1 and not b["healthy"]


def test_removed_backend_finishes_its_streams(stack, tmp_path):
    """The backends file drops one port server while four streams run on
    it: every stream finishes, the next requests go to the other server
    only, and the server comes back after its first healthy probe."""
    url1, url2 = stack["urls"]
    srv1, srv2 = stack["servers"]
    bf = tmp_path / "backends.json"
    bf.write_text(json.dumps([url1, url2]))
    gw = port_gw.Gateway([], port_gw.GatewayConfig(host="127.0.0.1", port=0,
                                                   health_interval_s=3600,
                                                   backends_file=str(bf)))
    gport = gw.start()
    url = f"http://127.0.0.1:{gport}/v1/completions"
    try:
        gw.probe_backends_once()
        assert all(b.healthy for b in gw.backends)
        # prompts whose rendezvous target is server 2
        prompts, i = [], 0
        while len(prompts) < 4:
            p = [100 + i, 101 + i, 102 + i, 7]
            i += 1
            key = affinity_key({"prompt": p})
            if port_gw.Gateway._rendezvous_target(key, gw.backends).url == url2:
                prompts.append(p)
        res = {}
        threads = [threading.Thread(target=lambda j=j, p=p: res.__setitem__(j, _stream(
            url, {"prompt": p, "max_tokens": 40, "temperature": 0, "ignore_eos": True,
                  "return_token_ids": True}))) for j, p in enumerate(prompts)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while sum(b.outstanding for b in gw.backends if b.url == url2) < 4:
            assert time.monotonic() < deadline, "the streams never routed"
            time.sleep(0.005)
        bf.write_text(json.dumps([url1]))
        assert gw.reload_backends()
        assert [b.url for b in gw.backends] == [url1]
        in_flight = sum(1 for j in range(4) if j not in res)
        for t in threads:
            t.join(timeout=120)
        assert all(res[j][0] == 200 and res[j][2] and len(res[j][1]) == 40 for j in range(4))
        assert in_flight >= 1
        before = [srv1.engine.stats.requests_finished, srv2.engine.stats.requests_finished]
        for p in prompts:
            _post(url, {"prompt": p, "max_tokens": 2})
        assert srv2.engine.stats.requests_finished == before[1]
        assert srv1.engine.stats.requests_finished == before[0] + 4
        bf.write_text(json.dumps([url1, url2]))
        assert gw.reload_backends()
        back = next(b for b in gw.backends if b.url == url2)
        assert not back.healthy
        gw.probe_backends_once()
        assert back.healthy
        st = _get_json(f"http://127.0.0.1:{gport}/gateway/status")
        assert sorted(b["url"] for b in st["backends"] if b["healthy"]) == sorted([url1, url2])
    finally:
        gw.shutdown()


# ---------------------------------------------------------------------------
# stub backends (the JAX tests' shapes)
# ---------------------------------------------------------------------------

def _stub(handler_cls):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


class _Quiet(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _send(self, code, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self._send(200, b'{"status":"ok"}')


def test_ejects_on_consecutive_5xx_and_readmits_after_backoff(stack):
    class Flaky(_Quiet):
        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            self._send(500, b'{"error":{"message":"engine down","type":"server_error"}}')

    flaky_httpd, flaky_url = _stub(Flaky)
    gw = port_gw.Gateway([flaky_url, stack["urls"][0]], port_gw.GatewayConfig(
        host="127.0.0.1", port=0, health_interval_s=3600, eject_after_failures=2))
    gport = gw.start()
    try:
        flaky = next(b for b in gw.backends if b.url == flaky_url)
        errors = 0
        for i in range(16):
            try:
                _post(f"http://127.0.0.1:{gport}/v1/completions",
                      {"prompt": [200 + i, 5], "max_tokens": 2, "temperature": 0})
            except urllib.error.HTTPError as e:
                assert e.code == 500
                errors += 1
            if not flaky.healthy:
                break
        assert errors >= 2 and not flaky.healthy and flaky.consecutive_failures >= 2
        for i in range(4):
            assert _post(f"http://127.0.0.1:{gport}/v1/completions",
                         {"prompt": [300 + i, 5], "max_tokens": 2})[0] == 200
        assert flaky.backoff_until > 0 and flaky.eject_count == 1
        gw.probe_backends_once()
        assert not flaky.healthy                  # inside the backoff window
        with gw._lock:
            flaky.backoff_until = 0.0
        gw.probe_backends_once()
        assert flaky.healthy and flaky.consecutive_failures == 0
        gw.probe_backends_once()
        assert flaky.eject_count == 1
        with gw._lock:
            flaky.healthy_since = time.monotonic() - gw.config.readmit_reset_healthy_s - 1
        gw.probe_backends_once()
        assert flaky.eject_count == 0
    finally:
        gw.shutdown()
        flaky_httpd.shutdown()


def test_connect_failover_and_all_unreachable(stack):
    gw = port_gw.Gateway(["http://127.0.0.1:1", stack["urls"][1]], port_gw.GatewayConfig(
        host="127.0.0.1", port=0, health_interval_s=3600))
    gport = gw.start()
    dead = port_gw.Gateway(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                           port_gw.GatewayConfig(host="127.0.0.1", port=0,
                                                 health_interval_s=3600))
    dport = dead.start()
    try:
        # a prompt whose rendezvous target is the dead backend: the relay
        # must fail over to the live one
        prompt = next([i, 6] for i in range(5, 200)
                      if port_gw.Gateway._rendezvous_target(
                          affinity_key({"prompt": [i, 6]}), gw.backends).url.endswith(":1"))
        status, body = _post(f"http://127.0.0.1:{gport}/v1/completions",
                             {"prompt": prompt, "max_tokens": 4, "temperature": 0,
                              "ignore_eos": True})
        assert status == 200 and body["usage"]["completion_tokens"] == 4
        assert any(b.consecutive_failures >= 1 for b in gw.backends)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{dport}/v1/completions", {"prompt": "y"})
        assert e.value.code == 502
    finally:
        gw.shutdown()
        dead.shutdown()


def _named_stub(name, delay_s=0.0):
    class Stub(_Quiet):
        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            if delay_s:
                time.sleep(delay_s)
            self._send(200, json.dumps({"served_by": name}).encode())
    return _stub(Stub)


def test_dynamic_backend_reload_admit_and_drain(tmp_path):
    """A scale-out backend gets traffic after its first healthy probe; a
    removed one stops being picked at once while its in-flight request
    completes."""
    a_httpd, a_url = _named_stub("A", delay_s=2.0)
    b_httpd, b_url = _named_stub("B")
    bf = tmp_path / "backends.json"
    bf.write_text(json.dumps([a_url]))
    gw = port_gw.Gateway([], port_gw.GatewayConfig(host="127.0.0.1", port=0,
                                                   health_interval_s=3600,
                                                   backends_file=str(bf)))
    gport = gw.start()
    url = f"http://127.0.0.1:{gport}/v1/completions"
    try:
        assert [b.url for b in gw.backends] == [a_url] and not gw.backends[0].healthy
        gw.probe_backends_once()
        slow = {}
        t = threading.Thread(target=lambda: slow.setdefault("r", _post(url, {"prompt": "x"})))
        t.start()
        deadline = time.monotonic() + 5
        while not any(b.outstanding for b in gw.backends):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        bf.write_text(json.dumps([a_url, b_url]))
        assert gw.reload_backends()
        b_backend = next(b for b in gw.backends if b.url == b_url)
        assert not b_backend.healthy
        for _ in range(4):
            picked = gw.pick_backend(b'{"prompt":"y"}')
            assert picked.url == a_url
            gw.release(picked, ok=True)
        gw.probe_backends_once()
        assert b_backend.healthy
        bf.write_text(json.dumps([b_url]))
        assert gw.reload_backends()
        assert _post(url, {"prompt": "x"})[1]["served_by"] == "B"
        t.join(timeout=30)
        assert slow["r"] == (200, {"served_by": "A"})
    finally:
        gw.shutdown()
        a_httpd.shutdown()
        b_httpd.shutdown()


def test_empty_dynamic_pool_503_and_demand_counter(tmp_path):
    bf = tmp_path / "backends.json"
    bf.write_text("[]")
    gw = port_gw.Gateway([], port_gw.GatewayConfig(host="127.0.0.1", port=0,
                                                   health_interval_s=3600,
                                                   backends_file=str(bf)))
    gport = gw.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{gport}/v1/completions", {"prompt": "x", "model": "m"})
        assert e.value.code == 503 and e.value.headers.get("Retry-After")
        st = _get_json(f"http://127.0.0.1:{gport}/gateway/status")
        assert st["unserved_total"] == 1 and st["unserved_by_model"] == {"m": 1}
    finally:
        gw.shutdown()


def test_tenants_and_trace_context_reach_the_backend():
    """Gateway tenancy: a keyed tenant's default class rides as X-SLO-Class
    when the client sent none (never over an explicit one); a tenant past
    its token rate gets the 429; the caller's traceparent passes through."""
    seen = {}

    class Echo(_Quiet):
        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            seen["slo"] = self.headers.get("X-SLO-Class")
            seen["traceparent"] = self.headers.get("traceparent")
            self._send(200, b'{"usage": {"total_tokens": 3}}')

    httpd, up = _stub(Echo)
    gw = port_gw.Gateway([up], port_gw.GatewayConfig(
        host="127.0.0.1", port=0, health_interval_s=3600,
        tenant_config=json.dumps({"tenants": {
            "acme": {"slo_class": "interactive", "api_keys": ["sk-a"]},
            "tiny": {"rate_tps": 1, "burst": 20, "api_keys": ["sk-t"]}}})))
    gport = gw.start()
    url = f"http://127.0.0.1:{gport}/v1/completions"
    tp = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    try:
        _post(url, {"prompt": "x", "max_tokens": 1},
              headers={"Authorization": "Bearer sk-a", "traceparent": tp})
        assert seen["slo"] == "interactive" and seen["traceparent"] == tp
        _post(url, {"prompt": "x", "max_tokens": 1},
              headers={"Authorization": "Bearer sk-a", "X-SLO-Class": "batch"})
        assert seen["slo"] == "batch"
        _post(url, {"prompt": "x", "max_tokens": 1})
        assert seen["slo"] is None
        with pytest.raises(urllib.error.HTTPError) as e:
            for _ in range(4):
                _post(url, {"prompt": "x", "max_tokens": 16},
                      headers={"Authorization": "Bearer sk-t"})
        assert e.value.code == 429 and e.value.headers.get("Retry-After")
    finally:
        gw.shutdown()
        httpd.shutdown()


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("front", ["jax_gateway_port_server", "port_gateway_jax_server"])
def test_gateway_fronts_the_other_package(stack, front):
    """The wire format is shared: each package's gateway relays, streams and
    reads the other package's server's ``/healthz`` digest, and the key it
    routes by is in that digest after a request."""
    mod, backend = ((jax_gw, stack["urls"][0]) if front == "jax_gateway_port_server"
                    else (port_gw, stack["jax_url"]))
    gw = mod.Gateway([backend], mod.GatewayConfig(host="127.0.0.1", port=0,
                                                  health_interval_s=3600))
    gport = gw.start()
    url = f"http://127.0.0.1:{gport}"
    try:
        payload = {"prompt": list(range(60, 84)), "max_tokens": 3, "temperature": 0,
                   "ignore_eos": True}
        status, out = _post(url + "/v1/completions", payload)
        assert status == 200 and out["usage"]["completion_tokens"] == 3
        status, ids, done = _stream(url + "/v1/completions",
                                    dict(payload, return_token_ids=True))
        assert status == 200 and done and len(ids) == 3
        assert _get_json(url + "/v1/models")["data"][0]["id"] == "tiny-qwen3"
        gw.probe_backends_once()
        b = gw.backends[0]
        assert b.healthy and b.kv_digest
        assert digest_has(b.kv_digest, b.kv_digest_bits, affinity_key(payload))
        assert len(_get_json(url + "/gateway/status")["backends"]) == 1
    finally:
        gw.shutdown()


def test_gateway_entry_point_exists():
    res = subprocess.run([sys.executable, "-m", "tpuserve_torch.server.gateway", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--backends-file" in res.stdout
