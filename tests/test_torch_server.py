"""The port's HTTP server on the CPU, against the JAX package's server.

A port ``OpenAIServer`` over ``Engine(..., device="cpu")`` and a JAX
``OpenAIServer`` over the JAX engine serve float32 tiny-qwen3 with the same
weights (the JAX tree handed over as numpy), each on a free port.  For the
same requests they must give the same greedy tokens (text and usage when
not streamed, token ids when streamed), the same ``n`` choices, the same
chat text, the same statuses for malformed bodies, and the same 503s under
backpressure and while draining, the sampling options (greedy ones token
for token, logprobs within atol 1e-4) and the logprobs shapes.  Port-only:
guided requests (``response_format``, ``guided_regex``, ``guided_choice``)
give its text and finish reason, full and streamed, and a bad spec its
400 and message; CLI flags the port does not carry exit naming their
ROADMAP.md item, ``best_of`` returns its best candidate, a
mixed-batching engine serves concurrent streams, a failing step fails its
requests, ``/metrics`` has the JAX server's vllm_* families, and
``python -m tpuserve_torch.server`` starts, serves and drains on SIGTERM.

Sampled tokens cannot match across the two packages (their noise differs:
ROADMAP.md C), so the ``n``-choice comparison runs at a temperature of
1e-4, where the noise cannot move an argmax of these logits; the port's
seeded choices are checked against single seeded requests on their own.
"""

import dataclasses
import json
import os
import random
import re
import signal
import subprocess
import sys
import threading
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
from tpuserve.models.config import get_model_config as jax_get_model_config
from tpuserve.server.openai_api import OpenAIServer as JaxServer
from tpuserve.server.openai_api import ServerConfig as JaxServerConfig
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig, SamplingParams,
                                    SchedulerConfig)
from tpuserve_torch.server import OpenAIServer, ServerConfig
from tpuserve_torch.server.openai_api import main

ROOT = Path(__file__).resolve().parent.parent
CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16, dtype="float32")
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
def weights():
    jcfg = dataclasses.replace(jax_get_model_config("tiny-qwen3"), dtype="float32")
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _port_engine(weights, **sched):
    _, _, cfg, params = weights
    return Engine(EngineConfig(model="tiny-qwen3", cache=CacheConfig(**CACHE),
                               scheduler=SchedulerConfig(**dict(SCHED, **sched))),
                  params=params, model_cfg=cfg, device="cpu")


def _jax_engine(weights):
    jcfg, jparams, _, _ = weights
    return jax_rt.Engine(jax_rt.EngineConfig(
        model="tiny-qwen3", cache=jax_rt.CacheConfig(**CACHE),
        scheduler=jax_rt.SchedulerConfig(**SCHED), attn_impl="reference", multi_step=1),
        params=jparams, model_cfg=jcfg)


def _jax_server(engine):
    return JaxServer(engine, JaxServerConfig(host="127.0.0.1", port=0, tpu_metrics=False,
                                             slo_burn=False))


@pytest.fixture(scope="module")
def servers(weights):
    """{"port": url, "jax": url} and the two server objects."""
    port = OpenAIServer(_port_engine(weights), ServerConfig(host="127.0.0.1", port=0))
    jsrv = _jax_server(_jax_engine(weights))
    urls = {"port": f"http://127.0.0.1:{port.start()}",
            "jax": f"http://127.0.0.1:{jsrv.start()}"}
    yield urls, {"port": port, "jax": jsrv}
    port.shutdown()
    jsrv.shutdown()


def _request(url, payload=None, raw=False, timeout=120, headers=None):
    """(status, parsed body or raw text, headers); never raises on 4xx/5xx."""
    data = None if payload is None else json.dumps(payload, allow_nan=True).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read().decode()
            if raw or "json" not in r.headers.get("Content-Type", ""):
                return r.status, body, dict(r.headers)
            return r.status, json.loads(body), dict(r.headers)
    except urllib.error.HTTPError as e:
        body = e.read().decode()
        return e.code, json.loads(body) if body else None, dict(e.headers)


def _sse(url, payload):
    """A streamed request: (status, chunks, saw [DONE])."""
    status, raw, _ = _request(url, dict(payload, stream=True), raw=True)
    if status != 200:
        return status, raw, False
    events = [ln[len("data: "):] for ln in raw.splitlines() if ln.startswith("data: ")]
    done = events[-1] == "[DONE]"
    return status, [json.loads(e) for e in events[:-1] if e != "[DONE]"], done


def _both(servers, path, payload, stream=False):
    urls, _ = servers
    fn = _sse if stream else (lambda u, p: _request(u, p)[:2])
    return {k: fn(urls[k] + path, payload) for k in ("port", "jax")}


PROMPTS = ["Hello world", [5, 6, 7, 8, 9], "paged attention on a card", [300, 301, 302]]


@pytest.mark.parametrize("prompt", PROMPTS, ids=lambda p: "ids" if isinstance(p, list) else p)
def test_greedy_completions_match_the_jax_server(servers, prompt):
    body = {"prompt": prompt, "max_tokens": 8, "temperature": 0, "ignore_eos": True}
    full = _both(servers, "/v1/completions", body)
    streamed = _both(servers, "/v1/completions",
                     dict(body, return_token_ids=True, stream_options={"include_usage": True}),
                     stream=True)
    (ps, pb), (js, jb) = full["port"], full["jax"]
    assert ps == js == 200
    assert pb["choices"] == jb["choices"] and pb["usage"] == jb["usage"]
    ids = {}
    for k, (status, chunks, done) in streamed.items():
        assert status == 200 and done
        ids[k] = [t for c in chunks for ch in c["choices"] for t in ch.get("token_ids", [])]
        assert chunks[-1]["usage"] == pb["usage"]
        assert chunks[-2]["choices"][0]["finish_reason"] == "length"
        assert "".join(ch["text"] for c in chunks for ch in c["choices"]) == \
            pb["choices"][0]["text"]
    assert ids["port"] == ids["jax"] and len(ids["port"]) == 8


def test_n_choices_match_the_jax_server(servers):
    body = {"prompt": "choices", "max_tokens": 6, "n": 3, "temperature": 1e-4, "seed": 7,
            "ignore_eos": True}
    res = _both(servers, "/v1/completions", body)
    (ps, pb), (js, jb) = res["port"], res["jax"]
    assert ps == js == 200
    assert [c["index"] for c in pb["choices"]] == [0, 1, 2]
    assert pb["choices"] == jb["choices"] and pb["usage"] == jb["usage"]
    streamed = _both(servers, "/v1/completions", dict(body, return_token_ids=True),
                     stream=True)
    per_choice = {}
    for k, (status, chunks, done) in streamed.items():
        assert status == 200 and done
        got = {}
        for c in chunks:
            for ch in c["choices"]:
                got.setdefault(ch["index"], []).extend(ch["token_ids"])
        per_choice[k] = got
    assert per_choice["port"] == per_choice["jax"] and sorted(per_choice["port"]) == [0, 1, 2]


def test_seeded_choice_i_samples_with_seed_plus_i(servers):
    """Port only: choice i of a seeded request is the request seeded seed + i."""
    urls, _ = servers
    body = {"prompt": [7, 8, 9], "max_tokens": 6, "temperature": 0.9, "ignore_eos": True,
            "return_token_ids": True}
    _, chunks, _ = _sse(urls["port"] + "/v1/completions", dict(body, n=2, seed=11))
    got = {}
    for c in chunks:
        for ch in c["choices"]:
            got.setdefault(ch["index"], []).extend(ch["token_ids"])
    for i in range(2):
        _, alone, _ = _sse(urls["port"] + "/v1/completions", dict(body, seed=11 + i))
        assert got[i] == [t for c in alone for ch in c["choices"] for t in ch["token_ids"]]
    assert got[0] != got[1]


def test_chat_matches_the_jax_server(servers):
    body = {"messages": [{"role": "system", "content": "Be nice."},
                         {"role": "user", "content": [{"type": "text", "text": "hi"}]}],
            "max_tokens": 5, "temperature": 0, "ignore_eos": True}
    res = _both(servers, "/v1/chat/completions", body)
    (ps, pb), (js, jb) = res["port"], res["jax"]
    assert ps == js == 200 and pb["object"] == jb["object"] == "chat.completion"
    assert pb["choices"] == jb["choices"] and pb["usage"] == jb["usage"]
    streamed = _both(servers, "/v1/chat/completions", body, stream=True)
    texts = {k: "".join(ch["delta"].get("content", "") for c in chunks for ch in c["choices"])
             for k, (_, chunks, _) in streamed.items()}
    assert texts["port"] == texts["jax"] == pb["choices"][0]["message"]["content"]


MALFORMED = [
    ("/v1/completions", {}), ("/v1/completions", {"prompt": ""}),
    ("/v1/completions", {"prompt": ["a", "b"]}), ("/v1/chat/completions", {"messages": []}),
    ("/v1/completions", {"prompt": "x" * 5000, "max_tokens": 2}),
    ("/v1/completions", {"prompt": "x", "max_tokens": "lots"}),
    ("/v1/completions", {"prompt": "x", "temperature": "hot"}),
    ("/v1/completions", {"prompt": "x", "stop": [1, 2]}),
    ("/v1/completions", {"prompt": "x", "temperature": None, "max_tokens": 2,
                         "top_p": None, "ignore_eos": True}),
    ("/v1/completions", {"prompt": "x", "n": 0}),
    ("/v1/completions", {"prompt": "x", "suffix": "y"}),
    ("/v1/completions", {"prompt": "x", "max_tokens": 0}),
    ("/v1/completions", {"prompt": "x", "stream_options": 3}),
    ("/v1/chat/completions", {"messages": [{"content": "no role"}]}),
    ("/tokenize", {"prompt": 3}), ("/detokenize", {"tokens": [-1]}),
    ("/v2/whatever", {"prompt": "x"}),
]


@pytest.mark.parametrize("path,body", MALFORMED, ids=[f"{i}" for i in range(len(MALFORMED))])
def test_malformed_bodies_get_the_jax_servers_status(servers, path, body):
    res = _both(servers, path, body)
    assert res["port"][0] == res["jax"][0], (res["port"], res["jax"])
    if res["jax"][0] == 400:
        assert res["port"][1]["error"]["type"] == "invalid_request_error"


def test_get_routes_get_the_jax_servers_status(servers):
    urls, _ = servers
    for path in ("/v1/models", "/v1/models/tiny-qwen3", "/v1/models/nope", "/healthz",
                 "/readyz", "/v2/whatever"):
        assert _request(urls["port"] + path)[0] == _request(urls["jax"] + path)[0], path
    _, models, _ = _request(urls["port"] + "/v1/models")
    assert models["data"][0]["id"] == "tiny-qwen3" and models["data"][0]["max_model_len"] > 0


def test_fuzzed_bodies_never_5xx_and_keep_the_jax_servers_4xx(servers):
    """The JAX fuzz's keys and junk values (tests/test_server.py): the port
    answers every single-key body below 500; on a seeded sample both servers
    are asked, and where the JAX server refuses, so does the port."""
    urls, _ = servers
    junk = [None, True, False, -1, 0, 1.5, 2**40, -2**40, "x", "", [], ["a"], [None], {},
            {"a": None}, float("inf"), float("-inf"), "NaN", [2**40], [-5], {"k": []}]
    keys = ["model", "prompt", "messages", "input", "tokens", "encoding_format", "dimensions",
            "max_tokens", "min_tokens", "temperature", "top_k", "top_p", "min_p", "seed",
            "stop", "stop_token_ids", "logit_bias", "logprobs", "top_logprobs", "n",
            "best_of", "echo", "stream", "stream_options", "response_format", "guided_regex",
            "guided_choice", "prompt_logprobs", "truncate_prompt_tokens", "priority",
            "presence_penalty", "frequency_penalty", "repetition_penalty", "ignore_eos",
            "tools", "tool_choice"]
    rng = random.Random(11)
    probes = []
    for path in ("/v1/completions", "/v1/chat/completions", "/v1/embeddings", "/tokenize",
                 "/detokenize"):
        base = {"prompt": "x", "input": "x", "tokens": [1], "max_tokens": 1}
        if "chat" in path:
            base["messages"] = [{"role": "user", "content": "x"}]
        probes += [(path, dict(base, **{k: v})) for k in keys for v in junk]
    for path, body in probes:
        status = _request(urls["port"] + path, body)[0]
        assert status < 500, (path, body, status)
    for path, body in rng.sample(probes, 30):
        p, j = _request(urls["port"] + path, body)[0], _request(urls["jax"] + path, body)[0]
        assert p < 500 and (j < 400 or 400 <= p < 500), (path, body, p, j)


def test_backpressure_gets_the_jax_servers_503(servers, monkeypatch):
    urls, srvs = servers

    def full(*a, **kw):
        raise MemoryError("waiting queue full (test)")
    for k in ("port", "jax"):
        monkeypatch.setattr(srvs[k].engine, "add_request", full)
    body = {"prompt": "x", "max_tokens": 4, "ignore_eos": True}
    for stream in (False, True):
        got = {k: _request(urls[k] + "/v1/completions", dict(body, stream=stream))
               for k in ("port", "jax")}
        for status, err, headers in got.values():
            assert status == 503 and headers.get("Retry-After") == "1"
            assert "waiting queue full" in err["error"]["message"]


def test_draining_gets_the_jax_servers_503(weights):
    """drain() with a handler still in flight: readyz and new requests get
    503 with Retry-After on both servers; drain returns once it leaves."""
    results = {}
    for name, srv in (("port", OpenAIServer(_port_engine(weights),
                                            ServerConfig(host="127.0.0.1", port=0))),
                      ("jax", _jax_server(_jax_engine(weights)))):
        url = f"http://127.0.0.1:{srv.start()}"
        srv._handler_enter()                      # a request still being delivered
        drained = {}
        t = threading.Thread(target=lambda s=srv: drained.setdefault("ok", s.drain(30)))
        t.start()
        deadline = time.monotonic() + 10
        while not srv.draining and time.monotonic() < deadline:
            time.sleep(0.01)
        post = _request(url + "/v1/completions", {"prompt": "x", "max_tokens": 2})
        ready = _request(url + "/readyz")
        srv._handler_exit()
        t.join(timeout=30)
        assert not t.is_alive()
        results[name] = (post[0], post[2].get("Retry-After"), ready[0], drained.get("ok"))
    assert results["port"] == results["jax"] == (503, "1", 503, True)


# guided decoding's request shapes, each greedy: the port's text and
# finish reason must be the JAX server's
GUIDED = {
    "json_object": {"response_format": {"type": "json_object"}},
    "json_schema": {"response_format": {"type": "json_schema", "json_schema": {
        "name": "pet", "schema": {"type": "object", "properties": {
            "name": {"type": "string"}, "ok": {"type": "boolean"}},
            "required": ["name", "ok"], "additionalProperties": False}}}},
    "guided_regex": {"guided_regex": "[0-9]{3}-[0-9]{4}"},
    "guided_choice": {"guided_choice": ["yes", "no", "maybe"]},
}


@pytest.mark.parametrize("name", list(GUIDED))
@pytest.mark.parametrize("stream", [False, True], ids=["full", "sse"])
def test_guided_requests_are_served_like_the_jax_server(servers, name, stream):
    """A guided completion gives the JAX server's text and finish reason,
    full or streamed, and a document of its spec when it stopped."""
    body = {"prompt": "x", "max_tokens": 32, "temperature": 0, **GUIDED[name]}
    res = _both(servers, "/v1/completions", body, stream=stream)
    out = {}
    for k, (status, payload, *rest) in res.items():
        assert status == 200, (k, payload)
        if stream:
            assert rest[0]
            out[k] = ("".join(ch["text"] for c in payload for ch in c["choices"]),
                      payload[-1]["choices"][0]["finish_reason"])
        else:
            out[k] = (payload["choices"][0]["text"], payload["choices"][0]["finish_reason"])
    assert out["port"] == out["jax"]
    text, reason = out["port"]
    if reason == "stop":
        if name.startswith("json"):
            assert isinstance(json.loads(text), dict)
        elif name == "guided_regex":
            assert re.fullmatch("[0-9]{3}-[0-9]{4}", text)
        else:
            assert text in ("yes", "no", "maybe")


BAD_GUIDED = [
    {"response_format": {"type": "json_schema", "json_schema": {"schema": {
        "type": "object", "patternProperties": {}}}}},
    {"guided_regex": "a(?=b)"},
    {"guided_choice": []},
    {"guided_choice": ["a"], "logprobs": 2},
]


@pytest.mark.parametrize("extra", BAD_GUIDED, ids=["schema", "regex", "choice", "logprobs"])
def test_bad_guided_specs_get_the_jax_servers_400(servers, extra):
    """An unsupported schema, pattern or choice list, or logprobs with a
    guided mode: a 400 with the JAX server's message."""
    body = {"prompt": "x", "max_tokens": 4, **extra}
    res = _both(servers, "/v1/completions", body)
    assert res["port"][0] == res["jax"][0] == 400
    assert res["port"][1]["error"]["message"] == res["jax"][1]["error"]["message"]


def test_metrics_count_guided_requests(servers):
    """/metrics carries the JAX server's three guided counters, fed from
    the engine's stats."""
    urls, srvs = servers
    _request(urls["port"] + "/v1/completions", {"prompt": "g", "max_tokens": 8,
                                                "guided_choice": ["ab", "cd"]})
    stats = srvs["port"].engine.stats
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        _, text, _ = _request(urls["port"] + "/metrics", raw=True)
        lines = {ln.split("{")[0]: float(ln.split()[-1]) for ln in text.splitlines()
                 if ln.startswith("tpuserve_guided_")}
        if lines.get("tpuserve_guided_fsm_requests_total") == stats.guided_fsm_requests:
            break
        time.sleep(0.05)
    assert set(lines) == {"tpuserve_guided_fallbacks_total",
                          "tpuserve_guided_fsm_requests_total",
                          "tpuserve_guided_fsm_windows_total"}
    assert lines["tpuserve_guided_fsm_requests_total"] == stats.guided_fsm_requests >= 1
    _, jtext, _ = _request(urls["jax"] + "/metrics", raw=True)
    assert all(f"# TYPE {name} counter" in jtext for name in lines)


# the sampling options the JAX server serves: greedy ones compared token
# for token (and logprob for logprob, atol 1e-4) with it, sampled ones
# held to a well-formed answer (the two packages' noise differs)
SERVED = [
    ({"top_p": 0.9}, False), ({"top_k": 5}, False), ({"min_p": 0.1}, False),
    ({"presence_penalty": 0.5, "temperature": 0}, True),
    ({"repetition_penalty": 1.2, "temperature": 0}, True),
    ({"logprobs": 2, "temperature": 0}, True),
    ({"logit_bias": {"5": 10}, "temperature": 0}, True),
    ({"min_tokens": 2, "temperature": 0}, True),
    ({"best_of": 2, "temperature": 0.8}, False),
]


def _same_logprobs(a, b):
    """Two completions logprobs objects: the same tokens and top ids, the
    values within atol 1e-4."""
    assert a["tokens"] == b["tokens"]
    np.testing.assert_allclose(a["token_logprobs"], b["token_logprobs"], atol=1e-4, rtol=0)
    for x, y in zip(a["top_logprobs"], b["top_logprobs"]):
        assert list(x) == list(y)
        np.testing.assert_allclose(list(x.values()), list(y.values()), atol=1e-4, rtol=0)


@pytest.mark.parametrize("extra,greedy", SERVED, ids=["/".join(e) for e, _ in SERVED])
@pytest.mark.parametrize("stream", [False, True], ids=["full", "sse"])
def test_sampling_options_are_served_like_the_jax_server(servers, extra, greedy, stream):
    """A 200 with a well-formed body or event stream, as the JAX server
    answers (``best_of > n`` cannot stream: both give 400); greedy ones
    give its tokens, text and logprobs."""
    body = {"prompt": "x", "max_tokens": 6, "ignore_eos": True, "return_token_ids": True,
            **extra}
    res = _both(servers, "/v1/completions", body, stream=stream)
    (ps, pb, *_), (js, jb, *_) = res["port"], res["jax"]
    assert ps == js, (res["port"], res["jax"])
    if "best_of" in extra and stream:
        assert ps == 400
        return
    assert ps == 200
    if not stream:
        (choice,), (jchoice,) = pb["choices"], jb["choices"]
        assert isinstance(choice["text"], str) and choice["finish_reason"] == "length"
        assert pb["usage"] == jb["usage"]
        if "best_of" in extra:
            # both candidates billed; the ranking's logprobs stripped
            assert pb["usage"]["completion_tokens"] == 12 and "logprobs" not in choice
        assert ("logprobs" in choice) == ("logprobs" in extra) == ("logprobs" in jchoice)
        if greedy:
            assert choice["text"] == jchoice["text"]
            if "logprobs" in extra:
                _same_logprobs(choice["logprobs"], jchoice["logprobs"])
                assert all(len(t) == 2 for t in choice["logprobs"]["top_logprobs"])
        return
    ids, lps = {}, {}
    for k, (status, chunks, done) in res.items():
        assert status == 200 and done
        ids[k] = [t for c in chunks for ch in c["choices"] for t in ch["token_ids"]]
        lps[k] = [ch["logprobs"] for c in chunks for ch in c["choices"] if "logprobs" in ch]
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert len(ids["port"]) == 6
    if "logprobs" in extra:
        merged = {k: {f: [x for lp in v for x in lp[f]] for f in
                      ("tokens", "token_logprobs", "top_logprobs")} for k, v in lps.items()}
        assert merged["port"]["tokens"] == ids["port"]
        _same_logprobs(merged["port"], merged["jax"])
    if greedy:
        assert ids["port"] == ids["jax"]


def test_chat_logprobs_match_the_jax_server(servers):
    """Chat ``logprobs``/``top_logprobs``: the per-token content entries
    (vocabulary token strings, top alternatives), full and streamed, as
    the JAX server's, values within atol 1e-4."""
    body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 5,
            "temperature": 0, "ignore_eos": True, "logprobs": True, "top_logprobs": 3}
    res = _both(servers, "/v1/chat/completions", body)
    (ps, pb), (js, jb) = res["port"], res["jax"]
    assert ps == js == 200
    got, want = pb["choices"][0]["logprobs"]["content"], jb["choices"][0]["logprobs"]["content"]
    streamed = _both(servers, "/v1/chat/completions", body, stream=True)
    chunks = streamed["port"][1]
    got_sse = [e for c in chunks for ch in c["choices"] if "logprobs" in ch
               for e in ch["logprobs"]["content"]]
    for entries in (got, got_sse):
        assert [e["token"] for e in entries] == [e["token"] for e in want]
        np.testing.assert_allclose([e["logprob"] for e in entries],
                                   [e["logprob"] for e in want], atol=1e-4, rtol=0)
        assert [[t["token"] for t in e["top_logprobs"]] for e in entries] == [
            [t["token"] for t in e["top_logprobs"]] for e in want]
    assert len(got) == 5 and all(len(e["top_logprobs"]) == 3 for e in got)


def test_best_of_ranks_candidates_by_cumulative_logprob(servers):
    """``best_of`` 3, n 1: the returned text is the candidate of highest
    cumulative logprob among the three the server sampled (seeds seed,
    seed + 1, seed + 2, each checked alone with logprobs)."""
    urls, _ = servers
    body = {"prompt": [7, 8, 9], "max_tokens": 6, "temperature": 1.5, "seed": 3,
            "ignore_eos": True}
    status, best, _ = _request(urls["port"] + "/v1/completions", dict(body, best_of=3))
    assert status == 200 and len(best["choices"]) == 1
    cands = []
    for i in range(3):
        _, alone, _ = _request(urls["port"] + "/v1/completions",
                               dict(body, seed=3 + i, logprobs=0))
        ch = alone["choices"][0]
        cands.append((sum(ch["logprobs"]["token_logprobs"]), ch["text"]))
    assert best["choices"][0]["text"] == max(cands, key=lambda c: c[0])[1]
    assert best["usage"]["completion_tokens"] == 18
    status, err, _ = _request(urls["port"] + "/v1/completions",
                              dict(body, best_of=2, temperature=0))
    assert status == 400 and "sampling" in err["error"]["message"]


def test_metrics_have_the_jax_servers_vllm_families(servers):
    urls, _ = servers
    _request(urls["port"] + "/v1/completions", {"prompt": "m", "max_tokens": 2})

    def families(url):
        _, text, _ = _request(url + "/metrics", raw=True)
        # prometheus_client adds a _created gauge per family (its creation
        # time); the port renders no timestamps
        return {ln.split()[2]: ln.split()[3] for ln in text.splitlines()
                if ln.startswith("# TYPE vllm_") and not ln.split()[2].endswith("_created")}
    ours, ref = families(urls["port"]), families(urls["jax"])
    assert ours == ref and len(ours) == 12
    _, text, _ = _request(urls["port"] + "/metrics", raw=True)
    assert 'vllm_time_to_first_token_seconds_bucket{le="0.01",model_name="tiny-qwen3"}' in text
    assert 'vllm_request_duration_seconds_bucket{le="+Inf",model_name="tiny-qwen3"}' in text


def test_mixed_batching_serves_concurrent_streams(servers, weights):
    """Four concurrent streams through a mixed-batching port engine give the
    JAX server's greedy tokens for the same prompts."""
    urls, _ = servers
    srv = OpenAIServer(_port_engine(weights, mixed_batching=True, mixed_token_budget=16),
                       ServerConfig(host="127.0.0.1", port=0))
    url = f"http://127.0.0.1:{srv.start(warmup=True)}"
    prompts = [[11, 12, 13], list(range(20, 40)), [50, 51], list(range(60, 73))]
    body = {"max_tokens": 10, "temperature": 0, "ignore_eos": True, "return_token_ids": True}
    got = {}

    def run(i):
        got[i] = _sse(url + "/v1/completions", dict(body, prompt=prompts[i]))
    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    try:
        assert srv.engine.stats.num_mixed_steps > 0
        for i, p in enumerate(prompts):
            status, chunks, done = got[i]
            assert status == 200 and done
            ids = [t for c in chunks for ch in c["choices"] for t in ch["token_ids"]]
            _, ref, _ = _sse(urls["jax"] + "/v1/completions", dict(body, prompt=p))
            assert ids == [t for c in ref for ch in c["choices"] for t in ch["token_ids"]]
    finally:
        srv.shutdown()


def test_a_failing_step_fails_its_requests_and_the_server_goes_on(weights):
    """With a salvage budget of 0 (``max_salvages``), the first faulted step
    fails the requests it carried, as the JAX runner does once salvage
    gives up (tests/test_torch_salvage.py holds the salvage itself)."""
    srv = OpenAIServer(_port_engine(weights), ServerConfig(host="127.0.0.1", port=0))
    srv.runner.max_salvages = 0
    url = f"http://127.0.0.1:{srv.start()}"
    real = srv.engine.step
    calls = {"n": 0}

    def boom():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device fault (test)")
        return real()
    srv.engine.step = boom
    try:
        body = {"prompt": [5, 6], "max_tokens": 3, "ignore_eos": True, "temperature": 0}
        status, err, _ = _request(url + "/v1/completions", body)
        assert status == 500 and "device fault (test)" in err["error"]["message"]
        assert srv.runner.steps_failed == 1
        status, ok, _ = _request(url + "/v1/completions", body)
        assert status == 200 and ok["usage"]["completion_tokens"] == 3
        outs, _ = srv.runner.generate_sync(
            prompt_token_ids=[5, 6], params=SamplingParams(max_tokens=3, temperature=0.0,
                                                           ignore_eos=True))
        assert [o.num_output_tokens for o in outs] == [1, 2, 3] and outs[-1].finished
        assert srv.engine.block_manager.num_seqs() == 0
    finally:
        srv.shutdown()


def test_cli_rejects_unported_flags_naming_their_item(capsys):
    # A8's flags (--quantization, --lora, --lora-modules), A9's
    # (tests/test_torch_obs.py, tests/test_torch_modelpool.py serve them)
    # and A10's (--tp, --pp, --multihost, --disagg, --role:
    # tests/test_torch_multihost.py, test_torch_pp.py,
    # test_torch_disagg_net.py) are ported; --pp exits only where the JAX
    # CLI refuses it
    for argv, says in ((["--pp", "2", "--tp", "2"], "--pp and --tp are mutually exclusive"),
                       (["--pp", "2", "--disagg"], "drop --disagg/--role/--multihost"),
                       (["--pp", "2", "--role", "decode"], "drop --disagg/--role/--multihost"),
                       (["--pp", "2", "--multihost"], "drop --disagg/--role/--multihost")):
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert ei.value.code == 2
        err = capsys.readouterr().err
        assert says in err and "ROADMAP.md" not in err, argv
    # A10's ported flags parse, card or none, and the JAX server's
    # topology checks refuse what they refuse there
    from tpuserve_torch.server.openai_api import build_parser
    args = build_parser().parse_args(["--tp", "2", "--multihost", "--disagg", "--role",
                                      "decode", "--decode-url", "http://d:1", "--pp", "4"])
    assert (args.tp, args.multihost, args.disagg, args.role, args.decode_url, args.pp) == (
        2, True, True, "decode", "http://d:1", 4)
    for argv, says in ((["--role", "decode", "--disagg"], "--role prefill/decode is its own"),
                       (["--role", "prefill", "--multihost"], "--role prefill/decode is its own"),
                       (["--role", "prefill"], "--role prefill requires --decode-url"),
                       # the JAX server cannot serve a pair across processes
                       (["--disagg", "--multihost"], "cannot mirror an in-process "
                                                     "prefill/decode pair")):
        with pytest.raises(SystemExit) as ei:
            main(["--model", "tiny-qwen3"] + argv)
        assert ei.value.code == 2
        err = capsys.readouterr().err
        assert says in err and "ROADMAP.md" not in err, argv
    # a ported flag is taken: with it the CLI gets as far as the engine
    # (which, without a card, exits naming device='cpu')
    if not torch.cuda.is_available():
        for argv in (["--tool-call-parser", "hermes", "--no-kv-tiers"],
                     ["--model-catalog", "tiny-llama", "--tenant-config", "{}"],
                     ["--tp", "2"], ["--pp", "2"], ["--disagg"], ["--multihost"],
                     # disaggregation on a --tp mesh, as the JAX server's
                     ["--disagg", "--tp", "2"], ["--role", "decode", "--tp", "2"],
                     ["--role", "prefill", "--decode-url", "http://d:1", "--tp", "2"]):
            with pytest.raises(SystemExit) as ei:
                main(["--model", "tiny-qwen3"] + argv)
            assert "device='cpu'" in str(ei.value.code)
            assert "ROADMAP.md" not in capsys.readouterr().err


def test_cli_without_a_card_exits_with_the_engines_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(SystemExit) as ei:
        main(["--model", "tiny-qwen3", "--no-kv-tiers", "--no-devprof"])
    assert "device='cpu'" in str(ei.value.code)


def test_cli_serves_and_drains_on_sigterm():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuserve_torch.server", "--device", "cpu", "--model",
         "tiny-qwen3", "--host", "127.0.0.1", "--port", "0", "--block-size", "4",
         "--num-blocks", "64", "--max-blocks-per-seq", "16", "--no-slo-burn"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert "listening on 127.0.0.1:" in line, line
        url = "http://127.0.0.1:" + line.strip().rsplit(":", 1)[1]
        assert _request(url + "/readyz")[0] == 200
        status, chunks, done = _sse(url + "/v1/completions",
                                    {"prompt": [5, 6, 7], "max_tokens": 4, "temperature": 0,
                                     "ignore_eos": True, "return_token_ids": True})
        assert status == 200 and done
        assert sum(len(ch["token_ids"]) for c in chunks for ch in c["choices"]) == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
