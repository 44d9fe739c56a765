"""Tool calling and request tracing in the port, on the CPU, against the
JAX package.

The unit cases of tests/test_tool_calls.py (parsers, the streaming
hold-back filter, request validation, message normalisation, the
template's tool block) run on both packages' ``tool_calls`` modules and
must give equal outputs.  The server cases run through the port's server
and the JAX server side by side: with the engine's output canned (a
patched ``runner.submit``, as in tests/test_tool_calls.py) the full
responses and the SSE events must be equal once the ids and timestamps
each server draws are set aside; with the real engines (the same seeded
float32 tiny-qwen3 weights), chat requests with ``tools`` under
``tool_choice`` auto, required and a named function, full and streamed,
must get the same status, content and finish reason, and no streamed
content may carry the forced marker.

Tracing: with a fake tracer standing in for the OTLP SDK, one request
gives one request span named by its route and the request's timeline as
``engine.<event>`` child spans, the JAX server's names in the JAX
server's order; ``extract_context`` degrades to None without a header or
without the opentelemetry API.
"""

import dataclasses
import json
import queue
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import tokenizer as jax_tokenizer
from tpuserve.models import weights as jax_weights
from tpuserve.runtime import request as jax_request
from tpuserve.server import tool_calls as jax_tc
from tpuserve.server import tracing as jax_tracing
from tpuserve.server.openai_api import OpenAIServer as JaxServer
from tpuserve.server.openai_api import ServerConfig as JaxServerConfig
from tpuserve_torch import runtime as port_rt
from tpuserve_torch.models import tokenizer as port_tokenizer
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime import request as port_request
from tpuserve_torch.server import OpenAIServer, ServerConfig
from tpuserve_torch.server import tool_calls as port_tc
from tpuserve_torch.server import tracing as port_tracing
from tpuserve_torch.server.openai_api import build_parser, main

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
    monkeypatch.setenv("TPUSERVE_DEVPROF", "0")
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)


def _tools():
    return [{"type": "function",
             "function": {"name": "get_weather", "description": "weather lookup",
                          "parameters": {"type": "object", "properties": {
                              "city": {"type": "string"}}}}}]


def _calls(calls):
    return [(c.name, json.loads(c.arguments)) for c in calls]


# ---------------------------------------------------------------------------
# units (tests/test_tool_calls.py), each run on both modules: equal outputs
# ---------------------------------------------------------------------------

def _hermes_block(tc):
    content, calls = tc.HermesToolParser().extract(
        'Let me check.\n<tool_call>\n{"name": "get_weather", '
        '"arguments": {"city": "Paris"}}\n</tool_call>')
    assert content.strip() == "Let me check." and len(calls) == 1
    return content, _calls(calls)


def _hermes_multiple_and_unterminated(tc):
    _, calls = tc.HermesToolParser().extract(
        '<tool_call>{"name": "a", "arguments": {}}</tool_call>'
        '<tool_call>{"name": "b", "arguments": {"x": 1}}')
    assert [c.name for c in calls] == ["a", "b"]
    return _calls(calls)


def _hermes_garbage(tc):
    content, calls = tc.HermesToolParser().extract("<tool_call>not json</tool_call> hi")
    assert calls == [] and "not json" in content
    return content


def _mistral(tc):
    content, calls = tc.MistralToolParser().extract(
        'Sure. [TOOL_CALLS] [{"name": "f", "arguments": {"a": 2}}]')
    assert content.strip() == "Sure." and calls[0].name == "f"
    return content, _calls(calls)


def _llama3(tc):
    p = tc.Llama3JsonParser()
    content, calls = p.extract('{"name": "f", "parameters": {"q": "x"}}')
    assert content == "" and _calls(calls) == [("f", {"q": "x"})]
    prose, none = p.extract('{"name": "f", "parameters": {}} and more')
    assert none == [] and "and more" in prose
    return content, _calls(calls), prose


def _inference(tc):
    names = [tc.get_tool_parser(m).name for m in (
        "Qwen/Qwen3-0.6B", "mistralai/Mistral-7B-Instruct-v0.1", "meta-llama/Llama-3.1-8B",
        "anything-else")]
    assert names == ["hermes", "mistral", "llama3_json", "hermes"]
    with pytest.raises(ValueError):
        tc.get_tool_parser("x", override="nope")
    return names


def _forced_roundtrip(tc):
    p = tc.HermesToolParser()
    forced = p.forced_prefix("get_weather")
    _, calls = p.extract(forced + '{"city": "Nice"}}\n</tool_call>')
    assert _calls(calls) == [("get_weather", {"city": "Nice"})]
    return forced, [p.forced_prefix(None) for p in (tc.MistralToolParser(),
                                                    tc.Llama3JsonParser())]


def _filter_split_marker(tc):
    f = tc.ToolStreamFilter(tc.HermesToolParser())
    out = [f.feed("Sure, "), f.feed("<to"),
           f.feed('ol_call>{"name": "f", "arguments": {}}</tool_call>')]
    tail, calls = f.finish()
    assert "".join(out) == "Sure, " and tail == "" and calls[0].name == "f"
    return out, tail, _calls(calls)


def _filter_releases_plain(tc):
    f = tc.ToolStreamFilter(tc.HermesToolParser())
    out = [f.feed(d) for d in ("hello ", "<b>world", "</b> done")]
    tail, calls = f.finish()
    assert "".join(out) + tail == "hello <b>world</b> done" and calls == []
    return out, tail


def _filter_false_start(tc):
    f = tc.ToolStreamFilter(tc.HermesToolParser())
    out = f.feed("a <tool_call> that never closes with json")
    tail, calls = f.finish()
    assert calls == [] and out + tail == "a <tool_call> that never closes with json"
    return out, tail


def _filter_forced_never_leaks(tc):
    ctx = tc.ToolContext.from_body(
        {"tools": [{"type": "function", "function": {"name": "f"}}],
         "tool_choice": "required"}, "Qwen/Qwen3-0.6B")
    f = ctx.stream_filter()
    out = f.feed("I cannot call any tool for that.")
    tail, calls = f.finish()
    assert out == "" and calls == [] and tail == "I cannot call any tool for that."
    return out, tail


def _filter_forced_completes(tc):
    ctx = tc.ToolContext.from_body(
        {"tools": [{"type": "function", "function": {"name": "f"}}],
         "tool_choice": "required"}, "Qwen/Qwen3-0.6B")
    f = ctx.stream_filter()
    out = f.feed('{"name": "f", "arguments": {}}</tool_call>')
    tail, calls = f.finish()
    assert out == "" and tail == "" and calls[0].name == "f"
    return _calls(calls)


def _llama3_prose_streams(tc):
    f = tc.ToolStreamFilter(tc.Llama3JsonParser())
    out = [f.feed(d) for d in ("Here is the config: ", '{"a": 1}', " and more text")]
    tail, calls = f.finish()
    assert out == ["Here is the config: ", '{"a": 1}', " and more text"]
    assert calls == [] and tail == ""
    return out


def _llama3_holds_leading_call(tc):
    f = tc.ToolStreamFilter(tc.Llama3JsonParser())
    out = [f.feed('{"name": "f", '), f.feed('"parameters": {"q": 1}}')]
    tail, calls = f.finish()
    assert out == ["", ""] and tail == "" and calls[0].name == "f"
    return _calls(calls)


def _validation(tc):
    assert tc.ToolContext.from_body({}, "m") is None
    assert tc.ToolContext.from_body({"tools": _tools(), "tool_choice": "none"}, "m") is None
    auto = tc.ToolContext.from_body({"tools": _tools()}, "m")
    named = tc.ToolContext.from_body(
        {"tools": _tools(),
         "tool_choice": {"type": "function", "function": {"name": "get_weather"}}}, "m")
    assert auto.parser.name == "hermes" and auto.forced == "" and "get_weather" in named.forced
    errors = []
    for bad in ({"tools": []}, {"tools": "x"},
                {"tools": [{"type": "function", "function": {"name": ""}}]},
                {"tools": [{"function": {"name": "f"}}]},
                {"tools": _tools(), "tool_choice": "sometimes"},
                {"tools": _tools(),
                 "tool_choice": {"type": "function", "function": {"name": "nope"}}},
                {"tool_choice": "required"},
                {"tools": [{"type": "function", "function": {"name": "f",
                                                             "parameters": 3}}]}):
        with pytest.raises(ValueError) as ei:
            tc.ToolContext.from_body(bad, "m")
        errors.append(str(ei.value))
    return auto.forced, named.forced, errors


def _postprocess(tc):
    ctx = tc.ToolContext.from_body(
        {"tools": _tools(),
         "tool_choice": {"type": "function", "function": {"name": "get_weather"}}}, "m")
    content, calls = ctx.postprocess('{"city": "Oslo"}}</tool_call>')
    failed = ctx.postprocess("no call at all")
    assert failed == ("no call at all", None)
    return content, [(c["type"], c["function"]) for c in calls], failed


def _normalize(tc):
    msgs = tc.normalize_messages([
        {"role": "user", "content": [{"type": "text", "text": "a"},
                                     {"type": "text", "text": "b"}]},
        {"role": "assistant", "content": None,
         "tool_calls": [{"id": "call_1", "type": "function",
                         "function": {"name": "f", "arguments": "{}"}}]},
        {"role": "tool", "content": "42", "tool_call_id": "call_1"}])
    assert msgs[0]["content"] == "ab" and msgs[1]["content"] == "" and msgs[2]["role"] == "tool"
    for bad in ([{"content": "x"}], [{"role": "user", "content": None}],
                [{"role": "user", "content": [{"type": "image_url"}]}],
                [{"role": "user", "content": 7}],
                [{"role": "assistant", "content": None,
                  "tool_calls": [{"type": "function", "function": {"arguments": "{}"}}]}]):
        with pytest.raises(ValueError):
            tc.normalize_messages(bad)
    return msgs


def _prompt_instruction(tc):
    tok = port_tokenizer if tc is port_tc else jax_tokenizer
    msgs = [{"role": "user", "content": "hi"}]
    rendered = {}
    for name, marker in (("mistral", "[TOOL_CALLS]"),
                         ("llama3_json", '{"name": <name>, "parameters"'),
                         ("hermes", "<tool_call>")):
        p = tc.get_tool_parser("m", override=name)
        rendered[name] = tok.default_chat_template(
            msgs, tools=_tools(), tool_instruction=p.prompt_instruction(json.dumps(_tools())))
        assert marker in rendered[name]
    history = tok.default_chat_template(tc.normalize_messages([
        {"role": "assistant", "content": None,
         "tool_calls": [{"id": "c", "type": "function",
                         "function": {"name": "f", "arguments": "{}"}}]},
        {"role": "tool", "content": "42"}]))
    assert "f" in history and "42" in history
    return rendered, history


UNITS = [_hermes_block, _hermes_multiple_and_unterminated, _hermes_garbage, _mistral,
         _llama3, _inference, _forced_roundtrip, _filter_split_marker,
         _filter_releases_plain, _filter_false_start, _filter_forced_never_leaks,
         _filter_forced_completes, _llama3_prose_streams, _llama3_holds_leading_call,
         _validation, _postprocess, _normalize, _prompt_instruction]


@pytest.mark.parametrize("unit", UNITS, ids=[u.__name__.strip("_") for u in UNITS])
def test_units_give_the_jax_modules_outputs(unit):
    assert unit(port_tc) == unit(jax_tc)


def test_tool_call_wire_shape_matches_the_jax_module():
    ours = port_tc.ToolCall("f", '{"a": 1}').as_openai()
    ref = jax_tc.ToolCall("f", '{"a": 1}').as_openai()
    assert ours["id"].startswith("call_") and len(ours["id"]) == len(ref["id"])
    assert {k: v for k, v in ours.items() if k != "id"} == \
        {k: v for k, v in ref.items() if k != "id"}


# ---------------------------------------------------------------------------
# the server twin
# ---------------------------------------------------------------------------

CACHE = dict(block_size=8, num_blocks=128, max_blocks_per_seq=48, dtype="float32")
SCHED = dict(max_num_seqs=8, min_prefill_bucket=8, min_decode_bucket=2)


@pytest.fixture(scope="module")
def servers(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")

    def conf(rt):
        # the tools' JSON rides the prompt: ~400-byte prompts
        return rt.EngineConfig(model="tiny-qwen3", cache=rt.CacheConfig(**CACHE),
                               scheduler=rt.SchedulerConfig(**SCHED), attn_impl="reference",
                               multi_step=1, seed=0)
    port = OpenAIServer(port_rt.Engine(conf(port_rt), params=params, model_cfg=cfg,
                                       device="cpu"),
                        ServerConfig(host="127.0.0.1", port=0))
    jsrv = JaxServer(jax_rt.Engine(conf(jax_rt), params=jparams, model_cfg=jcfg),
                     JaxServerConfig(host="127.0.0.1", port=0, tpu_metrics=False,
                                     slo_burn=False))
    urls = {"port": f"http://127.0.0.1:{port.start()}", "jax": f"http://127.0.0.1:{jsrv.start()}"}
    yield urls, {"port": port, "jax": jsrv}
    port.shutdown()
    jsrv.shutdown()


def _post(url, payload, headers=None):
    """(status, JSON body, or the SSE events' JSON payloads)."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            data = r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    if payload.get("stream"):
        return 200, [json.loads(ln[len("data: "):]) for ln in data.splitlines()
                     if ln.startswith("data: ") and ln != "data: [DONE]"]
    return 200, json.loads(data)


def _scrub(x):
    """A response without what each server draws anew: ids, timestamps."""
    if isinstance(x, dict):
        return {k: _scrub(v) for k, v in x.items() if k not in ("id", "created")}
    if isinstance(x, list):
        return [_scrub(v) for v in x]
    return x


def _canned_submit(request_mod, text_chunks, finish):
    """A ``runner.submit`` stand-in yielding canned outputs."""
    def submit(params=None, **kwargs):
        q = queue.Queue()
        for i, t in enumerate(text_chunks):
            last = i == len(text_chunks) - 1
            q.put(request_mod.RequestOutput(
                request_id="fake", new_token_ids=[i], new_text=t, finished=last,
                finish_reason=getattr(request_mod.FinishReason, finish) if last else None,
                num_prompt_tokens=3, num_output_tokens=i + 1))
        q.put(None)
        return "fake", q
    return submit


CANNED = {
    "call": (["I will check. ", '<tool_call>{"name": "get_weather", '
              '"arguments": {"city": "Paris"}}</tool_call>'], "STOP"),
    "split_marker": (["Checking ", "now. <tool", '_call>{"name": "get_weather", ',
                      '"arguments": {"city": "Nice"}}</tool_call>'], "STOP"),
    "false_start": (["an honest <tool", " tag, no call"], "LENGTH"),
    "no_call": (["plain ", "words"], "STOP"),
}
BODIES = {
    "auto": {"tools": _tools()},
    "required": {"tools": _tools(), "tool_choice": "required"},
    "named": {"tools": _tools(),
              "tool_choice": {"type": "function", "function": {"name": "get_weather"}}},
    "no_tools": {},
}


@pytest.mark.parametrize("canned", list(CANNED))
@pytest.mark.parametrize("choice", list(BODIES))
@pytest.mark.parametrize("stream", [False, True], ids=["full", "sse"])
def test_canned_outputs_answer_like_the_jax_server(servers, monkeypatch, canned, choice,
                                                   stream):
    urls, srvs = servers
    chunks, finish = CANNED[canned]
    for k, mod in (("port", port_request), ("jax", jax_request)):
        monkeypatch.setattr(srvs[k].runner, "submit", _canned_submit(mod, chunks, finish))
    body = dict(BODIES[choice], messages=[{"role": "user", "content": "weather?"}],
                stream=stream)
    got = {k: _post(urls[k] + "/v1/chat/completions", body) for k in urls}
    assert got["port"][0] == got["jax"][0] == 200
    assert _scrub(got["port"][1]) == _scrub(got["jax"][1])
    if stream:
        events = got["port"][1]
        text = "".join(e["choices"][0]["delta"].get("content", "")
                       for e in events if e["choices"])
        if canned == "no_call":
            # a forced call's prefix is never content, even when no call parses
            assert text == "plain words"
        calls = [c for e in events if e["choices"]
                 for c in e["choices"][0]["delta"].get("tool_calls", [])]
        ids = [c["id"] for c in calls]
    else:
        msg = got["port"][1]["choices"][0]["message"]
        ids = [c["id"] for c in msg.get("tool_calls", [])]
    assert all(i.startswith("call_") and len(i) == 29 for i in ids)


@pytest.mark.parametrize("choice", ["auto", "required", "named"])
@pytest.mark.parametrize("stream", [False, True], ids=["full", "sse"])
def test_tools_on_the_real_engines_answer_like_the_jax_server(servers, choice, stream):
    """Random weights rarely spell a call: a forced call's text that does
    not parse is content without the forced marker, as in the JAX server;
    either way the two servers answer alike."""
    urls, _ = servers
    body = dict(BODIES[choice], messages=[{"role": "user", "content": "hi"}], max_tokens=6,
                temperature=0, ignore_eos=True, stream=stream)
    got = {k: _post(urls[k] + "/v1/chat/completions", body) for k in urls}
    assert got["port"][0] == got["jax"][0] == 200
    assert _scrub(got["port"][1]) == _scrub(got["jax"][1])
    if stream:
        finish = [e["choices"][0]["finish_reason"] for e in got["port"][1]
                  if e["choices"] and e["choices"][0]["finish_reason"]]
        text = "".join(e["choices"][0]["delta"].get("content", "")
                       for e in got["port"][1] if e["choices"])
    else:
        finish = [got["port"][1]["choices"][0]["finish_reason"]]
        text = got["port"][1]["choices"][0]["message"]["content"] or ""
    assert finish[-1] in ("stop", "length", "tool_calls")
    assert "<tool_call>" not in text


def test_malformed_tools_get_the_jax_servers_400(servers):
    urls, _ = servers
    for extra in ({"tools": [{"type": "function"}]}, {"tools": _tools(), "tool_choice": "maybe"},
                  {"tool_choice": "required"}):
        body = dict(extra, messages=[{"role": "user", "content": "hi"}])
        got = {k: _post(urls[k] + "/v1/chat/completions", body) for k in urls}
        assert got["port"][0] == got["jax"][0] == 400
        assert got["port"][1]["error"]["message"] == got["jax"][1]["error"]["message"]


def test_cli_accepts_the_tool_call_parser():
    args = build_parser().parse_args(["--tool-call-parser", "mistral"])
    assert args.tool_call_parser == "mistral"
    with pytest.raises(SystemExit) as ei:
        main(["--tool-call-parser", "nope"])
    assert ei.value.code == 2


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

class _FakeSpan:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def set_attribute(self, key, value):
        self.log.append(("attr", self.name, key))

    def end(self, end_time=None):
        self.log.append(("end", self.name))


class _FakeCM:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def __enter__(self):
        self.log.append(("request", self.name))
        return _FakeSpan(self.log, self.name)

    def __exit__(self, *exc):
        self.log.append(("request_end", self.name))
        return False


class _FakeTracer:
    def __init__(self):
        self.log = []

    def start_as_current_span(self, name, context=None):
        return _FakeCM(self.log, name)

    def start_span(self, name, start_time=None):
        self.log.append(("child", name))
        return _FakeSpan(self.log, name)


def test_request_and_engine_spans_are_the_jax_servers(servers, monkeypatch):
    urls, _ = servers
    spans = {}
    for k, mod in (("port", port_tracing), ("jax", jax_tracing)):
        tracer = mod.RequestTracer.__new__(mod.RequestTracer)
        tracer._tracer = _FakeTracer()
        monkeypatch.setattr(mod, "_tracer", tracer)
        for stream in (False, True):
            status, _ = _post(urls[k] + "/v1/completions",
                              {"prompt": [5, 6, 7], "max_tokens": 3, "temperature": 0,
                               "ignore_eos": True, "stream": stream})
            assert status == 200
        # both servers end a request's span (and emit its engine children)
        # after the response's last byte: wait for the second one's end
        deadline = time.monotonic() + 10
        while (tracer._tracer.log.count(("request_end", "/v1/completions")) < 2
               and time.monotonic() < deadline):
            time.sleep(0.01)
        spans[k] = [e for e in tracer._tracer.log if e[0] in ("request", "child",
                                                               "request_end")]
    assert spans["port"] == spans["jax"]
    names = [n for kind, n in spans["port"] if kind == "child"]
    assert spans["port"].count(("request", "/v1/completions")) == 2
    assert names[:3] == ["engine.queued", "engine.admitted", "engine.prefill"]
    assert "engine.finished" in names


def test_emit_timeline_spans_is_a_noop_when_inactive_and_never_raises():
    for mod in (port_tracing, jax_tracing):
        tracer = mod.RequestTracer()
        assert not tracer.active
        mod.emit_timeline_spans(tracer, [{"t": 1.0, "event": "QUEUED"}], lambda t: t)
        broken = mod.RequestTracer.__new__(mod.RequestTracer)
        broken._tracer = object()                # no start_span: swallowed
        mod.emit_timeline_spans(broken, [{"t": 1.0, "event": "QUEUED"}], lambda t: t)
        with tracer.request_span("x", a=1) as span:
            span.set_attribute("b", 2)


def test_extract_context_degrades_to_none(monkeypatch):
    for mod in (port_tracing, jax_tracing):
        assert mod.extract_context({}) is None
        assert mod.inject_headers({"x": "y"})["x"] == "y"
    monkeypatch.setitem(sys.modules, "opentelemetry.propagate", None)
    header = {"traceparent": "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"}
    for mod in (port_tracing, jax_tracing):
        assert mod.extract_context(header) is None
        assert mod.inject_headers({}) == {}
