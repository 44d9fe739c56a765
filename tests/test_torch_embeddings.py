"""The cache-less trunks in the port against the JAX package: embeddings
and prompt scoring, from the model functions (float32 tiny-qwen3, atol
1e-4 on embeddings and logprobs, ranks and tokens exactly) through the
engine (entries, batching under the attention-score budget, its refusal,
warmup) to the HTTP surfaces: ``/v1/embeddings``, prompt scoring,
``prompt_logprobs`` and ``echo`` with ``logprobs``, full and streamed, each
answered with the JAX server's JSON; the speculative counters on
``/metrics``; the four CLI flags; and the loop thread that runs the trunks
for the server.

Both sides run the same parameters (the JAX tree handed over as numpy)
with the plain attention; ``chip_smoke.py`` phase ``embed`` holds the
trunks' kernel (B1) on the card.
"""

import base64
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import transformer as jax_tf
from tpuserve.models import weights as jax_weights
from tpuserve.runtime import spec as jax_spec
from tpuserve.server.openai_api import OpenAIServer as JaxServer
from tpuserve.server.openai_api import ServerConfig as JaxServerConfig
from tpuserve_torch.models import transformer
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SchedulerConfig
from tpuserve_torch.runtime.spec import SpecConfig
from tpuserve_torch.server import OpenAIServer, ServerConfig
from tpuserve_torch.server.openai_api import build_parser, engine_config, main


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads and full float32 matmuls while this file
    runs: under pytest-xdist several files run at once on the same cores."""
    n = torch.get_num_threads()
    prec = torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


ATOL = 1e-4
CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16, dtype="float32")
SCHED = dict(max_num_seqs=8, min_prefill_bucket=8, min_decode_bucket=2)


@pytest.fixture(scope="module")
def weights(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _port_engine(weights, **kw):
    _, _, cfg, params = weights
    return Engine(EngineConfig(model="tiny-qwen3", cache=CacheConfig(**CACHE),
                               scheduler=SchedulerConfig(**SCHED), **kw),
                  params=params, model_cfg=cfg, device="cpu")


def _jax_engine(weights, **kw):
    jcfg, jparams, _, _ = weights
    return jax_rt.Engine(jax_rt.EngineConfig(
        model="tiny-qwen3", cache=jax_rt.CacheConfig(**CACHE),
        scheduler=jax_rt.SchedulerConfig(**SCHED), attn_impl="reference", multi_step=1,
        **kw), params=jparams, model_cfg=jcfg)


@pytest.fixture(scope="module")
def engines(weights):
    return _port_engine(weights), _jax_engine(weights)


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------

def _padded_batch(seed, lens, T, vocab):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(0, vocab, n)
    return tokens, np.asarray(lens, np.int32)


@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_embed_forward_matches_jax(weights, pooling):
    jcfg, jparams, cfg, params = weights
    tokens, lens = _padded_batch(1, [16, 5, 1, 11], 16, cfg.vocab_size)
    want = np.asarray(jax_tf.embed_forward(jparams, jcfg, jnp.asarray(tokens),
                                           jnp.asarray(lens), pooling=pooling))
    got = transformer.embed_forward(params, cfg, torch.from_numpy(tokens),
                                    torch.from_numpy(lens), pooling=pooling)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("top_n", [0, 3])
def test_score_prompt_matches_jax(weights, top_n):
    jcfg, jparams, cfg, params = weights
    tokens, lens = _padded_batch(2, [32, 17, 2], 32, cfg.vocab_size)
    want = [np.asarray(x) for x in jax_tf.score_prompt(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens), top_n=top_n)]
    got = [x.numpy() for x in transformer.score_prompt(
        params, cfg, torch.from_numpy(tokens), torch.from_numpy(lens), top_n=top_n)]
    for b, n in enumerate(lens):
        rows = slice(0, n - 1)               # position p-1 scores token p
        np.testing.assert_allclose(got[0][b, rows], want[0][b, rows], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(got[1][b, rows], want[1][b, rows])
        np.testing.assert_array_equal(got[2][b, rows], want[2][b, rows])
        np.testing.assert_allclose(got[3][b, rows], want[3][b, rows], atol=ATOL, rtol=0)
    assert got[2].shape == want[2].shape and got[1].dtype == np.int32


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

TEXTS = ["hello world", "hi", "a longer text than the others, padded past eight",
         [5, 6, 7], [300, 301, 302, 303, 304, 305, 306, 307, 308, 309]]


@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_engine_embed_equals_jax(engines, pooling):
    port, jeng = engines
    (got, gc), (want, wc) = port.embed(TEXTS, pooling), jeng.embed(TEXTS, pooling)
    assert gc == wc and got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_engine_score_prompts_entries_equal_jax(engines):
    port, jeng = engines
    prompts = [[5, 6, 7, 8, 9, 10], [300, 2, 41], [77]]
    got, want = port.score_prompts(prompts, top_n=4), jeng.score_prompts(prompts, top_n=4)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert g[0] == w[0] == {"token_id": g[0]["token_id"], "logprob": None, "rank": None,
                                "top": []}
        for eg, ew in zip(g[1:], w[1:]):
            assert (eg["token_id"], eg["rank"]) == (ew["token_id"], ew["rank"])
            assert abs(eg["logprob"] - ew["logprob"]) <= ATOL
            assert [t for t, _ in eg["top"]] == [t for t, _ in ew["top"]]
            np.testing.assert_allclose([v for _, v in eg["top"]], [v for _, v in ew["top"]],
                                       atol=ATOL, rtol=0)


def test_trunk_batches_and_budget_chunking_equal_jax(engines, monkeypatch):
    port, jeng = engines
    ids = [[1] * n for n in (3, 9, 17, 2, 40, 5)]
    assert ([(len(g), t.shape) for g, t, _ in port._trunk_batches(ids, 8)]
            == [(len(g), t.shape) for g, t, _ in jeng._trunk_batches(ids, 8)])
    short = ["alpha", "beta text", "gamma", "delta four"]
    full, _ = port.embed(short)
    per_row = port.model_cfg.num_heads * 16 * 16 * 4
    for eng in (type(port), type(jeng)):
        monkeypatch.setattr(eng, "EMBED_SCORE_BUDGET_BYTES", per_row)
    assert ([(len(g), t.shape) for g, t, _ in port._trunk_batches(ids[:4], 8)]
            == [(len(g), t.shape) for g, t, _ in jeng._trunk_batches(ids[:4], 8)])
    chunked, _ = port.embed(short)
    np.testing.assert_allclose(full, chunked, atol=2e-5, rtol=0)


def test_over_budget_and_invalid_inputs_raise_the_jax_errors(engines, monkeypatch):
    port, jeng = engines
    for eng in (type(port), type(jeng)):
        monkeypatch.setattr(eng, "EMBED_SCORE_BUDGET_BYTES", 1024)
    long = "this input is far too long for a 1KB score budget"
    for call in (lambda e: e.embed([long]), lambda e: e.score_prompts([list(range(40))])):
        with pytest.raises(ValueError, match="attention budget") as ours:
            call(port)
        with pytest.raises(ValueError) as theirs:
            call(jeng)
        assert str(ours.value) == str(theirs.value)
    monkeypatch.undo()
    for call in (lambda e: e.embed([]), lambda e: e.embed(["x"], pooling="max"),
                 lambda e: e.embed(["x"] * 129), lambda e: e.embed([[]]),
                 lambda e: e.score_prompts([[]])):
        with pytest.raises(ValueError) as ours:
            call(port)
        with pytest.raises(ValueError) as theirs:
            call(jeng)
        assert str(ours.value) == str(theirs.value)


def test_warmup_embed_buckets_and_concurrent_embeds(weights):
    eng = _port_engine(weights)
    eng.warmup(prefill_buckets=[], decode_buckets=[2], embed_buckets=[(2, 8), (1, 16)])
    results = {}

    def work(i):
        results[i] = eng.embed([f"text number {i}"])[0]
    ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for i in range(4):
        np.testing.assert_allclose(results[i], eng.embed([f"text number {i}"])[0],
                                   atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# the HTTP surfaces against the JAX server
# ---------------------------------------------------------------------------

def _request(url, payload=None, raw=False):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read().decode()
            return r.status, (body if raw else json.loads(body))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _sse(url, payload):
    status, raw = _request(url, dict(payload, stream=True), raw=True)
    if status != 200:
        return status, raw
    events = [ln[len("data: "):] for ln in raw.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return status, [json.loads(e) for e in events[:-1]]


def _same(a, b, path="$"):
    """JSON trees equal, floats within ATOL; response ids and timestamps
    are left out."""
    if isinstance(a, dict) and isinstance(b, dict):
        ka, kb = set(a) - {"id", "created"}, set(b) - {"id", "created"}
        assert ka == kb, (path, ka ^ kb)
        for k in ka:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), (path, a, b)
        assert abs(a - b) <= ATOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _jax_server(engine):
    return JaxServer(engine, JaxServerConfig(host="127.0.0.1", port=0, tpu_metrics=False,
                                             slo_burn=False))


@pytest.fixture(scope="module")
def servers(weights):
    port = OpenAIServer(_port_engine(weights), ServerConfig(host="127.0.0.1", port=0))
    jsrv = _jax_server(_jax_engine(weights))
    urls = {"port": f"http://127.0.0.1:{port.start()}",
            "jax": f"http://127.0.0.1:{jsrv.start()}"}
    yield urls, port
    port.shutdown()
    jsrv.shutdown()


def _both(urls, path, body, stream=False):
    fn = _sse if stream else _request
    return fn(urls["port"] + path, body), fn(urls["jax"] + path, body)


EMBED_BODIES = {
    "str": {"input": "hello", "model": "tiny-qwen3"},
    "list": {"input": ["a", "b", "c"]},
    "ids": {"input": [5, 6, 7]},
    "list_of_ids": {"input": [[5, 6, 7], [300, 301]]},
    "dimensions": {"input": "truncate me", "dimensions": 8},
}


@pytest.mark.parametrize("case", list(EMBED_BODIES))
def test_embeddings_route_equals_the_jax_server(servers, case):
    urls, _ = servers
    (ps, pb), (js, jb) = _both(urls, "/v1/embeddings", EMBED_BODIES[case])
    assert ps == js == 200
    _same(pb, jb)
    if case == "dimensions":
        v = np.array(pb["data"][0]["embedding"])
        assert v.shape == (8,) and abs(np.linalg.norm(v) - 1.0) < 1e-5


def test_embeddings_base64_equals_the_jax_server_and_float(servers):
    urls, _ = servers
    body = {"input": "same text", "encoding_format": "base64"}
    (ps, pb), (js, jb) = _both(urls, "/v1/embeddings", body)
    assert ps == js == 200
    dec = lambda b: np.frombuffer(base64.b64decode(b["data"][0]["embedding"]), "<f4")  # noqa: E731
    np.testing.assert_allclose(dec(pb), dec(jb), atol=ATOL, rtol=0)
    _, f = _request(urls["port"] + "/v1/embeddings", {"input": "same text"})
    np.testing.assert_allclose(dec(pb), np.float32(f["data"][0]["embedding"]), atol=1e-6)
    assert pb["usage"] == jb["usage"]


BAD_EMBED = [{"input": []}, {"input": 7}, {}, {"input": "x", "encoding_format": "hex"},
             {"input": "x", "dimensions": 0}, {"input": "x", "dimensions": 10**6},
             {"input": [["a", "b"]]}, {"input": [[-1, 5]]}, {"input": "x", "dimensions": True},
             {"input": [[]]}, {"input": ["x"] * 129}]


def test_embeddings_400s_equal_the_jax_servers(servers):
    urls, _ = servers
    for bad in BAD_EMBED:
        (ps, pb), (js, jb) = _both(urls, "/v1/embeddings", bad)
        assert ps == js == 400, (bad, pb, jb)
        assert pb == jb, bad


SCORING = {
    "score_only": {"prompt": "Hello world", "max_tokens": 0, "echo": True, "logprobs": 3},
    "score_only_ids": {"prompt": [5, 6, 7, 8], "max_tokens": 0, "echo": True, "logprobs": 0},
    "score_only_truncated": {"prompt": [5, 6, 7, 8, 9, 10], "max_tokens": 0, "echo": True,
                             "logprobs": 2, "truncate_prompt_tokens": 3},
    "prompt_logprobs": {"prompt": [5, 6, 7, 8], "max_tokens": 4, "temperature": 0,
                        "ignore_eos": True, "prompt_logprobs": 2},
    "echo_logprobs": {"prompt": "paged attention", "max_tokens": 4, "temperature": 0,
                      "ignore_eos": True, "echo": True, "logprobs": 2},
    "both": {"prompt": [11, 12, 13], "max_tokens": 3, "temperature": 0, "ignore_eos": True,
             "echo": True, "logprobs": 1, "prompt_logprobs": 3},
}


@pytest.mark.parametrize("case", list(SCORING))
def test_prompt_scoring_shapes_equal_the_jax_server(servers, case):
    urls, _ = servers
    (ps, pb), (js, jb) = _both(urls, "/v1/completions", SCORING[case])
    assert ps == js == 200, (pb, jb)
    _same(pb, jb)


def test_streamed_echo_with_logprobs_equals_the_jax_server(servers):
    urls, _ = servers
    body = {"prompt": [5, 6, 7, 8], "max_tokens": 4, "temperature": 0, "ignore_eos": True,
            "echo": True, "logprobs": 2, "return_token_ids": True}
    (ps, pc), (js, jc) = _both(urls, "/v1/completions", body, stream=True)
    assert ps == js == 200
    _same([c["choices"] for c in pc], [c["choices"] for c in jc])
    assert pc[0]["choices"][0]["logprobs"]["token_logprobs"][0] is None


BAD_SCORING = [
    {"prompt": "x", "max_tokens": 0, "echo": True},
    {"prompt": "x", "max_tokens": 0, "logprobs": 1},
    {"prompt": "x", "max_tokens": 0, "echo": True, "logprobs": 1, "n": 2},
    {"prompt": "x", "max_tokens": 0, "echo": True, "logprobs": 1, "prompt_logprobs": 1},
    {"prompt": "x", "max_tokens": 0, "echo": True, "logprobs": 1, "stream": True},
    {"prompt": "x", "max_tokens": 2, "prompt_logprobs": 1, "stream": True},
    {"prompt": "x", "max_tokens": 2, "prompt_logprobs": -1},
]


def test_scoring_400s_equal_the_jax_servers(servers):
    urls, _ = servers
    for bad in BAD_SCORING:
        (ps, pb), (js, jb) = _both(urls, "/v1/completions", bad)
        assert ps == js == 400, (bad, pb, jb)
        assert pb["error"]["message"] == jb["error"]["message"], bad


def test_trunks_run_on_the_runners_loop_thread(servers, monkeypatch):
    """Handler threads make no CUDA call: Engine.embed and score_prompts
    run on the loop thread, between steps."""
    urls, srv = servers
    seen = []
    eng = srv.engine
    for name in ("embed", "score_prompts"):
        orig = getattr(eng, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            seen.append((_name, threading.current_thread()))
            return _orig(*a, **kw)
        monkeypatch.setattr(eng, name, wrapped)
    assert _request(urls["port"] + "/v1/embeddings", {"input": "x"})[0] == 200
    assert _request(urls["port"] + "/v1/completions", SCORING["score_only"])[0] == 200
    assert _sse(urls["port"] + "/v1/completions", SCORING["echo_logprobs"])[0] == 200
    assert [n for n, _ in seen] == ["embed", "score_prompts", "score_prompts"]
    assert all(t is srv.runner._thread for _, t in seen)


def test_runner_call_returns_results_and_raises_errors(servers):
    _, srv = servers
    assert srv.runner.call(lambda: threading.current_thread()) is srv.runner._thread
    with pytest.raises(ValueError, match="boom"):
        srv.runner.call(lambda: (_ for _ in ()).throw(ValueError("boom")))


def test_spec_counters_on_metrics_equal_the_jax_servers(weights):
    spec = SpecConfig(num_draft_tokens=4)
    port = OpenAIServer(_port_engine(weights, speculative=spec, enable_prefix_caching=False),
                        ServerConfig(host="127.0.0.1", port=0))
    jsrv = _jax_server(_jax_engine(weights, enable_prefix_caching=False,
                                   speculative=jax_spec.SpecConfig(num_draft_tokens=4)))
    urls = {"port": f"http://127.0.0.1:{port.start()}",
            "jax": f"http://127.0.0.1:{jsrv.start()}"}
    try:
        body = {"prompt": [1, 2, 3, 4] * 5, "max_tokens": 12, "temperature": 0,
                "ignore_eos": True}
        (ps, pb), (js, jb) = _both(urls, "/v1/completions", body)
        assert ps == js == 200 and pb["choices"][0]["text"] == jb["choices"][0]["text"]
        assert port.engine.stats.spec_steps > 0

        def counters(url):
            # the runner exports between steps: poll until it has
            for _ in range(100):
                _, text = _request(url + "/metrics", raw=True)
                got = {ln.split()[0].split("{")[0]: float(ln.split()[-1])
                       for ln in text.splitlines()
                       if ln.startswith("tpuserve_spec_") and not ln.startswith("#")
                       and "_created" not in ln}
                if got.get("tpuserve_spec_draft_tokens_proposed_total"):
                    return got
                threading.Event().wait(0.05)
            return got
        ours, theirs = counters(urls["port"]), counters(urls["jax"])
        assert ours == theirs and len(ours) == 3
        assert ours["tpuserve_spec_draft_tokens_proposed_total"] == port.engine.stats.spec_proposed
    finally:
        port.shutdown()
        jsrv.shutdown()


# ---------------------------------------------------------------------------
# the CLI flags
# ---------------------------------------------------------------------------

CLI_ERRORS = [
    (["--speculative-draft-model", "tiny-qwen3"], "--speculative-draft-model needs"),
    (["--speculative-k", "2", "--speculative-draft-dir", "/x"],
     "--speculative-draft-dir needs"),
    (["--warmup-embed", "8by128"], "--warmup-embed must be"),
    (["--warmup-embed", "8x"], "--warmup-embed must be"),
]


@pytest.mark.parametrize("argv,msg", CLI_ERRORS, ids=["draft_no_k", "dir_no_draft",
                                                      "embed_junk", "embed_half"])
def test_cli_spec_and_embed_flag_errors_equal_the_jax_clis(argv, msg, capsys):
    from tpuserve.server.openai_api import main as jax_main
    errs = []
    for fn in (main, jax_main):
        with pytest.raises(SystemExit) as ei:
            fn(["--model", "tiny-qwen3"] + argv)
        assert ei.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[-1])
    assert errs[0] == errs[1] and msg in errs[0]


def test_cli_spec_flags_reach_the_engine_config():
    args = build_parser().parse_args(["--speculative-k", "3", "--speculative-draft-model",
                                      "tiny-qwen3", "--speculative-draft-dir", "/ckpt",
                                      "--warmup-embed", "8x128,1x512"])
    spec = engine_config(args).speculative
    assert spec == SpecConfig(num_draft_tokens=3, draft_model="tiny-qwen3",
                              draft_checkpoint_dir="/ckpt")
    assert engine_config(build_parser().parse_args([])).speculative is None
    assert args.warmup_embed == "8x128,1x512"


def test_cli_takes_the_spec_flags_as_far_as_the_engine():
    """With the flags taken the CLI gets as far as the engine, which,
    without a card, exits naming device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(SystemExit) as ei:
        main(["--model", "tiny-qwen3", "--no-kv-tiers", "--speculative-k", "4",
              "--warmup-embed", "2x8"])
    assert "device='cpu'" in str(ei.value.code)
