"""Cross-pod disaggregated prefill/decode on the CPU
(``tpuserve_torch/parallel/disagg_net.py`` and the port server's
``/internal/migrate`` and ``/internal/abort``): the counterparts of the JAX
package's ``tests/test_disagg_net.py``, the wire format byte for byte
against the JAX codec, and both mixed pairs (a JAX prefill pod handing off
to a port decode pod, and the reverse), every stream equal to a colocated
engine's on the same float32 weights."""

import dataclasses
import json
import time
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

import tpuserve.runtime.engine as jax_engine_mod
from tpuserve.models.config import get_model_config as jax_model_config
from tpuserve.parallel import disagg_net as jax_net
from tpuserve.runtime import (CacheConfig as JCacheConfig, Engine as JEngine,
                              EngineConfig as JEngineConfig, SamplingParams as JSamplingParams,
                              SchedulerConfig as JSchedulerConfig)
from tpuserve.server.openai_api import OpenAIServer as JServer
from tpuserve.server.openai_api import ServerConfig as JServerConfig
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.parallel import disagg_net
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig, FinishReason,
                                    SamplingParams, SchedulerConfig)
from tpuserve_torch.server import OpenAIServer, ServerConfig


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CACHE = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16, dtype="float32")
SCHED = dict(max_num_seqs=4, min_prefill_bucket=8, min_decode_bucket=4)
MC = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")


def _ecfg(cache=CACHE, **kw):
    return EngineConfig(model="tiny-qwen3", cache=CacheConfig(**cache),
                        scheduler=SchedulerConfig(**SCHED), attn_impl="reference", **kw)


def _engine(cache=CACHE, **kw):
    return Engine(_ecfg(cache, **kw), model_cfg=MC, device="cpu")


def _handoff(url):
    return disagg_net.PrefillHandoffEngine(_ecfg(), url, model_cfg=MC, device="cpu")


def _colocated(prompts, params):
    return [r.output_token_ids for r in _engine().generate(prompts, params)]


@pytest.fixture()
def decode_server():
    eng = _engine()
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0, allow_kv_migration=True))
    port = srv.start(warmup=False)
    yield f"http://127.0.0.1:{port}", eng
    srv.shutdown()


@pytest.fixture()
def jax_fp32(monkeypatch):
    """The JAX engines of this test on float32 tiny-qwen3 (its pods build
    their engines by name)."""
    def fp32(name):
        return dataclasses.replace(jax_model_config(name), dtype="float32")
    monkeypatch.setattr(jax_engine_mod, "get_model_config", fp32)


def _jcfg():
    return JEngineConfig(model="tiny-qwen3", cache=JCacheConfig(**CACHE),
                         scheduler=JSchedulerConfig(**SCHED), attn_impl="reference",
                         multi_step=1, kv_tiers=False)


# ---------------------------------------------------------------------------
# Wire codec
# ---------------------------------------------------------------------------

def _seq_kv(seed: int, layers: int):
    rng = np.random.default_rng(seed)
    np_kv = [{"k": rng.standard_normal((2, 4, 2, 8)).astype(ml_dtypes.bfloat16),
              "v": rng.standard_normal((2, 4, 2, 8)).astype(np.float32)}
             for _ in range(layers)]
    torch_kv = [{"k": torch.from_numpy(layer["k"].view(np.int16).copy()).view(torch.bfloat16),
                 "v": torch.from_numpy(layer["v"].copy())} for layer in np_kv]
    return np_kv, torch_kv


def test_migration_codec_roundtrip():
    np_kv, seq_kv = _seq_kv(0, 3)
    meta = {"request_id": "r1", "prompt_token_ids": [1, 2, 3], "first_token": 7,
            "params": disagg_net.sampling_to_dict(
                SamplingParams(max_tokens=5, temperature=0.5, seed=3))}
    blob = disagg_net.serialize_migration(meta, seq_kv)
    meta2, kv2 = disagg_net.deserialize_migration(blob)
    assert meta2["request_id"] == "r1"
    assert disagg_net.sampling_from_dict(meta2["params"]).seed == 3
    for a, b in zip(seq_kv, kv2):
        assert a["k"].dtype == b["k"].dtype == torch.bfloat16
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    # the JAX codec's bytes, both ways
    jmeta = dict(meta, params=jax_net.sampling_to_dict(
        JSamplingParams(max_tokens=5, temperature=0.5, seed=3)))
    assert blob == jax_net.serialize_migration(jmeta, np_kv)
    jmeta2, jkv = jax_net.deserialize_migration(blob)
    assert jmeta2 == meta2
    np.testing.assert_array_equal(np.asarray(jkv[0]["k"], np.float32),
                                  seq_kv[0]["k"].float().numpy())


def test_migration_codec_rejects_garbage():
    with pytest.raises(ValueError, match="migration"):
        disagg_net.deserialize_migration(b"nope" + b"\x00" * 64)


def test_migration_payload_chunked_equals_monolithic():
    _, seq_kv = _seq_kv(1, 2)
    meta = {"request_id": "c1", "prompt_token_ids": [1], "first_token": 2,
            "num_valid_blocks": 1, "params": disagg_net.sampling_to_dict(SamplingParams())}
    total, make_chunks = disagg_net.migration_payload(meta, seq_kv, chunk_bytes=64)
    chunks = list(make_chunks())
    assert len(chunks) > 4
    blob = b"".join(bytes(c) for c in chunks)
    assert len(blob) == total
    assert blob == disagg_net.serialize_migration(meta, seq_kv)
    assert blob == b"".join(bytes(c) for c in make_chunks())       # again, for a retry
    meta2, kv2 = disagg_net.deserialize_migration(blob)
    assert meta2["request_id"] == "c1" and torch.equal(kv2[0]["k"], seq_kv[0]["k"])


# ---------------------------------------------------------------------------
# The cross-pod path over HTTP
# ---------------------------------------------------------------------------

def test_cross_pod_stream_matches_colocated(decode_server):
    url, decode_eng = decode_server
    handoff = _handoff(url)
    params = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
    prompts = [[5, 6, 7], [11, 12, 13, 14, 15]]
    reqs = handoff.generate(prompts, params)
    assert [r.output_token_ids for r in reqs] == _colocated(prompts, params)
    assert handoff.prefill.block_manager.num_seqs() == 0
    assert decode_eng.block_manager.num_seqs() == 0


def _hold_stream(url: str, body: dict, started, stop, out: dict) -> None:
    """One stream through ``url``'s /v1/completions, held open until
    ``stop`` (closing it aborts the request): ``started`` at its first
    token; ``out["done"]`` whether it ended by itself first."""
    import http.client
    host, port = url.rsplit("/", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    out["done"] = False
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(dict(body, stream=True)),
                     headers={"Content-Type": "application/json"})
        for line in conn.getresponse():
            if line.startswith(b"data: [DONE]"):
                out["done"] = True
                break
            if line.startswith(b"data: {"):
                started.set()
                if stop.is_set():
                    break
    finally:
        conn.close()


def test_cross_pod_decode_pool_full_falls_back_to_local_decode():
    """A decode pool without the free blocks answers 503; after the bounded
    retries the prefill pod decodes the request itself.  The pool has 12
    blocks (44 tokens a sequence) and a 32-token stream holds 8 of them,
    its decode steps delayed by a fault so that it holds them: a 13-token
    prompt, which fits a sequence, needs 5 and is refused on both
    attempts."""
    import threading
    tiny = dict(CACHE, num_blocks=12, max_blocks_per_seq=12)
    srv = OpenAIServer(_engine(tiny, faults="decode_dispatch:delay:1.0:delay_s=0.5"),
                       ServerConfig(host="127.0.0.1", port=0, allow_kv_migration=True))
    port = srv.start(warmup=False)
    url = f"http://127.0.0.1:{port}"
    assert srv.engine.max_seq_len == 44
    prompt = list(range(1, 14))
    params = SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
    started, stop, fill = threading.Event(), threading.Event(), {}
    filler = threading.Thread(target=_hold_stream, args=(
        url, {"prompt": list(range(40, 72)), "max_tokens": 10, "temperature": 0,
              "ignore_eos": True}, started, stop, fill))
    try:
        handoff = _handoff(url)
        handoff.MIGRATE_RETRIES, handoff.MIGRATE_RETRY_DELAY_S = 2, 0.05
        filler.start()
        assert started.wait(30)
        # an id of its own: the filler is the pool's "req-0", as this
        # engine's first request would be
        rid = handoff.add_request(request_id="pool-full", prompt_token_ids=prompt,
                                  params=params)
        while handoff.has_work():
            if not handoff.step():
                time.sleep(0.005)
        req = handoff.requests.pop(rid)
        assert not fill["done"]          # the stream held its blocks throughout
        assert handoff.refused == 2      # a 503, one retry, a 503: local decode
        assert req.finish_reason == FinishReason.LENGTH
        assert req.output_token_ids == _colocated([prompt], params)[0]
        assert handoff.prefill.block_manager.num_seqs() == 0
    finally:
        stop.set()
        filler.join(30)
        srv.shutdown()


def test_cross_pod_unreachable_decode_pool_serves_locally():
    handoff = _handoff("http://127.0.0.1:9")        # the discard port: refused
    handoff.MIGRATE_RETRIES = 2
    handoff.MIGRATE_RETRY_DELAY_S = 0.05
    params = SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)
    prompts = [[5, 6, 7], [11, 12, 13, 14, 15]]
    reqs = handoff.generate(prompts, params)
    assert [r.output_token_ids for r in reqs] == _colocated(prompts, params)
    assert all(r.finish_reason == FinishReason.LENGTH for r in reqs)
    assert handoff.prefill.block_manager.num_seqs() == 0


def test_ambiguous_migration_aborts_remote_and_serves_locally(decode_server, monkeypatch):
    """The adoption lands but its 200 is lost: the prefill pod decodes
    locally and tells the decode pool to drop its copy."""
    import urllib.request as ur
    url, decode_eng = decode_server
    real = ur.urlopen

    def flaky(req, timeout=None):
        resp = real(req, timeout=timeout)
        if req.full_url.endswith("/internal/migrate"):
            resp.close()
            raise TimeoutError("simulated lost migration response")
        return resp

    monkeypatch.setattr(ur, "urlopen", flaky)
    handoff = _handoff(url)
    handoff.MIGRATE_RETRIES = 1
    params = SamplingParams(max_tokens=5, temperature=0.0, ignore_eos=True)
    [req] = handoff.generate([[5, 6, 7]], params)
    assert req.output_token_ids == _colocated([[5, 6, 7]], params)[0]
    deadline = time.time() + 10
    while decode_eng.block_manager.num_seqs() and time.time() < deadline:
        time.sleep(0.05)
    assert decode_eng.block_manager.num_seqs() == 0
    assert handoff.prefill.block_manager.num_seqs() == 0


def test_internal_abort_endpoint(decode_server):
    """/internal/abort: an unknown id is not aborted; a pod that is not a
    decode pool refuses both internal routes with 403."""
    url, _ = decode_server
    req = urllib.request.Request(f"{url}/internal/abort",
                                 data=json.dumps({"request_id": "nope"}).encode(),
                                 headers={"Content-Type": "application/json"})
    body = json.loads(urllib.request.urlopen(req, timeout=30).read())
    assert body == {"request_id": "nope", "aborted": False}
    srv = OpenAIServer(_engine(), ServerConfig(host="127.0.0.1", port=0))
    port = srv.start(warmup=False)
    try:
        for route in ("/internal/abort", "/internal/migrate"):
            r = urllib.request.Request(f"http://127.0.0.1:{port}{route}", data=b"{}",
                                       headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(r, timeout=30)
            assert ei.value.code == 403
    finally:
        srv.shutdown()


def test_cross_pod_server_to_server(decode_server):
    """Completions POSTed to a prefill-role server stream the tokens the
    decode pod made."""
    url, _ = decode_server
    srv = OpenAIServer(_handoff(url), ServerConfig(host="127.0.0.1", port=0))
    port = srv.start(warmup=False)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions",
            data=json.dumps({"model": "tiny-qwen3", "prompt": [5, 6, 7], "max_tokens": 6,
                             "temperature": 0, "ignore_eos": True,
                             "return_token_ids": True}).encode(),
            headers={"Content-Type": "application/json"})
        body = json.loads(urllib.request.urlopen(req, timeout=120).read())
        assert body["usage"]["completion_tokens"] == 6
        assert body["choices"][0]["finish_reason"] == "length"
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# A decode pod of 2 lockstep ranks: python -m tpuserve_torch.server --tp 2
# --role decode (tiny-mistral, registered in float32: both pods draw the same
# seed-0 weights by name)
# ---------------------------------------------------------------------------

TP_MODEL = "tiny-mistral"
TP_MC = get_model_config(TP_MODEL)


def _start_tp2_decode_pod(tmp_path):
    """The CLI at ``--tp 2 --role decode`` (it spawns its follower rank);
    (process, url)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    log = tmp_path / "rank0.log"
    env = dict(os.environ, PYTHONPATH=str(root), TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpuserve_torch.server", "--tp", "2", "--role", "decode",
             "--device", "cpu", "--model", TP_MODEL, "--port", "0", "--host", "127.0.0.1",
             "--block-size", "4", "--num-blocks", "64", "--max-blocks-per-seq", "16",
             "--max-num-seqs", "4", "--kv-cache-dtype", "float32", "--no-warmup",
             # the long request's decode dispatches slowed, so that its abort
             # lands mid-stream
             "--faults", "decode_dispatch:delay:1.0:delay_s=0.2:match=long"],
            stdout=f, stderr=subprocess.STDOUT, env=env, stdin=subprocess.DEVNULL)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and proc.poll() is None:
        text = log.read_text()
        if "listening on" in text:
            port = int(text.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
            return proc, f"http://127.0.0.1:{port}"
        time.sleep(0.2)
    proc.kill()
    proc.wait()
    raise AssertionError(log.read_text()[-3000:])


def _post_json(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


def test_cross_pod_to_a_tp2_decode_pod(tmp_path):
    """A one-device prefill pod hands off over ``/internal/migrate`` to a
    decode pod of 2 ranks: the streams equal colocated; an adopted request
    aborted mid-stream on ``/internal/abort`` answers as on one card
    (aborted, then unknown), and its stream ends; SIGTERM drains and every
    rank exits 0."""
    import signal
    proc, url = _start_tp2_decode_pod(tmp_path)
    try:
        handoff = disagg_net.PrefillHandoffEngine(
            EngineConfig(model=TP_MODEL, cache=CacheConfig(**CACHE),
                         scheduler=SchedulerConfig(**SCHED)), url, model_cfg=TP_MC,
            device="cpu")
        prompts = [[5, 6, 7], [11, 12, 13, 14, 15], list(range(2, 30))]
        params = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
        reqs = handoff.generate(prompts, params)
        colocated = Engine(EngineConfig(model=TP_MODEL, cache=CacheConfig(**CACHE),
                                        scheduler=SchedulerConfig(**SCHED)),
                           model_cfg=TP_MC, device="cpu").generate(prompts, params)
        assert [r.output_token_ids for r in reqs] == [r.output_token_ids for r in colocated]
        assert handoff.refused == 0 and handoff.prefill.block_manager.num_seqs() == 0
        # a long request adopted, then aborted while it streams
        eng = handoff.prefill
        rid = eng.add_request(prompt_token_ids=[9, 8, 7], request_id="long",
                              params=SamplingParams(max_tokens=56, temperature=0.0,
                                                    ignore_eos=True))
        eng.step()
        req = eng.requests[rid]
        meta = {"request_id": rid, "prompt_token_ids": [9, 8, 7],
                "first_token": req.output_token_ids[-1], "num_valid_blocks": 1,
                "params": disagg_net.sampling_to_dict(req.params)}
        blob = disagg_net.serialize_migration(
            meta, eng._exec_extract(eng.block_manager.block_table(rid)))
        stream = urllib.request.urlopen(urllib.request.Request(
            f"{url}/internal/migrate", data=blob,
            headers={"Content-Type": "application/x-tpuserve-kv"}), timeout=60)
        first = json.loads(stream.readline())
        assert first["new_token_ids"] and not first["finished"]
        assert _post_json(f"{url}/internal/abort", {"request_id": rid}) == {
            "request_id": rid, "aborted": True}
        rest = [json.loads(line) for line in stream if line.strip()]
        stream.close()
        got = len(first["new_token_ids"]) + sum(len(m["new_token_ids"]) for m in rest)
        assert got < 55
        assert _post_json(f"{url}/internal/abort", {"request_id": rid}) == {
            "request_id": rid, "aborted": False}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=90) == 0, (tmp_path / "rank0.log").read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# Mixed pairs: the two packages' pods hand off to each other
# ---------------------------------------------------------------------------

def test_jax_prefill_pod_to_port_decode_pod(decode_server, jax_fp32):
    url, decode_eng = decode_server
    handoff = jax_net.PrefillHandoffEngine(_jcfg(), url)
    prompts = [[5, 6, 7], [11, 12, 13, 14, 15], list(range(2, 30))]
    reqs = handoff.generate(prompts, JSamplingParams(max_tokens=8, temperature=0.0,
                                                     ignore_eos=True))
    assert [r.output_token_ids for r in reqs] == _colocated(
        prompts, SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True))
    assert decode_eng.block_manager.num_seqs() == 0
    assert handoff.prefill.block_manager.num_seqs() == 0


def test_port_prefill_pod_to_jax_decode_pod(jax_fp32):
    jeng = JEngine(_jcfg())
    srv = JServer(jeng, JServerConfig(host="127.0.0.1", port=0, allow_kv_migration=True))
    port = srv.start(warmup=False)
    try:
        handoff = _handoff(f"http://127.0.0.1:{port}")
        prompts = [[5, 6, 7], [11, 12, 13, 14, 15], list(range(2, 30))]
        params = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
        reqs = handoff.generate(prompts, params)
        assert [r.output_token_ids for r in reqs] == _colocated(prompts, params)
        assert handoff.prefill.block_manager.num_seqs() == 0
        assert jeng.block_manager.num_seqs() == 0
    finally:
        srv.shutdown()
