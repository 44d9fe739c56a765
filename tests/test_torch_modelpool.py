"""The port's model pool (``modelpool/``) and ``Engine.swap_model`` on the
CPU, against the JAX package.

The JAX ``tests/test_modelpool.py`` cases on the port: catalog parsing and
config validation (the JAX outputs and refusals), the weight tiers (host
then spill cascade, no spill directory drops, spill-to-host prefetch, a
spill directory adopted after a restart, demotion one leaf at a time), the
pool driving a real engine (a round trip token for token, a swap refused
with work in flight, the routing and status surfaces), and the server
(swap on demand with ``/healthz``, ``/v1/models`` and ``/debug/engine``,
the reject policy's 503, ``TPUSERVE_MODELPOOL=0``, an engine without a
config refused).

Beyond them: a server with the catalog {tiny-qwen3, tiny-llama} (float32
variants, registered in both packages under ``-fp32`` names, random
weights from the seed, so both packages draw the same numbers) serves
requests that alternate by ``model`` through swaps from cold, the host
tier, the spill tier and (with two resident) the card; each model's greedy
tokens are the same after every swap and equal to the JAX engine's on the
same weights.  A bf16 tree survives the spill files bit for bit.
"""

import dataclasses
import gc
import json
import urllib.error
import urllib.request
import weakref

import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import config as jax_config
from tpuserve.modelpool import ModelPoolConfig as JaxPoolConfig
from tpuserve.modelpool import parse_catalog as jax_parse_catalog
from tpuserve_torch.models import config as port_config
from tpuserve_torch.modelpool import ModelPool, ModelPoolConfig, WeightTiers, parse_catalog
from tpuserve_torch.modelpool import tiers as tiers_mod
from tpuserve_torch.modelpool.tiers import (load_params_from_dir, stream_params_to_dir,
                                            tree_host_nbytes)
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig, SamplingParams,
                                    SchedulerConfig)
from tpuserve_torch.server import OpenAIServer, ServerConfig

QWEN, LLAMA = "tiny-qwen3-fp32", "tiny-llama-fp32"
CACHE = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16)
SCHED = dict(max_num_seqs=4, min_prefill_bucket=8, min_decode_bucket=2)
PROMPTS = [[5, 6, 7, 8], [3, 4, 5], [100, 101, 102, 103, 104, 105, 106, 107, 108, 109]]


@pytest.fixture(autouse=True, scope="module")
def _models():
    """float32 twins of the tiny models in both packages' registries."""
    for mod in (port_config, jax_config):
        for base, name in (("tiny-qwen3", QWEN), ("tiny-llama", LLAMA)):
            mod.register_model_config(dataclasses.replace(mod.get_model_config(base),
                                                          name=name, dtype="float32"))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mk_engine(model=QWEN, **kw):
    return Engine(EngineConfig(model=model, cache=CacheConfig(**CACHE),
                               scheduler=SchedulerConfig(**SCHED), **kw), device="cpu")


def _generate(eng, prompt_ids, n=8):
    rid = eng.add_request(prompt_token_ids=list(prompt_ids),
                          params=SamplingParams(max_tokens=n, temperature=0.0, seed=0,
                                                ignore_eos=True))
    toks = None
    while eng.has_work():
        for out in eng.step():
            if out.finished and out.request_id == rid:
                toks = list(eng.requests.pop(rid).output_token_ids)
    assert toks is not None
    return toks


_JAX_TOKENS: dict = {}


def _jax_tokens(model: str) -> list:
    """The JAX engine's greedy tokens of PROMPTS on ``model``'s seeded
    weights."""
    if model not in _JAX_TOKENS:
        eng = jax_rt.Engine(jax_rt.EngineConfig(
            model=model, cache=jax_rt.CacheConfig(**CACHE),
            scheduler=jax_rt.SchedulerConfig(**SCHED), attn_impl="reference", multi_step=1))
        _JAX_TOKENS[model] = [o.output_token_ids for o in eng.generate(
            PROMPTS, jax_rt.SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True))]
    return _JAX_TOKENS[model]


# ---- the catalog ----------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "", "a,b, c", '{"a": "/ckpt/a", "b": null}',
                                  {"a": "/x", "b": None}, "{not json", '["a-list"]'])
def test_parse_catalog_forms_are_the_jax_ones(spec):
    try:
        want = jax_parse_catalog(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            parse_catalog(spec)
        assert str(ours.value) == str(e)
        return
    assert parse_catalog(spec) == want


def test_pool_config_validation_is_the_jax_ones():
    for kw in (dict(swap_policy="maybe"), dict(max_resident=0)):
        with pytest.raises(ValueError) as ours:
            ModelPoolConfig(**kw).validate()
        with pytest.raises(ValueError) as ref:
            JaxPoolConfig(**kw).validate()
        assert str(ours.value) == str(ref.value)


# ---- the weight tiers -----------------------------------------------------

def _tree(seed, kb=4):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(kb * 256 // 8, generator=g),
            "layers": [{"b": torch.randn(8, generator=g)}]}


def _equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for (_, x), (_, y) in zip(
        tiers_mod.iter_param_leaves(a), tiers_mod.iter_param_leaves(b)))


def test_tiers_host_then_spill_cascade(tmp_path):
    a, b = _tree(1), _tree(2)
    tiers = WeightTiers(tree_host_nbytes(a) + tree_host_nbytes(b) // 2, spill_dir=str(tmp_path))
    assert tiers.put("a", a) == "host"
    assert tiers.put("b", b) == "host"        # evicts a (LRU) to spill
    tiers.flush()
    assert (tiers.where("a"), tiers.where("b")) == ("spill", "host")
    assert tiers.spilled_models == 1
    assert tiers.bytes_by_tier() == {"host": tree_host_nbytes(b), "spill": tree_host_nbytes(a)}
    got, tier = tiers.take("a")
    assert tier == "spill" and _equal(got, a)
    assert isinstance(got["layers"], list)
    assert tiers.where("a") is None


def test_tiers_without_a_spill_dir_drop():
    tiers = WeightTiers(16)
    assert tiers.put("big", _tree(3)) == "dropped"
    assert tiers.dropped_models == 1 and tiers.take("big") is None


def test_tiers_prefetch_promotes_spill_to_host(tmp_path):
    a = _tree(4)
    tiers = WeightTiers(tree_host_nbytes(a) * 4, spill_dir=str(tmp_path))
    tiers.put("a", a)
    tiers._spill_one("a", tiers._host.pop("a")[0])
    tiers.host_bytes_used = 0
    tiers.flush()
    assert tiers.where("a") == "spill"
    assert tiers.prefetch("a") is True
    tiers.flush()
    assert tiers.where("a") == "host" and tiers.prefetched_models == 1
    got, tier = tiers.take("a")
    assert tier == "host" and _equal(got, a)


def test_tiers_spill_survives_a_restart(tmp_path):
    a = _tree(5)
    t1 = WeightTiers(1 << 20, spill_dir=str(tmp_path))
    t1._spill_one("m/odel-a", a)
    t1.flush()
    t2 = WeightTiers(1 << 20, spill_dir=str(tmp_path))
    assert t2.where("m/odel-a") == "spill"
    got, tier = t2.take("m/odel-a")
    assert tier == "spill" and _equal(got, a)


def test_streaming_demotion_holds_one_leaf_at_a_time(tmp_path):
    """``stream_params_to_dir`` holds at most one leaf's host copy at once:
    demoting an N-leaf model costs one leaf of host memory, not a tree."""
    live, peak = [0], [0]

    class _DeviceLeaf:
        """A card tensor's stand-in: each host copy it hands out is counted
        while alive."""

        def __init__(self, t):
            self.t = t

        def detach(self):
            return self

        def cpu(self):
            out = self.t.clone()
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            weakref.finalize(out, lambda: live.__setitem__(0, live[0] - 1))
            return out

    src = {f"l{i}": _DeviceLeaf(torch.full((64,), float(i))) for i in range(8)}
    total = stream_params_to_dir(src, str(tmp_path / "s"))
    gc.collect()
    assert total == 8 * 64 * 4 and peak[0] <= 1
    back = load_params_from_dir(str(tmp_path / "s"))
    assert all(torch.equal(back[f"l{i}"], src[f"l{i}"].t) for i in range(8))


def test_a_bf16_tree_spills_and_restores_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(9)
    tree = {"embed": torch.randn(64, 32, generator=g).to(torch.bfloat16),
            "layers": [{"w": torch.randn(32, 32, generator=g).to(torch.bfloat16),
                        "q": torch.randint(-127, 127, (32, 8), dtype=torch.int8, generator=g),
                        "s": torch.rand(8, generator=g)}],
            "odd": torch.tensor([float("nan"), float("-inf"), -0.0, 1e-40]).to(torch.bfloat16)}
    tiers = WeightTiers(1, spill_dir=str(tmp_path))          # straight to spill
    assert tiers.put("m", tree) == "spill"
    tiers.flush()
    got, tier = tiers.take("m")
    assert tier == "spill"
    for (pa, a), (pb, b) in zip(tiers_mod.iter_param_leaves(tree),
                                tiers_mod.iter_param_leaves(got)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
        bits = torch.int16 if a.dtype == torch.bfloat16 else a.dtype
        assert torch.equal(a.view(bits), b.view(bits)), pa


# ---- the pool on a real engine --------------------------------------------

@pytest.fixture(scope="module")
def swap_rig():
    eng = _mk_engine(QWEN)
    pool = ModelPool(eng.config, ModelPoolConfig(catalog={QWEN: None, LLAMA: None}))
    yield eng, pool


def _swap(pool, eng, target):
    assert pool.request_swap(target)
    outcome = pool.maybe_swap(eng)
    assert pool.current == target
    return outcome


def test_swap_round_trip_token_identity(swap_rig):
    eng, pool = swap_rig
    base = [_generate(eng, p) for p in PROMPTS]
    assert _swap(pool, eng, LLAMA) == "cold"
    assert eng.config.model == LLAMA
    llama = [_generate(eng, p) for p in PROMPTS]
    assert _swap(pool, eng, QWEN) in ("host", "resident")
    again = [_generate(eng, p) for p in PROMPTS]
    assert again == base == _jax_tokens(QWEN)
    assert llama == _jax_tokens(LLAMA) != base
    assert eng.stats.model_swaps == 2 and eng.stats.model_swaps_by_outcome["cold"] == 1
    # the profiler, the recorder and the stats carried across; the ladder
    # counts both models' executables
    assert eng.devprof.cycles > 0 and eng.devprof.hbm_snapshot()["weights_bytes"] > 0
    assert any(e["event"] == "SWAP" for e in eng.flight.request_timeline(
        f"swap:{LLAMA}->{QWEN}"))


def test_swap_refused_with_work_in_flight(swap_rig):
    eng, pool = swap_rig
    eng.add_request(prompt_token_ids=[1, 2, 3],
                    params=SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True))
    pool.request_swap(LLAMA)
    assert pool.maybe_swap(eng) is None and pool.current == QWEN
    with pytest.raises(RuntimeError):
        eng.swap_model(pool.build_config(LLAMA))
    while eng.has_work():
        for o in eng.step():
            if o.finished:
                eng.requests.pop(o.request_id, None)
    assert pool.maybe_swap(eng) is not None
    _swap(pool, eng, QWEN)


def test_pool_surfaces(swap_rig):
    eng, pool = swap_rig
    assert [pool.route(n) for n in (None, QWEN, LLAMA, "nope")] == \
        ["current", "current", "swap", "unknown"]
    if pool.swaps == 0:
        _swap(pool, eng, LLAMA)
        _swap(pool, eng, QWEN)
    cat = {c["name"]: c["tier"] for c in pool.catalog_status()}
    assert cat[QWEN] == "serving" and cat[LLAMA] in ("host", "resident")
    st = pool.status()
    assert st["current"] == QWEN and st["swaps"] >= 2
    assert set(st["weight_tier_bytes"]) == {"host", "spill"}


# ---- the server -----------------------------------------------------------

def _post(url, payload, timeout=180):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def pool_server(tmp_path_factory):
    # the host tier holds tiny-qwen3 (427,520 bytes) but not tiny-llama
    # (460,032), which goes to the spill files
    spill = str(tmp_path_factory.mktemp("weight-spill"))
    srv = OpenAIServer(_mk_engine(QWEN), ServerConfig(
        host="127.0.0.1", port=0, model_catalog=f"{QWEN},{LLAMA}",
        weight_host_bytes=440_000, weight_spill_dir=spill))
    url = f"http://127.0.0.1:{srv.start()}"
    yield srv, url
    srv.shutdown()


def _stream_ids(url, model, prompt):
    req = urllib.request.Request(url + "/v1/completions", method="POST",
                                 data=json.dumps({"model": model, "prompt": prompt,
                                                  "max_tokens": 8, "temperature": 0,
                                                  "ignore_eos": True, "stream": True,
                                                  "return_token_ids": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    ids, names = [], set()
    with urllib.request.urlopen(req, timeout=180) as r:
        for line in r.read().decode().splitlines():
            if line.startswith("data: ") and line != "data: [DONE]":
                chunk = json.loads(line[6:])
                names.add(chunk["model"])
                for c in chunk["choices"]:
                    ids += c.get("token_ids", [])
    return ids, names


def _round(url, model):
    got = [_stream_ids(url, model, p) for p in PROMPTS]
    assert all(names == {model} for _, names in got)
    return [ids for ids, _ in got]


def test_requests_alternating_by_model_swap_through_every_tier(pool_server):
    srv, url = pool_server
    pool = srv.pool
    before = _round(url, QWEN)
    assert before == _jax_tokens(QWEN)
    for model in (LLAMA, QWEN, LLAMA, QWEN):
        if model == LLAMA:
            pool.tiers.flush()          # the spill files are written: a real spill read
        assert _round(url, model) == _jax_tokens(model), model
    by = srv.engine.stats.model_swaps_by_outcome
    assert by == {"cold": 1, "host": 2, "spill": 1}, by
    text = urllib.request.urlopen(url + "/metrics", timeout=30).read().decode()
    for tier in ("cold", "host", "spill"):
        assert f'tpuserve_model_swaps_total{{model_name="{QWEN}",outcome="{tier}"}}' in text
    assert 'tpuserve_models_resident{model_name="tiny-qwen3-fp32"} 1.0' in text


def test_two_resident_models_swap_from_the_card():
    srv = OpenAIServer(_mk_engine(QWEN), ServerConfig(
        host="127.0.0.1", port=0, model_catalog=f"{QWEN},{LLAMA}", max_resident_models=2))
    url = f"http://127.0.0.1:{srv.start()}"
    try:
        for model in (QWEN, LLAMA, QWEN, LLAMA):
            assert _round(url, model) == _jax_tokens(model)
        assert srv.engine.stats.model_swaps_by_outcome == {"cold": 1, "resident": 2}
        assert {c["name"]: c["tier"] for c in srv.pool.catalog_status()} == \
            {QWEN: "resident", LLAMA: "serving"}
        # the co-resident weights count in the watermark
        hbm = srv.engine.devprof.hbm_snapshot()
        assert hbm["weights_bytes"] == 427_520 + 460_032
    finally:
        srv.shutdown()


def test_server_swap_on_demand_surfaces(pool_server):
    srv, url = pool_server
    st, body = _get(url + "/healthz")
    assert {m["name"] for m in body["models"]} == {QWEN, LLAMA}
    st, body = _post(url + "/v1/completions", {"model": LLAMA, "prompt": [3, 4, 5],
                                               "max_tokens": 4, "temperature": 0,
                                               "ignore_eos": True})
    assert st == 200 and body["model"] == LLAMA and body["usage"]["completion_tokens"] == 4
    st, body = _get(url + "/healthz")
    assert body["model_current"] == LLAMA
    st, body = _get(url + "/v1/models")
    assert {m["id"] for m in body["data"]} == {QWEN, LLAMA}
    st, body = _post(url + "/v1/completions", {"model": "no-such-model", "prompt": [1],
                                               "max_tokens": 2, "temperature": 0,
                                               "ignore_eos": True})
    assert st == 200 and body["model"] == LLAMA
    st, body = _get(url + "/debug/engine")
    assert body["modelpool"]["current"] == LLAMA and body["modelpool"]["swaps"] >= 1
    st, body = _post(url + "/v1/completions", {"model": QWEN, "prompt": [3, 4, 5],
                                               "max_tokens": 2, "temperature": 0,
                                               "ignore_eos": True})
    assert st == 200 and body["model"] == QWEN


def test_reject_policy_503_with_retry_after():
    srv = OpenAIServer(_mk_engine(QWEN), ServerConfig(
        host="127.0.0.1", port=0, model_catalog=f"{QWEN},{LLAMA}", swap_policy="reject",
        swap_retry_after_s=7))
    url = f"http://127.0.0.1:{srv.start()}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/v1/completions", {"model": LLAMA, "prompt": [1, 2], "max_tokens": 2})
        assert ei.value.code == 503 and ei.value.headers.get("Retry-After") == "7"
        assert srv.pool.rejects == 1 and srv.pool.demand.get(LLAMA, 0) >= 1
    finally:
        srv.shutdown()


def test_kill_switch_makes_no_pool(monkeypatch):
    monkeypatch.setenv("TPUSERVE_MODELPOOL", "0")
    srv = OpenAIServer(_mk_engine(QWEN), ServerConfig(host="127.0.0.1", port=0,
                                                      model_catalog=f"{QWEN},{LLAMA}"))
    url = f"http://127.0.0.1:{srv.start()}"
    try:
        assert srv.pool is None and srv.runner.pool is None
        st, body = _get(url + "/healthz")
        assert "models" not in body and "model_current" not in body
        st, body = _get(url + "/debug/engine")
        assert "modelpool" not in body
        off = _stream_ids(url, LLAMA, PROMPTS[0])[0]
    finally:
        srv.shutdown()
    assert off == _jax_tokens(QWEN)[0]          # served by the one model


def test_an_engine_without_a_config_is_refused():
    class NotAnEngine:
        pass
    with pytest.raises(ValueError):
        OpenAIServer(NotAnEngine(), ServerConfig(host="127.0.0.1", port=0,
                                                 served_model_name="a", model_catalog="a,b"))
