"""The windowed, softcapped, Gemma-norm and layernorm families and the
sliding-window block release, in the port against the JAX package, on the
CPU.

float32 copies of ``tiny-mistral`` (every layer an 8-token window),
``tiny-gemma`` (Gemma norms and the sqrt(hidden) embedding scale),
``tiny-gemma2`` (alternating windows, attention and final softcaps,
sandwich norms), ``tiny-gemma3`` (5:1 local and global layers, a local
rope base, scaled global rope, qk-norm) and ``tiny-opt`` (layernorm,
learned positions, biases): the same parameters (the JAX tree handed over
as numpy) on both sides, the plain attention on both.  Logits are held at
atol 1e-4, tokens exactly.  The rolling-buffer release: the block manager's
unit cases mirror tests/test_block_manager.py, the engine's released
blocks step by step and its tokens equal the JAX engine's with prefix
caching and the KV tiers on, release never changes a token (also under
speculation, the twin of tests/test_spec_decode.py's case), and
``/metrics`` carries ``tpuserve_window_released_blocks`` as the JAX
server does.  Also: the card's weight maker (``init_params_device``) draws
``init_params``' tree.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import transformer as jax_tf
from tpuserve.models import weights as jax_weights
from tpuserve.models.config import get_model_config as jax_get_model_config
from tpuserve.runtime import kv_cache as jax_kv
from tpuserve.runtime import spec as jax_spec
from tpuserve.runtime.block_manager import BlockManager as JaxBlockManager
from tpuserve.server.openai_api import OpenAIServer as JaxServer
from tpuserve.server.openai_api import ServerConfig as JaxServerConfig
from tpuserve_torch.models import transformer, weights
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.ops.attention import PAD_SLOT
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig, SamplingParams,
                                    SchedulerConfig, kv_cache, spec)
from tpuserve_torch.runtime.block_manager import RELEASED, BlockManager
from tpuserve_torch.server import OpenAIServer, ServerConfig


@pytest.fixture(autouse=True, scope="module")
def _torch_setup():
    """Two torch intra-op threads while this file runs (pytest-xdist runs
    several files at once on the same cores) and float32 products in full
    precision."""
    n = torch.get_num_threads()
    prec = torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


ATOL = 1e-4
FAMILIES = ["tiny-mistral", "tiny-gemma", "tiny-gemma2", "tiny-gemma3", "tiny-opt"]
BS, NB, MB = 4, 64, 16          # block size, blocks, blocks per sequence
_MODELS: dict = {}


def _model(name):
    """(JAX config, JAX params, port config, port params), float32, seed 5."""
    if name not in _MODELS:
        jcfg = dataclasses.replace(jax_get_model_config(name), dtype="float32")
        cfg = dataclasses.replace(get_model_config(name), dtype="float32")
        jparams = jax_weights.init_params(jcfg, seed=5)
        params = weights.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
        _MODELS[name] = (jcfg, jparams, cfg, params)
    return _MODELS[name]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ---- the transformer -----------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_equals_jax_init_bitwise(name):
    cfg = get_model_config(name)
    ours = dict(_leaves(weights.init_params(cfg, seed=3, device="cpu")))
    ref = dict(_leaves(jax.tree.map(np.asarray, jax_weights.init_params(
        jax_get_model_config(name), seed=3))))
    assert ours.keys() == ref.keys()
    for k, leaf in ours.items():
        want = torch.from_numpy(np.array(ref[k], np.float32)).to(leaf.dtype)
        assert torch.equal(leaf, want), k


@pytest.mark.parametrize("name", FAMILIES + ["tiny-moe", "tiny-qwen3"])
def test_device_weights_have_init_params_tree(name):
    """The weight maker chip_smoke.py uses on the card draws init_params'
    keys, shapes and dtypes (other numbers: a torch generator)."""
    cfg = get_model_config(name)
    a = dict(_leaves(weights.init_params(cfg, seed=0, device="cpu")))
    b = dict(_leaves(weights.init_params_device(cfg, seed=0, device="cpu")))
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
    again = dict(_leaves(weights.init_params_device(cfg, seed=0, device="cpu")))
    assert all(torch.equal(b[k], again[k]) for k in b)        # seeded


def _caches(jcfg, cfg):
    cc = dict(block_size=BS, num_blocks=NB, max_blocks_per_seq=MB, dtype="float32")
    return (jax_kv.create_kv_cache(jcfg, jax_rt.CacheConfig(**cc)),
            kv_cache.create_kv_cache(cfg, CacheConfig(**cc), "cpu"))


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_decode_and_chunk_logits_match_jax(name):
    """Prompts past the 8-token windows: a batched prefill, one decode
    step, then a chunk of 8 on a third sequence's 24 cached tokens."""
    jcfg, jparams, cfg, params = _model(name)
    jcache, cache = _caches(jcfg, cfg)
    bt = np.arange(3 * MB, dtype=np.int32).reshape(3, MB) % NB
    rng = np.random.default_rng(6)
    T = 24
    lens = np.array([24, 17], np.int32)
    tokens = rng.integers(2, cfg.vocab_size, (2, T)).astype(np.int32)
    slots = np.full((2, T), PAD_SLOT, np.int32)
    for b, n in enumerate(lens):
        tokens[b, n:] = 0
        t = np.arange(n)
        slots[b, :n] = bt[b, t // BS] * BS + t % BS
    args = (tokens, lens, slots)
    jl, jcache = jax_tf.prefill(jparams, jcfg, *map(jnp.asarray, args), jcache)
    tl, _ = transformer.prefill(params, cfg, *map(torch.from_numpy, args), cache,
                                attn_impl="reference")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    toks = np.asarray(jl).argmax(-1).astype(np.int32)
    slot = (bt[np.arange(2), lens // BS] * BS + lens % BS).astype(np.int32)
    args = (toks, lens, slot, bt[:2], (lens + 1).astype(np.int32))
    jl2, jcache = jax_tf.decode_step(jparams, jcfg, *map(jnp.asarray, args), jcache)
    tl2, _ = transformer.decode_step(params, cfg, *map(torch.from_numpy, args), cache,
                                     attn_impl="reference")
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL, rtol=0)
    # a third sequence: 24 tokens in chunks of 8 (the last over 16 cached)
    prompt = rng.integers(2, cfg.vocab_size, (1, 24)).astype(np.int32)
    for start in (0, 8, 16):
        t = np.arange(start, start + 8)
        args = (prompt[:, start:start + 8], np.array([start], np.int32),
                np.array([8], np.int32), (bt[2, t // BS] * BS + t % BS)[None].astype(np.int32),
                bt[2:3])
        jl3, jcache = jax_tf.prefill_chunk(jparams, jcfg, *map(jnp.asarray, args), jcache)
        tl3, _ = transformer.prefill_chunk(params, cfg, *map(torch.from_numpy, args), cache,
                                           attn_impl="reference")
        np.testing.assert_allclose(tl3.numpy(), np.asarray(jl3), atol=ATOL, rtol=0)


# ---- the engines ---------------------------------------------------------------

CACHE = dict(block_size=BS, num_blocks=256, max_blocks_per_seq=32, dtype="float32")
SCHED = dict(max_num_seqs=4, min_prefill_bucket=8, min_decode_bucket=2)
GREEDY = dict(max_tokens=16, temperature=0.0, ignore_eos=True)


def _port(name, sched=None, **kw):
    _, _, cfg, params = _model(name)
    kw = dict(dict(pipeline_decode=False), **kw)
    return Engine(EngineConfig(model=name, cache=CacheConfig(**CACHE),
                               scheduler=SchedulerConfig(**(sched or SCHED)), **kw),
                  params=params, model_cfg=cfg, device="cpu")


def _jax(name, sched=None, **kw):
    jcfg, jparams, _, _ = _model(name)
    kw = dict(dict(pipeline_decode=False, slo_classes=False, kv_tiers=False,
                   attn_impl="reference", multi_step=1), **kw)
    return jax_rt.Engine(jax_rt.EngineConfig(
        model=name, cache=jax_rt.CacheConfig(**CACHE),
        scheduler=jax_rt.SchedulerConfig(**(sched or SCHED)), **kw),
        params=jparams, model_cfg=jcfg)


def _prompts(seed=1, lens=(30, 11, 45)):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 200, n).tolist() for n in lens]


@pytest.mark.parametrize("name", FAMILIES)
def test_engine_greedy_streams_match_jax_engine(name):
    """Prompts past the windows, one of them in chunks of 16: the port's
    streams, chunk steps and released blocks equal the JAX engine's."""
    sched = dict(SCHED, prefill_chunk_size=16)
    port, jeng = _port(name, sched), _jax(name, sched)
    ours = port.generate(_prompts(), SamplingParams(**GREEDY))
    ref = jeng.generate(_prompts(), jax_rt.SamplingParams(**GREEDY))
    assert [r.output_token_ids for r in ours] == [r.output_token_ids for r in ref]
    assert port.stats.num_chunk_steps > 0
    assert port.stats.num_prefill_steps == jeng.stats.num_prefill_steps
    assert port.stats.released_blocks == jeng.stats.released_blocks
    # only a model whose every layer is windowed releases
    assert (port.stats.released_blocks > 0) == (name == "tiny-mistral")
    assert port.block_manager.num_seqs() == 0


def test_released_blocks_match_jax_step_by_step_with_prefix_caching_and_tiers():
    """tiny-mistral, prefix caching and the KV tiers on, a prompt repeated
    so its second run hits the cache: after every step the engine's
    released blocks and free blocks equal the JAX engine's, with the block
    and tier accounting checked every cycle; the tokens equal a run with
    the release off."""
    prompts = _prompts(2, (37, 26, 52))
    prompts.append(prompts[0][:24] + [7, 8, 9])
    kw = dict(enable_prefix_caching=True, kv_tiers=True)
    port, jeng = _port("tiny-mistral", **kw), _jax("tiny-mistral", **kw)
    port._strict_blocks = True
    sp, jsp = SamplingParams(**GREEDY), jax_rt.SamplingParams(**GREEDY)
    trace, jtrace = [], []
    for eng, p, tr in ((port, sp, trace), (jeng, jsp, jtrace)):
        rids = [eng.add_request(prompt_token_ids=x, params=p) for x in prompts[:3]]
        n = 0
        while eng.has_work():
            eng.step()
            n += 1
            if n == 3:                    # the repeat arrives mid-run
                rids.append(eng.add_request(prompt_token_ids=prompts[3], params=p))
            tr.append((eng.stats.released_blocks, eng.block_manager.num_free_blocks))
        tr.append([eng.requests[r].output_token_ids for r in rids])
    assert trace == jtrace
    assert trace[-2][0] > 0
    off = _port("tiny-mistral", window_release=False, **kw)
    assert [r.output_token_ids for r in off.generate(prompts, sp)] == [
        r.output_token_ids for r in _port("tiny-mistral", **kw).generate(prompts, sp)]
    assert off.stats.released_blocks == 0


def test_spec_composes_with_sliding_window_and_release():
    """The port's twin of tests/test_spec_decode.py's case: n-gram verify
    windows write at positions >= num_tokens - 1, which the release's
    clamp keeps; greedy spec output equals plain decode and the JAX
    engine's spec output, and blocks were released."""
    prompts = [[1, 2, 3, 4] * 5, [7, 8] * 8]            # self-similar, past the window
    sched = dict(max_num_seqs=4, min_prefill_bucket=8, min_decode_bucket=2)
    p = SamplingParams(max_tokens=16, temperature=0.0, ignore_eos=True)
    plain = _port("tiny-mistral", sched, enable_prefix_caching=False).generate(prompts, p)
    eng = _port("tiny-mistral", sched, enable_prefix_caching=False,
                speculative=spec.SpecConfig(num_draft_tokens=3))
    specd = eng.generate(prompts, p)
    jeng = _jax("tiny-mistral", sched, enable_prefix_caching=False,
                speculative=jax_spec.SpecConfig(num_draft_tokens=3))
    jspecd = jeng.generate(prompts, jax_rt.SamplingParams(**dict(GREEDY)))
    assert ([a.output_token_ids for a in plain] == [b.output_token_ids for b in specd]
            == [c.output_token_ids for c in jspecd])
    assert eng.stats.spec_steps == jeng.stats.spec_steps > 0
    assert eng.stats.released_blocks == jeng.stats.released_blocks > 0


# ---- the block manager's release ---------------------------------------------

def test_release_out_of_window_returns_blocks():
    """tests/test_block_manager.py's case on the port's manager."""
    bm = BlockManager(num_blocks=16, block_size=4, enable_prefix_caching=False)
    bm.allocate("s", list(range(20)))          # 5 blocks
    free0 = bm.num_free_blocks
    assert bm.release_out_of_window("s", 13) == 3
    assert bm.num_free_blocks == free0 + 3
    assert bm.release_out_of_window("s", 13) == 0
    assert bm.release_out_of_window("s", 17) == 1
    table = bm.block_table("s")
    assert len(table) == 5 and table[:4] == [0, 0, 0, 0]
    assert bm._seqs["s"].blocks[:4] == [RELEASED] * 4
    bm.slot_for_token("s", 18)
    with pytest.raises(IndexError):
        bm.slot_for_token("s", 2)
    bm.free("s")
    assert bm.num_free_blocks == 16
    assert bm.num_seqs() == 0


def test_release_never_takes_the_newest_written_block():
    """The clamp: a release past the written tokens stops at the block of
    the newest one (the next append, or a verify rewrite, writes there)."""
    bm = BlockManager(num_blocks=16, block_size=4, enable_prefix_caching=False)
    bm.allocate("s", list(range(10)))          # 3 blocks, token 9 in block 2
    assert bm.release_out_of_window("s", 100) == 2
    assert bm.slot_for_token("s", 9) >= 0


def test_release_respects_shared_refcounts_and_parks_hashed_blocks():
    bm = BlockManager(num_blocks=16, block_size=4)
    prompt = list(range(100, 116))              # 4 full blocks
    bm.allocate("a", prompt)
    shared, n = bm.lookup_prefix(prompt + [1])
    assert len(shared) >= 2
    bm.allocate("b", prompt + [1], shared_blocks=shared)
    free0, cached0 = bm.num_free_blocks, bm.num_cached_blocks
    bm.release_out_of_window("a", 8)           # b still holds them
    assert bm.num_free_blocks == free0 and bm.num_cached_blocks == cached0
    bm.release_out_of_window("b", 8)           # now hashed: parked, still a prefix hit
    assert bm.num_cached_blocks == cached0 + 2
    assert bm.lookup_prefix(prompt + [2], count_stats=False)[1] >= 8
    bm.check_integrity(expected_seq_ids={"a", "b"})
    bm.free("b")
    bm.free("a")
    bm.check_integrity(expected_seq_ids=set())
    assert bm.num_seqs() == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_release_matches_the_jax_manager_on_random_traces(seed):
    """Random allocate / append / release / free traces: tables, released
    counts and free blocks equal the JAX manager's after every op."""
    rng = np.random.default_rng(seed)
    ours, ref = BlockManager(64, 4), JaxBlockManager(64, 4)
    live, nxt = {}, 0
    for _ in range(200):
        op = rng.integers(4)
        if op == 0 or not live:
            sid = f"s{nxt}"
            nxt += 1
            prompt = rng.integers(0, 6, rng.integers(1, 20)).tolist()
            if ref.num_free_blocks < 8:
                continue
            for bm in (ours, ref):
                bm.allocate(sid, prompt)
            live[sid] = len(prompt)
        else:
            sid = sorted(live)[rng.integers(len(live))]
            if op == 1 and ref.num_free_blocks > 1:
                assert ours.append_slot(sid) == ref.append_slot(sid)
                live[sid] += 1
            elif op == 2:
                first = int(rng.integers(0, live[sid] + 4))
                assert (ours.release_out_of_window(sid, first)
                        == ref.release_out_of_window(sid, first))
            elif op == 3:
                for bm in (ours, ref):
                    bm.free(sid)
                del live[sid]
        for sid in live:
            assert ours.block_table(sid) == ref.block_table(sid)
        assert ours.num_free_blocks == ref.num_free_blocks
    ours.check_integrity(expected_seq_ids=set(live))


# ---- /metrics --------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read().decode())


def _released(text):
    """The counter's value and its TYPE line."""
    rows = [ln for ln in text.splitlines()
            if ln.startswith("tpuserve_window_released_blocks_total{")]
    # prometheus_client adds a _created gauge per family; the port does not
    types = [ln for ln in text.splitlines()
             if ln.startswith("# TYPE tpuserve_window_released_blocks")
             and "_created" not in ln]
    return (float(rows[0].split()[-1]) if rows else None), types


def test_metrics_count_window_released_blocks_as_the_jax_server():
    """One windowed request past its window through each server: both
    expose ``tpuserve_window_released_blocks`` (a counter), with the same
    count."""
    body = {"prompt": list(range(2, 42)), "max_tokens": 12, "temperature": 0,
            "ignore_eos": True}
    port = OpenAIServer(_port("tiny-mistral"), ServerConfig(host="127.0.0.1", port=0))
    jsrv = JaxServer(_jax("tiny-mistral"), JaxServerConfig(host="127.0.0.1", port=0,
                                                          tpu_metrics=False, slo_burn=False))
    try:
        counts = {}
        for key, srv in (("port", port), ("jax", jsrv)):
            url = f"http://127.0.0.1:{srv.start()}"
            _post(url + "/v1/completions", body)
            counts[key] = _released(_get(url + "/metrics"))
    finally:
        port.shutdown()
        jsrv.shutdown()
    (ours, types), (ref, jtypes) = counts["port"], counts["jax"]
    assert ours == ref > 0
    assert types == jtypes == ["# TYPE tpuserve_window_released_blocks_total counter"]
