"""The port's engine on the CPU, against the JAX package's engine.

Both engines serve float32 tiny-qwen3 with the same parameters (the JAX
tree handed over as numpy), the same CacheConfig and the same scheduler
settings (chunked prefill off on the JAX side; these prompts never chunk
by length); greedy token streams, texts and finish reasons must be equal.
tests/test_torch_chunked_mixed.py holds the chunked and mixed paths.  The
rest checks the port's own engine: fused windows against single steps,
prefix-cache reuse, preemption, abort, the block manager draining, the
sampling options (greedy ones against the JAX engine) and the options this
slice refuses.
"""

import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig,
                                    FinishReason, SamplingParams, SchedulerConfig)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores, and torch would otherwise
    start one thread a core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


PROMPTS = ["Hello world", "The quick brown fox jumps", "a",
           "paged attention on a card", "zzz zzz zzz zzz zzz zzz zzz"]
CACHE = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16, dtype="float32")
SCHED = dict(max_num_seqs=8, max_prefill_tokens=256, min_prefill_bucket=8,
             min_decode_bucket=2)


@pytest.fixture(scope="module")
def model(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _port(model, cache=CACHE, sched=SCHED, **kw):
    _, _, cfg, params = model
    conf = EngineConfig(model="tiny-qwen3", cache=CacheConfig(**cache),
                        scheduler=SchedulerConfig(**sched), **kw)
    return Engine(conf, params=params, model_cfg=cfg, device="cpu")


def _jax_run(model, prompts, params_list):
    jcfg, jparams, _, _ = model
    conf = jax_rt.EngineConfig(
        model="tiny-qwen3", cache=jax_rt.CacheConfig(**CACHE),
        scheduler=jax_rt.SchedulerConfig(allow_chunked_prefill=False, **SCHED),
        attn_impl="reference", multi_step=1, kv_tiers=False, slo_classes=False)
    eng = jax_rt.Engine(conf, params=jparams, model_cfg=jcfg)
    return eng.generate(prompts, [jax_rt.SamplingParams(**p) for p in params_list])


def _summary(reqs):
    return [(r.output_token_ids, r.output_text, r.finish_reason.value) for r in reqs]


@pytest.fixture(scope="module")
def jax_greedy(model):
    return _jax_run(model, PROMPTS, [dict(max_tokens=10, temperature=0.0)] * len(PROMPTS))


def test_greedy_streams_match_jax_engine(model, jax_greedy):
    ours = _port(model).generate(PROMPTS, SamplingParams(max_tokens=10, temperature=0.0))
    assert _summary(ours) == _summary(jax_greedy)


def test_stop_rules_match_jax_engine(model, jax_greedy):
    """Stop ids, stop strings, ignore_eos and max_tokens are host logic;
    with the same streams both engines must cut at the same token."""
    first = jax_greedy[1].output_token_ids
    text = jax_greedy[0].output_text
    plist = [dict(max_tokens=10, temperature=0.0, stop_token_ids=(first[3],)),
             dict(max_tokens=10, temperature=0.0, stop=(text[2:4] or "x",)),
             dict(max_tokens=7, temperature=0.0, ignore_eos=True),
             dict(max_tokens=10, temperature=0.0, stop=("zz",),
                  include_stop_str_in_output=True)]
    prompts = [PROMPTS[1], PROMPTS[0], PROMPTS[2], PROMPTS[4]]
    ref = _jax_run(model, prompts, plist)
    ours = _port(model).generate(prompts, [SamplingParams(**p) for p in plist])
    assert _summary(ours) == _summary(ref)
    assert ours[0].output_token_ids[-1] == first[3]


@pytest.mark.parametrize("sp", [dict(temperature=0.0),
                                dict(temperature=0.8, seed=11, ignore_eos=True)])
def test_multi_step_window_matches_single_step(model, sp):
    params = SamplingParams(max_tokens=13, **sp)
    one = _port(model, multi_step=1).generate(PROMPTS, params)
    eng = _port(model, multi_step=8)
    eight = eng.generate(PROMPTS, params)
    assert _summary(eight) == _summary(one)
    assert eng.stats.num_decode_windows > 0
    assert eng.block_manager.num_seqs() == 0


def test_seeded_sampling_is_reproducible_and_seed_dependent(model):
    eng = _port(model)
    a = eng.generate(PROMPTS[:2], SamplingParams(max_tokens=8, temperature=1.0,
                                                 seed=5, ignore_eos=True))
    b = eng.generate(PROMPTS[:2], SamplingParams(max_tokens=8, temperature=1.0,
                                                 seed=5, ignore_eos=True))
    c = eng.generate(PROMPTS[:2], SamplingParams(max_tokens=8, temperature=1.0,
                                                 seed=6, ignore_eos=True))
    assert _summary(a) == _summary(b) != _summary(c)


def test_prefix_cache_reuse(model):
    eng = _port(model)
    prompt = "a shared system prompt that fills several blocks: "
    params = SamplingParams(max_tokens=6, temperature=0.0)
    first = eng.generate([prompt + "one"], params)[0]
    hits = eng.block_manager.prefix_hits
    second = eng.generate([prompt + "one"], params)[0]
    assert eng.block_manager.prefix_hits == hits + 1
    assert second.output_token_ids == first.output_token_ids
    assert eng.block_manager.num_seqs() == 0


def test_preemption_replays_token_identically(model, monkeypatch):
    """A cache too small for every stream forces decode-OOM preemption and
    a re-prefill of prompt + generated tokens; greedy streams are
    unchanged."""
    params = SamplingParams(max_tokens=24, temperature=0.0, ignore_eos=True)
    roomy = _port(model).generate(PROMPTS, params)
    small = dict(CACHE, num_blocks=24)
    # the Python block manager: the integrity check reads its sequence table
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", "python")
    eng = _port(model, cache=small)
    tight = eng.generate(PROMPTS, params)
    assert eng.stats.preemptions > 0
    assert _summary(tight) == _summary(roomy)
    eng.block_manager.check_integrity(expected_seq_ids=())


def test_abort(model, monkeypatch):
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", "python")    # check_integrity below
    eng = _port(model)
    params = SamplingParams(max_tokens=20, temperature=0.0, ignore_eos=True)
    keep = eng.add_request(prompt="keep going", params=params)
    drop = eng.add_request(prompt="abort me", params=params)
    eng.step()                                      # prefill both
    assert eng.abort_request(drop)
    assert not eng.abort_request(drop)
    queued = eng.add_request(prompt="never admitted", params=params)
    assert eng.abort_request(queued)
    while eng.has_work():
        eng.step()
    assert eng.requests[drop].finish_reason == FinishReason.ABORT
    assert eng.requests[queued].finish_reason == FinishReason.ABORT
    assert len(eng.requests[keep].output_token_ids) == 20
    eng.block_manager.check_integrity(expected_seq_ids=())
    assert not eng.abort_request("no-such-request")


def test_block_manager_drains_to_zero(model, monkeypatch):
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", "python")    # check_integrity below
    eng = _port(model, multi_step=4)
    eng.generate(PROMPTS * 2, SamplingParams(max_tokens=9, temperature=0.0))
    assert eng.block_manager.num_seqs() == 0
    eng.block_manager.check_integrity(expected_seq_ids=())
    assert not eng.has_work() and not eng.scheduler.running


@pytest.mark.parametrize("kw", [dict(quantization="fp4"),
                                dict(lora_modules={"a": "/x"}, speculative="spec"),
                                dict(lora_dir="/nonexistent-adapter-dir")])
def test_unported_engine_options_raise(model, kw):
    """The A8 options are ported (tests/test_torch_int8.py and
    test_torch_lora.py hold them against the JAX engine); what the JAX
    engine refuses, the port refuses: an unknown quantization, multi-LoRA
    beside speculative decoding, an adapter directory that is not there."""
    from tpuserve_torch.runtime.spec import SpecConfig
    if kw.get("speculative") == "spec":
        kw = dict(kw, speculative=SpecConfig(num_draft_tokens=2))
    with pytest.raises((ValueError, FileNotFoundError),
                       match="quantization|speculative|adapter_config"):
        _port(model, **kw)


def test_speculative_engine_option_builds_and_serves(model):
    """``speculative`` is ported: the engine builds and its greedy stream
    is the plain engine's (tests/test_torch_spec.py holds it against the
    JAX engine)."""
    from tpuserve_torch.runtime.spec import SpecConfig
    prompts = [[1, 2, 3, 4] * 5]
    sp = SamplingParams(max_tokens=10, temperature=0.0, ignore_eos=True)
    eng = _port(model, speculative=SpecConfig(num_draft_tokens=4))
    toks = eng.generate(prompts, sp)[0].output_token_ids
    assert eng.stats.spec_steps > 0
    assert toks == _port(model).generate(prompts, sp)[0].output_token_ids


def test_unported_mesh_and_mixed_batching_raise(model):
    """A mesh still raises; mixed batching is ported and builds an engine
    whose scheduler packs at the ragged block."""
    _, _, cfg, params = model
    with pytest.raises(NotImplementedError, match="A10"):
        Engine(EngineConfig(model="tiny-qwen3"), params=params, model_cfg=cfg,
               mesh=object(), device="cpu")
    eng = _port(model, sched=dict(SCHED, mixed_batching=True))
    assert eng.scheduler.cfg.mixed_batching
    assert eng.scheduler.ragged_align == eng._ragged_blk == 8


def test_guided_requests_are_served(model):
    """Every guided mode is served (none is refused naming a ROADMAP.md
    item): greedy json, regex and choice requests finish with a document
    of their spec, their grammar state released."""
    eng = _port(model)
    outs = eng.generate(["x", "y", "z"], [
        SamplingParams(max_tokens=24, temperature=0.0, guided="json"),
        SamplingParams(max_tokens=24, temperature=0.0, guided="regex",
                       guided_schema="[ab]{2}c"),
        SamplingParams(max_tokens=24, temperature=0.0, guided="choice",
                       guided_schema='["red", "green"]')])
    assert [r.finish_reason.value for r in outs] == ["stop"] * 3
    assert isinstance(json.loads(outs[0].output_text), dict)
    assert re.fullmatch("[ab]{2}c", outs[1].output_text)
    assert outs[2].output_text in ("red", "green")
    assert eng.stats.guided_fsm_requests == 3 and not eng._guided_fsm


SAMPLING_OPTIONS = [dict(top_k=5), dict(top_p=0.9), dict(min_p=0.1),
                    dict(presence_penalty=0.5), dict(repetition_penalty=1.2),
                    dict(logprobs=2), dict(logit_bias={3: 1.0}), dict(min_tokens=2)]


@pytest.mark.parametrize("kw", SAMPLING_OPTIONS,
                         ids=["/".join(k) for k in SAMPLING_OPTIONS])
def test_sampling_options_are_accepted_and_match_jax(model, kw):
    """Each option set the port once refused is served.  Greedy (the
    penalties, logprobs, bias and floor at temperature 0): the JAX
    engine's streams, texts, finish reasons and logprobs (atol 1e-4).
    Truncated sampling: seeded streams the same in windows and single
    steps, with tokens in the vocabulary."""
    prompts = PROMPTS[:3]
    if any(k in kw for k in ("top_k", "top_p", "min_p")):
        plist = [dict(max_tokens=8, temperature=0.9, seed=i, **kw) for i in range(3)]
        single = _port(model).generate(prompts, [SamplingParams(**p) for p in plist])
        windows = _port(model, multi_step=4, pipeline_decode=True).generate(
            prompts, [SamplingParams(**p) for p in plist])
        assert [r.output_token_ids for r in single] == [r.output_token_ids for r in windows]
        assert all(0 <= t < model[2].vocab_size for r in single for t in r.output_token_ids)
        return
    plist = [dict(max_tokens=8, temperature=0.0, **kw)] * 3
    ref = _jax_run(model, prompts, plist)
    ours = _port(model, multi_step=4).generate(prompts, [SamplingParams(**p) for p in plist])
    assert _summary(ours) == _summary(ref)
    for o, r in zip(ours, ref):
        assert [e["token_id"] for e in o.logprobs] == [e["token_id"] for e in r.logprobs]
        np.testing.assert_allclose([e["logprob"] for e in o.logprobs],
                                   [e["logprob"] for e in r.logprobs], atol=1e-4, rtol=0)
        assert [[t for t, _ in e["top"]] for e in o.logprobs] == [
            [t for t, _ in e["top"]] for e in r.logprobs]
    if "logprobs" in kw:
        assert all(len(r.logprobs) == len(r.output_token_ids) for r in ours)


def test_intake_validation(model):
    eng = _port(model)
    with pytest.raises(ValueError, match="empty"):
        eng.add_request(prompt_token_ids=[])
    with pytest.raises(ValueError, match="integers"):
        eng.add_request(prompt_token_ids=[1, 10_000])
    with pytest.raises(ValueError, match="exceeds"):
        eng.add_request(prompt_token_ids=[1] * 64)
    with pytest.raises(ValueError, match="slo_class"):
        eng.add_request(prompt="x", params=SamplingParams(slo_class="gold"))
    assert not eng.has_work()


def test_defaults_are_keyed_on_the_device():
    conf = EngineConfig()
    assert conf.resolve_attn_impl(torch.device("cuda")) == "cuda"
    assert conf.resolve_attn_impl(torch.device("cpu")) == "reference"
    assert conf.resolve_multi_step(torch.device("cuda")) == 32
    assert conf.resolve_multi_step(torch.device("cpu")) == 1
    assert EngineConfig(multi_step=4).resolve_multi_step(torch.device("cpu")) == 4


def test_cpu_engine_with_kernel_wrappers(model):
    """attn_impl="cuda" on CPU tensors runs the wrappers' plain versions:
    the same streams as the reference attention."""
    params = SamplingParams(max_tokens=8, temperature=0.0)
    ref = _port(model, attn_impl="reference", multi_step=4).generate(PROMPTS, params)
    wrapped = _port(model, attn_impl="cuda", multi_step=4).generate(PROMPTS, params)
    assert _summary(wrapped) == _summary(ref)
