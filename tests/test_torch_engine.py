"""The port's engine on the CPU, against the JAX package's engine.

Both engines serve float32 tiny-qwen3 with the same parameters (the JAX
tree handed over as numpy), the same CacheConfig and the same scheduler
settings with chunked prefill off; greedy token streams, texts and finish
reasons must be equal.  The rest checks the port's own engine: fused
windows against single steps, prefix-cache reuse, preemption, abort, the
block manager draining, and the options this slice refuses.
"""

import dataclasses

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


def test_preemption_replays_token_identically(model):
    """A cache too small for every stream forces decode-OOM preemption and
    a re-prefill of prompt + generated tokens; greedy streams are
    unchanged."""
    params = SamplingParams(max_tokens=24, temperature=0.0, ignore_eos=True)
    roomy = _port(model).generate(PROMPTS, params)
    small = dict(CACHE, num_blocks=24)
    eng = _port(model, cache=small)
    tight = eng.generate(PROMPTS, params)
    assert eng.stats.preemptions > 0
    assert _summary(tight) == _summary(roomy)
    eng.block_manager.check_integrity(expected_seq_ids=())


def test_abort(model):
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


def test_block_manager_drains_to_zero(model):
    eng = _port(model, multi_step=4)
    eng.generate(PROMPTS * 2, SamplingParams(max_tokens=9, temperature=0.0))
    assert eng.block_manager.num_seqs() == 0
    eng.block_manager.check_integrity(expected_seq_ids=())
    assert not eng.has_work() and not eng.scheduler.running


@pytest.mark.parametrize("kw", [dict(quantization="int8"), dict(lora_dir="/x"),
                                dict(lora_modules={"a": "/x"}),
                                dict(speculative=object()),
                                dict(checkpoint_dir="/x")])
def test_unported_engine_options_raise(model, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(model, **kw)


def test_unported_mesh_and_mixed_batching_raise(model):
    _, _, cfg, params = model
    with pytest.raises(NotImplementedError, match="A10"):
        Engine(EngineConfig(model="tiny-qwen3"), params=params, model_cfg=cfg,
               mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ragged"):
        _port(model, sched=dict(SCHED, mixed_batching=True))


@pytest.mark.parametrize("kw", [dict(top_k=5), dict(top_p=0.9), dict(min_p=0.1),
                                dict(presence_penalty=0.5),
                                dict(repetition_penalty=1.2), dict(logprobs=2),
                                dict(logit_bias={3: 1.0}), dict(min_tokens=2),
                                dict(guided="json")])
def test_unported_sampling_options_raise(model, kw):
    eng = _port(model)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.add_request(prompt="x", params=SamplingParams(**kw))
    assert not eng.has_work() and not eng.requests


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
