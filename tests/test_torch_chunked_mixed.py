"""The port's chunked-prefill and mixed ragged engine paths on the CPU,
against the JAX package's engine.

Both engines serve float32 tiny-qwen3 with the same parameters (the JAX
tree handed over as numpy), the same CacheConfig and the same scheduler
settings, on the plain attention; greedy token streams must be equal.
Mirrors tests/test_chunked_prefill.py and tests/test_mixed.py: prompts
longer than ``prefill_chunk_size``, the prefix-cache compute skip, a
request preempted mid-chunk, an abort mid-chunk, and mixed steps with
staggered arrivals, preemption and fused windows.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve_torch import runtime as port_rt
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime import Engine, SamplingParams
from tpuserve_torch.runtime.request import Request, RequestState


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores, and torch would otherwise
    start one thread a core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=24, dtype="float32")
GREEDY = dict(max_tokens=8, temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def model(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _conf(mod, cache, sched, **kw):
    return mod.EngineConfig(model="tiny-qwen3", cache=mod.CacheConfig(**cache),
                            scheduler=mod.SchedulerConfig(**sched), **kw)


def _port(model, cache=CACHE, **sched_kw):
    _, _, cfg, params = model
    sched = {"max_num_seqs": 4, **sched_kw}
    kw = {k: sched.pop(k) for k in ("enable_prefix_caching", "multi_step", "attn_impl")
          if k in sched}
    return Engine(_conf(port_rt, cache, sched, **kw), params=params, model_cfg=cfg,
                  device="cpu")


def _jax(model, cache=CACHE, **sched_kw):
    jcfg, jparams, _, _ = model
    sched = {"max_num_seqs": 4, **sched_kw}
    kw = dict(attn_impl="reference", multi_step=1, kv_tiers=False, slo_classes=False)
    kw.update({k: sched.pop(k) for k in ("enable_prefix_caching", "multi_step")
               if k in sched})
    return jax_rt.Engine(_conf(jax_rt, cache, sched, **kw), params=jparams,
                         model_cfg=jcfg)


def _prompts(seed=1, lens=(20, 33, 7, 5)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, size=n).tolist() for n in lens]


def _staggered(eng, sp_cls, prompts, first=2, after=3, **sp):
    """Add ``prompts[:first]``, step ``after`` times, add the rest, drain;
    return each request's tokens in prompt order."""
    p = sp_cls(**sp)
    rids = [eng.add_request(prompt_token_ids=x, params=p) for x in prompts[:first]]
    for _ in range(after):
        eng.step()
    rids += [eng.add_request(prompt_token_ids=x, params=p) for x in prompts[first:]]
    while eng.has_work():
        eng.step()
    return [eng.requests[r].output_token_ids for r in rids]


def _ids(reqs):
    return [r.output_token_ids for r in reqs]


# ---- chunked prefill --------------------------------------------------------

@pytest.mark.parametrize("prefix", [False, True])
def test_long_prompts_chunk_and_match_jax_engine(model, prefix):
    """Prompts longer than prefill_chunk_size run chunk by chunk, the short
    one stays on the batched path, and the streams equal the JAX engine's
    and a one-shot (unchunked) run's."""
    prompts = _prompts()
    kw = dict(prefill_chunk_size=8, enable_prefix_caching=prefix)
    ref = _jax(model, **kw).generate(prompts, jax_rt.SamplingParams(**GREEDY))
    eng = _port(model, **kw)
    ours = eng.generate(prompts, SamplingParams(**GREEDY))
    oneshot = _port(model, prefill_chunk_size=4096).generate(prompts, SamplingParams(**GREEDY))
    assert _ids(ours) == _ids(ref) == _ids(oneshot)
    assert [r.num_prefilled for r in ours] == [20, 33, 0, 0]
    assert eng.block_manager.num_seqs() == 0


def test_chunk_scheduling_counts(model):
    """20 tokens at chunk 8: three chunk steps, the first token on the last;
    the chunks count 20 real of 24 padded tokens, and the decode step that
    follows its one row of its bucket's."""
    eng = _port(model, prefill_chunk_size=8)
    eng.add_request(prompt_token_ids=list(range(1, 21)),
                    params=SamplingParams(max_tokens=2, temperature=0.0, ignore_eos=True))
    assert eng.step() == [] and eng.stats.num_prefill_steps == 1
    assert eng.step() == [] and eng.stats.num_prefill_steps == 2
    outs = eng.step()
    assert len(outs) == 1 and outs[0].new_token_ids and outs[0].from_prefill
    assert eng.stats.ttft_count == 1
    assert eng.stats.actual_tokens_total == 20 and eng.stats.padded_tokens_total == 24
    while eng.has_work():
        eng.step()
    assert eng.block_manager.num_seqs() == 0
    B = eng.scheduler.decode_bucket(1)
    assert eng.stats.actual_tokens_total == 21 and eng.stats.padded_tokens_total == 24 + B
    assert (eng.stats.step_actual_tokens, eng.stats.step_padded_tokens) == (1, B)


def test_prefix_cache_compute_skip_matches_jax(model):
    """A repeated prompt with a substantial cache hit takes the chunk route
    and computes only its uncached tail (one chunk step), with the tokens
    of a cold run and of the JAX engine."""
    prompt = list(range(1, 23))      # 22 tokens = 5 full blocks + tail
    kw = dict(prefill_chunk_size=64, enable_prefix_caching=True)
    p = SamplingParams(max_tokens=5, temperature=0.0, ignore_eos=True)
    eng = _port(model, **kw)
    cold = eng.generate([prompt], p)[0].output_token_ids
    steps, hits = eng.stats.num_prefill_steps, eng.block_manager.prefix_hits
    warm = eng.generate([prompt + [7, 8]], p)[0]
    assert eng.block_manager.prefix_hits == hits + 1
    assert eng.stats.num_prefill_steps == steps + 1
    assert warm.num_prefilled == 24
    jeng = _jax(model, **kw)
    jp = jax_rt.SamplingParams(max_tokens=5, temperature=0.0, ignore_eos=True)
    jcold = jeng.generate([prompt], jp)[0].output_token_ids
    jwarm = jeng.generate([prompt + [7, 8]], jp)[0].output_token_ids
    assert (cold, warm.output_token_ids) == (jcold, jwarm)
    assert eng.generate([prompt], p)[0].output_token_ids == cold
    assert eng.block_manager.num_seqs() == 0


def test_preemption_mid_stream_replays_through_chunks_like_jax(model, monkeypatch):
    """A cache too small for every stream preempts; the victims re-prefill
    prompt + generated tokens through the chunk route (hitting their own
    freed blocks), and every stream equals the JAX engine's."""
    cache = dict(CACHE, num_blocks=12, max_blocks_per_seq=10)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5], [4, 4, 4]]
    kw = dict(max_num_seqs=3, enable_prefix_caching=True, prefill_chunk_size=8)
    sp = dict(max_tokens=16, temperature=0.0, ignore_eos=True)
    jeng = _jax(model, cache=cache, **kw)
    ref = jeng.generate(prompts, jax_rt.SamplingParams(**sp))
    # the Python block manager: the integrity check reads its sequence table
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", "python")
    eng = _port(model, cache=cache, **kw)
    ours = eng.generate(prompts, SamplingParams(**sp))
    assert eng.stats.preemptions > 0
    assert _ids(ours) == _ids(ref)
    assert all(len(r.output_token_ids) == 16 for r in ours)
    eng.block_manager.check_integrity(expected_seq_ids=())


def test_mid_chunk_request_resumes_from_any_queue_position(model):
    """A preemption victim put at the head of the queue ahead of a
    mid-chunk request does not starve it, and its stream is unchanged."""
    p = SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
    long_prompt = list(range(1, 21))
    alone = _port(model, prefill_chunk_size=8).generate([long_prompt], p)[0]
    eng = _port(model, prefill_chunk_size=8)
    rid = eng.add_request(prompt_token_ids=long_prompt, params=p)
    eng.step()                       # chunk 1: mid-chunk, back in waiting
    victim = Request(request_id="victim", prompt_token_ids=[1, 2, 3], params=p)
    victim.state = RequestState.PREEMPTED
    eng.requests["victim"] = victim
    eng._detok["victim"] = type(eng._detok[rid])(eng.tokenizer)
    eng.scheduler.waiting.appendleft(victim)
    batch = eng.scheduler.schedule()
    assert batch.kind == "prefill_chunk" and batch.requests[0].num_prefilled > 0
    eng.scheduler.waiting.appendleft(batch.requests[0])
    while eng.has_work():
        eng.step()
    assert eng.requests[rid].output_token_ids == alone.output_token_ids
    assert len(victim.output_token_ids) == 4
    assert eng.block_manager.num_seqs() == 0


@pytest.mark.parametrize("mixed", [False, True])
def test_abort_mid_chunk_publishes_no_unwritten_prefix(model, mixed, monkeypatch):
    """Aborting a request between chunks frees its blocks without parking
    the never-written ones in the prefix cache: the same prefix then gives
    the tokens of a fresh engine, and the block manager drains to zero."""
    kw = dict(prefill_chunk_size=8, enable_prefix_caching=True)
    if mixed:
        kw.update(mixed_batching=True, mixed_token_budget=8)
    prompt = list(range(1, 25))
    p = SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
    fresh = _port(model, **kw).generate([prompt], p)[0].output_token_ids
    # the Python block manager: the integrity check reads its sequence table
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", "python")
    eng = _port(model, **kw)
    free0 = eng.block_manager.num_free_blocks
    rid = eng.add_request(prompt_token_ids=prompt, params=p)
    eng.step()                       # the first chunk only
    assert 0 < eng.requests[rid].num_prefilled < len(prompt)
    assert eng.abort_request(rid)
    assert eng.block_manager.num_free_blocks == free0
    assert eng.block_manager.lookup_prefix(prompt)[1] == 0
    assert eng.generate([prompt], p)[0].output_token_ids == fresh
    assert eng.block_manager.num_seqs() == 0
    eng.block_manager.check_integrity(expected_seq_ids=())


# ---- mixed ragged batching --------------------------------------------------

MIXED = dict(mixed_batching=True, mixed_token_budget=16)


def test_mixed_greedy_matches_jax_and_phase_split(model):
    """Prompts that chunk over several mixed steps, ride decode rows and
    finish: the streams equal the JAX mixed engine's and the port's
    phase-split engine's."""
    prompts = _prompts(3)
    ref = _jax(model, **MIXED).generate(prompts, jax_rt.SamplingParams(**GREEDY))
    eng = _port(model, **MIXED)
    ours = eng.generate(prompts, SamplingParams(**GREEDY))
    split = _port(model).generate(prompts, SamplingParams(**GREEDY))
    assert _ids(ours) == _ids(ref) == _ids(split)
    assert eng.stats.num_mixed_steps > 0
    assert eng.block_manager.num_seqs() == 0
    assert eng.stats.padded_tokens_total >= eng.stats.actual_tokens_total > 0


@pytest.mark.parametrize("multi_step", [1, 4])
def test_mixed_staggered_arrivals_match_jax(model, multi_step):
    """Streams decoding when more prompts arrive: the late prompts ride
    mixed steps beside the decode rows; with multi_step 4 the prefill-free
    cycles run fused windows between them.  Streams equal the JAX engine's
    on the same schedule."""
    prompts = _prompts(5, lens=(9, 6, 30, 14, 3))
    kw = dict(MIXED, max_num_seqs=8, multi_step=multi_step)
    ref = _staggered(_jax(model, **kw), jax_rt.SamplingParams, prompts, **GREEDY)
    eng = _port(model, **kw)
    ours = _staggered(eng, SamplingParams, prompts, **GREEDY)
    assert ours == ref
    assert eng.stats.num_mixed_steps >= 3
    assert eng.block_manager.num_seqs() == 0


def test_mixed_prefix_caching_matches_jax(model):
    """The mixed path keeps the prefix-cache compute skip (the first chunk
    starts at the cached offset) with the JAX engine's streams."""
    prompts = _prompts(9, lens=(22, 22, 6))
    kw = dict(MIXED, enable_prefix_caching=True)
    sp = dict(max_tokens=5, temperature=0.0, ignore_eos=True)
    jeng = _jax(model, **kw)
    ref = [jeng.generate([x], jax_rt.SamplingParams(**sp))[0].output_token_ids
           for x in (prompts[0], prompts[0], prompts[1])]
    eng = _port(model, **kw)
    ours = [eng.generate([x], SamplingParams(**sp))[0].output_token_ids
            for x in (prompts[0], prompts[0], prompts[1])]
    assert ours == ref and ours[0] == ours[1]
    assert eng.block_manager.prefix_hits > 0


def test_mixed_preemption_matches_jax(model):
    """Decode-OOM preemption inside a mixed step re-prefills the victim
    through the mixed path; every stream completes as in the JAX engine."""
    cache = dict(CACHE, num_blocks=12, max_blocks_per_seq=10)
    kw = dict(mixed_batching=True, mixed_token_budget=8, max_num_seqs=3)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5], [4, 4, 4]]
    sp = dict(max_tokens=16, temperature=0.0, ignore_eos=True)
    ref = _jax(model, cache=cache, **kw).generate(prompts, jax_rt.SamplingParams(**sp))
    eng = _port(model, cache=cache, **kw)
    ours = eng.generate(prompts, SamplingParams(**sp))
    assert _ids(ours) == _ids(ref)
    assert eng.stats.preemptions > 0
    assert eng.block_manager.num_seqs() == 0


def test_mixed_engine_on_the_kernel_wrappers(model):
    """attn_impl="cuda" on CPU tensors runs the ragged and window wrappers'
    plain versions (descriptors only): the streams of the reference path."""
    prompts = _prompts(17, lens=(19, 6, 9))
    ref = _port(model, **MIXED, attn_impl="reference").generate(
        prompts, SamplingParams(**GREEDY))
    wrapped = _port(model, **MIXED, attn_impl="cuda").generate(
        prompts, SamplingParams(**GREEDY))
    chunked = _port(model, prefill_chunk_size=8, attn_impl="cuda").generate(
        prompts, SamplingParams(**GREEDY))
    assert _ids(wrapped) == _ids(ref) == _ids(chunked)


def test_mixed_budget_floor_and_ragged_align(model):
    """A budget below max_num_seqs decode rows plus one block is raised,
    and the scheduler charges rows at the engine's ragged block."""
    eng = _port(model, mixed_batching=True, mixed_token_budget=4)
    assert eng._ragged_blk == 8
    assert eng.scheduler.ragged_align == 8
    assert eng.scheduler.cfg.mixed_token_budget == 16     # 8 (4 rows, padded) + 8
