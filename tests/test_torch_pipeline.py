"""The port's decode execution model on the CPU: pipelined decode, the
static-state decode step the CUDA graphs replay, the KV write that drops
padding on the device, keyed sampling noise and ``Engine.warmup``.

Both engines serve float32 tiny-qwen3 with the same parameters (the JAX
tree handed over as numpy) and the same cache and scheduler settings, on
the plain attention; the JAX engine runs with ``pipeline_decode=True`` as
its own tests run it on the CPU.  Greedy token streams, texts and finish
reasons must be equal; float32 logits agree to atol 1e-4 (the same math
summed in another order).  On the CPU the decode executables run their
step eagerly on the same static buffers the graphs replay on the card
(``runtime/graphs.py``), and a guided executable's step, grammar load
and state chaining read nothing back to the host either; the card's own
checks are in tests/test_torch_kernels.py and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import transformer as jax_tf
from tpuserve.models import weights as jax_weights
from tpuserve.ops import attention as jax_attn
from tpuserve.runtime import kv_cache as jax_kv
from tpuserve_torch import runtime as port_rt
from tpuserve_torch.models import transformer
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.tokenizer import load_tokenizer
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.ops import attention, sampling
from tpuserve_torch.ops.attention import PAD_SLOT
from tpuserve_torch.runtime import Engine, FinishReason, SamplingParams, grammar, kv_cache
from tpuserve_torch.runtime.graphs import StepGraphs


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores, and torch would otherwise
    start one thread a core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ATOL = 1e-4
CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=24, dtype="float32")
SCHED = dict(max_num_seqs=8, max_prefill_tokens=256, min_prefill_bucket=8,
             min_decode_bucket=2)
GREEDY = dict(max_tokens=14, temperature=0.0, ignore_eos=True)
# prompts whose greedy streams (seed-0 weights) end in EOS after 11, 10,
# 17 and 12 tokens: mid-window at multi_step 4
EOS_PROMPTS = [[73, 135, 115, 53, 66, 144, 120, 102, 69, 152, 80, 67],
               [168, 164, 61, 118, 176, 96, 180],
               [148, 42, 40],
               [196, 82, 87, 174, 167, 27, 5, 173]]


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


def _port(model, cache=CACHE, sched=SCHED, **kw):
    _, _, cfg, params = model
    return Engine(_conf(port_rt, cache, sched, **kw), params=params, model_cfg=cfg,
                  device="cpu")


def _jax(model, cache=CACHE, sched=SCHED, **kw):
    jcfg, jparams, _, _ = model
    sched = dict(sched, allow_chunked_prefill=False)
    kw = dict(dict(attn_impl="reference", kv_tiers=False, slo_classes=False,
                   pipeline_decode=True), **kw)
    return jax_rt.Engine(_conf(jax_rt, cache, sched, **kw), params=jparams,
                         model_cfg=jcfg)


def _prompts(seed=1, lens=(20, 33, 7, 5, 12)):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 200, size=n).tolist() for n in lens]


def _summary(reqs):
    return [(r.output_token_ids, r.output_text, r.finish_reason.value) for r in reqs]


def _drain(eng, sp_cls, prompts, plist, on_step=None):
    """Add every prompt, step until no work, calling ``on_step(eng, n)``
    after step n; the requests in prompt order."""
    rids = [eng.add_request(prompt_token_ids=p, params=sp_cls(**sp))
            for p, sp in zip(prompts, plist)]
    n = 0
    while eng.has_work():
        eng.step()
        n += 1
        if on_step is not None:
            on_step(eng, rids, n)
    return [eng.requests[r] for r in rids]


# ---- the engine, pipelined, against the JAX engine --------------------------

@pytest.mark.parametrize("multi_step", [1, 4])
def test_pipelined_greedy_streams_match_sync_and_jax(model, multi_step):
    prompts = _prompts()
    plist = [GREEDY] * len(prompts)
    eng = _port(model, multi_step=multi_step, pipeline_decode=True)
    piped = _drain(eng, SamplingParams, prompts, plist)
    sync = _drain(_port(model, multi_step=multi_step, pipeline_decode=False),
                  SamplingParams, prompts, plist)
    ref = _drain(_jax(model, multi_step=multi_step), jax_rt.SamplingParams, prompts, plist)
    assert _summary(piped) == _summary(sync) == _summary(ref)
    assert all(len(r.output_token_ids) == 14 for r in piped)
    assert eng.block_manager.num_seqs() == 0


@pytest.mark.parametrize("multi_step", [1, 4])
def test_pipelined_stops_match_sync_and_jax(model, multi_step):
    """EOS mid-window, a stop id, a stop string (with and without the stop
    text) and max_tokens: rows that finish inside a window or an in-flight
    step drop their overrun, as in the JAX engine."""
    text_ref = _drain(_port(model), SamplingParams, [_prompts()[0]],
                      [dict(max_tokens=10, temperature=0.0)])[0]
    stop_text = text_ref.output_text[2:4] or "x"
    stop_id = text_ref.output_token_ids[5]
    prompts = EOS_PROMPTS + [_prompts()[0]] * 3 + [_prompts()[1]]
    plist = ([dict(max_tokens=24, temperature=0.0)] * 4
             + [dict(max_tokens=24, temperature=0.0, stop_token_ids=(stop_id,)),
                dict(max_tokens=24, temperature=0.0, stop=(stop_text,)),
                dict(max_tokens=24, temperature=0.0, stop=(stop_text,),
                     include_stop_str_in_output=True),
                dict(max_tokens=7, temperature=0.0, ignore_eos=True)])
    eng = _port(model, multi_step=multi_step, pipeline_decode=True)
    piped = _drain(eng, SamplingParams, prompts, plist)
    sync = _drain(_port(model, multi_step=multi_step, pipeline_decode=False),
                  SamplingParams, prompts, plist)
    ref = _drain(_jax(model, multi_step=multi_step), jax_rt.SamplingParams, prompts, plist)
    assert _summary(piped) == _summary(sync) == _summary(ref)
    assert [r.finish_reason for r in piped[:5]] == [FinishReason.STOP] * 5
    assert [len(r.output_token_ids) for r in piped[:4]] == [11, 10, 17, 12]
    assert eng.block_manager.num_seqs() == 0
    if multi_step > 1:
        assert eng.stats.window_overrun_tokens > 0


@pytest.mark.parametrize("multi_step", [1, 4])
def test_abort_of_a_row_in_flight_matches_jax(model, multi_step, monkeypatch):
    """A request aborted while its decode dispatch is in flight emits
    nothing more: its tokens drop at the flush, the other rows stream on,
    and the cache drains."""
    prompts = _prompts(2, lens=(9, 14, 6))
    plist = [GREEDY] * 3

    def abort_second(eng, rids, n):
        if n == 2:                      # the first decode dispatch is in flight
            pending = eng._pending_window or eng._pending
            assert pending is not None and rids[1] in [r.request_id for r in pending.reqs]
            assert eng.abort_request(rids[1])

    def jax_abort(eng, rids, n):
        if n == 2:
            assert eng.abort_request(rids[1])

    # the Python block manager: its sequence table is what the integrity
    # check below reads (the C++ one has none; test_torch_native.py holds
    # the two equal)
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", "python")
    eng = _port(model, multi_step=multi_step, pipeline_decode=True)
    ours = _drain(eng, SamplingParams, prompts, plist, abort_second)
    ref = _drain(_jax(model, multi_step=multi_step), jax_rt.SamplingParams, prompts,
                 plist, jax_abort)
    assert [r.output_token_ids for r in ours] == [r.output_token_ids for r in ref]
    assert ours[1].finish_reason == FinishReason.ABORT
    assert len(ours[1].output_token_ids) == 1          # the prefill's token only
    assert len(ours[0].output_token_ids) == len(ours[2].output_token_ids) == 14
    eng.block_manager.check_integrity(expected_seq_ids=())


@pytest.mark.parametrize("multi_step", [1, 4])
def test_pipelined_preemption_matches_jax_and_roomy_cache(model, multi_step, monkeypatch):
    """A cache too small for every stream: windows fall back to single
    steps, which flush the in-flight dispatch before they preempt; every
    stream equals the roomy cache's and the JAX engine's."""
    prompts = _prompts(4)
    sp = dict(max_tokens=24, temperature=0.0, ignore_eos=True)
    plist = [sp] * len(prompts)
    small = dict(CACHE, num_blocks=30)
    roomy = _drain(_port(model, multi_step=multi_step), SamplingParams, prompts, plist)
    # the Python block manager: the integrity check reads its sequence table
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", "python")
    eng = _port(model, cache=small, multi_step=multi_step, pipeline_decode=True)
    tight = _drain(eng, SamplingParams, prompts, plist)
    ref = _drain(_jax(model, cache=small, multi_step=multi_step), jax_rt.SamplingParams,
                 prompts, plist)
    assert eng.stats.preemptions > 0
    assert _summary(tight) == _summary(roomy) == _summary(ref)
    eng.block_manager.check_integrity(expected_seq_ids=())


@pytest.mark.parametrize("multi_step", [1, 4])
def test_has_work_while_only_a_dispatch_is_in_flight(model, multi_step, monkeypatch):
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", "python")    # check_integrity below
    eng = _port(model, multi_step=multi_step, pipeline_decode=True)
    rid = eng.add_request(prompt_token_ids=[5, 6, 7],
                          params=SamplingParams(max_tokens=1 + multi_step,
                                                temperature=0.0, ignore_eos=True))
    eng.step()                                   # prefill: the first token
    eng.step()                                   # the last dispatch, in flight
    assert eng.requests[rid].finished is False
    assert (eng._pending or eng._pending_window) is not None
    assert eng.scheduler.has_work()
    outs = eng.step()                            # nothing to schedule: flush
    assert outs and outs[-1].finished
    assert not eng.has_work() and eng._pending is None and eng._pending_window is None
    assert len(eng.requests[rid].output_token_ids) == 1 + multi_step
    assert eng.block_manager.num_seqs() == 0
    eng.block_manager.check_integrity(expected_seq_ids=())


def test_pipelined_engine_drains_to_zero(model, monkeypatch):
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", "python")    # check_integrity below
    eng = _port(model, multi_step=4, pipeline_decode=True)
    eng.generate(_prompts() * 2, SamplingParams(max_tokens=9, temperature=0.0))
    assert eng.block_manager.num_seqs() == 0
    eng.block_manager.check_integrity(expected_seq_ids=())
    assert not eng.has_work() and not eng.scheduler.running


@pytest.mark.parametrize("multi_step", [1, 4])
def test_mixed_steps_between_pipelined_windows_match_jax(model, multi_step):
    """Streams decoding in pipelined windows when prompts arrive: each
    mixed step flushes the in-flight dispatch first; the streams equal the
    JAX engine's on the same schedule."""
    prompts = _prompts(5, lens=(9, 6, 30, 14, 3))
    sched = dict(SCHED, mixed_batching=True, mixed_token_budget=16, max_num_seqs=8)
    plist = [dict(max_tokens=10, temperature=0.0, ignore_eos=True)] * len(prompts)

    def staggered(eng, sp_cls):
        rids = [eng.add_request(prompt_token_ids=p, params=sp_cls(**sp))
                for p, sp in zip(prompts[:2], plist)]
        for _ in range(3):
            eng.step()
        rids += [eng.add_request(prompt_token_ids=p, params=sp_cls(**sp))
                 for p, sp in zip(prompts[2:], plist)]
        while eng.has_work():
            eng.step()
        return [eng.requests[r].output_token_ids for r in rids]

    eng = _port(model, sched=sched, multi_step=multi_step, pipeline_decode=True)
    ours = staggered(eng, SamplingParams)
    ref = staggered(_jax(model, sched=sched, multi_step=multi_step), jax_rt.SamplingParams)
    sync = staggered(_port(model, sched=sched, multi_step=multi_step), SamplingParams)
    assert ours == ref == sync
    assert eng.stats.num_mixed_steps >= 3
    assert eng.block_manager.num_seqs() == 0


def test_the_decode_executables_hold_the_requests_keys(model):
    """A window's packed state, as the executable reads it: each row's
    position, length, salt and step, and padding rows inactive."""
    eng = _port(model, multi_step=4)
    rid = eng.add_request(prompt_token_ids=[9, 8, 7],
                          params=SamplingParams(max_tokens=20, temperature=0.5, seed=77))
    eng.step()
    eng.step()
    exe = eng.graphs.executables[("decode", 2, "temperature")]
    st = exe.state
    n = eng.requests[rid].num_tokens
    assert st.positions.tolist() == [n - 1, 4]            # advanced by the window
    assert st.seq_lens.tolist() == [n, 5]
    assert st.active.tolist() == [1, 0]
    assert st.salt.tolist()[0] == 77 and st.step.tolist()[0] == 5
    assert st.col.tolist() == [4]


# ---- the static-state step against the JAX decode ---------------------------

BS, NB, MB = 4, 16, 8


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_state_step_run_s_times_equals_jax_decode(model, cache_dtype):
    """The step the graphs replay, run S times over one state: each
    iteration's logits equal the JAX ``decode_step`` on the same chain
    (atol 1e-4) and the tokens equal the JAX ``decode_multi``'s exactly,
    padding rows included in the batch."""
    jcfg, jparams, cfg, params = model
    jcc = jax_kv.CacheConfig(block_size=BS, num_blocks=NB, max_blocks_per_seq=MB,
                             dtype=cache_dtype)
    cc = kv_cache.CacheConfig(block_size=BS, num_blocks=NB, max_blocks_per_seq=MB,
                              dtype=cache_dtype)
    jcache = jax_kv.create_kv_cache(jcfg, jcc)
    cache = kv_cache.create_kv_cache(cfg, cc, "cpu")
    rng = np.random.default_rng(6)
    lens = np.array([13, 6], np.int32)
    bt = np.arange(2 * MB, dtype=np.int32).reshape(2, MB)
    T = 16
    tokens = rng.integers(3, cfg.vocab_size, (2, T)).astype(np.int32)
    slot_ids = np.full((2, T), PAD_SLOT, np.int32)
    for b, n in enumerate(lens):
        t = np.arange(n)
        slot_ids[b, :n] = bt[b, t // BS] * BS + t % BS
    jl, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens),
                                jnp.asarray(slot_ids), jcache)
    transformer.prefill(params, cfg, torch.from_numpy(tokens), torch.from_numpy(lens),
                        torch.from_numpy(slot_ids), cache)
    B, S = 4, 5                                   # 2 real rows, 2 padding
    first = np.zeros(B, np.int32)
    first[:2] = np.asarray(jl).argmax(-1)
    pos = np.zeros(B, np.int32)
    pos[:2] = lens
    seq = np.ones(B, np.int32)
    seq[:2] = lens + 1
    active = np.array([True, True, False, False])
    bts = np.zeros((B, MB), np.int32)
    bts[:2] = bt
    jt, _ = jax_tf.decode_multi(jparams, jcfg, jnp.asarray(first), jnp.asarray(pos),
                                jnp.asarray(bts), jnp.asarray(seq), jnp.asarray(active),
                                jnp.zeros((B, 2), jnp.uint32), jnp.zeros((B,)),
                                jax.tree.map(jnp.copy, jcache), steps=S, mode="greedy")
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)          # noqa: E731
    state = transformer.DecodeState(
        tokens=i32(first), positions=i32(pos), seq_lens=i32(seq), active=i32(active),
        salt=i32(np.zeros(B)), step=i32(np.zeros(B)), temperature=torch.zeros(B),
        block_tables=i32(bts), out=torch.zeros((B, S), dtype=torch.int32),
        col=i32([0]))
    toks, jc = first.copy(), jcache
    for s in range(S):
        slot = np.full(B, PAD_SLOT, np.int32)
        slot[:2] = bts[np.arange(2), (pos[:2] + s) // BS] * BS + (pos[:2] + s) % BS
        jlog, jc = jax_tf.decode_step(jparams, jcfg, jnp.asarray(toks),
                                      jnp.asarray(pos + s), jnp.asarray(slot),
                                      jnp.asarray(bts), jnp.asarray(seq + s), jc)
        logits = transformer.decode_state_step(params, cfg, state, cache)
        np.testing.assert_allclose(logits.numpy()[:2], np.asarray(jlog)[:2], atol=ATOL,
                                   rtol=0)
        toks = np.asarray(jlog).argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(state.out.numpy()[:2], np.asarray(jt)[:2])
    assert state.col.tolist() == [S]
    assert state.positions.tolist()[:2] == (pos[:2] + S).tolist()
    for li in range(cfg.num_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[li][key].float().numpy(),
                                       np.asarray(jc[li][key]).astype(np.float32),
                                       atol=ATOL if cache_dtype == "float32" else 1.0,
                                       rtol=0)


def test_decode_multi_is_the_state_step_run_s_times(model):
    """``decode_multi`` and a state advanced by ``decode_state_step`` S
    times write the same tokens and the same cache, in both modes."""
    _, _, cfg, params = model
    cc = kv_cache.CacheConfig(block_size=BS, num_blocks=NB, max_blocks_per_seq=MB,
                              dtype="float32")
    B, S = 2, 4
    bt = torch.arange(B * MB, dtype=torch.int32).reshape(B, MB)
    args = (torch.tensor([5, 9], dtype=torch.int32), torch.tensor([0, 0], dtype=torch.int32),
            bt, torch.tensor([1, 1], dtype=torch.int32), torch.tensor([True, True]))
    temp = torch.tensor([0.7, 0.0])
    keys = torch.tensor([[3, 4], [8, 0]], dtype=torch.int64)
    for mode in ("greedy", "temperature"):
        a, b = (kv_cache.create_kv_cache(cfg, cc, "cpu") for _ in range(2))
        toks, _ = transformer.decode_multi(params, cfg, *args, temp, a, steps=S,
                                           mode=mode, keys=keys)
        state = transformer.DecodeState(
            tokens=args[0].clone(), positions=args[1].clone(), seq_lens=args[3].clone(),
            active=args[4].int(), salt=keys[:, 0].int(), step=keys[:, 1].int(),
            temperature=temp.clone(), block_tables=bt.clone(),
            out=torch.zeros((B, S), dtype=torch.int32), col=torch.zeros(1, dtype=torch.int32))
        for _ in range(S):
            transformer.decode_state_step(params, cfg, state, b, mode=mode)
        assert torch.equal(toks, state.out)
        for ea, eb in zip(a, b):
            assert torch.equal(ea["k"], eb["k"]) and torch.equal(ea["v"], eb["v"])


# ---- the KV write that drops padding on the device --------------------------

def _nan_cache(shape, dtype):
    if dtype == "int8":
        return np.random.default_rng(0).integers(-127, 128, shape).astype(np.int8)
    return np.full(shape, np.nan, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("pattern", ["mixed", "all_padding", "out_of_range", "first_padding"])
def test_drop_mode_write_matches_jax(dtype, pattern):
    """Every row written, padding rows placed by ``pad_drop``: the cache
    (and the int8 scales) equal the JAX ``write_kv_entry``'s, on caches
    whose unwritten slots hold NaN (int8: random values)."""
    rng = np.random.default_rng(11)
    shape = (8, 4, 2, 16)
    N = 6
    k = rng.standard_normal((N, 2, 16)).astype(np.float32)
    v = rng.standard_normal((N, 2, 16)).astype(np.float32)
    slots = rng.permutation(32)[:N].astype(np.int32)
    if pattern == "mixed":
        slots[[1, 4]] = PAD_SLOT
    elif pattern == "all_padding":
        slots[:] = PAD_SLOT
    elif pattern == "out_of_range":
        slots[[0, 5]] = [32, 1000]
    else:
        slots[[0, 1]] = PAD_SLOT
    if dtype == "int8":
        kc, vc = _nan_cache(shape, "int8"), _nan_cache(shape, "int8")
        sc = np.full(shape[:3], np.nan, np.float32)
        jentry = {"k": jnp.asarray(kc), "v": jnp.asarray(vc), "ks": jnp.asarray(sc),
                  "vs": jnp.asarray(sc)}
        tentry = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy()),
                  "ks": torch.from_numpy(sc.copy()), "vs": torch.from_numpy(sc.copy())}
    else:
        kc = _nan_cache(shape, "float32")
        jentry = {"k": jnp.asarray(kc), "v": jnp.asarray(kc)}
        tentry = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(kc.copy())}
    ref = jax_attn.write_kv_entry(jentry, jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots))
    drop = attention.pad_drop(torch.from_numpy(slots), 32)
    attention.write_kv_entry(tentry, torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(slots), drop=drop)
    for key in tentry:
        np.testing.assert_array_equal(tentry[key].numpy(), np.asarray(ref[key]))


# ---- keyed sampling noise ---------------------------------------------------

def test_keyed_noise_depends_on_the_key_alone():
    """One (salt, step) gives one row of noise in any batch, at any place
    in it; a change of either word changes the row."""
    V = 300
    salt = torch.tensor([7, 123456789, 0xFFFFFFFF - 3, 7], dtype=torch.int64)
    step = torch.tensor([0, 5, 9, 1], dtype=torch.int64)
    batch = sampling.keyed_gumbel(salt, step, V)
    for i in range(4):
        alone = sampling.keyed_gumbel(salt[i:i + 1], step[i:i + 1], V)
        assert torch.equal(alone[0], batch[i])
    moved = sampling.keyed_gumbel(salt.flip(0), step.flip(0), V)
    assert torch.equal(moved, batch.flip(0))
    as_int32 = sampling.keyed_gumbel(salt.to(torch.int32), step.to(torch.int32), V)
    assert torch.equal(as_int32, batch)
    assert not torch.equal(batch[0], batch[3])
    assert torch.isfinite(batch).all()
    u = torch.exp(-torch.exp(-sampling.keyed_gumbel(
        torch.arange(32), torch.zeros(32, dtype=torch.int64), 4096)))
    assert abs(u.mean().item() - 0.5) < 0.01 and abs(u.std().item() - 12 ** -0.5) < 0.01


SEEDED = dict(max_tokens=13, temperature=0.9, seed=21, ignore_eos=True)


@pytest.mark.parametrize("multi_step,pipeline", [(1, True), (4, False), (4, True)])
def test_seeded_streams_do_not_depend_on_windows_pipelining_or_batch(model, multi_step,
                                                                     pipeline):
    """A seeded temperature stream served alone with per-token steps is the
    same stream in windows of 4, with pipelining, and beside other
    requests (greedy and sampled) at another batch position."""
    prompt = _prompts()[1]
    alone = _drain(_port(model, multi_step=1, pipeline_decode=False), SamplingParams,
                   [prompt], [SEEDED])[0]
    others = _prompts(8, lens=(5, 11, 3))
    plist = [dict(max_tokens=13, temperature=0.0), dict(max_tokens=9, temperature=1.0),
             SEEDED, dict(max_tokens=13, temperature=0.5, seed=3)]
    batch = _drain(_port(model, multi_step=multi_step, pipeline_decode=pipeline),
                   SamplingParams, others[:2] + [prompt] + others[2:], plist)
    assert batch[2].output_token_ids == alone.output_token_ids
    assert len(alone.output_token_ids) == 13


def test_different_seeds_give_different_streams(model):
    prompt = _prompts()[0]
    runs = [_drain(_port(model, multi_step=4, pipeline_decode=True), SamplingParams,
                   [prompt], [dict(SEEDED, seed=s)])[0].output_token_ids for s in (1, 2, 1)]
    assert runs[0] == runs[2] != runs[1]


# ---- Engine.warmup and the executables ---------------------------------------

def test_warmup_makes_the_decode_ladder_and_leaves_the_cache(model):
    """The default ladder is min_decode_bucket .. the bucket max_num_seqs
    pads to, in the JAX warmup's variants (every sampling mode, each
    without extras, with logprobs and with penalties), beside the prefill, chunk and mixed buckets
    given; their dispatches of padding write nothing, and serving
    afterwards is unchanged."""
    eng = _port(model, multi_step=4, sched=dict(SCHED, max_num_seqs=6))
    before = [{k: t.clone() for k, t in e.items()} for e in eng.kv_cache]
    eng.warmup(prefill_buckets=[8, (2, 16)], chunk_buckets=[8], mixed_buckets=[16, 32])
    assert sorted(eng.graphs.executables) == sorted(
        [("decode", B, m) + x for B in (2, 4, 8) for m in ("greedy", "temperature", "full")
         for x in ((), ("logprobs",), ("penalties",))]
        + [("prefill", 1, 8), ("prefill", 2, 16), ("chunk", 8), ("mixed", 16),
           ("mixed", 32)])
    for e, b in zip(eng.kv_cache, before):
        for k in e:
            assert torch.equal(e[k], b[k])
    assert eng.block_manager.num_seqs() == 0 and not eng.has_work()
    ours = eng.generate(_prompts(), SamplingParams(**GREEDY))
    cold = _port(model, multi_step=4, sched=dict(SCHED, max_num_seqs=6)).generate(
        _prompts(), SamplingParams(**GREEDY))
    assert _summary(ours) == _summary(cold)


def test_a_bucket_is_made_on_first_use(model):
    eng = _port(model, multi_step=4)
    assert not eng.graphs.executables
    eng.generate(_prompts(lens=(5, 6, 7)), SamplingParams(**GREEDY))
    assert list(eng.graphs.executables) == [("prefill", 4, 8), ("decode", 4, "greedy")]


def test_graphs_need_a_card(model):
    with pytest.raises(ValueError, match="cuda"):
        _port(model, cuda_graphs=True)
    _, _, cfg, params = model
    with pytest.raises(ValueError, match="CUDA device"):
        StepGraphs(params, cfg, [], device=torch.device("cpu"), attn_impl="reference",
                     max_blocks=4, steps=1, max_batch=2, capture=True)


def test_pipeline_and_graph_defaults_are_keyed_on_the_device():
    conf = port_rt.EngineConfig()
    assert conf.resolve_pipeline_decode(torch.device("cuda"))
    assert not conf.resolve_pipeline_decode(torch.device("cpu"))
    assert port_rt.EngineConfig(pipeline_decode=True).resolve_pipeline_decode(
        torch.device("cpu"))
    assert conf.resolve_cuda_graphs(torch.device("cuda"))
    assert not conf.resolve_cuda_graphs(torch.device("cpu"))
    assert not port_rt.EngineConfig(cuda_graphs=False).resolve_cuda_graphs(
        torch.device("cuda"))


class _NoHostReads(torch.utils._python_dispatch.TorchDispatchMode):
    """Raises on the ops that read a tensor back to the host (``.item()``,
    ``nonzero``, boolean masks): on the card each would block the host and
    refuse CUDA graph capture."""
    READS = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
             torch.ops.aten.masked_select.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            raise AssertionError(f"host read in the decode path: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("mode", ["greedy", "temperature"])
def test_the_decode_step_reads_nothing_back(model, mode, cache_dtype):
    """The step the graphs capture, the load that chains a dispatch to the
    one in flight, and the KV write run without one host read (the
    kernel wrappers' path: attn_impl "cuda" runs their plain versions
    here)."""
    _, _, cfg, params = model
    cc = kv_cache.CacheConfig(block_size=BS, num_blocks=NB, max_blocks_per_seq=MB,
                              dtype=cache_dtype)
    cache = kv_cache.create_kv_cache(cfg, cc, "cpu")
    graphs = StepGraphs(params, cfg, cache, device=torch.device("cpu"), attn_impl="cuda",
                        max_blocks=MB, steps=3, max_batch=4, capture=False)
    exe = graphs.get("decode", 4, mode)
    st = exe.stage()
    st.tokens[:2], st.positions[:2], st.seq_lens[:2], st.active[:2] = [5, 6], [0, 3], [1, 4], 1
    st.temperature[:2] = [0.0, 0.9]
    st.block_tables[:2] = np.arange(2 * MB).reshape(2, MB)
    with _NoHostReads():
        exe.load(st)
        exe.run(3)
        exe.load(st, chain=(exe, 3))
        exe.run(1)
    assert exe.state.col.tolist() == [1] and exe.state.tokens.tolist()[:2] != [5, 6]


def test_the_guided_step_reads_nothing_back_and_chains_its_states(model):
    """The guided decode executable's step, its grammar load and the load
    that chains a dispatch's FSM states to the one in flight run without a
    host read (the kernel wrappers' path runs their plain versions here);
    chained rows take the in-flight states, fresh rows the staged ones, and
    a grammar already loaded in the bucket is not copied again."""
    _, _, cfg, params = model
    fsm = grammar.fsm_for_spec("json", None, load_tokenizer("tiny-qwen3", cfg.vocab_size),
                               cfg.vocab_size, {1, 2})
    cache = kv_cache.create_kv_cache(cfg, kv_cache.CacheConfig(
        block_size=BS, num_blocks=NB, max_blocks_per_seq=MB, dtype="float32"), "cpu")
    graphs = StepGraphs(params, cfg, cache, device=torch.device("cpu"), attn_impl="cuda",
                        max_blocks=MB, steps=3, max_batch=4, capture=False)
    N, C = 1 << (fsm.num_states - 1).bit_length(), 1 << (fsm.num_classes - 1).bit_length()
    exe = graphs.get("decode", 4, "greedy", "guided", N, C)
    masks = np.zeros((N, fsm.masks.shape[1]), np.int32)
    masks[:fsm.num_states] = fsm.masks.view(np.int32)
    nxt = np.full((N, C), -1, np.int32)
    nxt[:fsm.num_states, :fsm.num_classes] = fsm.class_next
    tables = (torch.from_numpy(masks), torch.from_numpy(fsm.tok_class), torch.from_numpy(nxt))
    st = exe.stage()
    st.tokens[:2], st.positions[:2], st.seq_lens[:2], st.active[:2] = [5, 6], [0, 3], [1, 4], 1
    st.block_tables[:2] = np.arange(2 * MB).reshape(2, MB)
    st.gstate[:2] = [fsm.start, -1]
    with _NoHostReads():
        assert graphs.load_grammar((N, C), fsm, *tables)
        exe.load(st)
        exe.run(3)
        after = exe.state.gstate.clone()
        st.use_host[:2], st.gather[:2] = [0, 1], [0, 0]
        st.gstate[:3] = [fsm.start, fsm.start, fsm.start]
        exe.load(st, chain=(exe, 3))
        assert not graphs.load_grammar((N, C), fsm, *tables)
    s = fsm.start
    for t in exe.state.out[0, :3].tolist():
        s = fsm.advance(s, t)
    assert after[0].item() == s and after[1].item() == -1
    # row 0 chained, row 1 fresh from the host
    assert exe.state.gstate[:3].tolist() == [s, fsm.start, fsm.start]


def test_an_engine_frees_its_executables_without_the_garbage_collector(model):
    """Dropping an engine frees its decode executables at once: a cycle
    would keep another engine's CUDA graphs alive until a collection,
    which on the card may land inside a later capture and invalidate it."""
    import gc
    import weakref
    eng = _port(model, multi_step=4)
    eng.warmup()
    eng.generate(_prompts(lens=(5, 6)), SamplingParams(**GREEDY))
    graphs, exe = weakref.ref(eng.graphs), weakref.ref(eng.graphs.get("decode", 2, "greedy"))
    enabled = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert graphs() is None and exe() is None
    finally:
        if enabled:
            gc.enable()
