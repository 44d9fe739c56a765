"""Speculative decoding in the port against the JAX package: the n-gram
proposer and the accept rules, rejection-sampling acceptance fed JAX's
own noise, the verify passes and the stateless draft on float32 tiny-qwen3
(logits at atol 1e-4, tokens exactly), and the engine's speculative
streams, counters and governor against the JAX engine's.

Both sides run the same parameters (the JAX tree handed over as numpy)
with the reference attention; on CPU tensors the kernel wrappers run the
same plain versions, and ``chip_smoke.py`` phase ``spec`` holds the
kernels (B3 in the verify pass, B1 in the draft) on the card.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import transformer as jax_tf
from tpuserve.models import weights as jax_weights
from tpuserve.ops import sampling as jax_sampling
from tpuserve.runtime import kv_cache as jax_kv
from tpuserve.runtime import spec as jax_spec
from tpuserve_torch.models import transformer
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.ops import sampling
from tpuserve_torch.ops.attention import PAD_SLOT
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig, SamplingParams,
                                    SchedulerConfig, kv_cache, spec)
from tpuserve_torch.runtime.slo import SloConfig


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


# ---------------------------------------------------------------------------
# the proposer and the accept rules
# ---------------------------------------------------------------------------

def _random_histories(seed, n=200):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(rng.integers(0, 40))
        alphabet = int(rng.integers(2, 9))
        out.append([int(t) for t in rng.integers(0, alphabet, L)])
    return out


@pytest.mark.parametrize("kw", [dict(k=4), dict(k=3, max_ngram=2, min_ngram=2),
                                dict(k=5, max_lookback=8)],
                         ids=["default", "bigram", "lookback8"])
def test_ngram_propose_equals_jax_python_and_native(kw):
    kw = dict(dict(max_ngram=3, min_ngram=1, max_lookback=1024), **kw)
    k = kw.pop("k")
    for ids in _random_histories(1):
        ours = spec.ngram_propose(ids, k, **kw)
        assert ours == jax_spec._ngram_propose_py(ids, k, kw["max_ngram"], kw["min_ngram"],
                                                  kw["max_lookback"])
        assert ours == jax_spec.ngram_propose(ids, k, **kw)


def test_accept_rules_equal_jax():
    rng = np.random.default_rng(2)
    for _ in range(300):
        n = int(rng.integers(0, 5))
        draft = [int(t) for t in rng.integers(0, 3, n)]
        pred = rng.integers(0, 3, n + 1)
        acc = rng.integers(0, 2, n).astype(bool)
        assert spec.accept_greedy(draft, pred) == jax_spec.accept_greedy(draft, pred)
        assert (spec.accept_sampled(draft, acc, pred)
                == jax_spec.accept_sampled(draft, acc, pred))


def test_spec_config_defaults_equal_jax():
    assert (dataclasses.asdict(spec.SpecConfig())
            == dataclasses.asdict(jax_spec.SpecConfig()))
    for kw in ({}, {"draft_model": "x"}):
        assert (spec.SpecConfig(**kw).effective_min_acceptance
                == jax_spec.SpecConfig(**kw).effective_min_acceptance)


# ---------------------------------------------------------------------------
# rejection-sampling acceptance
# ---------------------------------------------------------------------------

def _jax_noise(keys, K, V):
    """The (u, gumbel) JAX's spec_accept_sampled draws from ``keys``."""
    keys = jnp.asarray(keys)

    def row_keys(key):
        return jax.vmap(lambda s: jax.random.fold_in(key, s))(jnp.arange(K))
    keys2 = jax.vmap(row_keys)(keys)
    u_keys = jax.vmap(jax.vmap(lambda k: jax.random.fold_in(k, 0)))(keys2)
    g_keys = jax.vmap(jax.vmap(lambda k: jax.random.fold_in(k, 1)))(keys2)
    u = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, ())))(u_keys)
    gumbel = -jnp.log(-jnp.log(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, (V,), jnp.float32, minval=1e-7,
                                     maxval=1.0)))(g_keys)))
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(gumbel))


def _both_accept(logits, draft, chunk, keys, temp, tk, tp, mp=None):
    B, K, V = logits.shape
    ja, jp = jax_sampling.spec_accept_sampled(
        jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(chunk), jnp.asarray(keys),
        jnp.asarray(temp), jnp.asarray(tk), jnp.asarray(tp),
        None if mp is None else jnp.asarray(mp))
    t = torch.from_numpy
    ta, tpred = sampling.spec_accept_sampled(
        t(logits), t(draft), t(chunk), t(keys[:, 0].astype(np.int64)),
        t(keys[:, 1].astype(np.int64)), t(temp), t(tk), t(tp),
        None if mp is None else t(mp), noise=_jax_noise(keys, K, V))
    return (np.asarray(ja), np.asarray(jp)), (ta.numpy(), tpred.numpy())


ACCEPT_CASES = ["temperature", "top_p", "top_k_min_p", "greedy_rows"]


@pytest.mark.parametrize("case", ACCEPT_CASES)
def test_spec_accept_sampled_with_jax_noise_equals_jax(case):
    rng = np.random.default_rng(ACCEPT_CASES.index(case))
    B, K, V = 16, 5, 64
    logits = (rng.normal(size=(B, K, V)) * 2.0).astype(np.float32)
    # drafts: half the argmax (likely accepted), half random
    draft = np.where(rng.random((B, K - 1)) < 0.5, logits[:, :-1].argmax(-1),
                     rng.integers(0, V, (B, K - 1))).astype(np.int32)
    chunk = rng.integers(1, K + 1, B).astype(np.int32)
    for b in range(B):
        draft[b, chunk[b] - 1:] = 0                     # padding past the drafts
    keys = np.stack([rng.integers(0, 2**32, B, dtype=np.uint64),
                     rng.integers(0, 100, B, dtype=np.uint64)], 1).astype(np.uint32)
    temp = np.full(B, 0.8, np.float32)
    tk = np.zeros(B, np.int32)
    tp = np.ones(B, np.float32)
    mp = None
    if case == "top_p":
        tp = np.full(B, 0.7, np.float32)
    elif case == "top_k_min_p":
        tk = np.full(B, 8, np.int32)
        mp = np.full(B, 0.05, np.float32)
    elif case == "greedy_rows":
        temp[::2] = 0.0
    (ja, jp), (ta, tp_) = _both_accept(logits, draft, chunk, keys, temp, tk, tp, mp)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tp_, jp)


def _marginal_inputs(N, V, logits_row, draft_tok, chunk_len, K=2):
    logits = torch.from_numpy(np.tile(logits_row, (N, K, 1)))
    draft = torch.full((N, K - 1), draft_tok, dtype=torch.int32)
    salt = torch.arange(N, dtype=torch.int64)
    step = torch.full((N,), 7, dtype=torch.int64)
    return (logits, draft, torch.full((N,), chunk_len, dtype=torch.int32), salt, step,
            torch.ones(N), torch.zeros(N, dtype=torch.int32))


def test_spec_accept_sampled_marginal_is_target_distribution():
    """The port of the JAX marginal test, on the port's keyed noise: the
    first emitted token follows p̃ and the acceptance rate is p(draft)."""
    rng = np.random.default_rng(0)
    V, N = 8, 4000
    logits_row = rng.normal(size=(V,)).astype(np.float32) * 1.5
    logits, draft, chunk, salt, step, temp, tk = _marginal_inputs(N, V, logits_row, 3, 2)
    accept, pred = sampling.spec_accept_sampled(logits, draft, chunk, salt, step, temp, tk,
                                                torch.ones(N))
    accept = accept.numpy()[:, 0]
    emitted = np.where(accept, 3, pred.numpy()[:, 0])
    p = np.exp(logits_row) / np.exp(logits_row).sum()
    assert abs(accept.mean() - p[3]) < 0.03
    np.testing.assert_allclose(np.bincount(emitted, minlength=V) / N, p, atol=0.03)


def test_spec_accept_sampled_respects_top_p_truncation():
    V, N = 6, 500
    logits_row = np.array([5.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    logits, draft, chunk, salt, step, temp, tk = _marginal_inputs(N, V, logits_row, 4, 2)
    accept, pred = sampling.spec_accept_sampled(logits, draft, chunk, salt, step * 0,
                                                temp, tk, torch.full((N,), 0.5))
    assert not accept.any()
    assert (pred == 0).all()


def test_spec_accept_sampled_padding_keeps_token_zero_mass():
    V, N = 4, 1200
    logits_row = np.array([4.0, 0.0, 0.0, 0.0], np.float32)
    logits, draft, chunk, salt, step, temp, tk = _marginal_inputs(N, V, logits_row, 0, 1)
    _, pred = sampling.spec_accept_sampled(logits, draft, chunk, salt, step * 0 + 1, temp,
                                           tk, torch.ones(N))
    assert (pred.numpy()[:, 0] == 0).mean() > 0.9


def test_keyed_streams_are_independent_and_stream_zero_is_the_decode_noise():
    salt = torch.tensor([3, 3, 9], dtype=torch.int64)
    step = torch.tensor([0, 1, 0], dtype=torch.int64)
    base = sampling.keyed_gumbel(salt, step, 32)
    assert torch.equal(base, sampling.keyed_gumbel(salt, step, 32, stream=0))
    for s in (sampling.SPEC_U_STREAM, sampling.SPEC_G_STREAM):
        other = sampling.keyed_gumbel(salt, step, 32, stream=s)
        assert not torch.equal(other, base)
    u1 = sampling.keyed_uniform(salt, step, 1, sampling.SPEC_U_STREAM)
    assert ((u1 >= 0) & (u1 < 1)).all()


# ---------------------------------------------------------------------------
# the verify passes and the stateless draft against the JAX functions
# ---------------------------------------------------------------------------

BS, NB, MB = 4, 48, 12


class _Pair:
    def __init__(self, jcfg):
        self.jcfg = jcfg
        self.cfg = dataclasses.replace(get_model_config(jcfg.name), dtype="float32")
        self.jparams = jax_weights.init_params(jcfg, seed=5)
        self.params = params_from_numpy(jax.tree.map(np.asarray, self.jparams),
                                        self.cfg, "cpu")
        cc = dict(block_size=BS, num_blocks=NB, max_blocks_per_seq=MB, dtype="float32")
        self.jcache = jax_kv.create_kv_cache(jcfg, jax_kv.CacheConfig(**cc))
        self.cache = kv_cache.create_kv_cache(self.cfg, kv_cache.CacheConfig(**cc), "cpu")
        self.bt = np.arange(4 * MB, dtype=np.int32).reshape(4, MB)

    def slots(self, b, start, n):
        t = np.arange(start, start + n)
        return (self.bt[b, t // BS] * BS + t % BS).astype(np.int32)


@pytest.fixture
def pair(fp32_tiny_qwen3):
    p = _Pair(fp32_tiny_qwen3)
    # prefill three sequences, then a verify window on each (the fourth
    # row is batch padding: ctx 0, chunk 1, PAD_SLOT, zeroed table)
    rng = np.random.default_rng(8)
    lens = np.array([20, 13, 30], np.int32)
    T = 32
    tokens = rng.integers(0, p.cfg.vocab_size, (3, T)).astype(np.int32)
    slot_ids = np.full((3, T), PAD_SLOT, np.int32)
    for b, n in enumerate(lens):
        tokens[b, n:] = 0
        slot_ids[b, :n] = p.slots(b, 0, n)
    t = torch.from_numpy
    _, p.jcache = jax_tf.prefill(p.jparams, p.jcfg, jnp.asarray(tokens), jnp.asarray(lens),
                                 jnp.asarray(slot_ids), p.jcache)
    transformer.prefill(p.params, p.cfg, t(tokens), t(lens), t(slot_ids), p.cache)
    K = 5
    vt = rng.integers(0, p.cfg.vocab_size, (4, K)).astype(np.int32)
    chunk = np.array([5, 3, 1, 1], np.int32)
    ctx = np.array([19, 12, 29, 0], np.int32)
    vs = np.full((4, K), PAD_SLOT, np.int32)
    bt = np.zeros((4, MB), np.int32)
    for b in range(3):
        vt[b, chunk[b]:] = 0
        vs[b] = p.slots(b, int(ctx[b]), K)
        bt[b] = p.bt[b]
    vt[3] = 0
    p.verify = (vt, ctx, chunk, vs, bt)
    return p


def test_decode_verify_matches_jax(pair):
    p = pair
    vt, ctx, chunk, vs, bt = p.verify
    t = torch.from_numpy
    jpred, jcache = jax_tf.decode_verify(p.jparams, p.jcfg, *map(jnp.asarray, p.verify),
                                         p.jcache)
    logits = transformer.verify_logits(p.params, p.cfg, t(vt), t(ctx), t(chunk), t(vs), t(bt),
                                       [dict(e) for e in p.cache])
    pred, cache = transformer.decode_verify(p.params, p.cfg, t(vt), t(ctx), t(chunk), t(vs),
                                            t(bt), p.cache)
    jl = np.asarray(jax_tf._unembed(p.jparams, p.jcfg, jax_tf._chunk_trunk(
        p.jparams, p.jcfg, *map(jnp.asarray, p.verify), jcache)[0]))
    for b in range(3):           # valid rows only: padding rows are unspecified
        n = chunk[b]
        np.testing.assert_allclose(logits[b, :n].numpy(), jl[b, :n], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(pred[b, :n].numpy(), np.asarray(jpred)[b, :n])
    for li in range(p.cfg.num_layers):
        np.testing.assert_allclose(cache[li]["k"].numpy(), np.asarray(jcache[li]["k"]),
                                   atol=ATOL, rtol=0)


def test_decode_verify_sampled_matches_jax(pair):
    p = pair
    vt, ctx, chunk, vs, bt = p.verify
    B, K = vt.shape
    keys = np.stack([np.arange(B) * 7 + 1, np.arange(B) + 3], 1).astype(np.uint32)
    temp = np.array([0.9, 0.0, 1.3, 0.0], np.float32)
    tk = np.array([0, 5, 0, 0], np.int32)
    tp = np.array([0.8, 1.0, 1.0, 1.0], np.float32)
    mp = np.zeros(B, np.float32)
    ja, jp, _ = jax_tf.decode_verify_sampled(
        p.jparams, p.jcfg, *map(jnp.asarray, p.verify), p.jcache, jnp.asarray(keys),
        jnp.asarray(temp), jnp.asarray(tk), jnp.asarray(tp), jnp.asarray(mp))
    t = torch.from_numpy
    ta, tp_, _ = transformer.decode_verify_sampled(
        p.params, p.cfg, t(vt), t(ctx), t(chunk), t(vs), t(bt), p.cache,
        t(keys.astype(np.int64)), t(temp), t(tk), t(tp), t(mp),
        noise=_jax_noise(keys, K, p.cfg.vocab_size))
    ja, jp = np.asarray(ja), np.asarray(jp)
    for b in range(3):
        n = chunk[b]
        np.testing.assert_array_equal(ta[b, :n - 1].numpy(), ja[b, :n - 1])
        np.testing.assert_array_equal(tp_[b, :n].numpy(), jp[b, :n])


def test_draft_propose_matches_jax(pair):
    p = pair
    rng = np.random.default_rng(4)
    W, k = 12, 3
    tokens = np.zeros((4, W + k), np.int32)
    lens = np.array([12, 5, 1, 9], np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(0, p.cfg.vocab_size, n)
    jout = np.asarray(jax_tf.draft_propose(p.jparams, p.jcfg, jnp.asarray(tokens),
                                           jnp.asarray(lens), k=k))
    out = transformer.draft_propose(p.params, p.cfg, torch.from_numpy(tokens),
                                    torch.from_numpy(lens), k=k)
    np.testing.assert_array_equal(out.numpy(), jout)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

CACHE = dict(block_size=4, num_blocks=256, max_blocks_per_seq=32, dtype="float32")
SCHED = dict(max_num_seqs=4)
REPETITIVE = [[1, 2, 3, 4] * 5, [7, 8, 7, 8, 7, 8, 9], [5, 6, 5, 6, 5, 6]]


@pytest.fixture(scope="module")
def model(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _port(model, spec_cfg, identity=False, sched=SCHED, **kw):
    _, _, cfg, params = model
    kw = dict(dict(enable_prefix_caching=False, pipeline_decode=False), **kw)
    conf = EngineConfig(model="tiny-qwen3", cache=CacheConfig(**CACHE),
                        scheduler=SchedulerConfig(**sched), speculative=spec_cfg, **kw)
    eng = Engine(conf, params=params, model_cfg=cfg, device="cpu")
    if identity:
        _identity_draft(eng, params, cfg)
    return eng


def _identity_draft(eng, params, cfg):
    """The target as its own draft, set after construction as the JAX
    engine's tests do (and on the step graphs, which hold the draft)."""
    eng._draft_cfg, eng._draft_params = cfg, params
    eng.graphs.draft_cfg, eng.graphs.draft_params = cfg, params


def _jax(model, spec_cfg, identity=False, sched=SCHED, **kw):
    jcfg, jparams, _, _ = model
    kw = dict(dict(enable_prefix_caching=False, pipeline_decode=False, slo_classes=False,
                   kv_tiers=False, attn_impl="reference"), **kw)
    jspec = None if spec_cfg is None else jax_spec.SpecConfig(**dataclasses.asdict(spec_cfg))
    eng = jax_rt.Engine(jax_rt.EngineConfig(
        model="tiny-qwen3", cache=jax_rt.CacheConfig(**CACHE),
        scheduler=jax_rt.SchedulerConfig(**sched), speculative=jspec, **kw),
        params=jparams, model_cfg=jcfg)
    if identity:
        eng._draft_cfg, eng._draft_params = jcfg, jparams
    return eng


def _stats(eng):
    s = eng.stats
    return (s.spec_steps, s.spec_proposed, s.spec_accepted, s.spec_pauses,
            s.num_decode_steps)


def _gen(eng, prompts, **p):
    mod = jax_rt if isinstance(eng, jax_rt.Engine) else None
    sp = (mod.SamplingParams if mod else SamplingParams)(**p)
    return [(r.output_token_ids, r.finish_reason.value) for r in eng.generate(prompts, sp)]


SPEC_CASES = {
    "ngram_k4": (dict(num_draft_tokens=4), False, REPETITIVE, 12),
    "ngram_k3_random": (dict(num_draft_tokens=3), False, "random", 8),
    "identity_draft": (dict(num_draft_tokens=3, draft_model="tiny-qwen3", adaptive=False),
                       True, [[1, 2, 1, 2, 1, 2], [9, 4, 11, 3]], 10),
    "draft_window_cut": (dict(num_draft_tokens=2, draft_model="tiny-qwen3", draft_window=4,
                              adaptive=False), True, [list(range(3, 15))], 9),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_greedy_streams_and_counters_equal_jax(model, case):
    kw, identity, prompts, n = SPEC_CASES[case]
    if prompts == "random":
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, 200, size=9).tolist() for _ in range(3)]
    sp = dict(max_tokens=n, temperature=0.0, ignore_eos=True)
    port = _port(model, spec.SpecConfig(**kw), identity)
    jeng = _jax(model, spec.SpecConfig(**kw), identity)
    ours, theirs = _gen(port, prompts, **sp), _gen(jeng, prompts, **sp)
    assert ours == theirs
    assert ours == _gen(_port(model, None), prompts, **sp)      # speculation changes nothing
    assert _stats(port) == _stats(jeng)
    if identity:
        assert port.stats.spec_steps > 0
    if identity and "draft_window" not in kw:
        # the identity draft sees the whole context: every draft verifies
        assert port.stats.spec_accepted == port.stats.spec_proposed
    assert port.block_manager.num_seqs() == 0


def test_governor_pauses_at_the_jax_engines_step(model):
    cfg = spec.SpecConfig(num_draft_tokens=4, min_batch_coverage=0.0, min_acceptance=0.9,
                          adaptive_window_proposed=8, adaptive_pause_steps=6)
    prompts = [[1, 2, 3, 4] * 6, [7, 8] * 10]
    sp = dict(max_tokens=24, temperature=0.0, ignore_eos=True)
    port, jeng = _port(model, cfg), _jax(model, cfg)
    assert _gen(port, prompts, **sp) == _gen(jeng, prompts, **sp)
    assert port.stats.spec_pauses >= 1
    assert _stats(port) == _stats(jeng)
    assert port._spec_resume_step == jeng._spec_resume_step
    assert port.stats.num_decode_steps > port.stats.spec_steps


def test_governor_keeps_a_winning_spec_active(model):
    cfg = spec.SpecConfig(num_draft_tokens=2, min_acceptance=0.01,
                          adaptive_window_proposed=4, adaptive_pause_steps=1000)
    port = _port(model, cfg)
    _gen(port, [[1, 2, 3, 4] * 6], max_tokens=16, temperature=0.0, ignore_eos=True)
    assert port.stats.spec_steps > 0 and port.stats.spec_pauses == 0


def test_spec_eos_and_max_tokens_equal_jax(model):
    cfg = spec.SpecConfig(num_draft_tokens=4)
    prompts = [[2, 3, 2, 3, 2, 3], [1, 2, 3, 4] * 5]
    for sp in (dict(max_tokens=5, temperature=0.0), dict(max_tokens=7, temperature=0.0,
                                                         ignore_eos=True)):
        port, jeng = _port(model, cfg), _jax(model, cfg)
        ours = _gen(port, prompts, **sp)
        assert ours == _gen(jeng, prompts, **sp)
        assert all(len(t) <= sp["max_tokens"] for t, _ in ours)
        assert _stats(port) == _stats(jeng)
        assert port.block_manager.num_seqs() == 0


def test_spec_composes_with_pipelined_windows(model):
    cfg = spec.SpecConfig(num_draft_tokens=4)
    prompts = [[1, 2, 3, 4] * 5, [7, 8, 7, 8, 7, 8, 9]]
    sp = dict(max_tokens=12, temperature=0.0, ignore_eos=True)
    port = _port(model, cfg, pipeline_decode=True, multi_step=4)
    ours = _gen(port, prompts, **sp)
    assert ours == _gen(_port(model, None), prompts, **sp)
    assert ours == _gen(_jax(model, cfg, pipeline_decode=True, multi_step=4), prompts, **sp)
    assert port._pending_window is None and port._pending is None
    assert port.stats.spec_steps > 0 and port.block_manager.num_seqs() == 0


def test_spec_gate_skips_rows_with_extras(model):
    """Penalties, logprobs, a bias or a guided spec send the batch down the
    decode path, as in the JAX engine; tokens still equal the JAX engine's."""
    cfg = spec.SpecConfig(num_draft_tokens=4)
    prompts = [[1, 2, 3, 4] * 5]
    for extra in (dict(presence_penalty=0.5), dict(logprobs=2), dict(logit_bias={5: 1.0})):
        sp = dict(max_tokens=8, temperature=0.0, ignore_eos=True, **extra)
        port = _port(model, cfg)
        assert _gen(port, prompts, **sp) == _gen(_jax(model, cfg), prompts, **sp)
        assert port.stats.spec_steps == 0


def test_slo_level_one_pauses_speculation_for_batch_rows(model):
    """The SLO controller's level 1 (batch-class rows under queue pressure)
    runs those dispatches without speculation; the stream is unchanged."""
    cfg = spec.SpecConfig(num_draft_tokens=4)
    prompts = [[1, 2, 3, 4] * 5]
    sp = SamplingParams(max_tokens=10, temperature=0.0, ignore_eos=True, slo_class="batch")
    port = _port(model, cfg, slo_classes=True, slo=SloConfig(hold_s=1e9))
    rid = port.add_request(prompt_token_ids=prompts[0], params=sp)
    port._slo.level = 1
    port._slo._waiting = 10 ** 6                # pressure that never decays
    port._slo._queue_pressure_live = lambda: True
    while port.has_work():
        port.step()
        port._slo.level = 1
    assert port.stats.spec_steps == 0
    toks = port.requests.pop(rid).output_token_ids
    free = _port(model, cfg, slo_classes=True)
    assert toks == free.generate(prompts, sp)[0].output_token_ids
    assert free.stats.spec_steps > 0


def test_sampled_spec_is_seeded_and_tiny_temperature_is_greedy(model):
    cfg = spec.SpecConfig(num_draft_tokens=3, draft_model="tiny-qwen3", adaptive=False)
    prompts = [[1, 2, 1, 2, 1, 2]]
    sp = dict(max_tokens=8, temperature=0.8, seed=3, ignore_eos=True, top_p=0.9)
    a = _port(model, cfg, identity=True)
    ta = _gen(a, prompts, **sp)
    assert ta == _gen(_port(model, cfg, identity=True), prompts, **sp)
    assert len(ta[0][0]) == 8 and a.stats.spec_steps > 0
    assert a.stats.spec_proposed >= a.stats.spec_accepted >= 0
    greedy = _gen(_port(model, spec.SpecConfig(num_draft_tokens=4)), [[1, 2, 3, 4] * 5],
                  max_tokens=10, temperature=0.0, ignore_eos=True)
    near = _port(model, spec.SpecConfig(num_draft_tokens=4))
    assert _gen(near, [[1, 2, 3, 4] * 5], max_tokens=10, temperature=1e-5, seed=1,
                ignore_eos=True) == greedy
    assert near.stats.spec_steps > 0


def test_draft_errors_equal_jax(model, tmp_path):
    _, _, cfg, params = model
    bad = spec.SpecConfig(draft_model="tiny-llama")
    with pytest.raises(ValueError, match="vocab") as ours:
        _port(model, bad)
    if get_model_config("tiny-llama").vocab_size != cfg.vocab_size:
        with pytest.raises(ValueError, match="vocab") as theirs:
            _jax(model, bad)
        assert str(ours.value) == str(theirs.value)
    missing = spec.SpecConfig(draft_model="tiny-qwen3", draft_checkpoint_dir=str(tmp_path))
    assert not glob.glob(os.path.join(tmp_path, "*.safetensors"))
    with pytest.raises(ValueError, match="safetensors") as ours:
        _port(model, missing)
    with pytest.raises(ValueError, match="safetensors") as theirs:
        _jax(model, missing)
    assert str(ours.value) == str(theirs.value)


def test_spec_executables_are_listed_only_with_speculation(model):
    plain = _port(model, None)
    sched = plain.scheduler.cfg
    assert not [k for k in plain._step_keys(sched, 64) if k[0] in ("verify", "draft")]
    eng = _port(model, spec.SpecConfig(num_draft_tokens=3, draft_model="tiny-qwen3"),
                identity=True)
    keys = eng._step_keys(sched, 64)
    assert {k for k in keys if k[0] == "verify"} == {
        ("verify", B, 4, m) for B in eng._decode_ladder() for m in ("greedy", "sampled")}
    assert {k for k in keys if k[0] == "draft"} == {("draft", B, 67, 3) for B in (1, 2, 4)}
    eng.warmup(sample_modes=("greedy",))
    made = set(eng.graphs.executables)
    assert {("verify", B, 4, "greedy") for B in eng._decode_ladder()} <= made
    assert not any(k[0] == "verify" and k[3] == "sampled" for k in made)
    plain.warmup()
    assert not any(k[0] in ("verify", "draft") for k in plain.graphs.executables)
