"""The port's full sampler on the CPU, against the JAX package's.

Ops, float32: the full mode (top-k, top-p, min-p, their mixes, rows at
temperature 0, tied logits) fed the JAX sampler's own noise gives the JAX
``sample_tokens(mode="full")`` tokens exactly; the truncation, counts,
penalties and bias equal the JAX ops' within atol 1e-6, and logprobs
within atol 1e-5 with equal ids.  Model: a decode window carrying the
extras (the count carry, the bias, a floor lifted mid-window) and
logprobs gives the JAX ``decode_multi``'s tokens exactly and its logprobs
within atol 1e-4.  Engine: greedy streams with each extra equal
``tpuserve.runtime.Engine``'s token for token (texts and finish reasons
too; logprobs within atol 1e-4, top ids equal) on pipelined windows,
pipelined single steps and mixed steps, and the staleness flushes of the
penalties and the floor land where the JAX engine's do.  Sampled streams
cannot match across the two packages (their noise differs: ROADMAP.md C),
so sampled requests are held to the port's own single steps.
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
from tpuserve.ops import sampling as jax_sampling
from tpuserve.runtime import kv_cache as jax_kv
from tpuserve.runtime.clock import VirtualClock as JaxVirtualClock
from tpuserve_torch import runtime as port_rt
from tpuserve_torch.models import transformer
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.ops import sampling
from tpuserve_torch.ops.attention import PAD_SLOT
from tpuserve_torch.runtime import Engine, SamplingParams, kv_cache
from tpuserve_torch.runtime.clock import VirtualClock


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- ops --------------------------------------------------------------------

B, V = 8, 300
FULL_CASES = {
    "top_k": dict(top_k=[1, 5, 50, 0, 300, 2, 7, -1]),
    "top_p": dict(top_p=[0.9, 0.5, 0.1, 1.0, 0.99, 0.3, 0.75, 0.0]),
    "min_p": dict(min_p=[0.1, 0.5, 0.0, 1.0, 0.05, 0.9, 0.2, 0.01]),
    "mixed": dict(top_k=[3, 0, 40, 1, 0, 12, 0, 100],
                  top_p=[0.8, 0.95, 1.0, 0.5, 0.2, 1.0, 0.6, 0.9],
                  min_p=[0.0, 0.1, 0.3, 0.0, 0.0, 0.05, 0.5, 0.02]),
    "greedy_rows": dict(top_k=[5] * 8, top_p=[0.9] * 8,
                        temperature=[0.0, 0.7, 0.0, 1.3, 0.0, 2.0, 0.0, 0.9]),
    # logits on a coarse grid: many ties, sorted in index order by both
    "ties": dict(top_k=[4, 20, 0, 9, 1, 0, 60, 2],
                 top_p=[0.7, 1.0, 0.4, 0.95, 1.0, 0.8, 0.99, 0.5], grid=True),
}


def _full_inputs(case, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    if case.get("grid"):
        logits = np.round(logits).astype(np.float32)
    temp = np.asarray(case.get("temperature", [0.7, 1.0, 0.5, 1.3, 0.9, 2.0, 0.6, 1.1]),
                      np.float32)
    top_k = np.asarray(case.get("top_k", [0] * B), np.int32)
    top_p = np.asarray(case.get("top_p", [1.0] * B), np.float32)
    min_p = np.asarray(case.get("min_p", [0.0] * B), np.float32)
    keys = rng.integers(0, 2**31, (B, 2)).astype(np.uint32)
    return logits, temp, top_k, top_p, min_p, keys


@pytest.mark.parametrize("name", list(FULL_CASES))
def test_full_mode_matches_jax_with_same_noise(name):
    """Exact tokens: the JAX sampler's own Gumbel noise fed to the port."""
    logits, temp, top_k, top_p, min_p, keys = _full_inputs(FULL_CASES[name], 21)
    ref = jax_sampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), min_p=jnp.asarray(min_p), mode="full")
    noise = np.asarray(jax_sampling._row_gumbel(jnp.asarray(keys), (B, V)))
    out = sampling.sample_tokens(_t(logits), _t(temp), mode="full", gumbel=_t(noise),
                                 top_k=_t(top_k), top_p=_t(top_p), min_p=_t(min_p))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # the noise may also come from a function, drawn after the sort
    lazy = sampling.sample_tokens(_t(logits), _t(temp), mode="full",
                                  gumbel=lambda: _t(noise), top_k=_t(top_k),
                                  top_p=_t(top_p), min_p=_t(min_p))
    assert torch.equal(lazy, out)


def _borderline(scaled, top_p):
    """Sorted positions where the probability before the token lies within
    1e-5 of ``top_p``: there the kept set depends on the float order of the
    cumsum, which XLA and torch sum differently (with top_p 1.0, deep in
    the tail, where the probability is ~1e-7)."""
    probs = np.asarray(jax.nn.softmax(-np.sort(-scaled, axis=-1), axis=-1), np.float64)
    before = np.cumsum(probs, axis=-1) - probs
    return np.abs(before - top_p[:, None]) < 1e-5


@pytest.mark.parametrize("name", list(FULL_CASES))
def test_truncation_matches_jax(name):
    """The sort's ids equal the JAX ops' (ties in index order); the masked
    sorted logits and the vocabulary-order form equal them within atol
    1e-6 wherever the kept set is not decided by the cumsum's rounding
    (:func:`_borderline`; the full-mode tokens above are exact)."""
    logits, temp, top_k, top_p, min_p, _ = _full_inputs(FULL_CASES[name], 22)
    scaled = logits / np.maximum(temp, 1e-6)[:, None]
    ref_vals, ref_idx = jax_sampling.truncated_sorted_logits(
        jnp.asarray(scaled), jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(min_p))
    vals, idx = sampling.truncated_sorted_logits(_t(scaled), _t(top_k), _t(top_p), _t(min_p))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    edge = _borderline(scaled, top_p)
    np.testing.assert_allclose(vals.numpy()[~edge], np.asarray(ref_vals)[~edge], atol=1e-6,
                               rtol=0)
    assert (~edge).mean() > 0.75
    ref_unsorted = np.asarray(jax_sampling.truncated_scaled_logits(
        jnp.asarray(scaled), jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(min_p)))
    edge_vocab = np.zeros_like(edge)
    np.put_along_axis(edge_vocab, np.asarray(ref_idx), edge, axis=1)
    np.testing.assert_allclose(
        sampling.truncated_scaled_logits(_t(scaled), _t(top_k), _t(top_p),
                                         _t(min_p)).numpy()[~edge_vocab],
        ref_unsorted[~edge_vocab], atol=1e-6, rtol=0)


def test_min_p_out_of_range_keeps_the_most_likely_token():
    """NaN and values above 1 are clamped, so the top token survives."""
    logits = np.random.default_rng(3).standard_normal((3, 40)).astype(np.float32)
    min_p = np.array([np.nan, 5.0, -1.0], np.float32)
    vals, idx = sampling.truncated_sorted_logits(_t(logits), _t(np.zeros(3, np.int32)),
                                                 _t(np.ones(3, np.float32)), _t(min_p))
    ref_vals, _ = jax_sampling.truncated_sorted_logits(
        jnp.asarray(logits), jnp.zeros(3, jnp.int32), jnp.ones(3), jnp.asarray(min_p))
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals), atol=1e-6, rtol=0)
    assert (vals[:, 0] > sampling.NEG_INF).all()


def _history(seed, T=12):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (B, T)).astype(np.int32)
    tokens[:, :3] = tokens[:, 3:6]                     # repeats: counts above 1
    tokens[0, -2:] = [V, V + 7]                         # padding ids past the vocabulary
    mask = rng.random((B, T)) < 0.8
    mask[1] = False                                     # a row with no history
    return tokens, mask


def test_counts_and_penalties_match_jax():
    rng = np.random.default_rng(23)
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    tokens, mask = _history(24)
    presence = rng.uniform(-1, 2, B).astype(np.float32)
    frequency = rng.uniform(-1, 2, B).astype(np.float32)
    repetition = rng.uniform(0.5, 2.0, B).astype(np.float32)
    ref_counts = jax_sampling.token_counts(jnp.asarray(tokens), jnp.asarray(mask), V)
    counts = sampling.token_counts(_t(tokens), _t(mask), V)
    np.testing.assert_allclose(counts.numpy(), np.asarray(ref_counts), atol=1e-6, rtol=0)
    assert counts[1].sum() == 0 and counts.max() > 1
    ref = jax_sampling.apply_logit_penalties(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(presence),
        jnp.asarray(frequency), jnp.asarray(repetition))
    out = sampling.apply_logit_penalties(_t(logits), _t(tokens), _t(mask), _t(presence),
                                         _t(frequency), _t(repetition))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    ref2 = jax_sampling.penalize_from_counts(jnp.asarray(logits), ref_counts,
                                             jnp.asarray(presence), jnp.asarray(frequency),
                                             jnp.asarray(repetition))
    out2 = sampling.penalize_from_counts(_t(logits), counts, _t(presence), _t(frequency),
                                         _t(repetition))
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref2), atol=1e-6, rtol=0)


def test_logit_bias_matches_jax():
    rng = np.random.default_rng(25)
    logits = rng.standard_normal((B, V)).astype(np.float32)
    ids = rng.integers(0, V, (B, 4)).astype(np.int32)
    ids[:, 3] = V                                       # padding, dropped
    ids[2, 1] = V + 100
    vals = rng.uniform(-100, 100, (B, 4)).astype(np.float32)
    ref = jax_sampling.apply_logit_bias(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(vals))
    out = sampling.apply_logit_bias(_t(logits), _t(ids), _t(vals))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("top_n", [1, 5, 20])
def test_compute_logprobs_matches_jax(top_n):
    rng = np.random.default_rng(26)
    logits = rng.standard_normal((B, V)).astype(np.float32) * 4
    chosen = rng.integers(0, V, B).astype(np.int32)
    r_lp, r_ids, r_top = jax_sampling.compute_logprobs(jnp.asarray(logits), jnp.asarray(chosen),
                                                       top_n)
    lp, ids, top = sampling.compute_logprobs(_t(logits), _t(chosen), top_n)
    np.testing.assert_allclose(lp.numpy(), np.asarray(r_lp), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    np.testing.assert_allclose(top.numpy(), np.asarray(r_top), atol=1e-5, rtol=0)
    assert ids.dtype == torch.int32 and (np.diff(top.numpy(), axis=1) <= 0).all()


# ---- the decode window with its extras against the JAX decode_multi --------

@pytest.fixture(scope="module")
def model(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


BS, NB, MB = 4, 16, 8


def _prefilled(model):
    """Two sequences of 13 and 6 tokens prefilled in both packages' caches:
    (JAX cache, port cache, first decode tokens, positions, block tables)."""
    jcfg, jparams, cfg, params = model
    jcache = jax_kv.create_kv_cache(jcfg, jax_kv.CacheConfig(
        block_size=BS, num_blocks=NB, max_blocks_per_seq=MB, dtype="float32"))
    cache = kv_cache.create_kv_cache(cfg, kv_cache.CacheConfig(
        block_size=BS, num_blocks=NB, max_blocks_per_seq=MB, dtype="float32"), "cpu")
    rng = np.random.default_rng(6)
    lens = np.array([13, 6], np.int32)
    bt = np.arange(2 * MB, dtype=np.int32).reshape(2, MB)
    tokens = rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32)
    slot_ids = np.full((2, 16), PAD_SLOT, np.int32)
    for b, n in enumerate(lens):
        t = np.arange(n)
        slot_ids[b, :n] = bt[b, t // BS] * BS + t % BS
    jl, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens),
                                jnp.asarray(slot_ids), jcache)
    transformer.prefill(params, cfg, _t(tokens), _t(lens), _t(slot_ids), cache)
    return jcache, cache, np.asarray(jl).argmax(-1).astype(np.int32), lens, bt


@pytest.mark.parametrize("mode", ["greedy", "full"])
def test_window_extras_and_logprobs_match_jax_decode_multi(model, mode):
    """A 6-step window with the count carry (from a history), presence,
    frequency and repetition penalties, a dense bias and a floor lifted
    after 3 steps on one row, and 5 logprobs a step: tokens equal to the
    JAX ``decode_multi``'s, logprobs within atol 1e-4 and ids equal.  The
    full mode runs top_k 1 at temperature 0.8, which must give the same
    tokens through the sort."""
    jcfg, jparams, cfg, params = model
    jcache, cache, first, lens, bt = _prefilled(model)
    S, Vm = 6, cfg.vocab_size
    rng = np.random.default_rng(7)
    hist = rng.integers(0, Vm, (2, 8)).astype(np.int32)
    counts = np.asarray(jax_sampling.token_counts(jnp.asarray(hist), jnp.ones((2, 8), bool), Vm))
    bias = np.zeros((2, Vm), np.float32)
    bias[0, rng.integers(0, Vm, 5)] = 4.0
    floor = np.zeros((2, Vm), np.float32)
    floor[:, first] = -1e9                              # the floor bars each row's argmax
    kw = dict(presence=np.array([0.5, 0.0], np.float32),
              frequency=np.array([0.3, 1.0], np.float32),
              repetition=np.array([1.3, 1.1], np.float32),
              floor_remaining=np.array([3, 0], np.int32))
    temp = np.array([0.8, 0.8] if mode == "full" else [0.0, 0.0], np.float32)
    top = dict(top_k=np.array([1, 1], np.int32), top_p=np.ones(2, np.float32),
               min_p=np.zeros(2, np.float32)) if mode == "full" else {}
    args = (first, lens, bt, lens + 1, np.ones(2, bool))
    jt, _, (jc, ji, jv) = jax_tf.decode_multi(
        jparams, jcfg, *map(jnp.asarray, args), jnp.asarray([[9, 0], [4, 0]], jnp.uint32),
        jnp.asarray(temp), jcache, steps=S, mode=mode, logprobs_n=5,
        counts=jnp.asarray(counts), bias=jnp.asarray(bias), floor_bias=jnp.asarray(floor),
        **{k: jnp.asarray(v) for k, v in {**kw, **top}.items()})
    out, _, (c, i, v) = transformer.decode_multi(
        params, cfg, *map(_t, args), _t(temp), cache, steps=S, mode=mode,
        keys=torch.tensor([[9, 0], [4, 0]]), logprobs_n=5, counts=_t(counts), bias=_t(bias),
        floor_bias=_t(floor), **{k: _t(v) for k, v in {**kw, **top}.items()})
    np.testing.assert_array_equal(out.numpy(), np.asarray(jt))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4, rtol=0)
    assert out.shape == (2, S) and c.shape == (2, S) and i.shape == v.shape == (2, S, 5)
    # the floor held the first 3 steps of row 0 off its barred tokens
    assert first[0] not in out[0, :3].tolist()


def test_window_without_extras_returns_tokens_and_cache(model):
    """Without logprobs ``decode_multi`` returns (tokens, cache), as the
    JAX one; an unknown mode is refused."""
    _, _, cfg, params = model
    _, cache, first, lens, bt = _prefilled(model)
    res = transformer.decode_multi(params, cfg, _t(first), _t(lens), _t(bt), _t(lens + 1),
                                   torch.ones(2, dtype=torch.bool), torch.zeros(2), cache,
                                   steps=2)
    assert len(res) == 2 and res[0].shape == (2, 2)
    with pytest.raises(ValueError, match="mode"):
        transformer.decode_multi(params, cfg, _t(first), _t(lens), _t(bt), _t(lens + 1),
                                 torch.ones(2, dtype=torch.bool), torch.zeros(2), cache,
                                 steps=1, mode="beam")


# ---- the engine against the JAX engine ---------------------------------------

CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=24, dtype="float32")
SCHED = dict(max_num_seqs=8, max_prefill_tokens=256, min_prefill_bucket=8,
             min_decode_bucket=2)
PATHS = {
    "windows": dict(multi_step=4, pipeline_decode=True),
    "single": dict(multi_step=1, pipeline_decode=True),
    "mixed": dict(multi_step=4, pipeline_decode=True,
                  sched=dict(mixed_batching=True, mixed_token_budget=16)),
}
EOS = 2                       # the byte tokenizer's EOS (the model's is 1)
A = 97 + 3                    # the byte tokenizer's id of "a"
OPTIONS = {
    "presence": dict(presence_penalty=1.5),
    "frequency": dict(frequency_penalty=0.7),
    "repetition": dict(repetition_penalty=1.3),
    "logit_bias": dict(logit_bias={EOS: 6.0, 40: 3.0, 41: -50.0}),
    "min_tokens": dict(logit_bias={EOS: 100.0}, min_tokens=5),
    "min_tokens_stop": dict(logit_bias={A: 100.0}, min_tokens=3, stop=("a",)),
    "logprobs": dict(logprobs=5),
    "top_k_1": dict(temperature=0.8, top_k=1, seed=5),
    "min_p_1": dict(temperature=0.8, min_p=1.0, seed=6),
    "all": dict(presence_penalty=0.5, repetition_penalty=1.2, logit_bias={EOS: 100.0},
                min_tokens=4, logprobs=3),
}
PROMPTS = [[73, 135, 115, 53, 66, 144, 120, 102, 69, 152, 80, 67],
           [168, 164, 61, 118, 176, 96, 180], [148, 42, 40],
           [196, 82, 87, 174, 167, 27, 5, 173, 9, 10, 11]]


def _params(extra):
    """The first and last prompts plain greedy, the middle two with the
    option set: the extras rows share their batches with neutral rows."""
    opt = dict(dict(max_tokens=12, temperature=0.0), **extra)
    plain = dict(max_tokens=12, temperature=0.0)
    return [plain, opt, opt, plain]


def _port(model, sched=None, **kw):
    _, _, cfg, params = model
    conf = port_rt.EngineConfig(model="tiny-qwen3", cache=port_rt.CacheConfig(**CACHE),
                                scheduler=port_rt.SchedulerConfig(**dict(SCHED, **(sched or {}))),
                                **kw)
    return Engine(conf, params=params, model_cfg=cfg, device="cpu")


def _jax(model, **kw):
    jcfg, jparams, _, _ = model
    conf = jax_rt.EngineConfig(
        model="tiny-qwen3", cache=jax_rt.CacheConfig(**CACHE),
        scheduler=jax_rt.SchedulerConfig(allow_chunked_prefill=False, **SCHED),
        attn_impl="reference", kv_tiers=False, slo_classes=False, **kw)
    return jax_rt.Engine(conf, params=jparams, model_cfg=jcfg)


@pytest.fixture(scope="module")
def jax_runs(model):
    """The JAX engine's requests a option set, made once (single steps,
    synchronous: greedy streams do not depend on the path)."""
    done = {}

    def run(name):
        if name not in done:
            done[name] = _jax(model, multi_step=1).generate(
                PROMPTS, [jax_rt.SamplingParams(**p) for p in _params(OPTIONS[name])])
        return done[name]
    return run


def _assert_same(ours, ref):
    for o, r in zip(ours, ref):
        assert (o.output_token_ids, o.output_text, o.finish_reason.value) == (
            r.output_token_ids, r.output_text, r.finish_reason.value)
        assert len(o.logprobs) == len(r.logprobs)
        for a, b in zip(o.logprobs, r.logprobs):
            assert a["token_id"] == b["token_id"]
            assert abs(a["logprob"] - b["logprob"]) <= 1e-4
            assert [t for t, _ in a["top"]] == [t for t, _ in b["top"]]
            np.testing.assert_allclose([lp for _, lp in a["top"]],
                                       [lp for _, lp in b["top"]], atol=1e-4, rtol=0)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", list(OPTIONS))
def test_greedy_streams_with_each_extra_match_jax_engine(model, jax_runs, name, path):
    kw = dict(PATHS[path])
    eng = _port(model, kw.pop("sched", None), **kw)
    ours = eng.generate(PROMPTS, [SamplingParams(**p) for p in _params(OPTIONS[name])])
    ref = jax_runs(name)
    _assert_same(ours, ref)
    st = eng.stats
    assert {"windows": st.num_decode_windows > 0, "single": st.num_decode_windows == 0,
            "mixed": st.num_mixed_steps > 2}[path]
    if name == "logprobs":
        assert [len(r.logprobs) for r in ours] == [0, len(ours[1].output_token_ids),
                                                     len(ours[2].output_token_ids), 0]
        assert all(len(e["top"]) == 5 for e in ours[1].logprobs)
    if name in ("min_tokens", "all"):
        floor = OPTIONS[name]["min_tokens"]
        # the floor holds EOS off, then the bias ends the stream with it
        assert [r.output_token_ids.index(EOS) for r in ours[1:3]] == [floor, floor]
        assert all(r.finish_reason.value == "stop" for r in ours[1:3])
    if name == "min_tokens_stop":
        # the stop string "a" is matched only once the floor is reached
        assert [len(r.output_token_ids) for r in ours[1:3]] == [3, 3]


def test_sampled_truncation_streams_equal_across_paths(model):
    """Seeded top-k / top-p / min-p streams (keyed noise) are the same in
    windows, single steps and mixed steps, and differ from greedy."""
    sp = [SamplingParams(max_tokens=10, temperature=0.9, top_p=0.8, seed=1),
          SamplingParams(max_tokens=10, temperature=1.2, top_k=5, seed=2),
          SamplingParams(max_tokens=10, temperature=0.7, min_p=0.2, top_k=40, seed=3),
          SamplingParams(max_tokens=10, temperature=0.0)]
    runs = {}
    for path, kw in PATHS.items():
        kw = dict(kw)
        eng = _port(model, kw.pop("sched", None), **kw)
        runs[path] = [r.output_token_ids for r in eng.generate(PROMPTS, sp)]
    assert runs["windows"] == runs["single"] == runs["mixed"]
    greedy = [r.output_token_ids for r in _port(model).generate(
        PROMPTS, SamplingParams(max_tokens=10, temperature=0.0))]
    assert runs["windows"][3] == greedy[3] and runs["windows"][:3] != greedy[:3]


def _events(eng, dispatchers):
    """Record the order of ``eng``'s decode dispatches ("D": the methods
    named in ``dispatchers``) and flushes of an in-flight window ("F"): a
    staleness flush comes before the dispatch it clears the way for, a
    pipelined one after the dispatch that overlaps it."""
    seen = []

    def spy(name, tag, cond=lambda: True):
        orig = getattr(eng, name)

        def call(*a, **kw):
            if cond():
                seen.append(tag)
            return orig(*a, **kw)
        setattr(eng, name, call)
    spy("_flush_window", "F", lambda: eng._pending_window is not None)
    for name in dispatchers:
        spy(name, "D")
    return seen


def _staleness_run(eng, sp_cls, clock):
    """A plain stream and one whose min_tokens floor is in force for its
    first 7 tokens, then a penalized stream arriving after the third
    step; the clock moves 0.1 s a step."""
    base = dict(max_tokens=20, temperature=0.0, ignore_eos=True)
    rids = [eng.add_request(prompt_token_ids=PROMPTS[0], params=sp_cls(**base)),
            eng.add_request(prompt_token_ids=PROMPTS[1],
                            params=sp_cls(**dict(base, ignore_eos=False, min_tokens=7,
                                                 logit_bias={EOS: 3.0})))]
    n = 0
    while eng.has_work():
        eng.step()
        clock.advance(0.1)
        n += 1
        if n == 3:
            rids.append(eng.add_request(prompt_token_ids=PROMPTS[2],
                                        params=sp_cls(**dict(base, max_tokens=12,
                                                             repetition_penalty=1.4))))
    return [eng.requests[r].output_token_ids for r in rids]


def test_staleness_flushes_land_where_the_jax_engines_do(model):
    """Pipelined adaptive windows (multi_step 8, min 4) under a
    VirtualClock: a window for rows with penalties, or with a floor in
    force within the in-flight window's steps, first flushes that window.
    The dispatches and flushes come in the JAX engine's order, the streams
    are equal, and both kinds of flush occur."""
    kw = dict(multi_step=8, min_multi_step=4, adaptive_window_hold_s=0.5,
              pipeline_decode=True)
    clock, jclock = VirtualClock(), JaxVirtualClock()
    eng, jeng = _port(model, clock=clock, **kw), _jax(model, clock=jclock, **kw)
    ours = _events(eng, ["_dispatch"])
    ref = _events(jeng, ["_exec_decode_multi", "_exec_decode"])
    got = _staleness_run(eng, SamplingParams, clock)
    want = _staleness_run(jeng, jax_rt.SamplingParams, jclock)
    assert got == want and ours == ref
    pairs = ["".join(p) for p in zip(ours, ours[1:])]
    assert pairs.count("DF") >= 2 and pairs.count("FD") >= 2
