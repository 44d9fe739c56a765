"""The port's guided decoding on the CPU, against the JAX package's.

Host modules: the port's own copies compile each spec family (json,
json_schema, regex, choice) on tiny-qwen3's tokenizer to FSM tables
bit-equal to the JAX compile's; the character acceptors agree with the
JAX ones character by character; a compiled FSM saved by either package's
disk cache loads in the other.  Ops, float32: ``apply_token_mask`` and the
window's mask and advance give the JAX ops' results exactly (kept logits,
the NEG_INF set, the next states), on vocabularies whose mask words have
bit 31 set; a guided window (``decode_multi`` with the FSM carry) gives
the JAX window's tokens and final states; masked rows sampled with the JAX
sampler's own noise give its tokens.  Engine: greedy guided streams equal
``tpuserve.runtime.Engine``'s token for token, with texts and finish
reasons, on pipelined windows, single steps and mixed steps, for every
spec family, a batch mixing guided and unguided rows, a batch of two
grammars, the substitution path (``guided_fsm=False``) and a spec that
does not compile, and under preemption; compiled FSMs are cached on
disk; seeded sampled guided streams are the same on windows, chained
pipelined windows and single steps (the two packages' noise differs,
ROADMAP.md C).
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import transformer as jax_tf
from tpuserve.models import weights as jax_weights
from tpuserve.models.tokenizer import load_tokenizer as jax_load_tokenizer
from tpuserve.ops import sampling as jax_sampling
from tpuserve.runtime import grammar as jax_grammar
from tpuserve.runtime import guided as jax_guided
from tpuserve.runtime import guided_choice as jax_choice
from tpuserve.runtime import guided_regex as jax_regex
from tpuserve.runtime import kv_cache as jax_kv
from tpuserve_torch import runtime as port_rt
from tpuserve_torch.models import transformer
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.tokenizer import load_tokenizer
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.ops import sampling
from tpuserve_torch.ops.attention import PAD_SLOT
from tpuserve_torch.runtime import Engine, SamplingParams, grammar, guided, kv_cache
from tpuserve_torch.runtime import guided_choice, guided_regex


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


SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string"}, "ok": {"type": "boolean"},
                         "mood": {"enum": ["up", "down"]}},
          "required": ["name", "ok", "mood"], "additionalProperties": False}
# an integer field's digit prefixes pass the compile's state budget (in
# both packages): this schema runs the substitution path
INT_SCHEMA = {"type": "object", "properties": {"n": {"type": "integer"},
                                               "mood": {"enum": ["up", "down"]}},
              "required": ["n", "mood"], "additionalProperties": False}
SPECS = {"json": ("json", None), "json_schema": ("json_schema", json.dumps(SCHEMA)),
         "regex": ("regex", "[0-9]{3}-[0-9]{4}"),
         "choice": ("choice", json.dumps(["yes", "no", "maybe"]))}


def _vocab():
    V = get_model_config("tiny-qwen3").vocab_size
    return V, load_tokenizer("tiny-qwen3", vocab_size=V), jax_load_tokenizer(
        "tiny-qwen3", vocab_size=V)


# ---- host modules -----------------------------------------------------------

@pytest.mark.parametrize("name", list(SPECS))
def test_fsm_tables_are_bit_equal_to_the_jax_compile(name):
    V, tok, jtok = _vocab()
    eos = {1, 2}
    fsm = grammar.fsm_for_spec(*SPECS[name], tok, V, eos)
    ref = jax_grammar.fsm_for_spec(*SPECS[name], jtok, V, eos)
    for field in ("masks", "tok_class", "class_next", "can_finish", "complete"):
        got, want = getattr(fsm, field), getattr(ref, field)
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    assert (fsm.start, fsm.vocab_size) == (ref.start, ref.vocab_size)
    # the text table the engine builds once: ids past the byte range have
    # no text, as in the JAX compile
    texts = grammar.token_text_table(tok, V)
    assert texts == jax_grammar.token_text_table(jtok, V) and max(texts) < 259


ACCEPTOR_CASES = [
    ("json", None, '{"a": [1, 2.5e3, true, null], "b": {"c": "x\\"y"}} '),
    ("json", None, '{"a": tru'),
    ("json_schema", json.dumps(SCHEMA), '{"name": "q", "ok": false, "mood": "down"}'),
    ("json_schema", json.dumps(INT_SCHEMA), '{"n": -12, "mood": "up"}'),
    ("json_schema", json.dumps(SCHEMA), '{"ok": 1}'),
    ("regex", "[0-9]{3}-[0-9]{4}", "123-4567"),
    ("regex", "(ab|cd)+e?", "abcdcdx"),
    ("choice", json.dumps(["yes", "no", "maybe"]), "maybe"),
    ("choice", json.dumps(["yes", "no", "maybe"]), "mayo"),
]


def _machines(mode, spec):
    if mode == "json":
        return guided.JsonStateMachine(), jax_guided.JsonStateMachine()
    if mode == "json_schema":
        s = json.loads(spec)
        return (guided.SchemaJsonStateMachine(guided.compile_schema(s)),
                jax_guided.SchemaJsonStateMachine(jax_guided.compile_schema(s)))
    if mode == "regex":
        return (guided_regex.RegexStateMachine(guided_regex.compile_regex(spec)),
                jax_regex.RegexStateMachine(jax_regex.compile_regex(spec)))
    c = json.loads(spec)
    return (guided_choice.ChoiceStateMachine(guided_choice.compile_choices(c)),
            jax_choice.ChoiceStateMachine(jax_choice.compile_choices(c)))


@pytest.mark.parametrize("mode,spec,text", ACCEPTOR_CASES,
                         ids=[f"{m}-{i}" for i, (m, _, _) in enumerate(ACCEPTOR_CASES)])
def test_acceptors_agree_with_the_jax_ones(mode, spec, text):
    """allows / feed / can_finish / complete / in_string, character by
    character, until both reject the same character."""
    ours, ref = _machines(mode, spec)
    for ch in text:
        assert ours.allows(ch) == ref.allows(ch), ch
        assert (ours.can_finish, ours.complete, ours.in_string) == (
            ref.can_finish, ref.complete, ref.in_string)
        if not ref.allows(ch):
            for m in (ours, ref):
                with pytest.raises(ValueError):
                    m.feed(ch)
            return
        ours.feed(ch)
        ref.feed(ch)
    assert (ours.can_finish, ours.complete) == (ref.can_finish, ref.complete)


def test_spec_errors_are_the_jax_errors():
    bad = [(guided.compile_schema, jax_guided.compile_schema, {"type": "object",
                                                              "patternProperties": {}}),
           (guided_regex.compile_regex, jax_regex.compile_regex, "a(?=b)"),
           (guided_choice.compile_choices, jax_choice.compile_choices, [])]
    for ours, ref, spec in bad:
        with pytest.raises(ValueError) as e_ref:
            ref(spec)
        with pytest.raises(ValueError) as e_ours:
            ours(spec)
        assert str(e_ours.value) == str(e_ref.value)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_cache_entries_load_in_the_other_package(tmp_path, writer):
    V, tok, jtok = _vocab()
    eos = {1, 2}
    mode, spec = SPECS["regex"]
    fp = grammar.tokenizer_fingerprint(tok, V, eos)
    assert fp == jax_grammar.tokenizer_fingerprint(jtok, V, eos)
    fsm = jax_grammar.fsm_for_spec(mode, spec, jtok, V, eos)
    save, load = ((jax_grammar.save_fsm, grammar.load_fsm) if writer == "jax"
                  else (grammar.save_fsm, jax_grammar.load_fsm))
    save(str(tmp_path), mode, spec, fp, fsm)
    got = load(str(tmp_path), mode, spec, fp)
    for field in ("masks", "tok_class", "class_next", "can_finish", "complete"):
        assert np.array_equal(getattr(got, field), getattr(fsm, field))
    assert got.start == fsm.start
    assert load(str(tmp_path), "regex", "other", fp) is None


# ---- ops --------------------------------------------------------------------

def _mask_inputs(V, B=6, seed=3):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    allow = rng.random((B, V)) < 0.3
    allow[:, 31::32] = True                     # bit 31 of every word set
    allow[1] = False
    allow[1, V - 1] = True                      # one legal token, in the last word
    packed = jax_grammar.pack_masks(allow)
    enabled = np.array([True, True, False, True, False, True])[:B]
    return logits, packed, enabled, allow


@pytest.mark.parametrize("V", [300, 512])
def test_apply_token_mask_equals_jax(V):
    logits, packed, enabled, allow = _mask_inputs(V)
    ref = np.asarray(jax_sampling.apply_token_mask(jnp.asarray(logits), jnp.asarray(packed),
                                                   jnp.asarray(enabled)))
    for words in (_t(packed), _t(packed.view(np.int32))):       # uint32 or int32 words
        out = sampling.apply_token_mask(_t(logits), words, _t(enabled)).numpy()
        np.testing.assert_array_equal(out, ref)
    kept = allow | ~enabled[:, None]
    assert np.array_equal(out == sampling.NEG_INF, ~kept)
    assert (ref == jax_sampling.NEG_INF).sum() == (~kept).sum()


def test_window_mask_and_advance_equal_jax():
    V, N, C = 300, 5, 7
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, V)).astype(np.float32)
    masks = jax_grammar.pack_masks(rng.random((N, V)) < 0.5)
    gclass = rng.integers(0, C, V).astype(np.int32)
    gnext = rng.integers(-1, N, (N, C)).astype(np.int32)
    gstate = np.array([0, -1, 4, 2, -1, 3], np.int32)
    nxt = rng.integers(0, V, 6).astype(np.int32)
    ref = np.asarray(jax_tf.window_guided_mask(jnp.asarray(logits), jnp.asarray(gstate),
                                               jnp.asarray(masks)))
    out = transformer.window_guided_mask(_t(logits), _t(gstate), _t(masks.view(np.int32)))
    np.testing.assert_array_equal(out.numpy(), ref)
    ref_next = np.asarray(jax_tf.window_guided_advance(
        jnp.asarray(gstate), jnp.asarray(nxt), jnp.asarray(gclass), jnp.asarray(gnext)))
    got = transformer.window_guided_advance(_t(gstate), _t(nxt), _t(gclass), _t(gnext))
    np.testing.assert_array_equal(got.numpy(), ref_next)
    assert got.dtype == torch.int32 and got[1] == -1 and got[4] == -1


@pytest.mark.parametrize("mode", ["temperature", "full"])
def test_masked_rows_sampled_with_the_jax_noise_give_its_tokens(mode):
    V = 300
    logits, packed, enabled, _ = _mask_inputs(V, seed=9)
    B = logits.shape[0]
    keys = np.random.default_rng(2).integers(0, 2**31, (B, 2)).astype(np.uint32)
    temp = np.array([0.8, 1.0, 0.0, 1.3, 0.7, 0.9], np.float32)
    top_k = np.array([0, 5, 0, 40, 0, 2], np.int32)
    top_p = np.array([0.9, 1.0, 1.0, 0.5, 1.0, 0.95], np.float32)
    jm = jax_sampling.apply_token_mask(jnp.asarray(logits), jnp.asarray(packed),
                                       jnp.asarray(enabled))
    ref = jax_sampling.sample_tokens(jm, jnp.asarray(keys), jnp.asarray(temp),
                                     jnp.asarray(top_k), jnp.asarray(top_p), mode=mode)
    noise = np.asarray(jax_sampling._row_gumbel(jnp.asarray(keys), (B, V)))
    masked = sampling.apply_token_mask(_t(logits), _t(packed), _t(enabled))
    out = sampling.sample_tokens(masked, _t(temp), mode=mode, gumbel=_t(noise),
                                 top_k=_t(top_k), top_p=_t(top_p))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # every enabled row sampled a legal token
    allowed = jax_grammar.unpack_masks(packed, V)
    assert all(allowed[i, t] for i, t in enumerate(out.tolist()) if enabled[i])


# ---- the guided window against the JAX decode_multi -------------------------

@pytest.fixture(scope="module")
def model(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


BS, NB, MB = 4, 16, 8


@pytest.mark.parametrize("mode", ["greedy", "full"])
def test_guided_window_matches_jax_decode_multi(model, mode):
    """An 8-step window over two rows, one guided by the json_schema FSM
    (from its start state) and one unguided, with a bias pushing the
    guided row off-grammar: tokens and final states equal to the JAX
    ``decode_multi``'s, and the guided row's tokens walk the FSM.  The full
    mode runs top_k 1 at temperature 0.8 (the argmax through the sort)."""
    jcfg, jparams, cfg, params = model
    V = cfg.vocab_size
    _, tok, _ = _vocab()
    fsm = grammar.fsm_for_spec(*SPECS["json_schema"], tok, V, {1, 2})
    jcache = jax_kv.create_kv_cache(jcfg, jax_kv.CacheConfig(
        block_size=BS, num_blocks=NB, max_blocks_per_seq=MB, dtype="float32"))
    cache = kv_cache.create_kv_cache(cfg, kv_cache.CacheConfig(
        block_size=BS, num_blocks=NB, max_blocks_per_seq=MB, dtype="float32"), "cpu")
    lens = np.array([7, 5], np.int32)
    bt = np.arange(2 * MB, dtype=np.int32).reshape(2, MB)
    tokens = np.random.default_rng(6).integers(3, V, (2, 8)).astype(np.int32)
    slots = np.full((2, 8), PAD_SLOT, np.int32)
    for b, n in enumerate(lens):
        t = np.arange(n)
        slots[b, :n] = bt[b, t // BS] * BS + t % BS
    jl, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens),
                                jnp.asarray(slots), jcache)
    transformer.prefill(params, cfg, _t(tokens), _t(lens), _t(slots), cache)
    first = np.asarray(jl).argmax(-1).astype(np.int32)
    gstate = np.array([fsm.start, -1], np.int32)
    bias = np.zeros((2, V), np.float32)
    bias[:, 3 + ord("x")] = 50.0                    # "x" is never legal in the schema
    temp = np.array([0.8, 0.8] if mode == "full" else [0.0, 0.0], np.float32)
    top = dict(top_k=np.array([1, 1], np.int32), top_p=np.ones(2, np.float32),
               min_p=np.zeros(2, np.float32)) if mode == "full" else {}
    args = (first, lens, bt, lens + 1, np.ones(2, bool))
    extras = dict(counts=np.zeros((2, V), np.float32), bias=bias,
                  floor_bias=np.zeros((2, V), np.float32), presence=np.zeros(2, np.float32),
                  frequency=np.zeros(2, np.float32), repetition=np.ones(2, np.float32),
                  floor_remaining=np.zeros(2, np.int32), gstate=gstate, gmasks=fsm.masks,
                  gclass=fsm.tok_class, gnext=fsm.class_next, **top)
    jt, _, jg = jax_tf.decode_multi(
        jparams, jcfg, *map(jnp.asarray, args), jnp.zeros((2, 2), jnp.uint32),
        jnp.asarray(temp), jcache, steps=8, mode=mode,
        **{k: jnp.asarray(v) for k, v in extras.items()})
    out, _, g = transformer.decode_multi(
        params, cfg, *map(_t, args), _t(temp), cache, steps=8, mode=mode,
        **{k: _t(v) for k, v in extras.items()})
    np.testing.assert_array_equal(out.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    s = fsm.start
    for tok_id in out[0].tolist():
        s = fsm.advance(s, tok_id)
        assert s >= 0
    assert s == g[0].item() and g[1].item() == -1
    assert out[1].tolist() == [3 + ord("x")] * 8           # the unguided row took the bias


# ---- the engine against the JAX engine ---------------------------------------

CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=32, dtype="float32")
SCHED = dict(max_num_seqs=4, max_prefill_tokens=256, min_prefill_bucket=8,
             min_decode_bucket=2)
PATHS = {
    "windows": dict(multi_step=4, pipeline_decode=True),
    "single": dict(multi_step=1, pipeline_decode=True),
    "mixed": dict(multi_step=4, pipeline_decode=True,
                  sched=dict(mixed_batching=True, mixed_token_budget=16)),
}
PROMPTS = [[73, 135, 115, 53, 66, 144, 120, 102, 69, 152, 80, 67], [168, 164, 61, 118],
           [148, 42, 40]]


def _guided(name, **kw):
    mode, spec = SPECS[name]
    return dict(dict(max_tokens=40, temperature=0.0, guided=mode, guided_schema=spec), **kw)


PLAIN = dict(max_tokens=12, temperature=0.0, ignore_eos=True)
SCENARIOS = {
    "json": [_guided("json")] * 3,
    "json_schema": [_guided("json_schema")] * 3,
    "regex": [_guided("regex")] * 3,
    "choice": [_guided("choice")] * 3,
    # the mask touches the guided rows only
    "mixed_batch": [_guided("json"), PLAIN, _guided("json")],
    # a window carries one grammar: two run single steps
    "two_grammars": [_guided("json"), _guided("regex"), PLAIN],
    # a non-ASCII choice list and an integer field cannot compile under the
    # byte tokenizer: the substitution path (with its plans) serves them
    # beside an FSM request
    "uncompilable": [dict(max_tokens=16, temperature=0.0, guided="choice",
                          guided_schema=json.dumps(["是", "否"])),
                     dict(max_tokens=40, temperature=0.0, guided="json_schema",
                          guided_schema=json.dumps(INT_SCHEMA)), _guided("choice")],
    # a guided row beside rows with logprobs and penalties: one window
    # carries the mask, the logprobs and the penalties
    "logprobs_beside": [_guided("json"), dict(PLAIN, logprobs=3),
                        dict(PLAIN, logprobs=2, repetition_penalty=1.3)],
    # every spec on the substitution path
    "no_fsm": [_guided("json", max_tokens=16), _guided("regex", max_tokens=16), PLAIN],
}


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
    """The JAX engine's requests a scenario, made once (single steps,
    synchronous: greedy streams do not depend on the path)."""
    done, engines = {}, {}

    def run(name):
        if name not in done:
            fsm = name != "no_fsm"
            if fsm not in engines:
                engines[fsm] = _jax(model, multi_step=1, guided_fsm=fsm)
            done[name] = engines[fsm].generate(
                PROMPTS, [jax_rt.SamplingParams(**p) for p in SCENARIOS[name]])
        return done[name]
    return run


def _check_valid(name, reqs):
    """Each guided output that stopped is a document of its spec."""
    for p, r in zip(SCENARIOS[name], reqs):
        mode, text = p.get("guided"), r.output_text
        if mode is None or r.finish_reason.value != "stop":
            continue
        if mode == "json":
            assert isinstance(json.loads(text), dict)
        elif mode == "json_schema":
            doc, schema = json.loads(text), json.loads(p["guided_schema"])
            assert set(doc) == set(schema["required"]) and doc["mood"] in ("up", "down")
            assert all(isinstance(doc[k], {"string": str, "boolean": bool, "integer": int}[v["type"]])
                       for k, v in schema["properties"].items() if "type" in v)
        elif mode == "regex":
            assert re.fullmatch(p["guided_schema"], text), text
        else:
            assert text in json.loads(p["guided_schema"])


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_greedy_guided_streams_match_jax_engine(model, jax_runs, name, path):
    kw = dict(PATHS[path])
    eng = _port(model, kw.pop("sched", None), guided_fsm=name != "no_fsm", **kw)
    ours = eng.generate(PROMPTS, [SamplingParams(**p) for p in SCENARIOS[name]])
    ref = jax_runs(name)
    for o, r in zip(ours, ref):
        assert (o.output_token_ids, o.output_text, o.finish_reason.value) == (
            r.output_token_ids, r.output_text, r.finish_reason.value)
        assert len(o.logprobs) == len(r.logprobs)
        for a, b in zip(o.logprobs, r.logprobs):
            assert a["token_id"] == b["token_id"] and abs(a["logprob"] - b["logprob"]) <= 1e-4
            assert [t for t, _ in a["top"]] == [t for t, _ in b["top"]]
    _check_valid(name, ours)
    st = eng.stats
    fsm_rows = {"uncompilable": 1, "no_fsm": 0, "mixed_batch": 2, "two_grammars": 2,
                "logprobs_beside": 1}.get(name, 3)
    assert st.guided_fsm_requests == fsm_rows
    if path == "windows" and name in ("json", "json_schema", "regex", "choice", "mixed_batch",
                                      "logprobs_beside"):
        assert st.guided_fsm_windows > 0            # guided rows rode windows
    if path == "single" or name in ("no_fsm",):
        assert st.guided_fsm_windows == 0
    if name == "uncompilable":
        assert ours[0].output_text in ("是", "否") and st.guided_plans >= 1
    assert not eng._guided and not eng._guided_fsm and not eng._guided_plan


@pytest.mark.parametrize("multi_step", [1, 4])
def test_guided_streams_survive_preemption_as_the_jax_engines(model, multi_step):
    """A 12-block cache preempts streams in both engines: a preempted
    guided request keeps its grammar state through its re-prefill, and
    every stream equals the JAX engine's."""
    cache = dict(CACHE, num_blocks=12)
    params = [_guided("json_schema"), dict(max_tokens=40, temperature=0.0, guided="regex",
                                           guided_schema="[a-z]{30}"), PLAIN]
    _, jparams, cfg, tparams = model
    eng = Engine(port_rt.EngineConfig(
        model="tiny-qwen3", cache=port_rt.CacheConfig(**cache),
        scheduler=port_rt.SchedulerConfig(**SCHED), multi_step=multi_step,
        pipeline_decode=True), params=tparams, model_cfg=cfg, device="cpu")
    ours = eng.generate(PROMPTS, [SamplingParams(**p) for p in params])
    jeng = jax_rt.Engine(jax_rt.EngineConfig(
        model="tiny-qwen3", cache=jax_rt.CacheConfig(**cache),
        scheduler=jax_rt.SchedulerConfig(allow_chunked_prefill=False, **SCHED),
        attn_impl="reference", kv_tiers=False, slo_classes=False, multi_step=multi_step),
        params=jparams, model_cfg=model[0])
    ref = jeng.generate(PROMPTS, [jax_rt.SamplingParams(**p) for p in params])
    assert eng.stats.preemptions == jeng.stats.preemptions > 0
    for o, r in zip(ours, ref):
        assert (o.output_token_ids, o.output_text, o.finish_reason.value) == (
            r.output_token_ids, r.output_text, r.finish_reason.value)
    assert re.fullmatch("[a-z]{30}", ours[1].output_text)
    assert not eng._guided_fsm


def test_guided_requests_are_accepted_and_refused_as_the_jax_engines(model):
    """Guided requests run; the JAX engine's admission errors stand: an
    unknown mode, logprobs with a spec, and a bad schema, pattern or
    choice list raise ValueError with its message and leave nothing
    queued."""
    eng, jeng = _port(model), _jax(model, multi_step=1)
    rid = eng.add_request(prompt_token_ids=[5, 6], params=SamplingParams(
        max_tokens=4, guided="json"))
    assert eng.has_work() and rid in eng._guided_fsm
    eng.abort_request(rid)
    assert not eng._guided_fsm
    bad = [dict(guided="xml"), dict(guided="json", logprobs=2),
           dict(guided="json_schema", guided_schema=json.dumps({"type": "foo"})),
           dict(guided="regex", guided_schema="a{"),
           dict(guided="choice", guided_schema=json.dumps(["a", 3]))]
    for kw in bad:
        with pytest.raises(ValueError) as e_ref:
            jeng.add_request(prompt_token_ids=[5, 6], params=jax_rt.SamplingParams(**kw))
        with pytest.raises(ValueError) as e_ours:
            eng.add_request(prompt_token_ids=[5, 6], params=SamplingParams(**kw))
        assert str(e_ours.value) == str(e_ref.value)
    assert not eng.has_work() and not eng._guided and not eng._guided_fsm


SAMPLED = {
    "json": _guided("json", max_tokens=24, temperature=0.8, seed=5),
    "regex": dict(max_tokens=17, temperature=0.9, seed=2, guided="regex",
                  guided_schema="[abc]{2,16}Z"),
    "choice": _guided("choice", max_tokens=16, temperature=0.9, seed=1, top_p=0.9),
}


@pytest.mark.parametrize("name", list(SAMPLED))
def test_sampled_guided_streams_equal_across_paths(model, name):
    """Seeded guided streams at temperature are the same on single steps,
    windows and chained pipelined windows (each row's noise is keyed by
    its seed and step), every stopped one valid; the pipelined windows
    chain each row's FSM state on the device."""
    p = [SamplingParams(**dict(SAMPLED[name], seed=SAMPLED[name]["seed"] + i))
         for i in range(len(PROMPTS))]
    base = _port(model, multi_step=1, pipeline_decode=False).generate(PROMPTS, p)
    for kw in (dict(multi_step=4, pipeline_decode=False), dict(multi_step=4,
                                                               pipeline_decode=True)):
        eng = _port(model, **kw)
        outs = eng.generate(PROMPTS, p)
        assert [r.output_token_ids for r in outs] == [r.output_token_ids for r in base]
        # a choice ends inside its first window; the others chain windows
        assert eng.stats.guided_fsm_windows >= (1 if name == "choice" else 2)
    for r in outs:
        if r.finish_reason.value == "stop" and name == "regex":
            assert re.fullmatch("[abc]{2,16}Z", r.output_text), r.output_text
        elif r.finish_reason.value == "stop" and name == "json":
            json.loads(r.output_text)
        elif name == "choice":
            assert r.output_text in ("yes", "no", "maybe")


def test_fsm_compiles_once_per_grammar_and_a_planted_fault_shows(model, monkeypatch):
    """The memo: one compile serves four requests of one grammar.  With
    the mask disabled (the fault chip_smoke.py plants) greedy json rows
    leave the grammar and drop their constraint."""
    calls = {"n": 0}
    orig = grammar.fsm_for_spec

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)
    monkeypatch.setattr("tpuserve_torch.runtime.grammar.fsm_for_spec", counting)
    eng = _port(model, multi_step=4)
    p = SamplingParams(**_guided("json", max_tokens=8))
    eng.generate(PROMPTS[:2], p)
    eng.generate(PROMPTS[:2], p)
    assert calls["n"] == 1 and eng._fsm_stats == {"hits": 3, "misses": 1, "disk_hits": 0}
    eng.guided_mask_enabled = False
    outs = eng.generate(PROMPTS[:2], SamplingParams(**_guided("json", max_tokens=8)))
    assert not all(r.output_text.lstrip().startswith("{") for r in outs)


@pytest.mark.parametrize("where", ["env", "checkpoint_dir"])
def test_compiled_fsms_are_cached_on_disk(model, tmp_path, monkeypatch, where):
    """With ``TPUSERVE_FSM_CACHE_DIR``, or beside the checkpoint directory,
    the first engine saves the compiled FSM and a second loads it (a disk
    hit, no token-text table), giving the same tokens."""
    kw = {}
    if where == "env":
        monkeypatch.setenv("TPUSERVE_FSM_CACHE_DIR", str(tmp_path))
        cache_dir = tmp_path
    else:
        monkeypatch.delenv("TPUSERVE_FSM_CACHE_DIR", raising=False)
        kw, cache_dir = dict(checkpoint_dir=str(tmp_path)), tmp_path / "fsm_cache"
    p = SamplingParams(**_guided("regex", max_tokens=12))
    first = _port(model, multi_step=4, **kw)
    a = first.generate(PROMPTS[:1], p)[0].output_token_ids
    second = _port(model, multi_step=4, **kw)
    b = second.generate(PROMPTS[:1], p)[0].output_token_ids
    assert a == b and second._fsm_stats["disk_hits"] == 1 and second._fsm_texts is None
    assert len(list(cache_dir.glob("fsm-*.npz"))) == 1
