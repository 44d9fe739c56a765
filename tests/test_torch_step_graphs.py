"""The port's prefill, chunk and mixed executables (``runtime/graphs.py``)
on the CPU, against the port's eager transformer entries and the JAX
package's; the warmup ladder and adaptive window sizing against the JAX
engine's.

Both sides run float32 tiny-qwen3 with the same parameters (the JAX tree
handed over as numpy) on the plain attention.  On the CPU an executable
runs its step eagerly on the same static buffers the graph replays on the
card: its logits must equal the port's eager function's and agree with the
JAX function's to atol 1e-4 (float32 summed in another order); its cache
must equal the eager function's and agree with the JAX cache (int8 values
to one quantization step, as tests/test_torch_pipeline.py holds them).
The card's own checks are in chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import _NoHostReads
from tpuserve import runtime as jax_rt
from tpuserve.models import transformer as jax_tf
from tpuserve.models import weights as jax_weights
from tpuserve.runtime import kv_cache as jax_kv
from tpuserve.runtime.clock import VirtualClock as JaxVirtualClock
from tpuserve_torch import runtime as port_rt
from tpuserve_torch.models import transformer
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.ops.attention import PAD_SLOT
from tpuserve_torch.ops.ragged_paged import ragged_layout
from tpuserve_torch.runtime import Engine, SamplingParams, kv_cache
from tpuserve_torch.runtime.clock import VirtualClock
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
BS, NB, MB, BLK, SEQS = 4, 32, 8, 8, 4     # block size, blocks, per sequence, ragged block


@pytest.fixture(scope="module")
def model(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


# ---- the executables against the eager functions and the JAX functions -----

BT = np.arange(3 * MB, dtype=np.int32).reshape(3, MB)     # three sequences' blocks


def _slots(b, start, n):
    t = np.arange(start, start + n)
    return (BT[b, t // BS] * BS + t % BS).astype(np.int32)


def _prefill_inputs(rng, lens, L, B):
    """A (B, L) prefill of sequences 0.. with ``lens`` tokens, padding rows
    after them."""
    a = dict(tokens=np.zeros((B, L), np.int32), slot_ids=np.full((B, L), PAD_SLOT, np.int32),
             prompt_lens=np.ones(B, np.int32))
    for b, n in enumerate(lens):
        a["tokens"][b, :n] = rng.integers(3, 200, n)
        a["slot_ids"][b, :n] = _slots(b, 0, n)
        a["prompt_lens"][b] = n
    return a


def _inputs(kind, rng, first_tokens):
    """The step of ``kind`` after a prefill of sequences 0 (13 tokens) and
    1 (6 tokens): sequence 2's 11 tokens in a (4, 16) batch, with three
    padding rows (prefill); a 5-row chunk of sequence 0 at its cached
    offset 13, in a bucket of 8 (chunk: a prefix hit's suffix); the two
    decode rows and a 10-row first chunk of sequence 2 in a 32-row stream
    (mixed)."""
    if kind == "prefill":
        a = _prefill_inputs(rng, [], 16, 4)
        n = 11
        a["tokens"][0, :n] = rng.integers(3, 200, n)
        a["slot_ids"][0, :n] = _slots(2, 0, n)
        a["prompt_lens"][0] = n
        return a
    if kind == "chunk":
        n, C = 5, 8
        a = dict(tokens=np.zeros((1, C), np.int32), slot_ids=np.full((1, C), PAD_SLOT, np.int32),
                 ctx_lens=np.array([13], np.int32), chunk_lens=np.array([n], np.int32),
                 block_tables=BT[:1].copy())
        a["tokens"][0, :n] = rng.integers(3, 200, n)
        a["slot_ids"][0, :n] = _slots(0, 13, n)
        return a
    lens, take = (13, 6), 10
    starts, T, meta, blk_seq = ragged_layout(2, [take], BLK)
    a = dict(tokens=np.zeros(T, np.int32), positions=np.zeros(T, np.int32),
             slot_ids=np.full(T, PAD_SLOT, np.int32), row_seq=np.zeros(T, np.int32),
             block_tables=np.zeros((SEQS, MB), np.int32), kv_lens=np.zeros(SEQS, np.int32),
             q_starts=np.full(SEQS, T, np.int32), q_lens=np.zeros(SEQS, np.int32),
             meta=meta, blk_seq=blk_seq, last_rows=np.zeros(SEQS, np.int32))
    for i, n in enumerate(lens):
        a["tokens"][i], a["positions"][i], a["slot_ids"][i] = first_tokens[i], n, _slots(i, n, 1)[0]
        a["row_seq"][i] = a["q_starts"][i] = a["last_rows"][i] = i
        a["kv_lens"][i], a["q_lens"][i] = n + 1, 1
        a["block_tables"][i] = BT[i]
    st = starts[0]
    rows = slice(st, st + take)
    a["tokens"][rows] = rng.integers(3, 200, take)
    a["positions"][rows] = np.arange(take)
    a["slot_ids"][rows] = _slots(2, 0, take)
    a["row_seq"][rows] = 2
    a["kv_lens"][2], a["q_starts"][2], a["q_lens"][2], a["last_rows"][2] = take, st, take, st + take - 1
    a["block_tables"][2] = BT[2]
    return a


_ARGS = {"prefill": ("tokens", "prompt_lens", "slot_ids"),
         "chunk": ("tokens", "ctx_lens", "chunk_lens", "slot_ids", "block_tables"),
         "mixed": ("tokens", "positions", "slot_ids", "row_seq", "block_tables", "kv_lens",
                   "q_starts", "q_lens", "meta", "blk_seq", "last_rows")}
_PORT = {"prefill": transformer.prefill, "chunk": transformer.prefill_chunk,
         "mixed": transformer.forward_ragged}
_JAX = {"prefill": jax_tf.prefill, "chunk": jax_tf.prefill_chunk,
        "mixed": jax_tf.forward_ragged}
# the rows whose logits are meaningful
_VALID = {"prefill": slice(0, 1), "chunk": slice(0, 1), "mixed": slice(0, 3)}


def _key(kind, a):
    """The executable key of a step's inputs: (B, L), C or T."""
    shape = a["tokens"].shape
    return (kind, *shape) if kind == "prefill" else (kind, shape[-1])


def _caches(model, dtype):
    """A JAX cache and two port caches (executable, eager) after the same
    prefill of sequences 0 and 1; the prefill's greedy tokens."""
    jcfg, jparams, cfg, params = model
    jcache = jax_kv.create_kv_cache(jcfg, jax_kv.CacheConfig(
        block_size=BS, num_blocks=NB, max_blocks_per_seq=MB, dtype=dtype))
    cc = kv_cache.CacheConfig(block_size=BS, num_blocks=NB, max_blocks_per_seq=MB, dtype=dtype)
    caches = [kv_cache.create_kv_cache(cfg, cc, "cpu") for _ in range(2)]
    a = _prefill_inputs(np.random.default_rng(3), (13, 6), 16, 2)
    args = [a[k] for k in _ARGS["prefill"]]
    jl, jcache = jax_tf.prefill(jparams, jcfg, *map(jnp.asarray, args), jcache)
    for c in caches:
        transformer.prefill(params, cfg, *map(torch.from_numpy, args), c)
    return jcache, caches, np.asarray(jl).argmax(-1)


def _stage(exe, a):
    st = exe.stage()
    for name, arr in a.items():
        getattr(st, name)[...] = arr
    return st


def _step_graphs(model, cache, attn_impl="reference"):
    _, _, cfg, params = model
    return StepGraphs(params, cfg, cache, device=torch.device("cpu"), attn_impl=attn_impl,
                      max_blocks=MB, steps=1, max_batch=SEQS, ragged_blk=BLK, capture=False)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("kind", ["prefill", "chunk", "mixed"])
def test_executable_equals_eager_and_jax(model, kind, cache_dtype):
    """One step of each kind from the executable's packed buffers, padding
    rows included: the logits and the cache equal the eager function's on
    the same inputs and agree with the JAX function's."""
    jcfg, jparams, cfg, params = model
    jcache, (cache, eager_cache), first = _caches(model, cache_dtype)
    a = _inputs(kind, np.random.default_rng(4), first)
    graphs = _step_graphs(model, cache)      # the executables' owner: held while they run
    exe = graphs.get(*_key(kind, a))
    exe.load(_stage(exe, a))
    exe.run()
    args = [a[k] for k in _ARGS[kind]]
    kw = dict(ragged_blk=BLK) if kind == "mixed" else {}
    eager, _ = _PORT[kind](params, cfg, *map(torch.from_numpy, args), eager_cache, **kw)
    jl, jcache = _JAX[kind](jparams, jcfg, *map(jnp.asarray, args), jcache, **kw)
    rows = _VALID[kind]
    assert torch.equal(exe.logits[rows], eager[rows])
    np.testing.assert_allclose(exe.logits.numpy()[rows], np.asarray(jl)[rows], atol=ATOL,
                               rtol=0)
    for li in range(cfg.num_layers):
        for key, t in cache[li].items():
            assert torch.equal(t, eager_cache[li][key])
            atol = 1.0 if key in ("k", "v") and cache_dtype == "int8" else ATOL
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(jcache[li][key]).astype(np.float32),
                                       atol=atol, rtol=0)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("kind", ["prefill", "chunk", "mixed"])
def test_the_step_bodies_read_nothing_back(model, kind, cache_dtype):
    """The steps the graphs capture, with their drop-mode KV writes, run
    without one host read (the kernel wrappers' path: attn_impl "cuda"
    runs their plain versions here), and the padding run that precedes a
    capture leaves the cache as it was."""
    _, cache, first = _caches(model, cache_dtype)
    a = _inputs(kind, np.random.default_rng(4), first)
    graphs = _step_graphs(model, cache[0], attn_impl="cuda")
    exe = graphs.get(*_key(kind, a))
    before = [{k: t.clone() for k, t in e.items()} for e in cache[0]]
    with _NoHostReads():
        exe.pad_run()
        for e, b in zip(cache[0], before):
            assert all(torch.equal(e[k], b[k]) for k in e)
        exe.load(_stage(exe, a))
        exe.run()
    assert torch.isfinite(exe.logits).all()


def test_padding_rows_of_a_prefill_write_only_their_batch_rows(model):
    """A prefill batch of lengths 11 and 3 padded to (4, 16): every slot
    outside the two prompts keeps its value, though every row is written
    (padding rows rewrite the first real row's slot with its own KV)."""
    cc = kv_cache.CacheConfig(block_size=BS, num_blocks=NB, max_blocks_per_seq=MB,
                              dtype="float32")
    cache = kv_cache.create_kv_cache(model[2], cc, "cpu")
    for e in cache:
        for t in e.values():
            t.fill_(7.0)
    a = _prefill_inputs(np.random.default_rng(9), (11, 3), 16, 4)
    graphs = _step_graphs(model, cache)
    exe = graphs.get("prefill", 4, 16)
    exe.load(_stage(exe, a))
    exe.run()
    written = np.concatenate([_slots(0, 0, 11), _slots(1, 0, 3)])
    for e in cache:
        flat = e["k"].reshape(NB * BS, -1)
        untouched = np.setdiff1d(np.arange(NB * BS), written)
        assert (flat[untouched] == 7.0).all()
        assert not (flat[written] == 7.0).all(dim=-1).any()


# ---- Engine.warmup's defaults against the JAX engine's ---------------------

CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=24, dtype="float32")


def _conf(mod, sched, **kw):
    return mod.EngineConfig(model="tiny-qwen3", cache=mod.CacheConfig(**CACHE),
                            scheduler=mod.SchedulerConfig(**sched), **kw)


def _port(model, sched, **kw):
    _, _, cfg, params = model
    return Engine(_conf(port_rt, sched, **kw), params=params, model_cfg=cfg, device="cpu")


def _jax(model, sched, **kw):
    jcfg, jparams, _, _ = model
    kw = dict(dict(attn_impl="reference", kv_tiers=False, slo_classes=False), **kw)
    return jax_rt.Engine(_conf(jax_rt, sched, **kw), params=jparams, model_cfg=jcfg)


@pytest.mark.parametrize("mixed", [False, True])
def test_default_warmup_makes_the_jax_engines_step_shapes(model, mixed):
    """``warmup()`` with no arguments makes exactly the prefill, chunk and
    mixed shapes the JAX engine's ``warmup()`` compiles on the same
    config (its ``_exec_*`` calls recorded on the instance): the minimum
    prefill bucket at batch 1 and the full chunk when sequences can
    outgrow it; under mixed batching the flat-token ladder and neither of
    the others.  The port also warms the whole decode ladder."""
    sched = dict(max_num_seqs=4, max_prefill_tokens=64, min_prefill_bucket=8,
                 min_decode_bucket=2, prefill_chunk_size=16, mixed_batching=mixed,
                 mixed_token_budget=32)
    jeng = _jax(model, sched)
    seen = set()

    def spy(name, key):
        orig = getattr(jeng, name)

        def call(tokens, *args, **kw):
            seen.add(key(tokens.shape))
            return orig(tokens, *args, **kw)
        setattr(jeng, name, call)
    spy("_exec_prefill", lambda s: ("prefill", *s))
    spy("_exec_prefill_chunk", lambda s: ("chunk", s[1]))
    spy("_exec_forward_ragged", lambda s: ("mixed", s[0]))
    jeng.warmup()
    eng = _port(model, sched)
    eng.warmup()
    made = set(eng.graphs.executables)
    assert {k for k in made if k[0] != "decode"} == seen
    assert seen == ({("mixed", 8), ("mixed", 16), ("mixed", 32)} if mixed
                    else {("prefill", 1, 8), ("chunk", 16)})
    assert {k for k in made if k[0] == "decode"} == {
        ("decode", B, m) + x for B in (2, 4) for m in ("greedy", "temperature", "full")
        for x in ((), ("logprobs",), ("penalties",))}
    eng.warmup(prefill_buckets=[], chunk_buckets=[], mixed_buckets=[], decode_buckets=[])
    assert set(eng.graphs.executables) == made


def test_every_dispatch_takes_a_key_the_engine_can_size_for(model):
    """The keys the cache sizing counts (``Engine._step_keys``) hold every
    executable a served mix makes: prompts of 1 to 40 tokens, chunked and
    batched, then mixed."""
    for mixed in (False, True):
        sched = dict(max_num_seqs=4, max_prefill_tokens=64, min_prefill_bucket=8,
                     min_decode_bucket=2, prefill_chunk_size=16, mixed_batching=mixed,
                     mixed_token_budget=32)
        eng = _port(model, sched, multi_step=4)
        rng = np.random.default_rng(12)
        eng.generate([rng.integers(3, 200, n).tolist() for n in (1, 5, 9, 17, 40, 33, 2)],
                     SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True))
        keys = set(eng._step_keys(eng.scheduler.cfg, eng.max_seq_len))
        assert set(eng.graphs.executables) <= keys
        assert {k[0] for k in eng.graphs.executables} == (
            {"mixed", "decode"} if mixed else {"prefill", "chunk", "decode"})


# ---- adaptive window sizing against the JAX engine -------------------------

ADAPTIVE = dict(multi_step=8, min_multi_step=4, adaptive_window_hold_s=0.5)
SCHED = dict(max_num_seqs=8, max_prefill_tokens=256, min_prefill_bucket=8, min_decode_bucket=2)
SP = dict(max_tokens=40, temperature=0.0, ignore_eos=True)


def _windows(eng):
    """Record each window size ``_window_steps`` gives ``eng``."""
    sizes, orig = [], eng._window_steps

    def spy():
        sizes.append(orig())
        return sizes[-1]
    eng._window_steps = spy
    return sizes


def _arrivals(eng, sp_cls, clock, prompts):
    """Two prompts into an idle engine; a third after the third step, while
    they decode; drain; then two more into the idle engine and drain.  The
    clock moves 0.1 s a step.  Each request's tokens, in order."""
    p = sp_cls(**SP)
    rids = [eng.add_request(prompt_token_ids=x, params=p) for x in prompts[:2]]
    n = 0
    while eng.has_work():
        eng.step()
        clock.advance(0.1)
        n += 1
        if n == 3:
            rids.append(eng.add_request(prompt_token_ids=prompts[2], params=p))
    clock.advance(1.0)
    rids += [eng.add_request(prompt_token_ids=x, params=p) for x in prompts[3:]]
    while eng.has_work():
        eng.step()
        clock.advance(0.1)
    return [eng.requests[r].output_token_ids for r in rids]


@pytest.mark.parametrize("pipelined", [False, True])
def test_adaptive_windows_match_jax(model, pipelined):
    """multi_step 8, min_multi_step 4: an arrival into the busy engine
    shrinks the next windows to 4 tokens for adaptive_window_hold_s, then
    they return to 8; arrivals into the idle engine shrink nothing.  The
    window sizes equal the JAX engine's, and the greedy streams equal the
    JAX engine's and the port's single-step run's."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(3, 200, n).tolist() for n in (9, 14, 6, 11, 7)]
    clock, jclock = VirtualClock(), JaxVirtualClock()
    eng = _port(model, SCHED, pipeline_decode=pipelined, clock=clock, **ADAPTIVE)
    jeng = _jax(model, dict(SCHED, allow_chunked_prefill=False), pipeline_decode=pipelined,
                clock=jclock, **ADAPTIVE)
    ours, ref = _windows(eng), _windows(jeng)
    got = _arrivals(eng, SamplingParams, clock, prompts)
    want = _arrivals(jeng, jax_rt.SamplingParams, jclock, prompts)
    single = _arrivals(_port(model, SCHED, multi_step=1, clock=VirtualClock()), SamplingParams,
                       VirtualClock(), prompts)
    assert ours == ref
    assert got == want == single
    assert all(len(t) == 40 for t in got)
    first4 = ours.index(4)
    # the busy arrival shrinks the windows until the hold ends, then 8 again
    assert ours[:first4] == [8] * first4 and first4 >= 1
    assert 8 in ours[first4:]
    shrunk = ours[first4:ours.index(8, first4)]
    assert shrunk == [4] * len(shrunk) and 2 <= len(shrunk) <= 6
    # the idle arrivals' windows stay full (their own windows: the last ones)
    assert ours[-3:] == [8, 8, 8]
    assert 4 not in ours[ours.index(8, first4):]


def test_adaptive_sizing_is_off_unless_multi_step_exceeds_its_floor(model):
    eng = _port(model, SCHED, multi_step=4, clock=VirtualClock())
    assert not eng._adaptive_window and eng._min_multi_step == 4
    eng.add_request(prompt_token_ids=[5, 6, 7], params=SamplingParams(**SP))
    eng.step()
    eng.add_request(prompt_token_ids=[8, 9], params=SamplingParams(**SP))
    assert eng._last_busy_arrival == float("-inf") and eng._window_steps() == 4
    assert not _port(model, SCHED)._adaptive_window            # the CPU's multi_step 1
    off = _port(model, SCHED, multi_step=8, adaptive_multi_step=False)
    assert not off._adaptive_window and off._window_steps() == 8
