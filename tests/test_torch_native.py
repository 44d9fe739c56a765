"""The port's C++ block manager (``tpuserve_torch.native``) on the CPU.

One seeded op trace drives three managers: the port's
``NativeBlockManager``, the port's Python ``BlockManager`` and the JAX
package's Python ``BlockManager``; every observable (allocated blocks,
slots, tables, shortfalls, admission picks, evictions in order, restore
assignments, free and cached counts, raised errors) must be equal.  Chain
hash values are the one exception: Python ``hash()`` in the Python
managers (equal to each other), FNV-1a in C++, so the tier trace keys a
simulated store per manager by its own hashes.  The traces are the JAX
package's ``tests/test_native.py`` differentials (plain, batched, tier,
window release), plus ``ngram_propose`` against the JAX pure-Python
proposer, the factory's rules, the engine's manager, greedy tokens under
both managers against the JAX engine, a tier spill and restore under the
native manager, writes through a pinned ``Staging`` view, and the C ABI.

g++ builds the extension into ``build/tpuserve_torch/`` at first use;
without g++ these tests skip (the engine then keeps the Python manager).
"""

import ctypes
import dataclasses
import random
import shutil

import jax
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve.models.config import get_model_config as jax_get_model_config
from tpuserve.runtime.block_manager import BlockManager as JaxBlockManager
from tpuserve.runtime.spec import _ngram_propose_py as jax_ngram_py
from tpuserve_torch import native
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SamplingParams
from tpuserve_torch.runtime import SchedulerConfig
from tpuserve_torch.runtime import spec as port_spec
from tpuserve_torch.runtime.block_manager import BlockManager, create_block_manager
from tpuserve_torch.runtime.graphs import Staging

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++: the engine keeps the Python block manager")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Trio:
    """The port's native and Python managers and the JAX Python one, driven
    with the same calls; each call's results (or error types) must agree."""

    def __init__(self, num_blocks, block_size, prefix=True):
        self.cc = native.NativeBlockManager(num_blocks, block_size,
                                            enable_prefix_caching=prefix)
        self.py = BlockManager(num_blocks, block_size, enable_prefix_caching=prefix)
        self.jx = JaxBlockManager(num_blocks, block_size, enable_prefix_caching=prefix)
        self.all = (self.cc, self.py, self.jx)

    def call(self, name, *args, same=True, **kw):
        outs = []
        for bm in self.all:
            try:
                outs.append(getattr(bm, name)(*args, **kw))
            except (MemoryError, KeyError, ValueError, IndexError, AssertionError) as e:
                outs.append(type(e))
        if same:
            assert outs[0] == outs[1] == outs[2], (name, args, outs)
        return outs

    def check(self):
        for attr in ("num_free_blocks", "num_cached_blocks", "num_restoring_blocks",
                     "prefix_hits", "prefix_queries"):
            vals = [getattr(bm, attr) for bm in self.all]
            assert vals[0] == vals[1] == vals[2], (attr, vals)
        assert self.cc.num_seqs() == self.py.num_seqs() == self.jx.num_seqs()


def _alloc(t: Trio, sid, toks):
    shared = t.call("lookup_prefix", toks)[0][0]
    outs = t.call("allocate", sid, toks, shared_blocks=shared, same=False)
    if isinstance(outs[0], type):
        assert outs[0] is outs[1] is outs[2], outs
        return False
    assert outs[0].blocks == outs[1].blocks == outs[2].blocks
    return True


def test_randomized_op_trace():
    rng = random.Random(0)
    t = Trio(48, 4)
    live, next_id = [], 0
    for _step in range(800):
        op = rng.random()
        if op < 0.35:
            toks = [rng.randrange(16) for _ in range(rng.randrange(1, 20))]
            sid = f"s{next_id}"
            next_id += 1
            if _alloc(t, sid, toks):
                live.append(sid)
        elif op < 0.75 and live:
            sid = rng.choice(live)
            t.call("needs_new_block", sid)
            t.call("append_slot", sid)
        elif op < 0.85 and live:
            sid = rng.choice(live)
            t.call("release_out_of_window", sid, rng.randrange(0, 40))
            t.call("block_table", sid)
        elif live:
            t.call("free", live.pop(rng.randrange(len(live))))
        t.check()
    for sid in live:
        t.call("block_table", sid)


def test_randomized_batched_op_trace():
    rng = random.Random(7)
    t = Trio(64, 4)
    live, next_id = [], 0
    for step in range(600):
        op = rng.random()
        if op < 0.25:
            counts = [rng.randrange(1, 40) for _ in range(rng.randrange(1, 9))]
            picked = t.call("admit_prefill", counts, rng.randrange(1, 9),
                            rng.choice([64, 256, 8192]), 8)[0]
            for _ in range(picked[0]):
                sid = f"s{next_id}"
                next_id += 1
                if not _alloc(t, sid, [rng.randrange(16) for _ in range(counts.pop(0))]):
                    break
                live.append(sid)
        elif op < 0.55 and live:
            rows = rng.sample(live, rng.randrange(1, len(live) + 1))
            t.call("decode_shortfall", rows)
            slots = [np.full((len(rows),), -7, np.int32) for _ in t.all]
            res = [bm.charge_decode(rows, s) for bm, s in zip(t.all, slots)]
            assert res[0] == res[1] == res[2], step
            assert slots[0].tolist() == slots[1].tolist() == slots[2].tolist(), step
            tables = [np.zeros((len(rows), 24), np.int32) for _ in t.all]
            res = [bm.fill_block_tables(rows, tb) for bm, tb in zip(t.all, tables)]
            assert res[0] == res[1] == res[2], step
            assert tables[0].tolist() == tables[1].tolist() == tables[2].tolist(), step
        elif op < 0.7 and live:
            rows = rng.sample(live, rng.randrange(1, len(live) + 1))
            window = rng.randrange(1, 9)
            totals = [t.py._seqs[sid].num_tokens + window for sid in rows]
            if t.call("reserve_batch", rows, totals)[0]:
                t.call("advance_batch", rows, window)
        elif live:
            t.call("free", live.pop(rng.randrange(len(live))),
                   cache_blocks=rng.random() < 0.7)
        t.check()
    for sid in live:
        t.call("block_table", sid)
    t.py.check_integrity(expected_seq_ids=live)


def test_randomized_tier_op_trace():
    """Demote / restore under pressure: which blocks evict and in what
    order, the restore's block assignments and the lookups after it.  Each
    manager keys its own simulated tier store by its own chain hashes."""
    rng = random.Random(21)
    t = Trio(40, 4)
    for bm in t.all:
        bm.record_evictions = True
    tiers = [dict() for _ in t.all]
    prompts, live, next_id = [], [], 0
    for step in range(600):
        op = rng.random()
        if op < 0.3:
            toks = [rng.randrange(12) for _ in range(rng.randrange(4, 32))]
            sid = f"s{next_id}"
            next_id += 1
            if _alloc(t, sid, toks):
                live.append(sid)
                prompts.append(toks)
        elif op < 0.5 and live:
            rows = rng.sample(live, rng.randrange(1, len(live) + 1))
            slots = [np.zeros((len(rows),), np.int32) for _ in t.all]
            res = [bm.charge_decode(rows, s) for bm, s in zip(t.all, slots)]
            assert res[0] == res[1] == res[2], step
            assert slots[0].tolist() == slots[1].tolist() == slots[2].tolist(), step
        elif op < 0.7 and prompts:
            toks = rng.choice(prompts)
            chains = t.call("prefix_chain", toks, same=False)
            # the two Python managers hash alike; C++ uses FNV-1a
            assert chains[1] == chains[2] and len(chains[0]) == len(chains[1]), step
            k = len(t.call("lookup_prefix", toks, count_stats=False)[0][0])
            spans = []
            for ch, tier in zip(chains, tiers):
                span = []
                while k + len(span) < len(ch) and ch[k + len(span)] in tier:
                    span.append(ch[k + len(span)])
                spans.append(span)
            assert len(spans[0]) == len(spans[1]) == len(spans[2]), step
            if spans[0]:
                got = [bm.begin_restore(sp) for bm, sp in zip(t.all, spans)]
                assert got[0] == got[1] == got[2], step
                if got[0] is not None:
                    for sp, tier in zip(spans, tiers):
                        for h in sp:
                            del tier[h]
                    if rng.random() < 0.15:          # a failed copy
                        for bm, b in zip(t.all, got):
                            bm.abort_restore(b)
                    else:
                        n = [bm.commit_restore(sp, b) for bm, sp, b in zip(t.all, spans, got)]
                        assert n[0] == n[1] == n[2], step
                        t.call("lookup_prefix", toks, count_stats=False)
        elif live:
            t.call("free", live.pop(rng.randrange(len(live))),
                   cache_blocks=rng.random() < 0.8)
        # eviction logs drained in lockstep: the same blocks in the same
        # order (the LRU order is the demotion order)
        evs = [bm.take_evictions() for bm in t.all]
        assert [b for b, _ in evs[0]] == [b for b, _ in evs[1]] == [b for b, _ in evs[2]], step
        assert evs[1] == evs[2], step
        for ev, tier in zip(evs, tiers):
            for _b, h in ev:
                tier[h] = True
        t.check()
    t.py.check_integrity(expected_seq_ids=live, tier_hashes=list(tiers[1]))


@pytest.mark.parametrize("prefix", [False, True])
def test_window_release_parity(prefix):
    t = Trio(16, 4, prefix=prefix)
    t.call("allocate", "s", list(range(20)), same=False)
    for first_needed in (13, 13, 17, 5, 21):
        t.call("release_out_of_window", "s", first_needed)
        t.call("block_table", "s")
        t.check()
    t.call("slot_for_token", "s", 2)          # a released slot: IndexError
    t.call("slot_for_token", "s", 19)
    t.call("free", "s")
    t.check()


def test_reserve_advance_and_errors_parity():
    t = Trio(16, 4, prefix=False)
    t.call("allocate", "s", [1, 2, 3, 4, 5], same=False)
    t.call("reserve", "s", 11)
    for idx in (5, 8, 10, -1):
        t.call("slot_for_token", "s", idx)
    t.call("advance", "s", 3)
    t.call("advance", "s", 100)
    t.call("append_slot", "s")
    t.call("allocate", "s", [1], same=False)       # duplicate: AssertionError
    t.call("append_slot", "nope")
    t.call("free", "s")
    t.check()
    t.call("allocate", "big", list(range(100)), same=False)   # MemoryError
    t.check()


def test_ngram_propose_matches_the_jax_python_proposer():
    rng = np.random.default_rng(0)
    for _ in range(300):
        vocab = int(rng.integers(2, 12))
        ids = rng.integers(0, vocab, size=int(rng.integers(0, 200))).tolist()
        k = int(rng.integers(1, 8))
        max_n = int(rng.integers(1, 5))
        min_n = int(rng.integers(1, max_n + 1))
        lookback = int(rng.integers(1, 64))
        want = jax_ngram_py(ids, k, max_n, min_n, lookback)
        assert native.ngram_propose(ids, k, max_n, min_n, lookback) == want
        assert port_spec._ngram_propose_py(ids, k, max_n, min_n, lookback) == want
    port_spec._propose_impl = None
    assert port_spec.ngram_propose([1, 2, 3, 9, 9, 1, 2, 3], 3) == [9, 9, 1]
    assert port_spec._propose_impl is native.ngram_propose


def test_the_factory_follows_the_jax_rules(monkeypatch):
    monkeypatch.delenv("TPUSERVE_BLOCK_MANAGER", raising=False)
    monkeypatch.delenv("TPUSERVE_STRICT_BLOCKS", raising=False)
    assert isinstance(create_block_manager(8, 4), native.NativeBlockManager)
    assert isinstance(create_block_manager(8, 4, impl="native"), native.NativeBlockManager)
    assert isinstance(create_block_manager(8, 4, impl="python"), BlockManager)
    monkeypatch.setenv("TPUSERVE_STRICT_BLOCKS", "1")
    assert isinstance(create_block_manager(8, 4), BlockManager)
    assert isinstance(create_block_manager(8, 4, impl="native"), native.NativeBlockManager)
    monkeypatch.delenv("TPUSERVE_STRICT_BLOCKS")
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", "python")
    assert isinstance(create_block_manager(8, 4, impl="native"), BlockManager)
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", "native")
    assert isinstance(create_block_manager(8, 4, impl="python"), native.NativeBlockManager)
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", "rust")
    with pytest.raises(ValueError):
        create_block_manager(8, 4)
    monkeypatch.delenv("TPUSERVE_BLOCK_MANAGER")
    # no toolchain: auto falls back, an explicit native raises
    monkeypatch.setattr(native, "native_available", lambda: False)
    assert isinstance(create_block_manager(8, 4), BlockManager)
    with pytest.raises(RuntimeError):
        create_block_manager(8, 4, impl="native")


def test_native_writes_through_a_pinned_staging_view():
    """The engine's batched calls fill rows of one staging tensor in place:
    the result must be readable from the tensor, not from a copy."""
    st = Staging((("tokens", (4, 1), 0), ("slots", (4,), -1), ("block_tables", (4, 6), 0)),
                 pinned=False)
    bm = native.NativeBlockManager(32, 4)
    py = BlockManager(32, 4)
    for m in (bm, py):
        m.allocate("a", list(range(7)))
        m.allocate("b", list(range(100, 113)))
    want_slots = np.zeros((2,), np.int32)
    assert py.charge_decode(["a", "b"], want_slots) == 0
    assert bm.charge_decode(["a", "b"], st.slots[:2]) == 0
    want_tables = np.zeros((2, 6), np.int32)
    py.fill_block_tables(["a", "b"], want_tables)
    bm.fill_block_tables(["a", "b"], st.block_tables[:2])
    flat = st.tensor.numpy()
    assert flat[4:6].tolist() == want_slots.tolist() and flat[6:8].tolist() == [-1, -1]
    assert flat[8:20].reshape(2, 6).tolist() == want_tables.tolist()
    assert st.tensor[8:20].view(2, 6).tolist() == want_tables.tolist()
    with pytest.raises(ValueError):         # a strided view cannot be filled in place
        bm.fill_block_tables(["a"], st.block_tables[:, ::2])


def test_the_c_abi_matches_the_python_manager():
    lib = ctypes.CDLL(str(native.build_c_abi()))
    lib.bm_create.restype = ctypes.c_void_p
    lib.bm_create.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int]
    lib.bm_destroy.argtypes = [ctypes.c_void_p]
    lib.bm_num_free_blocks.restype = ctypes.c_int32
    lib.bm_num_free_blocks.argtypes = [ctypes.c_void_p]
    lib.bm_allocate.restype = ctypes.c_int64
    lib.bm_allocate.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64]
    lib.bm_append_slot.restype = ctypes.c_int64
    lib.bm_append_slot.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bm_slot_for_token.restype = ctypes.c_int64
    lib.bm_slot_for_token.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.bm_free_seq.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    h = lib.bm_create(16, 4, 1)
    py = BlockManager(16, 4)
    tokens = list(range(10))
    out = (ctypes.c_int32 * 16)()
    n = lib.bm_allocate(h, b"s1", (ctypes.c_int32 * 10)(*tokens), 10, None, 0, out, 16)
    assert list(out[:n]) == py.allocate("s1", tokens).blocks
    for _ in range(6):
        assert lib.bm_append_slot(h, b"s1") == py.append_slot("s1")
    assert lib.bm_slot_for_token(h, b"s1", 7) == py.slot_for_token("s1", 7)
    assert lib.bm_slot_for_token(h, b"s1", -1) == -3
    lib.bm_free_seq(h, b"s1")
    py.free("s1")
    assert lib.bm_num_free_blocks(h) == py.num_free_blocks
    lib.bm_destroy(h)


# ---- the engine ----------------------------------------------------------

CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16, dtype="float32")
SCHED = dict(max_num_seqs=8, min_prefill_bucket=8, min_decode_bucket=2)
PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12, 13], [40, 41, 42], [5, 6, 7, 8, 9, 10, 11, 12, 14],
           list(range(100, 130))]


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_get_model_config("tiny-qwen3"), dtype="float32")
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _port(weights, impl, monkeypatch, **kw):
    """An engine whose block manager ``TPUSERVE_BLOCK_MANAGER=impl`` picks."""
    _, _, cfg, params = weights
    kw.setdefault("cache", CacheConfig(**CACHE))
    monkeypatch.setenv("TPUSERVE_BLOCK_MANAGER", impl)
    return Engine(EngineConfig(model="tiny-qwen3", scheduler=SchedulerConfig(**SCHED), **kw),
                  params=params, model_cfg=cfg, device="cpu")


def test_the_engine_holds_the_native_manager(weights, monkeypatch):
    monkeypatch.delenv("TPUSERVE_STRICT_BLOCKS", raising=False)
    assert isinstance(_port(weights, "auto", monkeypatch).block_manager, native.NativeBlockManager)
    assert isinstance(_port(weights, "python", monkeypatch).block_manager, BlockManager)
    # the strict check steers auto to Python, and skips an explicit native
    monkeypatch.setenv("TPUSERVE_STRICT_BLOCKS", "1")
    assert isinstance(_port(weights, "auto", monkeypatch).block_manager, BlockManager)
    eng = _port(weights, "native", monkeypatch)
    assert isinstance(eng.block_manager, native.NativeBlockManager)
    eng.generate([PROMPTS[0]], SamplingParams(max_tokens=4, temperature=0.0))


def test_greedy_tokens_equal_under_both_managers_and_the_jax_engine(weights, monkeypatch):
    monkeypatch.delenv("TPUSERVE_BLOCK_MANAGER", raising=False)
    jcfg, jparams, _, _ = weights
    sp = dict(max_tokens=12, temperature=0.0, ignore_eos=True)
    outs = {}
    for impl in ("native", "python"):
        eng = _port(weights, impl, monkeypatch, multi_step=4)
        outs[impl] = [o.output_token_ids for o in eng.generate(PROMPTS, SamplingParams(**sp))]
        # a second round hits the prefix cache
        outs[impl] += [o.output_token_ids for o in eng.generate(PROMPTS, SamplingParams(**sp))]
        assert eng.block_manager.prefix_hits > 0
    jeng = jax_rt.Engine(jax_rt.EngineConfig(
        model="tiny-qwen3", cache=jax_rt.CacheConfig(**CACHE),
        scheduler=jax_rt.SchedulerConfig(**SCHED), attn_impl="reference", multi_step=4,
        pipeline_decode=False), params=jparams, model_cfg=jcfg)
    want = [o.output_token_ids for o in jeng.generate(PROMPTS, jax_rt.SamplingParams(**sp))]
    assert outs["native"] == outs["python"] == want + want


@pytest.mark.parametrize("tier", ["host", "spill"])
def test_a_tier_spill_and_restore_under_the_native_manager(weights, tier, tmp_path,
                                                           monkeypatch):
    """A cached prefix churned out of a small cache is demoted (to host
    memory, or with a zero host budget on to the spill directory), restored
    by the native manager's own chain hashes, and serves the same tokens as
    a twin under the Python manager."""
    monkeypatch.delenv("TPUSERVE_BLOCK_MANAGER", raising=False)
    sp = SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)
    prefix = list(range(2, 26))
    got = {}
    for impl in ("native", "python"):
        eng = _port(weights, impl, monkeypatch, cache=CacheConfig(block_size=4, num_blocks=24,
                                                     max_blocks_per_seq=16, dtype="float32"),
                    kv_host_bytes=1 if tier == "spill" else 0,
                    kv_spill_dir=str(tmp_path / impl) if tier == "spill" else None)
        first = eng.generate([prefix + [30]], sp)[0].output_token_ids
        eng.generate([[100 + i] * 40 for i in range(3)], sp)            # churn
        again = eng.generate([prefix + [77]], sp)[0].output_token_ids
        got[impl] = (first, again, eng.stats.kv_restores > 0,
                     eng.stats.kv_spilled_blocks > 0 if tier == "spill" else True)
    assert got["native"] == got["python"]
    assert got["native"][2] and got["native"][3]
