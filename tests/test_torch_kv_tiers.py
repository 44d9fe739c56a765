"""The port's tiered KV cache on the CPU, against the JAX package's.

The tier store (``runtime/kv_tiers.py``) case by case as
tests/test_kv_tiers.py holds the JAX one, and spill files read across the
two packages; the block manager's eviction log and restore API under one
op trace in both; the page copies (``kv_cache.gather_block_pages`` /
``scatter_block_pages``) on bf16 and int8 caches against the JAX functions,
the scatter writing the cache's own tensors; the engine's demote / restore
cases on float32 tiny-qwen3 with the same weights in both engines and
``TPUSERVE_STRICT_BLOCKS=1``, tokens and tier counters equal; the prefix
digest against the JAX tracker; and the server's ``/healthz`` fields,
metric families and CLI flags.
"""

import dataclasses
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve.runtime import kv_cache as jax_kv
from tpuserve.runtime.block_manager import BlockManager as JaxBlockManager
from tpuserve.runtime.kv_tiers import TieredPageStore as JaxStore
from tpuserve.runtime.kv_tiers import pages_nbytes as jax_pages_nbytes
from tpuserve.server import kv_digest as jax_digest
from tpuserve_torch import runtime as port_rt
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime import kv_cache as port_kv
from tpuserve_torch.runtime.block_manager import BlockManager
from tpuserve_torch.runtime.kv_tiers import TieredPageStore, pages_nbytes
from tpuserve_torch.server import kv_digest as port_digest


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pages(nbytes=64, dtype=torch.int8):
    return [{"k": torch.arange(nbytes).to(dtype)}]


# ---------------------------------------------------------------------------
# the tier store: tests/test_kv_tiers.py's cases on the port's store
# ---------------------------------------------------------------------------

def test_store_budget_cascades_to_spill(tmp_path):
    st = TieredPageStore(host_bytes=200, spill_dir=str(tmp_path))
    for h in range(5):                      # 5 x 64B > 200B budget
        st.put(h, _pages())
    assert st.host_count + st.spill_count == 5
    assert st.host_bytes_used <= 200
    assert st.spill_count >= 2 and st.spilled_blocks == st.spill_count
    st.flush()                              # writes land off-thread
    assert len(os.listdir(tmp_path)) == st.spill_count
    assert all(st.has(h) for h in range(5))
    assert st.writer_tensor_pages == 0      # the writer held numpy only


def test_store_drops_without_spill_dir():
    st = TieredPageStore(host_bytes=200, spill_dir=None)
    for h in range(5):
        st.put(h, _pages())
    assert st.host_count <= 3
    assert st.dropped_blocks == 5 - st.host_count
    assert st.spill_count == 0


def test_store_take_removes_from_exactly_one_tier(tmp_path):
    st = TieredPageStore(host_bytes=200, spill_dir=str(tmp_path))
    for h in range(5):
        st.put(h, _pages())
    st.flush()
    for h in range(5):
        where = st.where(h)
        pages = st.take(h)
        assert pages is not None and pages[0]["k"].dtype == torch.int8
        assert torch.equal(pages[0]["k"], _pages()[0]["k"])
        assert not st.has(h), f"hash {h} still resolvable after take"
        if where == "spill":
            assert not os.path.exists(st._spill_path(h))
    assert len(st) == 0 and st.host_bytes_used == 0


def test_store_spill_roundtrips_bfloat16(tmp_path):
    st = TieredPageStore(host_bytes=1, spill_dir=str(tmp_path))
    a = torch.arange(8, dtype=torch.float32).to(torch.bfloat16) / 3
    st.put(7, [{"k": a}])
    st.flush()           # the real .npz round trip, not the pending map
    assert st._spill
    out = st.take(7)
    assert out is not None and out[0]["k"].dtype == torch.bfloat16
    assert torch.equal(out[0]["k"].view(torch.int16), a.view(torch.int16))


def test_store_pending_spill_entries_are_pageable_numpy(tmp_path):
    """What the writer thread gets: numpy copies made on the loop thread,
    never the host tier's tensors (pinned on a card)."""
    st = TieredPageStore(host_bytes=64, spill_dir=str(tmp_path))
    pages = _pages()
    st.put(1, pages)
    st.put(2, _pages())                     # cascades 1 to spill
    with st._lock:
        flat = st._spill_pending.get(1)
    if flat is not None:                    # else already written
        assert all(isinstance(a, np.ndarray) for a in flat.values())
        assert not any(np.shares_memory(a, pages[0]["k"].numpy()) for a in flat.values())
    st.flush()
    assert st.writer_tensor_pages == 0


def test_store_unreadable_spill_is_a_miss(tmp_path):
    st = TieredPageStore(host_bytes=1, spill_dir=str(tmp_path))
    st.put(3, _pages())
    st.flush()
    assert st.where(3) == "spill"
    with open(st._spill_path(3), "wb") as f:
        f.write(b"corrupt")
    dropped = st.dropped_blocks
    assert st.take(3) is None               # the caller recomputes
    assert not st.has(3)
    assert st.dropped_blocks == dropped + 1  # the KV was LOST


def test_store_rescan_survives_restart(tmp_path):
    st = TieredPageStore(host_bytes=1, spill_dir=str(tmp_path))
    st.put(11, _pages())
    st.put(1 << 63 | 5, _pages())           # high-bit (native-style) hash
    st.flush()
    st2 = TieredPageStore(host_bytes=1, spill_dir=str(tmp_path))
    assert st2.has(11) and st2.has(1 << 63 | 5)
    out = st2.take(11)
    assert out is not None and out[0]["k"].dtype == torch.int8
    assert st2.take(1 << 63 | 5) is not None


def test_store_rescan_enforces_cap(tmp_path):
    st = TieredPageStore(host_bytes=1, spill_dir=str(tmp_path))
    for h in range(6):
        st.put(h, _pages())
    st.flush()
    TieredPageStore(host_bytes=1, spill_dir=str(tmp_path), max_spill_entries=3)
    assert len(os.listdir(tmp_path)) == 3   # oldest trimmed at rescan


# ---------------------------------------------------------------------------
# spill files across the two packages
# ---------------------------------------------------------------------------

def _bf16_block(seed=0):
    """One block's pages of a 2-layer bf16 cache with int8-style scales:
    float32 numpy values, and each package's bf16 of them."""
    rng = np.random.default_rng(seed)
    vals = [{"k": rng.standard_normal((4, 2, 16)).astype(np.float32),
             "v": rng.standard_normal((4, 2, 16)).astype(np.float32),
             "ks": rng.random((4, 2)).astype(np.float32)} for _ in range(2)]
    jax_pages = [{k: (np.asarray(jnp.asarray(a, jnp.bfloat16)) if k != "ks" else a)
                  for k, a in layer.items()} for layer in vals]
    port_pages = [{k: (torch.from_numpy(a).to(torch.bfloat16) if k != "ks"
                       else torch.from_numpy(a)) for k, a in layer.items()}
                  for layer in vals]
    return jax_pages, port_pages


def _bits(a):
    """The raw bits of a page of either package, as numpy."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def test_a_jax_spill_file_reads_bit_equal_in_the_port(tmp_path):
    jax_pages, port_pages = _bf16_block(1)
    js = JaxStore(host_bytes=1, spill_dir=str(tmp_path))
    js.put(42, jax_pages)
    js.flush()
    ps = TieredPageStore(host_bytes=1, spill_dir=str(tmp_path))   # rescans
    out = ps.take(42)
    assert out is not None and not os.listdir(tmp_path)
    for li in range(2):
        assert out[li]["k"].dtype == torch.bfloat16 and out[li]["ks"].dtype == torch.float32
        for k in ("k", "v", "ks"):
            np.testing.assert_array_equal(_bits(out[li][k]), _bits(jax_pages[li][k]))
            assert torch.equal(out[li][k], port_pages[li][k])


def test_a_port_spill_file_reads_bit_equal_in_jax(tmp_path):
    jax_pages, port_pages = _bf16_block(2)
    ps = TieredPageStore(host_bytes=1, spill_dir=str(tmp_path))
    ps.put(-7, port_pages)                  # a negative Python hash
    ps.flush()
    js = JaxStore(host_bytes=1, spill_dir=str(tmp_path))
    out = js.take(-7)
    assert out is not None
    for li in range(2):
        assert out[li]["k"].dtype == jax_pages[li]["k"].dtype
        for k in ("k", "v", "ks"):
            np.testing.assert_array_equal(_bits(out[li][k]), _bits(jax_pages[li][k]))


# ---------------------------------------------------------------------------
# the block manager's tier state machine
# ---------------------------------------------------------------------------

def _evicted_pair(BM):
    bm = BM(8, 4)
    bm.record_evictions = True
    bm.allocate("a", list(range(8)))        # 2 hashed blocks
    bm.free("a")
    bm.allocate("fill", [9] * 32)           # evicts both cached blocks
    ev = bm.take_evictions()
    bm.free("fill", cache_blocks=False)
    return bm, ev


def test_restore_in_flight_blocks_unevictable_and_uncharged():
    bm, ev = _evicted_pair(BlockManager)
    assert len(ev) == 2
    hashes = [h for _, h in ev]
    blocks = bm.begin_restore(hashes)
    assert blocks is not None and bm.num_restoring_blocks == 2
    assert bm.num_free_blocks == 6
    bm.allocate("b", [5] * 24)              # takes all 6 remaining
    assert bm.num_free_blocks == 0
    with pytest.raises(MemoryError):
        bm.allocate("c", [6] * 4)
    assert set(blocks) & set(bm._seqs["b"].blocks) == set()
    bm.check_integrity(expected_seq_ids=["b"], tier_hashes=[])
    assert bm.commit_restore(hashes, blocks) == 2
    assert bm.num_restoring_blocks == 0
    sh, cached = bm.lookup_prefix(list(range(8)) + [1], count_stats=False)
    assert cached == 8 and sh == blocks
    bm.check_integrity(expected_seq_ids=["b"])
    # a hash on the card AND in a lower tier breaks exactly-one-tier
    with pytest.raises(RuntimeError, match="exactly-one-tier"):
        bm.check_integrity(expected_seq_ids=["b"], tier_hashes=hashes[:1])


def test_abort_restore_returns_blocks():
    bm, ev = _evicted_pair(BlockManager)
    blocks = bm.begin_restore([h for _, h in ev])
    free_before = bm.num_free_blocks
    # a restore-in-flight hash still in the store is flagged
    with pytest.raises(RuntimeError, match="restore-in-flight"):
        bm.check_integrity(expected_seq_ids=[], tier_hashes=[ev[0][1]])
    bm.abort_restore(blocks)
    assert bm.num_free_blocks == free_before + len(blocks)
    bm.check_integrity(expected_seq_ids=[])


def test_commit_restore_yields_to_fresh_registration():
    bm, ev = _evicted_pair(BlockManager)
    hashes = [h for _, h in ev]
    blocks = bm.begin_restore(hashes)
    bm.allocate("again", list(range(8)))    # re-registers the same hashes
    assert bm.commit_restore(hashes, blocks) == 0
    bm.free("again")
    bm.check_integrity(expected_seq_ids=[])


def _bm_trace(BM, seed: int) -> list:
    """A seeded trace of allocate / free / demote-drain / begin, commit and
    abort restore on a 16-block manager, and after each op everything the
    engine reads: the eviction log, the pool counts, a chain, integrity."""
    rng = np.random.default_rng(seed)
    bm = BM(16, 4)
    bm.record_evictions = True
    prefixes = [[int(t) for t in rng.integers(3, 50, size=12)] for _ in range(3)]
    live, inflight, log = [], [], []
    for step in range(120):
        op = int(rng.integers(0, 7))
        res = None
        if op <= 1:
            p = prefixes[int(rng.integers(0, 3))] + [
                int(t) for t in rng.integers(3, 50, size=int(rng.integers(1, 9)))]
            shared, cached = bm.lookup_prefix(p, count_stats=False)
            try:
                bm.allocate(f"s{step}", p, shared_blocks=shared)
                live.append(f"s{step}")
                res = ("alloc", cached)
            except MemoryError:
                res = ("oom", cached)
        elif op in (2, 3) and live:
            sid = live.pop(int(rng.integers(0, len(live))))
            bm.free(sid, cache_blocks=bool(rng.integers(0, 4)))
            res = ("free", sid)
        elif op == 4:
            ev = bm.take_evictions()
            hashes = [h for _, h in ev if not bm.prefix_resolvable(h)]
            blocks = bm.begin_restore(hashes) if hashes else None
            if blocks:
                inflight.append((hashes, blocks))
            res = ("drain", ev, hashes, blocks)
        elif op >= 5 and inflight:
            hashes, blocks = inflight.pop(0)
            if rng.integers(0, 3):
                res = ("commit", bm.commit_restore(hashes, blocks))
            else:
                bm.abort_restore(blocks)
                res = ("abort", blocks)
        try:
            bm.check_integrity(expected_seq_ids=live, tier_hashes=[])
            integrity = "ok"
        except RuntimeError as e:
            integrity = str(e)
        log.append((op, res, bm.num_free_blocks, bm.num_cached_blocks,
                    bm.num_restoring_blocks, bm.prefix_chain(prefixes[0] + [1]),
                    [bm.prefix_resolvable(h) for h in bm.prefix_chain(prefixes[1] + [1])],
                    integrity))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_manager_tier_trace_matches_jax(seed):
    ours, ref = _bm_trace(BlockManager, seed), _bm_trace(JaxBlockManager, seed)
    assert ours == ref
    kinds = {entry[1][0] for entry in ours if entry[1]}
    assert {"alloc", "drain", "commit"} <= kinds
    assert any(entry[1] and entry[1][0] == "drain" and entry[1][1] for entry in ours)
    assert all(entry[-1] == "ok" for entry in ours)


# ---------------------------------------------------------------------------
# the page copies
# ---------------------------------------------------------------------------

def _caches(dtype: str, num_blocks=12, layers=2, bs=4, H=2, D=16, seed=0):
    """The same random cache in both packages: per layer k, v (+ ks, vs
    float32 scales under int8)."""
    rng = np.random.default_rng(seed)
    jax_c, port_c = [], []
    for _ in range(layers):
        jl, pl = {}, {}
        for key in ("k", "v"):
            if dtype == "int8":
                a = rng.integers(-127, 128, size=(num_blocks, bs, H, D)).astype(np.int8)
                jl[key], pl[key] = jnp.asarray(a), torch.from_numpy(a.copy())
                s = rng.random((num_blocks, bs, H)).astype(np.float32)
                jl[key + "s"], pl[key + "s"] = jnp.asarray(s), torch.from_numpy(s.copy())
            else:
                a = rng.standard_normal((num_blocks, bs, H, D)).astype(np.float32)
                jl[key] = jnp.asarray(a, jnp.bfloat16)
                pl[key] = torch.from_numpy(a).to(torch.bfloat16)
        jax_c.append(jl)
        port_c.append(pl)
    return jax_c, port_c


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("rows", [3, 32])
def test_page_copies_match_jax_and_write_in_place(dtype, rows):
    jax_c, port_c = _caches(dtype)
    blocks, dest = [7, 2, 9, 2, 11], [0, 5, 6, 3, 1]
    staging = port_kv.PageStaging(port_c, rows)       # rows 3: two rounds
    ours = port_kv.gather_block_pages(port_c, blocks, staging)
    ref = jax_kv.gather_block_pages(jax_c, blocks)
    assert len(ours) == len(ref) == len(blocks)
    for o, r in zip(ours, ref):
        assert [sorted(layer) for layer in o] == [sorted(layer) for layer in r]
        for ol, rl in zip(o, r):
            for k in rl:
                assert tuple(ol[k].shape) == rl[k].shape
                np.testing.assert_array_equal(_bits(ol[k]), _bits(np.asarray(rl[k])))
        # one record a block, views at the layout's offsets
        assert o.record.numel() == staging.record_bytes
    assert pages_nbytes(ours[0]) == sum(np.asarray(a).nbytes for layer in ref[0]
                                        for a in layer.values())
    # scatter onto other blocks: the same cache as JAX's, in the same tensors
    ptrs = [(t.data_ptr(), t) for layer in port_c for t in layer.values()]
    port_kv.scatter_block_pages(port_c, dest, ours, staging)
    jax_c = jax_kv.scatter_block_pages(jax_c, dest, ref)
    assert all(t.data_ptr() == p for p, t in ptrs)
    assert [t for layer in port_c for t in layer.values()] == [t for _, t in ptrs]
    for pl, jl in zip(port_c, jax_c):
        for k in jl:
            np.testing.assert_array_equal(_bits(pl[k]), _bits(np.asarray(jl[k])))
    # pages without a record (read back from a spill file) are packed
    plain = [[{k: v.clone() for k, v in layer.items()} for layer in p] for p in ours[:2]]
    port_kv.scatter_block_pages(port_c, [4, 8], plain, staging)
    for b, src in ((4, blocks[0]), (8, blocks[1])):
        for layer in port_c:
            for t in layer.values():
                assert torch.equal(t[b].view(torch.uint8), t[src].view(torch.uint8))


def test_int8_pages_are_about_half_of_bf16():
    _, bf = _caches("bfloat16")
    _, i8 = _caches("int8")
    nb = pages_nbytes(port_kv.gather_block_pages(bf, [0])[0])
    n8 = pages_nbytes(port_kv.gather_block_pages(i8, [0])[0])
    assert n8 < nb and n8 == nb // 2 + 2 * 2 * 4 * 2 * 4     # + the f32 scales


# ---------------------------------------------------------------------------
# the engine, against the JAX engine
# ---------------------------------------------------------------------------

CACHE = dict(block_size=4, num_blocks=24, max_blocks_per_seq=16)
SCHED = dict(max_num_seqs=4, max_prefill_tokens=256, min_prefill_bucket=8,
             min_decode_bucket=2)
SHARED = list(range(2, 26))      # 24 tokens = 6 full blocks at block_size 4
PARAMS = dict(max_tokens=6, temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def model(fp32_tiny_qwen3):
    jcfg = fp32_tiny_qwen3
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _engine(rt, model, tiers=True, cache=None, **kw):
    jcfg, jparams, cfg, params = model
    conf = rt.EngineConfig(model="tiny-qwen3", cache=rt.CacheConfig(**(cache or CACHE)),
                           scheduler=rt.SchedulerConfig(**SCHED), enable_prefix_caching=True,
                           kv_tiers=tiers, attn_impl="reference", **kw)
    if rt is jax_rt:
        return jax_rt.Engine(dataclasses.replace(conf, slo_classes=False),
                             params=jparams, model_cfg=jcfg)
    return port_rt.Engine(conf, params=params, model_cfg=cfg, device="cpu")


def _gen(rt, eng, prompts):
    return [r.output_token_ids for r in eng.generate(prompts, rt.SamplingParams(**PARAMS))]


def _churn(rt, eng):
    """Unrelated prompts that exhaust the pool and evict the shared prefix."""
    return _gen(rt, eng, [[100 + i] * 40 for i in range(3)])


def _counters(eng) -> dict:
    s = eng.stats
    return {"demoted": s.kv_demoted_blocks, "spilled": s.kv_spilled_blocks,
            "dropped": s.kv_tier_dropped_blocks, "restores": s.kv_restores,
            "restored": s.kv_restored_blocks}


def _case(name: str, rt, model, spill_dir, **kw) -> dict:
    """One case of tests/test_kv_tiers.py's engine round trips, run the
    same way on either package's engine; what it returns must be equal."""
    out: dict = {}
    if name == "kill_switch":
        eng = _engine(rt, model, tiers=None, **kw)
        out["tiers_off"] = eng._kv_tiers is None and not eng.block_manager.record_evictions
    elif name == "spill":
        eng = _engine(rt, model, kv_host_bytes=3000, kv_spill_dir=spill_dir, **kw)
    elif name == "int8":
        eng = _engine(rt, model, cache=dict(CACHE, dtype="int8"), **kw)
    else:
        eng = _engine(rt, model, **kw)
    prompts = ([SHARED + [30 + i] for i in range(2)] if name in ("demote", "int8")
               else [SHARED + [30]])
    out["first"] = _gen(rt, eng, prompts)
    out["churn"] = _churn(rt, eng)
    store = eng._kv_tiers
    out["after_churn"] = _counters(eng)
    if name == "int8":
        nbytes = jax_pages_nbytes if rt is jax_rt else pages_nbytes
        out["page_bytes"] = nbytes(next(iter(store._host.values()))[0])
    if name == "gap":
        chain = eng.block_manager.prefix_chain(SHARED + [77])
        resolvable = [h for h in chain if store.has(h)]
        out["resolvable"] = len(resolvable)
        store.drop(resolvable[1])           # punch a gap mid-chain
    if name == "same_cycle":
        for r in range(3):
            rids = [eng.add_request(prompt_token_ids=SHARED + [60 + r, i],
                                    params=rt.SamplingParams(**PARAMS)) for i in range(3)]
            while eng.has_work():
                eng.step()                  # strict-checked every cycle
            out[f"round{r}"] = [eng.requests.pop(rid).output_token_ids for rid in rids]
            out[f"churn{r}"] = _churn(rt, eng)
    elif name == "abort":
        rid = eng.add_request(prompt_token_ids=SHARED + [88], params=rt.SamplingParams(**PARAMS))
        eng.step()                          # begins the restore, holds admission
        out["state"] = eng.requests[rid].state.value
        out["aborted"] = eng.abort_request(rid)
        while eng.has_work():
            eng.step()
        out["restoring_left"] = eng.block_manager.num_restoring_blocks
    else:
        out["hit"] = _gen(rt, eng, [SHARED + [77]])
    if name == "gap":
        out["chain_left"] = any(store.has(h) for h in chain)
    eng._check_block_integrity()
    out["counters"] = _counters(eng)
    out["num_restoring"] = eng.block_manager.num_restoring_blocks
    return out


CASES = ["demote", "spill", "kill_switch", "gap", "same_cycle", "abort", "int8"]


@pytest.mark.parametrize("name", CASES)
def test_engine_tier_case_matches_jax_engine(name, model, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSERVE_STRICT_BLOCKS", "1")
    if name == "kill_switch":
        monkeypatch.setenv("TPUSERVE_KV_TIERS", "0")
    ours = _case(name, port_rt, model, str(tmp_path / "port"), multi_step=1)
    ref = _case(name, jax_rt, model, str(tmp_path / "jax"), multi_step=1)
    assert ours == ref
    c = ours["counters"]
    if name == "kill_switch":
        assert ours["tiers_off"] and c["demoted"] == 0 and c["restores"] == 0
    else:
        assert ours["after_churn"]["demoted"] > 0
    if name in ("demote", "spill", "int8"):
        assert c["restores"] >= 1 and c["restored"] > 0
    if name == "spill":
        assert c["spilled"] > 0
    if name == "gap":
        assert ours["resolvable"] >= 3 and not ours["chain_left"]
    if name == "abort":
        assert ours["state"] == "restoring" and ours["aborted"]
        assert ours["restoring_left"] == 0
    if name == "demote":
        # and the restored hit equals a cold engine's tokens
        cold = _gen(port_rt, _engine(port_rt, model, tiers=False, multi_step=1),
                    [SHARED + [77]])
        assert ours["hit"] == cold


def test_int8_pages_demote_smaller_than_bf16(model):
    sizes = {}
    for dtype in ("int8", "bfloat16"):
        eng = _engine(port_rt, model, cache=dict(CACHE, dtype=dtype), multi_step=1)
        _gen(port_rt, eng, [SHARED + [30]])
        _churn(port_rt, eng)
        assert eng._kv_tiers.host_count > 0
        sizes[dtype] = pages_nbytes(next(iter(eng._kv_tiers._host.values()))[0])
    assert sizes["int8"] < sizes["bfloat16"]


def test_pipelined_windows_demote_and_restore_like_jax(model, monkeypatch):
    """The demote / restore case with fused windows kept in flight: the
    demote's gather waits the in-flight window out; tokens and counters as
    the JAX engine's with the same windows."""
    monkeypatch.setenv("TPUSERVE_STRICT_BLOCKS", "1")
    kw = dict(multi_step=4, pipeline_decode=True)
    ours = _case("demote", port_rt, model, None, **kw)
    ref = _case("demote", jax_rt, model, None, **kw)
    assert ours == ref
    assert ours["counters"]["restores"] >= 1


def test_restore_writes_the_engines_own_cache_tensors(model, monkeypatch):
    """The restore scatters into the tensors the executables hold (their
    data_ptr unchanged, the graphs' cache the engine's), and the step that
    follows reads the restored pages: its tokens equal a cold engine's."""
    monkeypatch.setenv("TPUSERVE_STRICT_BLOCKS", "1")
    eng = _engine(port_rt, model, multi_step=4, pipeline_decode=True)
    eng.warmup(decode_buckets=[2], prefill_buckets=[8])
    ptrs = [t.data_ptr() for layer in eng.kv_cache for t in layer.values()]
    _gen(port_rt, eng, [SHARED + [30]])
    _churn(port_rt, eng)
    hit = _gen(port_rt, eng, [SHARED + [77]])
    assert eng.stats.kv_restores >= 1
    assert eng.graphs.kv_cache is eng.kv_cache
    assert [t.data_ptr() for layer in eng.kv_cache for t in layer.values()] == ptrs
    cold = _engine(port_rt, model, tiers=False, multi_step=4, pipeline_decode=True)
    assert hit == _gen(port_rt, cold, [SHARED + [77]])


# ---------------------------------------------------------------------------
# the prefix digest
# ---------------------------------------------------------------------------

BODIES = [{"prompt": "shared system prompt | user 1"}, {"prompt": "p" * 500},
          {"prompt": [5, 6, 7]}, {"messages": [{"role": "user", "content": "hi"}]},
          {"prompt": ""}, {"nothing": 1}]


def test_digest_tracker_matches_jax():
    for body in BODIES:
        assert port_digest.affinity_key(body) == jax_digest.affinity_key(body)
    ours, ref = port_digest.PrefixDigestTracker(capacity=8), jax_digest.PrefixDigestTracker(8)
    keys = [port_digest.affinity_key({"prompt": f"conversation {i}"}) for i in range(20)]
    for tr in (ours, ref):
        for k in keys[:12]:
            tr.note(k)
    assert ours.digest_hex() == ref.digest_hex() and len(ours) == len(ref) == 8
    for tr in (ours, ref):
        tr.resize(4096)
        for k in keys[12:]:
            tr.note(k)
    assert (ours.bits, ours.capacity) == (ref.bits, ref.capacity)
    assert ours.digest_hex() == ref.digest_hex()
    assert all(jax_digest.digest_has(ours.digest_hex(), ours.bits, k) for k in keys[4:])


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_server_advertises_tiers_and_digest_and_renders_tier_metrics(model):
    from prometheus_client import generate_latest

    from tpuserve.server.metrics import ServerMetrics as JaxMetrics
    from tpuserve_torch.server import OpenAIServer, ServerConfig
    eng = _engine(port_rt, model, multi_step=1)
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0))
    url = f"http://127.0.0.1:{srv.start()}"
    try:
        base = dict(max_tokens=4, temperature=0, ignore_eos=True)
        _post(url + "/v1/completions", dict(base, prompt="digest me"))
        _post(url + "/v1/completions", dict(base, prompt=SHARED + [30]))
        for i in range(3):
            _post(url + "/v1/completions", dict(base, prompt=[100 + i] * 40))
        info = json.loads(_get(url + "/healthz"))
        assert info["status"] == "ok"
        assert set(info["kv_tier_blocks"]) == {"hbm", "host", "spill"}
        assert info["kv_tier_blocks"]["host"] > 0
        assert info["kv_digest_chars"] == jax_digest.AFFINITY_PREFIX_CHARS
        assert jax_digest.digest_has(info["kv_digest"], info["kv_digest_bits"],
                                     jax_digest.affinity_key({"prompt": "digest me"}))
        _post(url + "/v1/completions", dict(base, prompt=SHARED + [77]))
        assert eng.stats.kv_restores >= 1
        text = _get(url + "/metrics")
    finally:
        srv.shutdown()
    samples = {ln.split("{")[0]: float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith("tpuserve_kv_") and "_bucket" not in ln}
    assert samples["tpuserve_kv_blocks_demoted_total"] == eng.stats.kv_demoted_blocks > 0
    assert samples["tpuserve_kv_blocks_restored_total"] == eng.stats.kv_restored_blocks > 0
    assert samples["tpuserve_kv_restore_latency_seconds_count"] >= 1
    assert 'tpuserve_kv_tier_blocks{model_name="tiny-qwen3",tier="host"}' in text
    # the families' names and types are the JAX server's
    ref = generate_latest(JaxMetrics("tiny-qwen3").registry).decode()
    types = lambda t: {ln for ln in t.splitlines()      # noqa: E731
                       if ln.startswith("# TYPE tpuserve_kv_")
                       and not ln.split()[2].endswith("_created")}
    assert types(text) == types(ref) and len(types(text)) == 6


@pytest.mark.parametrize("argv,want", [
    ([], (True, 1 << 30, None)),
    (["--kv-host-bytes", "4096", "--kv-spill-dir", "SPILL"], (True, 4096, "SPILL")),
    (["--no-kv-tiers", "--kv-host-bytes", "4096"], (False, None, None)),
])
def test_cli_kv_tier_flags_reach_the_engine(argv, want, model, tmp_path):
    from tpuserve_torch.server.openai_api import build_parser, engine_config
    argv = [str(tmp_path) if a == "SPILL" else a for a in argv]
    conf = engine_config(build_parser().parse_args(
        ["--model", "tiny-qwen3", "--block-size", "4", "--num-blocks", "32",
         "--max-blocks-per-seq", "8", "--attn-impl", "reference"] + argv))
    _, _, cfg, params = model
    eng = port_rt.Engine(conf, params=params, model_cfg=cfg, device="cpu")
    store = eng._kv_tiers
    on, host, spill = want
    assert (store is not None) == on == eng.block_manager.record_evictions
    if on:
        assert store.host_budget_bytes == host
        assert store.spill_dir == (str(tmp_path) if spill else None)
