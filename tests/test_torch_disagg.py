"""In-process disaggregated prefill/decode on the CPU
(``tpuserve_torch/parallel/disagg.py``): the counterparts of the JAX
package's ``tests/test_disagg.py``, each also held against the JAX
package (its colocated engine's streams on the same weights, or its page
copies on the same caches)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models.config import get_model_config as jax_model_config
from tpuserve.parallel import disagg as jax_disagg
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.parallel.disagg import (DisaggregatedEngine, extract_seq_kv,
                                            insert_seq_kv)
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig, SamplingParams,
                                    SchedulerConfig)
from tpuserve_torch.runtime.kv_cache import create_kv_cache


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CACHE = dict(block_size=4, num_blocks=32, max_blocks_per_seq=8, dtype="float32")
SCHED = dict(max_num_seqs=4, max_prefill_tokens=64, min_prefill_bucket=8, min_decode_bucket=2)


def _mc(name="tiny-qwen3"):
    return dataclasses.replace(get_model_config(name), dtype="float32")


def _cfg(model="tiny-qwen3", cache=CACHE, **kw):
    return EngineConfig(model=model, cache=CacheConfig(**cache),
                        scheduler=SchedulerConfig(**SCHED), **kw)


def _pair(prefill=None, decode=None, model="tiny-qwen3"):
    return DisaggregatedEngine(prefill or _cfg(model), decode or _cfg(model),
                               model_cfg=_mc(model), device="cpu")


def _jax_colocated(prompts, params, model="tiny-qwen3", cache=CACHE, sched=SCHED):
    """The JAX colocated engine on the same seed-0 weights, float32."""
    conf = jax_rt.EngineConfig(
        model=model, cache=jax_rt.CacheConfig(**cache),
        scheduler=jax_rt.SchedulerConfig(**sched), attn_impl="reference",
        multi_step=1, kv_tiers=False)
    eng = jax_rt.Engine(conf, model_cfg=dataclasses.replace(jax_model_config(model),
                                                            dtype="float32"))
    return [r.output_token_ids for r in eng.generate(prompts, params)]


def test_extract_insert_roundtrip():
    src = [{"k": torch.arange(32 * 4 * 2 * 4, dtype=torch.float32).reshape(32, 4, 2, 4),
            "v": torch.ones((32, 4, 2, 4))}]
    pages = extract_seq_kv(src, [3, 7])
    dst = [{"k": torch.zeros((16, 4, 2, 4)), "v": torch.zeros((16, 4, 2, 4))}]
    keep = [dst[0]["k"].data_ptr(), dst[0]["v"].data_ptr()]
    dst = insert_seq_kv(dst, pages, [5, 9])
    assert torch.equal(dst[0]["k"][5], src[0]["k"][3])
    assert torch.equal(dst[0]["k"][9], src[0]["k"][7])
    assert float(dst[0]["k"][0].sum()) == 0.0
    # in place: the graphs hold the cache's addresses
    assert [dst[0]["k"].data_ptr(), dst[0]["v"].data_ptr()] == keep
    # the JAX functions on the same cache give the same pages
    jsrc = [{k: jnp.asarray(v.numpy()) for k, v in src[0].items()}]
    jpages, _ = jax_disagg.extract_seq_kv(jsrc, [3, 7])
    for k in ("k", "v"):
        np.testing.assert_array_equal(np.asarray(jpages[0][k]), pages[0][k].numpy())


def test_disagg_matches_colocated():
    """Same prompts, same greedy params: the pair's streams equal the
    colocated port engine's and the JAX colocated engine's."""
    p = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
    prompts = ["Hello world", "abcdefgh", "xy"]
    ref = Engine(_cfg(), model_cfg=_mc(), device="cpu").generate(prompts, p)
    disagg = _pair()
    out = disagg.generate(prompts, p)
    assert [r.output_token_ids for r in out] == [r.output_token_ids for r in ref]
    ids = [disagg.prefill.tokenizer.encode(x) for x in prompts]
    assert [r.output_token_ids for r in out] == _jax_colocated(
        ids, jax_rt.SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True))
    assert disagg.stats.kv_transfers == 3
    assert disagg.stats.kv_bytes_transferred > 0
    assert disagg.prefill.block_manager.num_seqs() == 0
    assert disagg.decode.block_manager.num_seqs() == 0
    # one weight tree on the device for both engines
    assert disagg.decode.params is disagg.prefill.params


def test_disagg_sampled_streams_follow_their_salt():
    """A seeded sampled request's stream continues across the handoff as
    in the colocated engine (its keyed noise moves with it)."""
    p = SamplingParams(max_tokens=8, temperature=0.9, top_p=0.95, seed=11, ignore_eos=True)
    prompts = [[5, 6, 7], [9, 8, 7, 6, 5]]
    ref = Engine(_cfg(), model_cfg=_mc(), device="cpu").generate(prompts, p)
    out = _pair().generate(prompts, p)
    assert [r.output_token_ids for r in out] == [r.output_token_ids for r in ref]


def test_disagg_finish_at_prefill():
    disagg = _pair()
    out = disagg.generate(["one token only"],
                          SamplingParams(max_tokens=1, temperature=0.0, ignore_eos=True))
    assert len(out) == 1 and len(out[0].output_token_ids) == 1
    assert disagg.stats.kv_transfers == 0       # finished before migration


def test_disagg_streaming_steps():
    disagg = _pair()
    disagg.add_request(prompt="stream", params=SamplingParams(
        max_tokens=4, temperature=0.0, ignore_eos=True))
    seen = 0
    while disagg.has_work():
        seen += len(disagg.step())
    assert seen == 4


def test_disagg_admission_control_many_requests():
    """More requests than the decode pool's max_num_seqs: the batch never
    overflows; every stream equals the JAX colocated engine's."""
    disagg = _pair()
    p = SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
    prompts = [[i + 1, i + 2, i + 3] for i in range(10)]
    out = disagg.generate(prompts, p)
    assert len(out) == 10 and all(len(r.output_token_ids) == 4 for r in out)
    assert [r.output_token_ids for r in out] == _jax_colocated(
        prompts, jax_rt.SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True))


def test_disagg_decode_pool_too_small_rejected_at_intake():
    tiny_decode = EngineConfig(
        model="tiny-qwen3",
        cache=CacheConfig(block_size=4, num_blocks=2, max_blocks_per_seq=8, dtype="float32"),
        enable_prefix_caching=False)
    disagg = _pair(decode=tiny_decode)
    with pytest.raises(ValueError, match="decode pool capacity"):
        disagg.add_request(prompt_token_ids=[1, 2, 3, 4, 5, 6, 7, 8],
                           params=SamplingParams(max_tokens=4, ignore_eos=True))
    assert not disagg.has_work()
    assert disagg.prefill.block_manager.num_seqs() == 0


def test_disagg_with_pipelined_windows_matches_colocated():
    """The decode pool on the card's decode shape (pipelined fused
    windows) still matches the plain colocated engine, and drains its
    in-flight window at the end."""
    p = SamplingParams(max_tokens=9, temperature=0.0, ignore_eos=True)
    prompts = ["Hello world", "abcdefgh", "xy"]
    ref = Engine(_cfg(), model_cfg=_mc(), device="cpu").generate(prompts, p)
    disagg = _pair(decode=_cfg(multi_step=4, pipeline_decode=True))
    out = disagg.generate(prompts, p)
    assert [r.output_token_ids for r in out] == [r.output_token_ids for r in ref]
    assert disagg.decode._pending_window is None
    assert disagg.prefill.block_manager.num_seqs() == 0
    assert disagg.decode.block_manager.num_seqs() == 0


def test_disagg_zombie_only_window_drains():
    """Every row of the decode pool's in-flight pipelined window finished
    (an abort): the flush is still owed, and the pair must drain it."""
    disagg = _pair(decode=_cfg(multi_step=4, pipeline_decode=True))
    p = SamplingParams(max_tokens=40, temperature=0.0, ignore_eos=True)
    rid = disagg.add_request(prompt_token_ids=[5, 6, 7], params=p)
    for _ in range(200):
        disagg.step()
        if disagg.decode._pending_window is not None:
            break
    assert disagg.decode._pending_window is not None
    assert disagg.abort_request(rid)
    for _ in range(50):
        if not disagg.has_work():
            break
        disagg.step()
    assert not disagg.has_work()
    assert disagg.decode._pending_window is None
    assert disagg.decode.block_manager.num_seqs() == 0


def test_insert_rejects_kv_format_mismatch():
    """An int8 pool's pages must not land in a float pool (codes as values,
    scales dropped), as the JAX check refuses them; matching formats
    round-trip, scale pages included."""
    cfg = _mc()
    ccfg = CacheConfig(block_size=4, num_blocks=16, max_blocks_per_seq=8, dtype="float32")
    int8_cache = create_kv_cache(cfg, dataclasses.replace(ccfg, dtype="int8"), "cpu")
    fp_cache = create_kv_cache(cfg, ccfg, "cpu")
    int8_cache[0]["ks"][1:3] = 0.5
    pages = extract_seq_kv(int8_cache, [1, 2])
    with pytest.raises(ValueError, match="mismatch"):
        insert_seq_kv(fp_cache, pages, [3, 4])
    insert_seq_kv(int8_cache, pages, [5, 6])
    assert torch.equal(int8_cache[0]["ks"][5:7], int8_cache[0]["ks"][1:3])
    jpages = [{k: np.asarray(v.numpy()) for k, v in layer.items()} for layer in pages]
    with pytest.raises(ValueError, match="mismatch"):
        jax_disagg.insert_seq_kv([{k: jnp.asarray(v.numpy()) for k, v in fp_cache[0].items()}],
                                 jpages[:1], [3, 4])


def test_disagg_sliding_window_migration_correct():
    """A windowed model migrates its full prompt KV (the prefill side
    never window-releases); its streams equal the colocated engine's and
    the JAX one's."""
    cache = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16, dtype="float32")
    cfg = EngineConfig(model="tiny-mistral", cache=CacheConfig(**cache),
                       scheduler=SchedulerConfig(max_num_seqs=4, min_prefill_bucket=8,
                                                 min_decode_bucket=2),
                       attn_impl="reference", pipeline_decode=False)
    prompts = [list(range(2, 22)), [7, 8, 9] * 5]      # 20 and 15 tokens > window 8
    p = SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
    mc = _mc("tiny-mistral")
    plain = Engine(cfg, model_cfg=mc, device="cpu").generate(prompts, p)
    d = DisaggregatedEngine(cfg, cfg, model_cfg=mc, device="cpu")
    assert d.prefill.config.window_release is False
    assert d.decode.config.window_release is True
    outs = d.generate(prompts, p)
    assert [r.output_token_ids for r in outs] == [r.output_token_ids for r in plain]
    assert [r.output_token_ids for r in outs] == _jax_colocated(
        prompts, jax_rt.SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True),
        model="tiny-mistral", cache=cache,
        sched=dict(max_num_seqs=4, min_prefill_bucket=8, min_decode_bucket=2))
    assert d.decode.stats.released_blocks > 0


def test_disagg_guided_choice_plan_follows_migration():
    """A guided_choice request whose first token opens a committed
    canonical-suffix plan (a non-ASCII choice: the prefill emits a
    partial-rune byte token) keeps its plan across the handoff."""
    disagg = _pair()
    choices = ["ünïcödé", "Ωmega"]
    (r,) = disagg.generate(["x"], [SamplingParams(max_tokens=40, temperature=0.0,
                                                  guided="choice",
                                                  guided_schema=json.dumps(choices))])
    assert r.output_text in choices, r.output_text
    assert disagg.prefill.stats.guided_plans >= 1
    assert not disagg.prefill._guided_plan and not disagg.decode._guided_plan


def test_disagg_refusals(tmp_path):
    """The JAX pair's refusals (multi-LoRA, a pp mesh); a tp mesh is served
    (here one rank's: the many-rank pair is tests/test_torch_mesh_disagg.py)."""
    import torch.distributed as dist
    from tpuserve_torch.parallel.mesh import (MeshConfig, RankComm, RankMesh, make_mesh,
                                              multihost_initialize)
    with pytest.raises(ValueError, match="multi-LoRA"):
        DisaggregatedEngine(_cfg(lora_modules={"a": "/x"}), _cfg(), model_cfg=_mc(),
                            device="cpu")
    pp = RankMesh(cfg=MeshConfig(pp=2), rank=0, world=2, device=torch.device("cpu"),
                  backend="gloo", comm=RankComm(1, 0, None, 1, 0, None), ctrl_group=None)
    with pytest.raises(ValueError, match="pipeline"):
        DisaggregatedEngine(_cfg(), _cfg(), mesh=pp, model_cfg=_mc(), device="cpu")
    assert not dist.is_initialized()
    multihost_initialize("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                         world_size=1)
    try:
        mesh = make_mesh(MeshConfig(tp=1), device_type="cpu")
        pair = DisaggregatedEngine(_cfg(), _cfg(), mesh=mesh, model_cfg=_mc(), device="cpu")
        assert pair.prefill.mesh is mesh and pair.decode.mesh is mesh
        prompts = [[5, 6, 7], list(range(10, 30))]
        sp = SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)
        assert [r.output_token_ids for r in pair.generate(prompts, sp)] == [
            r.output_token_ids for r in _pair().generate(prompts, sp)]
        assert pair.stats.kv_transfers == 2
    finally:
        dist.destroy_process_group()


def test_adopt_prefilled_demotes_before_it_writes():
    """The KV insert comes after the tiers' demote: a cached prefix block
    the adoption's allocate evicts keeps its pages in the host tier, then
    the adopted pages land in the block."""
    src = Engine(_cfg(), model_cfg=_mc(), device="cpu")
    dst = Engine(EngineConfig(model="tiny-qwen3",
                              cache=CacheConfig(block_size=4, num_blocks=4,
                                                max_blocks_per_seq=4, dtype="float32"),
                              scheduler=SchedulerConfig(**SCHED)),
                 params=src.params, model_cfg=_mc(), device="cpu")
    p = SamplingParams(max_tokens=2, temperature=0.0, ignore_eos=True)
    dst.generate([[3, 4, 5, 6, 7, 8, 9, 10, 11]], p)      # cached prefix blocks
    assert dst._kv_tiers is not None
    ids = [20 + i for i in range(9)]
    src.add_request(prompt_token_ids=ids, params=p, request_id="m")
    src.step()
    req = src.requests["m"]
    pages = extract_seq_kv(src.kv_cache, src.block_manager.block_table("m"))
    dst.adopt_prefilled("m", ids, req.output_token_ids[-1], p, pages)
    assert dst.stats.kv_demoted_blocks > 0
    bt = dst.block_manager.block_table("m")
    assert torch.equal(dst.kv_cache[0]["k"][bt[0]],
                       src.kv_cache[0]["k"][src.block_manager.block_table("m")[0]])
    while dst.has_work():
        dst.step()
    assert dst.requests["m"].output_token_ids == src.generate([ids], p)[0].output_token_ids


def test_pair_migration_demotes_before_it_copies():
    """The pair's page copy comes after the decode pool's tiers act, as an
    adoption's: a cached prefix block the migration's allocate evicts is
    demoted with its own pages, not the migrated ones written over it."""
    small = EngineConfig(model="tiny-qwen3",
                         cache=CacheConfig(block_size=4, num_blocks=4, max_blocks_per_seq=4,
                                           dtype="float32"),
                         scheduler=SchedulerConfig(**SCHED))
    pair = _pair(decode=small)
    dst = pair.decode
    p = SamplingParams(max_tokens=2, temperature=0.0, ignore_eos=True)
    first = [3, 4, 5, 6, 7, 8, 9, 10, 11]
    pair.generate([first], p)                               # cached prefix blocks
    assert dst._kv_tiers is not None
    blocks, n = dst.block_manager.lookup_prefix(first, count_stats=False)
    hashes = dst.block_manager.prefix_chain(first)[:len(blocks)]
    assert n > 0 and len(hashes) == len(blocks)
    before = {h: dst.kv_cache[0]["k"][b].clone() for h, b in zip(hashes, blocks)}
    pair.add_request(prompt_token_ids=[20 + i for i in range(9)], params=p)
    pair.prefill.step()
    pair._ready = list(pair.prefill.scheduler.running)
    pair.prefill.scheduler.running.clear()
    pair._try_migrations()                                   # evicts the prefix
    demoted = [h for h in hashes if dst._kv_tiers.has(h)]
    assert demoted and dst.stats.kv_demoted_blocks == len(demoted)
    for h in demoted:
        assert torch.equal(dst._kv_tiers.take(h)[0]["k"], before[h]), h
