"""The port's multi-head latent attention (DeepSeek MLA) against the JAX
package's, on the CPU.

float32 throughout (``torch.set_float32_matmul_precision("highest")``),
inputs drawn with numpy from a seed.  Two configurations: ``tiny-deepseek``
(q-lora, sigmoid routing with a selection bias, grouped top-k, a shared
expert, the first layer dense) and a ``dataclasses.replace`` of it in
DeepSeek-V2-Lite's shape (a direct q projection, softmax routing without
renormalisation, two shared experts).  The init is bit-equal to the JAX
init; the k-only latent cache, its per-slice int8 scales and the paged ops
that read it equal the JAX ops (the hot-rope-channel case included); the
naive prefill, the absorbed chunk, decode-window and mixed trunks give the
JAX logits within 1e-4, and the absorbed decode step the naive prefill's
row; the engines' greedy streams equal the JAX engine's on the decode,
chunked, prefix-hit-with-tiers, int8-cache and n-gram paths; tiny
transformers DeepSeek-V2 and V3 checkpoints load to transformers' and the
JAX loader's logits; and an ``attn_impl="cuda"`` engine downgrades to the
plain attention before anything launches.
"""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from tpuserve import runtime as jax_rt
from tpuserve.models import transformer as jax_tf
from tpuserve.models import weights as jax_weights
from tpuserve.models.config import config_from_hf_json as jax_config_from_hf_json
from tpuserve.models.config import get_model_config as jax_get_model_config
from tpuserve.ops import attention as jax_attn
from tpuserve.runtime import kv_cache as jax_kv
from tpuserve.runtime import spec as jax_spec
from tpuserve_torch.models import transformer, weights
from tpuserve_torch.models.config import config_from_hf_json, get_model_config
from tpuserve_torch.ops import attention
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig, SamplingParams,
                                    SchedulerConfig, kv_cache, spec)


@pytest.fixture(autouse=True, scope="module")
def _torch_setup():
    n = torch.get_num_threads()
    prec = torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


ATOL = 1e-4
# DeepSeek-V2-Lite's attention and routing on tiny-deepseek's widths
V2_LITE = dict(mla_q_lora_rank=None, moe_scoring="softmax", moe_router_bias=False,
               moe_n_group=1, moe_topk_group=1, moe_routed_scaling=1.0,
               norm_topk_prob=False, moe_shared_experts=2)
VARIANTS = {"tiny-deepseek": {}, "v2-lite-shape": V2_LITE}


def _cfgs(variant):
    kw = dict(VARIANTS[variant], dtype="float32")
    return (dataclasses.replace(jax_get_model_config("tiny-deepseek"), **kw),
            dataclasses.replace(get_model_config("tiny-deepseek"), **kw))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _pair(variant, seed=3):
    """The JAX params (a random selection bias where the routing has one)
    and the same tree on the port's side."""
    jcfg, cfg = _cfgs(variant)
    jparams = jax_weights.init_params(jcfg, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for lp in jparams["layers"]:
        if "router_bias" in lp:
            lp["router_bias"]["bias"] = jnp.asarray(
                0.1 * rng.standard_normal(jcfg.num_experts).astype(np.float32))
    params = weights.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request):
    return _pair(request.param)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mla_init_equals_jax_init_bitwise(variant):
    jcfg, cfg = _cfgs(variant)
    ours = dict(_leaves(weights.init_params(cfg, seed=3, device="cpu")))
    ref = dict(_leaves(jax.tree.map(np.asarray, jax_weights.init_params(jcfg, seed=3))))
    assert ours.keys() == ref.keys()
    for k, leaf in ours.items():
        assert torch.equal(leaf, torch.from_numpy(np.array(ref[k], np.float32))), k
    q_keys = ({"/layers/0/q_proj/kernel"} if variant == "v2-lite-shape"
              else {"/layers/0/q_a_proj/kernel", "/layers/0/q_a_norm/scale",
                    "/layers/0/q_b_proj/kernel"})
    assert {"/layers/0/kv_a_proj/kernel", "/layers/0/kv_a_norm/scale",
            "/layers/0/kv_b_proj/kernel"} | q_keys <= ours.keys()


# ---- the latent cache -------------------------------------------------------------

def test_latent_cache_is_k_only_one_head():
    _, cfg = _cfgs("tiny-deepseek")
    cc = dict(block_size=4, num_blocks=8, max_blocks_per_seq=4)
    cache = kv_cache.create_kv_cache(cfg, CacheConfig(**cc), "cpu")
    assert set(cache[0]) == {"k"}
    assert tuple(cache[0]["k"].shape) == (8, 4, 1, cfg.mla_latent_dim)
    q = kv_cache.create_kv_cache(cfg, CacheConfig(**cc, dtype="int8"), "cpu")
    assert set(q[0]) == {"k", "ks"} and tuple(q[0]["ks"].shape) == (8, 4, 2)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", ["tiny-deepseek", "deepseek-v2-lite"])
def test_mla_block_bytes_equal_jax(name, dtype):
    """One latent array a layer (and two scales a token under int8): the
    engine sizes the blocks the JAX engine sizes."""
    cc = dict(block_size=16, num_blocks=8, max_blocks_per_seq=4, dtype=dtype)
    ours = kv_cache.bytes_per_block(get_model_config(name), CacheConfig(**cc))
    ref = jax_kv.bytes_per_block(jax_get_model_config(name), jax_kv.CacheConfig(**cc))
    assert ours == ref
    v2l = get_model_config("deepseek-v2-lite")
    assert kv_cache.bytes_per_block(v2l, CacheConfig(block_size=1, dtype="bfloat16")) \
        == 27 * 576 * 2


def _latent(T, cfg, hot=False, seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(1, T, cfg.mla_latent_dim)).astype(np.float32)
    lat[..., cfg.mla_kv_lora_rank:] *= 3.0
    if hot:
        lat[..., -1] = 50.0                      # a hot rope channel
    return lat


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_write_mla_entry_equals_jax(dtype, hot):
    _, cfg = _cfgs("tiny-deepseek")
    cc = dict(block_size=4, num_blocks=8, max_blocks_per_seq=4, dtype=dtype)
    T = 9
    lat = _latent(T, cfg, hot)
    slots = np.array([[0, 1, 2, 3, 4, 5, attention.PAD_SLOT, 8, 9]], np.int32)
    entry = kv_cache.create_kv_cache(cfg, CacheConfig(**cc), "cpu")[0]
    attention.write_mla_entry(entry, torch.from_numpy(lat), torch.from_numpy(slots),
                              latent_split=cfg.mla_kv_lora_rank)
    jentry = jax_kv.create_kv_cache(cfg, jax_kv.CacheConfig(**cc))[0]
    jentry = jax_attn.write_mla_entry(jentry, jnp.asarray(lat), jnp.asarray(slots),
                                      latent_split=cfg.mla_kv_lora_rank)
    assert set(entry) == set(jentry)
    for k in entry:
        np.testing.assert_array_equal(entry[k].numpy(), np.asarray(jentry[k]), err_msg=k)


def test_int8_mla_per_slice_scales_survive_hot_rope_channel():
    """The JAX test's trap: with one scale over the 48-wide (latent ⊕ rope)
    vector a rope channel 50x the latent would crush the latent's
    precision; the two slice scales keep it within half a step, and the
    int8 decode tracks the float32 one."""
    _, cfg = _cfgs("tiny-deepseek")
    split = cfg.mla_kv_lora_rank
    cc = CacheConfig(block_size=4, num_blocks=8, max_blocks_per_seq=4, dtype="int8")
    entry = kv_cache.create_kv_cache(cfg, cc, "cpu")[0]
    T = 8
    rng = np.random.default_rng(0)                  # the JAX test's draws
    lat = rng.normal(size=(1, T, cfg.mla_latent_dim)).astype(np.float32)
    lat[..., split:] *= 3.0
    lat[..., -1] = 50.0
    lat = torch.from_numpy(lat)
    slots = torch.arange(T, dtype=torch.int32)[None, :]
    attention.write_mla_entry(entry, lat, slots, latent_split=split)
    slices = (split, cfg.mla_qk_rope_head_dim)
    sc = attention.expand_slice_scales(entry["ks"], slices)
    deq = (entry["k"].float() * sc).reshape(-1, cfg.mla_latent_dim)[:T]
    ref = lat[0]
    lat_step = ref[:, :split].abs().max() / 127.0
    assert (deq[:, :split] - ref[:, :split]).abs().max() <= lat_step * 0.51 + 1e-6
    assert (deq[:, split:] - ref[:, split:]).abs().max() <= 50.0 / 127.0 * 0.51 + 1e-6
    q = torch.from_numpy(rng.normal(size=(1, cfg.num_heads, cfg.mla_latent_dim)).astype(
        np.float32))
    bt = torch.arange(2, dtype=torch.int32)[None, :]
    fp = {"k": torch.zeros(8, 4, 1, cfg.mla_latent_dim)}
    attention.write_mla_entry(fp, lat, slots)
    lens = torch.tensor([T], dtype=torch.int32)
    out_q = attention.paged_decode_attention(q, entry["k"], entry["k"], bt, lens,
                                             cfg.attn_scale, k_scale=entry["ks"],
                                             v_scale=entry["ks"], scale_slices=slices)
    out_fp = attention.paged_decode_attention(q, fp["k"], fp["k"], bt, lens, cfg.attn_scale)
    np.testing.assert_allclose(out_q.numpy(), out_fp.numpy(), atol=0.15, rtol=0.1)


def _latent_pages(cfg, hot, nb=12, bs=4, seed=0):
    """An int8 latent cache of ``nb`` blocks written from seeded latents,
    as both packages hold it."""
    lat = _latent(nb * bs, cfg, hot, seed)
    slots = np.arange(nb * bs, dtype=np.int32)[None, :]
    entry = kv_cache.create_kv_cache(cfg, CacheConfig(block_size=bs, num_blocks=nb,
                                                      max_blocks_per_seq=4, dtype="int8"), "cpu")[0]
    attention.write_mla_entry(entry, torch.from_numpy(lat), torch.from_numpy(slots),
                              latent_split=cfg.mla_kv_lora_rank)
    return entry["k"].numpy(), entry["ks"].numpy()


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("op", ["decode", "chunked", "ragged", "ragged_blocked"])
def test_scale_slices_paged_ops_equal_jax(op, hot):
    """Every plain paged op reads the int8 latent pages through their two
    slice scales as the JAX op does."""
    _, cfg = _cfgs("tiny-deepseek")
    kc, ks = _latent_pages(cfg, hot)
    slices = (cfg.mla_kv_lora_rank, cfg.mla_qk_rope_head_dim)
    rng = np.random.default_rng(2)
    H, D, scale = cfg.num_heads, cfg.mla_latent_dim, cfg.attn_scale
    kw = dict(k_scale=ks, v_scale=ks)
    if op == "decode":
        q = rng.normal(size=(2, H, D)).astype(np.float32)
        bt = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
        lens = np.array([13, 7], np.int32)
        args = (q, kc, kc, bt, lens)
        ours = attention.paged_decode_attention(*map(_t, args), scale, k_scale=_t(ks),
                                                v_scale=_t(ks), scale_slices=slices)
        ref = jax_attn.paged_decode_attention(*map(jnp.asarray, args), scale,
                                              k_scale=jnp.asarray(ks), v_scale=jnp.asarray(ks),
                                              scale_slices=slices)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
        return
    if op == "chunked":
        q = rng.normal(size=(2, 5, H, D)).astype(np.float32)
        bt = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
        ctx, chunk = np.array([6, 0], np.int32), np.array([5, 3], np.int32)
        args = (q, kc, kc, bt, ctx, chunk)
        ours = attention.chunked_prefill_attention(*map(_t, args), scale, k_scale=_t(ks),
                                                   v_scale=_t(ks), scale_slices=slices)
        ref = jax_attn.chunked_prefill_attention(*map(jnp.asarray, args), scale,
                                                 k_scale=jnp.asarray(ks), v_scale=jnp.asarray(ks),
                                                 scale_slices=slices)
        for b in range(2):
            np.testing.assert_allclose(ours.numpy()[b, :chunk[b]], np.asarray(ref)[b, :chunk[b]],
                                       atol=1e-5, rtol=1e-5)
        return
    T, blk = 8, 4
    q = rng.normal(size=(T, H, D)).astype(np.float32)
    if op == "ragged":
        rbt = np.repeat(np.array([[0, 1, 2, 3]], np.int32), T, axis=0)
        rbt[4:] = [4, 5, 6, 7]
        lens = np.array([3, 9, 14, 16, 1, 2, 5, 11], np.int32)
        ours = attention.ragged_attention(_t(q), _t(kc), _t(kc), _t(rbt), _t(lens), scale,
                                          seg_size=8, k_scale=_t(ks), v_scale=_t(ks),
                                          scale_slices=slices)
        ref = jax_attn.ragged_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(kc),
                                        jnp.asarray(rbt), jnp.asarray(lens), scale, seg_size=8,
                                        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(ks),
                                        scale_slices=slices)
    else:
        bbt = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
        lens = np.array([5, 6, 7, 8, 1, 2, 3, 4], np.int32)
        ours = attention.ragged_blocked_attention(_t(q), _t(kc), _t(kc), _t(bbt), _t(lens), blk,
                                                  scale, k_scale=_t(ks), v_scale=_t(ks),
                                                  scale_slices=slices)
        ref = jax_attn.ragged_blocked_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(kc),
                                                jnp.asarray(bbt), jnp.asarray(lens), blk, scale,
                                                k_scale=jnp.asarray(ks), v_scale=jnp.asarray(ks),
                                                scale_slices=slices)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_prefill_attention_contracts_values_at_their_own_width():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 7, 4, 48)).astype(np.float32)
    k = rng.normal(size=(2, 7, 4, 48)).astype(np.float32)
    v = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    lens = np.array([7, 4], np.int32)
    ours = attention.prefill_attention(*map(_t, (q, k, v, lens)), 0.2)
    ref = jax_attn.prefill_attention(*map(jnp.asarray, (q, k, v, lens)), 0.2)
    assert tuple(ours.shape) == (2, 7, 4, 32)
    np.testing.assert_allclose(ours.numpy()[0], np.asarray(ref)[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours.numpy()[1, :4], np.asarray(ref)[1, :4], atol=1e-5, rtol=1e-5)


# ---- the trunks ---------------------------------------------------------------------

BS, NB, MB = 4, 16, 8


def _caches(jcfg, cfg, dtype="float32"):
    cc = dict(block_size=BS, num_blocks=NB, max_blocks_per_seq=MB, dtype=dtype)
    return (jax_kv.create_kv_cache(jcfg, jax_kv.CacheConfig(**cc)),
            kv_cache.create_kv_cache(cfg, CacheConfig(**cc), "cpu"))


def _prefilled(model, dtype="float32"):
    """Both caches after a prefill of two prompts (12 and 7 tokens) into
    blocks 0-2 and 4-5; returns the caches, tokens, logits and tables."""
    jcfg, jparams, cfg, params = model
    jc, tc = _caches(jcfg, cfg, dtype)
    rng = np.random.default_rng(6)
    B, T = 2, 12
    tokens = rng.integers(2, cfg.vocab_size, (B, T)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    bt = np.array([[0, 1, 2, 3, 0, 0, 0, 0], [4, 5, 6, 7, 0, 0, 0, 0]], np.int32)
    slots = np.full((B, T), attention.PAD_SLOT, np.int32)
    for b in range(B):
        t = np.arange(lens[b])
        slots[b, :lens[b]] = bt[b, t // BS] * BS + t % BS
    jl, jc = jax_tf.prefill(jparams, jcfg, *map(jnp.asarray, (tokens, lens, slots)), jc)
    tl, _ = transformer.prefill(params, cfg, *map(_t, (tokens, lens, slots)), tc)
    return jc, tc, tokens, lens, bt, jl, tl


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_prefill_logits_and_latent_cache_match_jax(model, dtype):
    jc, tc, _, _, _, jl, tl = _prefilled(model, dtype)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for li in range(len(tc)):
        assert set(tc[li]) == set(jc[li])
        np.testing.assert_allclose(tc[li]["k"].float().numpy(),
                                   np.asarray(jc[li]["k"], np.float32), atol=1e-4 if dtype != "int8"
                                   else 1.0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_chunk_logits_match_jax(model, dtype):
    """The absorbed window trunk over the latent pages (a 5-row chunk after
    the cached prompts)."""
    jcfg, jparams, cfg, params = model
    jc, tc, _, lens, bt, _, _ = _prefilled(model, dtype)
    rng = np.random.default_rng(8)
    C = 5
    toks = rng.integers(2, cfg.vocab_size, (2, C)).astype(np.int32)
    chunk = np.array([5, 3], np.int32)
    slots = np.full((2, C), attention.PAD_SLOT, np.int32)
    for b in range(2):
        t = lens[b] + np.arange(chunk[b])
        slots[b, :chunk[b]] = bt[b, t // BS] * BS + t % BS
    args = (toks, lens, chunk, slots, bt)
    jl, _ = jax_tf.prefill_chunk(jparams, jcfg, *map(jnp.asarray, args), jc)
    tl, _ = transformer.prefill_chunk(params, cfg, *map(_t, args), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_decode_window_matches_jax(model):
    """A 4-step greedy window (the absorbed decode trunk) after a prefill."""
    jcfg, jparams, cfg, params = model
    jc, tc, tokens, lens, bt, jl, _ = _prefilled(model)
    first = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    args = (first, lens, bt, lens + 1, np.ones(2, bool))
    jout, _ = jax_tf.decode_multi(jparams, jcfg, *map(jnp.asarray, args),
                                  jnp.zeros((2, 2), jnp.uint32), jnp.zeros(2, jnp.float32),
                                  jc, steps=4)
    tout, _ = transformer.decode_multi(params, cfg, *map(_t, args), torch.zeros(2), tc, steps=4)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_absorbed_decode_matches_naive_prefill_row(model):
    """Decoding token t+1 (absorbed, latent space) gives the logits of a
    prefill over all t+1 tokens (naive, decompressed), on the port's side
    and against the JAX decode."""
    jcfg, jparams, cfg, params = model
    toks = np.array([[7, 3, 250, 99, 14, 2]], np.int32)
    slots = np.arange(6, dtype=np.int32)[None, :]
    _, tc = _caches(jcfg, cfg)
    full, _ = transformer.prefill(params, cfg, _t(toks), _t(np.array([6], np.int32)),
                                  _t(slots), tc)
    jc, tc = _caches(jcfg, cfg)
    _, jc = jax_tf.prefill(jparams, jcfg, jnp.asarray(toks[:, :5]), jnp.asarray([5]),
                           jnp.asarray(slots[:, :5]), jc)
    transformer.prefill(params, cfg, _t(toks[:, :5]), _t(np.array([5], np.int32)),
                        _t(slots[:, :5]), tc)
    bt = np.array([[0, 1, 0, 0, 0, 0, 0, 0]], np.int32)
    one = lambda v: np.array([v], np.int32)          # noqa: E731
    args = (toks[:, 5], one(5), one(5), bt, one(6))
    dec, _ = transformer.decode_step(params, cfg, *map(_t, args), tc)
    jdec, _ = jax_tf.decode_step(jparams, jcfg, *map(jnp.asarray, args), jc)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_forward_ragged_matches_jax(model, dtype):
    """A mixed step: two decode rows and a 4-row chunk of a third sequence,
    on the plain ragged attention over the latent pages."""
    jcfg, jparams, cfg, params = model
    jc, tc, tokens, lens, bt, _, _ = _prefilled(model, dtype)
    blk, T, B = 4, 8, 4
    toks = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    slots = np.full(T, attention.PAD_SLOT, np.int32)
    row_seq = np.zeros(T, np.int32)
    bts = np.zeros((B, MB), np.int32)
    bts[:2] = bt
    bts[2, :2] = [8, 9]
    kv_lens = np.zeros(B, np.int32)
    q_starts = np.full(B, T, np.int32)
    q_lens = np.zeros(B, np.int32)
    last = np.zeros(B, np.int32)
    rng = np.random.default_rng(3)
    for i in range(2):                           # decode rows 0, 1
        toks[i] = rng.integers(2, cfg.vocab_size)
        pos[i] = lens[i]
        slots[i] = bt[i, lens[i] // BS] * BS + lens[i] % BS
        row_seq[i], kv_lens[i], q_starts[i], q_lens[i], last[i] = i, lens[i] + 1, i, 1, i
    toks[4:8] = rng.integers(2, cfg.vocab_size, 4)  # a fresh 4-token chunk
    pos[4:8] = np.arange(4)
    slots[4:8] = 8 * BS + np.arange(4)
    row_seq[4:8] = 2
    kv_lens[2], q_starts[2], q_lens[2], last[2] = 4, 4, 4, 7
    meta = np.array([2, 1], np.int32)
    blk_seq = np.array([-1, 2], np.int32)
    args = (toks, pos, slots, row_seq, bts, kv_lens, q_starts, q_lens, meta, blk_seq, last)
    jl, _ = jax_tf.forward_ragged(jparams, jcfg, *map(jnp.asarray, args), jc, ragged_blk=blk)
    tl, _ = transformer.forward_ragged(params, cfg, *map(_t, args), tc, ragged_blk=blk)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], atol=ATOL, rtol=0)


def test_cacheless_trunks_match_jax(model):
    """embed_forward, score_prompt and draft_propose over the naive form."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(5)
    toks = rng.integers(2, cfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    ours = transformer.embed_forward(params, cfg, _t(toks), _t(lens))
    ref = jax_tf.embed_forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(lens))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    chosen, ranks, _, _ = transformer.score_prompt(params, cfg, _t(toks), _t(lens))
    jchosen, jranks, _, _ = jax_tf.score_prompt(jparams, jcfg, jnp.asarray(toks),
                                                jnp.asarray(lens))
    np.testing.assert_allclose(chosen.numpy()[0], np.asarray(jchosen)[0], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ranks.numpy()[0], np.asarray(jranks)[0])
    win = np.zeros((2, 12), np.int32)
    win[:, :8] = toks[:, :8]
    dlens = np.array([8, 5], np.int32)
    prop = transformer.draft_propose(params, cfg, _t(win), _t(dlens), k=4)
    jprop = jax_tf.draft_propose(jparams, jcfg, jnp.asarray(win), jnp.asarray(dlens), k=4)
    np.testing.assert_array_equal(prop.numpy(), np.asarray(jprop))


# ---- the engines -----------------------------------------------------------------------

CACHE = dict(block_size=4, num_blocks=256, max_blocks_per_seq=32, dtype="float32")
TIER_CACHE = dict(block_size=4, num_blocks=24, max_blocks_per_seq=16, dtype="float32")
GREEDY = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
SHARED = list(range(2, 26))
PATHS = ["decode", "chunked", "prefix_tiers", "int8_cache", "ngram"]


def _engines(model, path):
    jcfg, jparams, cfg, params = model
    sched = dict(max_num_seqs=4, min_prefill_bucket=8, min_decode_bucket=2)
    kw = dict(model="tiny-deepseek", enable_prefix_caching=False)
    cache, spec_kw = dict(CACHE), None
    if path == "decode":
        kw["multi_step"] = 4
    if path == "chunked":
        sched["prefill_chunk_size"] = 8
    if path == "prefix_tiers":
        cache, kw = dict(TIER_CACHE), dict(kw, enable_prefix_caching=True, kv_tiers=True)
    if path == "int8_cache":
        cache["dtype"] = "int8"
    if path == "ngram":
        spec_kw = dict(num_draft_tokens=3)
    port = Engine(EngineConfig(cache=CacheConfig(**cache), scheduler=SchedulerConfig(**sched),
                               speculative=spec.SpecConfig(**spec_kw) if spec_kw else None,
                               pipeline_decode=False, **kw),
                  params=params, model_cfg=cfg, device="cpu")
    jeng = jax_rt.Engine(jax_rt.EngineConfig(
        cache=jax_rt.CacheConfig(**cache), scheduler=jax_rt.SchedulerConfig(**sched),
        speculative=jax_spec.SpecConfig(**spec_kw) if spec_kw else None,
        attn_impl="reference", slo_classes=False,
        **dict({"kv_tiers": False}, **kw)), params=jparams, model_cfg=jcfg)
    return port, jeng


def _gen(eng, prompts):
    sp = SamplingParams if isinstance(eng, Engine) else jax_rt.SamplingParams
    return [r.output_token_ids for r in eng.generate(prompts, sp(**GREEDY))]


@pytest.mark.parametrize("path", PATHS)
def test_mla_engine_streams_match_jax_engine(model, path):
    port, jeng = _engines(model, path)
    rng = np.random.default_rng(2)
    if path == "prefix_tiers":
        rounds = [[SHARED + [30]], [[100 + i] * 40 for i in range(3)], [SHARED + [77]]]
        for prompts in rounds:
            assert _gen(port, prompts) == _gen(jeng, prompts)
        assert port.stats.kv_demoted_blocks > 0 and port.stats.kv_restores >= 1
        assert port.stats.kv_restores == jeng.stats.kv_restores
    else:
        prompts = [rng.integers(2, 200, n).tolist() for n in (21, 9, 30)]
        prompts.append([5, 6, 7, 8] * 5)
        if path == "ngram":                      # repetitive: n-gram drafts hit
            prompts = [[5, 6, 7, 8] * 5, [9, 10, 11] * 7]
        assert _gen(port, prompts) == _gen(jeng, prompts)
    if path == "chunked":
        assert port.stats.num_chunk_steps > 0
    if path == "ngram":
        assert port.stats.spec_steps > 0 and port.stats.spec_steps == jeng.stats.spec_steps
    assert port.block_manager.num_seqs() == 0


def test_cuda_request_downgrades_to_reference(caplog):
    """The JAX engine's design, before any launch: MLA never reaches a
    kernel, and the engine says so."""
    _, cfg = _cfgs("tiny-deepseek")
    with caplog.at_level(logging.INFO, logger="tpuserve_torch.engine"):
        eng = Engine(EngineConfig(model="tiny-deepseek", attn_impl="cuda",
                                  cache=CacheConfig(block_size=4, num_blocks=32,
                                                    max_blocks_per_seq=8)),
                     model_cfg=cfg, device="cpu")
    assert eng.attn_impl == "reference" and eng.graphs.attn_impl == "reference"
    assert "MLA model: attn_impl=cuda not supported yet" in caplog.text
    out = eng.generate([[5, 6, 7]], SamplingParams(max_tokens=3, temperature=0.0,
                                                   ignore_eos=True))
    assert len(out[0].output_token_ids) == 3


# ---- transformers checkpoints ------------------------------------------------------------

def _deepseek_v3():
    return transformers.DeepseekV3ForCausalLM(transformers.DeepseekV3Config(
        vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
        n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2, n_group=2,
        topk_group=1, routed_scaling_factor=1.5, norm_topk_prob=True,
        first_k_dense_replace=1, kv_lora_rank=32, q_lora_rank=24, qk_rope_head_dim=16,
        qk_nope_head_dim=32, v_head_dim=32, max_position_embeddings=512,
        rope_theta=10000.0, tie_word_embeddings=True, attention_bias=False,
        rope_interleave=True, rms_norm_eps=1e-6, bos_token_id=0, eos_token_id=1,
        rope_scaling={"rope_type": "yarn", "factor": 4.0, "beta_fast": 32, "beta_slow": 1,
                      "mscale": 0.707, "mscale_all_dim": 0.707,
                      "original_max_position_embeddings": 8},
        attn_implementation="eager"))


def _deepseek_v2():
    return transformers.DeepseekV2ForCausalLM(transformers.DeepseekV2Config(
        vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
        n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=2,
        topk_method="greedy", norm_topk_prob=False, routed_scaling_factor=1.0,
        first_k_dense_replace=1, kv_lora_rank=32, q_lora_rank=None, qk_rope_head_dim=16,
        qk_nope_head_dim=32, v_head_dim=32, max_position_embeddings=512,
        rope_theta=10000.0, tie_word_embeddings=True, attention_bias=False,
        rms_norm_eps=1e-6, bos_token_id=0, eos_token_id=1, attn_implementation="eager"))


@pytest.mark.parametrize("family", ["deepseek_v2", "deepseek_v3"])
def test_deepseek_checkpoint_loads_to_transformers_and_jax_logits(family, tmp_path):
    """A tiny transformers checkpoint: the loader's names, the rope
    de-interleave and (V3) YaRN against transformers' logits and the JAX
    loader's leaves."""
    torch.manual_seed(1)
    model = {"deepseek_v2": _deepseek_v2, "deepseek_v3": _deepseek_v3}[family]()
    model = model.to(torch.float32).eval()
    if family == "deepseek_v3":
        with torch.no_grad():
            for layer in model.model.layers:
                if hasattr(layer.mlp, "gate"):
                    layer.mlp.gate.e_score_correction_bias.uniform_(-0.05, 0.05)
    model.save_pretrained(tmp_path, safe_serialization=True)
    hf = json.loads((tmp_path / "config.json").read_text())
    cfg = dataclasses.replace(config_from_hf_json("ckpt", hf), dtype="float32")
    jcfg = dataclasses.replace(jax_config_from_hf_json("ckpt", hf), dtype="float32")
    assert cfg.is_mla and cfg.cache_head_dim == 48
    params = weights.load_hf_checkpoint(cfg, str(tmp_path), "cpu")
    jparams = jax_weights.load_hf_checkpoint(jcfg, str(tmp_path))
    ours, ref = dict(_leaves(params)), dict(_leaves(jax.tree.map(np.asarray, jparams)))
    assert sorted(ours) == sorted(ref)
    for name, leaf in ours.items():
        np.testing.assert_array_equal(leaf.numpy(), ref[name], err_msg=name)
    rng = np.random.default_rng(7)
    B, T = 2, 12
    tokens = rng.integers(2, cfg.vocab_size, (B, T)).astype(np.int32)
    slots = np.arange(B * T, dtype=np.int32).reshape(B, T)
    lens = np.full((B,), T, np.int32)
    cc = dict(block_size=4, num_blocks=8, max_blocks_per_seq=4, dtype="float32")
    tl, _ = transformer.prefill(params, cfg, *map(_t, (tokens, lens, slots)),
                                kv_cache.create_kv_cache(cfg, CacheConfig(**cc), "cpu"))
    jl, _ = jax_tf.prefill(jparams, jcfg, *map(jnp.asarray, (tokens, lens, slots)),
                           jax_kv.create_kv_cache(jcfg, jax_kv.CacheConfig(**cc)))
    with torch.no_grad():
        hf_logits = model(torch.from_numpy(tokens).long()).logits[:, -1].numpy()
    np.testing.assert_allclose(tl.numpy(), hf_logits, atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


# ---- the captured steps ---------------------------------------------------------------------

STEP_KEYS = {"prefill": ("prefill", 2, 16), "chunk": ("chunk", 8), "mixed": ("mixed", 16),
             "decode": ("decode", 4, "greedy"), "verify": ("verify", 2, 3, "greedy")}


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("kind", sorted(STEP_KEYS))
def test_mla_step_bodies_read_nothing_back(model, kind, cache_dtype):
    """MLA's steps on the plain attention, as the card captures them (the
    engine downgrades MLA to "reference", and every step is still a
    graph): no host read, and a padding run writes nothing."""
    from test_torch_pipeline import _NoHostReads
    from tpuserve_torch.runtime.graphs import StepGraphs
    _, _, cfg, params = model
    cc = CacheConfig(block_size=BS, num_blocks=NB, max_blocks_per_seq=MB, dtype=cache_dtype)
    cache = kv_cache.create_kv_cache(cfg, cc, "cpu")
    for entry in cache:
        for t in entry.values():
            t.copy_(torch.randn(t.shape).to(t.dtype) if t.dtype != torch.int8
                    else torch.randint(-100, 100, t.shape, dtype=torch.int8))
    before = [{k: t.clone() for k, t in e.items()} for e in cache]
    graphs = StepGraphs(params, cfg, cache, device=torch.device("cpu"), attn_impl="reference",
                        max_blocks=MB, steps=2, max_batch=4, ragged_blk=4, capture=False)
    exe = graphs.get(*STEP_KEYS[kind])
    with _NoHostReads():
        exe.pad_run()
    for e, b in zip(cache, before):
        assert all(torch.equal(e[k], b[k]) for k in e)
    assert transient_bytes_grow(cfg, STEP_KEYS[kind])


def transient_bytes_grow(cfg, key) -> bool:
    """The graph bound counts MLA's plain attention: more than the same
    key's dense bound, growing with the context the tables span."""
    from tpuserve_torch.runtime import graphs
    small = graphs.transient_bytes(cfg, key, 4, sizing=graphs.Sizing(ctx=64, blk=4))
    big = graphs.transient_bytes(cfg, key, 4, sizing=graphs.Sizing(ctx=4096, blk=4))
    dense = graphs.transient_bytes(dataclasses.replace(cfg, mla_kv_lora_rank=None), key, 4)
    return small > dense and (big > small or key[0] == "prefill")


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_latent_blocks_demote_and_restore_bit_equal(dtype, tmp_path):
    """The tiered cache's page copies take the k-only latent entries (and
    their two-slice int8 scales): a block gathered to the host, through a
    spill file, and scattered back reads bit-equal, and the gathered pages
    equal the JAX copies'."""
    from tpuserve.runtime import kv_cache as jkv
    from tpuserve_torch.runtime.kv_tiers import TieredPageStore
    _, cfg = _cfgs("tiny-deepseek")
    cc = dict(block_size=4, num_blocks=12, max_blocks_per_seq=4, dtype=dtype)
    cache = kv_cache.create_kv_cache(cfg, CacheConfig(**cc), "cpu")
    for entry in cache:
        for t in entry.values():
            t.copy_(torch.randint(-127, 128, t.shape, dtype=torch.int8) if t.dtype == torch.int8
                    else torch.randn(t.shape).to(t.dtype))
    jcache = [{k: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                        else t.numpy().dtype)
               for k, t in e.items()} for e in cache]
    before = [{k: t.clone() for k, t in e.items()} for e in cache]
    staging = kv_cache.PageStaging(cache, 2)
    pages = kv_cache.gather_block_pages(cache, [3, 7, 9], staging)
    ref = jkv.gather_block_pages(jcache, [3, 7, 9])
    for o, r in zip(pages, ref):
        assert [sorted(layer) for layer in o] == [sorted(layer) for layer in r]
        for ol, rl in zip(o, r):
            for k in rl:
                np.testing.assert_array_equal(ol[k].float().numpy(),
                                              np.asarray(rl[k], np.float32))
    store = TieredPageStore(0, spill_dir=str(tmp_path))        # every put spills
    for h, p in enumerate(pages):
        store.put(h, p)
    store.flush()
    back = [store.take(h) for h in range(3)]
    for entry in cache:
        for t in entry.values():
            t[[3, 7, 9]] = 0
    kv_cache.scatter_block_pages(cache, [3, 7, 9], back, staging)
    for e, b in zip(cache, before):
        assert set(e) == ({"k", "ks"} if dtype == "int8" else {"k"})
        for k in e:
            assert torch.equal(e[k].view(torch.uint8), b[k].view(torch.uint8)), k
