"""The port's mixture-of-experts MLP against the JAX package's, on the CPU.

float32 throughout (``torch.set_float32_matmul_precision("highest")``),
inputs drawn with numpy from a seed.  Two configurations: ``tiny-moe``
(Qwen3-MoE routing: softmax, top-2 of 4) and a variant of it with
DeepSeek-V3's routing (sigmoid scores, a float32 selection bias, two
expert groups of which one survives, a shared expert, the first layer
dense, a 1.5 scaling), reached through ``dataclasses.replace`` since the
MLA family is not ported.  The init is bit-equal to the JAX init; the MLP
is held at atol 1e-5 (the same sums in another order, the combine weight
folded in before the down projection), also on a router with planted
ties; a tiny transformers ``Qwen3MoeForCausalLM`` checkpoint loads to
transformers' and the JAX loader's logits; the engines' greedy streams
equal the JAX engine's on the prefill, chunked, mixed and n-gram paths.
"""

import dataclasses
import json

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
from tpuserve.runtime import kv_cache as jax_kv
from tpuserve.runtime import spec as jax_spec
from tpuserve_torch.models import transformer, weights
from tpuserve_torch.models.config import config_from_hf_json, get_model_config
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig, SamplingParams,
                                    SchedulerConfig, graphs, kv_cache, spec)


@pytest.fixture(autouse=True, scope="module")
def _torch_setup():
    """Two torch intra-op threads while this file runs (pytest-xdist runs
    several files at once on the same cores) and float32 products in full
    precision."""
    n = torch.get_num_threads()
    prec = torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


ATOL = 1e-5
DEEPSEEK_ROUTING = dict(moe_scoring="sigmoid", moe_router_bias=True, moe_n_group=2,
                        moe_topk_group=1, moe_shared_experts=1, moe_first_k_dense=1,
                        moe_routed_scaling=1.5, norm_topk_prob=True)
VARIANTS = {"qwen3-moe": {}, "deepseek-routing": DEEPSEEK_ROUTING}


def _cfgs(variant):
    kw = dict(VARIANTS[variant], dtype="float32")
    return (dataclasses.replace(jax_get_model_config("tiny-moe"), **kw),
            dataclasses.replace(get_model_config("tiny-moe"), **kw))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _pair(variant, seed=3, bias_seed=None):
    """The JAX params (with a random selection bias when ``bias_seed``) and
    the same tree on the port's side."""
    jcfg, cfg = _cfgs(variant)
    jparams = jax_weights.init_params(jcfg, seed=seed)
    if bias_seed is not None and jcfg.moe_router_bias:
        rng = np.random.default_rng(bias_seed)
        for lp in jparams["layers"]:
            if "router_bias" in lp:
                lp["router_bias"]["bias"] = jnp.asarray(
                    0.1 * rng.standard_normal(jcfg.num_experts).astype(np.float32))
    params = weights.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_init_equals_jax_init_bitwise(variant):
    """The router, the float32 selection bias, the stacked (E, n_in, n_out)
    experts, the shared experts and the dense first layer are drawn as the
    JAX init draws them."""
    jcfg, cfg = _cfgs(variant)
    ours = dict(_leaves(weights.init_params(cfg, seed=3, device="cpu")))
    ref = dict(_leaves(jax.tree.map(np.asarray, jax_weights.init_params(jcfg, seed=3))))
    assert ours.keys() == ref.keys()
    for k, leaf in ours.items():
        want = torch.from_numpy(np.array(ref[k], np.float32))
        assert leaf.dtype == torch.float32 and torch.equal(leaf, want), k
    if variant == "deepseek-routing":         # a dense first layer, then MoE
        assert {"/layers/0/gate_proj/kernel", "/layers/1/router_bias/bias",
                "/layers/1/shared/down_proj/kernel"} <= ours.keys()


def _plant_ties(jparams, jcfg):
    """Router columns repeated, so experts tie exactly: in every MoE layer
    expert 3 copies expert 1, and (two groups of four) expert 6 copies 4."""
    for lp in jparams["layers"]:
        if "router" in lp:
            w = np.array(lp["router"]["kernel"])
            w[:, 3] = w[:, 1]
            if jcfg.num_experts >= 8:
                w[:, 6] = w[:, 4]
            lp["router"]["kernel"] = jnp.asarray(w)
    return jparams


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_mlp_matches_jax(variant, ties):
    jcfg, cfg = _cfgs(variant)
    if variant == "deepseek-routing":          # two groups of four experts
        jcfg = dataclasses.replace(jcfg, num_experts=8)
        cfg = dataclasses.replace(cfg, num_experts=8)
    jparams = jax_weights.init_params(jcfg, seed=4)
    if ties:
        jparams = _plant_ties(jparams, jcfg)
    if jcfg.moe_router_bias:
        rng = np.random.default_rng(9)
        for lp in jparams["layers"]:
            if "router_bias" in lp:
                lp["router_bias"]["bias"] = jnp.asarray(
                    0.05 * rng.standard_normal(jcfg.num_experts).astype(np.float32))
    params = weights.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    li = cfg.num_layers - 1                    # an MoE layer in both variants
    assert "experts" in params["layers"][li]
    x = np.random.default_rng(5).standard_normal((3, 9, cfg.hidden_size)).astype(np.float32)
    ref = np.asarray(jax_tf._moe_mlp(jnp.asarray(x), jparams["layers"][li], jcfg))
    ours = transformer._moe_mlp(torch.from_numpy(x), params["layers"][li], cfg).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def test_top_k_breaks_ties_to_the_lower_index():
    """bf16-valued scores tie often among 128 experts: the selection must be
    jax.lax.top_k's, values and indices."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 6, (64, 128)).astype(np.float32) / 8   # many exact ties
    jv, ji = jax.lax.top_k(jnp.asarray(x), 8)
    tv, ti = transformer._top_k(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_expert_groups_divide_the_experts_within_the_budget():
    cfg = get_model_config("Qwen/Qwen3-30B-A3B")
    for rows in (1, 8, 40, 512, 2048, 8192, 16384):
        g = transformer.moe_group(cfg, rows)
        assert cfg.num_experts % g == 0
        assert g == 1 or rows * g * cfg.expert_intermediate_size <= transformer.MOE_GROUP_VALUES
    assert transformer.moe_group(cfg, 8) == 128
    # the graph bound counts the group: a prefill key's transients grow
    # with the rows' group width, not with the unused dense width
    dense = dataclasses.replace(cfg, num_experts=0)
    key = ("prefill", 8, 1024)
    assert graphs.transient_bytes(cfg, key, 8) > 0
    assert graphs.transient_bytes(cfg, key, 8) != graphs.transient_bytes(dense, key, 8)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_prefill_logits_match_jax(variant):
    """A whole tiny MoE model's prefill (plain attention both sides)."""
    jcfg, jparams, cfg, params = _pair(variant, bias_seed=7)
    rng = np.random.default_rng(6)
    B, T, bs = 2, 12, 4
    tokens = rng.integers(2, cfg.vocab_size, (B, T)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    slots = np.arange(B * T, dtype=np.int32).reshape(B, T)
    ccfg = dict(block_size=bs, num_blocks=8, max_blocks_per_seq=4, dtype="float32")
    jl, _ = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens),
                           jnp.asarray(slots),
                           jax_kv.create_kv_cache(jcfg, jax_rt.CacheConfig(**ccfg)))
    cache = kv_cache.create_kv_cache(cfg, CacheConfig(**ccfg), "cpu")
    tl, _ = transformer.prefill(params, cfg, torch.from_numpy(tokens), torch.from_numpy(lens),
                                torch.from_numpy(slots), cache, attn_impl="reference")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


# ---- a Qwen3-MoE checkpoint --------------------------------------------------

@pytest.fixture(scope="module")
def qwen3_moe_checkpoint(tmp_path_factory):
    torch.manual_seed(0)
    model = transformers.Qwen3MoeForCausalLM(transformers.Qwen3MoeConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=512, rope_theta=1e6, rms_norm_eps=1e-6,
        num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
        norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
        tie_word_embeddings=False, bos_token_id=0, eos_token_id=1)).to(torch.float32).eval()
    path = tmp_path_factory.mktemp("ckpt-qwen3-moe")
    model.save_pretrained(path, safe_serialization=True)
    return str(path), model


def test_qwen3_moe_checkpoint_loads_to_transformers_and_jax_logits(qwen3_moe_checkpoint):
    path, model = qwen3_moe_checkpoint
    hf = json.loads(open(f"{path}/config.json").read())
    cfg = dataclasses.replace(config_from_hf_json("ckpt", hf), dtype="float32")
    jcfg = dataclasses.replace(jax_config_from_hf_json("ckpt", hf), dtype="float32")
    params = weights.load_hf_checkpoint(cfg, path, "cpu")
    jparams = jax_weights.load_hf_checkpoint(jcfg, path)
    ours, ref = dict(_leaves(params)), dict(_leaves(jax.tree.map(np.asarray, jparams)))
    assert sorted(ours) == sorted(ref)
    for name, leaf in ours.items():
        np.testing.assert_array_equal(leaf.numpy(), ref[name], err_msg=name)
    rng = np.random.default_rng(0)
    B, T = 2, 12
    tokens = rng.integers(2, cfg.vocab_size, (B, T)).astype(np.int32)
    slots = np.arange(B * T, dtype=np.int32).reshape(B, T)
    lens = np.full((B,), T, np.int32)
    ccfg = dict(block_size=4, num_blocks=8, max_blocks_per_seq=4, dtype="float32")
    tl, _ = transformer.prefill(params, cfg, torch.from_numpy(tokens), torch.from_numpy(lens),
                                torch.from_numpy(slots),
                                kv_cache.create_kv_cache(cfg, CacheConfig(**ccfg), "cpu"),
                                attn_impl="reference")
    jl, _ = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens),
                           jnp.asarray(slots),
                           jax_kv.create_kv_cache(jcfg, jax_rt.CacheConfig(**ccfg)))
    with torch.no_grad():
        hf_logits = model(torch.from_numpy(tokens).long()).logits[:, -1].numpy()
    np.testing.assert_allclose(tl.numpy(), hf_logits, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


# ---- the engines ---------------------------------------------------------------

CACHE = dict(block_size=4, num_blocks=256, max_blocks_per_seq=32, dtype="float32")
GREEDY = dict(max_tokens=10, temperature=0.0, ignore_eos=True)
PATHS = {
    "prefill": ({}, None),
    "chunked": ({"prefill_chunk_size": 8}, None),
    "mixed": ({"mixed_batching": True, "mixed_token_budget": 16}, None),
    "ngram": ({}, dict(num_draft_tokens=3)),
}


@pytest.fixture(scope="module")
def moe_model():
    return _pair("qwen3-moe", seed=0)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_moe_engine_streams_match_jax_engine(moe_model, path):
    jcfg, jparams, cfg, params = moe_model
    sched, spec_kw = PATHS[path]
    sched = dict(max_num_seqs=4, **sched)
    common = dict(model="tiny-moe", enable_prefix_caching=False, pipeline_decode=False)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, 200, n).tolist() for n in (21, 9, 30)]
    prompts.append([5, 6, 7, 8] * 5)                   # repetitive: n-gram drafts hit
    port = Engine(EngineConfig(cache=CacheConfig(**CACHE), scheduler=SchedulerConfig(**sched),
                               speculative=spec.SpecConfig(**spec_kw) if spec_kw else None,
                               **common), params=params, model_cfg=cfg, device="cpu")
    jeng = jax_rt.Engine(jax_rt.EngineConfig(
        cache=jax_rt.CacheConfig(**CACHE), scheduler=jax_rt.SchedulerConfig(**sched),
        speculative=jax_spec.SpecConfig(**spec_kw) if spec_kw else None,
        attn_impl="reference", multi_step=1, kv_tiers=False, slo_classes=False, **common),
        params=jparams, model_cfg=jcfg)
    ours = port.generate(prompts, SamplingParams(**GREEDY))
    ref = jeng.generate(prompts, jax_rt.SamplingParams(**GREEDY))
    assert [r.output_token_ids for r in ours] == [r.output_token_ids for r in ref]
    if path == "chunked":
        assert port.stats.num_chunk_steps > 0
    if path == "mixed":
        assert port.stats.num_mixed_steps > 0
    if path == "ngram":
        assert port.stats.spec_steps > 0
        assert port.stats.spec_steps == jeng.stats.spec_steps
    assert port.block_manager.num_seqs() == 0
