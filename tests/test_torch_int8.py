"""The port's weight-only int8 quantization against the JAX package's, on
the CPU (the cases of ``tests/test_quantization.py``).

float32 models (``torch.set_float32_matmul_precision("highest")``): the
int8 tensors and float32 scales are bit-equal to the JAX quantizer's on
``tiny-qwen3``, ``tiny-moe``, ``tiny-opt`` and ``tiny-deepseek`` (linears,
stacked experts with (E, out) scales, DeepSeek's shared experts and MLA
projections, the embedding's per-row scales); quantizing a layer at a time
as the tree is made gives the same tree; the int8 forward equals the
forward on the dequantized weights and the JAX int8 forward; the int8
engines' greedy streams equal the JAX int8 engine's; an unknown
quantization is refused before any load.
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
from tpuserve.models.config import get_model_config as jax_get_model_config
from tpuserve.runtime import kv_cache as jax_kv
from tpuserve_torch.models import transformer, weights
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig, SamplingParams,
                                    SchedulerConfig, graphs, kv_cache)


@pytest.fixture(autouse=True, scope="module")
def _torch_setup():
    n = torch.get_num_threads()
    prec = torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


MODELS = ["tiny-qwen3", "tiny-moe", "tiny-opt", "tiny-deepseek"]


def _cfgs(name, dtype="float32"):
    return (dataclasses.replace(jax_get_model_config(name), dtype=dtype),
            dataclasses.replace(get_model_config(name), dtype=dtype))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_trees_bit_equal(ours, ref):
    a, b = dict(_leaves(ours)), dict(_leaves(jax.tree.map(np.asarray, ref)))
    assert a.keys() == b.keys()
    for k, t in a.items():
        want = np.asarray(b[k])
        assert str(t.dtype).rsplit(".", 1)[-1] == str(want.dtype), (k, t.dtype, want.dtype)
        np.testing.assert_array_equal(t.numpy(), want, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_quantized_tree_bit_equal_to_jax(name, dtype):
    jcfg, cfg = _cfgs(name, dtype)
    ours = weights.quantize_params_int8(weights.init_params(cfg, seed=1, device="cpu"))
    ref = jax_weights.quantize_params_int8(jax_weights.init_params(jcfg, seed=1))
    if dtype == "bfloat16":              # norms stay bf16: compare through float32
        ours = jax.tree.map(lambda t: t.float() if t.dtype == torch.bfloat16 else t, ours)
        ref = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, ref)
    _assert_trees_bit_equal(ours, ref)


@pytest.mark.parametrize("name", MODELS)
def test_quantizing_layer_by_layer_equals_the_whole_tree(name):
    """``layer_fn=quantize_layer_int8`` at init (the engine's path, so a
    quantized model never exists whole in its dtype), then the embedding:
    the tree of quantizing after."""
    _, cfg = _cfgs(name)
    whole = weights.quantize_params_int8(weights.init_params(cfg, seed=2, device="cpu"))
    layered = weights.quantize_params_int8(weights.init_params(
        cfg, seed=2, device="cpu", layer_fn=weights.quantize_layer_int8))
    a, b = dict(_leaves(whole)), dict(_leaves(layered))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_int8_covers_mla_and_shared_weights():
    _, cfg = _cfgs("tiny-deepseek")
    q = weights.quantize_params_int8(weights.init_params(cfg, device="cpu"))
    lp = q["layers"][1]                       # an MoE layer (layer 0 dense)
    for key in ("kv_b_proj", "kv_a_proj", "q_a_proj", "q_b_proj", "o_proj", "router"):
        assert lp[key]["kernel"].dtype == torch.int8, key
    assert lp["shared"]["gate_proj"]["kernel"].dtype == torch.int8
    assert lp["experts"]["down_proj"]["kernel"].dtype == torch.int8
    assert tuple(lp["experts"]["down_proj"]["scale"].shape) == (cfg.num_experts, cfg.hidden_size)
    assert lp["router_bias"]["bias"].dtype == torch.float32
    assert lp["kv_a_norm"]["scale"].dtype == torch.float32
    assert q["layers"][0]["gate_proj"]["kernel"].dtype == torch.int8


def test_roundtrip_error_bounded():
    _, cfg = _cfgs("tiny-qwen3")
    params = weights.init_params(cfg, device="cpu")
    w = params["layers"][0]["q_proj"]["kernel"].clone()
    qp = weights.quantize_params_int8(params)
    dq = qp["layers"][0]["q_proj"]["kernel"].float() * qp["layers"][0]["q_proj"]["scale"][None]
    step = w.abs().amax(dim=0) / 127.0
    assert bool(((dq - w).abs() <= step[None] * 0.5 + 1e-7).all())
    assert qp["embed"]["weight"].dtype == torch.int8


def _dequantize(qp):
    """int8 + scale back to float kernels: the equality oracle."""
    def dq(p):
        if "scale" not in p or "kernel" not in p:
            return p
        s = p["scale"][:, None, :] if p["kernel"].dim() == 3 else p["scale"][None, :]
        out = {"kernel": p["kernel"].float() * s}
        if "bias" in p:
            out["bias"] = p["bias"]
        return out

    def layer(lp):
        out = {}
        for name, p in lp.items():
            if name in ("experts", "shared"):
                out[name] = {k: dq(v) for k, v in p.items()}
            else:
                out[name] = dq(p)
        return out
    new = {k: v for k, v in qp.items() if k not in ("layers", "embed", "lm_head")}
    new["layers"] = [layer(lp) for lp in qp["layers"]]
    new["embed"] = {"weight": qp["embed"]["weight"].float() * qp["embed"]["scale"][:, None]}
    if "lm_head" in qp:
        new["lm_head"] = dq(qp["lm_head"])
    return new


def _prefill(params, cfg, tokens, lens):
    B, T = tokens.shape
    cc = CacheConfig(block_size=4, num_blocks=16, max_blocks_per_seq=8, dtype="float32")
    slots = torch.arange(B * T, dtype=torch.int32).reshape(B, T)
    return transformer.prefill(params, cfg, tokens, lens, slots,
                               kv_cache.create_kv_cache(cfg, cc, "cpu"))[0]


@pytest.mark.parametrize("name", MODELS)
def test_quantized_forward_equals_dequantized_and_jax(name):
    jcfg, cfg = _cfgs(name)
    jq = jax_weights.quantize_params_int8(jax_weights.init_params(jcfg, seed=4))
    qp = weights.params_from_numpy(jax.tree.map(np.asarray, jq), cfg, "cpu")
    tokens = np.array([[1, 5, 9, 200, 7, 3], [4, 4, 8, 2, 0, 0]], np.int32)
    lens = np.array([6, 4], np.int32)
    lq = _prefill(qp, cfg, torch.from_numpy(tokens), torch.from_numpy(lens))
    ldq = _prefill(_dequantize(qp), cfg, torch.from_numpy(tokens), torch.from_numpy(lens))
    np.testing.assert_allclose(lq.numpy(), ldq.numpy(), atol=1e-4, rtol=1e-4)
    cc = jax_kv.CacheConfig(block_size=4, num_blocks=16, max_blocks_per_seq=8, dtype="float32")
    slots = np.arange(12, dtype=np.int32).reshape(2, 6)
    jl, _ = jax_tf.prefill(jq, jcfg, jnp.asarray(tokens), jnp.asarray(lens),
                           jnp.asarray(slots), jax_kv.create_kv_cache(jcfg, cc))
    np.testing.assert_allclose(lq.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def test_quantized_logits_close_to_full_precision():
    _, cfg = _cfgs("tiny-qwen3")
    params = weights.init_params(cfg, device="cpu")
    tokens = torch.tensor([[1, 5, 9, 200]], dtype=torch.int32)
    lens = torch.tensor([4], dtype=torch.int32)
    lf = _prefill(params, cfg, tokens, lens).numpy()
    lq = _prefill(weights.quantize_params_int8(params), cfg, tokens, lens).numpy()
    assert np.corrcoef(lf.ravel(), lq.ravel())[0, 1] > 0.999
    # the quantizer returns a new tree: the float one still gives its logits
    np.testing.assert_array_equal(_prefill(params, cfg, tokens, lens).numpy(), lf)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", ["tiny-qwen3", "tiny-moe"])
def test_engine_leaves_the_callers_tree_unchanged(name):
    """``Engine(params=p, quantization="int8")`` serves int8 weights and
    hands ``p`` back as it was: the same leaves, values and dtypes."""
    _, cfg = _cfgs(name)
    params = weights.init_params(cfg, seed=5, device="cpu")
    before = [(path, leaf, leaf.clone()) for path, leaf in _leaves(params)]
    eng = Engine(EngineConfig(model=name, quantization="int8", cache=CacheConfig(**CACHE),
                              scheduler=SchedulerConfig(**SCHED)),
                 params=params, model_cfg=cfg, device="cpu")
    assert weights.is_quantized(eng.params) and not weights.is_quantized(params)
    after = list(_leaves(params))
    assert [p for p, _ in after] == [p for p, _, _ in before]
    for (_, now), (path, leaf, copy) in zip(after, before):
        assert now is leaf and torch.equal(leaf, copy), path


SCHED = dict(max_num_seqs=4, min_prefill_bucket=8, min_decode_bucket=4)
CACHE = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16, dtype="float32")
GREEDY = dict(max_tokens=8, temperature=0.0, ignore_eos=True)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_int8_engine_streams_match_jax_engine(name, mixed):
    """The engine quantizes the (JAX-init) weights it is given and serves
    the JAX int8 engine's tokens, phase-split and mixed."""
    jcfg, cfg = _cfgs(name)
    jparams = jax_weights.init_params(jcfg, seed=0)
    params = weights.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    sched = dict(SCHED, mixed_batching=mixed, mixed_token_budget=16)
    kw = dict(model=name, quantization="int8", enable_prefix_caching=False)
    port = Engine(EngineConfig(cache=CacheConfig(**CACHE), scheduler=SchedulerConfig(**sched),
                               pipeline_decode=False, **kw),
                  params=params, model_cfg=cfg, device="cpu")
    jeng = jax_rt.Engine(jax_rt.EngineConfig(
        cache=jax_rt.CacheConfig(**CACHE), scheduler=jax_rt.SchedulerConfig(**sched),
        attn_impl="reference", kv_tiers=False, slo_classes=False, **kw),
        params=jparams, model_cfg=jcfg)
    assert port.params["layers"][0]["o_proj"]["kernel"].dtype == torch.int8
    assert port.params["embed"]["weight"].dtype == torch.int8
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 200, n).tolist() for n in (11, 5, 17)]
    ours = port.generate(prompts, SamplingParams(**GREEDY))
    ref = jeng.generate(prompts, jax_rt.SamplingParams(**GREEDY))
    assert [r.output_token_ids for r in ours] == [r.output_token_ids for r in ref]
    assert port.block_manager.num_seqs() == 0


def test_int8_engine_from_init_quantizes_layer_by_layer(monkeypatch):
    """With no weights given, each layer is quantized as it is made: the
    quantizer sees one layer at a time, never a whole float tree; the
    weights' bytes fall, and OPT keeps its biases and positions."""
    calls = []
    real = weights.quantize_layer_int8

    def spy(lp):
        calls.append(any(p.get("kernel") is not None and p["kernel"].dtype != torch.int8
                         for p in lp.values() if isinstance(p, dict)))
        return real(lp)
    from tpuserve_torch.runtime import engine as engine_mod
    monkeypatch.setattr(engine_mod, "quantize_layer_int8", spy)
    _, cfg = _cfgs("tiny-opt")
    eng = Engine(EngineConfig(model="tiny-opt", quantization="int8",
                              cache=CacheConfig(**CACHE), scheduler=SchedulerConfig(**SCHED)),
                 model_cfg=cfg, device="cpu")
    assert calls == [True] * cfg.num_layers
    lp = eng.params["layers"][0]
    assert lp["fc1"]["kernel"].dtype == torch.int8 and lp["fc1"]["bias"].dtype == torch.float32
    assert eng.params["pos_embed"]["weight"].dtype == torch.float32
    plain = weights.init_params(cfg, device="cpu")
    assert weights.param_nbytes(eng.params) < weights.param_nbytes(plain) / 2
    out = eng.generate([[5, 6, 7]], SamplingParams(max_tokens=5, temperature=0.0,
                                                   ignore_eos=True))
    assert len(out[0].output_token_ids) == 5


@pytest.mark.parametrize("value", ["fp4", "int4", "INT8"])
def test_engine_rejects_unknown_quantization_before_loading(value, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("weights were loaded")
    from tpuserve_torch.runtime import engine as engine_mod
    monkeypatch.setattr(engine_mod, "load_or_init", boom)
    with pytest.raises(ValueError, match="quantization"):
        Engine(EngineConfig(model="tiny-qwen3", quantization=value,
                            cache=CacheConfig(block_size=4, num_blocks=16,
                                              max_blocks_per_seq=4)), device="cpu")


def test_graph_bound_counts_the_dequantized_copy():
    """An int8 step holds one model-dtype copy of the kernel it multiplies:
    the vocabulary-wide unembedding, or one expert group's projection."""
    cfg = get_model_config("Qwen/Qwen3-30B-A3B")
    key = ("decode", 8, "greedy")
    plain = graphs.transient_bytes(cfg, key, 8)
    int8 = graphs.transient_bytes(cfg, key, 8, sizing=graphs.Sizing(int8=True))
    group = transformer.moe_group(cfg, 8) * cfg.expert_intermediate_size
    assert int8 - plain == cfg.hidden_size * max(cfg.vocab_size, group) * 2
    _, tiny = _cfgs("tiny-qwen3")
    q = weights.quantize_params_int8(weights.init_params(tiny, device="cpu"))
    assert graphs.sizing_of(q, 64, 8).int8
    assert not graphs.sizing_of(weights.init_params(tiny, device="cpu"), 64, 8).int8
