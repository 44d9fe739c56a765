"""The port's LoRA adapters, merged at load and stacked for per-request
selection, against the JAX package's, on the CPU (the cases of
``tests/test_lora.py`` and ``tests/test_multilora.py``).

Synthetic PEFT adapters (``adapter_config.json`` with
``adapter_model.safetensors`` or ``adapter_model.bin``), drawn with numpy
from a seed.  The merged kernels are bit-equal to the JAX merge (plain,
rsLoRA, Phi-3's fused projections split); malformed adapters raise the JAX
loader's errors and change no weight; the stacked factors are bit-equal to
the JAX stack; float32 engines give the JAX engines' greedy tokens with one
adapter merged, with a stack selecting per row (mixed with base rows, on
the phase-split and the mixed path, over int8 weights), and refuse what the
JAX engine refuses; the HTTP server lists, routes, echoes and refuses as
the JAX server does.
"""

import dataclasses
import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve.models.config import get_model_config as jax_get_model_config
from tpuserve_torch.models import weights
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig, SamplingParams,
                                    SchedulerConfig, graphs)
from tpuserve_torch.runtime.spec import SpecConfig


@pytest.fixture(autouse=True, scope="module")
def _torch_setup():
    n = torch.get_num_threads()
    prec = torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _cfgs(name="tiny-qwen3", dtype="float32"):
    return (dataclasses.replace(jax_get_model_config(name), dtype=dtype),
            dataclasses.replace(get_model_config(name), dtype=dtype))


JCFG, CFG = _cfgs()
SEVEN = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
         "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def _widths(cfg, module):
    h = cfg.hidden_size
    return {"self_attn.q_proj": (h, cfg.q_size), "self_attn.k_proj": (h, cfg.kv_size),
            "self_attn.v_proj": (h, cfg.kv_size), "self_attn.o_proj": (cfg.q_size, h),
            "mlp.gate_proj": (h, cfg.intermediate_size),
            "mlp.up_proj": (h, cfg.intermediate_size),
            "mlp.down_proj": (cfg.intermediate_size, h),
            "self_attn.qkv_proj": (h, cfg.q_size + 2 * cfg.kv_size),
            "mlp.gate_up_proj": (h, 2 * cfg.intermediate_size)}[module]


def _pair_tensors(rng, li, module, r, cfg=CFG, in_f=None, out_f=None, scale=1.0):
    i, o = _widths(cfg, module)
    pre = f"base_model.model.model.layers.{li}.{module}"
    return {f"{pre}.lora_A.weight": (scale * rng.standard_normal((r, in_f or i))).astype("f4"),
            f"{pre}.lora_B.weight": (scale * rng.standard_normal((out_f or o, r))).astype("f4")}


def write_adapter(path, tensors, r=4, alpha=8, rslora=False, fmt="safetensors"):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha, "use_rslora": rslora,
                   "peft_type": "LORA", "target_modules": ["q_proj"]}, f)
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in tensors.items()},
                   os.path.join(path, "adapter_model.bin"))
    else:
        save_file(tensors, os.path.join(path, "adapter_model.safetensors"))
    return str(path)


def _all_modules(rng, r, cfg=CFG, scale=0.05):
    t = {}
    for li in range(cfg.num_layers):
        for m in SEVEN:
            t.update(_pair_tensors(rng, li, m, r, cfg, scale=scale))
    return t


def _params(seed=0, cfg=CFG, jcfg=JCFG):
    jparams = jax_weights.init_params(jcfg, seed=seed)
    return jparams, weights.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_bit_equal(ours, ref):
    a, b = dict(_leaves(ours)), dict(_leaves(jax.tree.map(np.asarray, ref)))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k].float().numpy(), np.asarray(b[k], np.float32),
                                      err_msg=k)


# ---- merge at load ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["plain", "rslora", "bin", "phi3_fused"])
def test_merge_equals_jax_merge(kind, dtype, tmp_path):
    """W += s B A, the factors' product in numpy and the sum in float32 on
    both sides: the merged trees are bit-equal.  rsLoRA scales by alpha /
    sqrt(r); Phi-3's fused qkv / gate_up deltas split onto the columns the
    base loader splits."""
    jcfg, cfg = _cfgs(dtype=dtype)
    rng = np.random.default_rng(0)
    if kind == "phi3_fused":
        tensors = _pair_tensors(rng, 0, "self_attn.qkv_proj", 4, cfg)
        tensors.update(_pair_tensors(rng, 1, "mlp.gate_up_proj", 4, cfg))
    else:
        tensors = _all_modules(rng, 4, cfg, scale=1.0)
    path = write_adapter(tmp_path / kind, tensors, r=4, alpha=8, rslora=kind == "rslora",
                         fmt="bin" if kind == "bin" else "safetensors")
    jparams, params = _params(cfg=cfg, jcfg=jcfg)
    before = params["layers"][0]["q_proj"]["kernel"].clone()
    merged = weights.apply_lora(params, cfg, path)
    _assert_bit_equal(merged, jax_weights.apply_lora(jparams, jcfg, path))
    A = next(v for k, v in tensors.items() if "layers.0." in k and "lora_A" in k)
    B = next(v for k, v in tensors.items() if "layers.0." in k and "lora_B" in k)
    s = 8 / 4 ** 0.5 if kind == "rslora" else 8 / 4
    want = before.float() + torch.from_numpy(A.T @ (B.T * s))[:, :cfg.q_size]
    np.testing.assert_allclose(merged["layers"][0]["q_proj"]["kernel"].float().numpy(),
                               want.numpy(), atol=0.05 if dtype == "bfloat16" else 1e-5,
                               rtol=0.02 if dtype == "bfloat16" else 1e-5)


def _bad_adapters(rng):
    zz = "base_model.model.model.layers.0.self_attn.zz_proj"
    return {
        "not supported": {f"{zz}.lora_A.weight": rng.standard_normal((4, 64)).astype("f4"),
                          f"{zz}.lora_B.weight": rng.standard_normal((64, 4)).astype("f4")},
        "missing": {k: v for k, v in _pair_tensors(rng, 0, "self_attn.q_proj", 4).items()
                    if "lora_A" in k},
        "layer": _pair_tensors(rng, CFG.num_layers + 3, "self_attn.q_proj", 4),
        "shape": _pair_tensors(rng, 0, "self_attn.q_proj", 4, out_f=CFG.q_size + 8),
        "no LoRA pairs": {},
        "unsupported LoRA adapter key": {"base_model.model.lm_head.weight":
                                         rng.standard_normal((8, 8)).astype("f4")},
    }


@pytest.mark.parametrize("match", sorted(_bad_adapters(np.random.default_rng(3))))
def test_malformed_adapter_refused_like_jax(match, tmp_path):
    tensors = _bad_adapters(np.random.default_rng(3))[match]
    path = write_adapter(tmp_path / "bad", tensors)
    jparams, params = _params()
    with pytest.raises(ValueError, match=match) as ours:
        weights.apply_lora(params, CFG, path)
    with pytest.raises(ValueError) as ref:
        jax_weights.apply_lora(jparams, JCFG, path)
    assert str(ours.value) == str(ref.value)


def test_merge_validates_before_mutating(tmp_path):
    rng = np.random.default_rng(6)
    tensors = _pair_tensors(rng, 0, "self_attn.q_proj", 4)
    tensors.update(_pair_tensors(rng, 1, "self_attn.q_proj", 4, out_f=CFG.q_size + 8))
    path = write_adapter(tmp_path / "ad", tensors)
    _, params = _params()
    before = params["layers"][0]["q_proj"]["kernel"].clone()
    with pytest.raises(ValueError, match="shape"):
        weights.apply_lora(params, CFG, path)
    assert torch.equal(params["layers"][0]["q_proj"]["kernel"], before)


def test_merge_refuses_quantized_weights(tmp_path):
    path = write_adapter(tmp_path / "ad",
                         _pair_tensors(np.random.default_rng(5), 0, "self_attn.q_proj", 4))
    q = weights.quantize_params_int8(_params()[1])
    with pytest.raises(ValueError, match="quantized"):
        weights.apply_lora(q, CFG, path)


# ---- the stack ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    """Two adapters: ``alpha`` rank 4 on all seven projections of every
    layer, ``beta`` rsLoRA rank 2 on q and down of layer 1 and on v of
    layer 0 (a different rank and set: zero padding to the widest)."""
    root = tmp_path_factory.mktemp("adapters")
    rng = np.random.default_rng(7)
    write_adapter(root / "alpha", _all_modules(rng, 4, scale=0.3), r=4, alpha=8)
    t = _pair_tensors(rng, 1, "self_attn.q_proj", 2, scale=0.3)
    t.update(_pair_tensors(rng, 1, "mlp.down_proj", 2, scale=0.3))
    t.update(_pair_tensors(rng, 0, "self_attn.v_proj", 2, scale=0.3))
    write_adapter(root / "beta", t, r=2, alpha=4, rslora=True)
    return {"alpha": str(root / "alpha"), "beta": str(root / "beta")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_equals_jax_stack(adapters, dtype):
    jcfg, cfg = _cfgs(dtype=dtype)
    jparams, params = _params(cfg=cfg, jcfg=jcfg)
    names = weights.load_lora_stack(params, cfg, adapters)
    assert names == jax_weights.load_lora_stack(jparams, jcfg, adapters) == ["alpha", "beta"]
    _assert_bit_equal(params, jparams)
    assert tuple(params["layers"][1]["q_proj"]["lora"]["A"].shape) == (2, CFG.hidden_size, 4)
    assert graphs.sizing_of(params, 64, 8).lora_rank == 4


SCHED = dict(max_num_seqs=8, min_prefill_bucket=8, min_decode_bucket=2)
CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16, dtype="float32")
PROMPTS = [[5, 9, 12, 44], [101, 55, 3, 7], [20, 21, 22, 23]]


def _pair_engines(own=False, **kw):
    """The port's engine and the JAX one on the same weights: ``_params()``
    handed to both, or (``own``) each engine's own init from seed 0."""
    sched = dict(SCHED, **kw.pop("sched", {}))
    jparams, params = (None, None) if own else _params()
    common = dict(model="tiny-qwen3", enable_prefix_caching=False, **kw)
    port = Engine(EngineConfig(cache=CacheConfig(**CACHE), scheduler=SchedulerConfig(**sched),
                               pipeline_decode=False, **common),
                  params=params, model_cfg=CFG, device="cpu")
    jeng = jax_rt.Engine(jax_rt.EngineConfig(
        cache=jax_rt.CacheConfig(**CACHE), scheduler=jax_rt.SchedulerConfig(**sched),
        attn_impl="reference", kv_tiers=False, slo_classes=False, **common),
        params=jparams, model_cfg=JCFG)
    return port, jeng


def _gen(eng, prompts, names=None, max_tokens=8):
    sp = (SamplingParams if isinstance(eng, Engine) else jax_rt.SamplingParams)(
        max_tokens=max_tokens, temperature=0.0, ignore_eos=True)
    rids = [eng.add_request(prompt_token_ids=p, params=sp,
                            **({"adapter": names[i]} if names and names[i] else {}))
            for i, p in enumerate(prompts)]
    outs = {}
    while eng.has_work():
        for o in eng.step():
            outs.setdefault(o.request_id, []).extend(o.new_token_ids)
    return [outs[r] for r in rids]


@pytest.mark.parametrize("int8,own", [(False, False), (True, False), (True, True)])
def test_merged_engine_matches_jax_engine(adapters, int8, own):
    """One adapter merged at load (then quantized, under int8; ``own``: on
    the tree the engine made, quantized a layer at a time in place)."""
    kw = dict(lora_dir=adapters["alpha"], quantization="int8" if int8 else None)
    port, jeng = _pair_engines(own=own, **kw)
    got = _gen(port, PROMPTS)
    assert got == _gen(jeng, PROMPTS)
    plain, _ = _pair_engines(quantization=kw["quantization"])
    assert got != _gen(plain, PROMPTS)


@pytest.mark.parametrize("path", ["phase_split", "mixed", "int8"])
def test_stack_rows_match_jax_engine_and_merge(adapters, path):
    """A batch of alpha, base and beta rows: each row equals the JAX stack
    engine's, and (float32 weights) the engine with that adapter merged or
    none; under int8 the base row equals the plain int8 engine's."""
    kw = {"lora_modules": adapters}
    if path == "mixed":
        kw["sched"] = dict(mixed_batching=True, mixed_token_budget=16)
    if path == "int8":
        kw["quantization"] = "int8"
    port, jeng = _pair_engines(**kw)
    names = ["alpha", None, "beta"]
    got = _gen(port, PROMPTS, names)
    assert got == _gen(jeng, PROMPTS, names)
    if path == "mixed":
        assert port.stats.num_mixed_steps > 0
    if path == "int8":
        base, _ = _pair_engines(quantization="int8")
        assert got[1] == _gen(base, PROMPTS)[1]
        return
    for i, name in enumerate(names):
        alone, _ = _pair_engines(lora_dir=adapters[name]) if name else _pair_engines()
        assert got[i] == _gen(alone, PROMPTS)[i], name


def test_stack_long_adapter_prompt_runs_chunked(adapters):
    """An adapter prompt past the chunk size: every chunk carries its
    adapter."""
    port, jeng = _pair_engines(lora_modules=adapters, sched=dict(prefill_chunk_size=8))
    prompts = [list(range(3, 40)), [7, 8, 9]]
    got = _gen(port, prompts, ["beta", "alpha"])
    assert got == _gen(jeng, prompts, ["beta", "alpha"])
    assert port.stats.num_chunk_steps > 0


def test_adapter_intake_validation(adapters):
    port, _ = _pair_engines(lora_modules=adapters)
    with pytest.raises(ValueError, match="unknown adapter"):
        port.add_request(prompt_token_ids=[1, 2], params=SamplingParams(max_tokens=1),
                         adapter="gamma")
    plain, _ = _pair_engines()
    with pytest.raises(ValueError, match="no lora_modules"):
        plain.add_request(prompt_token_ids=[1, 2], params=SamplingParams(max_tokens=1),
                          adapter="alpha")


def test_multilora_gates(adapters, tmp_path):
    with pytest.raises(ValueError, match="speculative"):
        Engine(EngineConfig(model="tiny-qwen3", lora_modules=adapters,
                            speculative=SpecConfig(num_draft_tokens=2),
                            cache=CacheConfig(**CACHE)), model_cfg=CFG, device="cpu")
    # prefix caching, and so the tiers, off: cached KV is adapter-specific
    eng = Engine(EngineConfig(model="tiny-qwen3", lora_modules=adapters,
                              enable_prefix_caching=True, cache=CacheConfig(**CACHE)),
                 model_cfg=CFG, device="cpu")
    assert not eng.block_manager.enable_prefix_caching and eng._kv_tiers is None
    with pytest.raises(FileNotFoundError):
        Engine(EngineConfig(model="tiny-qwen3", lora_dir=str(tmp_path / "missing"),
                            cache=CacheConfig(**CACHE)), model_cfg=CFG, device="cpu")


def test_graphs_stage_adapter_indices_only_with_a_stack():
    """Executables of a stacked engine stage each row's adapter index (-1
    for base and padding); without a stack they have no such field."""
    key = ("decode", 4, "greedy")
    assert "adapter" not in [f[0] for f in graphs.layout(key, 8, 8, 8)]
    fields = {f[0]: f for f in graphs.layout(key, 8, 8, 8, adapters=2)}
    assert fields["adapter"][1:] == ((4,), -1)
    assert {f[0]: f for f in graphs.layout(("chunk", 16), 8, 8, 8, 2)}["adapter"][1] == (1,)
    assert {f[0]: f for f in graphs.layout(("mixed", 32), 8, 8, 8, 2)}["adapter"][1] == (32,)
    cfg = get_model_config("Qwen/Qwen3-0.6B")
    bare = graphs.transient_bytes(cfg, key, 8)
    lora = graphs.transient_bytes(cfg, key, 8, sizing=graphs.Sizing(lora_rank=16))
    assert lora - bare == 4 * (cfg.hidden_size + cfg.intermediate_size) * 16 * 8


# ---- the HTTP surface ------------------------------------------------------------------

def _servers(adapters):
    from tpuserve.server.openai_api import OpenAIServer as JaxServer
    from tpuserve.server.openai_api import ServerConfig as JaxServerConfig
    from tpuserve_torch.server.openai_api import OpenAIServer, ServerConfig
    port, jeng = _pair_engines(lora_modules=adapters)
    ours = OpenAIServer(port, ServerConfig(host="127.0.0.1", port=0))
    ref = JaxServer(jeng, JaxServerConfig(host="127.0.0.1", port=0))
    return ours, ref


@pytest.fixture(scope="module")
def servers(adapters):
    ours, ref = _servers(adapters)
    urls = (f"http://127.0.0.1:{ours.start(warmup=False)}",
            f"http://127.0.0.1:{ref.start(warmup=False)}")
    yield urls
    ours.shutdown()
    ref.shutdown()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _strip(body):
    """A response without its per-request id and timestamps."""
    return {k: v for k, v in body.items() if k not in ("id", "created")}


def test_models_list_adapters_like_jax(servers):
    bodies = []
    for url in servers:
        with urllib.request.urlopen(url + "/v1/models", timeout=30) as r:
            bodies.append(json.loads(r.read()))
    ours, ref = ([{k: v for k, v in m.items() if k != "created"} for m in b["data"]]
                 for b in bodies)
    assert ours == ref
    assert [m["id"] for m in ours] == ["tiny-qwen3", "alpha", "beta"]
    assert ours[1]["parent"] == "tiny-qwen3"
    with urllib.request.urlopen(servers[0] + "/v1/models/beta", timeout=30) as r:
        assert json.loads(r.read())["parent"] == "tiny-qwen3"


@pytest.mark.parametrize("model", ["tiny-qwen3", "alpha", "beta", "an-alias"])
def test_model_field_routes_and_echoes_like_jax(servers, model):
    body = {"model": model, "prompt": [5, 9, 12, 44], "max_tokens": 6, "temperature": 0,
            "ignore_eos": True}
    (s1, ours), (s2, ref) = (_post(u + "/v1/completions", body) for u in servers)
    assert s1 == s2 == 200
    assert _strip(ours) == _strip(ref)
    assert ours["model"] == (model if model in ("alpha", "beta") else "tiny-qwen3")


@pytest.mark.parametrize("route,body", [
    ("/v1/embeddings", {"model": "alpha", "input": "x"}),
    ("/v1/completions", {"model": "alpha", "prompt": [5, 9], "max_tokens": 2,
                         "prompt_logprobs": 1}),
    ("/v1/completions", {"model": "beta", "prompt": [5, 9], "max_tokens": 2, "echo": True,
                         "logprobs": 1}),
])
def test_adapter_refusals_match_jax(servers, route, body):
    (s1, ours), (s2, ref) = (_post(u + route, body) for u in servers)
    assert s1 == s2 == 400
    assert ours == ref
    assert "base model" in ours["error"]["message"]


def test_streamed_response_echoes_the_adapter(servers):
    req = urllib.request.Request(
        servers[0] + "/v1/completions",
        data=json.dumps({"model": "beta", "prompt": [5, 9], "max_tokens": 3, "stream": True,
                         "temperature": 0, "ignore_eos": True}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        chunks = [json.loads(line[6:]) for line in r.read().decode().splitlines()
                  if line.startswith("data: {")]
    assert chunks and all(c["model"] == "beta" for c in chunks)


@pytest.mark.parametrize("key", [("prefill", 2, 8), ("chunk", 8), ("mixed", 16),
                                 ("decode", 4, "greedy")])
def test_lora_step_bodies_read_nothing_back(adapters, key):
    """A stacked engine's steps, as the card captures them: the one-hot
    adapter weights are made from the staged indices on the device, with
    no host read; padding rows (-1) add nothing."""
    from test_torch_pipeline import _NoHostReads
    from tpuserve_torch.runtime import kv_cache
    _, params = _params()
    weights.load_lora_stack(params, CFG, adapters)
    cc = CacheConfig(block_size=4, num_blocks=32, max_blocks_per_seq=8, dtype="float32")
    g = graphs.StepGraphs(params, CFG, kv_cache.create_kv_cache(CFG, cc, "cpu"),
                          device=torch.device("cpu"), attn_impl="cuda", max_blocks=8, steps=2,
                          max_batch=4, ragged_blk=8, capture=False, n_adapters=2)
    exe = g.get(*key)
    st = exe.stage()
    assert (st.adapter == -1).all()
    st.adapter[0] = 1
    with _NoHostReads():
        exe.pad_run()
        exe.load(st)
        exe.run()
