"""Checkpoint loading in the port, against the JAX loader and transformers.

``transformers`` authors every checkpoint here, on the CPU (nothing is
downloaded): tiny Qwen3, Llama, Phi-3 (fused qkv and gate_up) and OPT
(learned positions, layernorm biases), shaped as in
tests/test_golden_checkpoint.py.  The port's tree must equal the JAX
loader's leaf for leaf in float32, its prefill's last-row logits must match
transformers' at atol/rtol 2e-4, and its engine's greedy tokens must be
transformers'.  The port's own safetensors parser must agree bit for bit
with the ``safetensors`` package, on a bf16 checkpoint and on a sharded
one.  Also here: the engine's tokenizer comes from the checkpoint
directory (F1), and a queued request past its deadline is aborted as the
JAX engine aborts it (F2).
"""

import dataclasses
import glob
import json

import jax
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import load_file

from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve.models.config import config_from_hf_json as jax_config_from_hf_json
from tpuserve.models.config import get_model_config as jax_get_model_config
from tpuserve_torch.models import transformer
from tpuserve_torch.models.config import config_from_hf_json, get_model_config
from tpuserve_torch.models.tokenizer import HFTokenizer
from tpuserve_torch.models.weights import (load_hf_checkpoint, load_or_init,
                                           params_from_numpy, read_safetensors)
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig,
                                    SamplingParams, SchedulerConfig)
from tpuserve_torch.runtime.clock import VirtualClock
from tpuserve_torch.runtime.kv_cache import create_kv_cache


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


COMMON = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, max_position_embeddings=512, bos_token_id=0,
              eos_token_id=1)
FAMILIES = {
    "qwen3": lambda: transformers.Qwen3ForCausalLM(transformers.Qwen3Config(
        **COMMON, num_key_value_heads=2, head_dim=16, rope_theta=1e6, rms_norm_eps=1e-6,
        tie_word_embeddings=True)),
    "llama": lambda: transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **dict(COMMON, vocab_size=256), num_key_value_heads=4, tie_word_embeddings=False)),
    "phi3": lambda: transformers.Phi3ForCausalLM(transformers.Phi3Config(
        **COMMON, num_key_value_heads=2, rms_norm_eps=1e-5, tie_word_embeddings=False,
        pad_token_id=0)),
    "opt": lambda: transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=512, word_embed_proj_dim=64,
        do_layer_norm_before=True, bos_token_id=0, eos_token_id=1, pad_token_id=0)),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """family -> (directory, the transformers model that wrote it), float32."""
    out = {}
    for name, make in FAMILIES.items():
        torch.manual_seed(0)
        model = make().to(torch.float32).eval()
        path = tmp_path_factory.mktemp(f"ckpt-{name}")
        model.save_pretrained(path, safe_serialization=True)
        out[name] = (str(path), model)
    return out


def _cfgs(path):
    hf = json.loads(open(f"{path}/config.json").read())
    return (dataclasses.replace(config_from_hf_json("ckpt", hf), dtype="float32"),
            dataclasses.replace(jax_config_from_hf_json("ckpt", hf), dtype="float32"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tree_equals_the_jax_loaders_leaf_for_leaf(checkpoints, family):
    path, _ = checkpoints[family]
    cfg, jcfg = _cfgs(path)
    ours = dict(_leaves(load_hf_checkpoint(cfg, path, "cpu")))
    ref = dict(_leaves(jax.tree.map(np.asarray, jax_weights.load_hf_checkpoint(jcfg, path))))
    assert sorted(ours) == sorted(ref)
    for name, leaf in ours.items():
        assert leaf.dtype == torch.float32 and leaf.is_contiguous(), name
        np.testing.assert_array_equal(leaf.numpy(), ref[name], err_msg=name)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_logits_match_transformers(checkpoints, family):
    path, model = checkpoints[family]
    cfg, _ = _cfgs(path)
    params = load_hf_checkpoint(cfg, path, "cpu")
    rng = np.random.default_rng(0)
    B, T = 2, 12
    tokens = rng.integers(2, cfg.vocab_size, size=(B, T)).astype(np.int32)
    cache_cfg = CacheConfig(block_size=4, num_blocks=8, max_blocks_per_seq=4, dtype="float32")
    cache = create_kv_cache(cfg, cache_cfg, "cpu")
    slots = np.arange(B * T, dtype=np.int32).reshape(B, T)
    lens = np.full((B,), T, np.int32)
    ours, _ = transformer.prefill(params, cfg, torch.from_numpy(tokens), torch.from_numpy(lens),
                                  torch.from_numpy(slots), cache, attn_impl="reference")
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens).long()).logits[:, -1].numpy()
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_engine_with_checkpoint_dir_gives_transformers_greedy_tokens(checkpoints, family):
    path, model = checkpoints[family]
    cfg, _ = _cfgs(path)
    eng = Engine(EngineConfig(model=path, checkpoint_dir=path,
                              cache=CacheConfig(block_size=4, num_blocks=64,
                                                max_blocks_per_seq=16, dtype="float32"),
                              scheduler=SchedulerConfig(max_num_seqs=4, min_prefill_bucket=8,
                                                        min_decode_bucket=2)),
                 model_cfg=cfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (5, 11)]
    outs = eng.generate(prompts, SamplingParams(max_tokens=8, temperature=0.0,
                                                ignore_eos=True))
    for prompt, req in zip(prompts, outs):
        ids = list(prompt)
        with torch.no_grad():
            for _ in range(8):
                ids.append(int(model(torch.tensor([ids])).logits[0, -1].argmax()))
        assert req.output_token_ids == ids[len(prompt):]


def _safetensors_files(path):
    ref = {}
    for f in glob.glob(f"{path}/*.safetensors"):
        part = load_file(f)
        assert not set(part) & set(ref)
        ref.update(part)
    return ref


@pytest.mark.parametrize("shard", [None, "40KB"], ids=["one_file", "sharded"])
def test_parser_agrees_with_the_safetensors_package_bit_for_bit(tmp_path, shard):
    torch.manual_seed(0)
    model = FAMILIES["qwen3"]().to(torch.bfloat16)
    kw = {"max_shard_size": shard} if shard else {}
    model.save_pretrained(tmp_path, safe_serialization=True, **kw)
    files = glob.glob(f"{tmp_path}/*.safetensors")
    assert (len(files) > 1) == (shard is not None)
    ref = _safetensors_files(tmp_path)
    with read_safetensors(str(tmp_path)) as raw:
        assert sorted(raw) == sorted(ref)
        for name in raw:
            t = raw[name]
            assert t.dtype == ref[name].dtype == torch.bfloat16
            assert torch.equal(t.view(torch.int16), ref[name].view(torch.int16)), name
            del t
    # the bf16 model loads leaf for leaf from either layout
    hf = json.loads((tmp_path / "config.json").read_text())
    cfg = config_from_hf_json("ckpt", hf)
    params = load_hf_checkpoint(cfg, str(tmp_path), "cpu")
    assert torch.equal(params["embed"]["weight"], ref["model.embed_tokens.weight"])
    assert torch.equal(params["layers"][1]["q_proj"]["kernel"],
                       ref["model.layers.1.self_attn.q_proj.weight"].T)
    assert "lm_head" not in params                       # tied embeddings


def test_parser_dtypes_and_duplicate_names(tmp_path):
    from safetensors.torch import save_file
    tensors = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
               "b": torch.arange(4, dtype=torch.float16),
               "c": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
               "d": torch.zeros((0, 3), dtype=torch.float32)}
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    with read_safetensors(str(tmp_path)) as raw:
        assert sorted(raw) == sorted(tensors)
        for k, v in tensors.items():
            assert raw[k].dtype == v.dtype and torch.equal(raw[k], v), k
    save_file({"a": torch.ones(2)}, str(tmp_path / "y.safetensors"))
    with pytest.raises(ValueError, match="more than one file"):
        read_safetensors(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        read_safetensors(str(tmp_path / "missing"))


def test_moe_checkpoint_raises_the_a8_error(tmp_path):
    """An MoE checkpoint with MLA attention (DeepSeek-V3) loads since MLA
    is ported: its logits are transformers' (tests/test_torch_mla.py also
    holds it and DeepSeek-V2 against the JAX loader)."""
    torch.manual_seed(0)
    transformers.DeepseekV3ForCausalLM(transformers.DeepseekV3Config(
        **COMMON, num_key_value_heads=4, n_routed_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=32, n_group=1, topk_group=1, kv_lora_rank=32,
        q_lora_rank=24, qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
        first_k_dense_replace=1, tie_word_embeddings=True,
    )).save_pretrained(tmp_path, safe_serialization=True)
    cfg = config_from_hf_json("moe", json.loads((tmp_path / "config.json").read_text()))
    assert cfg.num_experts and cfg.is_mla
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = load_hf_checkpoint(cfg, str(tmp_path), "cpu")
    model = transformers.DeepseekV3ForCausalLM.from_pretrained(tmp_path).to(torch.float32).eval()
    tokens = np.random.default_rng(7).integers(2, cfg.vocab_size, (2, 12)).astype(np.int32)
    slots = np.arange(24, dtype=np.int32).reshape(2, 12)
    cache = create_kv_cache(cfg, CacheConfig(block_size=4, num_blocks=8, max_blocks_per_seq=4,
                                             dtype="float32"), "cpu")
    ours, _ = transformer.prefill(params, cfg, torch.from_numpy(tokens),
                                  torch.full((2,), 12, dtype=torch.int32),
                                  torch.from_numpy(slots), cache)
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens).long()).logits[:, -1].numpy()
    np.testing.assert_allclose(ours.numpy(), ref, atol=3e-4, rtol=3e-4)


def test_load_or_init_random_inits_without_safetensors(tmp_path):
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    from tpuserve_torch.models.weights import init_params
    want = init_params(cfg, 3, "cpu")
    for ckpt in (None, str(tmp_path)):
        got = load_or_init(cfg, ckpt, 3, "cpu")
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(got), _leaves(want)))


# ---- F1: the tokenizer comes from the checkpoint directory -----------------

def _write_tokenizer(path):
    """A word-level tokenizer authored locally and saved by transformers."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    words = ["<unk>", "</s>", "hello", "world", "paged", "attention", "on", "a", "card"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                                                eos_token="</s>")
    fast.save_pretrained(path)


def test_engine_loads_the_checkpoints_tokenizer(checkpoints, tmp_path):
    path, _ = checkpoints["qwen3"]
    ckpt = tmp_path / "with-tokenizer"
    ckpt.mkdir()
    for f in glob.glob(f"{path}/*"):
        (ckpt / f.split("/")[-1]).write_bytes(open(f, "rb").read())
    _write_tokenizer(ckpt)
    cfg, jcfg = _cfgs(path)
    cache = dict(block_size=4, num_blocks=32, max_blocks_per_seq=8, dtype="float32")
    # the model is named by registry, not by the directory: only the
    # checkpoint directory holds the tokenizer files
    eng = Engine(EngineConfig(model="tiny-qwen3", checkpoint_dir=str(ckpt),
                              cache=CacheConfig(**cache)), model_cfg=cfg, device="cpu")
    jeng = jax_rt.Engine(jax_rt.EngineConfig(model="tiny-qwen3", checkpoint_dir=str(ckpt),
                                             cache=jax_rt.CacheConfig(**cache),
                                             kv_tiers=False, slo_classes=False),
                         model_cfg=jcfg)
    assert isinstance(eng.tokenizer, HFTokenizer)
    assert type(jeng.tokenizer).__name__ == "HFTokenizer"
    for text in ("hello world", "paged attention on a card", "hello unknown card"):
        assert eng.tokenizer.encode(text) == jeng.tokenizer.encode(text)
        assert eng.tokenizer.encode(text) != []
    assert eng.tokenizer.eos_token_ids == jeng.tokenizer.eos_token_ids == {1}


# ---- F2: admission deadlines -----------------------------------------------

def _deadline_run(make):
    """Queue three requests under a VirtualClock (one due at t=1, one at
    t=10, one without a deadline), move the clock to t=2, step to the end.
    Returns the engine's errors, each request's tokens and the free blocks
    before and after."""
    clock = VirtualClock()
    eng = make(clock)
    free0 = eng.block_manager.num_free_blocks
    sp = lambda: make.params(max_tokens=4, temperature=0.0, ignore_eos=True)  # noqa: E731
    eng.add_request(prompt_token_ids=[5, 6, 7], params=sp(), request_id="late", deadline=1.0)
    eng.add_request(prompt_token_ids=[8, 9], params=sp(), request_id="early", deadline=10.0)
    eng.add_request(prompt_token_ids=[3, 4, 5, 6], params=sp(), request_id="none")
    clock.advance_to(2.0)
    errors = []
    while eng.has_work():
        eng.step()
        errors += eng.drain_request_errors()
    toks = {rid: eng.requests[rid].output_token_ids for rid in ("early", "none")}
    late = eng.requests.pop("late", None)
    return ([(rid, type(e).__name__, str(e)) for rid, e in errors], toks,
            late is None or late.finish_reason.value, free0,
            eng.block_manager.num_free_blocks)


def test_queued_request_past_its_deadline_is_aborted_as_the_jax_engine_does():
    jcfg_model = dataclasses.replace(jax_get_model_config("tiny-qwen3"), dtype="float32")
    jparams = jax_weights.init_params(jcfg_model, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    cache = dict(block_size=4, num_blocks=32, max_blocks_per_seq=8, dtype="float32")
    sched = dict(max_num_seqs=4, min_prefill_bucket=8, min_decode_bucket=2)

    def port(clock):
        return Engine(EngineConfig(model="tiny-qwen3", cache=CacheConfig(**cache),
                                   scheduler=SchedulerConfig(**sched), clock=clock),
                      params=params, model_cfg=cfg, device="cpu")
    port.params = SamplingParams

    def jax_engine(clock):
        return jax_rt.Engine(jax_rt.EngineConfig(
            model="tiny-qwen3", cache=jax_rt.CacheConfig(**cache),
            scheduler=jax_rt.SchedulerConfig(allow_chunked_prefill=False, **sched),
            attn_impl="reference", multi_step=1, kv_tiers=False, slo_classes=False,
            clock=clock), params=jparams, model_cfg=jcfg_model)
    jax_engine.params = jax_rt.SamplingParams

    ours, ref = _deadline_run(port), _deadline_run(jax_engine)
    assert ours == ref
    errors, toks, late_reason, free0, free1 = ours
    assert errors == [("late", "TimeoutError", "request deadline expired before admission "
                                               "(engine overloaded); aborted queue-side")]
    assert all(len(t) == 4 for t in toks.values())
    assert free1 == free0              # nothing held, nothing leaked
