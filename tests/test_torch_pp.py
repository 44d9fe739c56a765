"""Pipeline stages on the CPU: the port's pipeline parallelism
(``tpuserve_torch/parallel/pipeline.py``, the engine's pp mode) in 2, 3
and 4 gloo processes, against the JAX package's pipeline on its 8-device
CPU mesh.

Each spawn starts its ranks through ``multihost.spawn_ranks`` (the
launcher ``--pp`` uses) with a ``file://`` store under ``tmp_path`` and a
hard timeout.  The ranks run ``pp_prefill`` and ``pp_decode_step`` at the
function level on ``tests/test_pipeline.py``'s cases (logits and every
stage's cache layers against the JAX ``pp_prefill`` / ``pp_decode_step``,
an int8 cache; a ``pp_decode_multi`` window against the one-device
``decode_multi``), then engines on their mesh: rank 0 serves
``tests/test_engine_pp.py``'s prompts, the followers mirror every step.
Greedy streams equal the JAX pp engine's exactly (pp 2, 3 and 4, and with
an int8 cache); windows with penalties, a bias, ``min_tokens`` and
logprobs equal it too; seeded sampling, whose noise is the port's own,
equals the port's one-device engine; float32 logits agree within 1e-4.  Every refusal of the JAX
pipeline engine is reproduced.  The file is also the ranks' program
(``python tests/test_torch_pp.py SPEC.json``), which imports no JAX.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpuserve_torch.models.config import get_model_config  # noqa: E402
from tpuserve_torch.parallel import multihost  # noqa: E402
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig,  # noqa: E402
                                    SamplingParams, SchedulerConfig)

BLOCK, NBLOCKS, MAX_BPS = 4, 64, 8          # tests/test_pipeline.py's cache
FN_CASES = {2: [2, 1], 4: [2, 4]}           # pp -> microbatch counts
ENGINE_CACHE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16)
ENGINE_SCHED = dict(max_num_seqs=8, max_prefill_seqs=4, max_prefill_tokens=512)
GREEDY = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
EXTRAS = [dict(max_tokens=8, temperature=0.0, presence_penalty=0.8, frequency_penalty=0.4,
               ignore_eos=True),
          dict(max_tokens=8, temperature=0.8, seed=5, top_p=0.9, logit_bias={7: 3.0},
               ignore_eos=True),
          dict(max_tokens=8, temperature=0.0, min_tokens=5, logprobs=2)]
TIMEOUT_S = 240
# a prompt past the chunk size, batched (the pp engine closes every chunk
# route; the references close it too, as tests/test_engine_pp.py's golden)
LONG_SCHED = dict(prefill_chunk_size=16, allow_chunked_prefill=False)


def _prompts(seed: int, sizes) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, size=n).tolist() for n in sizes]


# tests/test_engine_pp.py's workloads: (prompts, sampling, multi_step)
SCENARIOS = {
    "main": (_prompts(3, (5, 9, 12, 7)), [GREEDY], 1),
    "windows": (_prompts(8, (6, 6, 6)), [dict(max_tokens=9, temperature=0.0, ignore_eos=True),
                                          dict(max_tokens=9, temperature=0.8, seed=13,
                                               ignore_eos=True)], 4),
    "extras": (_prompts(12, (6, 6, 6)), EXTRAS, 4),
    "long": (_prompts(5, (21,)), [dict(GREEDY, max_tokens=4)], 1),
    "int8": (_prompts(3, (5, 9, 12, 7)), [GREEDY], 4),
}
# each scenario's scheduler and cache settings past the defaults
SCENARIO_ENGINE = {"long": dict(sched=LONG_SCHED), "int8": dict(cache=dict(dtype="int8"))}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def model_cfg(layers: int):
    return dataclasses.replace(get_model_config("tiny-qwen3"), num_layers=layers,
                               dtype="float32")


def engine_config(multi_step: int = 1, sched=None, cache=None) -> EngineConfig:
    return EngineConfig(model="tiny-qwen3",
                        cache=CacheConfig(**dict(ENGINE_CACHE, **(cache or {}))),
                        scheduler=SchedulerConfig(**dict(ENGINE_SCHED, **(sched or {}))),
                        multi_step=multi_step)


def scenario_config(name: str) -> EngineConfig:
    return engine_config(SCENARIOS[name][2], **SCENARIO_ENGINE.get(name, {}))


def sampling(p: dict) -> SamplingParams:
    return SamplingParams(**p)


def serve(eng, name: str) -> dict:
    """Rank 0's (or the one-device engine's) run of a scenario: each
    stream's tokens, logprob entries' token ids, and the first prefill's
    and decode step's float32 logits where a single step kept them."""
    prompts, plist, _ms = SCENARIOS[name]
    plist = [plist[i % len(plist)] for i in range(len(prompts))]
    reqs = eng.generate(prompts, [sampling(p) for p in plist])
    out = {"tokens": [r.output_token_ids for r in reqs],
           "logprob_ids": [[e["token_id"] for e in r.logprobs] if r.logprobs else None
                           for r in reqs]}
    exes = eng.graphs.executables
    for kind in ("prefill", "decode"):
        keys = [k for k in exes if k[0] == kind and exes[k].logits is not None]
        if keys:
            out[f"{kind}_logits"] = exes[keys[0]].logits[:len(prompts)].tolist()
    return out


# ---------------------------------------------------------------------------
# The ranks' program
# ---------------------------------------------------------------------------

def fn_inputs(cfg, B: int, T: int) -> tuple:
    """``tests/test_pipeline.py``'s ``_setup`` inputs, drawn the same way."""
    from tpuserve_torch.ops.attention import PAD_SLOT
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size - 1, size=(B, T)).astype(np.int32)
    prompt_lens = rng.integers(T // 2, T + 1, size=(B,)).astype(np.int32)
    block_tables = np.arange(B * MAX_BPS, dtype=np.int32).reshape(B, MAX_BPS)
    slot_ids = np.full((B, T), PAD_SLOT, np.int32)
    for i in range(B):
        n = prompt_lens[i]
        slot_ids[i, :n] = block_tables[i, np.arange(n) // BLOCK] * BLOCK + np.arange(n) % BLOCK
    d_slots = np.asarray([block_tables[i, prompt_lens[i] // BLOCK] * BLOCK
                          + prompt_lens[i] % BLOCK for i in range(B)], np.int32)
    return tokens, prompt_lens, slot_ids, block_tables, d_slots


def run_functions(mesh, micro: int, kv_dtype: str, decode: bool) -> dict:
    """One function-level case on this stage: ``pp_prefill`` then (with
    ``decode``) ``pp_decode_step`` on the next tokens stage 0 picks; 4
    layers at B 4 x T 8, or 2 layers at B 2 x T 6 (the int8 case)."""
    from tpuserve_torch.models.weights import init_params
    from tpuserve_torch.parallel.pipeline import (pp_decode_multi, pp_decode_step, pp_prefill,
                                                  stage_config, stage_params)
    from tpuserve_torch.runtime.kv_cache import create_kv_cache
    cfg = model_cfg(4 if decode else 2)
    B, T = (4, 8) if decode else (2, 6)
    tokens, lens, slots, bt, d_slots = (torch.from_numpy(a) for a in fn_inputs(cfg, B, T))
    params = stage_params(init_params(cfg, 0, "cpu"), cfg, mesh.cfg.pp, mesh.rank)
    scfg = stage_config(cfg, mesh.stage)
    cache = create_kv_cache(scfg, CacheConfig(block_size=BLOCK, num_blocks=NBLOCKS,
                                              max_blocks_per_seq=MAX_BPS, dtype=kv_dtype), "cpu")
    logits, cache = pp_prefill(params, scfg, tokens, lens, slots, cache, num_microbatches=micro)
    out = {"prefill": logits}
    if decode:
        nxt = (torch.argmax(logits, -1).to(torch.int32) if logits is not None
               else torch.zeros(B, dtype=torch.int32))
        out["decode"], cache = pp_decode_step(params, scfg, nxt, lens, d_slots, bt, lens + 1,
                                              cache, num_microbatches=micro)
    out["cache"] = [{k: v.clone() for k, v in e.items()} for e in cache]
    if decode:
        # then a 3-iteration greedy window from the step's tokens
        nxt = (torch.argmax(out["decode"], -1).to(torch.int32) if out["decode"] is not None
               else torch.zeros(B, dtype=torch.int32))
        out["window"] = pp_decode_multi(params, scfg, nxt, lens + 1, bt, lens + 2,
                                        torch.ones(B, dtype=torch.bool), torch.zeros(B), cache,
                                        steps=3, num_microbatches=micro)[0]
    return out


def gates(mesh, cfg) -> dict:
    """The JAX pipeline engine's refusals that fire while an engine is
    built (every rank builds, every rank refuses alike): their exception
    types and messages."""
    from tpuserve_torch.runtime.spec import SpecConfig
    cases = {
        "speculative": (engine_config(), cfg, dict(speculative=SpecConfig(num_draft_tokens=2))),
        "mla": (engine_config(), dataclasses.replace(get_model_config("tiny-deepseek"),
                                                     dtype="float32"), {}),
        "windows": (engine_config(), dataclasses.replace(get_model_config("tiny-gemma2"),
                                                         dtype="float32"), {}),
        "moe": (engine_config(), dataclasses.replace(get_model_config("tiny-moe"),
                                                     dtype="float32"), {}),
        "layers": (engine_config(), model_cfg(mesh.cfg.pp + 1), {}),
        "lora": (engine_config(), cfg, dict(lora_modules={"a": "/nonexistent"})),
    }
    out = {}
    for name, (conf, mcfg, kw) in cases.items():
        conf = dataclasses.replace(conf, model=mcfg.name, **kw)
        try:
            Engine(conf, model_cfg=mcfg, mesh=mesh, device="cpu")
            out[name] = None
        except Exception as e:      # noqa: BLE001 - the type is compared
            out[name] = [type(e).__name__, str(e)]
    return out


def disagg_gate(mesh) -> list | None:
    """``DisaggregatedEngine`` on the pp mesh: the JAX refusal."""
    from tpuserve_torch.parallel.disagg import DisaggregatedEngine
    try:
        DisaggregatedEngine(engine_config(), engine_config(), mesh=mesh, device="cpu")
    except Exception as e:      # noqa: BLE001
        return [type(e).__name__, str(e)]
    return None


def engine_gates(eng) -> dict:
    """Rank 0's refusals on a built pp engine: the prompt-score budget at
    intake, embeddings, prompt scoring, KV adoption."""
    out = {"chunked": eng.scheduler.cfg.allow_chunked_prefill,
           "mixed": eng.scheduler.cfg.mixed_batching,
           "graphs": eng.graphs.capture}
    budget = eng.PP_PREFILL_SCORE_BUDGET_BYTES
    eng.PP_PREFILL_SCORE_BUDGET_BYTES = 1024
    calls = {
        "budget": lambda: eng.add_request(prompt_token_ids=[1] * 20,
                                          params=SamplingParams(max_tokens=8)),
        "embed": lambda: eng.embed(["hello"]),
        "score": lambda: eng.score_prompts([[1, 2, 3]]),
        "adopt": lambda: eng.adopt_prefilled("x", [1, 2], 3, SamplingParams(max_tokens=1),
                                             seq_kv=[]),
    }
    for name, fn in calls.items():
        try:
            fn()
            out[name] = None
        except Exception as e:      # noqa: BLE001
            out[name] = [type(e).__name__, str(e)]
    eng.PP_PREFILL_SCORE_BUDGET_BYTES = budget
    return out


def _worker(spec_path: str) -> None:
    from tpuserve_torch.parallel.mesh import MeshConfig, make_mesh, multihost_initialize
    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    multihost_initialize("cpu", init_method=os.environ["TPUSERVE_INIT_METHOD"],
                         timeout_s=120)
    pp = spec["pp"]
    mesh = make_mesh(MeshConfig(pp=pp), device_type="cpu", timeout_s=120)
    cfg = model_cfg(spec["layers"])
    res = {"functions": {}, "engines": {}}
    for micro in spec["micro"]:
        res["functions"][f"f32-{micro}"] = run_functions(mesh, micro, "float32", True)
    if spec["int8"]:
        res["functions"]["int8"] = run_functions(mesh, 0, "int8", False)
    if spec["gates"]:
        res["gates"] = gates(mesh, cfg)
        res["gates"]["disagg"] = disagg_gate(mesh)
        # an auto-sized cache: every stage takes the fewest blocks any holds
        conf = engine_config()
        eng = Engine(dataclasses.replace(conf, cache=dataclasses.replace(conf.cache, num_blocks=0)),
                     model_cfg=cfg, mesh=mesh, device="cpu")
        res["auto_blocks"] = eng.cache_cfg.num_blocks
        if mesh.is_coordinator:
            eng.stop_followers()
        else:
            multihost.follower_loop(eng)
    for name in spec["scenarios"]:
        eng = Engine(scenario_config(name), model_cfg=cfg, mesh=mesh, device="cpu")
        counts0 = mesh.stage.counts.copy()
        if mesh.is_coordinator:
            eng._lockstep.record = True
            if spec["gates"] and name == "main":
                res["engine_gates"] = engine_gates(eng)
                eng.warmup()        # the server's start: every stage pad-runs the ladder
            r = serve(eng, name)
            r["windows"] = [list(t.shape) for t in eng._lockstep.tokens]
            r["sent"] = dict(eng._lockstep.sent)
            eng.stop_followers()
        else:
            r = {"windows": [list(t.shape) for t in multihost.follower_loop(eng, record=True)]}
        ran = mesh.stage.counts - counts0
        r["transfers"] = [ran["sent"], ran["received"]]
        r["microbatches"] = {k: ran[k] for k in ("prefill", "decode") if ran[k]}
        r["cache_layers"] = len(eng.kv_cache)
        r["params"] = sorted(eng.params)
        r["replays"] = dict(eng.graphs.replays)
        res["engines"][name] = r
    torch.save(res, spec["out"] + f".rank{mesh.rank}.pt")
    import torch.distributed as dist
    dist.destroy_process_group()


def spawn(tmp_path, pp: int, layers: int, scenarios, micro=(), int8=False,
          gates_=False) -> list:
    """Run a spec on ``pp`` gloo stage ranks; each rank's results."""
    name = f"pp{pp}"
    out = str(tmp_path / name)
    spec = tmp_path / f"{name}.json"
    spec.write_text(json.dumps(dict(pp=pp, layers=layers, scenarios=list(scenarios),
                                    micro=list(micro), int8=int8, gates=gates_, out=out)))
    procs = multihost.spawn_ranks([None, __file__, str(spec)], pp, str(tmp_path / "logs"),
                                  f"file://{tmp_path}/store-{name}", ranks=range(pp),
                                  extra_env={"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    rcs = multihost.stop_ranks(procs, TIMEOUT_S)
    logs = {r: (tmp_path / "logs" / f"rank{r}.log").read_text()[-3000:] for r in procs}
    assert all(rc == 0 for rc in rcs.values()), (rcs, logs)
    return [torch.load(f"{out}.rank{r}.pt", weights_only=False) for r in range(pp)]


# ---------------------------------------------------------------------------
# The references: the port's one-device engine, the JAX package
# ---------------------------------------------------------------------------

def one_device(layers: int, names) -> dict:
    res = {}
    for name in names:
        eng = Engine(scenario_config(name), model_cfg=model_cfg(layers),
                     device="cpu")
        res[name] = serve(eng, name)
    return res


def jax_engine(layers: int, pp: int, name: str) -> dict:
    """A scenario on the JAX pipeline engine on a ('pp',) mesh of virtual
    CPU devices (``tests/test_engine_pp.py``'s config)."""
    from tpuserve import runtime as jax_rt
    from tpuserve.models.config import get_model_config as jax_model_config
    from tpuserve.parallel.mesh import MeshConfig as JaxMeshConfig
    from tpuserve.parallel.mesh import make_mesh as jax_make_mesh
    prompts, plist, ms = SCENARIOS[name]
    extra = SCENARIO_ENGINE.get(name, {})
    conf = jax_rt.EngineConfig(
        model="tiny-qwen3", cache=jax_rt.CacheConfig(**dict(ENGINE_CACHE,
                                                            **extra.get("cache", {}))),
        scheduler=jax_rt.SchedulerConfig(**dict(ENGINE_SCHED, **extra.get("sched", {}))),
        attn_impl="reference", multi_step=ms)
    eng = jax_rt.Engine(conf, model_cfg=dataclasses.replace(
        jax_model_config("tiny-qwen3"), num_layers=layers, dtype="float32"),
        mesh=jax_make_mesh(JaxMeshConfig(pp=pp)))
    plist = [plist[i % len(plist)] for i in range(len(prompts))]
    rids = [eng.add_request(prompt_token_ids=p, params=jax_rt.SamplingParams(**s))
            for p, s in zip(prompts, plist)]
    outs = {}
    while eng.has_work():
        for o in eng.step():
            outs.setdefault(o.request_id, []).extend(o.new_token_ids)
    return {"tokens": [outs[r] for r in rids],
            "logprob_ids": [[e["token_id"] for e in eng.requests[r].logprobs]
                            if eng.requests[r].logprobs else None for r in rids]}


def jax_functions(pp: int, micro: int, kv_dtype: str, decode: bool) -> dict:
    """``tests/test_pipeline.py``'s case on the JAX pipeline: logits and the
    unstacked per-layer cache."""
    import jax.numpy as jnp
    from tpuserve.models.config import get_model_config as jax_model_config
    from tpuserve.models.weights import init_params as jax_init
    from tpuserve.parallel.mesh import MeshConfig as JaxMeshConfig
    from tpuserve.parallel.mesh import make_mesh as jax_make_mesh
    from tpuserve.parallel.pipeline import (pp_decode_step, pp_prefill, stack_pipeline_cache,
                                            stack_pipeline_params, unstack_pipeline_cache)
    from tpuserve.runtime.kv_cache import CacheConfig as JaxCacheConfig
    from tpuserve.runtime.kv_cache import create_kv_cache as jax_cache
    cfg = dataclasses.replace(jax_model_config("tiny-qwen3"), num_layers=4 if decode else 2,
                              dtype="float32")
    B, T = (4, 8) if decode else (2, 6)
    tokens, lens, slots, bt, d_slots = (jnp.asarray(a) for a in fn_inputs(cfg, B, T))
    mesh = jax_make_mesh(JaxMeshConfig(pp=pp))
    head, stages = stack_pipeline_params(jax_init(cfg, seed=0), cfg, mesh)
    cache = stack_pipeline_cache(jax_cache(cfg, JaxCacheConfig(
        block_size=BLOCK, num_blocks=NBLOCKS, max_blocks_per_seq=MAX_BPS, dtype=kv_dtype)), mesh)
    logits, cache = pp_prefill(head, stages, cfg, tokens, lens, slots, cache, mesh=mesh,
                               num_microbatches=micro)
    out = {"prefill": np.asarray(logits)}
    if decode:
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        dl, cache = pp_decode_step(head, stages, cfg, nxt, lens, d_slots, bt, lens + 1, cache,
                                   mesh=mesh, num_microbatches=micro)
        out["decode"] = np.asarray(dl)
    out["cache"] = [{k: np.asarray(v) for k, v in e.items()}
                    for e in unstack_pipeline_cache(cache)]
    return out


def one_device_window() -> list:
    """The function-level case on the port's one-device transformer:
    prefill, one decode step, then the 3-iteration greedy window."""
    from tpuserve_torch.models import transformer
    from tpuserve_torch.models.weights import init_params
    from tpuserve_torch.runtime.kv_cache import create_kv_cache
    cfg = model_cfg(4)
    B = 4
    tokens, lens, slots, bt, d_slots = (torch.from_numpy(a) for a in fn_inputs(cfg, B, 8))
    params = init_params(cfg, 0, "cpu")
    cache = create_kv_cache(cfg, CacheConfig(block_size=BLOCK, num_blocks=NBLOCKS,
                                             max_blocks_per_seq=MAX_BPS, dtype="float32"), "cpu")
    logits, cache = transformer.prefill(params, cfg, tokens, lens, slots, cache)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    logits, cache = transformer.decode_step(params, cfg, nxt, lens, d_slots, bt, lens + 1, cache)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    return transformer.decode_multi(params, cfg, nxt, lens + 1, bt, lens + 2,
                                    torch.ones(B, dtype=torch.bool), torch.zeros(B), cache,
                                    steps=3)[0].tolist()


def check_functions(ranks: list, pp: int, key: str, micro: int, kv: str, decode: bool):
    """Stage 0's logits (and, in float32, every stage's cache layers)
    against the JAX pipeline's, rtol/atol 2e-5 (``tests/test_pipeline.py``'s
    tolerance)."""
    ref = jax_functions(pp, micro, kv, decode)
    got = ranks[0]["functions"][key]
    for name in ("prefill", "decode") if decode else ("prefill",):
        np.testing.assert_allclose(got[name].numpy(), ref[name], rtol=2e-5, atol=2e-5,
                                   err_msg=f"{key} {name}")
    for r in ranks[1:]:
        assert r["functions"][key]["prefill"] is None
    if decode:
        # pp_decode_multi: stage 0's window equals the one-device window's
        assert got["window"].tolist() == one_device_window()
    layers = [e for r in ranks for e in r["functions"][key]["cache"]]
    assert len(layers) == len(ref["cache"])
    if kv != "float32":
        return
    for g, w in zip(layers, ref["cache"]):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_allclose(g[k].float().numpy(), w[k].astype(np.float32),
                                       rtol=2e-5, atol=2e-5, err_msg=f"{key} cache {k}")


def check_streams(ranks: list, pp: int, layers: int, ref: dict) -> None:
    """Rank 0's streams equal the one-device engine's; every stage ran the
    same windows and its own layers only; stage 0 alone holds the head;
    the transfers match the steps."""
    for name, want in ref.items():
        lead = ranks[0]["engines"][name]
        assert lead["tokens"] == want["tokens"], name
        assert lead["logprob_ids"] == want["logprob_ids"], name
        for key in ("prefill_logits", "decode_logits"):
            if key in want:
                np.testing.assert_allclose(lead[key], want[key], atol=1e-4, rtol=0,
                                           err_msg=f"{name} {key}")
        assert lead["windows"], name
        for s, r in enumerate(ranks):
            e = r["engines"][name]
            assert e["windows"] == lead["windows"], (name, s)
            assert e["cache_layers"] == layers // pp
            assert ("embed" in e["params"]) == (s == 0) and "layers" in e["params"]
            assert s == 0 or e["params"] == ["layers"]
            assert e["replays"] == lead["replays"], (name, s)
            # every stage ran each step's microbatches through its layers
            assert e["microbatches"] == lead["microbatches"], (name, s)
            assert sum(e["microbatches"].values()) >= sum(lead["replays"].values())
        # each stage receives exactly what its predecessor sent
        for s in range(pp):
            assert ranks[s]["engines"][name]["transfers"][0] == \
                ranks[(s + 1) % pp]["engines"][name]["transfers"][1]


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def test_pp2_functions_engines_and_gates_match_jax(tmp_path):
    """pp 2: the function-level cases (microbatches 2 and 1) and an int8
    cache against the JAX pipeline; the main, windowed, extras, long
    prompt and int8-cache engines against the one-device engine and the JAX
    pp engine; every refusal of the JAX pipeline engine."""
    names = ("main", "windows", "extras", "long", "int8")
    ranks = spawn(tmp_path, 2, 4, names, micro=FN_CASES[2], int8=True, gates_=True)
    for micro in FN_CASES[2]:
        check_functions(ranks, 2, f"f32-{micro}", micro, "float32", True)
    check_functions(ranks, 2, "int8", 0, "int8", False)
    check_streams(ranks, 2, 4, one_device(4, names))
    lead = ranks[0]["engines"]
    for name in ("main", "long", "int8"):
        assert lead[name]["tokens"] == jax_engine(4, 2, name)["tokens"], name
    # the window extras: every deterministic row equals the JAX window's
    # (the seeded row samples the port's own noise: the one-device engine
    # holds it above)
    jx = jax_engine(4, 2, "extras")
    for i in (0, 2):
        assert lead["extras"]["tokens"][i] == jx["tokens"][i]
        assert lead["extras"]["logprob_ids"][i] == jx["logprob_ids"][i]
    assert lead["windows"]["tokens"][0] == jax_engine(4, 2, "windows")["tokens"][0]
    assert lead["windows"]["sent"]["run"] > 0
    # refusals: the JAX engine's types and messages
    g = ranks[0]["gates"]
    assert all(ranks[1]["gates"][k] == v for k, v in g.items())
    for name, says in (("speculative", "speculative"), ("mla", "DeepSeek"),
                       ("windows", "windows"), ("moe", "MoE"), ("layers", "not divisible"),
                       ("lora", "multi-LoRA"), ("disagg", "pipeline (pp) meshes")):
        assert g[name] is not None and g[name][0] == "ValueError" and says in g[name][1], name
    assert ranks[0]["auto_blocks"] == ranks[1]["auto_blocks"] > 0
    eg = ranks[0]["engine_gates"]
    assert (eg["chunked"], eg["mixed"], eg["graphs"]) == (False, False, False)
    for name, says in (("budget", "prompt budget"), ("embed", "pipeline engine"),
                       ("score", "pipeline engine"), ("adopt", "pipeline engine")):
        assert eg[name] is not None and eg[name][0] == "ValueError" and says in eg[name][1], name


def test_pp4_functions_and_engine_match_jax(tmp_path):
    """pp 4: microbatches 2 and 4 at the function level against the JAX
    pipeline; the main engine's greedy streams equal the JAX pp engine's."""
    ranks = spawn(tmp_path, 4, 4, ("main",), micro=FN_CASES[4])
    for micro in FN_CASES[4]:
        check_functions(ranks, 4, f"f32-{micro}", micro, "float32", True)
    check_streams(ranks, 4, 4, one_device(4, ("main",)))
    assert ranks[0]["engines"]["main"]["tokens"] == jax_engine(4, 4, "main")["tokens"]


def test_pp3_auto_microbatches_serve_power_of_two_buckets(tmp_path):
    """pp 3 over 3 layers: power-of-two batch buckets take fewer
    microbatches (``auto_microbatches``); the streams equal the JAX pp 3
    engine's."""
    from tpuserve_torch.parallel.pipeline import auto_microbatches
    assert [auto_microbatches(b, 3) for b in (1, 2, 4, 8, 6)] == [1, 2, 2, 2, 3]
    ranks = spawn(tmp_path, 3, 3, ("main",))
    check_streams(ranks, 3, 3, one_device(3, ("main",)))
    assert ranks[0]["engines"]["main"]["tokens"] == jax_engine(3, 3, "main")["tokens"]


def test_cli_pp2_serves_and_every_stage_exits(tmp_path):
    """``python -m tpuserve_torch.server --pp 2 --device cpu`` starts its
    second stage itself, serves a completion equal to the one-device
    engine's greedy text, and on SIGTERM drains and stops both stages."""
    import signal
    import subprocess
    import time
    import urllib.request
    argv = ["--pp", "2", "--device", "cpu", "--model", "tiny-qwen3", "--port", "0",
            "--host", "127.0.0.1", "--block-size", "4", "--num-blocks", "64",
            "--max-blocks-per-seq", "16", "--max-num-seqs", "4", "--no-warmup"]
    log_path = tmp_path / "rank0.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT), TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "tpuserve_torch.server", *argv],
                                stdout=log, stderr=subprocess.STDOUT, env=env,
                                stdin=subprocess.DEVNULL)
    try:
        deadline, port = time.monotonic() + 120, None
        while port is None and time.monotonic() < deadline and proc.poll() is None:
            text = log_path.read_text()
            if "listening on" in text:
                port = int(text.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
            time.sleep(0.2)
        assert port is not None, log_path.read_text()[-3000:]
        body = json.dumps({"prompt": [5, 6, 7], "max_tokens": 8, "temperature": 0,
                           "ignore_eos": True}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=120).read())
        eng = Engine(EngineConfig(model="tiny-qwen3", cache=CacheConfig(
            block_size=4, num_blocks=64, max_blocks_per_seq=16)), device="cpu")
        want = eng.generate([[5, 6, 7]], SamplingParams(**GREEDY))[0]
        assert out["usage"]["completion_tokens"] == len(want.output_token_ids) == 8
        assert out["choices"][0]["text"] == want.output_text
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=90) == 0, log_path.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_pipeline_compatibility_refusals_match_jax():
    """``check_pipeline_compatible`` refuses what the JAX one refuses, with
    its messages, and a stage keeps its own layers."""
    from tpuserve.models.config import get_model_config as jax_model_config
    from tpuserve.parallel.pipeline import check_pipeline_compatible as jax_check
    from tpuserve_torch.parallel.pipeline import (check_pipeline_compatible, stage_layers,
                                                  stage_params)
    for name, layers, pp in (("tiny-qwen3", 3, 2), ("tiny-gemma2", None, 2),
                             ("tiny-moe", None, 2), ("tiny-qwen3", 4, 0)):
        cfg, jcfg = get_model_config(name), jax_model_config(name)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
            jcfg = dataclasses.replace(jcfg, num_layers=layers)
        with pytest.raises(ValueError) as want:
            jax_check(jcfg, pp)
        with pytest.raises(ValueError) as got:
            check_pipeline_compatible(cfg, pp)
        assert str(got.value) == str(want.value)
    assert list(stage_layers(8, 4, 2)) == [4, 5]
    tree = {"embed": 0, "final_norm": 1, "layers": list(range(8))}
    assert stage_params(tree, model_cfg(8), 4, 1) == {"layers": [2, 3]}
    assert stage_params(tree, model_cfg(8), 4, 0) == {"embed": 0, "final_norm": 1,
                                                      "layers": [0, 1]}


if __name__ == "__main__":
    _worker(sys.argv[1])
