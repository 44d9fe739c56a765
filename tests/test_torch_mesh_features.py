"""What a tp / ep mesh serves beside the plain streams, on the CPU: the KV
tiers, guided decoding, embeddings and prompt scoring, and speculation, in
2 gloo ranks of tiny-qwen3 in lockstep (``tpuserve_torch/parallel/
multihost.py``'s tier, trunk and grammar ops).

One spawn (``multihost.spawn_ranks``, a ``file://`` store under the test's
directory, logs to files, a hard timeout that kills every rank) runs every
scenario; while it runs, this process computes the two references: the
port's one-device engine on the same seed (tokens equal; embeddings and
score logprobs within atol 1e-4 in float32; tier and speculation counters
equal) and the JAX engine on a tp 2 mesh of the virtual CPU devices
(greedy tokens equal; embeddings and logprobs within 1e-4).  In every
scenario the followers' recorded window tokens equal rank 0's.  A planted
fault deletes one spill file on the follower only: the ranks restore the
shorter prefix they agree on, and the tokens still equal a twin that never
evicted.  Under ``mesh.multihost`` (several nodes) the tiers are off and
guided decoding, embeddings and scoring raise the JAX multi-process
errors.  The file is also the ranks' program (``python
tests/test_torch_mesh_features.py SPEC.json``), which imports no JAX.
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

from tpuserve_torch.models.config import get_model_config, register_model_config  # noqa: E402
from tpuserve_torch.parallel import multihost  # noqa: E402
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig,  # noqa: E402
                                    SamplingParams, SchedulerConfig)
from tpuserve_torch.runtime.spec import SpecConfig  # noqa: E402

ATOL = 1e-4
MODEL = "tiny-qwen3"
# a one-layer float32 draft of the target's shapes, registered in both
# packages (the ranks register it too)
DRAFT = "tiny-qwen3-draft1"
CACHE = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16, dtype="float32")
SCHED = dict(max_num_seqs=4, max_prefill_tokens=256, min_prefill_bucket=8,
             min_decode_bucket=2)
GREEDY = dict(max_tokens=6, temperature=0.0, ignore_eos=True)

# tiers: a 24-block cache, 3 of tiny-qwen3's 2,048-byte float32 pages in
# host DRAM (the rest of an evicted chain spills)
TIER_CACHE = dict(CACHE, num_blocks=24)
TIER_HOST_BYTES = 3 * 2048
SHARED = list(range(2, 26))                  # 24 tokens: 6 full blocks
TIER_STEPS = (("first", [SHARED + [30]]), ("churn", [[100 + i] * 40 for i in range(3)]),
              ("hit", [SHARED + [77]]))

SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string"}, "ok": {"type": "boolean"},
                         "mood": {"enum": ["up", "down"]}},
          "required": ["name", "ok", "mood"], "additionalProperties": False}
CHOICES = ["yes", "no", "maybe"]
GUIDED_PROMPTS = [[73, 135, 115, 53, 66, 144, 120, 102, 69, 152, 80, 67], [168, 164, 61, 118]]
GUIDED = (("json_schema", json.dumps(SCHEMA), 40), ("choice", json.dumps(CHOICES), 12))

TEXTS = [[5, 6, 7], list(range(10, 30)), [40, 41, 42, 43, 44, 45, 46, 47, 48]]
REPETITIVE = [[1, 2, 3, 4] * 5, [9, 8, 7] * 4]
SPEC_PARAMS = dict(max_tokens=12, temperature=0.0, ignore_eos=True)
SPECS = {"spec_ngram": dict(num_draft_tokens=4),
         "spec_draft": dict(num_draft_tokens=3, draft_model=DRAFT, adaptive=False)}
SCENARIOS = ("tiers", "tiers_fault", "tiers_restart", "guided", "trunks", "spec_ngram",
             "spec_draft", "multihost")
# spill files an earlier run left: one in both ranks' directories, one in
# rank 1's alone
RESTART_FILES = {0: (0x1234,), 1: (0x1234, 0x5678)}


def register_draft() -> None:
    register_model_config(dataclasses.replace(get_model_config(MODEL), name=DRAFT,
                                              num_layers=1, dtype="float32"))


def model_cfg():
    return dataclasses.replace(get_model_config(MODEL), dtype="float32")


def engine_config(name: str, spill_dir: str = "") -> EngineConfig:
    kw = dict(multi_step=4)
    cache = CACHE
    if name.startswith("tiers"):
        cache = TIER_CACHE
        kw.update(kv_tiers=True, kv_host_bytes=TIER_HOST_BYTES, kv_spill_dir=spill_dir)
    elif name in SPECS:
        kw.update(speculative=SpecConfig(**SPECS[name]), enable_prefix_caching=False)
    return EngineConfig(model=MODEL, cache=CacheConfig(**cache),
                        scheduler=SchedulerConfig(**SCHED), **kw)


def counters(eng) -> dict:
    s = eng.stats
    return {"tiers": eng.kv_tier_blocks(), "demoted": s.kv_demoted_blocks,
            "restores": s.kv_restores, "restored": s.kv_restored_blocks}


def serve(eng, name: str) -> dict:
    """Rank 0's (or the one-device engine's) work of scenario ``name``."""
    out: dict = {}
    if name.startswith("tiers"):
        out["steps"] = []
        for _label, ps in TIER_STEPS:
            reqs = eng.generate(ps, SamplingParams(**GREEDY))
            out["steps"].append({"tokens": [r.output_token_ids for r in reqs],
                                 **counters(eng)})
        # the hit's suffix ran as a chunk over the restored pages
        chunk = [e for k, e in eng.graphs.executables.items() if k[0] == "chunk"]
        out["hit_logits"] = chunk[-1].logits[:1].tolist()
        eng._kv_tiers.flush()
        out["hashes"] = sorted(eng._kv_tiers.hashes())
    elif name == "guided":
        out["guided"] = []
        for mode, spec, n in GUIDED:
            reqs = eng.generate(GUIDED_PROMPTS, SamplingParams(
                max_tokens=n, temperature=0.0, guided=mode, guided_schema=spec))
            out["guided"].append([[r.output_token_ids, r.output_text, r.finish_reason.value]
                                  for r in reqs])
        out["windows"] = eng.stats.num_decode_windows
    elif name == "trunks":
        out["embed"] = {p: eng.embed(TEXTS, pooling=p)[0].tolist() for p in ("mean", "last")}
        out["score"] = [[[e["token_id"], e["logprob"], e["rank"], e["top"]] for e in entries]
                        for entries in eng.score_prompts(TEXTS, top_n=2)]
    elif name in SPECS:
        reqs = eng.generate(REPETITIVE, SamplingParams(**SPEC_PARAMS))
        out["tokens"] = [r.output_token_ids for r in reqs]
        out["spec"] = [eng.stats.spec_steps, eng.stats.spec_proposed, eng.stats.spec_accepted]
    return out


def plant_spill_fault(eng, note: dict) -> None:
    """On a follower only: before its first restore, delete the spill file
    of the last span entry held in the spill tier (mid-chain: the oldest
    blocks spilled first)."""
    orig = eng._exec_restore

    def restore(span):
        store = eng._kv_tiers
        store.flush()
        if "fault_at" not in note:
            for i, h in reversed(list(enumerate(span))):
                if store.where(h) == "spill" and h in store._spill:
                    os.remove(store._spill[h])
                    note["fault_at"] = i
                    break
        return orig(span)
    eng._exec_restore = restore


def plant_spill_files(spill_dir: str, rank: int) -> None:
    """The files an earlier run left in this rank's spill directory."""
    os.makedirs(os.path.join(spill_dir, f"rank{rank}"), exist_ok=True)
    for h in RESTART_FILES[rank]:
        np.savez(os.path.join(spill_dir, f"rank{rank}", f"kvt_{h:016x}.npz"),
                 **{"0.k": np.zeros(4, np.float32)})


def multihost_refusals(eng) -> dict:
    """Rank 0 under ``mesh.multihost``: each refusal's message."""
    out = {"tiers_off": eng._kv_tiers is None}
    for what, call in (
            ("guided", lambda: eng.add_request(prompt_token_ids=[1, 2], params=SamplingParams(
                guided="choice", guided_schema=json.dumps(CHOICES)))),
            ("embed", lambda: eng.embed([[1, 2, 3]])),
            ("score", lambda: eng.score_prompts([[1, 2, 3]]))):
        try:
            call()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    return out


def _worker(spec_path: str) -> None:
    """One rank: join the group, make the tp 2 mesh, then for each scenario
    build the engine and (rank 0) serve it and stop the followers, or
    (followers) follow it; write the results."""
    from tpuserve_torch.parallel.mesh import MeshConfig, make_mesh, multihost_initialize
    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    register_draft()
    multihost_initialize("cpu", init_method=os.environ["TPUSERVE_INIT_METHOD"],
                         timeout_s=120)
    mesh = make_mesh(MeshConfig(tp=2), device_type="cpu", timeout_s=120)
    results = {}
    for name in spec["scenarios"]:
        mesh.multihost = name == "multihost"
        spill = os.path.join(spec["spill"], name)
        if name == "tiers_restart":
            plant_spill_files(spill, mesh.rank)
        eng = Engine(engine_config(name, spill), model_cfg=model_cfg(), mesh=mesh, device="cpu")
        note: dict = {}
        if name == "tiers_fault" and mesh.rank == 1:
            plant_spill_fault(eng, note)
        if mesh.is_coordinator:
            eng._lockstep.record = True
            res = (multihost_refusals(eng) if name == "multihost" else {}
                   if name == "tiers_restart" else serve(eng, name))
            res["recorded"] = [t.tolist() for t in eng._lockstep.tokens]
            res["sent"] = dict(eng._lockstep.sent)
            eng.stop_followers()
        else:
            res = {"recorded": [t.tolist() for t in multihost.follower_loop(eng, record=True)],
                   "tiers_off": eng._kv_tiers is None, **note}
        if name == "tiers_restart":
            res["hashes"] = sorted(eng._kv_tiers.hashes())
            res["files"] = sorted(os.listdir(os.path.join(spill, f"rank{mesh.rank}")))
        elif not mesh.is_coordinator and eng._kv_tiers is not None:
            eng._kv_tiers.flush()
            res["hashes"] = sorted(eng._kv_tiers.hashes())
        if eng._draft_params is not None:
            res["draft_heads"] = eng._draft_cfg.num_heads
        results[name] = res
    mesh.multihost = False
    Path(spec["out"] + f".rank{mesh.rank}.json").write_text(json.dumps(results))
    import torch.distributed as dist
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The references, computed while the ranks run
# ---------------------------------------------------------------------------

def one_device(tmp_path) -> dict:
    """Every scenario on the port's one-device engine; the tiers' twin that
    never evicts (tiers off, no churn); plain decode of the spec prompts."""
    ref = {}
    for name in SCENARIOS[:-1]:
        if name in ("tiers_fault", "tiers_restart"):
            continue
        eng = Engine(engine_config(name, str(tmp_path / "one" / name)), model_cfg=model_cfg(),
                     device="cpu")
        ref[name] = serve(eng, name)
    twin = Engine(dataclasses.replace(engine_config("main"), cache=CacheConfig(**TIER_CACHE)),
                  model_cfg=model_cfg(), device="cpu")
    ref["twin_hit"] = [r.output_token_ids for r in twin.generate(
        TIER_STEPS[-1][1], SamplingParams(**GREEDY))]
    plain = Engine(engine_config("plain"), model_cfg=model_cfg(), device="cpu")
    ref["plain"] = [r.output_token_ids for r in plain.generate(
        REPETITIVE, SamplingParams(**SPEC_PARAMS))]
    return ref


def jax_reference(tmp_path) -> dict:
    """The JAX engine on a tp 2 mesh of the virtual CPU devices (its plain
    attention, single steps): the tier steps' tokens with its tiers on,
    the guided streams, the trunks, and the spec prompts under n-gram
    speculation."""
    from tpuserve import runtime as jax_rt
    from tpuserve.models import config as jax_config
    from tpuserve.parallel import MeshConfig as JaxMeshConfig
    from tpuserve.parallel import make_mesh as jax_make_mesh
    mesh = jax_make_mesh(JaxMeshConfig(tp=2))
    jcfg = dataclasses.replace(jax_config.get_model_config(MODEL), dtype="float32")

    def engine(cache=CACHE, **kw):
        conf = jax_rt.EngineConfig(
            model=MODEL, cache=jax_rt.CacheConfig(**cache),
            scheduler=jax_rt.SchedulerConfig(allow_chunked_prefill=False, **SCHED),
            attn_impl="reference", multi_step=1, slo_classes=False, **kw)
        return jax_rt.Engine(conf, model_cfg=jcfg, mesh=mesh)

    out = {}
    eng = engine(TIER_CACHE, kv_tiers=True, kv_host_bytes=TIER_HOST_BYTES,
                 kv_spill_dir=str(tmp_path / "jax-spill"))
    out["tiers"] = [[r.output_token_ids for r in eng.generate(ps, jax_rt.SamplingParams(**GREEDY))]
                    for _label, ps in TIER_STEPS]
    eng = engine(kv_tiers=False)
    out["guided"] = [[r.output_token_ids for r in eng.generate(GUIDED_PROMPTS, jax_rt.SamplingParams(
        max_tokens=n, temperature=0.0, guided=mode, guided_schema=spec))]
        for mode, spec, n in GUIDED]
    out["embed"] = {p: eng.embed(TEXTS, pooling=p)[0].tolist() for p in ("mean", "last")}
    out["score"] = [[[e["token_id"], e["logprob"]] for e in entries]
                    for entries in eng.score_prompts(TEXTS, top_n=2)]
    eng = engine(kv_tiers=False, enable_prefix_caching=False,
                 speculative=jax_rt.SpecConfig(**SPECS["spec_ngram"]))
    out["spec"] = [r.output_token_ids for r in eng.generate(
        REPETITIVE, jax_rt.SamplingParams(**SPEC_PARAMS))]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the two ranks, compute the references meanwhile, then read
    every rank's results."""
    tmp = tmp_path_factory.mktemp("mesh-features")
    register_draft()
    out = str(tmp / "ranks")
    spec = tmp / "spec.json"
    spec.write_text(json.dumps(dict(scenarios=list(SCENARIOS), out=out,
                                    spill=str(tmp / "spill"))))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    procs = multihost.spawn_ranks([None, __file__, str(spec)], 2, str(tmp / "logs"),
                                  f"file://{tmp}/store", ranks=range(2),
                                  extra_env={"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    try:
        ref = one_device(tmp)
        jax_ref = jax_reference(tmp)
    finally:
        rcs = multihost.stop_ranks(procs, 240)
        torch.set_num_threads(n)
    logs = {r: (tmp / "logs" / f"rank{r}.log").read_text()[-3000:] for r in procs}
    assert all(rc == 0 for rc in rcs.values()), (rcs, logs)
    ranks = [json.loads(Path(f"{out}.rank{r}.json").read_text()) for r in range(2)]
    return ranks, ref, jax_ref


def followers_agree(ranks, name: str) -> None:
    assert ranks[1][name]["recorded"] == ranks[0][name]["recorded"], name


def test_tiers_match_one_device_and_jax(runs):
    """Shared prefix, churn, hit with host and spill tiers: every step's
    tokens and tier counters equal the one-device engine's, the tokens the
    JAX engine's on its mesh and the hit's a twin's that never evicted;
    both ranks' stores hold the same hashes."""
    ranks, ref, jax_ref = runs
    got, want = ranks[0]["tiers"], ref["tiers"]
    assert got["steps"] == want["steps"]
    np.testing.assert_allclose(got["hit_logits"], want["hit_logits"], atol=ATOL, rtol=0)
    assert [s["tokens"] for s in got["steps"]] == jax_ref["tiers"]
    assert got["steps"][-1]["tokens"] == ref["twin_hit"]
    churn, hit = got["steps"][1], got["steps"][2]
    assert churn["demoted"] > 0 and churn["tiers"]["host"] > 0 and churn["tiers"]["spill"] > 0
    assert hit["restores"] == 1 and hit["restored"] == len(SHARED) // 4
    assert ranks[1]["tiers"]["hashes"] == got["hashes"] == want["hashes"]
    sent = ranks[0]["tiers"]["sent"]
    assert sent["demote"] > 0 and sent["restore"] == 1 and sent["scatter"] == 1
    followers_agree(ranks, "tiers")


def test_a_spill_file_lost_on_one_follower_restores_the_agreed_prefix(runs):
    ranks, ref, _ = runs
    at = ranks[1]["tiers_fault"]["fault_at"]
    hit = ranks[0]["tiers_fault"]["steps"][-1]
    assert 0 < at < len(SHARED) // 4
    assert hit["restores"] == 1 and hit["restored"] == at
    assert hit["tokens"] == ref["twin_hit"]
    assert ranks[1]["tiers_fault"]["hashes"] == ranks[0]["tiers_fault"]["hashes"]
    followers_agree(ranks, "tiers_fault")


def test_spill_files_of_an_earlier_run_leave_the_ranks_the_same_hashes(runs):
    """At start each rank adopts its spill directory's files; the ranks
    keep those they all hold, and a file one rank alone holds is dropped."""
    ranks, _, _ = runs
    for rank in ranks:
        assert rank["tiers_restart"]["hashes"] == [0x1234]
        assert rank["tiers_restart"]["files"] == [f"kvt_{0x1234:016x}.npz"]


def check_guided(mode: str, spec: str, text: str, reason: str) -> None:
    """A guided output that stopped is a document of its spec (the check of
    tests/test_torch_guided.py)."""
    if reason != "stop":
        return
    if mode == "json_schema":
        doc, schema = json.loads(text), json.loads(spec)
        assert set(doc) == set(schema["required"]) and doc["mood"] in ("up", "down")
        assert isinstance(doc["name"], str) and isinstance(doc["ok"], bool)
    else:
        assert text in json.loads(spec)


def test_guided_windows_match_and_send_each_grammar_once(runs):
    ranks, ref, jax_ref = runs
    got = ranks[0]["guided"]
    assert got["guided"] == ref["guided"]["guided"]
    assert got["windows"] > 0
    for (mode, spec, _n), rows, jax_rows in zip(GUIDED, got["guided"], jax_ref["guided"]):
        assert [r[0] for r in rows] == jax_rows
        for _toks, text, reason in rows:
            check_guided(mode, spec, text, reason)
    # the choices complete (the schema's documents run to max_tokens)
    assert all(reason == "stop" for _t, _x, reason in got["guided"][-1])
    # two grammars, each of whose tables crossed the group once
    assert got["sent"]["grammar"] == len(GUIDED)
    followers_agree(ranks, "guided")


def test_embeddings_and_scores_match_one_device_and_jax(runs):
    ranks, ref, jax_ref = runs
    got = ranks[0]["trunks"]
    for pooling in ("mean", "last"):
        np.testing.assert_allclose(got["embed"][pooling], ref["trunks"]["embed"][pooling],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(got["embed"][pooling], jax_ref["embed"][pooling],
                                   atol=ATOL, rtol=0)
    for ours, one, theirs in zip(got["score"], ref["trunks"]["score"], jax_ref["score"]):
        assert [e[0] for e in ours] == [e[0] for e in one] == [e[0] for e in theirs]
        assert [e[2] for e in ours] == [e[2] for e in one]
        assert [[t for t, _ in e[3]] for e in ours] == [[t for t, _ in e[3]] for e in one]
        for a, b in ((ours, one), (ours, theirs)):
            np.testing.assert_allclose([e[1] for e in a[1:]], [e[1] for e in b[1:]],
                                       atol=ATOL, rtol=0)
    assert got["sent"]["trunk"] == 3          # a batch each: mean, last, score


@pytest.mark.parametrize("name", list(SPECS))
def test_speculation_matches_plain_decode_and_one_device(runs, name):
    ranks, ref, jax_ref = runs
    got = ranks[0][name]
    assert got["tokens"] == ref["plain"] == ref[name]["tokens"] == jax_ref["spec"]
    assert got["spec"] == ref[name]["spec"] and got["spec"][1] > 0
    if name == "spec_draft":
        # each rank holds its half of the draft's heads
        assert ranks[0][name]["draft_heads"] == ranks[1][name]["draft_heads"] == 2
    followers_agree(ranks, name)


def test_multihost_keeps_the_jax_multi_process_refusals(runs):
    ranks, _, _ = runs
    got = ranks[0]["multihost"]
    assert got["tiers_off"] and ranks[1]["multihost"]["tiers_off"]
    assert "multi-host serving mode" in got["guided"]
    assert got["embed"].startswith("embeddings not supported by this multi-host deployment")
    assert got["score"] == "prompt scoring not supported by this multi-host deployment"


if __name__ == "__main__":
    _worker(sys.argv[1])
