"""KV adoption and extraction on a tp / ep mesh, on the CPU: the in-process
prefill/decode pair and both cross-pod roles on 2 gloo ranks in lockstep
(``tpuserve_torch/parallel/multihost.py``'s adopt, extract and handoff
ops; ``sharding.cut_pages`` / ``join_pages``).

One spawn (``multihost.spawn_ranks``, a ``file://`` store under the test's
directory, logs to files, a hard timeout that kills every rank) runs every
scenario on tiny-qwen3 in float32 at tp 2 (the pair also on tiny-moe at ep
2, whose cache every rank holds whole):

- **pair**: ``DisaggregatedEngine`` on the mesh; greedy streams equal the
  port's one-device pair, its colocated engine and the JAX pair on a tp 2
  mesh of the virtual CPU devices;
- **decode**: rank 0 adopts migrations through the wire codec, made by the
  port's one-device prefill and by the JAX engine on its tp 2 mesh (the JAX
  ``extract_seq_kv`` through the JAX codec); tokens equal colocated, and
  each rank's adopted pages are its heads of the wire's, bit for bit;
- **guided**: a guided request whose first token opened a canonical-suffix
  plan migrates with ``guided_plan``; its output is legal and one
  device's;
- **prefill**: rank 0's joined pages are within 1e-4 of the one-device
  extraction and of the JAX tp 2 engine's, and a one-device engine that
  adopts them decodes the colocated tokens;
- **faults**: an int8 migration into the float32 pool raises
  ``ValueError`` and a full pool ``MemoryError`` on rank 0 only, with no
  descriptor sent (``Lockstep.sent`` unchanged); the next migration is
  served on both ranks.

In every scenario the follower's recorded window tokens equal rank 0's.
The migrations the ranks adopt are written before they start (the port's)
or while they run (the JAX engine's, which the decode scenario waits for).
The file is also the ranks' program (``python tests/test_torch_mesh_disagg.py
SPEC.json``), which imports no JAX.
"""

import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpuserve_torch.models.config import get_model_config  # noqa: E402
from tpuserve_torch.parallel import disagg_net, multihost  # noqa: E402
from tpuserve_torch.parallel.disagg import DisaggregatedEngine  # noqa: E402
from tpuserve_torch.parallel.sharding import cut_pages  # noqa: E402
from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig,  # noqa: E402
                                    SamplingParams, SchedulerConfig)

ATOL = 1e-4
CACHE = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16, dtype="float32")
# the faults' pool: three 20-token adoptions leave 5 free blocks, and a
# fourth needs 6
FAULT_CACHE = dict(CACHE, num_blocks=20)
SCHED = dict(max_num_seqs=4, max_prefill_tokens=128, min_prefill_bucket=8,
             min_decode_bucket=2)
GREEDY = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
FAULT_GREEDY = dict(GREEDY, max_tokens=4)
PROMPTS = [[5, 6, 7], list(range(10, 30)), [40, 41, 42, 43, 44, 45, 46, 47, 48]]
FAULT_PROMPTS = [[100 + 7 * i + j for j in range(20)] for i in range(4)]
CHOICES = ["ünïcödé", "Ωmega"]       # the first token opens a canonical-suffix plan
GUIDED = dict(max_tokens=40, temperature=0.0, guided="choice",
              guided_schema=json.dumps(CHOICES))
SCENARIOS = ("pair", "pair_moe", "prefill", "faults", "guided", "decode")
JAX_WAIT_S = 240


def model_cfg(name: str = "tiny-qwen3"):
    return dataclasses.replace(get_model_config(name), dtype="float32")


def engine_config(model: str = "tiny-qwen3", cache=CACHE) -> EngineConfig:
    return EngineConfig(model=model, cache=CacheConfig(**cache),
                        scheduler=SchedulerConfig(**SCHED), multi_step=4, kv_tiers=False)


def drain(eng, rids) -> list:
    while eng.has_work():
        eng.step()
    return [eng.requests.pop(rid).output_token_ids for rid in rids]


def prefilled(eng, prompts, params, prefix: str) -> list:
    """Prefill ``prompts`` on ``eng`` (one step) and take each sequence's
    migration as a prefill pod makes it: (meta, one card's host pages)."""
    rids = [eng.add_request(prompt_token_ids=p, params=params, request_id=f"{prefix}{i}")
            for i, p in enumerate(prompts)]
    eng.step()
    out = []
    for rid in rids:
        req = eng.requests[rid]
        assert len(req.output_token_ids) == 1, rid
        blocks = eng.block_manager.block_table(rid)
        meta = {"request_id": rid, "prompt_token_ids": list(req.prompt_token_ids),
                "first_token": req.output_token_ids[-1], "num_valid_blocks": len(blocks),
                "params": disagg_net.sampling_to_dict(params)}
        plan = eng._guided_plan.get(rid)
        if plan:
            meta["guided_plan"] = list(plan)
        out.append((meta, eng._exec_extract(blocks)))
    for rid in rids:
        eng.abort_request(rid)
    return out


def write_blobs(path: Path, migrations) -> None:
    path.mkdir(parents=True, exist_ok=True)
    for i, (meta, seq_kv) in enumerate(migrations):
        (path / f"{i}.kv").write_bytes(disagg_net.serialize_migration(meta, seq_kv))
    (path / "ready").write_text(str(len(migrations)))


def read_blobs(path: Path, wait_s: float = 0.0) -> list:
    deadline = time.monotonic() + wait_s
    while not (path / "ready").exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no migrations under {path}")
        time.sleep(0.2)
    n = int((path / "ready").read_text())
    return [disagg_net.deserialize_migration((path / f"{i}.kv").read_bytes())
            for i in range(n)]


def pages_np(seq_kv) -> dict:
    return {f"{i}.{k}": torch.as_tensor(v).numpy() for i, layer in enumerate(seq_kv)
            for k, v in layer.items()}


def watch_adoptions(eng) -> list:
    """Each adoption's pages as this rank's cache holds them right after
    its write (``_exec_adopt``: rank 0's and a follower's)."""
    from tpuserve_torch.parallel.disagg import extract_seq_kv
    seen, orig = [], eng._exec_adopt

    def adopt(blocks, seq_kv):
        orig(blocks, seq_kv)
        seen.append(pages_np(extract_seq_kv(eng.kv_cache, blocks)))
    eng._exec_adopt = adopt
    return seen


def adopt_all(eng, migrations, rename: str = "") -> list:
    rids = []
    for meta, seq_kv in migrations:
        meta = dict(meta, request_id=rename + meta["request_id"])
        rids.append(disagg_net.adopt_meta(eng, meta, seq_kv))
    return rids


def lead(name: str, eng, spec: dict) -> dict:
    """Rank 0's work of scenario ``name``."""
    work = Path(spec["work"])
    out: dict = {}
    if name in ("pair", "pair_moe"):
        reqs = eng.generate(PROMPTS, SamplingParams(**GREEDY))
        out["tokens"] = [r.output_token_ids for r in reqs]
        out["kv_transfers"] = eng.stats.kv_transfers
    elif name == "prefill":
        migrations = prefilled(eng, PROMPTS, SamplingParams(**GREEDY), "pre")
        np.savez(f"{spec['out']}.prefill.npz", **{
            f"{i}.{k}": v for i, (_m, kv) in enumerate(migrations)
            for k, v in pages_np(kv).items()})
        out["metas"] = [m for m, _kv in migrations]
    elif name == "faults":
        sent = eng._lockstep.sent
        good = read_blobs(work / "faults")
        bad_meta = dict(good[0][0], request_id="int8")
        bad = [{"k": torch.zeros((8, 4, 2, 16), dtype=torch.int8), "v": torch.zeros(
            (8, 4, 2, 16), dtype=torch.int8), "ks": torch.ones((8, 4, 2)),
            "vs": torch.ones((8, 4, 2))} for _ in range(2)]
        before = dict(sent)
        try:
            disagg_net.adopt_meta(eng, bad_meta, bad)
        except ValueError as e:
            out["int8_error"] = str(e)
        out["int8_sent_unchanged"] = dict(sent) == before
        rids = adopt_all(eng, good[:3])
        before = dict(sent)
        try:
            adopt_all(eng, good[3:])
        except MemoryError as e:
            out["full_error"] = str(e)
        out["full_sent_unchanged"] = dict(sent) == before
        out["tokens"] = drain(eng, rids) + drain(eng, adopt_all(eng, good[3:], "next-"))
        out["adopted"] = sent["adopt"]
    else:
        migrations = read_blobs(work / name)
        tokens = drain(eng, adopt_all(eng, migrations))
        if name == "decode":
            tokens += drain(eng, adopt_all(eng, read_blobs(work / "jax", JAX_WAIT_S)))
        out["tokens"] = tokens
    out["sent"] = dict(eng._lockstep.sent)
    return out


def _worker(spec_path: str) -> None:
    """One rank: join the group, make the tp 2 mesh (and an ep 2 mesh for
    the MoE pair), then for each scenario build its topology and (rank 0)
    serve it and stop the followers, or (the follower) follow it."""
    from tpuserve_torch.parallel.mesh import MeshConfig, make_mesh, multihost_initialize
    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    multihost_initialize("cpu", init_method=os.environ["TPUSERVE_INIT_METHOD"],
                         timeout_s=120)
    tp_mesh = make_mesh(MeshConfig(tp=2), device_type="cpu", timeout_s=120)
    ep_mesh = make_mesh(MeshConfig(ep=2), device_type="cpu", timeout_s=120)
    results = {}
    for name in spec["scenarios"]:
        mesh = ep_mesh if name == "pair_moe" else tp_mesh
        model = "tiny-moe" if name == "pair_moe" else "tiny-qwen3"
        cfg = engine_config(model, FAULT_CACHE if name == "faults" else CACHE)
        if name.startswith("pair"):
            eng = DisaggregatedEngine(cfg, cfg, mesh=mesh, model_cfg=model_cfg(model),
                                      device="cpu")
            adopted = []
        else:
            eng = Engine(cfg, model_cfg=model_cfg(model), mesh=mesh, device="cpu")
            adopted = watch_adoptions(eng)
        if mesh.is_coordinator:
            eng._lockstep.record = True
            res = lead(name, eng, spec)
            res["recorded"] = [t.tolist() for t in eng._lockstep.tokens]
            eng.stop_followers()
        else:
            res = {"recorded": [t.tolist() for t in multihost.follower_loop(eng, record=True)]}
        if adopted:
            np.savez(f"{spec['out']}.{name}.rank{mesh.rank}.npz",
                     **{f"{i}/{k}": v for i, a in enumerate(adopted) for k, v in a.items()})
            res["adoptions"] = len(adopted)
        results[name] = res
    Path(spec["out"] + f".rank{tp_mesh.rank}.json").write_text(json.dumps(results))
    import torch.distributed as dist
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The references, computed while the ranks run
# ---------------------------------------------------------------------------

def colocated(prompts, params, model: str = "tiny-qwen3") -> list:
    eng = Engine(engine_config(model), model_cfg=model_cfg(model), device="cpu")
    return [r.output_token_ids for r in eng.generate(prompts, params)]


def port_migrations(work: Path) -> dict:
    """The one-device prefill's migrations the ranks adopt (written before
    they start) and its extraction of the prefill scenario's prompts."""
    eng = Engine(engine_config(), model_cfg=model_cfg(), device="cpu")
    decode = prefilled(eng, PROMPTS, SamplingParams(**GREEDY), "port")
    write_blobs(work / "decode", decode)
    write_blobs(work / "faults", prefilled(eng, FAULT_PROMPTS, SamplingParams(**FAULT_GREEDY),
                                           "fault"))
    guided = prefilled(eng, [eng.tokenizer.encode("x")], SamplingParams(**GUIDED), "guided")
    assert guided[0][0].get("guided_plan"), "the first token opened no plan"
    write_blobs(work / "guided", guided)
    return {"decode": decode}


def jax_reference(work: Path) -> dict:
    """The JAX pair on a tp 2 mesh (and on an ep 2 mesh for tiny-moe) of
    the virtual CPU devices, its plain attention: the greedy streams; then
    its prefill engine's migrations of the same prompts (the JAX
    ``extract_seq_kv``), written through the JAX codec for the ranks."""
    import tpuserve.runtime.engine as jax_engine_mod
    from tpuserve import runtime as jax_rt
    from tpuserve.models.config import get_model_config as jax_model_config
    from tpuserve.parallel import MeshConfig as JaxMeshConfig
    from tpuserve.parallel import disagg as jax_disagg
    from tpuserve.parallel import disagg_net as jax_net
    from tpuserve.parallel import make_mesh as jax_make_mesh

    def conf(model):
        return jax_rt.EngineConfig(
            model=model, cache=jax_rt.CacheConfig(**CACHE),
            scheduler=jax_rt.SchedulerConfig(allow_chunked_prefill=False, **SCHED),
            attn_impl="reference", multi_step=1, kv_tiers=False, slo_classes=False)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine_mod, "get_model_config",
                   lambda name: dataclasses.replace(jax_model_config(name), dtype="float32"))
        pair = jax_disagg.DisaggregatedEngine(conf("tiny-qwen3"), conf("tiny-qwen3"),
                                              mesh=jax_make_mesh(JaxMeshConfig(tp=2)))
        out["pair"] = [r.output_token_ids for r in pair.generate(
            PROMPTS, jax_rt.SamplingParams(**GREEDY))]
        pre = pair.prefill
        rids = [pre.add_request(prompt_token_ids=p, params=jax_rt.SamplingParams(**GREEDY),
                                request_id=f"jax{i}") for i, p in enumerate(PROMPTS)]
        pre.step()
        migrations = []
        for rid in rids:
            req = pre.requests[rid]
            blocks = pre.block_manager.block_table(rid)
            seq_kv, pre.kv_cache = jax_disagg.extract_seq_kv(pre.kv_cache, blocks)
            seq_kv = [{k: np.asarray(v) for k, v in layer.items()} for layer in seq_kv]
            meta = {"request_id": rid, "prompt_token_ids": list(req.prompt_token_ids),
                    "first_token": req.output_token_ids[-1], "num_valid_blocks": len(blocks),
                    "params": jax_net.sampling_to_dict(jax_rt.SamplingParams(**GREEDY))}
            migrations.append(seq_kv)
            (work / "jax").mkdir(exist_ok=True)
            (work / "jax" / f"{len(migrations) - 1}.kv").write_bytes(
                jax_net.serialize_migration(meta, seq_kv))
        (work / "jax" / "ready").write_text(str(len(migrations)))
        out["pages"] = migrations
        moe = jax_disagg.DisaggregatedEngine(conf("tiny-moe"), conf("tiny-moe"),
                                             mesh=jax_make_mesh(JaxMeshConfig(ep=2)))
        out["pair_moe"] = [r.output_token_ids for r in moe.generate(
            PROMPTS, jax_rt.SamplingParams(**GREEDY))]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the port's migrations, start the two ranks, compute the
    references meanwhile, then read every rank's results."""
    tmp = tmp_path_factory.mktemp("mesh-disagg")
    work = tmp / "work"
    out = str(tmp / "ranks")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ref = port_migrations(work)
        spec = tmp / "spec.json"
        spec.write_text(json.dumps(dict(scenarios=list(SCENARIOS), out=out, work=str(work))))
        procs = multihost.spawn_ranks([None, __file__, str(spec)], 2, str(tmp / "logs"),
                                      f"file://{tmp}/store", ranks=range(2),
                                      extra_env={"PYTHONPATH": str(ROOT),
                                                 "OMP_NUM_THREADS": "1"})
        try:
            jax_ref = jax_reference(work)
            ref["colocated"] = colocated(PROMPTS, SamplingParams(**GREEDY))
            ref["colocated_moe"] = colocated(PROMPTS, SamplingParams(**GREEDY), "tiny-moe")
            ref["faults"] = colocated(FAULT_PROMPTS, SamplingParams(**FAULT_GREEDY))
            eng = Engine(engine_config(), model_cfg=model_cfg(), device="cpu")
            (req,) = eng.generate(["x"], SamplingParams(**GUIDED))
            ref["guided"] = [req.output_token_ids, req.output_text]
            for name, model in (("pair", "tiny-qwen3"), ("pair_moe", "tiny-moe")):
                pair = DisaggregatedEngine(engine_config(model), engine_config(model),
                                           model_cfg=model_cfg(model), device="cpu")
                ref[name] = [r.output_token_ids for r in pair.generate(
                    PROMPTS, SamplingParams(**GREEDY))]
        finally:
            rcs = multihost.stop_ranks(procs, 240)
    finally:
        torch.set_num_threads(n)
    logs = {r: (tmp / "logs" / f"rank{r}.log").read_text()[-3000:] for r in procs}
    assert all(rc == 0 for rc in rcs.values()), (rcs, logs)
    ranks = [json.loads(Path(f"{out}.rank{r}.json").read_text()) for r in range(2)]
    return ranks, ref, jax_ref, out, work


def followers_agree(ranks, name: str, windows: bool = True) -> None:
    assert bool(ranks[0][name]["recorded"]) == windows, name
    assert ranks[1][name]["recorded"] == ranks[0][name]["recorded"], name


@pytest.mark.parametrize("name", ["pair", "pair_moe"])
def test_pair_on_the_mesh_matches_one_device_colocated_and_jax(runs, name):
    """Greedy streams of the pair on tp 2 (ep 2 for tiny-moe, whose cache
    every rank holds whole) equal the one-device pair's, the colocated
    engine's and the JAX pair's on its mesh; one handoff a request."""
    ranks, ref, jax_ref, _, _ = runs
    got = ranks[0][name]
    want = ref["colocated_moe" if name == "pair_moe" else "colocated"]
    assert got["tokens"] == ref[name] == want == jax_ref[name]
    assert got["kv_transfers"] == len(PROMPTS) == got["sent"]["handoff"]
    assert "adopt" not in got["sent"] and "extract" not in got["sent"]
    followers_agree(ranks, name)


def test_decode_role_adopts_port_and_jax_migrations(runs):
    """Rank 0 adopts the one-device port prefill's migrations, then the JAX
    tp 2 engine's through its codec: tokens equal colocated, and each
    rank's adopted pages are its heads of the wire's, bit for bit."""
    ranks, ref, jax_ref, out, work = runs
    got = ranks[0]["decode"]
    assert got["tokens"] == ref["colocated"] * 2
    assert got["sent"]["adopt"] == 2 * len(PROMPTS)
    wire = ([kv for _m, kv in read_blobs(work / "decode")]
            + [kv for _m, kv in read_blobs(work / "jax")])
    for rank in range(2):
        assert ranks[rank]["decode"]["adoptions"] == len(wire)
        seen = np.load(f"{out}.decode.rank{rank}.npz")
        for i, kv in enumerate(wire):
            for key, page in pages_np(cut_pages(kv, 2, rank)).items():
                np.testing.assert_array_equal(seen[f"{i}/{key}"], page, err_msg=(rank, i, key))
    # the JAX engine's pages are one card's: the port's one-device pages
    # within 1e-4 (its tp sums run in another order)
    for (_meta, ours), theirs in zip(ref["decode"], jax_ref["pages"]):
        for a, b in zip(ours, theirs):
            for key in a:
                np.testing.assert_allclose(a[key].numpy(), b[key], atol=ATOL, rtol=0)
    followers_agree(ranks, "decode")


def test_guided_plan_migrates_onto_the_mesh(runs):
    """The plan the first token opened crosses with the pages: the stream
    equals one device's, whose output is one of the choices."""
    ranks, ref, _, _, _ = runs
    (tokens,) = ranks[0]["guided"]["tokens"]
    assert tokens == ref["guided"][0]
    assert ref["guided"][1] in CHOICES
    # a plan's row runs single steps, which rank 0 samples alone: no
    # window to record on either rank
    followers_agree(ranks, "guided", windows=False)


def test_prefill_role_joins_the_ranks_pages(runs):
    """Rank 0's joined pages of its own prefills are within 1e-4 of the
    one-device extraction and of the JAX tp 2 engine's; a one-device engine
    that adopts them decodes the colocated tokens."""
    ranks, ref, jax_ref, out, _ = runs
    got = ranks[0]["prefill"]
    assert got["sent"]["extract"] == len(PROMPTS)
    joined = np.load(f"{out}.prefill.npz")
    eng = Engine(engine_config(), model_cfg=model_cfg(), device="cpu")
    for i, ((meta, one), theirs) in enumerate(zip(ref["decode"], jax_ref["pages"])):
        assert got["metas"][i]["first_token"] == meta["first_token"]
        for layer, (a, b) in enumerate(zip(one, theirs)):
            for key in a:
                mine = joined[f"{i}.{layer}.{key}"]
                np.testing.assert_allclose(mine, a[key].numpy(), atol=ATOL, rtol=0)
                np.testing.assert_allclose(mine, b[key], atol=ATOL, rtol=0)
        seq_kv = [{key: torch.from_numpy(joined[f"{i}.{layer}.{key}"]) for key in a}
                  for layer, a in enumerate(one)]
        disagg_net.adopt_meta(eng, got["metas"][i], seq_kv)
    assert drain(eng, [m["request_id"] for m in got["metas"]]) == ref["colocated"]


def test_planted_faults_raise_on_rank_0_only_and_the_next_migration_is_served(runs):
    ranks, ref, _, _, _ = runs
    got = ranks[0]["faults"]
    assert "format mismatch" in got["int8_error"] and got["int8_sent_unchanged"]
    assert "at capacity" in got["full_error"] and got["full_sent_unchanged"]
    # three adopted before the full pool refused the fourth, which the
    # next migration serves: every one on both ranks
    assert got["adopted"] == 4 and ranks[1]["faults"]["adoptions"] == 4
    assert got["tokens"] == ref["faults"]
    followers_agree(ranks, "faults")


if __name__ == "__main__":
    _worker(sys.argv[1])
