"""Lockstep ranks on the CPU: the port's tensor and expert parallel serving
(``tpuserve_torch/parallel/multihost.py``) in 2 and 4 gloo processes.

Each case spawns its ranks through ``multihost.spawn_ranks`` (the launcher
``--tp`` uses) with a ``file://`` store under ``tmp_path``, logs to files,
and a hard timeout that kills every rank.  Rank 0 drives an engine on its
mesh through a list of scenarios (greedy streams, one prefill's and one
decode step's logits, a chunked prompt, mixed steps, penalties and logprobs
in the window); the followers mirror every step and record each decode
window's tokens, which must equal rank 0's.  In this process the same
scenarios run on the port's one-device engine and on the JAX engine on a
mesh of the 8 virtual CPU devices: tokens equal, float32 logits within
atol 1e-4.  Then ``python -m tpuserve_torch.server --tp 2 --device cpu``
serves a completion (and, with ``--speculative-k`` and the tiers on, a
``response_format`` completion and embeddings) and every rank exits
cleanly, and a follower's death stops rank 0 with an error.  The file is also the ranks' program
(``python tests/test_torch_multihost.py SPEC.json``), which imports no JAX.
"""

import ast
import dataclasses
import inspect
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
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
from tpuserve_torch.runtime import engine as engine_mod  # noqa: E402

CACHE = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16, dtype="float32")
SCHED = dict(max_num_seqs=4, max_prefill_tokens=128, min_prefill_bucket=8,
             min_decode_bucket=2)
PROMPTS = [[5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9], [11, 12, 13, 14, 15]]
LONG = [list(range(2, 42))]                  # 40 tokens: chunks of 16
GREEDY = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
# sampled in the window with penalties, a bias and logprobs, seeded
EXTRAS = dict(max_tokens=8, temperature=0.8, top_p=0.9, seed=7, ignore_eos=True,
              presence_penalty=0.5, frequency_penalty=0.3, repetition_penalty=1.1,
              logit_bias={"3": 2.0}, logprobs=2)
SCENARIOS = {
    "main": dict(engine={}, prompts=PROMPTS, params=GREEDY),
    # one prefill, one decode step: both executables keep their logits
    "logits": dict(engine={}, prompts=PROMPTS, params=dict(GREEDY, max_tokens=2)),
    "chunked": dict(engine=dict(sched=dict(prefill_chunk_size=16)), prompts=LONG + PROMPTS,
                    params=GREEDY),
    "mixed": dict(engine=dict(sched=dict(mixed_batching=True, mixed_token_budget=32)),
                  prompts=PROMPTS + LONG, params=GREEDY),
    "extras": dict(engine={}, prompts=PROMPTS, params=EXTRAS),
    "int8": dict(engine=dict(quantization="int8"), prompts=PROMPTS, params=GREEDY),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def model_cfg(name: str):
    return dataclasses.replace(get_model_config(name), dtype="float32")


def engine_config(model: str, spec: dict) -> EngineConfig:
    sched = dict(SCHED, **spec.get("sched", {}))
    return EngineConfig(model=model, cache=CacheConfig(**CACHE),
                        scheduler=SchedulerConfig(**sched),
                        quantization=spec.get("quantization"), multi_step=4)


def sampling(params: dict) -> SamplingParams:
    p = dict(params)
    if p.get("logit_bias"):
        p["logit_bias"] = {int(k): v for k, v in p["logit_bias"].items()}
    return SamplingParams(**p)


def run_scenario(eng, sc: dict) -> dict:
    """Serve ``sc``'s prompts; the streams, logprobs and, for "logits", the
    last prefill's and decode step's logits."""
    reqs = eng.generate(sc["prompts"], sampling(sc["params"]))
    out = {"tokens": [r.output_token_ids for r in reqs],
           "logprobs": [[e["logprob"] for e in (r.logprobs or [])] for r in reqs]}
    exes = eng.graphs.executables
    pre = [k for k in exes if k[0] == "prefill"]
    dec = [k for k in exes if k[0] == "decode" and len(k) == 3]
    if pre and dec:
        out["prefill_logits"] = exes[pre[-1]].logits[:len(sc["prompts"])].tolist()
        out["decode_logits"] = exes[dec[-1]].logits[:len(sc["prompts"])].tolist()
    return out


def _worker(spec_path: str) -> None:
    """One rank: join the group, make the mesh, then for each scenario
    build the engine and (rank 0) serve it and stop the followers, or
    (followers) follow it; write the results."""
    from tpuserve_torch.parallel.mesh import MeshConfig, make_mesh, multihost_initialize
    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    multihost_initialize("cpu", init_method=os.environ["TPUSERVE_INIT_METHOD"],
                         timeout_s=120)
    mesh = make_mesh(MeshConfig(tp=spec["tp"], ep=spec["ep"]), device_type="cpu",
                     timeout_s=120)
    results = {}
    for name in spec["scenarios"]:
        sc = SCENARIOS[name]
        eng = Engine(engine_config(spec["model"], sc["engine"]),
                     model_cfg=model_cfg(spec["model"]), mesh=mesh, device="cpu")
        if mesh.is_coordinator:
            eng._lockstep.record = True
            res = run_scenario(eng, sc)
            res["recorded"] = [t.tolist() for t in eng._lockstep.tokens]
            res["sent"] = dict(eng._lockstep.sent)
            res["heartbeat_s"] = eng._lockstep.heartbeat_s
            eng.stop_followers()
        else:
            res = {"recorded": [t.tolist() for t in multihost.follower_loop(eng, record=True)]}
        res["collectives"] = dict(mesh.comm.calls)
        results[name] = res
    Path(spec["out"] + f".rank{mesh.rank}.json").write_text(json.dumps(results))
    import torch.distributed as dist
    dist.destroy_process_group()


def spawn(tmp_path, model: str, tp: int, ep: int, scenarios, timeout_s: float = 240) -> list:
    """Run the scenarios on tp x ep gloo ranks; each rank's results."""
    world = tp * ep
    out = str(tmp_path / f"{model}-tp{tp}-ep{ep}")
    spec = tmp_path / f"{model}-tp{tp}-ep{ep}.json"
    spec.write_text(json.dumps(dict(model=model, tp=tp, ep=ep, scenarios=list(scenarios),
                                    out=out)))
    procs = multihost.spawn_ranks([None, __file__, str(spec)], world, str(tmp_path / "logs"),
                                  f"file://{tmp_path}/store-{model}-{tp}-{ep}",
                                  ranks=range(world),
                                  extra_env={"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    rcs = multihost.stop_ranks(procs, timeout_s)
    logs = {r: (tmp_path / "logs" / f"rank{r}.log").read_text()[-3000:] for r in procs}
    assert all(rc == 0 for rc in rcs.values()), (rcs, logs)
    return [json.loads(Path(f"{out}.rank{r}.json").read_text()) for r in range(world)]


def one_device(model: str, names) -> dict:
    """The scenarios on the port's one-device engine (the same seed)."""
    res = {}
    for name in names:
        sc = SCENARIOS[name]
        eng = Engine(engine_config(model, sc["engine"]), model_cfg=model_cfg(model),
                     device="cpu")
        res[name] = run_scenario(eng, sc)
    return res


def jax_tokens(model: str, tp: int, ep: int, name: str) -> list:
    """The greedy scenario on the JAX engine on a tp x ep mesh of virtual
    CPU devices, its plain attention (chunked prefill off, as the port's
    prompts here never chunk by length)."""
    from tpuserve import runtime as jax_rt
    from tpuserve.models.config import get_model_config as jax_model_config
    from tpuserve.parallel import MeshConfig as JaxMeshConfig
    from tpuserve.parallel import make_mesh as jax_make_mesh
    sc = SCENARIOS[name]
    conf = jax_rt.EngineConfig(
        model=model, cache=jax_rt.CacheConfig(**CACHE),
        scheduler=jax_rt.SchedulerConfig(allow_chunked_prefill=False, **SCHED),
        attn_impl="reference", multi_step=1, kv_tiers=False, slo_classes=False,
        quantization=sc["engine"].get("quantization"))
    eng = jax_rt.Engine(conf, model_cfg=dataclasses.replace(jax_model_config(model),
                                                            dtype="float32"),
                        mesh=jax_make_mesh(JaxMeshConfig(tp=tp, ep=ep)))
    outs = eng.generate(sc["prompts"], jax_rt.SamplingParams(**sc["params"]))
    return [o.output_token_ids for o in outs]


def check_ranks(ranks: list, ref: dict) -> None:
    """Rank 0's streams equal the one-device engine's; every follower
    recorded rank 0's window tokens; the logits agree within 1e-4."""
    lead = ranks[0]
    for name, r in ref.items():
        assert lead[name]["tokens"] == r["tokens"], name
        for a, b in zip(lead[name]["logprobs"], r["logprobs"]):
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=name)
        assert lead[name]["recorded"], name
        for f in ranks[1:]:
            assert f[name]["recorded"] == lead[name]["recorded"], name
        for key in ("prefill_logits", "decode_logits"):
            if key in r:
                np.testing.assert_allclose(lead[name][key], r[key], atol=1e-4, rtol=0,
                                           err_msg=f"{name} {key}")


def test_tp2_dense_paths_match_one_device_and_jax(tmp_path):
    """tiny-qwen3 at tp 2: the main path, one prefill's and one decode
    step's logits, a chunked prompt, mixed steps, and penalties, a bias and
    logprobs sampled in the window; followers hold rank 0's tokens; the
    greedy stream equals the JAX engine's on a tp 2 mesh."""
    names = ("main", "logits", "chunked", "mixed", "extras")
    ranks = spawn(tmp_path, "tiny-qwen3", 2, 1, names)
    ref = one_device("tiny-qwen3", names)
    check_ranks(ranks, ref)
    assert ranks[0]["chunked"]["sent"]["run"] > len(LONG[0]) // 16
    # the idle heartbeat: a quarter of the mesh's 120 s collective timeout
    assert ranks[0]["chunked"]["heartbeat_s"] == 30.0
    assert ranks[0]["main"]["collectives"]["tp"] > 0
    assert ranks[0]["main"]["tokens"] == jax_tokens("tiny-qwen3", 2, 1, "main")


def test_tp4_llama_and_mla_match(tmp_path):
    """tp 4: tiny-llama (4 kv heads) and MLA (tiny-deepseek: the per-head
    up-projections sharded, the latent replicated, its MoE and dense
    layers), each against the one-device engine and the JAX engine on a tp
    4 mesh."""
    for model in ("tiny-llama", "tiny-deepseek"):
        ranks = spawn(tmp_path, model, 4, 1, ("main", "logits"))
        check_ranks(ranks, one_device(model, ("main", "logits")))
        assert ranks[0]["main"]["tokens"] == jax_tokens(model, 4, 1, "main")


def test_ep_and_int8_ep_match(tmp_path):
    """Experts over ep: tiny-moe at ep 2 x tp 2 in float32 and with int8
    weights (the (E, out) scales split with their experts), and MLA's MoE
    at ep 4; against the one-device engine and the JAX engine's mesh."""
    ranks = spawn(tmp_path, "tiny-moe", 2, 2, ("main", "logits", "int8"))
    check_ranks(ranks, one_device("tiny-moe", ("main", "logits", "int8")))
    assert ranks[0]["main"]["collectives"]["ep"] > 0
    assert ranks[0]["main"]["tokens"] == jax_tokens("tiny-moe", 2, 2, "main")
    assert ranks[0]["int8"]["tokens"] == jax_tokens("tiny-moe", 2, 2, "int8")
    ranks = spawn(tmp_path, "tiny-deepseek", 1, 4, ("main",))
    check_ranks(ranks, one_device("tiny-deepseek", ("main",)))


# ---------------------------------------------------------------------------
# The AST guard: every device step goes through the lockstep hooks
# ---------------------------------------------------------------------------

def _engine_class():
    tree = ast.parse(inspect.getsource(engine_mod))
    return next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "Engine")


RUNS = {"run", "load", "load_extras", "pad_run", "step"}
GRAPH_CALLS = {"get", "warmup", "load_grammar"}


def _offending_calls(fn) -> list:
    found = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
            continue
        f = node.func
        if isinstance(f.value, ast.Name) and f.value.id == "transformer":
            found.append(f"transformer.{f.attr}")
        elif isinstance(f.value, ast.Name) and f.value.id == "exe" and f.attr in RUNS:
            found.append(f"exe.{f.attr}")
        elif (isinstance(f.value, ast.Attribute) and f.value.attr == "graphs"
              and f.attr in GRAPH_CALLS):
            found.append(f"graphs.{f.attr}")
    return found


def test_device_steps_only_in_exec_hooks():
    """The counterpart of the JAX engine's AST guard: every transformer
    call, every executable's load and run and every making of one lives in
    an ``_exec_*`` hook, so that no call site bypasses the lockstep."""
    offenders = {}
    for meth in _engine_class().body:
        if isinstance(meth, ast.FunctionDef) and not meth.name.startswith("_exec_"):
            calls = _offending_calls(meth)
            if calls:
                offenders[meth.name] = calls
    assert not offenders, f"device steps outside _exec_* hooks: {offenders}"


def test_sample_tokens_only_in_exec_sample():
    offenders = {}
    for meth in _engine_class().body:
        if not isinstance(meth, ast.FunctionDef) or meth.name == "_exec_sample":
            continue
        for node in ast.walk(meth):
            if (isinstance(node, ast.Attribute) and node.attr == "sample_tokens"
                    and isinstance(node.value, ast.Name) and node.value.id == "sampling_ops"):
                offenders[meth.name] = True
    assert not offenders, offenders


def test_lockstep_mirrors_every_hook_and_op():
    """The hooks call the lockstep before they run, and the followers'
    loop handles every op the coordinator sends."""
    hooks = {m.name: ast.unparse(m) for m in _engine_class().body
             if isinstance(m, ast.FunctionDef) and m.name.startswith("_exec_")}
    for hook, call in (("_exec_get", "make"), ("_exec_run", "run"),
                       ("_exec_warmup", "warmup"), ("_exec_embed", "trunk"),
                       ("_exec_score", "trunk"), ("_exec_demote", "demote"),
                       ("_exec_restore", "restore"), ("_exec_scatter", "scatter"),
                       ("_exec_drop", "drop"), ("_exec_adopt", "adopt"),
                       ("_exec_extract", "extract"), ("_exec_handoff", "handoff")):
        assert f"self._lockstep.{call}" in hooks[hook], hook
    src = inspect.getsource(multihost)
    for op in ("OP_MAKE", "OP_RUN", "OP_WARMUP", "OP_NOOP", "OP_STOP", "OP_DEMOTE",
               "OP_RESTORE", "OP_SCATTER", "OP_DROP", "OP_TRUNK", "OP_ADOPT", "OP_EXTRACT",
               "OP_HANDOFF"):
        assert src.count(op) >= 3, f"{op} not used by both protocol sides"
    # the tier and migration page copies run only in their hooks (warmup's
    # round trip of block 0 onto itself makes the staging on rank 0 alone)
    copies = {}
    for meth in _engine_class().body:
        if (isinstance(meth, ast.FunctionDef) and not meth.name.startswith("_exec_")
                and meth.name != "warmup"):
            found = [n.func.id for n in ast.walk(meth) if isinstance(n, ast.Call)
                     and isinstance(n.func, ast.Name)
                     and n.func.id in ("gather_block_pages", "scatter_block_pages",
                                       "extract_seq_kv", "insert_seq_kv")]
            if found:
                copies[meth.name] = found
    assert not copies, copies


def test_descriptor_codec_round_trips():
    st = np.arange(12, dtype=np.int32)
    extras = [np.array([[1, 2], [3, 4]], np.int64), np.array([0.5, -1.25], np.float32),
              np.zeros((0, 3), np.int32)]
    meta, body = multihost._encode({"key": ["decode", 2, "greedy"]}, [st] + extras)
    back_meta, arrays = multihost._decode(body.numpy())
    assert back_meta["key"] == ["decode", 2, "greedy"]
    for a, b in zip([st] + extras, arrays):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The CLI: python -m tpuserve_torch.server --tp 2 --device cpu
# ---------------------------------------------------------------------------

SERVER = ["--tp", "2", "--device", "cpu", "--model", "tiny-qwen3", "--port", "0",
          "--host", "127.0.0.1", "--block-size", "4", "--num-blocks", "64",
          "--max-blocks-per-seq", "16", "--max-num-seqs", "4", "--no-warmup",
          "--no-kv-tiers"]


def start_server(tmp_path, argv) -> tuple:
    log = open(tmp_path / "rank0.log", "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT), TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    proc = subprocess.Popen([sys.executable, "-m", "tpuserve_torch.server", *argv],
                            stdout=log, stderr=subprocess.STDOUT, env=env,
                            stdin=subprocess.DEVNULL)
    log.close()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        text = (tmp_path / "rank0.log").read_text()
        if "listening on" in text:
            return proc, int(text.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    proc.kill()
    proc.wait()
    raise AssertionError((tmp_path / "rank0.log").read_text()[-3000:])


def children(pid: int) -> list:
    try:
        return [int(c) for c in Path(f"/proc/{pid}/task/{pid}/children").read_text().split()]
    except OSError:
        return []


def test_cli_tp2_serves_and_every_rank_exits(tmp_path):
    proc, port = start_server(tmp_path, SERVER)
    try:
        followers = children(proc.pid)
        assert len(followers) == 1
        body = json.dumps({"prompt": [5, 6, 7], "max_tokens": 8, "temperature": 0,
                           "ignore_eos": True, "return_token_ids": True}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=120).read())
        assert out["usage"]["completion_tokens"] == 8
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=90) == 0, (tmp_path / "rank0.log").read_text()[-3000:]
        assert not any(Path(f"/proc/{pid}").exists() for pid in followers)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=120).read())


def test_cli_tp2_serves_guided_embeddings_and_speculation(tmp_path):
    """``--tp 2 --speculative-k 2`` with the tiers on by default: a
    ``response_format`` completion, a repetitive prompt through the spec
    path and ``/v1/embeddings`` over HTTP; SIGTERM, and every rank exits 0."""
    argv = [a for a in SERVER if a != "--no-kv-tiers"] + ["--speculative-k", "2"]
    proc, port = start_server(tmp_path, argv)
    try:
        followers = children(proc.pid)
        assert len(followers) == 1
        out = _post(port, "/v1/completions", {
            "prompt": [5, 6, 7], "max_tokens": 24, "temperature": 0,
            "response_format": {"type": "json_object"}})
        assert out["usage"]["completion_tokens"] > 0
        assert out["choices"][0]["text"].lstrip().startswith("{")
        out = _post(port, "/v1/completions", {
            "prompt": [1, 2, 3, 4] * 5, "max_tokens": 8, "temperature": 0, "ignore_eos": True})
        assert out["usage"]["completion_tokens"] == 8
        metrics = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                         timeout=30).read().decode()
        proposed = [float(line.split()[-1]) for line in metrics.splitlines()
                    if line.startswith("tpuserve_spec_draft_tokens_proposed")]
        assert proposed and proposed[0] > 0
        emb = _post(port, "/v1/embeddings", {"input": ["hello world", "hi"]})
        vecs = [d["embedding"] for d in emb["data"]]
        assert len(vecs) == 2 and all(abs(np.linalg.norm(v) - 1) < 1e-3 for v in vecs)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=90) == 0, (tmp_path / "rank0.log").read_text()[-3000:]
        assert not any(Path(f"/proc/{pid}").exists() for pid in followers)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_a_follower_failure_stops_rank_0(tmp_path):
    """A follower killed mid-service: rank 0 exits non-zero, bounded, with
    no rank left behind."""
    proc, _port = start_server(tmp_path, SERVER)
    try:
        followers = children(proc.pid)
        os.kill(followers[0], signal.SIGKILL)
        rc = proc.wait(timeout=90)
        assert rc != 0
        assert "follower rank 1 exited" in (tmp_path / "rank0.log").read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_topology_checks(capsys):
    """The JAX server's argument checks, --pp's among them."""
    from tpuserve_torch.server.openai_api import main
    for argv, msg in ((["--pp", "2", "--tp", "2"], "mutually exclusive"),
                      (["--pp", "2", "--multihost"], "drop --disagg/--role/--multihost"),
                      (["--role", "prefill"], "requires --decode-url"),
                      (["--role", "decode", "--disagg"], "its own topology"),
                      (["--role", "decode", "--multihost"], "its own topology"),
                      (["--disagg", "--multihost"], "cannot mirror an in-process")):
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert ei.value.code == 2
        err = capsys.readouterr().err
        assert msg in err and "A10" not in err
    # disaggregation on a --tp mesh parses and passes the topology checks
    from tpuserve_torch.server.openai_api import _check_topology, build_parser
    for argv in (["--disagg", "--tp", "2"], ["--role", "decode", "--tp", "2"],
                 ["--role", "prefill", "--decode-url", "http://d:1", "--tp", "2"]):
        ap = build_parser()
        args = ap.parse_args(argv)
        _check_topology(ap, args)
        assert args.tp == 2 and (args.disagg or args.role)


if __name__ == "__main__":
    _worker(sys.argv[1])
