"""The port's rank grid and sharding (``tpuserve_torch/parallel/mesh.py``,
``sharding.py``), attention on a rank's heads, and the process-wide
capture lock of ``runtime/graphs.py`` (F7), on the CPU.

Every rank's slice of the weights must equal the shard the JAX package
places on the matching device of its mesh (``shard_params`` on
``make_mesh(MeshConfig(tp=..., ep=...))`` over the 8 virtual CPU devices of
``tests/conftest.py``), for a dense model, MoE (int8 too) and MLA.  The
lockstep ranks themselves run in ``tests/test_torch_multihost.py``.
"""

import dataclasses
import datetime
import inspect
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpuserve.models import weights as jax_weights
from tpuserve.models.config import get_model_config as jax_model_config
from tpuserve.parallel import MeshConfig as JaxMeshConfig
from tpuserve.parallel import make_mesh as jax_make_mesh
from tpuserve.parallel import shard_params as jax_shard_params
from tpuserve_torch.models import weights
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.ops import attention as attn_ops
from tpuserve_torch.parallel import sharding
from tpuserve_torch.parallel.mesh import MeshConfig, RankComm, RankMesh, make_mesh
from tpuserve_torch.runtime import graphs as graphs_mod

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs (xdist workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rank_mesh(tp: int, ep: int, rank: int) -> RankMesh:
    """Rank ``rank`` of an ep x tp grid, without a process group: slicing
    reads only the coordinates."""
    e, t = divmod(rank, tp)
    return RankMesh(cfg=MeshConfig(tp=tp, ep=ep), rank=rank, world=tp * ep,
                    device=torch.device("cpu"), backend="gloo",
                    comm=RankComm(tp, t, None, ep, e, None), ctrl_group=None)


def _flat(tree, prefix="") -> dict:
    """Leaves by path, list indices kept."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}.{i}"))
        return out
    return {prefix: tree}


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


CASES = [("tiny-qwen3", 2, 1, False), ("tiny-qwen3", 4, 1, False),
         ("tiny-moe", 2, 1, False), ("tiny-moe", 1, 2, False), ("tiny-moe", 1, 4, False),
         ("tiny-moe", 2, 2, True), ("tiny-moe", 1, 4, True),
         ("tiny-deepseek", 2, 1, False), ("tiny-deepseek", 4, 1, False),
         ("tiny-deepseek", 1, 4, False), ("tiny-deepseek", 2, 2, False)]


@pytest.mark.parametrize("name,tp,ep,int8", CASES,
                         ids=[f"{n}-tp{t}-ep{e}{'-int8' if q else ''}" for n, t, e, q in CASES])
def test_shard_params_equals_the_jax_shards(name, tp, ep, int8):
    """Each rank's slice of every leaf equals the addressable shard the
    JAX ``shard_params`` puts on the device at the rank's grid position
    (int8: quantized whole, then sharded, on both sides)."""
    jcfg = dataclasses.replace(jax_model_config(name), dtype="float32")
    cfg = dataclasses.replace(get_model_config(name), dtype="float32")
    jparams = jax_weights.init_params(jcfg, seed=1)
    params = weights.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    if int8:
        jparams = jax_weights.quantize_params_int8(jparams)
        params = weights.quantize_params_int8(params)
    jmesh = jax_make_mesh(JaxMeshConfig(tp=tp, ep=ep))
    jflat = _flat(jax_shard_params(jparams, jcfg, jmesh))
    devices = list(jmesh.devices.reshape(-1))
    for rank in range(tp * ep):
        ours = _flat(sharding.shard_params(params, cfg, rank_mesh(tp, ep, rank)))
        assert ours.keys() == jflat.keys()
        for path, arr in jflat.items():
            shard = next(s for s in arr.addressable_shards if s.device == devices[rank])
            np.testing.assert_array_equal(_numpy(ours[path]), np.asarray(shard.data),
                                          err_msg=f"rank {rank} {path}")


def test_spec_for_follows_the_jax_rules():
    from tpuserve.parallel.sharding import _spec_for
    cfg = get_model_config("tiny-deepseek")
    paths = [p for p, _ in sharding.tree_paths(weights.init_params(
        dataclasses.replace(cfg, dtype="float32"), device="cpu"))]
    paths += ["embed.scale", "layers.q_proj.scale", "layers.o_proj.scale",
              "layers.experts.gate_proj.scale", "lm_head.kernel", "lm_head.scale"]
    for path in paths:
        assert sharding.spec_for(path) == tuple(_spec_for(path, cfg)), path


def test_rank_config_and_cache_heads():
    cfg = get_model_config("Qwen/Qwen2-72B-Instruct")
    rc = sharding.rank_config(cfg, rank_mesh(4, 1, 1))
    assert (rc.num_heads, rc.num_kv_heads, rc.intermediate_size) == (16, 2, 29568 // 4)
    assert rc.vocab_size == cfg.vocab_size and rc.comm.tp_rank == 1
    assert rc == dataclasses.replace(rc, comm=None)          # comm takes no part in equality
    assert sharding.cache_kv_heads(cfg, rank_mesh(4, 1, 0)) == 2
    moe = get_model_config("Qwen/Qwen3-30B-A3B")
    rm = sharding.rank_config(moe, rank_mesh(1, 4, 3))
    assert rm.num_experts == 32 and rm.expert_intermediate_size == moe.expert_intermediate_size
    assert sharding.cache_kv_heads(get_model_config("tiny-deepseek"), rank_mesh(4, 1, 0)) == 1
    with pytest.raises(ValueError, match="kv heads"):
        sharding.rank_config(get_model_config("tiny-qwen3"), rank_mesh(4, 1, 0))
    with pytest.raises(ValueError, match="experts"):
        sharding.rank_config(get_model_config("tiny-qwen3"), rank_mesh(1, 2, 0))


def test_rank_slicer_reads_only_the_ranks_blocks():
    """The loader's slicer: a column leaf's rank block, the experts a rank
    holds, and with ``top_only`` layers left whole."""
    mesh = rank_mesh(2, 2, 3)
    sl = sharding.RankSlicer(mesh)
    w = torch.arange(8 * 6).reshape(8, 6)
    assert torch.equal(sl("layers.q_proj.kernel", w), w[:, 3:])
    assert torch.equal(sl("layers.o_proj.kernel", w), w[4:])
    assert torch.equal(sl("embed.weight", w), w[4:])
    assert list(sl.experts(8)) == [4, 5, 6, 7]
    top = sl.top_level()
    assert torch.equal(top("layers.q_proj.kernel", w), w) and top.tp == 1
    assert list(top.experts(8)) == list(range(8))


def _with_group(tmp_path, fn):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        return fn()
    finally:
        dist.destroy_process_group()


def test_mesh_shapes_and_the_too_large_refusal(tmp_path):
    def body():
        mesh = make_mesh(MeshConfig(tp=1), device_type="cpu")
        assert mesh.shape == {"dp": 1, "ep": 1, "pp": 1, "tp": 1}
        assert (mesh.rank, mesh.world, mesh.tp_rank, mesh.ep_rank) == (0, 1, 0, 0)
        assert mesh.is_coordinator and mesh.device.type == "cpu"
        # no card here: a grid larger than the cards present is refused,
        # with the JAX make_mesh's message
        with pytest.raises(ValueError, match="needs 1 devices, have 0"):
            make_mesh(MeshConfig(tp=1), device_type="cuda", devices=[])
        with pytest.raises(ValueError, match="ranks"):
            make_mesh(MeshConfig(tp=2), device_type="cpu")
        # a pp grid builds (one stage here: the grid's rank count is checked
        # against the group's, as tp's); a pp grid beside tp or ep, or across
        # nodes, is refused as the JAX pipeline engine refuses it
        with pytest.raises(ValueError, match="ranks"):
            make_mesh(MeshConfig(pp=2), device_type="cpu")
        with pytest.raises(ValueError, match="pure"):
            make_mesh(MeshConfig(pp=2, tp=2), device_type="cpu")
        with pytest.raises(ValueError, match="one node"):
            make_mesh(MeshConfig(pp=2), device_type="cpu", multihost=True)
        mesh = make_mesh(MeshConfig(pp=1), device_type="cpu")
        assert mesh.stage is None and mesh.shape["pp"] == 1
    _with_group(tmp_path, body)
    assert MeshConfig(tp=4, ep=2).num_devices == 8


def test_backend_is_explicit():
    from tpuserve_torch.parallel.mesh import default_backend, multihost_initialize
    assert default_backend("cuda") == "nccl" and default_backend("cpu") == "gloo"
    with pytest.raises(ValueError, match="nccl backend needs"):
        multihost_initialize("cpu", backend="nccl", init_method="file:///nonexistent",
                             rank=0, world_size=1)


def test_engine_refusals_under_a_mesh(tmp_path):
    """The JAX engine's refusals (multi-LoRA, hot-swap, and across nodes its
    multi-process ones); what a one-node mesh now serves (speculation, the
    tiers, guided decoding, embeddings, scoring); graphs on gloo."""
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SamplingParams
    from tpuserve_torch.runtime.spec import SpecConfig
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    cache = CacheConfig(block_size=4, num_blocks=32, max_blocks_per_seq=8, dtype="float32")

    def body():
        mesh = make_mesh(MeshConfig(tp=1), device_type="cpu")
        base = EngineConfig(model="tiny-qwen3", cache=cache)
        with pytest.raises(ValueError, match="multi-LoRA"):
            Engine(dataclasses.replace(base, lora_modules={"a": "/x"}), model_cfg=cfg,
                   mesh=mesh, device="cpu")
        spec = Engine(dataclasses.replace(base, speculative=SpecConfig(), kv_tiers=True),
                      model_cfg=cfg, mesh=mesh, device="cpu")
        assert spec._spec is not None and spec._kv_tiers is not None
        with pytest.raises(ValueError, match="cuda_graphs=True needs device"):
            Engine(dataclasses.replace(base, cuda_graphs=True), model_cfg=cfg, mesh=mesh,
                   device="cpu")
        eng = Engine(base, model_cfg=cfg, mesh=mesh, device="cpu")
        # the tiers follow the one-card default; decode stays unpipelined
        assert eng._kv_tiers is not None and not eng._pipeline_decode
        out = eng.generate([[1, 2]], SamplingParams(
            max_tokens=8, temperature=0.0, guided="choice", guided_schema='["a", "b"]'))
        assert out[0].output_text in ("a", "b")
        vecs, counts = eng.embed([[1, 2, 3]])
        assert vecs.shape == (1, cfg.hidden_size) and counts == [3]
        assert len(eng.score_prompts([[1, 2, 3]])[0]) == 3
        with pytest.raises(ValueError, match="hot-swap"):
            eng.swap_model(base)
        # several nodes: the JAX intake refusal of what the lockstep does not
        # mirror there, its embeddings and scoring refusals, the tiers off
        mesh.multihost = True
        with pytest.raises(ValueError, match="multi-host"):
            eng.add_request(prompt_token_ids=[1, 2], params=SamplingParams(logprobs=2))
        with pytest.raises(ValueError, match="multi-host"):
            eng.add_request(prompt_token_ids=[1, 2], params=SamplingParams(
                guided="choice", guided_schema='["a", "b"]'))
        with pytest.raises(ValueError, match="multi-host"):
            eng.embed([[1, 2, 3]])
        with pytest.raises(ValueError, match="multi-host"):
            eng.score_prompts([[1, 2, 3]])
        assert Engine(dataclasses.replace(base, kv_tiers=True), model_cfg=cfg, mesh=mesh,
                      device="cpu")._kv_tiers is None
        cfg_gloo = dataclasses.replace(base)
        assert not cfg_gloo.resolve_cuda_graphs(torch.device("cpu"), mesh)
    _with_group(tmp_path, body)


def test_draft_rank_config_splits_or_refuses_as_a_targets():
    """A speculative draft under a mesh: its heads split over tp as a
    target's (refused where they do not), and a dense draft beside an MoE
    target on an ep grid keeps its MLP whole (its leaves split over tp
    alone)."""
    cfg = get_model_config("tiny-qwen3")                  # 4 heads, 2 kv heads
    got = sharding.draft_rank_config(cfg, rank_mesh(2, 1, 1))
    assert (got.num_heads, got.num_kv_heads, got.intermediate_size) == (2, 1, 64)
    with pytest.raises(ValueError, match="kv heads do not split"):
        sharding.draft_rank_config(cfg, rank_mesh(4, 1, 0))
    with pytest.raises(ValueError, match="experts do not split"):
        sharding.rank_config(cfg, rank_mesh(1, 2, 0))
    got = sharding.draft_rank_config(cfg, rank_mesh(2, 2, 3))
    assert (got.num_heads, got.num_kv_heads, got.intermediate_size) == (2, 1, 64)
    assert got.num_experts == 0 and got.comm.ep == 2


def test_hbm_share_halves_an_auto_sized_cache():
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    # 16 KiB blocks: the CPU's 1 GiB budget makes ~65,000, under the cap
    cache = CacheConfig(block_size=64, num_blocks=0, max_blocks_per_seq=8, dtype="float32")
    params = weights.init_params(cfg, device="cpu")
    blocks = [Engine(EngineConfig(model="tiny-qwen3", cache=cache, hbm_share=share,
                                  scheduler=dataclasses.replace(
                                      EngineConfig().scheduler, max_num_seqs=1 << 14)),
                     params=params, model_cfg=cfg, device="cpu").cache_cfg.num_blocks
              for share in (1.0, 0.5)]
    assert blocks[1] < blocks[0] and abs(blocks[1] * 2 - blocks[0]) <= 2 * blocks[0] // 100 + 2


def test_rank_heads_attention_and_partitionable():
    """Head-parallel decomposition: the attention a rank runs on its own
    heads (the wrappers the transformer calls, here their CPU versions)
    equals the attention over every head, restricted to them; heads that do
    not split over tp are refused, by the one rule ``tp_partitionable``."""
    from tpuserve_torch.ops.flash_prefill import flash_prefill_attention
    from tpuserve_torch.ops.paged_decode import paged_decode_attention
    g = torch.Generator().manual_seed(0)
    B, Hq, Hkv, D, page, nb = 2, 8, 4, 16, 4, 8
    q = torch.randn(B, Hq, D, generator=g)
    kc = torch.randn(nb, page, Hkv, D, generator=g)
    vc = torch.randn(nb, page, Hkv, D, generator=g)
    bt = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    lens = torch.tensor([13, 9], dtype=torch.int32)
    full = attn_ops.paged_decode_attention(q, kc, vc, bt, lens, 0.25)
    for r in range(2):
        qs, ks = slice(r * 4, r * 4 + 4), slice(r * 2, r * 2 + 2)
        out = paged_decode_attention(q[:, qs].contiguous(), kc[:, :, ks].contiguous(),
                                     vc[:, :, ks].contiguous(), bt, lens, 0.25)
        torch.testing.assert_close(out, full[:, qs], rtol=0, atol=1e-6)
    qp = torch.randn(B, 6, Hq, D, generator=g)
    kp = torch.randn(B, 6, Hkv, D, generator=g)
    vp = torch.randn(B, 6, Hkv, D, generator=g)
    pl = torch.tensor([6, 4], dtype=torch.int32)
    fullp = attn_ops.prefill_attention(qp, kp, vp, pl, 0.25)
    outp = flash_prefill_attention(qp[:, :, 4:].contiguous(), kp[:, :, 2:].contiguous(),
                                   vp[:, :, 2:].contiguous(), pl, 0.25)
    torch.testing.assert_close(outp[:, :4], fullp[:, :4, 4:], rtol=0, atol=1e-6)
    assert sharding.tp_partitionable(4, rank_mesh(2, 1, 0))
    assert not sharding.tp_partitionable(2, rank_mesh(4, 1, 0))
    assert not sharding.tp_partitionable(4, rank_mesh(1, 2, 0))
    assert not sharding.tp_partitionable(4, None)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), num_heads=8, num_kv_heads=2)
    with pytest.raises(ValueError, match="kv heads do not split over tp=4"):
        sharding.rank_config(cfg, rank_mesh(4, 1, 0))
    assert sharding.rank_config(cfg, rank_mesh(2, 1, 1)).num_kv_heads == 1


def _cpu_graphs(n: int) -> list:
    """``n`` engines' StepGraphs on one tiny float32 tree, each with a
    prefill executable (the CPU captures nothing)."""
    from tpuserve_torch.runtime.graphs import Executable, StepGraphs
    from tpuserve_torch.runtime.kv_cache import CacheConfig, create_kv_cache
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = weights.init_params(cfg, device="cpu")
    out = []
    for _ in range(n):
        cache = create_kv_cache(cfg, CacheConfig(block_size=4, num_blocks=8,
                                                 max_blocks_per_seq=4, dtype="float32"), "cpu")
        g = StepGraphs(params, cfg, cache, device=torch.device("cpu"), attn_impl="reference",
                       max_blocks=4, steps=1, max_batch=2, capture=False)
        out.append((g, Executable(g, ("prefill", 1, 8))))
    return out


def test_captures_never_overlap_across_engines():
    """F7: two engines' StepGraphs capture one at a time in a process.  The
    captures are patched to record their intervals (the CPU has no
    graphs); two threads capture at once, and the intervals must not
    overlap.  The capture runs in the thread-local error mode."""
    spans, errors = [], []
    engines = _cpu_graphs(2)
    for g, _ in engines:
        def record(exe, g=g):
            t0 = time.monotonic()
            time.sleep(0.05)
            spans.append((t0, time.monotonic()))
        g._capture_locked = record
    start = threading.Barrier(2)

    def run(g, exe):
        try:
            start.wait()
            for _ in range(4):
                g._capture(exe)
        except Exception as e:       # surfaced below
            errors.append(e)
    threads = [threading.Thread(target=run, args=pair) for pair in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors and not any(t.is_alive() for t in threads)
    spans.sort()
    assert len(spans) == 8
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all(g.capture_s > 0.15 for g, _ in engines)
    src = inspect.getsource(graphs_mod.StepGraphs._capture_locked)
    assert 'capture_error_mode="thread_local"' in src
    # the kernels' launch counts and the replays' additions share one lock
    from tpuserve_torch.ops import _build
    assert graphs_mod._COUNTS_LOCK is _build.LAUNCH_LOCK


def test_a_capture_blocks_no_other_engine():
    """F7: a capture holds the capture lock only.  While one engine's
    thread captures (patched: the CPU has no graphs), another thread takes
    the kernels' launch lock at once, and another engine's replay runs,
    adds its launches to the wrappers' counts and counts as beside a
    capture.  Launches inside ``_build.tally`` (a capture's) go to that
    thread's tally only, nested tallies apart."""
    from tpuserve_torch.ops import _build, paged_decode
    (g0, exe0), (g1, exe1) = _cpu_graphs(2)
    inside, release = threading.Event(), threading.Event()

    def capture(exe):
        inside.set()
        release.wait(10)
    g0._capture_locked = capture
    replays = []

    class Graph:
        def replay(self):
            replays.append(threading.get_ident())
    exe1.graph = Graph()
    exe1.launches = {"flash_prefill": 0, "paged_decode": 3, "paged_window": 0,
                     "ragged_paged": 0}
    t = threading.Thread(target=g0._capture, args=(exe0,))
    t.start()
    try:
        assert inside.wait(10)
        assert _build.LAUNCH_LOCK.acquire(timeout=5)
        _build.LAUNCH_LOCK.release()
        n0 = paged_decode.LAUNCHES
        exe1.run(2)
        assert len(replays) == 2 and paged_decode.LAUNCHES == n0 + 6
        assert g1.replays_beside_capture == 2 and g0.replays_beside_capture == 0
    finally:
        release.set()
        t.join(10)
    assert not t.is_alive()
    exe1.run(1)
    assert len(replays) == 3 and g1.replays_beside_capture == 2
    assert not _build.tallied("paged_decode")
    with _build.tally() as made:
        assert _build.tallied("paged_decode")
        with _build.tally() as inner:
            assert _build.tallied("ragged_paged")
        assert _build.tallied("paged_decode")
    assert made == {"paged_decode": 2} and inner == {"ragged_paged": 1}
    assert not _build.tallied("paged_decode")


def test_parallel_modules_load_no_jax():
    code = ("import sys, tpuserve_torch.parallel, tpuserve_torch.parallel.multihost, "
            "tpuserve_torch.parallel.disagg, tpuserve_torch.parallel.disagg_net\n"
            "from tpuserve_torch.parallel.disagg_net import serialize_migration, "
            "deserialize_migration\n"
            "import torch\n"
            "kv = [{'k': torch.ones(2, 4, 1, 8, dtype=torch.bfloat16)}]\n"
            "meta, back = deserialize_migration(serialize_migration({'a': 1}, kv))\n"
            "assert torch.equal(back[0]['k'], kv[0]['k'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpuserve', 'ml_dtypes')]\n"
            "assert not bad, bad\n"
            "print('clean')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


# ---------------------------------------------------------------------------
# A rank's weights from the loader and the init: its slices, nothing more
# ---------------------------------------------------------------------------

def _hf_models():
    import transformers
    common = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, max_position_embeddings=512, bos_token_id=0,
                  eos_token_id=1)
    return {
        "qwen3": transformers.Qwen3ForCausalLM(transformers.Qwen3Config(
            **common, num_key_value_heads=2, head_dim=16, tie_word_embeddings=True)),
        "phi3": transformers.Phi3ForCausalLM(transformers.Phi3Config(
            **common, num_key_value_heads=2, tie_word_embeddings=False, pad_token_id=0)),
        "opt": transformers.OPTForCausalLM(transformers.OPTConfig(
            vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=512, word_embed_proj_dim=64,
            do_layer_norm_before=True, bos_token_id=0, eos_token_id=1, pad_token_id=0)),
        "qwen3_moe": transformers.Qwen3MoeForCausalLM(transformers.Qwen3MoeConfig(
            **common, num_key_value_heads=2, head_dim=16, num_experts=4,
            num_experts_per_tok=2, moe_intermediate_size=32, decoder_sparse_step=1,
            mlp_only_layers=[], tie_word_embeddings=False)),
    }


@pytest.fixture(scope="module")
def hf_checkpoints(tmp_path_factory):
    import json as _json
    from tpuserve_torch.models.config import config_from_hf_json
    out = {}
    torch.manual_seed(0)
    for name, model in _hf_models().items():
        path = tmp_path_factory.mktemp(f"ckpt-{name}")
        model.to(torch.float32).save_pretrained(path, safe_serialization=True)
        hf = _json.loads((path / "config.json").read_text())
        out[name] = (str(path), dataclasses.replace(config_from_hf_json("ckpt", hf),
                                                    dtype="float32"))
    return out


@pytest.mark.parametrize("family,tp,ep", [("qwen3", 2, 1), ("phi3", 2, 1), ("opt", 4, 1),
                                          ("qwen3_moe", 2, 2), ("qwen3_moe", 1, 4)])
def test_loader_reads_each_ranks_slices(hf_checkpoints, monkeypatch, family, tp, ep):
    """With a rank's slicer the loader gives exactly the rank's slice of the
    whole tree (float32, and int8, quantized whole then sliced), and reads
    no expert the rank does not hold."""
    path, cfg = hf_checkpoints[family]
    whole = weights.load_hf_checkpoint(cfg, path, "cpu")
    quant = weights.quantize_params_int8(whole)
    read = []
    real = weights.SafetensorsDir.__getitem__

    def spy(self, name):
        read.append(name)
        return real(self, name)
    monkeypatch.setattr(weights.SafetensorsDir, "__getitem__", spy)
    for rank in range(tp * ep):
        mesh = rank_mesh(tp, ep, rank)
        sl = sharding.RankSlicer(mesh)
        read.clear()
        ours = _flat(weights.load_or_init(cfg, path, shard=sl, device="cpu"))
        want = _flat(sharding.shard_params(whole, cfg, mesh))
        assert ours.keys() == want.keys()
        for k in want:
            assert torch.equal(ours[k], want[k]), (rank, k)
        held = set(sl.experts(cfg.num_experts)) if cfg.num_experts else set()
        experts_read = {int(n.split("experts.")[1].split(".")[0]) for n in read
                        if "experts." in n}
        assert experts_read <= held
        q = weights.load_or_init(cfg, path, shard=sl, device="cpu",
                                 layer_fn=weights.quantize_layer_int8)
        ours_q = _flat(weights.quantize_params_int8(q))
        want_q = _flat(sharding.shard_params(quant, cfg, mesh))
        for k in want_q:
            assert torch.equal(ours_q[k], want_q[k]), (rank, k)


@pytest.mark.parametrize("family,pp", [("qwen3", 2), ("phi3", 2), ("opt", 2)])
def test_loader_reads_only_each_stages_layers(hf_checkpoints, monkeypatch, family, pp):
    """A pipeline stage's loader gives exactly the stage's part of the
    whole tree (float32 and int8) and reads no tensor of another stage's
    layers, nor, off stage 0, the embedding, final norm or head."""
    path, cfg = hf_checkpoints[family]
    whole = weights.load_hf_checkpoint(cfg, path, "cpu")
    quant = weights.quantize_params_int8(whole)
    read = []
    real = weights.SafetensorsDir.__getitem__

    def spy(self, name):
        read.append(name)
        return real(self, name)
    monkeypatch.setattr(weights.SafetensorsDir, "__getitem__", spy)
    k = cfg.num_layers // pp
    for stage in range(pp):
        mesh = RankMesh(cfg=MeshConfig(pp=pp), rank=stage, world=pp,
                        device=torch.device("cpu"), backend="gloo", comm=None,
                        ctrl_group=None)
        sl = sharding.RankSlicer(mesh, num_layers=cfg.num_layers)
        read.clear()
        ours = _flat(weights.load_or_init(cfg, path, shard=sl, device="cpu"))
        want = _flat(sharding.shard_params(whole, cfg, mesh))
        assert ours.keys() == want.keys()
        for key in want:
            assert torch.equal(ours[key], want[key]), (stage, key)
        layers_read = {int(n.split("layers.")[1].split(".")[0]) for n in read
                       if "layers." in n}
        assert layers_read == set(range(stage * k, (stage + 1) * k)), (stage, layers_read)
        top_read = [n for n in read if "layers." not in n]
        assert bool(top_read) == (stage == 0), (stage, top_read)
        q = weights.load_or_init(cfg, path, shard=sl, device="cpu",
                                 layer_fn=weights.quantize_layer_int8)
        ours_q = _flat(weights.quantize_params_int8(q))
        want_q = _flat(sharding.shard_params(quant, cfg, mesh))
        assert ours_q.keys() == want_q.keys()
        for key in want_q:
            assert torch.equal(ours_q[key], want_q[key]), (stage, key)


@pytest.mark.parametrize("name,tp,ep", [("tiny-qwen3", 2, 1), ("tiny-moe", 2, 2),
                                        ("tiny-deepseek", 4, 1)])
def test_init_draws_whole_layers_and_keeps_the_slice(name, tp, ep):
    """The init keeps its draw order: each rank's tree is its slice of the
    whole seeded tree (the JAX init's numbers)."""
    cfg = dataclasses.replace(get_model_config(name), dtype="float32")
    whole = weights.init_params(cfg, seed=5, device="cpu")
    for rank in range(tp * ep):
        mesh = rank_mesh(tp, ep, rank)
        ours = _flat(weights.load_or_init(cfg, None, 5, "cpu", shard=sharding.RankSlicer(mesh)))
        want = _flat(sharding.shard_params(whole, cfg, mesh))
        assert ours.keys() == want.keys()
        assert all(torch.equal(ours[k], want[k]) for k in want), rank
