"""The port stands alone: no JAX, no ``tpuserve`` import anywhere in
``tpuserve_torch`` or ``chip_smoke.py``; no silent CPU fallback; the
kernel modules import on a machine without nvcc; and chip_smoke.py refuses
to report without a card or without the package."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch intra-op threads while this file runs: under pytest-xdist
    several files run at once on the same cores, and torch would otherwise
    start one thread a core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent
# the card-only kernel tests run where there is no JAX, so they stand alone too
PORT_FILES = sorted((ROOT / "tpuserve_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels.py"]
FORBIDDEN = ("jax", "jaxlib", "tpuserve")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_tpuserve(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run(code: str, cwd=ROOT, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_importing_the_engine_loads_no_jax():
    res = _run("import sys, tpuserve_torch.runtime.engine, tpuserve_torch.ops._build\n"
               "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'tpuserve')]\n"
               "assert not bad, bad\n"
               "assert 'triton' not in sys.modules\n"
               "print('clean')")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_importing_the_server_loads_no_jax_and_no_optional_packages():
    """The card's machine has no prometheus_client, jinja2 or transformers:
    the server imports none of them (jinja2 only for --chat-template)."""
    res = _run("import sys, tpuserve_torch.server.openai_api, tpuserve_torch.server.__main__\n"
               "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
               "'tpuserve', 'prometheus_client', 'jinja2', 'transformers', 'safetensors')]\n"
               "assert not bad, bad\n"
               "print('clean')")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_tier_modules_load_no_jax_and_no_ml_dtypes():
    """The tier store and the prefix digest stand alone: the card's machine
    has neither JAX nor ml_dtypes (bf16 spill pages are read back through
    torch's own bfloat16)."""
    res = _run("import sys, tpuserve_torch.runtime.kv_tiers, tpuserve_torch.server.kv_digest\n"
               "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'tpuserve', 'ml_dtypes')]\n"
               "assert not bad, bad\n"
               "print('clean')")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    for rel in ("runtime/kv_tiers.py", "server/kv_digest.py", "runtime/kv_cache.py"):
        path = ROOT / "tpuserve_torch" / rel
        assert path in PORT_FILES
        assert "ml_dtypes" not in {m.split(".")[0] for m in _imported_modules(path)}


def test_slo_fault_and_runner_modules_load_no_jax():
    """The SLO controller, the fault injector, the runner (salvage,
    bisection, watchdog), the flight recorder, the host-phase profiler, the
    tracer and tool calls are the port's own copies: importing them loads
    no jax and no tpuserve module (and no opentelemetry: the tracer imports
    it only when an exporter is configured)."""
    res = _run("import sys, tpuserve_torch.runtime.slo, tpuserve_torch.runtime.faults, "
               "tpuserve_torch.server.runner, tpuserve_torch.runtime.flight, "
               "tpuserve_torch.runtime.hostprof, tpuserve_torch.server.tracing, "
               "tpuserve_torch.server.tool_calls\n"
               "assert 'opentelemetry' not in sys.modules\n"
               "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'tpuserve')]\n"
               "assert not bad, bad\n"
               "print('clean')")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    for rel in ("runtime/slo.py", "runtime/faults.py", "server/runner.py", "runtime/flight.py",
                "runtime/hostprof.py", "server/tracing.py", "server/tool_calls.py"):
        assert ROOT / "tpuserve_torch" / rel in PORT_FILES


def test_spec_and_download_modules_load_no_jax_and_no_hub():
    """Speculation's host side and the checkpoint downloader are the port's
    own copies: importing them loads no jax, no tpuserve module and no
    huggingface_hub (the downloader imports it only when it fetches)."""
    res = _run("import sys, tpuserve_torch.runtime.spec, tpuserve_torch.models.download\n"
               "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'tpuserve', 'huggingface_hub')]\n"
               "assert not bad, bad\n"
               "print('clean')")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    for rel in ("runtime/spec.py", "models/download.py"):
        path = ROOT / "tpuserve_torch" / rel
        assert path in PORT_FILES
        top = ast.parse(path.read_text()).body          # module-level imports only
        mods = {a.name for n in top if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in top if isinstance(n, ast.ImportFrom) and n.module}
        assert "huggingface_hub" not in {m.split(".")[0] for m in mods}


def test_fleet_modules_load_no_jax():
    """The fleet layer (replay, the autoscaler, the gateway, the alert
    backtest) is the port's own copy: importing every module of it, and
    running the lazy imports inside its functions (the gateway's tenants,
    digest, HTTP server, canary and tracer; the harness's engine; the
    pool's report), loads no jax and no tpuserve module."""
    res = _run("import sys, tpuserve_torch.replay, tpuserve_torch.autoscale, "
               "tpuserve_torch.autoscale.__main__, tpuserve_torch.server.gateway, "
               "tpuserve_torch.obs.backtest\n"
               "from tpuserve_torch.server.gateway import Gateway, GatewayConfig\n"
               "gw = Gateway(['http://127.0.0.1:9'], GatewayConfig(host='127.0.0.1', port=0,\n"
               "    health_interval_s=3600, tenant_config='{\"tenants\": {}}'))\n"
               "gw.pick_backend(b'{\"prompt\": \"x\"}'); gw.start(); gw.shutdown()\n"
               "from tpuserve_torch.replay import Workload, WorkloadRequest, ReplayOptions, replay\n"
               "wl = Workload([WorkloadRequest('r', 0.0, 4, 2)])\n"
               "replay(wl, ReplayOptions(device='cpu', include_token_streams=False))\n"
               "from tpuserve_torch.autoscale import (PoolReplayOptions, PolicyConfig,\n"
               "    make_storm_workload, pool_replay)\n"
               "pool_replay(make_storm_workload(n=2, ramp_s=0.1, span_s=0.2, max_tokens=2),\n"
               "    PoolReplayOptions(device='cpu'), PolicyConfig(max_replicas=1))\n"
               "from tpuserve_torch.server.metrics import AutoscalerMetrics\n"
               "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'tpuserve', 'prometheus_client')]\n"
               "assert not bad, bad\n"
               "print('clean')")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("clean")
    for rel in ("replay/harness.py", "replay/extract.py", "autoscale/pool.py",
                "autoscale/reconciler.py", "server/gateway.py", "obs/backtest.py"):
        assert ROOT / "tpuserve_torch" / rel in PORT_FILES


def test_pipeline_ring_and_train_modules_load_no_jax(tmp_path):
    """The rest of A10 (the pipeline stages, ring and Ulysses attention,
    the fine-tuning step) is the port's own: importing the modules and
    running their lazy paths in a one-rank gloo group (a stage, the sp
    group, both attentions, a train step with its collectives) loads no jax
    and no tpuserve module."""
    res = _run("import sys, dataclasses, torch, torch.distributed as dist\n"
               "from tpuserve_torch.parallel import pipeline, ring_attention, train\n"
               f"dist.init_process_group('gloo', init_method='file://{tmp_path}/s', rank=0,"
               " world_size=1)\n"
               "from tpuserve_torch.models.config import get_model_config\n"
               "from tpuserve_torch.models.weights import init_params\n"
               "cfg = dataclasses.replace(get_model_config('tiny-qwen3'), dtype='float32')\n"
               "st = pipeline.PipeStage(2, 1, torch.device('cpu'), 'gloo')\n"
               "assert pipeline.stage_config(cfg, st).num_layers == cfg.num_layers // 2\n"
               "g = ring_attention.make_sp_group()\n"
               "q = ring_attention.seq_shard(torch.randn(1, 8, 4, 16), g)\n"
               "lens = torch.tensor([8], dtype=torch.int32)\n"
               "a = ring_attention.ring_prefill_attention(q, q, q, lens, 0.25, g)\n"
               "b = ring_attention.ulysses_prefill_attention(q, q, q, lens, 0.25, g)\n"
               "assert torch.allclose(a, b, atol=1e-5)\n"
               "comm = train.make_train_comm(1, 1)\n"
               "p = init_params(cfg, 0, 'cpu')\n"
               "tcfg = train.TrainConfig()\n"
               "opt, state = train.init_train_state(p, tcfg)\n"
               "tok = torch.randint(1, 100, (2, 8))\n"
               "train.train_step(p, state, train.train_config(cfg, comm), tcfg, opt, tok,"
               " torch.ones(2, 8, dtype=torch.bool))\n"
               "dist.destroy_process_group()\n"
               "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpuserve')]\n"
               "assert not bad, bad\n"
               "print('clean')")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("clean")
    for rel in ("parallel/pipeline.py", "parallel/ring_attention.py", "parallel/train.py"):
        assert ROOT / "tpuserve_torch" / rel in PORT_FILES


def test_engine_without_device_raises_when_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from tpuserve_torch.runtime import Engine, EngineConfig
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(EngineConfig(model="tiny-qwen3"))


def test_kernel_modules_import_without_nvcc_and_build_nothing():
    """Importing the wrappers starts no build; without a CUDA toolkit the
    build itself raises instead of falling back."""
    from tpuserve_torch.ops import _build, flash_prefill, paged_decode
    assert flash_prefill.LAUNCHES >= 0 and paged_decode.LAUNCHES >= 0
    assert not _build._LIBS
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("paged_decode")


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_refuses_without_the_package(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_provisioner_loads_no_jax_no_tools_and_no_torch():
    """The provisioner deploys from a host without a card: importing every
    module of it, and its CLI's ``--help``, loads no jax, no tpuserve or
    tools module, no torch and no PyYAML (only rendering YAML text needs
    it)."""
    mods = ", ".join(f"tpuserve_torch.provision.{p.stem}"
                     for p in sorted((ROOT / "tpuserve_torch" / "provision").glob("*.py"))
                     if p.stem not in ("__init__", "__main__"))
    check = ("bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'tpuserve', 'tools', 'torch', 'yaml')]\n"
             "assert not bad, bad\n")
    res = _run(f"import sys, tpuserve_torch.provision, {mods}\n" + check + "print('clean')")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    res = _run("import runpy, sys\n"
               "sys.argv = ['tpuserve_torch.provision', '--help']\n"
               "try:\n"
               "    runpy.run_module('tpuserve_torch.provision', run_name='__main__')\n"
               "except SystemExit as e:\n"
               "    assert e.code == 0, e.code\n" + check + "print('clean')")
    assert res.returncode == 0, res.stderr
    assert "gpu-provisioner" in res.stdout and res.stdout.strip().endswith("clean")
    for p in (ROOT / "tpuserve_torch" / "provision").glob("*.py"):
        assert p in PORT_FILES
        assert "tools" not in {m.split(".")[0] for m in _imported_modules(p)}
