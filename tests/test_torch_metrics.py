"""The port's ``/metrics`` against the JAX server's ``ServerMetrics``.

Both runners drive their engine through the same float32 tiny-qwen3 run on
the CPU, on a ``VirtualClock`` that never moves (so every latency the
runners stamp is 0 on both sides), one loop turn at a time on this thread
as ``AsyncEngineRunner._loop`` does: fused windows of 8 with
``min_multi_step`` 4, prompts arriving while decode is busy (so windows
shrink: ``tpuserve_latency_windows``), a repeated prompt (prefix-cache
hits), and a request whose admission deadline has passed when it arrives
(a 504: ``tpuserve_requests_failed``).  The rendered expositions must name
the same ``tpuserve_*`` / ``vllm_*`` families with the same types, and
every counter sample must have the same value.
"""

import dataclasses
import queue
import threading

import jax
import numpy as np
import pytest
import torch

from tpuserve import runtime as jax_rt
from tpuserve.models import weights as jax_weights
from tpuserve.models.config import get_model_config as jax_get_model_config
from tpuserve.runtime.clock import VirtualClock as JaxVirtualClock
from tpuserve.server import runner as jax_runner
from tpuserve.server.metrics import ServerMetrics as JaxMetrics
from tpuserve_torch.models.config import get_model_config
from tpuserve_torch.models.weights import params_from_numpy
from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SamplingParams
from tpuserve_torch.runtime import SchedulerConfig
from tpuserve_torch.runtime.clock import VirtualClock
from tpuserve_torch.server import runner as port_runner
from tpuserve_torch.server.metrics import CanaryMetrics, ServerMetrics

CACHE = dict(block_size=4, num_blocks=96, max_blocks_per_seq=16, dtype="float32")
SCHED = dict(max_num_seqs=8, min_prefill_bucket=8, min_decode_bucket=2)
ENGINE = dict(multi_step=8, min_multi_step=4, pipeline_decode=False, devprof=False)
SP = dict(max_tokens=20, temperature=0.0, ignore_eos=True)
# loop turn -> prompts submitted before it; turn 3 brings a late prompt
# (deadline already past), turns 2 and 4 arrive into a busy decode
ARRIVALS = {0: [[5, 6, 7, 8, 9, 10, 11, 12, 13], [40, 41, 42]],
            2: [[5, 6, 7, 8, 9, 10, 11, 12, 99]],
            3: [[70, 71, 72, 73]],
            4: [[200, 201, 202, 203, 204], [5, 6, 7, 8, 9, 10, 11, 12, 13]]}
LATE = 3


@pytest.fixture(scope="module")
def expositions():
    jcfg = dataclasses.replace(jax_get_model_config("tiny-qwen3"), dtype="float32")
    jparams = jax_weights.init_params(jcfg, seed=0)
    cfg = dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    torch.set_num_threads(2)
    port = Engine(EngineConfig(model="tiny-qwen3", cache=CacheConfig(**CACHE),
                               scheduler=SchedulerConfig(**SCHED), clock=VirtualClock(),
                               **ENGINE), params=params, model_cfg=cfg, device="cpu")
    jeng = jax_rt.Engine(jax_rt.EngineConfig(
        model="tiny-qwen3", cache=jax_rt.CacheConfig(**CACHE),
        scheduler=jax_rt.SchedulerConfig(**SCHED), attn_impl="reference",
        clock=JaxVirtualClock(), **ENGINE), params=jparams, model_cfg=jcfg)
    out = {}
    for name, eng, mod, metrics, params_cls in (
            ("port", port, port_runner, ServerMetrics("m"), SamplingParams),
            ("jax", jeng, jax_runner, JaxMetrics("m"), jax_rt.SamplingParams)):
        runner = mod.AsyncEngineRunner(eng, metrics)
        tokens = _drive(runner, mod, params_cls)
        out[name] = (metrics.render().decode(), tokens, eng.stats)
    return out


def _drive(runner, mod, params_cls) -> dict:
    """The runner's loop, one turn at a time on this thread; returns each
    request's tokens (or its exception)."""
    qs = []
    turn = 0
    while turn < 200:
        for ids in ARRIVALS.get(turn, ()):
            sub = mod._Submit(prompt=None, prompt_token_ids=ids, params=params_cls(**SP),
                              out_queue=queue.Queue(), rid_event=threading.Event(),
                              deadline=-1.0 if turn == LATE else None)
            runner._intake.put(sub)
            qs.append(sub)
        runner._drain_intake()
        if runner.engine.has_work():
            outputs = runner.engine.step()
            runner._drain_engine_errors()
            runner._route_outputs(outputs)
        elif turn > max(ARRIVALS):
            break
        runner._update_gauges()
        turn += 1
    tokens = {}
    for i, sub in enumerate(qs):
        toks = []
        while not sub.out_queue.empty():
            item = sub.out_queue.get()
            if isinstance(item, Exception):
                toks = type(item).__name__
            elif item is not None:
                toks += list(item.new_token_ids)
        tokens[i] = toks
    return tokens


def _families(text: str) -> dict:
    # prometheus_client adds a _created gauge per counter and histogram
    # (its creation time); the port renders no timestamps
    return {ln.split()[2]: ln.split()[3] for ln in text.splitlines()
            if ln.startswith("# TYPE ") and not ln.split()[2].endswith("_created")}


def _counter_samples(text: str) -> dict:
    kinds = _families(text)
    out = {}
    for ln in text.splitlines():
        if ln.startswith("#") or not ln.strip():
            continue
        series, value = ln.rsplit(" ", 1)
        name = series.split("{")[0]
        if kinds.get(name) == "counter":
            out[series] = float(value)
    return out


def test_the_run_is_the_same_run(expositions):
    (_, ptoks, pstats), (_, jtoks, jstats) = expositions["port"], expositions["jax"]
    assert ptoks == jtoks
    assert ptoks[3] == "TimeoutError"
    assert all(len(t) == SP["max_tokens"] for i, t in ptoks.items() if i != 3)
    assert pstats.latency_windows == jstats.latency_windows > 0


def test_the_family_names_and_types_are_the_jax_servers(expositions):
    ours, ref = _families(expositions["port"][0]), _families(expositions["jax"][0])
    assert ours == ref
    for name in ("tpuserve_window_overrun_tokens_total", "tpuserve_prefix_cache_hits_total",
                 "tpuserve_prefix_cache_queries_total", "tpuserve_latency_windows_total",
                 "tpuserve_step_padded_tokens", "tpuserve_step_actual_tokens",
                 "tpuserve_padded_tokens_total", "tpuserve_actual_tokens_total",
                 "tpuserve_mixed_steps_total", "tpuserve_requests_failed_total"):
        assert name in ours, name


@pytest.mark.parametrize("prefix", ["vllm_", "tpuserve_"])
def test_the_counter_values_are_the_jax_servers(expositions, prefix):
    ours = {k: v for k, v in _counter_samples(expositions["port"][0]).items()
            if k.startswith(prefix)}
    ref = {k: v for k, v in _counter_samples(expositions["jax"][0]).items()
           if k.startswith(prefix)}
    assert ours == ref
    if prefix == "tpuserve_":
        for name, low in (("tpuserve_latency_windows_total", 1),
                          ("tpuserve_requests_failed_total", 1),
                          ("tpuserve_prefix_cache_hits_total", 1),
                          ("tpuserve_window_overrun_tokens_total", 0)):
            assert ours[f'{name}{{model_name="m"}}'] >= low, name


def test_the_step_gauges_are_the_jax_servers(expositions):
    def gauges(text):
        return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                if ln.startswith(("tpuserve_step_", "vllm_kv_cache_usage_perc",
                                  "vllm_num_requests"))}
    assert gauges(expositions["port"][0]) == gauges(expositions["jax"][0])


def test_canary_metrics_render_the_jax_prober_families():
    from tpuserve.server.metrics import CanaryMetrics as JaxCanary
    ours, ref = CanaryMetrics(), JaxCanary()
    for m in (ours, ref):
        m.probes.labels(slo_class="interactive").inc()
        m.probe_latency.labels(slo_class="interactive").observe(0.07)
        m.breached.set(1)
    assert _families(ours.render().decode()) == _families(ref.render().decode())
    assert _counter_samples(ours.render().decode()) == _counter_samples(ref.render().decode())
