#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpuserve_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, run in order, each printing one JSON line; any failure exits
non-zero:

1. build     compile the CUDA kernels from ``tpuserve_torch/csrc``.
2. kernels   hold each kernel against its plain PyTorch version at the main
             path's shapes (flash prefill: the main path's B=8 x 1024
             batch of 128-1024-token prompts; paged decode: B=8, 32-token
             pages, 64 pages a sequence), at further shapes, and in a
             sliding-window/softcap case, with times:
             the kernel, the plain version, the least time the card could
             take (``bound_ms``) and, for prefill, one
             ``scaled_dot_product_attention`` call as a yardstick only.
3. identity  Qwen3-0.6B at full width, 2 layers, float32: the engine on the
             CUDA kernels and the engine on the plain attention give the
             same greedy tokens.
4. main      the main path: a default engine (Qwen3-0.6B, 28 layers, bf16,
             random weights from the seed) serves 8 prompts of 128-1024
             tokens through ``add_request``/``step``, then one sampled
             request; both kernels' launch counts must match the layers
             times the dispatches, and the first step's bf16 logits must
             agree with the plain attention path's (max |diff| at most
             LOGIT_DIFF_MAX, top-1 agreement at least 0.75).

Then the kernel report, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``.  Needs one CUDA card; exits non-zero
with no result without one, or without the ``tpuserve_torch`` package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

PHASES = ("build", "kernels", "identity", "main")
# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): bf16 tensor cores, float32 CUDA cores, HBM.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"float32": dict(atol=1e-4, rtol=0.0), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
SEED = 0
# The main path's prompt lengths: one prefill batch of B=8 x T=1024.
MAIN_LENGTHS = [128, 256, 384, 512, 640, 768, 896, 1024]
# bf16 first-step logits, kernel path against plain path, over 28 layers:
# 0.0625 on an H100, where |logit| reaches 3.34 (four bf16 steps of
# 0.0156 at 2-4); the gate is twice that.
LOGIT_DIFF_MAX = 0.125


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2, cold: bool = False) -> float:
    """Mean ms of one ``fn()`` on the card.  ``cold``: overwrite a buffer
    larger than the 50 MB L2 before each call and time each call alone, as
    a decode step finds each layer's cache pages."""
    import torch
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters if cold else 1)]
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda") if cold else None
    torch.cuda.synchronize()
    if cold:
        for start, end in events:
            flush.zero_()
            start.record()
            fn()
            end.record()
    else:
        events[0][0].record()
        for _ in range(iters):
            fn()
        events[0][1].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def compare(out, ref, dtype: str) -> tuple[float, bool]:
    import torch
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
        out.float(), ref.float(), **TOL[dtype])
    return err, ok


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def flash_case(dtype: str, B: int, T: int, Hq: int, Hkv: int, D: int, lens,
               window=None, softcap=None, timed=True) -> dict:
    import torch
    import torch.nn.functional as F
    from tpuserve_torch.ops import attention, flash_prefill
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(B, T, Hq, D, generator=g, device="cuda").to(tdt)
    k = torch.randn(B, T, Hkv, D, generator=g, device="cuda").to(tdt)
    v = torch.randn(B, T, Hkv, D, generator=g, device="cuda").to(tdt)
    plens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    # padding keys past each prompt hold NaN, as a fresh buffer may
    for b, n in enumerate(lens):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    scale = D ** -0.5
    kw = dict(sliding_window=window, logit_softcap=softcap)
    out = flash_prefill.flash_prefill_attention(q, k, v, plens, scale, **kw)
    ref = attention.prefill_attention(q, k, v, plens, scale, **kw)
    torch.cuda.synchronize()
    errs, oks = [], []
    for b, n in enumerate(lens):                      # valid rows only
        e, ok = compare(out[b, :n], ref[b, :n], dtype)
        errs.append(e)
        oks.append(ok)
    pairs = sum(n * (n + 1) // 2 if window is None else
                sum(min(i + 1, window) for i in range(n)) for n in lens)
    res = {"case": f"flash_prefill {dtype} B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} "
                   f"lens={list(lens)} window={window} softcap={softcap}",
           "max_abs_err": max(errs), "tol": TOL[dtype], "ok": all(oks)}
    if timed:
        res["ms"] = cuda_ms(lambda: flash_prefill.flash_prefill_attention(
            q, k, v, plens, scale, **kw))
        res["plain_ms"] = cuda_ms(lambda: attention.prefill_attention(
            q, k, v, plens, scale, **kw), iters=3, warmup=1)
        # the bytes this data needs: each prompt's q, k, v and out rows once
        rows = sum(lens) * (2 * Hq + 2 * Hkv) * D * q.element_size()
        res["bound_ms"], res["bound_by"] = bound(
            2 * 2 * Hq * D * pairs, rows + nbytes(plens), dtype)
        # yardstick only: one dense causal SDPA call over the padded batch
        qd, kd, vd = (x.transpose(1, 2) for x in (q, k.nan_to_num(), v.nan_to_num()))
        kd = kd.repeat_interleave(Hq // Hkv, dim=1)
        vd = vd.repeat_interleave(Hq // Hkv, dim=1)
        res["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, is_causal=True, scale=scale))
    return res


def paged_case(dtype: str, B: int, Hq: int, Hkv: int, D: int, page: int,
               max_pages: int, lens, int8=False, window=None, softcap=None,
               timed=True) -> dict:
    import torch
    from tpuserve_torch.ops import attention, paged_decode
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    nb = B * max_pages + 7
    q = torch.randn(B, Hq, D, generator=g, device="cuda").to(tdt)
    kf = torch.randn(nb, page, Hkv, D, generator=g, device="cuda")
    vf = torch.randn(nb, page, Hkv, D, generator=g, device="cuda")
    perm = torch.randperm(nb, generator=g, device="cuda")[:B * max_pages]
    bt = perm.reshape(B, max_pages).to(torch.int32).contiguous()
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ks = vs = None
    if int8:
        kc, ks = attention.quantize_kv(kf)
        vc, vs = attention.quantize_kv(vf)
    else:
        kc, vc = kf.to(tdt), vf.to(tdt)
        # slots past each sequence's end hold NaN, as a fresh cache may
        for b, n in enumerate(lens):
            for t in range(n, min(max_pages * page, n + 2 * page)):
                blk, off = int(bt[b, t // page]), t % page
                kc[blk, off] = float("nan")
                vc[blk, off] = float("nan")
    scale = D ** -0.5
    kw = dict(k_scale=ks, v_scale=vs, sliding_window=window, logit_softcap=softcap)
    out = paged_decode.paged_decode_attention(q, kc, vc, bt, sl, scale, **kw)
    ref = attention.paged_decode_attention(q, kc, vc, bt, sl, scale, **kw)
    torch.cuda.synchronize()
    err, ok = compare(out, ref, dtype)
    kv_name = "int8" if int8 else dtype
    res = {"case": f"paged_decode q={dtype} kv={kv_name} B={B} Hq={Hq} Hkv={Hkv} D={D} "
                   f"page={page} max_pages={max_pages} max_len={max(lens)} "
                   f"window={window} softcap={softcap}",
           "max_abs_err": err, "tol": TOL[dtype], "ok": ok}
    if timed:
        res["ms"] = cuda_ms(lambda: paged_decode.paged_decode_attention(
            q, kc, vc, bt, sl, scale, **kw), iters=50, warmup=5, cold=True)
        res["plain_ms"] = cuda_ms(lambda: attention.paged_decode_attention(
            q, kc, vc, bt, sl, scale, **kw), iters=5, warmup=1, cold=True)
        attended = sum(n if window is None else min(n, window) for n in lens)
        row = Hkv * D * kc.element_size() + (Hkv * 4 if int8 else 0)
        res["bound_ms"], res["bound_by"] = bound(
            2 * 2 * Hq * D * attended,
            2 * attended * row + nbytes(q, out, bt, sl), dtype)
        res["library_ms"] = None
    return res


def phase_kernels() -> dict:
    rng = np.random.default_rng(SEED)
    lens_p = [1024, 777, 512, 129]
    lens_d = sorted(rng.integers(1, 2049, 7).tolist()) + [2048]
    # the first case of each kernel is its headline in the report
    cases = {
        "flash_prefill": [
            flash_case("bfloat16", 8, 1024, 16, 8, 128, MAIN_LENGTHS),
            flash_case("bfloat16", 4, 1024, 16, 8, 128, lens_p),
            flash_case("float32", 4, 1024, 16, 8, 128, lens_p),
            flash_case("float32", 2, 256, 8, 4, 64, [256, 200], window=64,
                       softcap=30.0, timed=False),
            flash_case("bfloat16", 2, 96, 4, 1, 256, [96, 50], timed=False),
            flash_case("bfloat16", 2, 200, 8, 2, 64, [200, 150], window=70,
                       softcap=30.0, timed=False),
        ],
        "paged_decode": [
            paged_case("bfloat16", 8, 16, 8, 128, 32, 64, lens_d),
            paged_case("float32", 8, 16, 8, 128, 32, 64, lens_d),
            paged_case("bfloat16", 8, 16, 8, 128, 32, 64, lens_d, int8=True),
            paged_case("float32", 4, 8, 2, 64, 16, 16, [256, 200, 17, 0],
                       window=100, softcap=30.0, timed=False),
            paged_case("float32", 3, 8, 1, 256, 16, 8, [128, 77, 1],
                       timed=False),
        ],
    }
    for name, rs in cases.items():
        for r in rs:
            emit({"phase": "kernels", "kernel": name, **r})
    ok = all(r["ok"] for rs in cases.values() for r in rs)
    return {"ok": ok, "headline": {n: rs[0] for n, rs in cases.items()}}


# --------------------------------------------------------------------------
# phases 3 and 4: the engine
# --------------------------------------------------------------------------

def prompts(rng, lengths, vocab):
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


def phase_identity() -> dict:
    import torch
    from tpuserve_torch.models.config import get_model_config
    from tpuserve_torch.models.weights import init_params
    from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig,
                                        SamplingParams)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_model_config("Qwen/Qwen3-0.6B"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, SEED, "cuda")
    ps = prompts(np.random.default_rng(SEED + 2), [37, 64, 100, 150], cfg.vocab_size)
    sp = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    streams = {}
    for impl in ("cuda", "reference"):
        eng = Engine(EngineConfig(attn_impl=impl, multi_step=8,
                                  cache=CacheConfig(num_blocks=256, dtype="float32")),
                     params=params, model_cfg=cfg, device="cuda")
        streams[impl] = [r.output_token_ids for r in eng.generate(ps, sp)]
        del eng
    ok = (streams["cuda"] == streams["reference"]
          and all(len(s) == 32 for s in streams["cuda"]))
    return {"ok": ok, "prompts": len(ps), "tokens_each": 32,
            "identical": streams["cuda"] == streams["reference"]}


def phase_main() -> dict:
    import torch
    from tpuserve_torch.models import transformer
    from tpuserve_torch.ops import flash_prefill, paged_decode
    from tpuserve_torch.ops.attention import PAD_SLOT
    from tpuserve_torch.runtime import Engine, EngineConfig, SamplingParams
    from tpuserve_torch.runtime.kv_cache import create_kv_cache

    t0 = time.perf_counter()
    eng = Engine(EngineConfig(seed=SEED))            # Qwen/Qwen3-0.6B, cuda
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = eng.model_cfg
    lengths = MAIN_LENGTHS
    ps = prompts(np.random.default_rng(SEED + 3), lengths, cfg.vocab_size)
    greedy = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
    sampled = SamplingParams(max_tokens=64, temperature=0.8, seed=1, ignore_eos=True)

    flash_prefill.LAUNCHES = 0
    paged_decode.LAUNCHES = 0
    rids = [eng.add_request(prompt_token_ids=p, params=greedy) for p in ps]
    t_prefill = t_decode = 0.0
    decode_tokens = 0
    while eng.has_work():
        n_prefill = eng.stats.num_prefill_steps
        t = time.perf_counter()
        outs = eng.step()
        dt = time.perf_counter() - t                 # every step ends in a host read
        if eng.stats.num_prefill_steps > n_prefill:
            t_prefill += dt
        else:
            t_decode += dt
            decode_tokens += sum(len(o.new_token_ids) for o in outs)
    reqs = [eng.requests.pop(r) for r in rids]
    ttft_ms = 1e3 * eng.stats.ttft_sum / eng.stats.ttft_count
    sampled_req = eng.generate([ps[0]], sampled)[0]
    launches = {"flash_prefill": flash_prefill.LAUNCHES,
                "paged_decode": paged_decode.LAUNCHES}
    L = cfg.num_layers
    steps = {"prefill_steps": eng.stats.num_prefill_steps,
             "decode_steps": eng.stats.num_decode_steps}
    want = {"flash_prefill": L * steps["prefill_steps"],
            "paged_decode": L * steps["decode_steps"]}
    finished = all(r.finished and len(r.output_token_ids) == 64
                   for r in reqs + [sampled_req])

    # first step against the reference path: prefill logits, both impls
    B, T = 8, 1024
    tokens = torch.zeros(B, T, dtype=torch.int32, device="cuda")
    slots = torch.full((B, T), PAD_SLOT, dtype=torch.int32, device="cuda")
    for i, p in enumerate(ps):
        tokens[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
        slots[i, :len(p)] = torch.arange(i * 1024, i * 1024 + len(p), dtype=torch.int32)
    plens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    logits = {}
    for impl in ("cuda", "reference"):
        cache = create_kv_cache(cfg, dataclasses.replace(eng.cache_cfg, num_blocks=B * 32),
                                "cuda")
        logits[impl], _ = transformer.prefill(eng.params, cfg, tokens, plens, slots,
                                              cache, attn_impl=impl)
        del cache
    diff = (logits["cuda"] - logits["reference"]).abs().max().item()
    top1 = (logits["cuda"].argmax(-1) == logits["reference"].argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(logits["cuda"]).all())
    max_logit = logits["reference"].abs().max().item()
    # bf16 argmax on random weights is path-sensitive: most rows, not all
    ok = (finished and finite and diff <= LOGIT_DIFF_MAX and top1 >= 0.75
          and launches == want and all(v > 0 for v in launches.values()))
    profile = profile_window(eng, ps, SamplingParams)
    return {"ok": ok, "model": cfg.name, "layers": L, "dtype": cfg.dtype,
            "requests": len(reqs) + 1, "finished_with_tokens": finished,
            "engine_init_s": init_s, "prefill_s": t_prefill,
            "decode_s": t_decode, "decode_tokens": decode_tokens,
            "decode_tok_per_s": decode_tokens / t_decode if t_decode else None,
            "mean_ttft_ms": ttft_ms, "multi_step": eng._multi_step, **steps,
            "launches": launches, "launches_expected": want,
            "first_step_max_logit_diff": diff,
            "first_step_logit_diff_max_allowed": LOGIT_DIFF_MAX,
            "first_step_max_abs_logit": max_logit,
            "first_step_top1_agreement": top1,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "profile": profile}


def profile_window(eng, ps, SamplingParams) -> dict:
    """Where the time goes: the 8 prompts again (one prefill and one
    32-token window) under torch.profiler, after the counted run.  Device
    busy time is the sum of kernel self times; the rest of the wall time
    the card sits idle waiting for the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    params = SamplingParams(max_tokens=1 + eng._multi_step, temperature=0.0,
                            ignore_eos=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.generate(ps, params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        return {"device_busy_ms": "not measured", "wall_ms": wall_ms}
    busy = sum(ms for _, ms, _ in kernels)

    def share(pred):
        return sum(ms for k, ms, _ in kernels if pred(k.lower())) / busy

    kernels.sort(key=lambda x: -x[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms,
            "share_flash_prefill": share(lambda k: "flash_prefill" in k),
            "share_paged_decode": share(lambda k: "paged_decode" in k),
            "share_gemm": share(lambda k: any(w in k for w in (
                "gemm", "cutlass", "xmma", "nvjet")) or k.startswith("sm90")),
            "kernel_launches": sum(c for _, _, c in kernels),
            "top": [{"name": k[:90], "ms": ms, "count": c} for k, ms, c in kernels[:8]]}


# --------------------------------------------------------------------------

KERNELS = {
    "flash_prefill": dict(source="tpuserve_torch/csrc/flash_prefill.cu",
                          replaces="tpuserve/ops/pallas_flash_attention.py:173"),
    "paged_decode": dict(source="tpuserve_torch/csrc/paged_decode.cu",
                         replaces="tpuserve/ops/pallas_paged_attention.py:420"),
}


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from tpuserve_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the tpuserve_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    results = {}
    t_all = time.perf_counter()
    for phase in PHASES:
        t = time.perf_counter()
        if phase == "build":
            res = {"ok": True, "build_s": _build.build()}
        elif phase == "kernels":
            res = phase_kernels()
        elif phase == "identity":
            res = phase_identity()
        elif phase == "main":
            res = phase_main()
        else:
            raise SystemExit(f"unknown phase {phase!r}")
        res["seconds"] = time.perf_counter() - t
        results[phase] = res
        emit({"phase": phase, **{k: v for k, v in res.items() if k != "headline"}})
        if not res["ok"]:
            print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
            return 1
    report = []
    for name, meta in KERNELS.items():
        h = results["kernels"]["headline"][name]
        report.append({"name": name, "route": "cuda", **meta,
                       "launches": results["main"]["launches"][name],
                       "max_abs_err": h["max_abs_err"], "ms": h["ms"],
                       "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                       "bound_by": h["bound_by"], "library_ms": h["library_ms"]})
    emit({"kernels": report})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_all:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
