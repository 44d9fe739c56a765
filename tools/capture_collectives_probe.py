#!/usr/bin/env python3
"""Probe, on one NVIDIA GPU, the two card facts the multi-GPU slice rests on.

    python3 tools/capture_collectives_probe.py [--out build/probe.json]

1. Captures beside other threads' work (F7).  Thread B replays a captured
   graph on its own stream in a loop, with a host read after each replay
   (as an engine's loop thread flushes a window), while thread A captures
   graphs into its own pool on its own stream.  Run with
   ``capture_error_mode`` "global" (PyTorch's default) and "thread_local".
   Reported: capture errors, B's errors, B's replays that ran during A's
   captures, whether B's results stayed equal to its first replay, whether
   A's graphs replay to their eager results, and whether a capture into
   the pool of a failed one raises ``already recording``.
2. torch.distributed on the one card: four processes over gloo, each on
   ``cuda:0``, time ``all_reduce`` (float32 and bf16) and ``broadcast`` of
   CUDA tensors at a decode row's and a prefill batch's hidden sizes; and
   whether NCCL accepts two ranks on one device.

Prints one JSON object.  Needs a card; exits 2 without one.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import tempfile
import threading
import time


def _work(torch, x, w, n: int):
    for _ in range(n):
        x = torch.tanh(x @ w)
    return x


def capture_probe(mode: str) -> dict:
    import torch
    dev = torch.device("cuda", 0)
    w = torch.randn(1024, 1024, device=dev) / 32
    xb = torch.randn(256, 1024, device=dev)
    sb = torch.cuda.Stream(dev)
    with torch.cuda.stream(sb):
        _work(torch, xb, w, 2)
    torch.cuda.synchronize()
    gb = torch.cuda.CUDAGraph()
    with torch.cuda.graph(gb, stream=sb):
        outb = _work(torch, xb, w, 50)
    gb.replay()
    torch.cuda.synchronize()
    ref = outb.clone()
    stop, capturing = threading.Event(), threading.Event()
    st = {"replays": 0, "replays_during_capture": 0, "replay_errors": [], "mismatches": 0}

    def replayer():
        torch.cuda.set_device(dev)
        with torch.cuda.stream(sb):
            while not stop.is_set():
                try:
                    gb.replay()
                    during = capturing.is_set()
                    if not torch.equal(outb, ref):      # a host read: waits on sb
                        st["mismatches"] += 1
                    st["replays"] += 1
                    st["replays_during_capture"] += during
                except Exception as e:      # the probe records what the card refuses
                    st["replay_errors"].append(f"{type(e).__name__}: {str(e)[:160]}")
                    break

    t = threading.Thread(target=replayer, daemon=True)
    t.start()
    time.sleep(0.2)
    pool, sa = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
    xa = torch.randn(256, 1024, device=dev)
    graphs, cap_errors, cap_s = [], [], []
    for _ in range(4):
        g = torch.cuda.CUDAGraph()
        sa.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(sa):
            _work(torch, xa, w, 2)
        torch.cuda.current_stream(dev).wait_stream(sa)
        t0 = time.perf_counter()
        capturing.set()
        try:
            with torch.cuda.graph(g, pool=pool, stream=sa, capture_error_mode=mode):
                out = _work(torch, xa, w, 400)
            graphs.append((g, out))
            cap_s.append(time.perf_counter() - t0)
        except Exception as e:      # the probe records what the card refuses
            cap_errors.append(f"{type(e).__name__}: {str(e)[:160]}")
        finally:
            capturing.clear()
        time.sleep(0.05)
    stop.set()
    t.join(60)
    torch.cuda.synchronize()
    eager = _work(torch, xa, w, 400)
    replay_ok = []
    for g, out in graphs:
        g.replay()
        torch.cuda.synchronize()
        replay_ok.append(bool(torch.allclose(out, eager, atol=1e-4, rtol=1e-4)))
    return {"mode": mode, "captures_ok": len(graphs), "capture_errors": cap_errors,
            "capture_s": cap_s, "captured_graphs_replay_equal": replay_ok, **st}


def worker(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    dev = torch.device("cuda", 0)
    res = {}
    for name, shape in (("decode_8x8192", (8, 8192)), ("prefill_2048x8192", (2048, 8192))):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.full(shape, float(rank + 1), dtype=dt, device=dev)
            dist.all_reduce(x)
            torch.cuda.synchronize()
            ok = bool((x == sum(range(1, world + 1))).all())
            n = 20 if shape[0] <= 8 else 4
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(n):
                dist.all_reduce(x)
            torch.cuda.synchronize()
            res[f"all_reduce_{name}_{str(dt)[6:]}_ms"] = (time.perf_counter() - t0) * 1e3 / n
            res[f"all_reduce_{name}_{str(dt)[6:]}_ok"] = ok
    y = torch.arange(1 << 16, dtype=torch.int32, device=dev) * (rank == 0)
    dist.broadcast(y, 0)
    torch.cuda.synchronize()
    res["broadcast_ok"] = bool((y == torch.arange(1 << 16, device=dev)).all())
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


def nccl_worker(rank: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=30))
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        res = {"ok": True, "value": x.tolist()}
        dist.destroy_process_group()
    except Exception as e:      # the probe records what NCCL refuses
        res = {"ok": False, "error": f"{type(e).__name__}: {str(e)[:200]}"}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


def spawn(args_of, n: int, timeout: float) -> list:
    with tempfile.TemporaryDirectory() as d:
        logs = [open(os.path.join(d, f"r{i}.log"), "w") for i in range(n)]
        procs = [subprocess.Popen([sys.executable, __file__, *args_of(i)], stdout=logs[i],
                                  stderr=subprocess.STDOUT) for i in range(n)]
        rcs = []
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        tails = [open(os.path.join(d, f"r{i}.log")).read()[-400:] for i in range(n)]
    return [rcs, tails]


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--gloo":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "--nccl":
        nccl_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out_path = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv else None
    res = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    res["nvidia_smi"] = smi.stdout.strip()
    res["capture"] = [capture_probe("thread_local"), capture_probe("global")]
    with tempfile.TemporaryDirectory() as d:
        store, out = os.path.join(d, "store"), os.path.join(d, "gloo.json")
        t0 = time.perf_counter()
        res["gloo_spawn"] = spawn(lambda i: ["--gloo", str(i), "4", store, out], 4, 300)
        res["gloo_s"] = time.perf_counter() - t0
        res["gloo"] = json.load(open(out)) if os.path.exists(out) else None
        store2, out2 = os.path.join(d, "store2"), os.path.join(d, "nccl.json")
        res["nccl_spawn"] = spawn(lambda i: ["--nccl", str(i), store2, out2], 2, 90)
        res["nccl_two_ranks_one_card"] = json.load(open(out2)) if os.path.exists(out2) else None
    text = json.dumps(res)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
