#!/usr/bin/env python3
"""What the port's sampler ops cost on one NVIDIA card, alone.

    python3 tools/sampler_probe.py

Times ``tpuserve_torch/ops/sampling.py``'s ops on Qwen3-0.6B's vocabulary
(151,936) for the main path's 8 rows and for the largest decode bucket
(64 rows), each call timed with CUDA events, the mean of 50 after 3 warm
calls: the keyed noise, the temperature sample, the full sample (the
stable sort, softmax, cumsum, the keep mask, the gather back; top_p 0.9,
top_k 50), the sort alone, the penalties from a count matrix, the count
update of one token a row, and the logprobs (``log_softmax`` and the top
20).  Each op is also captured in a CUDA graph on a private pool and
replayed: the replay must give the eager result bit for bit, and the
pool's bytes are printed.  One JSON line a batch size, then the card's
name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

V = 151_936
ITERS, WARM = 50, 3


def timed(fn) -> float:
    import torch
    for _ in range(WARM):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def captured(fn):
    """(replay equals eager, pool bytes) of ``fn`` captured alone."""
    import torch
    pool = torch.cuda.graph_pool_handle()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        got = fn()
    graph.replay()
    torch.cuda.synchronize()
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    same = all(torch.equal(a, b) for a, b in zip(want, got))
    return same, sum(seg["total_size"] for seg in torch.cuda.memory_snapshot(mempool_id=pool))


def probe(B: int) -> dict:
    import torch
    from tpuserve_torch.ops import sampling
    g = torch.Generator(device="cuda").manual_seed(B)
    logits = torch.randn(B, V, device="cuda", generator=g) * 3
    temp = torch.full((B,), 0.8, device="cuda")
    salt = torch.arange(B, dtype=torch.int32, device="cuda")
    step = torch.zeros(B, dtype=torch.int32, device="cuda")
    top_k = torch.full((B,), 50, dtype=torch.int32, device="cuda")
    top_p = torch.full((B,), 0.9, device="cuda")
    min_p = torch.zeros(B, device="cuda")
    counts = torch.zeros(B, V, device="cuda")
    counts[:, :64] = 1.0
    pen = [torch.full((B,), x, device="cuda") for x in (0.5, 0.3, 1.2)]
    tok = torch.randint(0, V, (B,), device="cuda", generator=g)
    ops = {
        "keyed_noise": lambda: sampling.keyed_gumbel(salt, step, V),
        "temperature_sample": lambda: sampling.sample_tokens(
            logits, temp, mode="temperature",
            gumbel=lambda: sampling.keyed_gumbel(salt, step, V)),
        "full_sample": lambda: sampling.sample_tokens(
            logits, temp, mode="full", gumbel=lambda: sampling.keyed_gumbel(salt, step, V),
            top_k=top_k, top_p=top_p, min_p=min_p),
        "sort": lambda: torch.sort(-logits, dim=-1, stable=True)[1],
        "penalties": lambda: sampling.penalize_from_counts(logits, counts, *pen),
        "count_update": lambda: counts.scatter_add_(
            1, tok.long()[:, None], torch.ones((B, 1), device="cuda")).sum(),
        "logprobs_top20": lambda: sampling.compute_logprobs(logits, tok, 20),
    }
    out = {"rows": B, "vocab": V}
    for name, fn in ops.items():
        same, pool = captured(fn) if name != "count_update" else (None, None)
        out[name] = {"ms": timed(fn), "replay_bit_equal": same, "pool_bytes": pool}
    return out


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("sampler_probe: no CUDA device", file=sys.stderr)
        return 2
    for B in (8, 64):
        print(json.dumps(probe(B)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
