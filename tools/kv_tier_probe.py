#!/usr/bin/env python3
"""Where the tiered KV cache's copies spend their time, on one CUDA card.

    python3 tools/kv_tier_probe.py [--blocks N]

A cache of Qwen3-0.6B's KV layout (28 layers, k and v pages of 32 tokens x
8 heads x 128, bf16: 3,670,016 bytes a block) with random pages, and the
port's own copies (``tpuserve_torch.runtime.kv_cache``,
``runtime/kv_tiers.py``) on N blocks (default 96, a 3,072-token prefix):

- pin: N host records pinned fresh (what a demote pays past the records
  warmup pinned), then the gather into records torch's host allocator
  hands back (what a demote pays after warmup);
- gather / scatter: the batched copy card -> host (one host wait) and
  host -> card (timed to a synchronise), each the median of 5;
- spill: ``TieredPageStore.put`` with a 1-byte host budget (the encode to
  pageable numpy on the calling thread), the writer thread's files
  (``flush``), the files' bytes read raw, ``take`` back (``np.load`` and
  the decode) with the writer idle, then with the writer busy on N other
  blocks, and the packing of spilled pages into pinned records;
- every read back bit-equal to what was written.

Prints one JSON line of readings, the card's name and power limit, and
exits non-zero if a check failed or there is no card.  Writes nothing
outside ``build/`` (the spill directory, removed at the end).
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

LAYERS, PAGE, HEADS, DIM = 28, 32, 8, 128


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kv_tier_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tpuserve_torch.runtime.kv_cache import (PageStaging, gather_block_pages,
                                                 scatter_block_pages)
    from tpuserve_torch.runtime.kv_tiers import TieredPageStore
    n = 96
    if len(sys.argv) == 3 and sys.argv[1] == "--blocks":
        n = int(sys.argv[2])
    elif len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(0)
    nb = 4 * n
    cache = [{k: torch.randn((nb, PAGE, HEADS, DIM), generator=g, device="cuda").to(torch.bfloat16)
              for k in ("k", "v")} for _ in range(LAYERS)]
    st = PageStaging(cache, 32)
    rec_bytes = n * st.record_bytes
    blocks = list(range(0, 2 * n, 2))
    dest = list(range(2 * n, 3 * n))
    out = {"blocks": n, "record_bytes": st.record_bytes, "bytes": rec_bytes}
    ok = True

    def pages_equal(a, b) -> bool:
        return all(torch.equal(x[k].view(torch.uint8), y[k].view(torch.uint8))
                   for pa, pb in zip(a, b) for x, y in zip(pa, pb) for k in x)

    # warm the staging and the index copies
    scatter_block_pages(cache, [0] * 32, gather_block_pages(cache, [0] * 32, st), st)
    torch.cuda.synchronize()
    t = time.perf_counter()
    st.pin_records(n)
    pin_s = time.perf_counter() - t
    out["pin_fresh_ms"] = pin_s * 1e3
    out["pin_fresh_GBps"] = n * 4 * (1 << 20) / pin_s / 1e9     # 4 MiB a record
    gathers, scatters = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pages = gather_block_pages(cache, blocks, st)
        gathers.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        t = time.perf_counter()
        scatter_block_pages(cache, dest, pages, st)
        torch.cuda.synchronize()
        scatters.append(time.perf_counter() - t)
    g_s, s_s = statistics.median(gathers), statistics.median(scatters)
    out.update({"gather_ms": g_s * 1e3, "gather_GBps": rec_bytes / g_s / 1e9,
                "gather_first_ms": gathers[0] * 1e3,
                "scatter_ms": s_s * 1e3, "scatter_GBps": rec_bytes / s_s / 1e9})
    ref = gather_block_pages(cache, blocks, st)
    ok &= pages_equal(gather_block_pages(cache, dest, st), ref)

    spill = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build", "kv_tier_probe_spill")
    shutil.rmtree(spill, ignore_errors=True)
    try:
        store = TieredPageStore(host_bytes=1, spill_dir=spill)
        t = time.perf_counter()
        for i, p in enumerate(ref):
            store.put(i, p)
        put_s = time.perf_counter() - t
        t = time.perf_counter()
        store.flush()
        flush_s = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(n):
            with open(store._spill_path(i), "rb") as f:
                f.read()
        read_s = time.perf_counter() - t
        t = time.perf_counter()
        back = [store.take(i) for i in range(n)]
        take_s = time.perf_counter() - t
        ok &= all(b is not None for b in back) and pages_equal(back, ref)
        t = time.perf_counter()
        recs = [st.record_of(p) for p in back]
        pack_s = time.perf_counter() - t
        del recs
        # the writer busy: N blocks spilling while N others are read back
        for i, p in enumerate(ref):
            store.put(i, p)
        store.flush()
        t = time.perf_counter()
        for i, p in enumerate(ref):
            store.put(n + i, p)
        put2_s = time.perf_counter() - t
        t = time.perf_counter()
        back2 = [store.take(i) for i in range(n)]
        take_busy_s = time.perf_counter() - t
        store.flush()
        ok &= all(b is not None for b in back2) and pages_equal(back2, ref)
        ok &= store.writer_tensor_pages == 0
        out.update({"spill_put_ms_per_block": put_s / n * 1e3,
                    "spill_write_ms_per_block": (put_s + flush_s) / n * 1e3,
                    "spill_file_read_ms_per_block": read_s / n * 1e3,
                    "spill_take_ms_per_block": take_s / n * 1e3,
                    "spill_take_writer_busy_ms_per_block": take_busy_s / n * 1e3,
                    "spill_put_writer_busy_ms_per_block": put2_s / n * 1e3,
                    "spill_pack_ms_per_block": pack_s / n * 1e3})
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    out["ok"] = bool(ok)
    print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
