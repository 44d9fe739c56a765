#!/usr/bin/env python3
"""Where the split-K paged decode kernel's time goes, on one NVIDIA card.

    python3 tools/decode_split_study.py [--parent DIR]

Times ``tpuserve_torch``'s paged decode (bf16, Qwen3-0.6B's 16 query / 8 KV
heads, D=128, 64 pages of 32 keys a sequence) with ``chip_smoke.py``'s
cold-L2 method (a 256 MB overwrite, a spin, one call timed alone, the
median of 50), and prints one JSON line a study:

1. ladder     B=8 sequences of equal length, 0 to 2,048 keys: the launch
              floor, one partition's walk, the in-launch merge.
2. partitions the decode headline's shapes with the partition size forced
              to 4 to 32 partitions a sequence (64 to 512 keys).
3. variants   copies of the kernel built with another ring depth (3 or 4
              stages) or with the KV head as the grid's fastest dimension,
              in turns with the kernel as it is.
4. floors     torch's own cold read of the headline's bytes (a sum) and a
              tiny kernel, under the zero overwrite and under a read of
              256 MB instead (clean L2).
5. ragged     the ragged kernel at the mixed phase's profiled step (the
              engine's 64-row table, 8 decode rows of ~100 keys and a
              480-row chunk at context 0, T=512), and at its two halves
              alone, cold and warm (no overwrite, each call timed alone),
              with the decode part sized as the wrapper sizes it and sized
              for the 8 rows only; with ``--parent DIR`` (a copy of an
              earlier commit's tree, from before the ragged kernel took
              split-K scratch, an SM count and a decode-part size) that
              kernel too, in turns.

Needs one CUDA card and ``nvcc``; builds into ``build/decode_study/``.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from tpuserve_torch.ops import _build, attention  # noqa: E402
from tpuserve_torch.ops import paged_decode as pd  # noqa: E402

Hq, Hkv, D, PAGE, MP = 16, 8, 128, 32, 64
GRID = "dim3(a.k.splits, a.d.Hkv, a.B)"
BODY = "split_decode<QT, KVT, D, MAXG>(a.d, a.k, b, blockIdx.y, blockIdx.x, a.seq_lens[b], smem);"
# name: (ring stages, KV head fastest in the grid)
VARIANTS = {"as_is": (None, False), "kv_fastest": (None, True), "stages4": (4, False)}


def inputs(B: int, lens, seed: int = 1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = B * MP + 7
    q = torch.randn(B, Hq, D, generator=g, device="cuda").bfloat16()
    kc = torch.randn(nb, PAGE, Hkv, D, generator=g, device="cuda").bfloat16()
    vc = torch.randn(nb, PAGE, Hkv, D, generator=g, device="cuda").bfloat16()
    bt = torch.randperm(nb, generator=g, device="cuda")[:B * MP].reshape(B, MP)
    return q, kc, vc, bt.to(torch.int32).contiguous(), torch.tensor(lens, dtype=torch.int32,
                                                                      device="cuda")


def cold(fn) -> float:
    return cs.cuda_ms(fn, iters=50, warmup=5, cold=True)


def headline_lens():
    rng = np.random.default_rng(cs.SEED)      # as chip_smoke.py's phase_kernels draws them
    return sorted(rng.integers(1, 2049, 7).tolist()) + [2048]


def shapes() -> dict:
    return {"headline": (8, headline_lens()),
            "main": (8, [n + 32 for n in cs.MAIN_LENGTHS]),
            "b1": (1, [2048]),
            "edges": (8, [127, 128, 129, 255, 256, 257, 2047, 2048])}


def ladder() -> dict:
    q, kc, vc, bt, _ = inputs(8, [0] * 8)
    out = {}
    for n in (0, 1, 32, 64, 128, 129, 256, 512, 1024, 2048):
        sl = torch.full((8,), n, dtype=torch.int32, device="cuda")
        out[n] = {"ms": cold(lambda: pd.paged_decode_attention(q, kc, vc, bt, sl, D ** -0.5)),
                  "bound_ms": cs.bound(4 * Hq * D * 8 * n, 8 * n * 2 * Hkv * D * 2,
                                       "bfloat16")[0]}
    return out


def partitions() -> dict:
    out, rule = {}, pd.decode_splits
    try:
        for name, (B, lens) in shapes().items():
            x = inputs(B, lens)
            row = {"rule": rule(MP, PAGE, B, Hkv, pd.num_sms(x[0].device))}
            for splits in (4, 8, 16, 32):
                pd.decode_splits = lambda *a, s=splits: (s, MP // s)
                row[f"{splits}x{MP // splits}"] = cold(
                    lambda: pd.paged_decode_attention(*x, D ** -0.5))
            pd.decode_splits = rule
            row["as_rule"] = cold(lambda: pd.paged_decode_attention(*x, D ** -0.5))
            out[name] = row
    finally:
        pd.decode_splits = rule
    return out


def build_variants() -> dict:
    """One library a variant, from a patched copy of csrc/."""
    root = ROOT / "build" / "decode_study"
    procs = {}
    for name, (stages, kv_fastest) in VARIANTS.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        h, c = d / "paged_decode.cuh", d / "paged_decode.cu"
        if stages is not None:
            src, n = re.subn(r"constexpr int kDecStages = \d+;",
                             f"constexpr int kDecStages = {stages};", h.read_text())
            assert n == 1
            h.write_text(src)
        if kv_fastest:
            src = c.read_text()
            assert GRID in src and BODY in src
            c.write_text(src.replace(GRID, "dim3(a.d.Hkv, a.k.splits, a.B)").replace(
                BODY, BODY.replace("blockIdx.y, blockIdx.x", "blockIdx.x, blockIdx.y")))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(c)],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, p in procs.items():
        err = p.communicate()[1]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        fn = ctypes.CDLL(str(root / name / "lib.so")).paged_decode
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def launch(fn, q, kc, vc, bt, sl):
    B = q.shape[0]
    splits, pages = pd.decode_splits(MP, PAGE, B, Hkv, pd.num_sms(q.device))
    stream = torch.cuda.current_stream().cuda_stream
    part, counters = pd.workspace(q.device, stream,
                                  B * Hkv * splits * pd.split_stride(Hq // Hkv, D), B * Hkv)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), None, None, bt.data_ptr(),
            sl.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, Hq, Hkv, D,
            PAGE, MP, splits, pages, D ** -0.5, 0, 0.0, 1, 1, stream)
    if rc:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out


def variants() -> dict:
    libs = build_variants()
    out = {}
    for name, (B, lens) in shapes().items():
        x = inputs(B, lens)
        ref = attention.paged_decode_attention(*x, D ** -0.5)
        row = {}
        for order in (list(libs), list(libs)[::-1]):          # in turns
            for v in order:
                err = (launch(libs[v], *x).float() - ref.float()).abs().max().item()
                if err > 2e-2:
                    raise RuntimeError(f"variant {v} disagrees on {name}: {err}")
                row.setdefault(v, []).append(cold(lambda: launch(libs[v], *x)))
        out[name] = row
    return out


def floors() -> dict:
    lens = headline_lens()
    buf = torch.empty(sum(lens) * Hkv * D * 2, dtype=torch.bfloat16, device="cuda")
    tiny = torch.zeros(8, device="cuda")
    x = inputs(8, lens)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    out = {"headline_bytes": buf.numel() * 2}
    for kind in ("zero", "read"):
        for name, fn in (("torch_sum", lambda: buf.sum()), ("tiny_add", lambda: tiny.add_(1)),
                         ("paged_decode", lambda: pd.paged_decode_attention(*x, D ** -0.5))):
            for _ in range(5):
                fn()
            ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(50)]
            torch.cuda.synchronize()
            for s, e in ev:
                flush.sum() if kind == "read" else flush.zero_()
                torch.cuda._sleep(cs.COLD_SPIN_CYCLES)
                s.record()
                fn()
                e.record()
            torch.cuda.synchronize()
            out[f"{name} {kind}"] = statistics.median(s.elapsed_time(e) for s, e in ev)
    return out


def ragged_inputs(n_dec: int = 8, chunks=(480,)):
    """The mixed phase's profiled step: ``n_dec`` decode rows of ~100 keys
    and prompt chunks of ``chunks`` rows at context 0, in the engine's
    64-row table."""
    from tpuserve_torch.ops.ragged_paged import ragged_layout
    g = torch.Generator(device="cuda").manual_seed(3)
    B, chunks = 64, list(chunks)
    pad = B - n_dec - len(chunks)
    kv = [96 + i for i in range(n_dec)] + chunks + [0] * pad
    starts, T, meta, blk_seq = ragged_layout(n_dec, chunks, 32)
    q_starts = list(range(n_dec)) + starts + [T] * pad
    q_lens = [1] * n_dec + chunks + [0] * pad
    nb = B * MP + 7
    kc = torch.randn(nb, PAGE, Hkv, D, generator=g, device="cuda").bfloat16()
    vc = torch.randn(nb, PAGE, Hkv, D, generator=g, device="cuda").bfloat16()
    bt = torch.randperm(nb, generator=g, device="cuda")[:B * MP].reshape(B, MP)
    q = torch.randn(T, Hq, D, generator=g, device="cuda").bfloat16()
    desc = [torch.tensor(x, dtype=torch.int32, device="cuda")
            for x in (kv, q_starts, q_lens, meta, blk_seq)]
    return [q, kc, vc, bt.to(torch.int32).contiguous(), *desc]


def ragged(parent: Path | None) -> dict:
    return {name: ragged_shape(parent, *shape) for name, shape in (
        ("mixed_step", (8, (480,))), ("chunk_only", (0, (480,))), ("decode_only", (8, ())))}


def ragged_shape(parent: Path | None, n_dec: int, chunks) -> dict:
    from tpuserve_torch.ops import ragged_paged as rp
    x = ragged_inputs(n_dec, chunks)
    T = x[0].shape[0]
    runs = {"as_wrapper": lambda: rp.ragged_paged_attention(*x, D ** -0.5, 32)}
    rule = rp.ragged_decode_blocks
    sized = rule(8, Hkv, MP, PAGE, pd.num_sms(x[0].device))

    def eight_rows():
        rp.ragged_decode_blocks = lambda *a: sized
        try:
            return rp.ragged_paged_attention(*x, D ** -0.5, 32)
        finally:
            rp.ragged_decode_blocks = rule
    runs["decode_part_for_8_rows"] = eight_rows
    if parent is not None:
        src = parent / "tpuserve_torch" / "csrc" / "ragged_paged.cu"
        lib = ROOT / "build" / "decode_study" / "parent_ragged.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True)
        fn = ctypes.CDLL(str(lib)).ragged_paged
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def parent_run():
            out = torch.empty_like(x[0])
            rc = fn(*(t.data_ptr() for t in x[:3]), None, None,
                    *(t.data_ptr() for t in x[3:]), out.data_ptr(), T, Hq, Hkv, D, PAGE, MP,
                    32, D ** -0.5, 0, 0.0, 1, 1, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"parent launch failed: cudaError {rc}")
            return out
        runs["parent"] = parent_run
    ref = runs["as_wrapper"]()
    out = {"T": T, "decode_blocks": {"as_wrapper": rule(min(64, T), Hkv, MP, PAGE,
                                                      pd.num_sms(x[0].device)),
                                     "decode_part_for_8_rows": sized}}
    names = list(runs)
    for order in (names, names[::-1]):
        for name in order:
            err = (runs[name]().float() - ref.float()).abs().max().item()
            if err > 2e-2:
                raise RuntimeError(f"{name} disagrees: {err}")
            out.setdefault(f"{name} cold", []).append(cold(runs[name]))
            for _ in range(3):
                runs[name]()
            ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(50)]
            torch.cuda.synchronize()
            for s, e in ev:
                torch.cuda._sleep(cs.COLD_SPIN_CYCLES)
                s.record()
                runs[name]()
                e.record()
            torch.cuda.synchronize()
            out.setdefault(f"{name} warm", []).append(
                statistics.median(s.elapsed_time(e) for s, e in ev))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_split_study: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    parent = Path(sys.argv[2]) if len(sys.argv) == 3 and sys.argv[1] == "--parent" else None
    for name, study in (("ladder", ladder), ("partitions", partitions),
                        ("variants", variants), ("floors", floors),
                        ("ragged", lambda: ragged(parent))):
        print(json.dumps({"study": name, **{str(k): v for k, v in study().items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
