"""Context parallelism on the CPU: the port's ring and Ulysses attention
(``tpuserve_torch/parallel/ring_attention.py``) over 2 and 4 gloo ranks,
against the JAX package's ``ring_prefill_attention`` and
``ulysses_prefill_attention`` on its 8-device CPU mesh.

Each rank takes its shard of the same numpy-drawn (B, T, H, D) inputs
(``seq_shard``); the ranks' outputs, laid end to end, must match the JAX
functions' at rtol/atol 2e-5 on the valid rows (a short prompt leaves whole
shards of padding), with (Hq, Hkv) of (8, 8) and (8, 2).  bf16 inputs give
bf16 outputs, and both refusals (a sequence that does not split over the
ranks, query heads that do not split for Ulysses) are the JAX ones.  The
file is also the ranks' program (``python tests/test_torch_ring_attention.py
SPEC.json``), which imports no JAX.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpuserve_torch.parallel import multihost  # noqa: E402

B, T, D = 2, 16, 16
LENS = [16, 3]                      # the second prompt ends inside the first shard
HEADS = [(8, 8), (8, 2)]
SCALE = D ** -0.5
TIMEOUT_S = 180


def inputs(hq: int, hkv: int, dtype=np.float32) -> tuple:
    rng = np.random.default_rng(hq * 10 + hkv)
    q = rng.standard_normal((B, T, hq, D), dtype=np.float32)
    k = rng.standard_normal((B, T, hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, T, hkv, D), dtype=np.float32)
    return q, k, v, np.asarray(LENS, np.int32)


def _worker(spec_path: str) -> None:
    import torch.distributed as dist
    from tpuserve_torch.parallel.mesh import multihost_initialize
    from tpuserve_torch.parallel.ring_attention import (make_sp_group, ring_prefill_attention,
                                                        seq_shard, ulysses_prefill_attention)
    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    multihost_initialize("cpu", init_method=os.environ["TPUSERVE_INIT_METHOD"], timeout_s=120)
    group = make_sp_group()
    out = {}
    for hq, hkv in HEADS:
        q, k, v, lens = (torch.from_numpy(a) for a in inputs(hq, hkv))
        shard = [seq_shard(t, group).contiguous() for t in (q, k, v)]
        for name, fn in (("ring", ring_prefill_attention), ("ulysses", ulysses_prefill_attention)):
            out[f"{name}-{hq}-{hkv}"] = fn(*shard, lens, SCALE, group)
            bf = [t.to(torch.bfloat16) for t in shard]
            out[f"{name}-{hq}-{hkv}-bf16"] = fn(*bf, lens, SCALE, group)
    # the ring step a few heads at a time (3 of 8: a ragged last chunk)
    import tpuserve_torch.parallel.ring_attention as ra
    whole, ra.RING_SCORE_BYTES = ra.RING_SCORE_BYTES, 3 * B * (T // dist.get_world_size()) ** 2 * 4
    out["ring-8-2-chunked"] = ring_prefill_attention(*shard, lens, SCALE, group)
    ra.RING_SCORE_BYTES = whole
    # the refusals: 10 rows over the ranks, 6 query heads for Ulysses
    # (at sp 4; 2 ranks take 6 heads, so there 5)
    n = dist.get_world_size()
    for name, call in (("seq", lambda: seq_shard(torch.zeros(1, 10 if n == 4 else 9, 1, 1), group)),
                       ("heads", lambda: ulysses_prefill_attention(
                           torch.zeros(1, 2, 6 if n == 4 else 5, D), torch.zeros(1, 2, 1, D),
                           torch.zeros(1, 2, 1, D), torch.tensor([2]), SCALE, group))):
        try:
            call()
            out[f"refuse-{name}"] = None
        except ValueError as e:
            out[f"refuse-{name}"] = str(e)
    torch.save(out, spec["out"] + f".rank{dist.get_rank()}.pt")
    dist.destroy_process_group()


def spawn(tmp_path, sp: int) -> list:
    out = str(tmp_path / f"sp{sp}")
    spec = tmp_path / f"sp{sp}.json"
    spec.write_text(json.dumps({"out": out}))
    procs = multihost.spawn_ranks([None, __file__, str(spec)], sp, str(tmp_path / "logs"),
                                  f"file://{tmp_path}/store-{sp}", ranks=range(sp),
                                  extra_env={"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    rcs = multihost.stop_ranks(procs, TIMEOUT_S)
    logs = {r: (tmp_path / "logs" / f"rank{r}.log").read_text()[-3000:] for r in procs}
    assert all(rc == 0 for rc in rcs.values()), (rcs, logs)
    return [torch.load(f"{out}.rank{r}.pt") for r in range(sp)]


def jax_outputs(sp: int, hq: int, hkv: int) -> dict:
    import jax.numpy as jnp
    from tpuserve.parallel.ring_attention import (make_sp_mesh, ring_prefill_attention,
                                                  ulysses_prefill_attention)
    mesh = make_sp_mesh(sp)
    q, k, v, lens = (jnp.asarray(a) for a in inputs(hq, hkv))
    return {"ring": np.asarray(ring_prefill_attention(q, k, v, lens, SCALE, mesh)),
            "ulysses": np.asarray(ulysses_prefill_attention(q, k, v, lens, SCALE, mesh))}


def valid_rows(x: np.ndarray) -> list:
    return [x[b, :LENS[b]] for b in range(B)]


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_and_ulysses_match_jax(tmp_path, sp):
    """Both strategies at sp ranks, (8, 8) and GQA (8, 2) heads, against
    the JAX functions on valid rows; bf16 stays bf16 within the bf16 kernel
    gate of the float32 result; the refusals carry the JAX messages."""
    ranks = spawn(tmp_path, sp)
    for hq, hkv in HEADS:
        want = jax_outputs(sp, hq, hkv)
        for name in ("ring", "ulysses"):
            got = torch.cat([r[f"{name}-{hq}-{hkv}"] for r in ranks], dim=1)
            assert got.shape == (B, T, hq, D) and got.dtype == torch.float32
            for g, w in zip(valid_rows(got.numpy()), valid_rows(want[name])):
                np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=name)
            bf = torch.cat([r[f"{name}-{hq}-{hkv}-bf16"] for r in ranks], dim=1)
            assert bf.dtype == torch.bfloat16
            for g, w in zip(valid_rows(bf.float().numpy()), valid_rows(want[name])):
                np.testing.assert_allclose(g, w, rtol=2e-2, atol=3e-2, err_msg=f"{name} bf16")
    for r in ranks:
        assert torch.equal(r["ring-8-2-chunked"], r["ring-8-2"])
    seq = 10 if sp == 4 else 9
    heads = 6 if sp == 4 else 5
    for r in ranks:
        assert r["refuse-seq"] == f"seq len {seq} not divisible by sp={sp}"
        assert r["refuse-heads"] == f"{heads} query heads not divisible by sp={sp}"


def test_make_sp_group_refuses_more_ranks_than_the_group(tmp_path):
    import datetime
    import torch.distributed as dist
    from tpuserve_torch.parallel.ring_attention import make_sp_group
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="sp=2 exceeds 1 ranks"):
            make_sp_group(2)
        assert make_sp_group() is not None
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1])
