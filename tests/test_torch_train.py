"""The fine-tuning step on the CPU: the port's ``parallel/train.py`` (the
transformer's differentiable ``forward``, the causal-LM loss, AdamW with
global-norm clipping) against the JAX package's ``train_step`` on
``fp32_tiny_qwen3`` weights (``params_from_numpy`` of the JAX init).

One rank: the loss before and after the step, every updated parameter and
both optimizer moments at atol 1e-5, and leaf by leaf the update (p1 - p0)
and both moments relative to the leaf's norm (``REL``), with ``remat`` on
and off and with a ``grad_clip`` small enough to bind.  dp 2 x tp 2 gloo ranks (spawned
through ``multihost.spawn_ranks``, a ``file://`` store under ``tmp_path``):
each rank's parameter and moment slices equal the same slices of the JAX
step on the whole batch, and the loss falls, as ``tests/test_parallel.py``
asks.  The file is also the ranks' program (``python
tests/test_torch_train.py SPEC.json``), which imports no JAX.
"""

import dataclasses
import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpuserve_torch.models.config import get_model_config  # noqa: E402
from tpuserve_torch.parallel import multihost  # noqa: E402
from tpuserve_torch.parallel import train  # noqa: E402

# the JAX TrainConfig's learning rate: Adam's first step moves a weight by
# about the learning rate whatever its gradient, and by any fraction of it
# where the gradient is near eps (1e-8), where float32 sums decide the
# fraction; at 1e-5 every parameter still holds to atol 1e-5
LR = 1e-5
# leaf by leaf ||ours - theirs|| / ||theirs||, of the update (p1 - p0) and
# of both moments: Adam's first step moves nearly every weight by the
# learning rate, so atol 1e-5 on the weights and moments cannot tell a
# gradient that is missing or partial (an error of order 1 here); the
# worst readings are 3.4e-3 for the update (a q_proj leaf: gradients near
# eps, where g / (|g| + eps) turns on float32 sums) and 1.7e-6 for the
# moments
REL = {"update": 1e-2, "mu": 1e-4, "nu": 1e-4}
# (remat, grad_clip): the unclipped and the clipped step
CASES = {"remat-unclipped": (True, 1e6), "plain-clipped": (False, 0.05)}
TIMEOUT_S = 180


def batch() -> tuple:
    """(4, 8) tokens and a loss mask with some targets left out."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 100, (4, 8)).astype(np.int32)
    mask = np.ones((4, 8), bool)
    mask[0, :3] = False
    mask[3, 5:] = False
    return tokens, mask


def port_cfg():
    return dataclasses.replace(get_model_config("tiny-qwen3"), dtype="float32")


def port_step(params, cfg, tokens, mask, remat: bool, clip: float) -> dict:
    """loss0, the step's loss, loss1, the updated tree and the moments."""
    tcfg = train.TrainConfig(learning_rate=LR, grad_clip=clip, remat=remat)
    before = train._map(torch.clone, params)
    opt, state = train.init_train_state(params, tcfg)
    with torch.no_grad():
        loss0 = train.causal_lm_loss(params, cfg, tokens, mask)
    params, state, loss = train.train_step(params, state, cfg, tcfg, opt, tokens, mask)
    with torch.no_grad():
        loss1 = train.causal_lm_loss(params, cfg, tokens, mask)
    return {"loss0": float(loss0), "loss": float(loss), "loss1": float(loss1),
            "before": before, "params": params, "mu": state["mu"], "nu": state["nu"],
            "count": state["count"]}


def _worker(spec_path: str) -> None:
    import torch.distributed as dist
    from tpuserve_torch.models.weights import init_params
    from tpuserve_torch.parallel.mesh import multihost_initialize
    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    multihost_initialize("cpu", init_method=os.environ["TPUSERVE_INIT_METHOD"], timeout_s=120)
    comm = train.make_train_comm(spec["dp"], spec["tp"])
    cfg = train.train_config(port_cfg(), comm)
    tokens, mask = batch()
    rows = slice(comm.dp_rank * 2, comm.dp_rank * 2 + 2)
    out = {"dp_rank": comm.dp_rank, "tp_rank": comm.tp_rank}
    for name, (remat, clip) in CASES.items():
        params = train.shard_train_params(init_params(port_cfg(), 0, "cpu"), comm)
        out[name] = port_step(params, cfg, torch.from_numpy(tokens[rows]),
                              torch.from_numpy(mask[rows]), remat, clip)
    torch.save(out, spec["out"] + f".rank{dist.get_rank()}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The JAX reference
# ---------------------------------------------------------------------------

def jax_step(jcfg, remat: bool, clip: float) -> dict:
    import jax
    import jax.numpy as jnp
    from tpuserve.models.weights import init_params as jax_init
    from tpuserve.parallel.train import TrainConfig, causal_lm_loss, init_train_state, train_step
    params = jax_init(jcfg, seed=0)
    before = jax.tree.map(np.asarray, params)
    tcfg = TrainConfig(learning_rate=LR, grad_clip=clip, remat=remat)
    opt, state = init_train_state(params, tcfg)
    tokens, mask = (jnp.asarray(a) for a in batch())
    loss0 = causal_lm_loss(params, jcfg, tokens, mask)
    params, state, loss = train_step(params, state, jcfg, tcfg, opt, tokens, mask)
    loss1 = causal_lm_loss(params, jcfg, tokens, mask)
    adam = next(s for s in jax.tree_util.tree_leaves(state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))
    return {"before": before, "loss0": float(loss0), "loss": float(loss),
            "loss1": float(loss1), "params": jax.tree.map(np.asarray, params),
            "mu": jax.tree.map(np.asarray, adam.mu), "nu": jax.tree.map(np.asarray, adam.nu),
            "count": int(adam.count)}


def pairs(ours, theirs, prefix=""):
    """(path, our leaf, their leaf), walking our tree's keys."""
    if isinstance(ours, dict):
        for k, v in ours.items():
            yield from pairs(v, theirs[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(ours, (list, tuple)):
        for a, b in zip(ours, theirs, strict=True):
            yield from pairs(a, b, prefix)
    else:
        yield prefix, ours, theirs


def rank_slice(x: np.ndarray, path: str, tp: int, tp_rank: int) -> np.ndarray:
    from tpuserve_torch.parallel.sharding import slice_leaf, spec_for
    grid = types.SimpleNamespace(cfg=types.SimpleNamespace(tp=tp, ep=1), tp_rank=tp_rank,
                                 ep_rank=0)
    return slice_leaf(torch.from_numpy(np.array(x)), spec_for(path), grid).numpy()


def leaves(got: dict, want: dict, tree: str, tp: int, tp_rank: int) -> list:
    """(path, our leaf, their leaf cut to the rank's slice), float64."""
    return [(path, a.double().numpy(), rank_slice(b, path, tp, tp_rank).astype(np.float64))
            for path, a, b in pairs(got[tree], want[tree])]


def rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check(got: dict, want: dict, tp: int = 1, tp_rank: int = 0) -> None:
    for key in ("loss0", "loss", "loss1"):
        assert abs(got[key] - want[key]) <= 1e-5, (key, got[key], want[key])
    assert got["loss1"] < got["loss0"]
    assert got["count"] == want["count"] == 1
    trees = {t: leaves(got, want, t, tp, tp_rank) for t in ("before", "params", "mu", "nu")}
    for tree in ("params", "mu", "nu"):
        for path, a, b in trees[tree]:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f"{tree} {path}")
        assert len(trees[tree]) == len(train._leaves(got["params"]))
    for (path, a1, b1), (_, a0, b0) in zip(trees["params"], trees["before"], strict=True):
        assert rel(a1 - a0, b1 - b0) <= REL["update"], ("update", path, rel(a1 - a0, b1 - b0))
    for tree in ("mu", "nu"):
        for path, a, b in trees[tree]:
            assert rel(a, b) <= REL[tree], (tree, path, rel(a, b))


@pytest.fixture(scope="module")
def references(fp32_tiny_qwen3):
    return {name: jax_step(fp32_tiny_qwen3, remat, clip)
            for name, (remat, clip) in CASES.items()}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_step_matches_jax(references, case, remat):
    """The step on one device, remat on and off, unclipped and clipped
    (the clip binds: the gradient's norm is past it)."""
    from tpuserve_torch.models.weights import params_from_numpy
    want = references[case]
    clip = CASES[case][1]
    params = params_from_numpy(want["before"], port_cfg(), "cpu")
    tokens, mask = (torch.from_numpy(a) for a in batch())
    got = port_step(params, port_cfg(), tokens, mask, remat, clip)
    check(got, want)
    # the clipped case's gradient norm is past its clip, the other's not
    fresh = params_from_numpy(want["before"], port_cfg(), "cpu")
    leaves = [t.requires_grad_(True) for _, t in train._leaves(fresh)]
    loss = train.causal_lm_loss(fresh, port_cfg(), tokens, mask)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    norm = train.AdamW(train.TrainConfig()).global_norm(train._map(lambda _t: next(it), fresh))
    assert (float(norm) > clip) == (case == "plain-clipped")


def test_dp2_tp2_ranks_match_jax(tmp_path, references):
    """dp 2 x tp 2 gloo ranks: each rank's slices of the updated
    parameters and moments, and the global losses, equal the JAX step's on
    the whole batch (one device), in both cases."""
    out = str(tmp_path / "train")
    spec = tmp_path / "train.json"
    spec.write_text(json.dumps({"dp": 2, "tp": 2, "out": out}))
    procs = multihost.spawn_ranks([None, __file__, str(spec)], 4, str(tmp_path / "logs"),
                                  f"file://{tmp_path}/store", ranks=range(4),
                                  extra_env={"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    rcs = multihost.stop_ranks(procs, TIMEOUT_S)
    logs = {r: (tmp_path / "logs" / f"rank{r}.log").read_text()[-3000:] for r in procs}
    assert all(rc == 0 for rc in rcs.values()), (rcs, logs)
    for r in range(4):
        res = torch.load(f"{out}.rank{r}.pt", weights_only=False)
        assert (res["dp_rank"], res["tp_rank"]) == divmod(r, 2)
        for name in CASES:
            check(res[name], references[name], tp=2, tp_rank=res["tp_rank"])


def test_tp_training_refuses_moe_and_mla():
    comm = train.TrainComm(tp=2)
    for name in ("tiny-moe", "tiny-deepseek"):
        with pytest.raises(ValueError, match="dense attention models only"):
            train.train_config(get_model_config(name), comm)
    assert train.train_config(port_cfg(), None) == port_cfg()


if __name__ == "__main__":
    _worker(sys.argv[1])
