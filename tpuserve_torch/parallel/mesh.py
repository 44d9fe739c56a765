"""The rank grid: the port of ``tpuserve/parallel/mesh.py``.

The JAX package serves several devices from one process on a GSPMD mesh
(``--tp N``), or from several processes in lockstep (``--multihost``,
``parallel/multihost.py``).  PyTorch has no single-process SPMD over
several cards, so the port runs one process a card, in lockstep over
``torch.distributed``: the JAX package's multihost protocol with its GSPMD
path's sharding rules (``parallel/sharding.py``).

A :class:`RankMesh` is one process's view of the grid.  The axes keep the
JAX names (``dp``, ``ep``, ``pp``, ``tp``, in that grid order, so rank
``e * tp + t`` holds the device the JAX mesh puts at ``(0, e, 0, t)``);
the port serves ``ep`` x ``tp`` grids.  Each rank learns its coordinates,
its ``tp`` group (the ranks of its ``ep`` row) and its ``ep`` group (its
``tp`` column), and a gloo group over every rank that carries the lockstep
descriptors (``parallel/multihost.py``) whatever the backend of the
collectives.  ``dp`` is replicas (one server each, behind the gateway).
A ``pp`` grid is pure (no ``tp`` or ``ep`` beside it, as the JAX pipeline
engine asks) and on one node: rank ``s`` is stage ``s`` of the pipeline,
and its :class:`RankMesh` carries the stage's transport
(``parallel/pipeline.py`` ``PipeStage``) instead of collectives.

The backend is the caller's choice, never a silent switch: NCCL on
``cuda``, gloo on ``cpu``, and gloo on ``cuda`` only when asked (several
ranks sharing one card, which NCCL refuses; gloo cannot be captured in a
CUDA graph, so engines on it run eagerly).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import torch

AXIS_DP = "dp"
AXIS_EP = "ep"
AXIS_PP = "pp"
AXIS_TP = "tp"
# seconds a collective may wait before it raises: a dead or stuck rank
# stops the others with an error instead of a hang
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    tp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.ep * self.pp * self.tp


def default_backend(device_type: str) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def multihost_initialize(device_type: str = "cuda", backend: Optional[str] = None,
                         init_method: str = "env://", rank: Optional[int] = None,
                         world_size: Optional[int] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join ``torch.distributed`` from the torchrun-style environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
    ``init_method`` "env://"), or from an explicit ``init_method`` (a
    ``file://`` store, as the single-node launcher and the tests use) with
    ``rank`` and ``world_size``.  ``backend``: None for
    :func:`default_backend`; "gloo" on ``cuda`` must be asked for.  A no-op
    when the process has joined already."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    backend = backend or default_backend(device_type)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} not in ('nccl', 'gloo')")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("the nccl backend needs device_type='cuda'")
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


class RankComm:
    """A rank's collectives inside the transformer (``ModelConfig.comm``):
    sums over its ``tp`` and ``ep`` groups, only ``all_reduce``, so one code
    path runs on NCCL (captured in the step graphs) and on gloo (whose CUDA
    tensors support no ``all_gather``).  Sums run in float32 and return in
    the input's dtype; every rank gets the same bits (ring all-reduce)."""

    def __init__(self, tp: int, tp_rank: int, tp_group, ep: int, ep_rank: int, ep_group):
        self.tp, self.tp_rank, self.tp_group = tp, tp_rank, tp_group
        self.ep, self.ep_rank, self.ep_group = ep, ep_rank, ep_group
        # all-reduces issued, by group: read by the CPU tests and the card's
        # phase to hold the collectives a step runs against the layers
        self.calls = {"tp": 0, "ep": 0}

    def _sum(self, x: torch.Tensor, group, axis: str) -> torch.Tensor:
        import torch.distributed as dist
        y = x.float() if x.dtype != torch.float32 else x.clone()
        dist.all_reduce(y, group=group)
        self.calls[axis] += 1
        return y.to(x.dtype)

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else self._sum(x, self.tp_group, "tp")

    def tp_enter(self, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel product's replicated input: as it is (serving
        runs no backward pass; ``parallel/train.py`` sums its gradient)."""
        return x

    def ep_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.ep == 1 else self._sum(x, self.ep_group, "ep")


@dataclasses.dataclass
class RankMesh:
    """One process's place in the grid.  ``shape`` is the JAX ``Mesh.shape``
    counterpart (axis name -> size), so code written against the JAX mesh
    reads it the same way."""
    cfg: MeshConfig
    rank: int
    world: int
    device: torch.device
    backend: str
    comm: RankComm
    ctrl_group: object          # gloo, every rank: the lockstep descriptors
    multihost: bool = False     # joined from torchrun's environment (several nodes)
    timeout_s: float = DEFAULT_TIMEOUT_S    # its groups' collective timeout
    stage: Optional[object] = None          # a pp grid's pipeline.PipeStage
    # rank 0's lockstep channel, shared by every engine it leads on this
    # mesh (parallel/multihost.py)
    lockstep: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def shape(self) -> dict:
        c = self.cfg
        return {AXIS_DP: c.dp, AXIS_EP: c.ep, AXIS_PP: c.pp, AXIS_TP: c.tp}

    @property
    def tp_rank(self) -> int:
        return self.comm.tp_rank

    @property
    def ep_rank(self) -> int:
        return self.comm.ep_rank

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0


def _local_devices(device_type: str, world: int) -> list:
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * world


def make_mesh(cfg: MeshConfig | None = None, *, device_type: str = "cuda",
              devices: Optional[Sequence] = None, local_rank: Optional[int] = None,
              multihost: bool = False, timeout_s: float = DEFAULT_TIMEOUT_S) -> RankMesh:
    """This process's :class:`RankMesh` on the joined process group
    (:func:`multihost_initialize`).  Default: every rank on the ``tp`` axis.
    ``devices``: the devices of this node, by local rank (default: every
    card, ``cuda:<local rank>``; on the CPU, the CPU); a grid of more ranks
    than devices is refused, as the JAX ``make_mesh`` refuses a mesh of
    more devices than it has.  Ranks sharing one card pass it once a rank
    (gloo only).  ``local_rank``: default ``LOCAL_RANK``, else the rank.
    Every rank must call this, in the same order: it creates the groups."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a joined process group "
                           "(parallel.mesh.multihost_initialize)")
    rank, world = dist.get_rank(), dist.get_world_size()
    if cfg is None:
        cfg = MeshConfig(tp=world)
    if cfg.pp > 1 and (cfg.tp > 1 or cfg.ep > 1 or cfg.dp > 1):
        raise ValueError(f"the pipeline needs a pure ('pp',) mesh, got {cfg} "
                         "(tp-within-stage composition is future work: use tp OR pp)")
    if cfg.pp > 1 and multihost:
        raise ValueError("the pipeline runs on one node; multi-host serving uses the "
                         "lockstep tp path")
    if cfg.dp > 1:
        raise ValueError("data parallelism is one replica a server: run dp "
                         "servers behind the gateway (server/gateway.py)")
    if cfg.num_devices != world:
        raise ValueError(f"mesh {cfg} has {cfg.num_devices} ranks, the process "
                         f"group {world}")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    devs = list(devices) if devices is not None else _local_devices(device_type, world)
    ranks_here = world if not multihost else int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if ranks_here > len(devs):
        raise ValueError(f"mesh {cfg} needs {cfg.num_devices} devices, "
                         f"have {len(devs)}")
    device = torch.device(devs[local_rank])
    backend = dist.get_backend()
    if backend == "nccl" and device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if cfg.pp > 1:
        from tpuserve_torch.parallel.pipeline import PipeStage
        ctrl = dist.new_group(list(range(world)), backend="gloo", timeout=timeout)
        return RankMesh(cfg=cfg, rank=rank, world=world, device=device, backend=backend,
                        comm=RankComm(1, 0, None, 1, 0, None), ctrl_group=ctrl,
                        timeout_s=timeout_s,
                        stage=PipeStage(cfg.pp, rank, device, backend))
    e, t = divmod(rank, cfg.tp)
    tp_group = ep_group = None
    # every rank creates every group, rows then columns
    for row in range(cfg.ep):
        g = dist.new_group([row * cfg.tp + c for c in range(cfg.tp)], timeout=timeout)
        if row == e:
            tp_group = g
    for col in range(cfg.tp):
        g = dist.new_group([r * cfg.tp + col for r in range(cfg.ep)], timeout=timeout)
        if col == t:
            ep_group = g
    ctrl = dist.new_group(list(range(world)), backend="gloo", timeout=timeout)
    comm = RankComm(cfg.tp, t, tp_group, cfg.ep, e, ep_group)
    return RankMesh(cfg=cfg, rank=rank, world=world, device=device, backend=backend,
                    comm=comm, ctrl_group=ctrl, multihost=multihost, timeout_s=timeout_s)
