"""The fine-tuning step, the port of ``tpuserve/parallel/train.py``: a
causal-LM loss over the transformer's plain forward, with autograd, and
AdamW with global-norm clipping, equal to the JAX package's
``optax.chain(clip_by_global_norm, adamw)``.

On one device the step takes the whole parameter tree.  On ranks (a
:class:`TrainComm` from :func:`make_train_comm`) ``dp`` replicas each take
a slice of the batch and ``tp`` ranks each hold their Megatron slice of
the weights (``parallel/sharding.py`` ``shard_params``, the serving
rules); the transformer's sums become autograd functions:

- a row-parallel output (o_proj, down_proj, the vocabulary-parallel
  embedding and logits): summed over tp forward, its gradient passed as it
  is;
- a column-parallel input (q/k/v, gate/up, the logits' hidden rows): passed
  forward, its gradient summed over tp;
- the loss: its value summed over dp (each replica's part divided by the
  global mask count), its gradient passed, then every gradient summed
  over dp.

A replicated leaf applied to each head (the qk-norm scales) has its
gradient summed over tp too.  The global gradient norm counts a
tp-sharded leaf's squares summed over its tp group and a replicated
leaf's once.  Dense attention models only
on ranks (no MoE, no MLA).
"""

from __future__ import annotations

import dataclasses

import torch

from tpuserve_torch.models import transformer
from tpuserve_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    remat: bool = True     # rematerialise layer activations (memory for FLOPs)


# --------------------------------------------------------------------------
# Collectives under autograd
# --------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A float32 sum over ``group`` in ``x``'s dtype (as ``RankComm``)."""
    import torch.distributed as dist
    y = x.detach().float().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _SumForward(torch.autograd.Function):
    """Sum over the group forward, the gradient as it is backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """As it is forward, the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class TrainComm:
    """A training rank's collectives (``ModelConfig.comm`` while it
    trains): ``tp`` sums under autograd and the ``dp`` replicas' sums."""

    ep, ep_rank = 1, 0

    def __init__(self, tp: int = 1, tp_rank: int = 0, tp_group=None, dp: int = 1,
                 dp_rank: int = 0, dp_group=None):
        self.tp, self.tp_rank, self.tp_group = tp, tp_rank, tp_group
        self.dp, self.dp_rank, self.dp_group = dp, dp_rank, dp_group

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else _SumForward.apply(x, self.tp_group)

    def tp_enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else _SumBackward.apply(x, self.tp_group)

    def ep_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dp == 1 else _SumForward.apply(x, self.dp_group)


def make_train_comm(dp: int, tp: int) -> TrainComm:
    """This rank's :class:`TrainComm` on the joined process group of
    ``dp * tp`` ranks, rank ``d * tp + t`` at (d, t) (the JAX mesh's
    (dp, tp) order).  Every rank must call it: it makes the groups."""
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    if dp * tp != world:
        raise ValueError(f"dp={dp} x tp={tp} is not the group's {world} ranks")
    d, t = divmod(rank, tp)
    tp_group = dp_group = None
    for row in range(dp):
        g = dist.new_group([row * tp + c for c in range(tp)])
        if row == d:
            tp_group = g
    for col in range(tp):
        g = dist.new_group([r * tp + col for r in range(dp)])
        if col == t:
            dp_group = g
    return TrainComm(tp, t, tp_group, dp, d, dp_group)


def train_config(cfg: ModelConfig, comm: TrainComm | None) -> ModelConfig:
    """The config a training rank's forward runs: its heads and MLP columns
    (``sharding.rank_config``'s rule) and ``comm``."""
    if comm is None:
        return cfg
    if comm.tp > 1 and (cfg.num_experts or cfg.is_mla):
        raise ValueError("tensor-parallel training takes dense attention models only")
    tp = comm.tp
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.intermediate_size % tp:
        raise ValueError(f"{cfg.name}: heads or MLP columns do not split over tp={tp}")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp,
                               intermediate_size=cfg.intermediate_size // tp, comm=comm)


def shard_train_params(params: dict, comm: TrainComm) -> dict:
    """This rank's tp slice of a whole parameter tree (the serving rules,
    ``sharding.shard_tree``), made contiguous; the whole tree at tp 1."""
    import types
    from tpuserve_torch.parallel.sharding import shard_tree
    if comm.tp == 1:
        return params
    grid = types.SimpleNamespace(cfg=types.SimpleNamespace(tp=comm.tp, ep=1),
                                 tp_rank=comm.tp_rank, ep_rank=0)
    return shard_tree(params, grid)


# replicated leaves applied to each head (qk-norm scales): a tp rank's
# gradient of one holds its own heads' part only, so it is summed over tp
_HEAD_SHARED = ("q_norm.", "k_norm.")


def _tp_sharded(path: str) -> bool:
    from tpuserve_torch.parallel.mesh import AXIS_TP
    from tpuserve_torch.parallel.sharding import spec_for
    return AXIS_TP in spec_for(path)


# --------------------------------------------------------------------------
# The optimizer: optax.chain(clip_by_global_norm, adamw)
# --------------------------------------------------------------------------

class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(learning_rate,
    weight_decay=weight_decay))`` with optax's defaults (b1 0.9, b2 0.999,
    eps 1e-8, eps_root 0) and its arithmetic order: clip by
    ``(g / norm) * max_norm`` unless ``norm < max_norm``; moments
    ``(1 - b) * g^k + b * m`` in the parameter's dtype; bias-corrected by
    ``1 - b^count``; ``m / (sqrt(v) + eps)``, plus ``weight_decay * p``,
    times ``-learning_rate``, added to ``p``."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg

    def init(self, params: dict) -> dict:
        """The state: a step ``count`` and the first and second moments
        (zeros in each parameter's dtype), as optax's ``ScaleByAdamState``."""
        zeros = lambda t: torch.zeros_like(t)       # noqa: E731
        return {"count": 0, "mu": _map(zeros, params), "nu": _map(zeros, params)}

    def global_norm(self, grads: dict, comm: TrainComm | None = None) -> torch.Tensor:
        """The gradient's global norm (float32) over every rank's slice."""
        sharded = replicated = None
        for path, g in _leaves(grads):
            sq = g.float().square().sum()
            if comm is not None and comm.tp > 1 and _tp_sharded(path):
                sharded = sq if sharded is None else sharded + sq
            else:
                replicated = sq if replicated is None else replicated + sq
        total = replicated if replicated is not None else torch.zeros(())
        if sharded is not None:
            import torch.distributed as dist
            dist.all_reduce(sharded, group=comm.tp_group)
            total = total + sharded
        return total.sqrt()

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict,
               comm: TrainComm | None = None) -> None:
        """One step, in place: clip ``grads``, advance ``state`` and apply
        the update to ``params``."""
        cfg = self.cfg
        norm = self.global_norm(grads, comm)
        clip = not bool(norm < cfg.grad_clip)
        state["count"] += 1
        c = state["count"]
        b1c, b2c = 1 - self.b1 ** c, 1 - self.b2 ** c
        for (path, p), (_, g), (_, mu), (_, nu) in zip(
                _leaves(params), _leaves(grads), _leaves(state["mu"]), _leaves(state["nu"])):
            if clip:
                g = (g / norm.to(g.dtype)) * cfg.grad_clip
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g.square() + self.b2 * nu)
            upd = (mu / b1c) / ((nu / b2c).sqrt() + self.eps)
            if cfg.weight_decay:
                upd = upd + cfg.weight_decay * p
            p.add_((-cfg.learning_rate) * upd)


def make_optimizer(cfg: TrainConfig) -> AdamW:
    return AdamW(cfg)


def init_train_state(params: dict, train_cfg: TrainConfig) -> tuple:
    """(optimizer, its state) for ``params``."""
    opt = make_optimizer(train_cfg)
    return opt, opt.init(params)


# --------------------------------------------------------------------------
# The loss and the step
# --------------------------------------------------------------------------

def causal_lm_loss(params: dict, model_cfg: ModelConfig, tokens: torch.Tensor,
                   loss_mask: torch.Tensor, *, remat: bool = False) -> torch.Tensor:
    """Next-token cross entropy.  tokens: (B, T) int; loss_mask: (B, T)
    True where the *target* token (position t, predicted from t-1) counts.
    On dp replicas (``model_cfg.comm``) the mean is over every replica's
    targets and every replica gets it."""
    comm = model_cfg.comm
    logits = transformer.forward(params, model_cfg, tokens, remat=remat)   # (B, T, V)
    targets = tokens[:, 1:].long()
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    mask = loss_mask[:, 1:].float()
    count = mask.sum()
    if isinstance(comm, TrainComm) and comm.dp > 1:
        count = _all_reduce(count, comm.dp_group)
    loss = (nll * mask).sum() / torch.clamp(count, min=1.0)
    if isinstance(comm, TrainComm):
        loss = comm.dp_sum(loss)
    return loss


def train_step(params: dict, opt_state: dict, model_cfg: ModelConfig,
               train_cfg: TrainConfig, optimizer: AdamW, tokens: torch.Tensor,
               loss_mask: torch.Tensor) -> tuple:
    """One step, the JAX ``train_step``: the loss and its gradient (each
    layer rematerialised with ``train_cfg.remat``), the gradients summed
    over dp replicas, then the optimizer.  ``params`` and ``opt_state`` are
    updated in place (the JAX step donates them).  On ranks
    ``model_cfg.comm`` is the rank's :class:`TrainComm` (``train_config``).
    Returns (params, opt_state, loss)."""
    comm = model_cfg.comm if isinstance(model_cfg.comm, TrainComm) else None
    leaves = [t for _, t in _leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = causal_lm_loss(params, model_cfg, tokens, loss_mask, remat=train_cfg.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    if comm is not None:
        for (path, _t), g in zip(_leaves(params), grads):
            if comm.tp > 1 and any(k in path for k in _HEAD_SHARED):
                g.copy_(_all_reduce(g, comm.tp_group))
            if comm.dp > 1:
                g.copy_(_all_reduce(g, comm.dp_group))
    it = iter(grads)
    optimizer.update(_map(lambda _t: next(it), params), opt_state, params, comm)
    return params, opt_state, loss.detach()


def _leaves(tree, prefix: str = "") -> list:
    """(path, tensor) pairs in a fixed order, the paths of
    ``sharding.tree_paths`` (dict keys joined by ".", list indices out)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v, prefix)]
    return [] if tree is None else [(prefix, tree)]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)
