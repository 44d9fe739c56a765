"""Megatron-style tensor and expert parallel slices of the transformer's
parameter tree: the port of ``tpuserve/parallel/sharding.py``.

The JAX package annotates the parameters once and lets GSPMD place them;
here each rank keeps only its slice (:func:`shard_params`), its config
counts its own heads, MLP columns and experts (:func:`rank_config`), and
``models/transformer.py`` sums the partial results where GSPMD inserted
the collectives (``parallel/mesh.py`` ``RankComm``).  The rules are the JAX
package's, keyed on the same paths (:func:`spec_for`):

- q/k/v, gate/up, fc1 and MLA's per-head ``q_b_proj`` / ``kv_b_proj``:
  column-parallel over ``tp`` (their bias and int8 per-output scale follow
  the columns);
- o_proj, down_proj, fc2: row-parallel over ``tp`` (bias and scale
  replicated, added after the sum);
- the embedding and ``lm_head``: vocabulary-parallel over ``tp``;
- stacked experts (E, in, out): split over ``ep``, with their (E, out)
  int8 scales; the router stays replicated;
- everything else (norms, qk-norm scales, position tables, MLA's
  a-projections, which make the shared latent): replicated.

The KV cache holds ``Hkv / tp`` heads a rank; MLA's one latent head is
replicated (:func:`cache_kv_heads`).  A KV migration's whole pages are cut
to a rank's heads and joined back in the order the k / v columns split
(:func:`cut_pages`, :func:`join_pages`; :func:`page_parts` slices).  ``tpuserve/parallel/compat.py`` is a
jax-version shim with no counterpart here.

Attention needs no collective under tp: a rank holds ``Hq / tp`` query and
``Hkv / tp`` kv heads, and the transformer calls the four kernels on them
as they are.  Under a ``pp`` grid a rank keeps its stage's layers whole,
and stage 0 the embedding, norms and head (``parallel/pipeline.py``).
``tpuserve/ops/pallas_tp.py`` wraps each Pallas kernel in a
``shard_map`` over those local heads; its counterpart here is
:func:`tp_partitionable` and :func:`check_partitionable`'s refusal, with
no wrapper: the rank's config already gives the kernels its local shapes.
"""

from __future__ import annotations

import dataclasses

import torch

from tpuserve_torch.models.config import ModelConfig
from tpuserve_torch.parallel.mesh import AXIS_EP, AXIS_TP, RankMesh
from tpuserve_torch.parallel.pipeline import stage_config, stage_layers, stage_params

_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "fc1",
           # MLA per-head up-projections: outputs are heads x width, so they
           # shard like q/k/v (the a-projections make the SHARED latent and
           # stay replicated)
           "q_b_proj", "kv_b_proj")
_ROW = ("o_proj", "down_proj", "fc2")


def spec_for(path: str) -> tuple:
    """The partition of one leaf, keyed on its path (the JAX ``_spec_for``):
    a tuple with an axis name or None a dimension, () when replicated."""
    # MoE stacked experts first: their paths contain gate_proj / up_proj too
    if "experts." in path:
        if path.endswith("kernel"):
            return (AXIS_EP, None, None)
        if path.endswith("scale"):          # int8 (E, out) scales follow experts
            return (AXIS_EP, None)
        return ()
    if any(k in path for k in _COLUMN):
        if path.endswith("kernel"):
            return (None, AXIS_TP)
        if path.endswith("bias") or path.endswith("scale"):
            return (AXIS_TP,)
    if any(k in path for k in _ROW):
        if path.endswith("kernel"):
            return (AXIS_TP, None)
        return ()
    if path.startswith("embed.") or path.startswith("lm_head."):
        if path.endswith("weight"):
            return (AXIS_TP, None)          # embed.weight: (V, H)
        if path.endswith("kernel"):
            return (None, AXIS_TP)          # lm_head.kernel: (H, V)
        if path.endswith("scale"):
            return (AXIS_TP,)               # int8 per-vocabulary-row scale
    return ()


def tree_paths(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of a parameter tree, the JAX ``_tree_paths``
    strings: dict keys joined by ".", list indices left out."""
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out += tree_paths(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out += tree_paths(v, prefix)
    elif tree is not None:
        out.append((prefix, tree))
    return out


def slice_leaf(x, spec: tuple, mesh: RankMesh):
    """This rank's block of ``x`` under ``spec`` (a view; equal blocks, as
    GSPMD's even shardings)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = (mesh.cfg.tp, mesh.tp_rank) if axis == AXIS_TP else (mesh.cfg.ep, mesh.ep_rank)
        if n == 1:
            continue
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"a dimension of {size} does not split over {axis}={n}")
        x = x.narrow(dim, i * (size // n), size // n)
    return x


def shard_tree(tree, mesh: RankMesh, prefix: str = ""):
    """``tree`` (a whole parameter tree, or one layer's with ``prefix``
    "layers") with each leaf cut to this rank's slice, made contiguous."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, mesh, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, mesh, prefix) for v in tree)
    if tree is None:
        return None
    return slice_leaf(tree, spec_for(prefix), mesh).contiguous()


def shard_params(params: dict, cfg: ModelConfig, mesh: RankMesh) -> dict:
    """This rank's slice of every leaf of ``params`` (the JAX
    ``shard_params`` places the whole tree; a rank keeps its block), or
    under pp its stage's part.  A dimension that does not split evenly
    raises; whether the slices make a servable rank (whole kv heads) is
    :func:`rank_config`'s check."""
    if mesh.cfg.pp > 1:
        return stage_params(params, cfg, mesh.cfg.pp, mesh.rank)
    return shard_tree(params, mesh)


class RankSlicer:
    """A rank's slicer of parameter leaves by path, for the weights' loader
    and init (``models/weights.py`` ``load_or_init(shard=...)``): ``(path,
    tensor)`` -> the rank's block (a view), ``experts(E)`` the stacked
    experts it holds, ``layer`` / ``tree`` a made layer or the top-level
    leaves cut.  ``top_only``: slice only the leaves outside ``layers``
    (layers then come whole to a ``layer_fn`` that cuts them itself).
    Under pp, ``layer`` keeps the layers of the rank's stage (counting the
    layers it is given, in order; the others give None) and ``tree`` drops
    the rest, and the head off every stage but the first."""

    def __init__(self, mesh: RankMesh, top_only: bool = False, num_layers: int = 0):
        self.mesh, self.top_only = mesh, top_only
        # the tp degree of a layer leaf as this slicer reads it
        self.tp = 1 if top_only else mesh.cfg.tp
        self.pp = mesh.cfg.pp
        # the stage's layer indices under pp (None without), and whether
        # it holds the embedding, final norm and head (stage 0)
        self.held = (stage_layers(num_layers, self.pp, mesh.rank) if self.pp > 1
                     else None)
        self.holds_head = self.pp == 1 or mesh.rank == 0
        self._seen = 0

    def __call__(self, path: str, x):
        if self.top_only and path.startswith("layers."):
            return x
        return slice_leaf(x, spec_for(path), self.mesh)

    def experts(self, E: int) -> range:
        n, i = self.mesh.cfg.ep, self.mesh.ep_rank
        if self.top_only or n == 1:
            return range(E)
        return range(i * (E // n), (i + 1) * (E // n))

    def layer(self, lp: dict):
        if self.held is not None:
            self._seen += 1
            return lp if self._seen - 1 in self.held else None
        return shard_tree(lp, self.mesh, "layers")

    def tree(self, params: dict, skip_layers: bool = False) -> dict:
        if self.held is not None:
            layers = [lp for lp in params["layers"] if lp is not None]
            return {**params, "layers": layers} if self.holds_head else {"layers": layers}
        return {k: (v if skip_layers and k == "layers" else shard_tree(v, self.mesh, k))
                for k, v in params.items()}

    def top_level(self) -> "RankSlicer":
        return RankSlicer(self.mesh, top_only=True)


def tp_partitionable(cfg_kv_heads: int, mesh) -> bool:
    """Heads must split evenly over tp for the head-parallel decomposition."""
    if mesh is None:
        return False
    tp = mesh.shape.get(AXIS_TP, 1)
    return tp > 1 and cfg_kv_heads % tp == 0


def check_partitionable(cfg: ModelConfig, mesh: RankMesh) -> None:
    """Refuse a grid the model's heads or experts do not split over."""
    tp, ep = mesh.cfg.tp, mesh.cfg.ep
    if tp > 1 and not cfg.is_mla and not tp_partitionable(cfg.num_kv_heads, mesh):
        raise ValueError(f"{cfg.num_kv_heads} kv heads do not split over tp={tp}: "
                         "the head-parallel kernels need whole kv heads a rank")
    if tp > 1 and cfg.num_heads % tp:
        raise ValueError(f"{cfg.num_heads} heads do not split over tp={tp}")
    if ep > 1 and (not cfg.num_experts or cfg.num_experts % ep):
        raise ValueError(f"{cfg.num_experts} experts do not split over ep={ep}")


def rank_config(cfg: ModelConfig, mesh: RankMesh) -> ModelConfig:
    """The config a rank's transformer runs: its own q and kv heads, MLP
    columns and experts, the full vocabulary (its logits are gathered), and
    ``comm``, its collectives; under pp its stage's layers and ``stage``."""
    if mesh.cfg.pp > 1:
        return stage_config(cfg, mesh.stage)
    check_partitionable(cfg, mesh)
    tp, ep = mesh.cfg.tp, mesh.cfg.ep
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp,
        # pinned: a fallback to intermediate_size would follow its split
        moe_intermediate_size=cfg.expert_intermediate_size if cfg.num_experts else
        cfg.moe_intermediate_size,
        num_experts=cfg.num_experts // ep if cfg.num_experts else 0,
        comm=mesh.comm)


def draft_rank_config(cfg: ModelConfig, mesh: RankMesh) -> ModelConfig:
    """A speculative draft's rank config: as a target's (a draft whose heads
    do not split over tp is refused as a target's are), but a dense draft
    beside an MoE target on an ep grid keeps its MLP whole, as the dense
    layers of a model on that grid do (its leaves split over tp alone)."""
    if mesh.cfg.ep > 1 and not cfg.num_experts:
        tp = mesh.cfg.tp
        check_partitionable(cfg, dataclasses.replace(mesh, cfg=dataclasses.replace(
            mesh.cfg, ep=1)))
        return dataclasses.replace(
            cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
            intermediate_size=cfg.intermediate_size // tp, comm=mesh.comm)
    return rank_config(cfg, mesh)


def cache_kv_heads(cfg: ModelConfig, mesh: RankMesh) -> int:
    """KV heads a rank's cache holds: ``Hkv / tp``; MLA's single latent
    head is replicated."""
    return 1 if cfg.is_mla else cfg.num_kv_heads // mesh.cfg.tp


def page_parts(cfg: ModelConfig, mesh) -> int:
    """Into how many head slices the ranks' KV pages cut one card's: ``tp``,
    or 1 where every rank's cache holds them whole (no mesh, pure ep, MLA's
    latent: :func:`cache_kv_heads`)."""
    if mesh is None or cfg.is_mla:
        return 1
    return mesh.cfg.tp


def cut_pages(seq_kv: list, parts: int, index: int) -> list:
    """Slice ``index`` of ``parts`` of whole pages (per layer ``{key: (blocks,
    page, Hkv, width)}``, an int8 cache's ``(blocks, page, Hkv)`` scale pages
    too): each array's heads narrowed to the ones tp rank ``index`` holds,
    in the order :func:`slice_leaf` gives ``k_proj`` / ``v_proj`` their
    columns (rank t the t-th block of heads).  One part is the identity."""
    if parts == 1:
        return seq_kv
    out = []
    for layer in seq_kv:
        cut = {}
        for key, x in layer.items():
            heads = x.shape[2]
            if heads % parts:
                raise ValueError(f"{heads} kv heads of {key!r} pages do not split "
                                 f"over tp={parts}")
            cut[key] = x.narrow(2, index * (heads // parts), heads // parts)
        out.append(cut)
    return out


def join_pages(slices: list) -> list:
    """Whole pages from the tp ranks' slices, in rank order (the inverse of
    :func:`cut_pages`); one slice (a replicated cache) is the whole."""
    if len(slices) == 1:
        return slices[0]
    return [{key: torch.cat([s[i][key] for s in slices], dim=2) for key in layer}
            for i, layer in enumerate(slices[0])]
