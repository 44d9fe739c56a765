"""Pipeline parallelism: the port of ``tpuserve/parallel/pipeline.py``.

The JAX package runs the whole pipeline as one SPMD program: layers and KV
cache stage-stacked over the ``pp`` mesh axis, a scan over ``M + S - 1``
ticks moving activations with ``ppermute``, bubble ticks computing on
garbage with their cache writes masked.  PyTorch has no single-process
SPMD over several cards, so here a stage is a process (``parallel/mesh.py``,
one process a card): stage ``s`` is rank ``s`` and holds its ``L / S``
layers' weights and KV pages; rank 0 also holds the embedding, the final
norm and the head, and samples.

Each step executable (``runtime/graphs.py``) runs on every stage with the
same inputs (rank 0 sends them through the lockstep,
``parallel/multihost.py``).  The transformer's trunks call
:meth:`PipeStage.trunk` with a stage's config (:func:`stage_config`): the
batch is cut into ``M`` microbatches; for each, stage 0 embeds and the
others receive the previous stage's hidden rows, run their layers on the
microbatch's rows (the port's trunks: B1 for prefill and B2 for decode on
the card), and send them on; the last stage sends its final hidden rows
(a prefill keeps each row's last position first) back to rank 0, which
unembeds and samples.  Sends are asynchronous and every receive is posted
in one order, so the stages overlap microbatches as the JAX ticks do.
Bubble ticks do not exist: a stage runs only the microbatches it holds, so
nothing is masked and nothing is written for padding.  A decode window is
a full pipeline pass an iteration, as the JAX ``pp_decode_multi`` scan.

Transport: NCCL sends CUDA tensors, and a stage's steps are captured in
CUDA graphs as every step on the card is (each rank captures the same key
at the same time, so its sends and receives replay in one order on every
rank); gloo sends host tensors, so ranks sharing one card over gloo stage
their activations through host memory and run eagerly.

Uniform-layer dense models only, as in the JAX package
(:func:`check_pipeline_compatible`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch

from tpuserve_torch.models.config import ModelConfig

AXIS_PP = "pp"


def check_pipeline_compatible(cfg: ModelConfig, pp: int) -> None:
    """Raise ValueError unless ``cfg`` can be cut into ``pp`` stages."""
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    if cfg.num_layers % pp:
        raise ValueError(f"{cfg.name}: num_layers={cfg.num_layers} not divisible by "
                         f"pp={pp}")
    windows = {cfg.layer_window(i) for i in range(cfg.num_layers)}
    ropes = {cfg.layer_rope(i) for i in range(cfg.num_layers)}
    if len(windows) > 1 or len(ropes) > 1:
        raise ValueError(
            f"{cfg.name}: per-layer attention windows/rope vary across layers "
            f"(windows={windows}); the pipeline trunk scans a stacked uniform layer — "
            "use tp/ep for this family")
    if cfg.num_experts:
        raise ValueError(f"{cfg.name}: MoE + pipeline is not supported (shard experts "
                         "over the ep axis instead)")


def auto_microbatches(B: int, S: int) -> int:
    """Largest divisor of the batch not exceeding the stage count (the JAX
    ``_auto_microbatches``): a pp 3 grid serves power-of-two buckets with
    fewer microbatches."""
    return max(d for d in range(1, min(S, B) + 1) if B % d == 0)


def stage_layers(num_layers: int, pp: int, stage: int) -> range:
    """The whole model's layer indices stage ``stage`` holds."""
    k = num_layers // pp
    return range(stage * k, (stage + 1) * k)


class PipeStage:
    """One rank's place in the pipeline: its stage index, its neighbours and
    the activation transport (``group``: the point-to-point group, None for
    the default one; stage ``s`` is rank ``s`` of it).  ``counts``: the
    microbatches run by step kind ("prefill", "decode": each runs the
    stage's layers once) and the activations "sent" and "received"; the
    tests and the card's phase hold the kernels' launches and the
    transfers against them."""

    def __init__(self, pp: int, stage: int, device: torch.device, backend: str,
                 group=None):
        if not 0 <= stage < pp:
            raise ValueError(f"stage {stage} outside pp={pp}")
        self.pp, self.stage, self.device, self.group = pp, stage, torch.device(device), group
        self.first, self.last = stage == 0, stage == pp - 1
        # gloo moves host tensors only: a card's activations go through host
        self.host_staged = backend == "gloo" and self.device.type == "cuda"
        self.counts = collections.Counter()
        self._tally = None

    def _count(self, key: str, n: int = 1) -> None:
        (self.counts if self._tally is None else self._tally)[key] += n

    @contextlib.contextmanager
    def tally(self):
        """Count apart inside (a capture's padding run, and the capture,
        whose counts each replay of its graph adds, as the kernels' launch
        counts are kept)."""
        outer, self._tally = self._tally, collections.Counter()
        try:
            yield self._tally
        finally:
            self._tally = outer

    def _send(self, x: torch.Tensor, dst: int):
        import torch.distributed as dist
        x = x.contiguous()
        if self.host_staged:
            x = x.cpu()
        self._count("sent")
        return dist.isend(x, dst, group=self.group), x

    def _recv(self, shape: tuple, dtype: torch.dtype, src: int) -> torch.Tensor:
        import torch.distributed as dist
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if self.host_staged else self.device)
        dist.recv(buf, src, group=self.group)
        self._count("received")
        return buf.to(self.device) if self.host_staged else buf

    def trunk(self, kind: str, rows: int, tail: tuple, out_tail: tuple, dtype: torch.dtype,
              embed, layers, finalize=None, microbatches: int = 0):
        """Run this stage's part of one ``kind`` step ("prefill", "decode")
        over ``rows`` batch rows.

        ``embed(r)`` (stage 0) gives the hidden rows of the microbatch's
        row slice ``r``, shaped (mb, *tail); ``layers(h, r)`` runs the
        stage's layers on them; ``finalize(h, r)`` (last stage) reduces
        them to (mb, *out_tail) before they go back to stage 0.
        ``microbatches``: how many (0: :func:`auto_microbatches`).  Returns
        the (rows, *out_tail) final hidden rows on stage 0, None elsewhere.
        """
        M = microbatches or auto_microbatches(rows, self.pp)
        if rows % M:
            raise ValueError(f"batch {rows} not divisible by microbatches {M}")
        mb = rows // M
        self._count(kind, M)
        nxt, prev = (self.stage + 1) % self.pp, (self.stage - 1) % self.pp
        pending = []
        for m in range(M):
            r = slice(m * mb, (m + 1) * mb)
            h = embed(r) if self.first else self._recv((mb, *tail), dtype, prev)
            h = layers(h, r)
            if self.last and finalize is not None:
                h = finalize(h, r)
            pending.append(self._send(h, nxt))
        out = None
        if self.first:
            out = torch.cat([self._recv((mb, *out_tail), dtype, self.pp - 1)
                             for _ in range(M)])
        for work, _buf in pending:
            work.wait()
        return out


def stage_config(cfg: ModelConfig, stage: PipeStage) -> ModelConfig:
    """The config a stage's transformer runs: its own layers and ``stage``."""
    check_pipeline_compatible(cfg, stage.pp)
    return dataclasses.replace(cfg, num_layers=cfg.num_layers // stage.pp, stage=stage)


def stage_params(params: dict, cfg: ModelConfig, pp: int, stage: int) -> dict:
    """Stage ``stage``'s part of a whole parameter tree (the same tensors):
    its layers, and on stage 0 the embedding, norms and head too."""
    layers = [params["layers"][i] for i in stage_layers(cfg.num_layers, pp, stage)]
    if stage:
        return {"layers": layers}
    return {**params, "layers": layers}


# --------------------------------------------------------------------------
# Entry points, the JAX package's names, on every stage rank with its own
# parameters (``stage_params``), config (``stage_config``) and cache
# --------------------------------------------------------------------------

def pp_prefill(params: dict, cfg: ModelConfig, tokens, prompt_lens, slot_ids, kv_cache: list,
               *, num_microbatches: int = 0, attn_impl: str = "reference"):
    """Pipelined prefill (``transformer.prefill``'s contract): returns
    (last-token logits (B, V) on stage 0, None elsewhere; kv_cache)."""
    from tpuserve_torch.models import transformer
    return transformer.prefill(params, cfg, tokens, prompt_lens, slot_ids, kv_cache,
                               attn_impl=attn_impl, microbatches=num_microbatches)


def pp_decode_step(params: dict, cfg: ModelConfig, tokens, positions, slot_ids,
                   block_tables, seq_lens, kv_cache: list, *, num_microbatches: int = 0,
                   attn_impl: str = "reference"):
    """One pipelined decode step (``transformer.decode_step``'s contract):
    (logits (B, V) on stage 0, None elsewhere; kv_cache)."""
    from tpuserve_torch.models import transformer
    return transformer.decode_step(params, cfg, tokens, positions, slot_ids, block_tables,
                                   seq_lens, kv_cache, attn_impl=attn_impl,
                                   microbatches=num_microbatches)


def pp_decode_multi(params: dict, cfg: ModelConfig, tokens, positions, block_tables,
                    seq_lens, active, temperature, kv_cache: list, *, steps: int,
                    num_microbatches: int = 0, **kw):
    """``steps`` fused decode + sample iterations through the stages
    (``transformer.decode_multi``'s contract and keywords): stage 0 samples
    and its outputs are the window's; the other stages' token outputs are
    zeros (they advance positions only)."""
    from tpuserve_torch.models import transformer
    return transformer.decode_multi(params, cfg, tokens, positions, block_tables, seq_lens,
                                    active, temperature, kv_cache, steps=steps,
                                    microbatches=num_microbatches, **kw)
