"""Sequence (context) parallelism: ring attention and Ulysses, the port of
``tpuserve/parallel/ring_attention.py``.

Long-context prefill splits the sequence over the ranks of a
``torch.distributed`` group (:func:`make_sp_group`); each rank holds its
contiguous shard of the sequence, rank ``i`` the rows ``i*Tl..(i+1)*Tl``
(:func:`seq_shard` cuts one).  Both strategies match
``ops/attention.prefill_attention`` (causal, prompt-length masking,
float32 softmax) on the valid rows:

- **Ring attention** (:func:`ring_prefill_attention`): each rank keeps its
  Q shard and passes K/V shards around the ring (``batch_isend_irecv``,
  the next pass posted before the current block is computed), folding each
  visiting block into the JAX package's online softmax.  The block step is
  plain torch, as the JAX ring step is a plain einsum outside any Pallas
  kernel; blocks wholly past the causal diagonal are skipped (they change
  nothing), and the step runs a few query heads at a time so that its
  float32 scores stay bounded.
- **Ulysses** (:func:`ulysses_prefill_attention`): ``all_to_all`` from a
  sequence split to a head split, the port's prefill attention over the
  whole sequence on the rank's heads (the flash kernel, B1, on the card),
  and back.  K/V heads are expanded to the query heads first only when
  they do not split over the ranks (the JAX function always expands).

Transport: NCCL moves CUDA tensors; gloo moves host tensors, so ranks
sharing one card over gloo stage K/V and the all-to-alls through host
memory.
"""

from __future__ import annotations

import torch

from tpuserve_torch.ops.attention import NEG_INF, repeat_kv
from tpuserve_torch.ops.flash_prefill import flash_prefill_attention

AXIS_SP = "sp"
# float32 score bytes one ring block step may make at a time
RING_SCORE_BYTES = 256 << 20


def make_sp_group(sp: int | None = None, backend: str | None = None):
    """A group of the first ``sp`` ranks (default: every rank) for context
    parallelism; every rank must call it (it makes the group)."""
    import torch.distributed as dist
    world = dist.get_world_size()
    sp = sp or world
    if sp > world:
        raise ValueError(f"sp={sp} exceeds {world} ranks")
    return dist.new_group(list(range(sp)), backend=backend)


def _size_rank(group) -> tuple[int, int]:
    import torch.distributed as dist
    return dist.get_world_size(group), dist.get_rank(group)


def seq_shard(x: torch.Tensor, group=None, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous shard of ``x``'s sequence dimension ``dim``."""
    n, idx = _size_rank(group)
    T = x.shape[dim]
    if T % n:
        raise ValueError(f"seq len {T} not divisible by {AXIS_SP}={n}")
    return x.narrow(dim, idx * (T // n), T // n)


def _staged(x: torch.Tensor, group) -> bool:
    import torch.distributed as dist
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _post_ring(k: torch.Tensor, v: torch.Tensor, group, n: int, idx: int):
    """Post the pass of ``k``/``v`` to the next rank and the receive of the
    previous rank's; returns (requests, received k, received v)."""
    import torch.distributed as dist
    staged = _staged(k, group)
    ks, vs = k.contiguous(), v.contiguous()
    if staged:
        ks, vs = ks.cpu(), vs.cpu()
    kr, vr = torch.empty_like(ks), torch.empty_like(vs)
    nxt = dist.get_global_rank(group, (idx + 1) % n) if group is not None else (idx + 1) % n
    prv = dist.get_global_rank(group, (idx - 1) % n) if group is not None else (idx - 1) % n
    ops = [dist.P2POp(dist.isend, ks, nxt, group), dist.P2POp(dist.isend, vs, nxt, group),
           dist.P2POp(dist.irecv, kr, prv, group), dist.P2POp(dist.irecv, vr, prv, group)]
    return dist.batch_isend_irecv(ops), kr, vr, ks, vs


def _ring_block(q32, k, v, q_pos, k_pos, lens, scale: float, n_rep: int, o, m, l) -> None:
    """Fold one visiting K/V block into (o, m, l) in place, a few query
    heads at a time (the JAX ``_ring_shard`` step)."""
    B, Tq, Hq, _ = q32.shape
    kk = repeat_kv(k, n_rep).float()
    vv = repeat_kv(v, n_rep).float()
    causal = k_pos[None, :] <= q_pos[:, None]                        # (Tq, Tk)
    valid = k_pos[None, :] < lens[:, None]                           # (B, Tk)
    mask = causal[None, None, :, :] & valid[:, None, None, :]
    step = max(1, RING_SCORE_BYTES // max(B * Tq * k.shape[1] * 4, 1))
    for h0 in range(0, Hq, step):
        hs = slice(h0, min(h0 + step, Hq))
        scores = torch.einsum("bqhd,bkhd->bhqk", q32[:, :, hs], kk[:, :, hs]) * scale
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m[:, hs], scores.amax(dim=-1))
        # p masked explicitly: on a row that is all NEG_INF, exp(0) = 1
        # would otherwise add phantom mass to l
        p = torch.where(mask, torch.exp(scores - m_new[..., None]), 0.0)
        alpha = torch.exp(m[:, hs] - m_new)
        l[:, hs] = l[:, hs] * alpha + p.sum(dim=-1)
        o[:, hs] = o[:, hs] * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                              vv[:, :, hs])
        m[:, hs] = m_new


def ring_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           prompt_lens: torch.Tensor, scale: float,
                           group=None) -> torch.Tensor:
    """Causal prefill attention with the sequence split over ``group``.

    q: (B, Tl, Hq, D), k/v: (B, Tl, Hkv, D), this rank's shards;
    prompt_lens: (B,) global valid lengths.  Returns (B, Tl, Hq, D) in
    q.dtype, matching ``prefill_attention`` on the valid rows."""
    n, idx = _size_rank(group)
    B, Tl, Hq, D = q.shape
    n_rep = Hq // k.shape[2]
    dev = q.device
    q32 = q.float()
    lens = prompt_lens.to(dev)
    q_pos = idx * Tl + torch.arange(Tl, device=dev)
    o = torch.zeros((B, Hq, Tl, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Hq, Tl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hq, Tl), dtype=torch.float32, device=dev)
    for s in range(n):
        pending = _post_ring(k, v, group, n, idx) if s < n - 1 else None
        src = (idx - s) % n
        if src <= idx:          # a block past the diagonal is all masked
            _ring_block(q32, k, v, q_pos, src * Tl + torch.arange(Tl, device=dev), lens,
                        scale, n_rep, o, m, l)
        if pending is not None:
            reqs, kr, vr, _ks, _vs = pending
            for r in reqs:
                r.wait()
            k, v = kr.to(dev), vr.to(dev)
    out = o / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of ``x`` (n, ...) over ``group``: row j goes
    to rank j, and row j of the result came from rank j."""
    import torch.distributed as dist
    staged = _staged(x, group)
    src = x.contiguous().cpu() if staged else x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if staged else out


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(B, Tl, H, D) sequence shards -> (B, n*Tl, H/n, D) head shards."""
    B, Tl, H, D = x.shape
    out = _all_to_all(x.reshape(B, Tl, n, H // n, D).permute(2, 0, 1, 3, 4), group)
    return out.permute(1, 0, 2, 3, 4).reshape(B, n * Tl, H // n, D)


def _heads_to_seq(y: torch.Tensor, group, n: int) -> torch.Tensor:
    """(B, T, h, D) head shards -> (B, T/n, n*h, D) sequence shards."""
    B, T, h, D = y.shape
    out = _all_to_all(y.reshape(B, n, T // n, h, D).permute(1, 0, 2, 3, 4), group)
    return out.permute(1, 2, 0, 3, 4).reshape(B, T // n, n * h, D)


def ulysses_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              prompt_lens: torch.Tensor, scale: float,
                              group=None) -> torch.Tensor:
    """All-to-all sequence parallelism (Ulysses): shards as
    :func:`ring_prefill_attention`; needs ``Hq % sp == 0``."""
    n, _idx = _size_rank(group)
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq % n:
        raise ValueError(f"{Hq} query heads not divisible by {AXIS_SP}={n}")
    if Hkv % n:
        # GQA whose kv heads do not split: expand them to the query heads
        k, v = repeat_kv(k, Hq // Hkv), repeat_kv(v, Hq // Hkv)
    q, k, v = (_seq_to_heads(t, group, n).contiguous() for t in (q, k, v))
    out = flash_prefill_attention(q, k, v, prompt_lens.to(device=q.device, dtype=torch.int32),
                                  scale)
    return _heads_to_seq(out, group, n)
