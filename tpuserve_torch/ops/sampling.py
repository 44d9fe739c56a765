"""Token sampling — the ``greedy`` and ``temperature`` modes of
``tpuserve/ops/sampling.py``.

The JAX sampler draws its Gumbel noise from per-row ``jax.random`` keys,
which torch cannot reproduce.  Here the noise comes from one
``torch.Generator`` per row (one per request, owned by the engine), or is
passed in whole as ``gumbel`` so a test can feed both sides the same
numbers.
"""

from __future__ import annotations

import torch


def gumbel_noise(generators, vocab_size: int,
                 device: torch.device | str) -> torch.Tensor:
    """(B, V) float32 Gumbel noise, row ``i`` drawn from ``generators[i]``;
    rows whose generator is None get zeros (greedy rows, batch padding).
    Uniforms lie in [1e-7, 1), as in the JAX sampler."""
    rows = []
    for g in generators:
        if g is None:
            rows.append(torch.zeros(vocab_size, device=device))
            continue
        u = torch.rand(vocab_size, generator=g, device=device)
        rows.append(-torch.log(-torch.log(u * (1.0 - 1e-7) + 1e-7)))
    return torch.stack(rows)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor | None = None,
                  *, mode: str = "greedy",
                  gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Sample next tokens.

    logits: (B, V); temperature: (B,) per-row, ``<= 0`` means greedy for
    that row; gumbel: (B, V) noise for ``mode="temperature"``.
      - "greedy": argmax (temperature and noise ignored).
      - "temperature": argmax(logits / temperature + gumbel).
    Returns (B,) int32 on the logits' device.
    """
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if mode == "greedy":
        return greedy_tok
    if mode != "temperature":
        raise NotImplementedError(
            f"sampling mode {mode!r} is not ported yet (ROADMAP.md A6, "
            "the full sampler)")
    temperature = temperature.to(logits.device)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy_tok, sampled)
