"""Token sampling — the ``greedy`` and ``temperature`` modes of
``tpuserve/ops/sampling.py``.

The JAX sampler draws each row's Gumbel noise from a ``(salt, step)``
``jax.random`` key, so a seeded stream does not depend on the batch it
lands in, its place there, or the window size.  ``jax.random``'s bits
cannot be reproduced in torch; :func:`keyed_gumbel` keeps the contract
with a counter-based integer hash of (salt, step, vocabulary index) in
plain torch integer ops: no generator object, so a captured CUDA graph
serves any request.  ``sample_tokens`` also takes the noise whole
(``gumbel``), so a test can feed both sides the same numbers.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
# xorshift-multiply rounds with odd multipliers below 2**31, so the
# products of 32-bit values stay inside int64
_MUL = (0x7FEB352D, 0x5BD1E995)
_IDX_SALT = 0x9E3779B9


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche hash of int64 ``x`` holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * _MUL[0]) & _U32
    x = x ^ (x >> 15)
    x = (x * _MUL[1]) & _U32
    return x ^ (x >> 16)


def keyed_gumbel(salt: torch.Tensor, step: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """(B, V) float32 Gumbel noise on the keys' device: row ``i`` is a
    function of ``(salt[i], step[i])`` alone (int32 or int64 tensors of
    (B,) holding uint32 bit patterns).  Uniforms lie in [1e-7, 1), as in
    the JAX sampler."""
    row = _mix32(_mix32(salt.long() & _U32) ^ (step.long() & _U32))
    idx = torch.arange(vocab_size, dtype=torch.int64, device=salt.device)
    col = _mix32((idx + _IDX_SALT) & _U32)
    h = _mix32(row[:, None] ^ col[None, :])
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u * (1.0 - 1e-7) + 1e-7))


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
