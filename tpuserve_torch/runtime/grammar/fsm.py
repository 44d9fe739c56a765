"""Token-level FSM container: packed masks + class-compressed transitions.

The port's own copy of ``tpuserve/runtime/grammar/fsm.py`` (pure Python and
numpy; the port imports nothing of the JAX package): the same budgets,
environment variables and packed layout, so tables, cache entries and
settings carry over between the two packages.

A :class:`TokenFSM` is the compiled, vocabulary-resolved form of a guided
spec.  Two representations matter:

- ``masks`` (N, ceil(V/32)) uint32 — per-state allowed-token bitmask,
  bit ``t % 32`` of word ``t // 32`` set iff token ``t`` is legal in the
  state.  This is what the sampler consumes (ops/sampling.py
  ``apply_token_mask`` unpacks it on device, so the host->device traffic
  per grammar is V/8 bytes per state, not V floats).
- ``tok_class`` (V,) + ``class_next`` (N, C) — the transition table
  delta(state, token), factored through token equivalence classes.  Most
  grammars collapse the vocabulary into a few hundred behaviour classes
  (every plain letter inside a JSON string transitions identically), so
  the dense (N, V) table — 600 MB at production vocab — never
  materialises on device: the window gathers ``class_next[state,
  tok_class[token]]`` per sampled token.

``-1`` in ``class_next`` means "no transition" (the token is masked, so a
sampler can only reach it if the mask was bypassed); state ``N-1`` by
construction is the TERMINAL state (EOS consumed; only EOS continues).

Host and device advance through the SAME table, so the host mirror state
(advanced at window flush, engine ``_emit_one``) cannot drift from the
device carry — the invariant the S>1 == S=1 token-identity tests pin.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def pack_masks(allow: np.ndarray) -> np.ndarray:
    """(N, V) bool -> (N, ceil(V/32)) uint32, bit t%32 of word t//32 =
    token t.  Little bit-order so the device unpack is a plain
    ``(word >> (t % 32)) & 1`` regardless of platform byte order (values
    cross to the device, not bytes)."""
    N, V = allow.shape
    Vp = ((V + 31) // 32) * 32
    bits = np.zeros((N, Vp), np.bool_)
    bits[:, :V] = allow
    packed = np.packbits(bits, axis=1, bitorder="little")
    return np.ascontiguousarray(packed).view(np.uint32).reshape(N, Vp // 32)


def unpack_masks(packed: np.ndarray, vocab_size: int) -> np.ndarray:
    """Inverse of :func:`pack_masks` (host-side: tests, per-step mask
    audits)."""
    as_bytes = np.ascontiguousarray(packed).view(np.uint8)
    bits = np.unpackbits(as_bytes, axis=1, bitorder="little")
    return bits[:, :vocab_size].astype(bool)


@dataclasses.dataclass
class TokenFSM:
    """Compiled token-level FSM (see module docstring for field layout)."""

    masks: np.ndarray        # (N, ceil(V/32)) uint32 packed allow bits
    tok_class: np.ndarray    # (V,) int32 token -> behaviour class
    class_next: np.ndarray   # (N, C) int32 delta, -1 = no transition
    can_finish: np.ndarray   # (N,) bool — EOS is legal here
    complete: np.ndarray     # (N,) bool — generation auto-stops here
    vocab_size: int
    start: int = 0

    @property
    def num_states(self) -> int:
        return int(self.class_next.shape[0])

    @property
    def num_classes(self) -> int:
        return int(self.class_next.shape[1])

    def advance(self, state: int, token: int) -> int:
        """Host-side delta(state, token): the next state, or -1 when the
        token has no transition (off-grammar — the engine drops the
        constraint rather than validating against a corrupt state)."""
        if not 0 <= state < self.num_states:
            return -1
        if not 0 <= token < self.vocab_size:
            return -1
        return int(self.class_next[state, self.tok_class[token]])

    def allowed(self, state: int) -> np.ndarray:
        """(V,) bool allowed-token vector for ``state`` (host-side)."""
        return unpack_masks(self.masks[state:state + 1],
                            self.vocab_size)[0]

    def mask_row(self, state: int) -> np.ndarray:
        """Packed (ceil(V/32),) uint32 mask row for ``state`` — what the
        per-step path scatters into its (B, Vw) batch mask."""
        return self.masks[state]
