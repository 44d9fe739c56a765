"""Guided-spec -> token-level FSM compiler (XGrammar/outlines-style, over
this repo's own char-level acceptors).

The port's own copy of ``tpuserve/runtime/grammar/compile.py`` (pure Python and
numpy; the port imports nothing of the JAX package): the same budgets,
environment variables and packed layout, so tables, cache entries and
settings carry over between the two packages.

The determinizer walks every vocabulary token's standalone decoded text
through cloned char-level machines and deduplicates the results on each
machine's ``state_key()`` (a hashable identity added to
runtime/guided.py, guided_regex.py — whose Thompson NFA state SETS are
the regex keys, reused as-is — and guided_choice.py).  The discovered
graph becomes a :class:`~tpuserve_torch.runtime.grammar.fsm.TokenFSM`:
per-state packed allow bitmasks + a class-compressed transition table.

Design boundaries (each falls back to the engine's per-step
candidate-substitution path, never to silent wrongness):

- **Finite subset only.**  JSON's container stack is bounded at
  ``JSON_MAX_DEPTH`` (a transition that nests deeper is simply not
  offered — output stays valid JSON, just shallower).  Schema machines
  whose state space explodes (numeric-bound digit prefixes) hit
  ``MAX_STATES`` and fail compilation loudly.
- **Standalone-token text only.**  A token is usable iff
  ``decode([tok])`` yields real text (no partial-rune U+FFFD, no
  specials).  Byte-fallback multi-token runes therefore can't be
  REQUIRED by the grammar: a choice list whose next char no token
  spells fails the spellability pre-check (or dead-end detection) and
  falls back to the substitution path's canonical-suffix plans.
- **Budgeted walks.**  ``MAX_WALK_CHARS`` bounds compile time; a
  production-vocab compile that exceeds it returns to the fallback
  path rather than stalling admission (offline/native caching is the
  follow-up, mirroring outlines' disk cache inside the vLLM image the
  reference deploys).
"""

from __future__ import annotations

import json
import os

import numpy as np

from tpuserve_torch.runtime.grammar.fsm import TokenFSM, pack_masks

MAX_STATES = int(os.environ.get("TPUSERVE_FSM_MAX_STATES", "4096"))
MAX_WALK_CHARS = int(os.environ.get("TPUSERVE_FSM_MAX_WALK_CHARS",
                                    "5000000"))
JSON_MAX_DEPTH = int(os.environ.get("TPUSERVE_FSM_JSON_DEPTH", "4"))


class FsmCompileError(ValueError):
    """The spec can't be compiled to a bounded token FSM — callers fall
    back to per-step candidate substitution, they do not fail the
    request."""


def token_text_table(tokenizer, vocab_size: int) -> dict[int, str]:
    """token id -> standalone decoded text for every usable token.

    Tokens that decode to nothing (pad/bos/eos, ids past the tokenizer's
    range on padded model vocabs) or to text containing U+FFFD (partial
    UTF-8 runes under byte-fallback vocabs) are excluded — the FSM masks
    them off everywhere, matching the engine's old rule that no-text
    tokens are never waved through outside free-text string context."""
    out: dict[int, str] = {}
    for t in range(vocab_size):
        try:
            txt = tokenizer.decode([t])
        except Exception:
            continue
        if not txt or "�" in txt:
            continue
        out[t] = txt
    return out


def _machine_factory(mode: str, schema):
    """Factory of fresh char-level acceptors for ``mode``.  The compiled
    artefacts (schema tree, regex NFA, choice tuple) are built ONCE and
    shared by every machine the factory makes — state_key() identity for
    schema nodes relies on that sharing."""
    if mode == "json":
        from tpuserve_torch.runtime.guided import JsonStateMachine
        return JsonStateMachine
    if mode == "json_schema":
        from tpuserve_torch.runtime.guided import (SchemaJsonStateMachine,
                                             compile_schema)
        compiled = compile_schema(json.loads(schema))
        return lambda: SchemaJsonStateMachine(compiled)
    if mode == "regex":
        from tpuserve_torch.runtime.guided_regex import (RegexStateMachine,
                                                   compile_regex)
        cre = compile_regex(schema)
        return lambda: RegexStateMachine(cre)
    if mode == "choice":
        from tpuserve_torch.runtime.guided_choice import (ChoiceStateMachine,
                                                    compile_choices)
        choices = compile_choices(json.loads(schema))
        return lambda: ChoiceStateMachine(choices), choices
    raise FsmCompileError(f"unknown guided mode {mode!r}")


def compile_token_fsm(make_machine, texts: dict[int, str],
                      vocab_size: int, eos_ids, *,
                      max_states: int | None = None,
                      max_depth: int | None = None,
                      max_walk_chars: int | None = None) -> TokenFSM:
    """Determinize a char-level acceptor into a :class:`TokenFSM`.

    ``make_machine``: zero-arg factory of the acceptor (clone/feed +
    ``state_key``/``can_finish``/``complete`` contract).  ``texts``:
    token id -> standalone text (:func:`token_text_table`).  ``eos_ids``:
    token ids that legally end generation in any ``can_finish`` state;
    they transition to the appended TERMINAL state.  ``max_depth`` bounds
    the container stack of machines that have one (the JSON PDA), making
    the language finite.

    Raises :class:`FsmCompileError` on budget overrun or when a
    REACHABLE non-finishing state has no outgoing transition at all (the
    grammar demands a char no token spells — a dead end logit masking
    could never escape; the substitution path's suffix plans can)."""
    max_states = max_states or MAX_STATES
    max_walk_chars = max_walk_chars or MAX_WALK_CHARS
    eos = sorted(e for e in set(eos_ids) if 0 <= e < vocab_size)
    root = make_machine()
    states: dict = {root.state_key(): 0}
    machines = [root]
    rows: dict[int, np.ndarray] = {}
    work = [0]
    spent = 0
    while work:
        si = work.pop()
        m = machines[si]
        row = np.full((vocab_size,), -1, np.int32)
        for tok, txt in texts.items():
            spent += len(txt)
            if spent > max_walk_chars:
                raise FsmCompileError(
                    f"walk budget exceeded ({max_walk_chars} chars) at "
                    f"{len(states)} states — vocabulary too large for "
                    "inline compilation")
            c = m.clone()
            try:
                c.feed(txt)
            except ValueError:
                continue
            stack = getattr(c, "stack", None)
            if (max_depth is not None and stack is not None
                    and len(stack) > max_depth):
                continue                     # depth-bounded JSON subset
            key = c.state_key()
            j = states.get(key)
            if j is None:
                if len(states) >= max_states:
                    raise FsmCompileError(
                        f"state budget exceeded ({max_states}) — grammar "
                        "state space too large for a token FSM")
                j = len(states)
                states[key] = j
                machines.append(c)
                work.append(j)
            row[tok] = j
        rows[si] = row

    n = len(machines)
    term = n                                  # appended terminal state
    can_finish = np.zeros((n + 1,), bool)
    complete = np.zeros((n + 1,), bool)
    next_arr = np.full((n + 1, vocab_size), -1, np.int32)
    for i, m in enumerate(machines):
        next_arr[i] = rows[i]
        can_finish[i] = bool(m.can_finish)
        complete[i] = bool(m.complete)
        if can_finish[i]:
            next_arr[i, eos] = term
    can_finish[term] = complete[term] = True
    next_arr[term, eos] = term                # EOS self-loop (overrun rows)

    dead = ~(next_arr >= 0).any(axis=1)
    if dead.any():
        raise FsmCompileError(
            f"{int(dead.sum())} reachable state(s) have no legal token "
            "(the grammar demands text no single token spells)")

    class_next, tok_class = _token_classes(next_arr, sorted(set(texts) | set(eos)))
    return TokenFSM(masks=pack_masks(next_arr >= 0),
                    tok_class=tok_class,
                    class_next=class_next,
                    can_finish=can_finish, complete=complete,
                    vocab_size=vocab_size, start=0)


def _token_classes(next_arr: np.ndarray, live: list[int]) -> tuple[np.ndarray, np.ndarray]:
    """``np.unique(next_arr, axis=1, return_inverse=True)``'s (class_next,
    tok_class), int32, without sorting every column: only the ``live``
    tokens (those with text, and EOS) have a transition anywhere, so every
    other column is all -1.  The distinct columns are ordered as
    ``np.unique`` orders them, lexicographically by their signed values, so
    the tables are the JAX compile's bit for bit; at a 151,936-token
    vocabulary this groups ~130 columns where ``np.unique`` sorts them
    all."""
    V = next_arr.shape[1]
    cols = {}
    for t in live:
        cols.setdefault(next_arr[:, t].tobytes(), t)
    dead = np.full((next_arr.shape[0],), -1, np.int32)
    if len(live) < V:
        cols.setdefault(dead.tobytes(), None)
    order = sorted(cols, key=lambda k: np.frombuffer(k, np.int32).tolist())
    index = {k: i for i, k in enumerate(order)}
    class_next = np.stack([np.frombuffer(k, np.int32) for k in order], axis=1)
    tok_class = np.full((V,), index.get(dead.tobytes(), 0), np.int32)
    for t in live:
        tok_class[t] = index[next_arr[:, t].tobytes()]
    return class_next.astype(np.int32), tok_class


def _choice_spellability_check(choices, texts: dict[int, str]) -> None:
    """Conservative pre-check for choice lists: every char of every
    choice must be spellable as a SINGLE token.  Without it a mixed list
    (["yes", "是"]) would compile into an FSM that silently masks the
    unspellable branch everywhere; failing compilation instead routes
    the request to the substitution path, whose canonical-suffix plans
    can emit multi-token runes."""
    single = {t for t in texts.values() if len(t) == 1}
    multi = set("".join(t for t in texts.values() if len(t) > 1))
    for c in choices:
        missing = [ch for ch in c if ch not in single and ch not in multi]
        if missing:
            raise FsmCompileError(
                f"choice {c!r} needs unspellable char(s) "
                f"{missing[:3]!r} — falling back to suffix plans")


def fsm_for_spec(mode: str, schema, tokenizer, vocab_size: int,
                 eos_ids, *, max_states: int | None = None,
                 max_walk_chars: int | None = None,
                 texts: dict[int, str] | None = None) -> TokenFSM:
    """Compile a guided spec (the engine's ``params.guided`` /
    ``params.guided_schema`` pair) into a :class:`TokenFSM`.

    ``texts``: a precomputed :func:`token_text_table` — pass it when
    compiling many grammars over one tokenizer (the engine does); it
    depends only on (tokenizer, vocab_size) and at production vocab
    sizes dominates the fixed cost of every compile.

    Raises :class:`FsmCompileError` when the spec can't be bounded — the
    engine treats that as "use the per-step substitution path", so a
    compile failure degrades throughput, never correctness."""
    if texts is None:
        texts = token_text_table(tokenizer, vocab_size)
    if not texts:
        raise FsmCompileError("tokenizer yields no usable token texts")
    factory = _machine_factory(mode, schema)
    if mode == "choice":
        factory, choices = factory
        _choice_spellability_check(choices, texts)
    depth = JSON_MAX_DEPTH if mode in ("json", "json_schema") else None
    return compile_token_fsm(factory, texts, vocab_size, eos_ids,
                             max_states=max_states, max_depth=depth,
                             max_walk_chars=max_walk_chars)
