"""Choice-constrained decoding (the vLLM ``guided_choice`` extension).

The port's own copy of ``tpuserve/runtime/guided_choice.py`` (pure Python and
numpy; the port imports nothing of the JAX package): the same budgets,
environment variables and packed layout, so tables, cache entries and
settings carry over between the two packages.

The output must be exactly one string from a client-supplied list.  Same
incremental char-level contract as the JSON/regex acceptors
(runtime/guided.py consumers: clone/feed/allows + ``can_finish``/
``complete``), so the engine's tokenizer-agnostic substitution path is
reused unchanged.

Deliberately NOT built on the regex NFA: choices are arbitrary literal
text, and routing them through a pattern language means escaping every
metachar and inheriting the regex subset's limits (MAX_PATTERN caps a
long choice list; ``\\n`` handling differs).  A prefix-set acceptor is
exact by construction: state = how many chars have been emitted + which
choices still start with the emitted text.  An empty viable set IS the
rejection, so dead-end freedom falls out the same way it does for the
NFA (guided_regex.py).

Reference parity: vLLM's guided_choice (served by outlines inside the
vLLM container the reference deploys, llm-d-deploy.yaml:140-193) with
full-match semantics — EOS only once the emitted text equals a choice,
auto-stop when no longer choice can extend it.
"""

from __future__ import annotations

MAX_CHOICES = 512
MAX_CHOICE_CHARS = 4096


class ChoiceError(ValueError):
    """Choice list is empty, oversized, or contains non-/empty strings."""


def compile_choices(choices) -> tuple[str, ...]:
    """Validate and normalise a guided_choice list (400 path: raise
    ChoiceError loudly rather than serve a constraint the client didn't
    ask for).  Duplicates collapse; order is irrelevant to acceptance."""
    if not isinstance(choices, (list, tuple)) or not choices:
        raise ChoiceError("'guided_choice' must be a non-empty list of "
                          "strings")
    if len(choices) > MAX_CHOICES:
        raise ChoiceError(f"too many choices ({len(choices)} > "
                          f"{MAX_CHOICES})")
    out = []
    seen = set()
    for c in choices:
        if not isinstance(c, str):
            raise ChoiceError("every choice must be a string")
        if not c:
            # an empty choice would make EOS-at-zero-chars legal, i.e.
            # permit empty output — reject rather than guess the intent
            raise ChoiceError("choices must be non-empty strings")
        if len(c) > MAX_CHOICE_CHARS:
            raise ChoiceError(f"choice longer than {MAX_CHOICE_CHARS} chars")
        try:
            c.encode("utf-8", "strict")
        except UnicodeEncodeError:
            # lone surrogates survive json.loads; they can't be tokenized
            # (UnicodeEncodeError deep in the engine step loop) nor ever
            # be emitted as output text — reject at the 400 edge
            raise ChoiceError("choices must be valid unicode (no lone "
                              "surrogates)") from None
        if c not in seen:
            seen.add(c)
            out.append(c)
    return tuple(out)


class ChoiceStateMachine:
    """Incremental full-match acceptor over a fixed set of literals.

    Engine contract (runtime/guided.py consumers): ``feed`` raises
    ValueError on a char no choice continues; ``can_finish`` gates EOS
    (emitted text equals some choice); ``complete`` auto-stops the
    request (equal to a choice AND no longer choice extends it);
    ``in_string`` is always False — choices are literal text, so
    no-text-yet tokens (partial runes) are substituted, never waved
    through.
    """

    __slots__ = ("choices", "pos", "viable")

    def __init__(self, choices: tuple[str, ...]):
        self.choices = choices
        self.pos = 0                       # chars emitted so far
        self.viable = tuple(range(len(choices)))

    def clone(self) -> "ChoiceStateMachine":
        c = ChoiceStateMachine.__new__(ChoiceStateMachine)
        c.choices = self.choices
        c.pos = self.pos
        c.viable = self.viable
        return c

    @property
    def can_finish(self) -> bool:
        return any(len(self.choices[i]) == self.pos for i in self.viable)

    @property
    def complete(self) -> bool:
        return (self.can_finish
                and all(len(self.choices[i]) == self.pos
                        for i in self.viable))

    @property
    def in_string(self) -> bool:
        return False

    def allows(self, text: str) -> bool:
        c = self.clone()
        try:
            c.feed(text)
        except ValueError:
            return False
        return True

    def state_key(self):
        """Hashable state identity for the grammar-FSM determinizer
        (runtime/grammar/compile.py): the multiset of REMAINING suffixes,
        not (pos, viable) — states that accept the same futures merge
        even when reached at different depths (shared choice tails)."""
        return tuple(sorted(self.choices[i][self.pos:]
                            for i in self.viable))

    def viable_suffixes(self) -> list[str]:
        """Remaining text of every still-viable choice, shortest first —
        the engine's escape hatch when token-level substitution can't
        spell the next char (e.g. a non-ASCII choice whose first byte
        token decodes to no text yet): it commits to the canonical token
        encoding of one of these suffixes (engine._guided_pick), which is
        correct by construction because encode(suffix) decodes back to
        exactly the chars this machine accepts."""
        return sorted((self.choices[i][self.pos:] for i in self.viable),
                      key=len)

    def feed(self, text: str) -> None:
        pos, viable = self.pos, self.viable
        for ch in text:
            nxt = tuple(i for i in viable
                        if len(self.choices[i]) > pos
                        and self.choices[i][pos] == ch)
            if not nxt:
                raise ValueError(
                    f"char {ch!r} at position {pos} continues no choice")
            pos += 1
            viable = nxt
        self.pos, self.viable = pos, viable
