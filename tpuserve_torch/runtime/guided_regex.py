"""Regex-constrained decoding (the vLLM ``guided_regex`` extension).

The port's own copy of ``tpuserve/runtime/guided_regex.py`` (pure Python and
numpy; the port imports nothing of the JAX package): the same budgets,
environment variables and packed layout, so tables, cache entries and
settings carry over between the two packages.

Same contract as the JSON acceptors (runtime/guided.py): an incremental
char-level machine the engine consults per candidate token
(clone/feed/allows + ``can_finish``/``complete``), so the
tokenizer-agnostic substitution path is reused unchanged — no
vocabulary/DFA product tables (outlines' approach inside the vLLM
container the reference deploys).

The pattern compiles to a Thompson NFA simulated as a state SET, so
acceptance is exact for the supported subset and a char that leads
nowhere raises immediately — dead-end freedom falls out of the
construction (an empty state set IS the rejection).  Full-match
semantics: the generated text must match the whole pattern; EOS is only
legal in an accepting state (``can_finish``), and generation auto-stops
when the match can no longer be extended (``complete``).

Supported: literals, ``.`` (any char but newline), escapes (``\\d \\D
\\w \\W \\s \\S`` and escaped metachars), classes ``[a-z0-9_]`` /
negated ``[^...]``, groups ``(...)``, alternation ``|``, quantifiers
``* + ?`` and bounded ``{m} {m,} {m,n}`` (n <= 64).  Rejected loudly:
anchors, backrefs, lookarounds, named groups — silently ignoring syntax
would accept strings the client's own regex then rejects.
"""

from __future__ import annotations

MAX_PATTERN = 512
MAX_REPEAT = 64
MAX_STATES = 8192


class RegexError(ValueError):
    """Pattern uses unsupported syntax or exceeds compile limits."""


class _State:
    __slots__ = ("eps", "trans", "accept")

    def __init__(self):
        self.eps: list = []          # epsilon successors
        self.trans: list = []        # (predicate, successor)
        self.accept = False


class _Frag:
    """NFA fragment: entry state + dangling exits to patch."""

    __slots__ = ("start", "outs")

    def __init__(self, start, outs):
        self.start = start
        self.outs = outs             # states whose eps gets the successor


_CLASSES = {
    "d": lambda c: c.isdigit() and c.isascii(),
    "D": lambda c: not (c.isdigit() and c.isascii()),
    "w": lambda c: (c.isalnum() and c.isascii()) or c == "_",
    "W": lambda c: not ((c.isalnum() and c.isascii()) or c == "_"),
    "s": lambda c: c in " \t\n\r\f\v",
    "S": lambda c: c not in " \t\n\r\f\v",
}
_ESCAPABLE = set("\\.[](){}|*+?^$-/\"'")
_ESC_LITERAL = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
                "0": "\0"}


class _Parser:
    """Recursive-descent regex -> NFA (Thompson construction)."""

    MAX_DEPTH = 64          # group nesting bound (recursion guard)

    def __init__(self, pattern: str):
        if len(pattern) > MAX_PATTERN:
            raise RegexError(f"pattern longer than {MAX_PATTERN} chars")
        self.p = pattern
        self.i = 0
        self.depth = 0
        self.states: list = []

    def _new(self) -> _State:
        if len(self.states) >= MAX_STATES:
            raise RegexError("pattern compiles to too many NFA states "
                             f"(> {MAX_STATES}); simplify the repetitions")
        s = _State()
        self.states.append(s)
        return s

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _take(self):
        ch = self.p[self.i]
        self.i += 1
        return ch

    # ---- grammar: alt -> concat ('|' concat)* ------------------------

    def parse(self) -> _Frag:
        frag = self._alt()
        if self.i < len(self.p):
            raise RegexError(f"unexpected {self.p[self.i]!r} at "
                             f"position {self.i}")
        return frag

    def _alt(self) -> _Frag:
        frags = [self._concat()]
        while self._peek() == "|":
            self._take()
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        fork = self._new()
        outs = []
        for f in frags:
            fork.eps.append(f.start)
            outs.extend(f.outs)
        return _Frag(fork, outs)

    def _concat(self) -> _Frag:
        frags = []
        while (c := self._peek()) is not None and c not in "|)":
            frags.append(self._repeat())
        if not frags:                # empty alternative matches ""
            s = self._new()
            return _Frag(s, [s])
        cur = frags[0]
        for nxt in frags[1:]:
            for o in cur.outs:
                o.eps.append(nxt.start)
            cur = _Frag(cur.start, nxt.outs)
        return cur

    def _repeat(self) -> _Frag:
        atom_start = self.i
        frag = self._atom()
        c = self._peek()
        if c == "*" or c == "+" or c == "?":
            self._take()
            lo, hi = {"*": (0, None), "+": (1, None), "?": (0, 1)}[c]
        elif c == "{":
            lo, hi = self._braces()
        else:
            return frag
        if self._peek() in ("*", "+", "?"):
            raise RegexError("nested quantifiers are not supported")
        return self._build_repeat(frag, atom_start, lo, hi)

    def _braces(self):
        self._take()                              # '{'
        digits = ""
        while (c := self._peek()) and c.isdigit():
            digits += self._take()
        if not digits:
            raise RegexError("'{' needs a count; escape a literal brace "
                             "as \\{")
        lo = int(digits)
        hi = lo
        if self._peek() == ",":
            self._take()
            digits = ""
            while (c := self._peek()) and c.isdigit():
                digits += self._take()
            hi = int(digits) if digits else None
        if self._peek() != "}":
            raise RegexError("unterminated {m,n}")
        self._take()
        if hi is not None and (hi < lo or hi > MAX_REPEAT):
            raise RegexError(f"repetition bound must be lo<=hi<="
                             f"{MAX_REPEAT}")
        if lo > MAX_REPEAT:
            raise RegexError(f"repetition bound above {MAX_REPEAT}")
        return lo, hi

    def _copy_atom(self, src_pos: int) -> _Frag:
        """Fresh copy of the atom by re-parsing its source span."""
        save = self.i
        self.i = src_pos
        frag = self._atom()
        self.i = save
        return frag

    def _build_repeat(self, first: _Frag, src_pos: int,
                      lo: int, hi) -> _Frag:
        if hi == 0:                               # {0} / {0,0}: empty match
            s = self._new()
            return _Frag(s, [s])
        if hi is None and lo == 0:                # '*'
            return self._star(first)
        if hi is None:                            # '+' / {m,}: m-1 copies + star
            cur = first
            for _ in range(lo - 1):
                nxt = self._copy_atom(src_pos)
                for o in cur.outs:
                    o.eps.append(nxt.start)
                cur = _Frag(cur.start, nxt.outs)
            star = self._star(self._copy_atom(src_pos))
            for o in cur.outs:
                o.eps.append(star.start)
            return _Frag(cur.start, star.outs)
        # {m,n}: m required copies then n-m optional ones
        entry = self._new()
        entry.eps.append(first.start)
        cur = _Frag(entry, first.outs)
        for idx in range(1, hi):
            nxt = self._copy_atom(src_pos)
            outs = []
            for o in cur.outs:
                o.eps.append(nxt.start)
            if idx >= lo:                         # optional copy: skippable
                outs.extend(cur.outs)
            outs.extend(nxt.outs)
            cur = _Frag(cur.start, outs)
        if lo == 0:
            cur = _Frag(cur.start, cur.outs + [entry])
        return cur

    def _star(self, frag: _Frag) -> _Frag:
        hub = self._new()
        hub.eps.append(frag.start)
        for o in frag.outs:
            o.eps.append(hub)
        return _Frag(hub, [hub])

    def _atom(self) -> _Frag:
        c = self._take() if self._peek() is not None else None
        if c is None:
            raise RegexError("pattern ended unexpectedly")
        if c == "(":
            if self._peek() == "?":
                raise RegexError("(?...) groups (non-capturing, named, "
                                 "lookaround) are not supported")
            self.depth += 1
            if self.depth > self.MAX_DEPTH:
                # recursion guard: a RecursionError would escape the
                # RegexError contract and 500 on client-controlled input
                raise RegexError(f"groups nested deeper than "
                                 f"{self.MAX_DEPTH}")
            frag = self._alt()
            if self._peek() != ")":
                raise RegexError("unbalanced '('")
            self._take()
            self.depth -= 1
            return frag
        if c == "[":
            return self._char_class()
        if c == ".":
            return self._pred(lambda ch: ch != "\n")
        if c == "\\":
            return self._escape()
        if c in "*+?{":
            raise RegexError(f"quantifier {c!r} with nothing to repeat")
        if c in ")|":
            raise RegexError(f"unexpected {c!r}")
        if c in "^$":
            raise RegexError("anchors are not supported (the whole "
                             "generation must match the pattern)")
        return self._literal(c)

    def _escape(self) -> _Frag:
        e = self._take() if self._peek() is not None else None
        if e is None:
            raise RegexError("dangling backslash")
        if e in _CLASSES:
            return self._pred(_CLASSES[e])
        if e in _ESC_LITERAL:
            return self._literal(_ESC_LITERAL[e])
        if e in _ESCAPABLE:
            return self._literal(e)
        raise RegexError(f"unsupported escape \\{e} (backrefs and "
                         "unicode classes are not supported)")

    def _char_class(self) -> _Frag:
        negate = False
        if self._peek() == "^":
            self._take()
            negate = True
        singles = set()
        ranges = []
        preds = []
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise RegexError("unterminated '['")
            if c == "]" and not first:
                self._take()
                break
            first = False
            c = self._take()
            if c == "\\":
                e = self._take() if self._peek() is not None else None
                if e is None:
                    raise RegexError("dangling backslash in class")
                if e in _CLASSES:
                    preds.append(_CLASSES[e])
                    if self._peek() == "-" and self.i + 1 < len(self.p) \
                            and self.p[self.i + 1] != "]":
                        raise RegexError(
                            f"\\{e} cannot bound a character range")
                    continue
                c = self._class_escape_literal(e)
            if self._peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self._take()
                hi = self._take()
                if hi == "\\":
                    e = self._take() if self._peek() is not None else None
                    if e is None:
                        raise RegexError("dangling backslash in class")
                    if e in _CLASSES:
                        # [a-\d] is an error in re too — never coerce a
                        # class escape into a made-up range bound
                        raise RegexError(
                            f"\\{e} cannot bound a character range")
                    hi = self._class_escape_literal(e)
                if not hi or ord(hi) < ord(c):
                    raise RegexError(f"bad class range {c}-{hi}")
                ranges.append((c, hi))
            else:
                singles.add(c)

        def member(ch, singles=frozenset(singles), ranges=tuple(ranges),
                   preds=tuple(preds)):
            if ch in singles:
                return True
            if any(lo <= ch <= hi for lo, hi in ranges):
                return True
            return any(p(ch) for p in preds)

        if negate:
            return self._pred(lambda ch: not member(ch))
        return self._pred(member)

    def _class_escape_literal(self, e: str) -> str:
        if e in _ESC_LITERAL:
            return _ESC_LITERAL[e]
        if e in _ESCAPABLE:
            return e
        raise RegexError(f"unsupported escape \\{e} in character class")

    def _literal(self, ch: str) -> _Frag:
        return self._pred(lambda c, ch=ch: c == ch)

    def _pred(self, pred) -> _Frag:
        a, b = self._new(), self._new()
        a.trans.append((pred, b))
        return _Frag(a, [b])


class CompiledRegex:
    """NFA start state + a transition memo SHARED by every machine over
    this pattern.  The per-candidate clone+feed in the engine's
    substitution loop re-walks the same state sets thousands of times per
    generated token; memoising (state_set, char) -> next_set turns that
    into dict lookups (a lazily-built DFA).  Dead transitions memoise
    too — rejection is the common case while filtering candidates."""

    __slots__ = ("start", "memo")

    MAX_MEMO = 1 << 16      # lazily-built DFA edge cap (bypass past it)

    def __init__(self, start: _State):
        self.start = start
        self.memo: dict = {}


_DEAD = frozenset()


def compile_regex(pattern: str) -> CompiledRegex:
    """Compile to an NFA; raises :class:`RegexError` on unsupported
    syntax (listed in the module docstring)."""
    if not isinstance(pattern, str) or not pattern:
        raise RegexError("pattern must be a non-empty string")
    parser = _Parser(pattern)
    try:
        frag = parser.parse()
    except RecursionError:      # belt and braces behind MAX_DEPTH
        raise RegexError("pattern nests too deeply") from None
    end = parser._new()
    end.accept = True
    for o in frag.outs:
        o.eps.append(end)
    return CompiledRegex(frag.start)


def _closure(states: frozenset) -> frozenset:
    seen = set(states)
    stack = list(states)
    while stack:
        for nxt in stack.pop().eps:
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return frozenset(seen)


class RegexStateMachine:
    """Incremental full-match acceptor over a compiled NFA.

    Engine contract (runtime/guided.py consumers): ``feed`` raises
    ValueError on a char no continuation survives; ``can_finish`` gates
    EOS (an accepting state is live); ``complete`` auto-stops the
    request (accepting AND inextensible); ``in_string`` is always False
    — a regex has no free-text context, so no-text-yet tokens (partial
    runes) are substituted, never waved through.
    """

    __slots__ = ("compiled", "states")

    def __init__(self, compiled: CompiledRegex):
        self.compiled = compiled
        self.states = _closure(frozenset((compiled.start,)))

    def clone(self) -> "RegexStateMachine":
        c = RegexStateMachine.__new__(RegexStateMachine)
        c.compiled = self.compiled
        c.states = self.states
        return c

    def state_key(self):
        """Hashable state identity for the grammar-FSM determinizer
        (runtime/grammar/compile.py): the NFA state SET itself — the
        textbook subset construction, reusing the Thompson NFA as-is.
        _State hashes by identity and every machine over one
        CompiledRegex shares the same state objects, so equal sets mean
        equal futures."""
        return self.states

    @property
    def can_finish(self) -> bool:
        return any(s.accept for s in self.states)

    @property
    def complete(self) -> bool:
        return self.can_finish and not any(s.trans for s in self.states)

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

    def feed(self, text: str) -> None:
        states = self.states
        memo = self.compiled.memo
        for ch in text:
            key = (states, ch)
            nxt = memo.get(key)
            if nxt is None:
                raw = {t for s in states for pred, t in s.trans
                       if pred(ch)}
                nxt = _closure(frozenset(raw)) if raw else _DEAD
                if len(memo) < CompiledRegex.MAX_MEMO:
                    memo[key] = nxt
            if not nxt:
                raise ValueError(
                    f"char {ch!r} matches no continuation of the pattern")
            states = nxt
        self.states = states
