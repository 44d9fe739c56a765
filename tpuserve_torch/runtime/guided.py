"""Guided (structured-output) decoding: incremental JSON acceptance.

The port's own copy of ``tpuserve/runtime/guided.py`` (pure Python and
numpy; the port imports nothing of the JAX package): the same budgets,
environment variables and packed layout, so tables, cache entries and
settings carry over between the two packages.

OpenAI ``response_format: {"type": "json_object"}`` — served by vLLM in
the stack the reference deploys (reference: llm-d-deploy.yaml pins the
vLLM OpenAI image) — constrains generation to a valid JSON object.  This
module is the grammar side: a character-level incremental acceptor the
engine consults token by token (runtime/engine.py ``_apply_guided``).

The acceptor is a pushdown automaton specialised to JSON: a container
stack ('O'/'A') plus a small mode word for in-progress scalars.  The
top level is restricted to an OBJECT (the json_object contract), so
completion is unambiguous: the moment the root object closes, only
whitespace may follow and the engine can stop the request.

Design note: the engine validates *candidate token text* against a clone
of the request's state and substitutes the best valid candidate when the
sampled token would break the grammar (top-K rejection sampling).  That
keeps the hot path on-device and tokenizer-agnostic — no vocabulary/DFA
product tables — at the cost of running guided requests on the
single-step decode path.
"""

from __future__ import annotations

_WS = " \t\n\r"
_DIGITS = "0123456789"
# number sub-states that may legally end the number
_NUM_TERMINAL = {"zero", "int", "frac", "exp"}


class JsonStateMachine:
    """Incremental JSON-object acceptor.

    Modes: 'start' (expecting '{'), 'value' (expecting any value),
    'key' (expecting '"' or — right after '{' — '}'), 'key-required'
    (after a comma in an object: '"' only), 'colon', 'post' (a value
    just closed; what follows depends on the stack), 'string'/'key-string'
    (with escape/unicode counters), 'number' (with ``num`` sub-state),
    'literal' (true/false/null tail), 'done' (root closed).
    """

    __slots__ = ("stack", "mode", "esc", "uni", "num", "lit", "ws_run")

    # Longest run of consecutive structural whitespace accepted.  Plain
    # JSON allows unbounded whitespace, but under guided decoding that is
    # a degenerate fixed point — a model whose argmax is '\t' emits
    # whitespace to max_tokens (observed with random weights).  Bounding
    # the run forces the grammar to demand progress.
    MAX_WS_RUN = 4

    def __init__(self):
        self.stack: list = []
        self.mode = "start"
        self.esc = False          # inside string: previous char was '\'
        self.uni = 0              # inside string: \uXXXX hex digits left
        self.num = ""             # number sub-state
        self.lit = ""             # remaining chars of true/false/null
        self.ws_run = 0           # consecutive structural whitespace

    def clone(self) -> "JsonStateMachine":
        c = JsonStateMachine.__new__(JsonStateMachine)
        c.stack = list(self.stack)
        c.mode = self.mode
        c.esc = self.esc
        c.uni = self.uni
        c.num = self.num
        c.lit = self.lit
        c.ws_run = self.ws_run
        return c

    @property
    def complete(self) -> bool:
        return self.mode == "done"

    def state_key(self):
        """Hashable state identity: two machines with equal keys accept
        identical futures.  Consumed by the grammar-FSM determinizer
        (runtime/grammar/compile.py), which dedupes walked clones on it —
        every field that influences a future transition must appear."""
        return (tuple(self.stack), self.mode, self.esc, self.uni,
                self.num, self.lit, self.ws_run)

    @property
    def can_finish(self) -> bool:
        """EOS is legal here (the engine's _guided_pick gate).  For JSON
        the document is finishable exactly when the root closed; regex
        acceptors (guided_regex.py) override with accepting-state
        liveness, which can be true while the match is still
        extensible."""
        return self.complete

    @property
    def in_string(self) -> bool:
        """Inside a string (value or key) — the only modes where arbitrary
        text, and hence a partial multibyte rune contributing no decoded
        text yet, is legal.  NOT while an escape or \\uXXXX sequence is
        pending: those demand specific next chars, so a neutral-accepted
        partial rune would assemble into a char the escape then rejects —
        failing the authoritative feed and silently dropping the whole
        constraint (observed as ~2% garbage-output flake under unseeded
        sampling)."""
        return (self.mode in ("string", "key-string")
                and not self.esc and not self.uni)

    def allows(self, text: str) -> bool:
        """Would ``text`` keep the document valid?  (Clone + feed.)"""
        c = self.clone()
        try:
            c.feed(text)
        except ValueError:
            return False
        return True

    def feed(self, text: str) -> None:
        for ch in text:
            self._feed_char(ch)

    # ------------------------------------------------------------------

    def _fail(self, ch: str):
        raise ValueError(f"invalid JSON char {ch!r} in mode {self.mode}")

    # ---- grammar-event hooks (no-ops here) ---------------------------
    # SchemaJsonStateMachine overrides these to layer JSON-Schema
    # constraints on top of the same character-level PDA.  Every hook may
    # raise ValueError to reject the char/transition.

    def _hook_value_start(self, ch: str) -> None:
        """First char of a value (also '{' of the root object)."""

    def _hook_open(self, kind: str) -> None:
        """A container just opened ('O'/'A'); called after the push."""

    def _hook_close(self, kind: str) -> None:
        """'}'/']' about to close a container; called BEFORE the pop."""

    def _hook_key_char(self, ch: str) -> None:
        """Raw char inside an object key (escapes included, quote not)."""

    def _hook_key_done(self) -> None:
        """Object key closed (about to expect ':')."""

    def _hook_scalar_char(self, ch: str) -> None:
        """Raw char consumed as part of a scalar value (string chars incl.
        escapes but not the quotes; number chars; literal tail chars)."""

    def _hook_value_end(self) -> None:
        """A value (scalar or container) just finished."""

    def _hook_more(self, kind: str) -> None:
        """',' consumed inside a container — another key/value MUST follow
        (JSON forbids trailing commas), so a schema with nothing left to
        accept rejects HERE rather than leaving a dead-end state the
        candidate substitution can never escape."""

    def _close_value(self) -> None:
        """A value just finished; decide what comes next."""
        self._hook_value_end()
        if not self.stack:
            self.mode = "done"
        else:
            self.mode = "post"

    def _feed_char(self, ch: str) -> None:
        m = self.mode
        if m == "done":
            if ch not in _WS:
                self._fail(ch)
            self.ws_run += 1
            if self.ws_run > self.MAX_WS_RUN:
                self._fail(ch)
            return
        if m in ("string", "key-string"):
            self._string_char(ch)
            return
        if m == "number":
            if self._number_char(ch):
                self._hook_scalar_char(ch)
                return
            # the char ended the number; fall through and process it in
            # the post-value context the number closed into
            m = self.mode
        if m == "literal":
            if self.lit and ch == self.lit[0]:
                self._hook_scalar_char(ch)
                self.lit = self.lit[1:]
                if not self.lit:
                    self._close_value()
                return
            self._fail(ch)
        if ch in _WS:
            self.ws_run += 1
            if self.ws_run > self.MAX_WS_RUN:
                self._fail(ch)
            return
        self.ws_run = 0
        if m == "start":
            if ch == "{":
                self._hook_value_start(ch)
                self.stack.append("O")
                self._hook_open("O")
                self.mode = "key"
                return
            self._fail(ch)
        if m == "value":
            self._value_start(ch)
            return
        if m == "arr-first":                    # right after '[': value or ']'
            if ch == "]":
                self._hook_close("A")
                self.stack.pop()
                self._close_value()
                return
            self._value_start(ch)
            return
        if m == "key":
            if ch == '"':
                self.mode = "key-string"
                return
            if ch == "}":                       # empty object
                self._hook_close("O")
                self.stack.pop()
                self._close_value()
                return
            self._fail(ch)
        if m == "key-required":
            if ch == '"':
                self.mode = "key-string"
                return
            self._fail(ch)
        if m == "colon":
            if ch == ":":
                self.mode = "value"
                return
            self._fail(ch)
        if m == "post":
            top = self.stack[-1]
            if top == "O":
                if ch == ",":
                    self._hook_more("O")
                    self.mode = "key-required"
                    return
                if ch == "}":
                    self._hook_close("O")
                    self.stack.pop()
                    self._close_value()
                    return
            else:                               # 'A'
                if ch == ",":
                    self._hook_more("A")
                    self.mode = "value"
                    return
                if ch == "]":
                    self._hook_close("A")
                    self.stack.pop()
                    self._close_value()
                    return
            self._fail(ch)
        self._fail(ch)

    def _value_start(self, ch: str) -> None:
        self._hook_value_start(ch)
        if ch == "{":
            self.stack.append("O")
            self._hook_open("O")
            self.mode = "key"
        elif ch == "[":
            self.stack.append("A")
            self._hook_open("A")
            self.mode = "arr-first"             # value or an immediate ']'
        elif ch == '"':
            self.mode = "string"
        elif ch == "-":
            self._hook_scalar_char(ch)
            self.mode = "number"
            self.num = "minus"
        elif ch == "0":
            self._hook_scalar_char(ch)
            self.mode = "number"
            self.num = "zero"
        elif ch in "123456789":
            self._hook_scalar_char(ch)
            self.mode = "number"
            self.num = "int"
        elif ch == "t":
            self._hook_scalar_char(ch)
            self.mode = "literal"
            self.lit = "rue"
        elif ch == "f":
            self._hook_scalar_char(ch)
            self.mode = "literal"
            self.lit = "alse"
        elif ch == "n":
            self._hook_scalar_char(ch)
            self.mode = "literal"
            self.lit = "ull"
        else:
            self._fail(ch)

    def _string_char(self, ch: str) -> None:
        key = self.mode == "key-string"
        hook = self._hook_key_char if key else self._hook_scalar_char
        if self.uni:
            if ch in "0123456789abcdefABCDEF":
                hook(ch)
                self.uni -= 1
                return
            self._fail(ch)
        if self.esc:
            if ch in '"\\/bfnrt':
                hook(ch)
                self.esc = False
                return
            if ch == "u":
                hook(ch)
                self.esc = False
                self.uni = 4
                return
            self._fail(ch)
        if ch == "\\":
            hook(ch)
            self.esc = True
            return
        if ch == '"':
            if key:
                self._hook_key_done()
                self.mode = "colon"
            else:
                self._close_value()
            return
        if ch in "\n\r\t" or (len(ch) == 1 and ord(ch) < 0x20):
            self._fail(ch)                      # control chars must be escaped
        hook(ch)
        # any other char (incl. multibyte) is fine inside a string

    def _number_char(self, ch: str) -> bool:
        """Consume ``ch`` as part of the number.  Returns True if it was
        part of the number, False if the number ENDED (mode already moved
        to the closed-value state; the caller re-processes ``ch``)."""
        n = self.num
        if n == "minus":
            if ch == "0":
                self.num = "zero"
                return True
            if ch in "123456789":
                self.num = "int"
                return True
            self._fail(ch)
        if n == "zero":
            if ch == ".":
                self.num = "dot"
                return True
            if ch in "eE":
                self.num = "e"
                return True
        elif n == "int":
            if ch in _DIGITS:
                return True
            if ch == ".":
                self.num = "dot"
                return True
            if ch in "eE":
                self.num = "e"
                return True
        elif n == "dot":
            if ch in _DIGITS:
                self.num = "frac"
                return True
            self._fail(ch)
        elif n == "frac":
            if ch in _DIGITS:
                return True
            if ch in "eE":
                self.num = "e"
                return True
        elif n == "e":
            if ch in "+-":
                self.num = "esign"
                return True
            if ch in _DIGITS:
                self.num = "exp"
                return True
            self._fail(ch)
        elif n == "esign":
            if ch in _DIGITS:
                self.num = "exp"
                return True
            self._fail(ch)
        elif n == "exp":
            if ch in _DIGITS:
                return True
        if self.num in _NUM_TERMINAL:
            self.num = ""
            self._close_value()
            return False
        self._fail(ch)


# --------------------------------------------------------------------------
# JSON-Schema-constrained acceptance (response_format: json_schema)
# --------------------------------------------------------------------------

# Keywords we enforce.  Anything else that could CHANGE the accepted
# language is rejected at compile time (silently ignoring a constraint
# would emit documents the client's schema then fails to validate —
# worse than an up-front 400).  Annotation-only keywords are ignored.
_SUPPORTED = {"type", "properties", "required", "additionalProperties",
              "items", "minItems", "maxItems", "enum", "const",
              "minimum", "maximum", "exclusiveMinimum", "exclusiveMaximum"}
_ANNOTATIONS = {"title", "description", "default", "examples", "$schema",
                "$id", "format"}
_TYPES = {"object", "array", "string", "number", "integer", "boolean",
          "null"}


class SchemaError(ValueError):
    """Schema uses a construct this acceptor can't enforce."""


def compile_schema(schema, _root=True):
    """Validate + normalise a JSON-Schema subset for incremental
    enforcement.  Returns the normalised node (plain dicts).  Raises
    :class:`SchemaError` on unsupported constructs — the API edge maps it
    to a 400 listing the offending keyword."""
    import json as _json
    if schema is True or schema == {}:
        return {}                                 # unconstrained
    if not isinstance(schema, dict):
        raise SchemaError("schema must be an object")
    unknown = set(schema) - _SUPPORTED - _ANNOTATIONS
    if unknown:
        raise SchemaError(
            f"unsupported schema keyword(s): {sorted(unknown)} "
            f"(supported: {sorted(_SUPPORTED)})")
    node = {}
    t = schema.get("type")
    if t is not None:
        types = [t] if isinstance(t, str) else list(t)
        bad = set(types) - _TYPES
        if bad:
            raise SchemaError(f"unknown type(s) {sorted(bad)}")
        node["types"] = set(types)
    if _root and node.get("types", {"object"}) != {"object"}:
        raise SchemaError("root schema must have type 'object' "
                          "(the json_schema response is an object)")
    if _root:
        node.setdefault("types", {"object"})
    if "enum" in schema or "const" in schema:
        vals = schema.get("enum", [])
        if "const" in schema:
            vals = vals + [schema["const"]] if vals else [schema["const"]]
        if not vals:
            raise SchemaError("'enum' must be non-empty")
        if any(isinstance(v, (dict, list)) for v in vals):
            raise SchemaError("enum/const of objects or arrays is not "
                              "supported (serialisation is not canonical)")
        # canonical serialised text the value must match char-for-char
        node["enum_texts"] = [_json.dumps(v, ensure_ascii=False)
                              for v in vals]
    props = schema.get("properties")
    if props is not None:
        if not isinstance(props, dict):
            raise SchemaError("'properties' must be an object")
        for k in props:
            if any(c in k for c in '"\\') or any(ord(c) < 0x20 for c in k):
                raise SchemaError(
                    f"property name {k!r} needs JSON escapes — "
                    "unsupported in key constraint")
        node["props"] = {k: compile_schema(v, _root=False)
                         for k, v in props.items()}
    req = schema.get("required")
    if req is not None:
        if (not isinstance(req, list)
                or not all(isinstance(k, str) for k in req)):
            raise SchemaError("'required' must be a list of strings")
        node["required"] = set(req)
    ap = schema.get("additionalProperties", True)
    if isinstance(ap, dict) or ap is True:
        node["additional"] = (compile_schema(ap, _root=False)
                              if isinstance(ap, dict) else {})
    elif ap is False:
        node["additional"] = None                 # only declared keys
        if not node.get("props"):
            raise SchemaError("additionalProperties: false with no "
                              "properties accepts no keys")
        undeclared = node.get("required", set()) - set(node["props"])
        if undeclared:
            # would compile into a runtime dead-end ('}' missing required,
            # ',' no keys left) — the up-front 400 this module promises
            raise SchemaError(
                f"required key(s) {sorted(undeclared)} not in properties "
                "while additionalProperties is false — no document can "
                "satisfy this schema")
    else:
        raise SchemaError("'additionalProperties' must be a schema or bool")
    items = schema.get("items")
    if items is not None:
        if isinstance(items, list):
            raise SchemaError("tuple-form 'items' is not supported")
        node["items"] = compile_schema(items, _root=False)
    for k in ("minItems", "maxItems"):
        if k in schema:
            v = schema[k]
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise SchemaError(f"'{k}' must be a non-negative integer")
            node[k] = v
    if node.get("maxItems") is not None and \
            node.get("maxItems") < node.get("minItems", 0):
        raise SchemaError("maxItems < minItems accepts no arrays")
    for k in ("minimum", "maximum", "exclusiveMinimum", "exclusiveMaximum"):
        if k in schema:
            v = schema[k]
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise SchemaError(f"'{k}' must be a number")
            node[k] = float(v)
    return node


def _allowed_types(node):
    return node.get("types") or _TYPES


_FIRST_CHAR_TYPE = {"{": "object", "[": "array", '"': "string",
                    "t": "boolean", "f": "boolean", "n": "null"}


class SchemaJsonStateMachine(JsonStateMachine):
    """JSON-Schema-constrained incremental acceptor.

    Layers schema context over the base PDA via the grammar-event hooks:
    a frame stack mirrors the container stack, carrying each container's
    schema node, the keys seen so far (objects) or the element count
    (arrays), and the schema expected for the next value.  Enum/const
    values are matched char-for-char against their canonical
    ``json.dumps`` serialisation; ``integer`` forbids '.'/'e' while the
    number streams; numeric bounds check at value end.  vLLM serves the
    same contract via outlines-compiled token DFAs (delegated inside the
    reference's serving container); here the tokenizer-agnostic
    candidate-substitution design of :class:`JsonStateMachine` is reused
    unchanged — only the acceptor got stricter.
    """

    __slots__ = ("root", "frames", "val_schema", "val_text", "val_kind",
                 "enum_cands")

    def __init__(self, compiled):
        """``compiled``: a node from :func:`compile_schema` (callers own
        the compile so its SchemaError surfaces at the API edge)."""
        super().__init__()
        self.root = compiled
        self.frames: list = []
        self.val_schema = self.root   # schema for the NEXT value
        self.val_text = None          # collected scalar text (when needed)
        self.val_kind = None          # 'string'|'number'|'boolean'|'null'
        self.enum_cands = None        # serialised enum texts still viable

    @property
    def in_string(self) -> bool:
        """The base acceptor treats strings as arbitrary text, so the
        engine accepts no-text-yet tokens (partial multibyte runes) while
        inside one.  A CONSTRAINED string — a key limited to declared
        properties, or an enum-matched value — is not arbitrary: a
        partial rune would assemble into a char the constraint then
        rejects, and the feed failure would deregister the whole
        constraint.  Report False there so such tokens are substituted
        instead of accepted."""
        if self.esc or self.uni:       # see JsonStateMachine.in_string
            return False
        if self.mode == "key-string":
            return not (self.frames
                        and self.frames[-1]["node"].get("additional",
                                                        {}) is None)
        if self.mode == "string":
            return self.enum_cands is None
        return False

    def state_key(self):
        """Schema-aware state identity (see JsonStateMachine.state_key).
        Schema nodes are keyed by ``id()`` — sound because every machine
        a grammar-FSM compile walks shares ONE compiled tree (the
        factory in runtime/grammar/compile.py builds it once).  Falsy
        val_schema ({} or None) collapses to 0: both mean
        "unconstrained" to every hook, and ``node.get(...) or {}`` sites
        mint fresh empty dicts whose ids would otherwise explode the
        state count."""
        frames = tuple(
            (f["kind"], id(f["node"]),
             frozenset(f["seen"]) if "seen" in f else f["count"],
             f.get("key"))
            for f in self.frames)
        return (super().state_key(), frames,
                id(self.val_schema) if self.val_schema else 0,
                self.val_text, self.val_kind,
                tuple(self.enum_cands)
                if self.enum_cands is not None else None)

    def clone(self):
        c = SchemaJsonStateMachine.__new__(SchemaJsonStateMachine)
        c.stack = list(self.stack)
        c.mode = self.mode
        c.esc = self.esc
        c.uni = self.uni
        c.num = self.num
        c.lit = self.lit
        c.ws_run = self.ws_run
        c.root = self.root            # immutable after compile
        c.frames = [dict(f, seen=set(f["seen"])) if "seen" in f else dict(f)
                    for f in self.frames]
        c.val_schema = self.val_schema
        c.val_text = self.val_text
        c.val_kind = self.val_kind
        c.enum_cands = (list(self.enum_cands)
                        if self.enum_cands is not None else None)
        return c

    # ---- hooks -------------------------------------------------------

    def _hook_value_start(self, ch: str) -> None:
        node = self.val_schema or {}
        kind = _FIRST_CHAR_TYPE.get(ch, "number")
        allowed = _allowed_types(node)
        if kind == "number":
            if not ({"number", "integer"} & allowed):
                raise ValueError(f"schema expects {sorted(allowed)}, "
                                 f"got a number")
            self._check_number_start(node, ch)
        elif kind not in allowed:
            raise ValueError(f"schema expects {sorted(allowed)}, "
                             f"got {kind}")
        if node.get("enum_texts") and kind in ("object", "array"):
            # compile_schema rejects container enum values, so a container
            # can never match — don't let it open unconstrained
            raise ValueError("value not in enum")
        # array growth cap: this value would exceed maxItems
        if self.frames and self.frames[-1]["kind"] == "A" \
                and self.mode in ("value", "arr-first"):
            fr = self.frames[-1]
            mx = fr["node"].get("maxItems")
            if mx is not None and fr["count"] + 1 > mx:
                raise ValueError(f"array exceeds maxItems {mx}")
        self.val_kind = kind
        texts = node.get("enum_texts")
        self.enum_cands = None
        self.val_text = None
        if texts is not None and kind not in ("object", "array"):
            # every scalar char (incl. this first one, delivered via
            # _hook_scalar_char right after this hook) prefix-filters the
            # candidate serialisations; exact match checked at value end
            if kind == "string":
                cands = [t[1:-1] for t in texts if t.startswith('"')]
            else:
                cands = [t for t in texts if not t.startswith('"')]
            if not cands:
                raise ValueError("value not in enum")
            self.enum_cands = cands
            self.val_text = ""
        elif kind == "number" and (
                "integer" in allowed and "number" not in allowed
                or any(k in node for k in ("minimum", "maximum",
                                           "exclusiveMinimum",
                                           "exclusiveMaximum"))):
            self.val_text = ""            # collect for bounds / int check

    def _hook_open(self, kind: str) -> None:
        node = self.val_schema or {}
        if kind == "O":
            self.frames.append({"kind": "O", "node": node, "seen": set(),
                                "key": None})
        else:
            self.frames.append({"kind": "A", "node": node, "count": 0})
            self.val_schema = node.get("items", {})
        self.val_kind = None
        self.enum_cands = None
        self.val_text = None

    def _hook_close(self, kind: str) -> None:
        fr = self.frames[-1]
        if kind == "O":
            missing = fr["node"].get("required", set()) - fr["seen"]
            if missing:
                raise ValueError(f"missing required key(s) "
                                 f"{sorted(missing)}")
        else:
            mn = fr["node"].get("minItems")
            if mn is not None and fr["count"] < mn:
                raise ValueError(f"array needs at least {mn} item(s)")

    def _hook_more(self, kind: str) -> None:
        fr = self.frames[-1]
        node = fr["node"]
        if kind == "A":
            mx = node.get("maxItems")
            if mx is not None and fr["count"] >= mx:
                raise ValueError(f"array already has maxItems {mx} items")
        elif node.get("additional", {}) is None and \
                set(node.get("props", {})) <= fr["seen"]:
            raise ValueError("every schema property already present")

    def _hook_key_char(self, ch: str) -> None:
        fr = self.frames[-1]
        if fr.get("key") is None:
            fr["key"] = ""
        node = fr["node"]
        if node.get("props") is None and "additional" not in node:
            fr["key"] += ch
            return
        if node.get("additional", {}) is None:    # declared keys only
            if ch == "\\":
                raise ValueError("escaped chars in constrained keys are "
                                 "not supported")
            cand = fr["key"] + ch
            if not any(k.startswith(cand) and k not in fr["seen"]
                       for k in node.get("props", {})):
                raise ValueError(f"no allowed key starts with {cand!r}")
            fr["key"] = cand
        else:
            fr["key"] += ch

    def _hook_key_done(self) -> None:
        fr = self.frames[-1]
        key = fr.get("key") or ""
        if "\\" in key:
            # unconstrained keys may use escapes; unescape before the
            # property lookup or "a" would dodge the schema for "a"
            import json as _json
            try:
                key = _json.loads(f'"{key}"')
            except ValueError:
                pass
        node = fr["node"]
        if key in fr["seen"]:
            raise ValueError(f"duplicate key {key!r}")
        if node.get("additional", {}) is None and \
                key not in node.get("props", {}):
            raise ValueError(f"key {key!r} not in schema properties")
        fr["seen"].add(key)
        fr["key"] = None
        props = node.get("props") or {}
        self.val_schema = props.get(key, node.get("additional") or {})

    @staticmethod
    def _only_negative(node) -> bool:
        return ((node.get("maximum") is not None and node["maximum"] < 0)
                or (node.get("exclusiveMaximum") is not None
                    and node["exclusiveMaximum"] <= 0))

    def _check_number_start(self, node, ch: str) -> None:
        """Reject sign starts that can NEVER satisfy the bounds — left
        alone they become dead-end states the candidate substitution
        cannot escape.  Only SIGN-level exclusions are decidable at the
        first char for floats: exponents make almost any magnitude
        reachable from any prefix ('0.5e3' = 500), so '-' is dead only
        when the bounds exclude ALL of (-inf, 0], and a digit start only
        when they exclude all of [0, inf).  Integers (no '.'/'e') get the
        stricter zero/magnitude checks in _hook_scalar_char."""
        lo = node.get("minimum")
        elo = node.get("exclusiveMinimum")
        if ch == "-":
            # reachable values: (-inf, 0] (-0 == 0 covers minimum == 0)
            if (lo is not None and lo > 0) or \
                    (elo is not None and elo >= 0):
                raise ValueError("schema bounds forbid negative numbers")
            return
        # digit start: reachable values [0, inf)
        if self._only_negative(node):
            raise ValueError("schema bounds require a negative number")
        allowed = _allowed_types(node)
        if ch == "0" and "integer" in allowed and "number" not in allowed:
            # integer '0' cannot grow (leading-zero rule, no exponent):
            # the value IS 0
            if (lo is not None and lo > 0) or \
                    (elo is not None and elo >= 0):
                raise ValueError("schema bounds forbid zero")

    def _hook_scalar_char(self, ch: str) -> None:
        if self.enum_cands is not None:
            self.val_text += ch
            self.enum_cands = [t for t in self.enum_cands
                               if t.startswith(self.val_text)]
            if not self.enum_cands:
                raise ValueError("value not in enum")
            return
        if self.val_text is not None and self.val_kind == "number":
            node = self.val_schema or {}
            allowed = _allowed_types(node)
            integer_only = ("integer" in allowed
                            and "number" not in allowed)
            if integer_only and ch in ".eE":
                raise ValueError("schema expects an integer")
            if ch == "0" and self.val_text == "-" and integer_only \
                    and self._only_negative(node):
                # integer '-0' IS 0 (no fraction/exponent escape)
                raise ValueError("schema bounds forbid -0")
            if ch in "123456789" and "e" not in self.val_text \
                    and "E" not in self.val_text:
                # a nonzero SIGNIFICAND digit commits the value's sign —
                # exponents scale magnitude but never flip sign or zero a
                # nonzero significand.  When the bounds confine this sign
                # to exactly zero (minimum 0 after '-', maximum 0 on a
                # positive start — the strict exclusions already rejected
                # at the first char), the state is a dead end every
                # terminator fails: reject the digit itself.
                if self.val_text.startswith("-"):
                    lo = node.get("minimum")
                    if lo is not None and lo >= 0:
                        raise ValueError(
                            "schema bounds forbid negative numbers")
                else:
                    hi = node.get("maximum")
                    if hi is not None and hi <= 0:
                        raise ValueError(
                            "schema bounds forbid positive numbers")
            self.val_text += ch
            # integer magnitude dead-ends: no exponent can shrink an
            # integer back under a bound, and further digits only grow it
            if integer_only and ch in _DIGITS:
                v = int(self.val_text)
                hi, ehi = node.get("maximum"), node.get("exclusiveMaximum")
                lo, elo = node.get("minimum"), node.get("exclusiveMinimum")
                if v >= 0 and ((hi is not None and v > hi)
                               or (ehi is not None and v >= ehi)):
                    raise ValueError("integer already above maximum")
                if v < 0 and ((lo is not None and v < lo)
                              or (elo is not None and v <= elo)):
                    raise ValueError("integer already below minimum")

    def _hook_value_end(self) -> None:
        if self.enum_cands is not None:
            if self.val_text not in self.enum_cands:
                raise ValueError("value not in enum")
        elif self.val_text is not None and self.val_kind == "number":
            node = self.val_schema or {}
            v = float(self.val_text)
            if "minimum" in node and v < node["minimum"]:
                raise ValueError(f"number below minimum {node['minimum']}")
            if "maximum" in node and v > node["maximum"]:
                raise ValueError(f"number above maximum {node['maximum']}")
            if "exclusiveMinimum" in node and v <= node["exclusiveMinimum"]:
                raise ValueError("number at/below exclusiveMinimum")
            if "exclusiveMaximum" in node and v >= node["exclusiveMaximum"]:
                raise ValueError("number at/above exclusiveMaximum")
        self.enum_cands = None
        self.val_text = None
        self.val_kind = None
        # the container this value closed INTO decides the next schema
        if self.frames and not self.stack:
            self.frames.pop()                     # root object closed
            return
        if self.frames and len(self.frames) > len(self.stack):
            self.frames.pop()                     # a container just closed
        if self.frames:
            fr = self.frames[-1]
            if fr["kind"] == "A":
                fr["count"] += 1
                self.val_schema = fr["node"].get("items", {})
            else:
                self.val_schema = None            # set at next key_done
