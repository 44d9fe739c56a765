"""OpenAI tool calling for ``/v1/chat/completions``: the port of
``tpuserve/server/tool_calls.py``.

The reference serves vLLM's OpenAI-compatible API (llm-d-test.yaml:61-78
smoke-tests it), whose chat route accepts ``tools``/``tool_choice`` and
answers with ``tool_calls``.  This module holds that surface:

- request validation and message normalisation (content parts,
  tool-result messages, assistant messages that carry earlier calls);
- prompt construction: tools ride the model's own chat template, and the
  built-in fallback template gets the active parser's system block;
- output parsing: per-family parsers turn generated text back into calls
  (Hermes ``<tool_call>`` blocks for Qwen, Mistral ``[TOOL_CALLS]``,
  Llama-3.x bare JSON);
- ``tool_choice: "required"`` or a named function, forced by a
  parser-specific prompt suffix that is prepended to the output again
  before parsing, so the parse sees one whole call;
- streaming: a hold-back filter keeps marker text (and a tail that may
  still grow into a marker) out of content deltas, and gives the parsed
  calls when the choice finishes.  A forced call whose text does not parse
  is answered as plain content, without the forced marker.
"""

from __future__ import annotations

import dataclasses
import json
import re
import uuid
from typing import Optional


@dataclasses.dataclass
class ToolCall:
    name: str
    arguments: str          # JSON-encoded string, the OpenAI wire shape

    def as_openai(self) -> dict:
        return {
            "id": f"call_{uuid.uuid4().hex[:24]}",
            "type": "function",
            "function": {"name": self.name, "arguments": self.arguments},
        }


def _call_from_obj(obj, args_keys=("arguments", "parameters")) -> Optional[ToolCall]:
    """A parsed-JSON object -> ToolCall if it looks like one."""
    if not isinstance(obj, dict) or not isinstance(obj.get("name"), str):
        return None
    args = None
    for k in args_keys:
        if k in obj:
            args = obj[k]
            break
    if args is None:
        args = {}
    if isinstance(args, str):
        return ToolCall(obj["name"], args)
    if isinstance(args, dict):
        return ToolCall(obj["name"], json.dumps(args))
    return None


class ToolParser:
    """Base: extract() pulls calls out of generated text; markers tell the
    streaming filter which substrings must be held back from content."""

    name = "base"
    markers: tuple[str, ...] = ()
    # True when calls can only appear at the START of the completion
    # (Llama-3 JSON): once prose has begun, the filter stops holding —
    # otherwise any brace in a normal answer would stall the stream.
    markers_start_only = False

    def extract(self, text: str) -> tuple[str, list[ToolCall]]:
        raise NotImplementedError

    def forced_prefix(self, fn_name: Optional[str]) -> str:
        """Prompt suffix that commits the model to a call (named when
        fn_name is given).  Prepended back onto the output before
        extract()."""
        raise NotImplementedError

    def prompt_instruction(self, tools_json: str) -> str:
        """System-block text advertising the tools in THIS parser's output
        format — used by the fallback chat template for template-less
        models, so the format the prompt teaches is the format extract()
        parses."""
        raise NotImplementedError


class HermesToolParser(ToolParser):
    """``<tool_call>{"name":..., "arguments":{...}}</tool_call>`` blocks —
    the Qwen2/Qwen3 (and NousResearch Hermes) convention."""

    name = "hermes"
    markers = ("<tool_call>",)
    _BLOCK = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.DOTALL)

    def extract(self, text):
        calls = []

        def _eat(m):
            c = None
            try:
                c = _call_from_obj(json.loads(m.group(1)))
            except json.JSONDecodeError:
                pass
            if c is not None:
                calls.append(c)
                return ""
            return m.group(0)      # unparseable block stays visible
        content = self._BLOCK.sub(_eat, text)
        # length/eos can cut the closing tag off the final block; salvage a
        # trailing unterminated call when its JSON still parses
        idx = content.rfind("<tool_call>")
        if idx != -1:
            frag = content[idx + len("<tool_call>"):].strip()
            try:
                c = _call_from_obj(json.loads(frag))
            except json.JSONDecodeError:
                c = None
            if c is not None:
                calls.append(c)
                content = content[:idx]
        return content, calls

    def forced_prefix(self, fn_name):
        if fn_name:
            return '<tool_call>\n{"name": "%s", "arguments": ' % fn_name
        return "<tool_call>\n"

    def prompt_instruction(self, tools_json):
        return ("You may call tools. To call one, reply with "
                '<tool_call>{"name": <name>, "arguments": <args-object>}'
                "</tool_call>.\nAvailable tools: " + tools_json)


class MistralToolParser(ToolParser):
    """``[TOOL_CALLS] [{...}, ...]`` — the Mistral-Instruct convention."""

    name = "mistral"
    markers = ("[TOOL_CALLS]",)
    _MARK = "[TOOL_CALLS]"

    def extract(self, text):
        idx = text.find(self._MARK)
        if idx == -1:
            return text, []
        payload = text[idx + len(self._MARK):].lstrip()
        calls = []
        try:
            arr, end = json.JSONDecoder().raw_decode(payload)
        except json.JSONDecodeError:
            return text, []
        if isinstance(arr, dict):
            arr = [arr]
        if isinstance(arr, list):
            for obj in arr:
                c = _call_from_obj(obj)
                if c is not None:
                    calls.append(c)
        if not calls:
            return text, []
        return text[:idx] + payload[end:], calls

    def forced_prefix(self, fn_name):
        if fn_name:
            return '[TOOL_CALLS] [{"name": "%s", "arguments": ' % fn_name
        return "[TOOL_CALLS] ["

    def prompt_instruction(self, tools_json):
        return ("You may call tools. To call one, reply with "
                '[TOOL_CALLS] [{"name": <name>, "arguments": '
                "<args-object>}].\nAvailable tools: " + tools_json)


class Llama3JsonParser(ToolParser):
    """Llama-3.x JSON tool calling: the completion itself is
    ``{"name": ..., "parameters": {...}}`` (optionally after
    ``<|python_tag|>``; multiple calls ``;``-separated)."""

    name = "llama3_json"
    markers = ("{", "<|python_tag|>")
    markers_start_only = True

    def extract(self, text):
        t = text.strip()
        if t.startswith("<|python_tag|>"):
            t = t[len("<|python_tag|>"):].lstrip()
        if not t.startswith("{"):
            return text, []
        calls = []
        rest = t
        while rest.startswith("{"):
            try:
                obj, end = json.JSONDecoder().raw_decode(rest)
            except json.JSONDecodeError:
                break
            c = _call_from_obj(obj)
            if c is None:
                break
            calls.append(c)
            rest = rest[end:].lstrip()
            if rest.startswith(";"):
                rest = rest[1:].lstrip()
        if not calls or rest:
            # anything left over means this wasn't (only) tool JSON —
            # treat the whole completion as content, like vLLM does
            return text, []
        return "", calls

    def forced_prefix(self, fn_name):
        if fn_name:
            return '{"name": "%s", "parameters": ' % fn_name
        return '{"name": "'

    def prompt_instruction(self, tools_json):
        return ("You may call tools. To call one, reply with ONLY "
                '{"name": <name>, "parameters": <args-object>} and no '
                "other text.\nAvailable tools: " + tools_json)


_PARSERS = {p.name: p for p in
            (HermesToolParser(), MistralToolParser(), Llama3JsonParser())}


def get_tool_parser(model_name: str, override: Optional[str] = None) -> ToolParser:
    """Parser by explicit name, else inferred from the model family.
    Hermes is the default — it is the convention of the flagship Qwen
    models and the least ambiguous to detect in free text."""
    if override:
        try:
            return _PARSERS[override]
        except KeyError:
            raise ValueError(
                f"unknown tool-call parser {override!r}; "
                f"choose from {sorted(_PARSERS)}")
    low = (model_name or "").lower()
    if "mistral" in low or "mixtral" in low:
        return _PARSERS["mistral"]
    if "llama-3" in low or "llama3" in low or "llama31" in low:
        return _PARSERS["llama3_json"]
    return _PARSERS["hermes"]


class ToolStreamFilter:
    """Streaming hold-back: release content up to the first marker, hold
    everything after it (and any tail that is still a prefix of a marker),
    then parse the full text when the choice finishes."""

    def __init__(self, parser: ToolParser):
        self._parser = parser
        self._buf = ""
        self._emitted = 0        # chars of _buf already released
        self._seeded = 0         # forced-prefix chars (never released)
        self._held = False
        self._prose = False      # start-only parser: prose began, stop holding

    def seed(self, forced: str) -> None:
        """Pre-load a forced prompt prefix: part of the parse, never part
        of the visible content."""
        self._buf += forced
        self._seeded = len(forced)
        self._held = True

    def feed(self, delta: str) -> str:
        if not delta:
            return ""
        self._buf += delta
        if self._held:
            return ""
        pending = self._buf[self._emitted:]
        if self._parser.markers_start_only:
            if not self._prose:
                stripped = pending.lstrip()
                if not stripped:
                    return ""                   # leading whitespace: wait
                for m in self._parser.markers:
                    if stripped.startswith(m):
                        self._held = True
                        return ""
                    if m.startswith(stripped):
                        return ""               # could still become a marker
                self._prose = True              # it's an answer, not a call
            out = pending
            self._emitted += len(out)
            return out
        cut = None
        for m in self._parser.markers:
            i = pending.find(m)
            if i != -1 and (cut is None or i < cut):
                cut = i
        if cut is not None:
            out = pending[:cut]
            self._emitted += cut      # the marker and beyond stay held
            self._held = True
            return out
        # hold back the longest tail that could still grow into a marker
        hold = 0
        for m in self._parser.markers:
            for k in range(min(len(m) - 1, len(pending)), 0, -1):
                if pending.endswith(m[:k]):
                    hold = max(hold, k)
                    break
        out = pending[:len(pending) - hold]
        self._emitted += len(out)
        return out

    def finish(self) -> tuple[str, list[ToolCall]]:
        """Remaining visible content + the parsed calls."""
        content, calls = self._parser.extract(self._buf)
        if calls:
            # a seeded filter holds from char 0, so _emitted is 0 there
            emitted = self._buf[:self._emitted]
            tail = (content[len(emitted):]
                    if content.startswith(emitted) else "")
            return tail, calls
        # no calls: whatever we held back is plain content after all —
        # except a seeded forced prefix, which was never model output
        # (matches the non-streaming postprocess, which parses
        # forced+text but returns the bare text on a failed parse)
        return self._buf[max(self._emitted, self._seeded):], calls


@dataclasses.dataclass
class ToolContext:
    """Per-request tool-calling state threaded from request parsing to
    response assembly."""

    raw_tools: list[dict]            # OpenAI-shaped, for the chat template
    parser: ToolParser
    forced: str = ""                 # prompt-forcing prefix ("" = auto)

    @staticmethod
    def from_body(body: dict, model_name: str,
                  parser_override: Optional[str] = None) -> Optional["ToolContext"]:
        tools = body.get("tools")
        choice = body.get("tool_choice", "auto")
        if tools is None:
            if choice not in ("auto", "none", None):
                raise ValueError("'tool_choice' requires 'tools'")
            return None
        if not isinstance(tools, list) or not tools:
            raise ValueError("'tools' must be a non-empty list")
        names = []
        for t in tools:
            if not isinstance(t, dict) or t.get("type") != "function" \
                    or not isinstance(t.get("function"), dict):
                raise ValueError(
                    "each tool must be {'type': 'function', 'function': {...}}")
            fn = t["function"]
            if not isinstance(fn.get("name"), str) or not fn["name"]:
                raise ValueError("tool function.name must be a non-empty string")
            if "parameters" in fn and not isinstance(fn["parameters"], dict):
                raise ValueError("tool function.parameters must be an object")
            names.append(fn["name"])
        forced_name = None
        if choice in ("none",):
            return None                       # tools ignored entirely
        if isinstance(choice, dict):
            if choice.get("type") != "function" or \
                    not isinstance(choice.get("function"), dict) or \
                    not isinstance(choice["function"].get("name"), str):
                raise ValueError(
                    "tool_choice object must be "
                    "{'type': 'function', 'function': {'name': ...}}")
            forced_name = choice["function"]["name"]
            if forced_name not in names:
                raise ValueError(
                    f"tool_choice names unknown function {forced_name!r}")
        elif choice not in ("auto", "required", None):
            raise ValueError(
                "'tool_choice' must be 'none', 'auto', 'required' or a "
                "named function object")
        parser = get_tool_parser(model_name, parser_override)
        forced = ""
        if forced_name is not None or choice == "required":
            forced = parser.forced_prefix(forced_name)
        return ToolContext(raw_tools=tools, parser=parser, forced=forced)

    def stream_filter(self) -> ToolStreamFilter:
        f = ToolStreamFilter(self.parser)
        if self.forced:
            f.seed(self.forced)
        return f

    def postprocess(self, text: str) -> tuple[Optional[str], Optional[list[dict]]]:
        """Full (non-streaming) response: (content, tool_calls) in the
        OpenAI message shape."""
        content, calls = self.parser.extract(self.forced + text)
        if not calls:
            return text, None
        content = content.strip()
        return (content or None), [c.as_openai() for c in calls]


def normalize_messages(messages: list) -> list[dict]:
    """Chat-message hygiene shared by all template paths: content parts
    are flattened to text, tool/assistant-tool_calls messages are kept
    structurally intact for the template, roles are validated."""
    out = []
    for m in messages:
        if not isinstance(m, dict) or not isinstance(m.get("role"), str):
            raise ValueError("each message must be an object with a 'role'")
        m = dict(m)
        for tc in m.get("tool_calls") or []:
            if not isinstance(tc, dict) \
                    or not isinstance(tc.get("function"), dict) \
                    or not isinstance(tc["function"].get("name"), str):
                raise ValueError(
                    "assistant tool_calls must be objects with "
                    "function.name")
        c = m.get("content")
        if isinstance(c, list):
            parts = []
            for p in c:
                if not isinstance(p, dict) or p.get("type") != "text" \
                        or not isinstance(p.get("text"), str):
                    raise ValueError(
                        "only {'type': 'text'} content parts are supported")
                parts.append(p["text"])
            m["content"] = "".join(parts)
        elif c is None:
            if not m.get("tool_calls"):
                raise ValueError(f"message with role {m['role']!r} has no content")
            m["content"] = ""
        elif not isinstance(c, str):
            raise ValueError("message content must be a string or text parts")
        out.append(m)
    return out
