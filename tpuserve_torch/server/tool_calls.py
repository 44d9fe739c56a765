"""Chat-message normalisation: the part of ``tpuserve/server/tool_calls.py``
that the chat path runs on every request.  Tool calling itself (parsers,
stream filters, forced calls) is not ported yet (ROADMAP.md A5b); the
server answers a request with ``tools`` with a 400 naming it."""

from __future__ import annotations


def normalize_messages(messages: list) -> list[dict]:
    """Chat-message hygiene for every template path: content parts are
    flattened to text, assistant ``tool_calls`` messages are kept intact
    for the template, roles are validated."""
    out = []
    for m in messages:
        if not isinstance(m, dict) or not isinstance(m.get("role"), str):
            raise ValueError("each message must be an object with a 'role'")
        m = dict(m)
        for tc in m.get("tool_calls") or []:
            if not isinstance(tc, dict) \
                    or not isinstance(tc.get("function"), dict) \
                    or not isinstance(tc["function"].get("name"), str):
                raise ValueError("assistant tool_calls must be objects with function.name")
        c = m.get("content")
        if isinstance(c, list):
            parts = []
            for p in c:
                if not isinstance(p, dict) or p.get("type") != "text" \
                        or not isinstance(p.get("text"), str):
                    raise ValueError("only {'type': 'text'} content parts are supported")
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
